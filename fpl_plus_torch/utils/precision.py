"""Precision policy: bf16 or f16 compute with f32 state.

* ``[testing] precision = bfloat16`` or ``float16`` casts the network's
  parameters to that dtype while the DSBN running statistics (buffers) stay
  f32, and the Inferer casts the volume on the host (round to nearest
  even). Sliding-window accumulation and TTA averaging stay f32.
* ``[training] precision = bfloat16`` or ``float16`` never casts the
  module: the train step forwards copies of the f32 master parameters in
  that dtype (``engine/train.py``). In-training validation rounds the
  volume as the Inferer does and computes in f32 with the training module,
  as the JAX package's validation promotes a rounded volume against f32
  variables. As in the JAX package there is no loss scaling: an f16
  gradient that underflows is zero.
* ``matmul_precision`` sets both TF32 flags, process-wide, for every
  accepted value (``MATMUL_TF32``), so a later stage of one process does
  not inherit an earlier stage's value.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_ALIASES = {
    'float32': None, 'f32': None, 'fp32': None, None: None, '': None,
    'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
    'float16': torch.float16, 'fp16': torch.float16,
}

# matmul_precision -> (torch.backends.cudnn.allow_tf32,
# torch.backends.cuda.matmul.allow_tf32). JAX's names of its three levels
# and their aliases; 'default' is PyTorch's own default (TF32 convolutions,
# f32 matmuls). JAX also takes XLA dot-algorithm names, which have no
# PyTorch counterpart.
MATMUL_TF32 = {
    'highest': (False, False), 'float32': (False, False),
    'high': (True, True), 'tensorfloat32': (True, True),
    'default': (True, False), 'bfloat16': (True, False),
}


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config string -> compute dtype (None = keep f32, no casting)."""
    key = name.lower() if isinstance(name, str) else name
    if key not in _ALIASES:
        raise ValueError('Undefined precision {0!r} (use float32/bfloat16/'
                         'float16)'.format(name))
    return _ALIASES[key]


def cast_infer_module(module: nn.Module, precision) -> nn.Module:
    """Cast the f32 parameters to the compute dtype in place; buffers (the
    DSBN running statistics) keep f32. ``module.to(dtype)`` would cast the
    buffers too.

    In place: for a module loaded only to serve. Never call it on a module
    that is still training, whose f32 parameters are the optimizer's
    masters (the train step and in-training validation leave the module's
    dtype alone)."""
    dtype = resolve_dtype(precision)
    if dtype is not None:
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return module


def apply_matmul_precision(config: dict, stage: str = 'test') -> None:
    """Honor ``matmul_precision``: set both TF32 flags from ``MATMUL_TF32``,
    process-wide; an unknown value raises. The section matching the running
    stage wins ([testing] for test/inference, [training] otherwise); with
    neither set, the flags stay as they are."""
    order = (('testing', 'training') if stage in ('test', 'inference')
             else ('training', 'testing'))
    for section in order:
        val = config.get(section, {}).get('matmul_precision', None)
        if val:
            if str(val) not in MATMUL_TF32:
                raise ValueError('Undefined matmul_precision {0!r} (use one '
                                 'of {1})'.format(val, ', '.join(MATMUL_TF32)))
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = MATMUL_TF32[str(val)]
            return
