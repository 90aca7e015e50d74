"""Precision policy: bf16 compute with f32 state.

* ``[testing] precision = bfloat16`` casts the network's parameters to bf16
  while the DSBN running statistics (buffers) stay f32, and the Inferer
  casts the volume on the host (round to nearest even). Sliding-window
  accumulation and TTA averaging stay f32.
* ``[training] precision = bfloat16`` never casts the module: the train
  step forwards bf16 copies of the f32 master parameters
  (``engine/train.py``). In-training validation rounds the volume as the
  Inferer does and computes in f32 with the training module, as the JAX
  package's validation promotes a bf16 volume against f32 variables.
* ``matmul_precision = highest`` turns TF32 off for cuDNN convolutions and
  matmuls; otherwise PyTorch's defaults hold (f32 convolutions run in TF32
  on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_ALIASES = {
    'float32': None, 'f32': None, 'fp32': None, None: None, '': None,
    'bfloat16': torch.bfloat16, 'bf16': torch.bfloat16,
}


def resolve_dtype(name) -> Optional[torch.dtype]:
    """Config string -> compute dtype (None = keep f32, no casting).
    float16 is not ported: the DSBN+PReLU kernel takes f32 and bf16."""
    key = name.lower() if isinstance(name, str) else name
    if key not in _ALIASES:
        raise ValueError('Undefined precision {0!r} (use float32 or '
                         'bfloat16)'.format(name))
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
    """Honor ``matmul_precision``: 'highest' disables TF32 for cuDNN
    convolutions and CUDA matmuls, process-wide; any other value keeps
    PyTorch's defaults. The section matching the running stage wins."""
    order = (('testing', 'training') if stage in ('test', 'inference')
             else ('training', 'testing'))
    for section in order:
        val = config.get(section, {}).get('matmul_precision', None)
        if val:
            if str(val) == 'highest':
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
            return
