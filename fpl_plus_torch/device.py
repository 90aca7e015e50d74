"""Explicit device resolution.

Entry points run on the card. They run on the CPU only when the caller asks
for it (``device='cpu'`` or ``--device cpu``); without a card and without
that request they raise. Nothing falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(name: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda:0``; ``'cpu'`` -> the CPU; ``'cuda[:i]'`` -> that
    card. Raises when a card is asked for (or implied) and none exists."""
    dev = torch.device('cuda:0' if name is None else name)
    if dev.type == 'cpu':
        return dev
    if dev.type != 'cuda':
        raise ValueError('unsupported device {0!r} (use cuda[:i] or cpu)'
                         .format(str(dev)))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU")
    if dev.index is None:
        dev = torch.device('cuda', 0)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError('CUDA device {0} requested but only {1} present'
                           .format(dev.index, torch.cuda.device_count()))
    return dev
