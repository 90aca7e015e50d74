"""Shared model building blocks (channels-first, PyTorch's layout).

Models in this package take ``[N, C, D, H, W]`` for 3D and ``[N, C, H, W]``
for 2D, the layout cuDNN and the reference checkpoints use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class PReLU(nn.Module):
    """Parametric ReLU slope holder: one shared slope ``weight`` of shape
    [1], init 0.25 (torch ``nn.PReLU()`` layout, reference key
    ``relu_{j}.weight``). The eval path applies it inside the fused
    DSBN+PReLU kernel (``models/dsbn.py``), so this module owns the
    parameter only."""

    def __init__(self, init_value: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init_value)))


def max_pool(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Max pooling with equal window/stride over all spatial dims."""
    if x.dim() == 5:
        return F.max_pool3d(x, window)
    return F.max_pool2d(x, window)


def upsample_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Linear (bi/tri) upsampling with ``align_corners=True``: source
    coordinate ``i * (n_in - 1) / (n_out - 1)``. An axis of length 1 maps
    every output to its one input, the repeat the JAX version spells out."""
    mode = 'trilinear' if x.dim() == 5 else 'bilinear'
    return F.interpolate(x, scale_factor=factor, mode=mode,
                         align_corners=True)


def fold_depth_to_batch(x: torch.Tensor):
    """[N, C, D, H, W] -> [N*D, C, H, W] (a transpose in NCDHW)."""
    n, c, d = x.shape[:3]
    return x.permute(0, 2, 1, 3, 4).reshape((n * d, c) + x.shape[3:]), (n, d)


def unfold_depth_from_batch(x: torch.Tensor, nd) -> torch.Tensor:
    """[N*D, C, H, W] -> [N, C, D, H, W] (a strided view)."""
    n, d = nd
    return x.reshape((n, d) + x.shape[1:]).permute(0, 2, 1, 3, 4)
