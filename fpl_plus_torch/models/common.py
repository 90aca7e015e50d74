"""Shared model building blocks (channels-first, PyTorch's layout).

Models in this package take ``[N, C, D, H, W]`` for 3D and ``[N, C, H, W]``
for 2D, the layout cuDNN and the reference checkpoints use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.parallel.mesh import active_mesh, active_segments


class PReLU(nn.Module):
    """Parametric ReLU slope holder: one shared slope ``weight`` of shape
    [1], init 0.25 (torch ``nn.PReLU()`` layout, reference key
    ``relu_{j}.weight``). ``models/dsbn.py`` applies it: inside the fused
    DSBN+PReLU kernel in eval mode, as ``F.prelu`` after the batch
    statistics in train mode. This module owns the parameter only."""

    def __init__(self, init_value: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), float(init_value)))


def group_rand(shape, generators, device, rows: bool = True
               ) -> torch.Tensor:
    """Uniform draws in [0, 1): ``shape`` from each generator, concatenated
    along axis 0. Within a data-parallel step (``parallel/mesh.py``
    ``active_mesh``) with ``rows``, ``shape[0]`` is this rank's share of a
    group's rows: every generator draws the global batch's rows, as one
    card draws them, and the rank keeps its own slice of the concatenation
    (ranks hold contiguous slices of the global batch, in rank order).
    When the forward's batch is segmented (``batch_segments``: two streams
    in one batch), each generator's draw keeps this rank's rows of each
    segment; a batch folded to ``f`` rows per sample (a 2D net over depth
    slices) has segments ``f`` times as long. Draws of one value per group
    (``rows`` False) are the same on every rank."""
    mesh = active_mesh()
    if mesh is None or not rows:
        return torch.cat([torch.rand(tuple(shape), generator=g,
                                     device=device) for g in generators])
    segments = active_segments()
    if segments is None:
        n_local = shape[0] * len(generators)
        full = torch.cat([torch.rand((shape[0] * mesh.size,)
                                     + tuple(shape[1:]), generator=g,
                                     device=device) for g in generators])
        return full[mesh.rank * n_local:(mesh.rank + 1) * n_local]
    if shape[0] % sum(segments):
        raise ValueError('{0} rows do not fold the segments {1}'.format(
            shape[0], list(segments)))
    fold = shape[0] // sum(segments)
    keep = mesh.segment_slices([fold * n for n in segments])
    parts = []
    for g in generators:
        full = torch.rand((shape[0] * mesh.size,) + tuple(shape[1:]),
                          generator=g, device=device)
        parts.extend(full[s] for s in keep)
    return torch.cat(parts)


def grouped_dropout(x: torch.Tensor, p: float, generators=None
                    ) -> torch.Tensor:
    """Dropout with explicit generators (flax ``nn.Dropout`` semantics).

    ``generators`` None: the identity (eval). M generators: the leading
    batch axis splits into M equal contiguous groups and group m's keep mask
    is drawn from generator m, so a batch that folds M passes draws, group
    by group, the same masks as M separate passes of one group each. Rate 0
    is the identity and draws nothing. A voxel is kept where a uniform draw
    in [0, 1) is below the keep probability ``1 - p``; kept values are
    scaled by ``1 / (1 - p)`` in the activation dtype. Within a
    data-parallel step the mask is the global batch's (``group_rand``)."""
    if p == 0 or generators is None:
        return x
    m = len(generators)
    if x.shape[0] % m:
        raise ValueError('batch {0} does not split into {1} dropout groups'
                         .format(x.shape[0], m))
    keep_prob = 1.0 - p
    shape = (x.shape[0] // m,) + tuple(x.shape[1:])
    keep = group_rand(shape, generators, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


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


def resize_linear(x: torch.Tensor, out_spatial) -> torch.Tensor:
    """Half-pixel linear (bi/tri) resize of ``[N, C, *spatial]`` to
    ``out_spatial`` (``align_corners=False``; an unchanged axis is the
    identity). For the upsampling the deep-supervision heads need, this
    equals ``jax.image.resize(..., 'linear')``: the edge weights there
    renormalise to what the clamped source coordinate gives here."""
    mode = 'trilinear' if x.dim() == 5 else 'bilinear'
    return F.interpolate(x, size=tuple(out_spatial), mode=mode,
                         align_corners=False)


def fold_depth_to_batch(x: torch.Tensor):
    """[N, C, D, H, W] -> [N*D, C, H, W] (a transpose in NCDHW)."""
    n, c, d = x.shape[:3]
    return x.permute(0, 2, 1, 3, 4).reshape((n * d, c) + x.shape[3:]), (n, d)


def unfold_depth_from_batch(x: torch.Tensor, nd) -> torch.Tensor:
    """[N*D, C, H, W] -> [N, C, D, H, W] (a strided view)."""
    n, d = nd
    return x.reshape((n, d) + x.shape[1:]).permute(0, 2, 1, 3, 4)
