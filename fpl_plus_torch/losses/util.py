"""Loss helpers (channels-first: predictions are ``[N, C, *spatial]``).

Numerics mirror the reference helpers (PyMIC/pymic/loss/seg/util.py:8-107)
and the JAX package's ``losses/util.py``: the classwise-dice smooth term is
1e-5 and the weighted path multiplies the pixel weight into numerator and
denominator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def get_soft_label(label: torch.Tensor, num_class: int,
                   dtype=torch.float32) -> torch.Tensor:
    """One-hot a ``[N, 1, *spatial]`` (or ``[N, *spatial]``) integer label
    map into ``[N, num_class, *spatial]``."""
    if label.dim() > 1 and label.shape[1] == 1:
        label = label[:, 0]
    return F.one_hot(label.long(), num_class).movedim(-1, 1).to(dtype)


def reshape_to_2d(x: torch.Tensor) -> torch.Tensor:
    """[N, C, *spatial] -> [voxels, C]."""
    return x.movedim(1, -1).reshape(-1, x.shape[1])


def get_classwise_dice(predict: torch.Tensor, soft_y: torch.Tensor,
                       pix_w: torch.Tensor = None) -> torch.Tensor:
    """Soft dice per class over [voxels, C] tensors (after softmax)."""
    if pix_w is None:
        y_vol = soft_y.sum(0)
        p_vol = predict.sum(0)
        intersect = (soft_y * predict).sum(0)
    else:
        y_vol = (soft_y * pix_w).sum(0)
        p_vol = (predict * pix_w).sum(0)
        intersect = (soft_y * predict * pix_w).sum(0)
    return (2.0 * intersect + 1e-5) / (y_vol + p_vol + 1e-5)


def softmax_if(predict, softmax: bool) -> torch.Tensor:
    if isinstance(predict, (list, tuple)):
        predict = predict[0]
    if softmax:
        predict = torch.softmax(predict, 1)
    return predict
