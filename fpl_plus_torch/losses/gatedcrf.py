"""Gated CRF loss for weakly-supervised segmentation (channels-first).

Parity with the JAX package's ``losses/gatedcrf.py`` (itself the reference
PyMIC/pymic/loss/seg/gatedcrf.py:9-184): a weighted sum of Gaussian kernels
over a ``(2r+1)^2`` neighbourhood, built from the XY mesh and image
features each divided by its sigma, the centre tap zeroed, gated by the
optional ``mask_src`` / ``mask_dst``, and contracted with the unfolded
softmax under the Potts shortcut (``sum(kernels) - sum(K * unfold(y) * y)``).
The neighbourhood is a stack of zero-padded spatial shifts, as in the JAX
package: ``_unfold(x)[:, t]`` holds ``x`` read at ``(h + dy - r, w + dx -
r)`` for tap ``t = dy (2r+1) + dx``. Inputs are ``[N, C, H, W]`` (a volume
is folded slice-wise by the caller). It is not a ``SegLossDict`` entry.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _unfold(x: torch.Tensor, radius: int) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, d*d, C, H, W]`` of zero-padded shifts."""
    h, w = x.shape[2:]
    d = 2 * radius + 1
    padded = F.pad(x, (radius, radius, radius, radius))
    return torch.stack([padded[:, :, dy:dy + h, dx:dx + w]
                        for dy in range(d) for dx in range(d)], 1)


def _get_mesh(n: int, h: int, w: int, device) -> torch.Tensor:
    """``[N, 2, H, W]``: the column index, then the row index."""
    xx = torch.arange(w, dtype=torch.float32, device=device)
    yy = torch.arange(h, dtype=torch.float32, device=device)
    return torch.stack([xx[None, :].expand(h, w),
                        yy[:, None].expand(h, w)])[None].expand(n, 2, h, w)


def _kernels_from_features(features: torch.Tensor,
                           radius: int) -> torch.Tensor:
    """``[N, C, H, W]`` features -> Gaussian kernel ``[N, d*d, 1, H, W]``
    with the centre tap zeroed."""
    diff = _unfold(features, radius) - features[:, None]
    kern = torch.exp((-0.5 * diff ** 2).sum(2, keepdim=True))
    centre = radius * (2 * radius + 1) + radius
    kern[:, centre] = 0.0
    return kern


def _binary_mask(mask: torch.Tensor) -> torch.Tensor:
    mask = torch.nan_to_num(mask)
    return torch.where(mask < 1.0, torch.zeros_like(mask), mask)


class GatedCRFLoss:
    """``loss(y_hat_softmax [N, C, H, W], kernels_desc, kernels_radius,
    sample, height_input, width_input, mask_src=None, mask_dst=None) ->
    {'loss'}``. ``kernels_desc``: dicts of ``weight`` and feature sigmas
    (``xy`` the mesh, any other key an image of ``sample`` already at the
    prediction's resolution); masks ``[N, 1, H, W]``."""

    def __call__(self, y_hat_softmax, kernels_desc, kernels_radius, sample,
                 height_input, width_input, mask_src=None, mask_dst=None):
        n, _, h, w = y_hat_softmax.shape
        kernels = None
        for desc in kernels_desc:
            feats = torch.cat([
                (_get_mesh(n, h, w, y_hat_softmax.device) if key == 'xy'
                 else sample[key]) / sigma
                for key, sigma in desc.items() if key != 'weight'], 1)
            kern = desc['weight'] * _kernels_from_features(feats,
                                                           kernels_radius)
            kernels = kern if kernels is None else kernels + kern
        denom = n * h * w
        if mask_src is not None:
            mask_src = _binary_mask(mask_src)
            denom = torch.clamp(mask_src.sum(), min=1)
            kernels = kernels * _unfold(mask_src, kernels_radius)
        if mask_dst is not None:
            mask_dst = _binary_mask(mask_dst)
            denom = torch.clamp(mask_dst.sum(), min=1)
            kernels = kernels * mask_dst[:, None]
        y_unfold = _unfold(y_hat_softmax, kernels_radius)
        product = (kernels * y_unfold).sum(1)
        loss = kernels.sum() - (product * y_hat_softmax).sum()
        return {'loss': loss / denom}
