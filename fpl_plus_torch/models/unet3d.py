"""3D U-Net (+ ScSE variant) and the conv blocks the 2D nets share.

Architecture parity with the JAX package's ``models/unet3d.py`` (reference
PyMIC/pymic/net/net3d/unet3d.py:9-160 and unet3d_scse.py): conv blocks are
(conv -> BatchNorm -> LeakyReLU 0.01) x 2 with dropout between, 4 or 5
resolution levels, align-corners trilinear (after a 1x1x1 conv) or k=2/s=2
transposed-conv upsampling, optional deep supervision (3 auxiliary 1x1x1
heads resized to full resolution inside the net). The ScSE variant ends
every conv block with a concurrent spatial + channel squeeze-excitation
(reference scse3d.py:17-116).

``ConvBlock`` and ``UpBlock`` take the spatial rank ``dim`` (2 or 3), so the
2D nets (``models/unet2d.py``) build on them too.

Submodules are named after the flax scopes: explicit names are kept
(``in_conv``, ``down1``, ``up2``, ``out_conv3``), flax's automatic names
become short ones (``Conv_0`` -> ``conv0``, ``ConvTranspose_0`` ->
``convt0``, ``BatchNorm_1`` -> ``bn1``, ``Dense_0`` -> ``fc0``,
``ConvBlock3D_0`` -> ``block``, ``ChannelSpatialSELayer_0`` -> ``scse``,
``ChannelSELayer_0`` -> ``cse``, ``SpatialSELayer_0`` -> ``sse``); the
weight bridge is ``utils/convert.py`` ``state_dict_from_flax``. The eval
BatchNorm + LeakyReLU stay ``F.batch_norm`` + ``F.leaky_relu``: the JAX
package computes them as plain ops too. Dropout draws from explicit
generators (``models/common.py`` ``grouped_dropout``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.models.common import (grouped_dropout, max_pool,
                                          resize_linear,
                                          upsample_align_corners)
from fpl_plus_torch.models.dsbn import BatchNorm


def conv_nd(dim: int):
    return nn.Conv2d if dim == 2 else nn.Conv3d


def conv_transpose_nd(dim: int):
    return nn.ConvTranspose2d if dim == 2 else nn.ConvTranspose3d


class ChannelSELayer(nn.Module):
    """Squeeze-and-excitation over channels (any spatial rank)."""

    def __init__(self, channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.fc0 = nn.Linear(channels, channels // reduction_ratio)
        self.fc1 = nn.Linear(channels // reduction_ratio, channels)

    def forward(self, x):
        squeeze = x.mean(dim=tuple(range(2, x.dim())))
        h = torch.sigmoid(self.fc1(torch.relu(self.fc0(squeeze))))
        return x * h.reshape(h.shape + (1,) * (x.dim() - 2))


class SpatialSELayer(nn.Module):
    """Spatial squeeze-excitation: a 1x1 conv to one channel, sigmoid gate."""

    def __init__(self, channels: int, dim: int):
        super().__init__()
        self.conv0 = conv_nd(dim)(channels, 1, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.conv0(x))


class ChannelSpatialSELayer(nn.Module):
    def __init__(self, channels: int, dim: int, reduction_ratio: int = 2):
        super().__init__()
        self.cse = ChannelSELayer(channels, reduction_ratio)
        self.sse = SpatialSELayer(channels, dim)

    def forward(self, x):
        return torch.maximum(self.cse(x), self.sse(x))


class ConvBlock(nn.Module):
    """(conv 3^dim -> BatchNorm -> LeakyReLU 0.01) x 2, dropout between the
    two, optional ScSE at the end."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_p: float = 0.0, scse: bool = False, dim: int = 3):
        super().__init__()
        self.conv0 = conv_nd(dim)(in_channels, out_channels, 3, padding=1)
        self.bn0 = BatchNorm(out_channels)
        self.conv1 = conv_nd(dim)(out_channels, out_channels, 3, padding=1)
        self.bn1 = BatchNorm(out_channels)
        self.scse = ChannelSpatialSELayer(out_channels, dim) if scse else None
        self.dropout_p = float(dropout_p)

    def forward(self, x, dropout_generators=None):
        x = F.leaky_relu(self.bn0(self.conv0(x)), 0.01)
        x = grouped_dropout(x, self.dropout_p, dropout_generators)
        x = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        return x if self.scse is None else self.scse(x)


def make_upsampler(in_channels: int, out_channels: int, linear: bool,
                   dim: int) -> nn.Module:
    """A 1x1 conv (then an align-corners linear x2 upsample, ``Upsample``)
    or a k=2/s=2 transposed conv."""
    if linear:
        return conv_nd(dim)(in_channels, out_channels, 1)
    return conv_transpose_nd(dim)(in_channels, out_channels, 2, stride=2)


def upsample(layer: nn.Module, x):
    """Apply an upsampler made by ``make_upsampler``."""
    x = layer(x)
    if isinstance(layer, (nn.Conv2d, nn.Conv3d)):
        x = upsample_align_corners(x, 2)
    return x


class UpBlock(nn.Module):
    """Upsample the low-resolution ``x1`` to ``skip_channels``, concatenate
    ``[x2, x1]`` and run a ``ConvBlock``."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, dropout_p: float = 0.0,
                 linear: bool = True, scse: bool = False, dim: int = 3):
        super().__init__()
        self._up = 'conv0' if linear else 'convt0'
        setattr(self, self._up, make_upsampler(in_channels, skip_channels,
                                               linear, dim))
        self.block = ConvBlock(2 * skip_channels, out_channels, dropout_p,
                               scse, dim)

    def forward(self, x1, x2, dropout_generators=None):
        x1 = upsample(getattr(self, self._up), x1)
        return self.block(torch.cat([x2, x1], 1), dropout_generators)


class UNet3D(nn.Module):
    """forward(x [N,C,D,H,W], domain_label (ignored), dropout_generators)
    -> logits [N,class_num,D,H,W], or with ``deep_supervise`` the list
    [logits, aux1, aux2, aux3] (aux heads of the 1/2, 1/4, 1/8 decoder
    levels, resized to full resolution)."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 trilinear: bool = True, deep_supervise: bool = False,
                 scse: bool = False):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        if len(ft) not in (4, 5) or len(dp) != len(ft):
            raise ValueError('UNet3D needs 4 or 5 levels of feature_chns '
                             'and dropout')
        self.in_conv = ConvBlock(in_chns, ft[0], dp[0], scse)
        for i in range(1, len(ft)):
            setattr(self, 'down{0}'.format(i),
                    ConvBlock(ft[i - 1], ft[i], dp[i], scse))
        # up{j} lands on level 4 - j (up1 exists with 5 levels only)
        for j, lvl in enumerate((3, 2, 1, 0), 1):
            if lvl + 1 < len(ft):
                setattr(self, 'up{0}'.format(j), UpBlock(
                    ft[lvl + 1], ft[lvl], ft[lvl], dp[lvl], trilinear, scse))
        self.out_conv = nn.Conv3d(ft[0], class_num, 1)
        self.deep_supervise = deep_supervise
        if deep_supervise:
            for lvl in (1, 2, 3):
                setattr(self, 'out_conv{0}'.format(lvl),
                        nn.Conv3d(ft[lvl], class_num, 1))
        self.levels = len(ft)

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        feats = [self.in_conv(x, g)]
        for i in range(1, self.levels):
            feats.append(getattr(self, 'down{0}'.format(i))(
                max_pool(feats[-1]), g))
        d = {3: self.up1(feats[4], feats[3], g) if self.levels == 5
             else feats[3]}
        for j, lvl in ((2, 2), (3, 1), (4, 0)):
            d[lvl] = getattr(self, 'up{0}'.format(j))(d[lvl + 1], feats[lvl],
                                                      g)
        output = self.out_conv(d[0])
        if not self.deep_supervise:
            return output
        spatial = output.shape[2:]
        return [output] + [resize_linear(getattr(
            self, 'out_conv{0}'.format(lvl))(d[lvl]), spatial)
            for lvl in (1, 2, 3)]


class UNet3DScSE(UNet3D):
    """UNet3D with concurrent spatial + channel squeeze-excitation."""

    def __init__(self, in_chns, feature_chns, dropout, class_num,
                 trilinear: bool = True, deep_supervise: bool = False):
        super().__init__(in_chns, feature_chns, dropout, class_num,
                         trilinear, deep_supervise, scse=True)
