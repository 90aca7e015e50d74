"""UNet2D5 with Domain-Specific Batch Norm, the FPL+ flagship network.

Architecture parity with the reference net
(PyMIC/pymic/net/net3d/unet2d5_dsbn.py:48-309): a 2.5D U-Net with 5
resolution levels whose per-level conv dimension is configurable
(``conv_dims``, e.g. [2,2,3,3,3]); 2D levels run slice-wise by folding depth
into the batch axis and downsample only H/W, 3D levels downsample D/H/W;
every conv is followed by DSBN + PReLU (dropout between the two convs of a
block, drawn from explicit generators: ``models/common.py``
``grouped_dropout``); decoder upsampling is a 1x1 conv + align-corners
linear upsample (``bilinear=True``) or a k=2/s=2 transposed conv; the head
is a Conv3d with kernel (1,3,3).

Module names are the reference checkpoint keys (``block{i}.conv.conv{D}d_{j}``,
``bn{D}d{j}.bns.{d}``, ``relu_{j}``, ``up{j}.trans{D}d`` / ``up{j}.conv{D}d``,
``out_conv``), so reference ``.pt`` state dicts load with ``strict=True``.
Unlike the reference, a block allocates only the conv dimension it uses.
DSBN follows ``module.train()`` / ``.eval()`` (``models/dsbn.py``: batch
statistics and the bank update, or the fused eval kernel). Dropout is on
only when the forward is given ``dropout_generators``, never through
``module.train()``: the train step passes one generator per domain forward,
MC-dropout at test time one per pass.

``Dis`` is the output-space discriminator of the ``dis`` training variant
(reference unet2d5_dsbn.py:190-215, the JAX package's
``models/unet2d5_dsbn.py:213-231``); ``AEs`` the 1x1x1-conv autoencoder
stack of the same file (reference :216-236, JAX :234-249).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.models.common import (PReLU, fold_depth_to_batch,
                                          grouped_dropout, max_pool,
                                          unfold_depth_from_batch,
                                          upsample_align_corners)
from fpl_plus_torch.models.dsbn import DomainBatchNorm, InstanceNorm


def _conv(dim: int):
    return nn.Conv2d if dim == 2 else nn.Conv3d


class ConvBlockND(nn.Module):
    """Two (conv -> DSBN -> PReLU) stages with dropout between them."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_domains: int, dim: int, dropout_p: float = 0.0):
        super().__init__()
        t = '{0}d'.format(dim)
        self._names = [('conv{0}_{1}'.format(t, j), 'bn{0}{1}'.format(t, j),
                        'relu_{0}'.format(j)) for j in (1, 2)]
        for j, (conv, bn, relu) in enumerate(self._names):
            setattr(self, conv, _conv(dim)(in_channels if j == 0
                                           else out_channels,
                                           out_channels, 3, padding=1))
            setattr(self, bn, DomainBatchNorm(out_channels, num_domains))
            setattr(self, relu, PReLU())
        self.dropout_p = float(dropout_p)

    def forward(self, x, domain: int, dropout_generators=None):
        for j, (conv, bn, relu) in enumerate(self._names):
            if j == 1:
                x = grouped_dropout(x, self.dropout_p, dropout_generators)
            x = getattr(self, conv)(x)
            x = getattr(self, bn)(x, domain, getattr(self, relu).weight)
        return x


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_domains: int,
                 dim: int, dropout_p: float = 0.0, downsample: bool = True):
        super().__init__()
        self.dim = dim
        self.downsample = downsample
        self.conv = ConvBlockND(in_channels, out_channels, num_domains, dim,
                                dropout_p)

    def forward(self, x, domain: int, dropout_generators=None):
        fold = self.dim == 2 and x.dim() == 5
        if fold:
            # rows n*D + d: dropout groups over n stay contiguous
            x, nd = fold_depth_to_batch(x)
        out = self.conv(x, domain, dropout_generators)
        out_d = max_pool(out, 2) if self.downsample else None
        if fold:
            out = unfold_depth_from_batch(out, nd)
            if out_d is not None:
                out_d = unfold_depth_from_batch(out_d, nd)
        return out, out_d


class UpBlock(nn.Module):
    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, num_domains: int, dim: int,
                 dropout_p: float = 0.0, bilinear: bool = True):
        super().__init__()
        self.dim = dim
        self.bilinear = bilinear
        t = '{0}d'.format(dim)
        if bilinear:
            self._up = 'conv' + t
            setattr(self, self._up,
                    _conv(dim)(in_channels, skip_channels, 1))
        else:
            self._up = 'trans' + t
            trans = nn.ConvTranspose2d if dim == 2 else nn.ConvTranspose3d
            setattr(self, self._up,
                    trans(in_channels, skip_channels, 2, stride=2))
        self.conv = ConvBlockND(2 * skip_channels, out_channels, num_domains,
                                dim, dropout_p)

    def forward(self, x1, x2, domain: int, dropout_generators=None):
        # x1: low-res decoder feature; x2: high-res encoder skip
        fold = self.dim == 2 and x1.dim() == 5
        if fold:
            x1, nd = fold_depth_to_batch(x1)
            x2, _ = fold_depth_to_batch(x2)
        x1 = getattr(self, self._up)(x1)
        if self.bilinear:
            x1 = upsample_align_corners(x1, 2)
        out = self.conv(torch.cat([x2, x1], dim=1), domain,
                        dropout_generators)
        if fold:
            out = unfold_depth_from_batch(out, nd)
        return out


class UNet2D5DSBN(nn.Module):
    """forward(x [N,C,D,H,W], domain int, dropout_generators=None) ->
    logits [N,class_num,D,H,W]. ``dropout_generators``: None (no dropout)
    or M ``torch.Generator``s on the device of ``x``, one per contiguous
    group of N/M samples (``grouped_dropout``)."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 conv_dims: Sequence[int], dropout: Sequence[float],
                 class_num: int, bilinear: bool = False,
                 num_domains: int = 2):
        super().__init__()
        ft, dims, dp, nd = (list(feature_chns), list(conv_dims),
                            list(dropout), num_domains)
        if not len(ft) == len(dims) == len(dp) == 5:
            raise ValueError('UNet2D5 needs 5 levels of feature_chns, '
                             'conv_dims and dropout')
        self.block0 = DownBlock(in_chns, ft[0], nd, dims[0], dp[0])
        self.block1 = DownBlock(ft[0], ft[1], nd, dims[1], dp[1])
        self.block2 = DownBlock(ft[1], ft[2], nd, dims[2], dp[2])
        self.block3 = DownBlock(ft[2], ft[3], nd, dims[3], dp[3])
        self.block4 = DownBlock(ft[3], ft[4], nd, dims[4], dp[4],
                                downsample=False)
        self.up1 = UpBlock(ft[4], ft[3], ft[3], nd, dims[3], dp[3], bilinear)
        self.up2 = UpBlock(ft[3], ft[2], ft[2], nd, dims[2], dp[2], bilinear)
        self.up3 = UpBlock(ft[2], ft[1], ft[1], nd, dims[1], dp[1], bilinear)
        self.up4 = UpBlock(ft[1], ft[0], ft[0], nd, dims[0], dp[0], bilinear)
        self.out_conv = nn.Conv3d(ft[0], class_num, (1, 3, 3),
                                  padding=(0, 1, 1))

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        x0, x0_d = self.block0(x, domain_label, g)
        x1, x1_d = self.block1(x0_d, domain_label, g)
        x2, x2_d = self.block2(x1_d, domain_label, g)
        x3, x3_d = self.block3(x2_d, domain_label, g)
        x4, _ = self.block4(x3_d, domain_label, g)
        y = self.up1(x4, x3, domain_label, g)
        y = self.up2(y, x2, domain_label, g)
        y = self.up3(y, x1, domain_label, g)
        y = self.up4(y, x0, domain_label, g)
        return self.out_conv(y)


class UNet2D5(UNet2D5DSBN):
    """Plain-BN UNet2D5 (reference net3d/unet2d5.py) = DSBN with one bank."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 conv_dims: Sequence[int], dropout: Sequence[float],
                 class_num: int, bilinear: bool = False):
        super().__init__(in_chns, feature_chns, conv_dims, dropout,
                         class_num, bilinear, num_domains=1)

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        return super().forward(x, 0, dropout_generators)


class Dis(nn.Module):
    """LSGAN 3D patch discriminator on softmax maps ``[N, in_chns, D, H,
    W]``: 4x4x4 convolutions with padding 1 (64 stride 2, 128 stride 2, 256
    stride 2, 512, 1), LeakyReLU 0.2 after the first four, InstanceNorm
    after the second to the fourth."""

    def __init__(self, in_chns: int):
        super().__init__()
        chns = [in_chns, 64, 128, 256, 512]
        self.convs = nn.ModuleList(
            nn.Conv3d(chns[i], chns[i + 1], 4, stride=2 if i < 3 else 1,
                      padding=1) for i in range(4))
        self.norms = nn.ModuleList(InstanceNorm(c) for c in chns[2:])
        self.out_conv = nn.Conv3d(512, 1, 4, padding=1)

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x)
            x = F.leaky_relu(x, 0.2)
        return self.out_conv(x)


class AEs(nn.Module):
    """1x1x1-conv autoencoder ``[N, in_chns, D, H, W] -> [N, in_chns, D, H,
    W]``: convolutions to 64, 128, 64 and back to ``in_chns`` channels,
    LeakyReLU 0.2 after the first three, InstanceNorm after the second and
    third. ``conv{k}`` is flax's ``Conv_{k}``; the domain is ignored."""

    def __init__(self, in_chns: int = 1):
        super().__init__()
        chns = [in_chns, 64, 128, 64, in_chns]
        for k in range(4):
            setattr(self, 'conv{0}'.format(k),
                    nn.Conv3d(chns[k], chns[k + 1], 1))
        self.norms = nn.ModuleList(InstanceNorm(c) for c in (128, 64))

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        for k in range(3):
            x = getattr(self, 'conv{0}'.format(k))(x)
            if k > 0:
                x = self.norms[k - 1](x)
            x = F.leaky_relu(x, 0.2)
        return self.conv3(x)
