"""2D U-Net family: UNet2D (+ ScSE, deep supervision), DualBranch, URPC,
CCT, AttentionUNet2D, NestedUNet2D and COPLENet.

Architecture parity with the JAX package's ``models/unet2d.py`` (the PyMIC
v0.3.0 designs the reference registry names, net_dict_seg.py:33-47). Every
net takes ``[N, C, H, W]`` or a 2.5D ``[N, C, D, H, W]``: depth folds into
the batch (slice-wise 2D segmentation), and each output unfolds back to
``[N, K, D, H, W]``. The conv blocks are ``models/unet3d.py``'s at
``dim = 2``; submodule names follow the flax scopes as described there.

Outputs by mode (``module.train()`` / ``.eval()``; dropout runs only when
the forward is given ``dropout_generators``):

* ``UNet2D`` with ``deep_supervise``: ``[main, aux1, aux2, ...]``, the aux
  heads of the coarser decoder levels resized to full resolution;
* ``UNet2D_DualBranch``: ``[out1, out2]`` in train mode, their mean in
  eval mode;
* ``UNet2D_URPC``: ``[p0, p1, p2, p3]`` at scales 1, 1/2, 1/4, 1/8 (a
  shallow net puts the deepest head on the bottleneck); dropout of rate
  ``0.1 x level`` before each coarser head;
* ``UNet2D_CCT``: in train mode ``[main, aux1, aux2, aux3]``, the aux
  decoders fed the bottleneck after dropout 0.5, feature dropout and
  feature noise, drawn from the generators (required then); in eval mode
  the main decoder's output.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fpl_plus_torch.models.common import (fold_depth_to_batch,
                                          group_rand, grouped_dropout,
                                          max_pool,
                                          resize_linear,
                                          unfold_depth_from_batch,
                                          upsample_align_corners)
from fpl_plus_torch.models.unet3d import (ConvBlock, UpBlock, make_upsampler,
                                          upsample)


def _conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    return nn.Conv2d(in_channels, out_channels, 3, padding=1)


def _fold_apply(x, fn):
    """Fold an optional depth axis into the batch (rows n*D + d, so dropout
    groups over n stay contiguous), apply ``fn``, unfold every output."""
    if x.dim() != 5:
        return fn(x)
    x2d, nd = fold_depth_to_batch(x)
    out = fn(x2d)
    if isinstance(out, list):
        return [unfold_depth_from_batch(o, nd) for o in out]
    return unfold_depth_from_batch(out, nd)


class Encoder2D(nn.Module):
    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], scse: bool = False):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        self.in_conv = ConvBlock(in_chns, ft[0], dp[0], scse, dim=2)
        for i in range(1, len(ft)):
            setattr(self, 'down{0}'.format(i),
                    ConvBlock(ft[i - 1], ft[i], dp[i], scse, dim=2))
        self.levels = len(ft)

    def forward(self, x, dropout_generators=None):
        feats = [self.in_conv(x, dropout_generators)]
        for i in range(1, self.levels):
            feats.append(getattr(self, 'down{0}'.format(i))(
                max_pool(feats[-1]), dropout_generators))
        return feats


class Decoder2D(nn.Module):
    """``up1`` .. ``up{n-1}`` then a 3x3 ``out_conv``; ``multiscale_heads``
    adds ``out_conv{j}`` on the decoder level of ``feature_chns[j]``
    (j = 1 .. n-2), returned after the main output, finest first."""

    def __init__(self, feature_chns: Sequence[int], dropout: Sequence[float],
                 class_num: int, bilinear: bool = True, scse: bool = False,
                 multiscale_heads: bool = False):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        n = len(ft)
        for i in range(n - 1):
            lvl = n - 2 - i
            setattr(self, 'up{0}'.format(i + 1), UpBlock(
                ft[lvl + 1], ft[lvl], ft[lvl], dp[lvl], bilinear, scse, dim=2))
        self.out_conv = _conv3x3(ft[0], class_num)
        self.multiscale_heads = multiscale_heads
        if multiscale_heads:
            for j in range(1, n - 1):
                setattr(self, 'out_conv{0}'.format(j),
                        _conv3x3(ft[j], class_num))
        self.levels = n

    def forward(self, feats, dropout_generators=None):
        d = feats[-1]
        decoder_feats = []
        for i in range(self.levels - 1):
            d = getattr(self, 'up{0}'.format(i + 1))(
                d, feats[self.levels - 2 - i], dropout_generators)
            decoder_feats.append(d)
        output = self.out_conv(d)
        if not self.multiscale_heads:
            return output
        return [output] + [getattr(self, 'out_conv{0}'.format(j + 1))(feat)
                           for j, feat in enumerate(decoder_feats[-2::-1])]


class UNet2D(nn.Module):
    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True, deep_supervise: bool = False,
                 scse: bool = False):
        super().__init__()
        self.encoder = Encoder2D(in_chns, feature_chns, dropout, scse)
        self.decoder = Decoder2D(feature_chns, dropout, class_num, bilinear,
                                 scse, multiscale_heads=deep_supervise)
        self.deep_supervise = deep_supervise

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        out = _fold_apply(x, lambda x2d: self.decoder(self.encoder(x2d, g),
                                                      g))
        if self.deep_supervise:
            spatial = out[0].shape[2:]
            out = [out[0]] + [resize_linear(o, spatial) for o in out[1:]]
        return out


class UNet2DScSE(UNet2D):
    def __init__(self, in_chns, feature_chns, dropout, class_num,
                 bilinear: bool = True, deep_supervise: bool = False):
        super().__init__(in_chns, feature_chns, dropout, class_num, bilinear,
                         deep_supervise, scse=True)


class UNet2DDualBranch(nn.Module):
    """A shared encoder and two decoders (DMPLS / CPS-style methods)."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        self.encoder = Encoder2D(in_chns, feature_chns, dropout)
        self.decoder1 = Decoder2D(feature_chns, dropout, class_num, bilinear)
        self.decoder2 = Decoder2D(feature_chns, dropout, class_num, bilinear)

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators

        def run(x2d):
            feats = self.encoder(x2d, g)
            out1, out2 = self.decoder1(feats, g), self.decoder2(feats, g)
            return [out1, out2] if self.training else (out1 + out2) / 2

        return _fold_apply(x, run)


class UNet2DURPC(nn.Module):
    """UNet2D with pyramid prediction heads ``head{l}`` at scales 1/2^l,
    l = 0..3 (URPC, SSL); the multi-scale output the Inferer accumulates
    head by head."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        n = len(ft)
        self.encoder = Encoder2D(in_chns, ft, dp)
        if n - 1 < 4:
            setattr(self, 'head{0}'.format(n - 1),
                    _conv3x3(ft[n - 1], class_num))
        for i in range(n - 1):
            lvl = n - 2 - i
            setattr(self, 'up{0}'.format(i + 1), UpBlock(
                ft[lvl + 1], ft[lvl], ft[lvl], dp[lvl], bilinear, dim=2))
            if lvl <= 3:
                setattr(self, 'head{0}'.format(lvl),
                        _conv3x3(ft[lvl], class_num))
        self.levels = n

    # the heads' dropout (rate 0.1 x level) draws in train mode even when
    # the network's rates are all 0: the train step must hand generators
    draws_in_train = True

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        n = self.levels

        def run(x2d):
            feats = self.encoder(x2d, g)
            d = feats[-1]
            outs = {}
            if n - 1 < 4:
                outs[n - 1] = getattr(self, 'head{0}'.format(n - 1))(d)
            for i in range(n - 1):
                lvl = n - 2 - i
                d = getattr(self, 'up{0}'.format(i + 1))(d, feats[lvl], g)
                if lvl <= 3:
                    outs[lvl] = getattr(self, 'head{0}'.format(lvl))(
                        grouped_dropout(d, 0.1 * lvl, g) if lvl > 0 else d)
            return [outs[k] for k in sorted(outs)]

        return _fold_apply(x, run)


def _group_uniform(shape, low: float, high: float, generators, device):
    """Uniform draws in [low, high): ``shape`` per generator, the groups
    concatenated along axis 0 (``models/common.py`` ``group_rand``). A 1-D
    ``shape`` holds values of the group, not of its rows: within a
    data-parallel step it is the same on every rank."""
    return group_rand(shape, generators, device,
                      rows=len(shape) > 1) * (high - low) + low


def row_quantile(flat: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-row linear-interpolation quantile of ``flat [N, M]`` at ``q
    [N]``, in the arithmetic of ``jnp.quantile`` (position ``q (M - 1)``,
    weights ``1 - frac`` and ``frac`` on its floor and ceiling)."""
    s = flat.sort(1).values
    pos = q.to(s.dtype) * (s.shape[1] - 1)
    lo, hi = pos.floor(), pos.ceil()
    w_hi = pos - lo
    v_lo = s.gather(1, lo.long()[:, None])[:, 0]
    v_hi = s.gather(1, hi.long()[:, None])[:, 0]
    return v_lo * (1 - w_hi) + v_hi * w_hi


def feature_dropout(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """CCT FeatureDrop: zero the positions whose channel-mean |x| is at or
    above the row's ``q`` quantile (``q [N]``, drawn in [0.7, 0.9))."""
    attention = x.abs().mean(1, keepdim=True)
    thresh = row_quantile(attention.reshape(x.shape[0], -1), q)
    return x * (attention < thresh.reshape((-1,) + (1,) * (x.dim() - 1)))


def feature_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """CCT FeatureNoise: ``x (1 + noise)``, noise drawn in [-0.3, 0.3)."""
    return x * (1.0 + noise)


class UNet2DCCT(nn.Module):
    """UNet2D with one main and three perturbed auxiliary decoders (CCT,
    SSL). Per generator (one per contiguous group of the folded batch) the
    train-mode forward draws, in order: the dropout-0.5 mask of the
    bottleneck, the group's feature-drop quantile and its feature noise."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        self.encoder = Encoder2D(in_chns, feature_chns, dropout)
        self.main_decoder = Decoder2D(feature_chns, dropout, class_num,
                                      bilinear)
        for i in (1, 2, 3):
            setattr(self, 'aux_decoder{0}'.format(i), Decoder2D(
                feature_chns, dropout, class_num, bilinear))

    # the train-mode perturbations draw even when the network's dropout
    # rates are all 0: the train step must hand generators over
    draws_in_train = True

    def perturb(self, bott: torch.Tensor, generators):
        """The three aux-decoder inputs of the bottleneck ``bott``."""
        m = len(generators)
        rows = bott.shape[0] // m
        dropped = grouped_dropout(bott, 0.5, generators)
        q = _group_uniform((1,), 0.7, 0.9, generators, bott.device)
        noise = _group_uniform((rows,) + tuple(bott.shape[1:]), -0.3, 0.3,
                               generators, bott.device).to(bott.dtype)
        return [dropped,
                feature_dropout(bott, q.repeat_interleave(rows)),
                feature_noise(bott, noise)]

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        if self.training and g is None:
            raise ValueError('UNet2D_CCT draws its train-mode perturbations '
                             'from dropout_generators; none were given')

        def run(x2d):
            feats = self.encoder(x2d, g)
            main = self.main_decoder(feats, g)
            if not self.training:
                return main
            return [main] + [
                getattr(self, 'aux_decoder{0}'.format(i + 1))(
                    feats[:-1] + [b], g)
                for i, b in enumerate(self.perturb(feats[-1], g))]

        return _fold_apply(x, run)


class AttentionGate(nn.Module):
    def __init__(self, gate_channels: int, skip_channels: int,
                 inter_channels: int):
        super().__init__()
        self.conv0 = nn.Conv2d(gate_channels, inter_channels, 1)
        self.conv1 = nn.Conv2d(skip_channels, inter_channels, 1)
        self.conv2 = nn.Conv2d(inter_channels, 1, 1)

    def forward(self, gate, skip):
        att = torch.relu(self.conv0(gate) + self.conv1(skip))
        return skip * torch.sigmoid(self.conv2(att))


def _up_name(bilinear: bool, suffix) -> str:
    return ('proj' if bilinear else 'upconv') + str(suffix)


class AttentionUNet2D(nn.Module):
    """UNet2D with attention gates on the skip connections."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        n = len(ft)
        self.encoder = Encoder2D(in_chns, ft, dp)
        for i in range(n - 1):
            lvl = n - 2 - i
            setattr(self, _up_name(bilinear, i + 1), make_upsampler(
                ft[lvl + 1], ft[lvl], bilinear, 2))
            setattr(self, 'att{0}'.format(i + 1), AttentionGate(
                ft[lvl], ft[lvl], max(ft[lvl] // 2, 1)))
            setattr(self, 'dec{0}'.format(i + 1),
                    ConvBlock(2 * ft[lvl], ft[lvl], dp[lvl], dim=2))
        self.out_conv = _conv3x3(ft[0], class_num)
        self.levels, self.bilinear = n, bilinear

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators

        def run(x2d):
            feats = self.encoder(x2d, g)
            d = feats[-1]
            for i in range(1, self.levels):
                up = upsample(getattr(self, _up_name(self.bilinear, i)), d)
                skip = getattr(self, 'att{0}'.format(i))(
                    up, feats[self.levels - 1 - i])
                d = getattr(self, 'dec{0}'.format(i))(
                    torch.cat([skip, up], 1), g)
            return self.out_conv(d)

        return _fold_apply(x, run)


class NestedUNet2D(nn.Module):
    """UNet++: node ``x{i}{j}`` at level i, column j, fed every earlier
    node of its level and the upsampled node below (``proj{i}{j}``)."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        depth = len(ft)
        for i in range(depth):
            setattr(self, 'x{0}0'.format(i), ConvBlock(
                in_chns if i == 0 else ft[i - 1], ft[i], dp[i], dim=2))
        for j in range(1, depth):
            for i in range(depth - j):
                setattr(self, 'proj{0}{1}'.format(i, j),
                        nn.Conv2d(ft[i + 1], ft[i], 1))
                setattr(self, 'x{0}{1}'.format(i, j), ConvBlock(
                    ft[i] * (j + 1), ft[i], dp[i], dim=2))
        self.out_conv = _conv3x3(ft[0], class_num)
        self.depth = depth

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        depth = self.depth

        def run(x2d):
            grid = {}
            for i in range(depth):
                inp = x2d if i == 0 else max_pool(grid[(i - 1, 0)])
                grid[(i, 0)] = getattr(self, 'x{0}0'.format(i))(inp, g)
            for j in range(1, depth):
                for i in range(depth - j):
                    up = upsample_align_corners(getattr(
                        self, 'proj{0}{1}'.format(i, j))(grid[(i + 1, j - 1)]),
                        2)
                    cat = torch.cat([grid[(i, k)] for k in range(j)] + [up], 1)
                    grid[(i, j)] = getattr(self, 'x{0}{1}'.format(i, j))(
                        cat, g)
            return self.out_conv(grid[(0, depth - 1)])

        return _fold_apply(x, run)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling bottleneck (COPLENet): 3x3 convs at
    dilations 1-4 to ``out_channels // 4`` each, then a 1x1 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 2, 3, 4)):
        super().__init__()
        c = out_channels // len(dilations)
        for k, d in enumerate(dilations):
            setattr(self, 'conv{0}'.format(k), nn.Conv2d(
                in_channels, c, 3, padding=d, dilation=d))
        setattr(self, 'conv{0}'.format(len(dilations)),
                nn.Conv2d(c * len(dilations), out_channels, 1))
        self.branches = len(dilations)

    def forward(self, x):
        y = torch.cat([getattr(self, 'conv{0}'.format(k))(x)
                       for k in range(self.branches)], 1)
        return getattr(self, 'conv{0}'.format(self.branches))(y)


class COPLENet(nn.Module):
    """COPLE-Net (Wang et al., IEEE TMI 2020): ScSE conv blocks, an ASPP
    bottleneck, 1x1 ``bridge`` convs on the skips and max-out fusion."""

    def __init__(self, in_chns: int, feature_chns: Sequence[int],
                 dropout: Sequence[float], class_num: int,
                 bilinear: bool = True):
        super().__init__()
        ft, dp = list(feature_chns), list(dropout)
        n = len(ft)
        for i in range(n):
            setattr(self, 'enc{0}'.format(i), ConvBlock(
                in_chns if i == 0 else ft[i - 1], ft[i], dp[i], scse=True,
                dim=2))
        self.aspp = ASPP(ft[-1], ft[-1])
        for lvl in range(n - 1):
            setattr(self, 'bridge{0}'.format(lvl),
                    nn.Conv2d(ft[lvl], ft[lvl], 1))
            setattr(self, _up_name(bilinear, lvl), make_upsampler(
                ft[lvl + 1], ft[lvl], bilinear, 2))
            setattr(self, 'dec{0}'.format(lvl), ConvBlock(
                ft[lvl], ft[lvl], dp[lvl], scse=True, dim=2))
        self.out_conv = _conv3x3(ft[0], class_num)
        self.levels, self.bilinear = n, bilinear

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        g = dropout_generators
        n = self.levels

        def run(x2d):
            feats, h = [], x2d
            for i in range(n):
                h = getattr(self, 'enc{0}'.format(i))(
                    max_pool(h) if i > 0 else h, g)
                feats.append(h)
            h = self.aspp(feats[-1])
            for lvl in range(n - 2, -1, -1):
                skip = getattr(self, 'bridge{0}'.format(lvl))(feats[lvl])
                h = upsample(getattr(self, _up_name(self.bilinear, lvl)), h)
                h = getattr(self, 'dec{0}'.format(lvl))(
                    torch.maximum(skip, h), g)
            return self.out_conv(h)

        return _fold_apply(x, run)
