"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266) as MONAI publishes it:
``monai.networks.nets.SwinUNETR`` v1.x with ``use_v2=False`` and
``downsample="merging"``, 3D, under MONAI's parameter names, so that a
state dict of MONAI's network loads with ``strict=True``.

* Encoder ``swinViT``: a k=2/s=2 Conv3d patch embedding to ``feature_size``
  channels, then four stages of ``depths[i]`` Swin blocks at ``feature_size
  x 2^i`` channels and ``num_heads[i]`` heads, each stage ending in patch
  merging. A block is ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``;
  the MLP is Linear(C, 4C), exact GELU, Linear(4C, C). Each of the five
  hidden states (the embedding and each stage's output) goes through
  ``proj_out``, a LayerNorm with no affine.
* Window attention: the window is 7 per axis, clipped to the axis's size
  where that size is 7 or less; the shift is 3 in odd blocks, 0 on a
  clipped axis. After ``norm1`` the tokens are zero-padded at the end of
  each axis to a whole number of windows, and the padded tokens take part
  in attention unmasked. A shifted block rolls by -shift, masks the pairs
  of tokens from different regions of ``compute_mask`` with -100, and
  rolls back. The bias is ``table[(2*7-1)^3, heads]`` indexed by the 7^3
  relative index sliced ``[:n, :n]``.
* Patch merging is MONAI's legacy ``PatchMerging``, kept as written: its
  eight strided views are ``(0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,0,1),
  (0,1,0), (0,0,1), (1,1,1)`` (depth, height, width offsets), so two views
  repeat and ``(1,1,0)`` and ``(0,1,1)`` are left out, where the paper
  concatenates all eight of the 2x2x2 neighbourhood. LayerNorm(8C), then
  Linear(8C, 2C) without bias.
* Decoder: ``UnetResBlock`` s (conv3 without bias, InstanceNorm without
  affine, LeakyReLU 0.01, a 1x1 conv and InstanceNorm on the skip where
  the channels change) on the input and on hidden states 0, 1, 2 and 4;
  ``UnetrUpBlock`` s (a k=2/s=2 transposed conv without bias, concatenated
  before the skip, then a res block); a 1x1 output conv with bias.
* Two departures widen what MONAI takes and change no answer that it
  gives: an input axis that is not a multiple of 32 is zero-padded at its
  end and the logits cropped back (MONAI refuses such an input), and an
  instance norm of a single voxel gives 0 (PyTorch's refuses it).

Eval mode runs the attention through the fused kernel
(``ops/window_attention.py``: on the card the Triton kernel, one launch a
block, 8 a forward at the default depths; on the CPU its plain version);
train mode runs the plain, differentiable version and never reaches the
kernel. The network has one normalisation bank and no dropout: it ignores
the domain and the dropout generators. The forward's two parts are program
spans, ``swin_vit`` (patch embedding through the last ``proj_out``) and
``unetr_decoder`` (the res blocks, the up path and the head).
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fpl_plus_torch.ops.window_attention import (relative_position_index,
                                                 window_attention,
                                                 window_attention_reference)
from fpl_plus_torch.utils.trace_metrics import span

WINDOW = (7, 7, 7)
PATCH = 2
MLP_RATIO = 4
# five halvings: the patch embedding and four patch mergings
DIVISOR = 32


def window_and_shift(dims: Sequence[int], window, shift):
    """MONAI's ``get_window_size``: on an axis no longer than the window
    the window is the axis and the shift 0."""
    win, sh = list(window), list(shift)
    for i, d in enumerate(dims):
        if d <= window[i]:
            win[i], sh[i] = d, 0
    return tuple(win), tuple(sh)


def window_partition(x, window):
    """``[B, D, H, W, C]`` -> ``[B * nW, n, C]``, windows depth-major."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // window[0], window[0], h // window[1], window[1],
               w // window[2], window[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, window[0] * window[1] * window[2], c)


def window_reverse(windows, window, dims):
    """``window_partition``'s inverse: ``[B * nW, n, C]`` -> ``[B, D, H, W,
    C]``."""
    b, d, h, w = dims
    x = windows.view(b, d // window[0], h // window[1], w // window[2],
                     window[0], window[1], window[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_regions(dims: Sequence[int], window, shift) -> torch.Tensor:
    """MONAI's ``compute_mask`` regions of the padded grid ``dims`` (D, H,
    W), as ``[nW, n]`` region ids per window: two tokens of one window are
    masked where their ids differ. The slices are MONAI's, so on an axis
    whose shift is 0 the last slice covers the whole axis."""
    img = torch.zeros((1,) + tuple(dims) + (1,))
    cnt = 0
    for sd, sh, sw in itertools.product(*[
            (slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift)]):
        img[:, sd, sh, sw, :] = cnt
        cnt += 1
    return window_partition(img, window).squeeze(-1).to(torch.int32)


def _conv(cls, *args, **kwargs) -> nn.Sequential:
    """A convolution under MONAI's ``Convolution`` name, ``<name>.conv``."""
    return nn.Sequential(collections.OrderedDict(
        conv=cls(*args, **kwargs)))


class PatchEmbed(nn.Module):
    """A k=2/s=2 Conv3d. MONAI's pads an axis to a multiple of the patch;
    the network pads its input to multiples of 32 first, so nothing is
    padded here."""

    def __init__(self, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv3d(in_chans, embed_dim, PATCH, stride=PATCH)

    def forward(self, x):
        return self.proj(x)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class WindowAttention(nn.Module):
    """The qkv linear, the attention of each (window, head) with the
    relative-position bias and an optional shift mask, and ``proj``.

    ``relative_position_index`` is MONAI's buffer, kept so that MONAI's
    state dicts load; the attention computes the same index from the
    window (``ops/window_attention.py``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        rows = 1
        for w in WINDOW:
            rows *= 2 * w - 1
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(rows, num_heads))
        self.register_buffer('relative_position_index',
                             relative_position_index(WINDOW).clone())
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, regions=None):
        attend = (window_attention_reference if self.training
                  else window_attention)
        return self.proj(attend(self.qkv(x), self.relative_position_bias_table,
                                self.num_heads, WINDOW, regions))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, shift: bool):
        super().__init__()
        self.shift = tuple(w // 2 for w in WINDOW) if shift else (0, 0, 0)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, MLP_RATIO * dim)

    def _attention(self, x, regions):
        b, d, h, w, c = x.shape
        window, shift = window_and_shift((d, h, w), WINDOW, self.shift)
        x = self.norm1(x)
        pad = [(window[i] - s % window[i]) % window[i]
               for i, s in enumerate((d, h, w))]
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        dims = (b,) + tuple(x.shape[1:4])
        shifted = any(shift)
        if shifted:
            x = torch.roll(x, shifts=tuple(-s for s in shift),
                           dims=(1, 2, 3))
        out = self.attn(window_partition(x, window),
                        regions(dims[1:], window, shift) if shifted
                        else None)
        x = window_reverse(out, window, dims)
        if shifted:
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        if any(pad):
            x = x[:, :d, :h, :w, :]
        return x

    def forward(self, x, regions):
        x = x + self._attention(x, regions)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's legacy (v0.9) ``PatchMerging`` for 3D, with its views. Every
    stage's grid is even (the network's input is a multiple of 32), so
    MONAI's padding of an odd axis never applies."""

    VIEWS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
             (0, 1, 0), (0, 0, 1), (1, 1, 1))

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x):
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in self.VIEWS],
                      -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: ``depth`` blocks, unshifted and shifted in turn, then
    patch merging; channels-first in and out."""

    def __init__(self, dim: int, depth: int, num_heads: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, shift=i % 2 == 1)
            for i in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x, regions):
        x = x.permute(0, 2, 3, 4, 1)
        for blk in self.blocks:
            x = blk(x, regions)
        return self.downsample(x).permute(0, 4, 1, 2, 3)


class SwinTransformer(nn.Module):
    def __init__(self, in_chans: int, embed_dim: int, depths, num_heads):
        super().__init__()
        self.patch_embed = PatchEmbed(in_chans, embed_dim)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, 'layers{0}'.format(i + 1), nn.ModuleList([
                BasicLayer(embed_dim * 2 ** i, depth, heads)]))
        self.num_layers = len(depths)
        # the shift regions of each (padded grid, window, shift), per device
        self._regions: Dict[Tuple, torch.Tensor] = {}

    def regions(self, dims, window, shift) -> torch.Tensor:
        key = (tuple(dims), window, shift, self.patch_embed.proj.weight.device)
        if key not in self._regions:
            self._regions[key] = shift_regions(dims, window, shift).to(key[3])
        return self._regions[key]

    @staticmethod
    def proj_out(x):
        """LayerNorm over the channels of ``[N, C, D, H, W]``, no affine."""
        return F.layer_norm(x.permute(0, 2, 3, 4, 1), x.shape[1:2]).permute(
            0, 4, 1, 2, 3)

    def forward(self, x):
        x = self.patch_embed(x)
        out = [self.proj_out(x)]
        for i in range(self.num_layers):
            x = getattr(self, 'layers{0}'.format(i + 1))[0](x, self.regions)
            out.append(self.proj_out(x))
        return out


class InstanceNorm(nn.InstanceNorm3d):
    """InstanceNorm without affine. A map of one voxel normalises to 0
    (its value minus its own mean), where PyTorch's, and so MONAI's,
    refuses it: the deepest stage of a window of 32 on every axis."""

    def forward(self, x):
        if x[0, 0].numel() == 1:
            return torch.zeros_like(x)
        return super().forward(x)


class UnetResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _conv(nn.Conv3d, in_channels, out_channels, 3,
                           padding=1, bias=False)
        self.conv2 = _conv(nn.Conv3d, out_channels, out_channels, 3,
                           padding=1, bias=False)
        self.norm1 = InstanceNorm(out_channels)
        self.norm2 = InstanceNorm(out_channels)
        if in_channels != out_channels:
            self.conv3 = _conv(nn.Conv3d, in_channels, out_channels, 1,
                               bias=False)
            self.norm3 = InstanceNorm(out_channels)

    def forward(self, x):
        out = F.leaky_relu(self.norm1(self.conv1(x)), 0.01, inplace=True)
        out = self.norm2(self.conv2(out))
        if hasattr(self, 'conv3'):
            x = self.norm3(self.conv3(x))
        return F.leaky_relu(out + x, 0.01, inplace=True)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp_conv = _conv(nn.ConvTranspose3d, in_channels,
                                 out_channels, 2, stride=2, bias=False)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels)

    def forward(self, x, skip):
        return self.conv_block(torch.cat((self.transp_conv(x), skip), 1))


class UnetOutBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv(nn.Conv3d, in_channels, out_channels, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class SwinUNETR(nn.Module):
    """``forward(x [N, in_chns, D, H, W], domain_label=0,
    dropout_generators=None)`` -> logits ``[N, class_num, D, H, W]``. An
    axis that is not a multiple of 32 (the five halvings) is zero-padded at
    its end to the next multiple and the logits cropped back, where MONAI
    refuses the input; a multiple of 32 runs as in MONAI."""

    def __init__(self, in_chns: int, class_num: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24)):
        super().__init__()
        fs = feature_size
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError('SwinUNETR takes four stages, got depths {0} and '
                             'num_heads {1}'.format(depths, num_heads))
        self.swinViT = SwinTransformer(in_chns, fs, depths, num_heads)
        self.encoder1 = UnetrBasicBlock(in_chns, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, class_num)

    def forward(self, x, domain_label: int = 0, dropout_generators=None):
        dims = tuple(x.shape[2:])
        pad = [-d % DIVISOR for d in dims]
        if any(pad):
            x = F.pad(x, (0, pad[2], 0, pad[1], 0, pad[0]))
        with span('swin_vit'):
            hidden = self.swinViT(x)
        with span('unetr_decoder'):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hidden[0])
            enc2 = self.encoder3(hidden[1])
            enc3 = self.encoder4(hidden[2])
            dec4 = self.encoder10(hidden[4])
            dec3 = self.decoder5(dec4, hidden[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            out = self.out(self.decoder1(dec0, enc0))
            if any(pad):
                out = out[:, :, :dims[0], :dims[1], :dims[2]]
            return out
