"""Plain PyTorch reference of Swin UNETR (Hatamizadeh et al.,
arXiv:2201.01266) as MONAI publishes it (``monai.networks.nets.SwinUNETR``
v1.x, ``use_v2=False``, ``downsample="merging"``; the BTCV configuration of
Project-MONAI/research-contributions, SwinUNETR/BTCV), as a function of a
dict of weights under MONAI's parameter names.

It imports nothing of the program. The benchmark makes the weights from
the seed (``make_weights``) and hands the same dict to the program (as its
checkpoint, loaded with ``strict=True``) and to ``Net`` here.

The network (f32, TF32 off in the judge): a k=2/s=2 convolution embeds 2^3
patches in ``feature_size`` channels; four stages of Swin blocks
(``x + W-MSA(LN(x))``, then ``x + MLP(LN(x))``, the MLP Linear(C, 4C), exact
GELU, Linear(4C, C)) at windows of 7^3 tokens, the odd blocks' windows
shifted by 3; patch merging after each stage; each of the five hidden states
layer-normed without affine; a convolutional decoder of residual blocks
(3^3 convolutions without bias, instance norm without affine, LeakyReLU
0.01) and k=2/s=2 transposed convolutions, with skips from the input and
every hidden state; a 1x1 head.

Where MONAI departs from the paper, this follows MONAI, which the program
reproduces:

* on an axis no longer than 7 the window is the axis and the shift 0;
* the tokens are zero-padded after the first LayerNorm to a whole number of
  windows, and the padded tokens are attended to unmasked;
* the shift mask is ``compute_mask``'s: -100 between tokens of two regions
  (a region is a product of the slices ``[:-w], [-w:-s], [-s:]`` per axis,
  the last slice the whole axis where the shift is 0);
* the bias of a window of n < 343 tokens is the 7^3 window's relative
  index sliced ``[:n, :n]``;
* patch merging concatenates MONAI's legacy eight views, two of them
  repeated (``(0,1,0)`` and ``(0,0,1)``) in place of ``(1,1,0)`` and
  ``(0,1,1)`` of the paper's 2x2x2 neighbourhood.

Where MONAI refuses an input, this takes it, as the program does: an axis
that is not a multiple of 32 is zero-padded at its end and the logits
cropped back, and the instance norm of a single voxel (the deepest stage of
a window of 32 a side) gives 0.

A configuration names this file under ``reference``; the harness uses it
through the four functions of ``benchmark/README.md``:

* ``Net(net_cfg, weights)``, called as ``(x, domain, train=False,
  generators=None)``: logits ``[N, class_num, D, H, W]`` (no dropout, one
  normalisation bank: the domain and the generators are not read);
* ``make_weights(net_cfg, seed, device)``;
* ``calibrate_foreground(net_cfg, weights, window, domain, share)``;
* ``work_per_window(net_cfg, window, itemsize=4)``: ``macs_by_class``
  (``conv``: every convolution; ``matmul``: the linears and the attention's
  QK^T and PV) and ``kernels: {'window_attention': {'bytes', 'launches'}}``,
  counted from the layer shapes.

Besides, ``window_attention_flops(net_cfg, window)``: the operations of the
program's window-attention kernel in one window's forward.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
WINDOW = (7, 7, 7)
PATCH = 2
MLP_RATIO = 4
MERGE_VIEWS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1),
               (0, 1, 0), (0, 0, 1), (1, 1, 1))


def _widths(net: dict):
    fs = net.get('feature_size', 48)
    depths = list(net.get('depths', (2, 2, 2, 2)))
    heads = list(net.get('num_heads', (3, 6, 12, 24)))
    return fs, depths, heads


def relative_index(window=WINDOW) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of the window: ``[W, W]``."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(w) for w in window],
                                        indexing='ij'))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window[0] - 1
    rel[:, :, 1] += window[1] - 1
    rel[:, :, 2] += window[2] - 1
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def _res_spec(prefix, cin, cout):
    spec = [(prefix + '.conv1.conv.weight', (cout, cin, 3, 3, 3), 'he'),
            (prefix + '.conv2.conv.weight', (cout, cout, 3, 3, 3), 'he')]
    if cin != cout:
        spec.append((prefix + '.conv3.conv.weight', (cout, cin, 1, 1, 1),
                     'he'))
    return spec


def param_spec(net: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every weight and buffer, in a fixed order.
    Kinds: ``he`` (convolution weights), ``he_transposed``, ``bias``
    (convolution biases), ``trunc`` (linear weights and biases), ``qkv``
    (the qkv linears' weights), ``table`` (the bias tables), ``ln_weight``,
    ``ln_bias``, ``index`` (the relative index)."""
    fs, depths, heads = _widths(net)
    cin = net['in_chns']
    rows = 1
    for w in WINDOW:
        rows *= 2 * w - 1
    spec = [('swinViT.patch_embed.proj.weight', (fs, cin) + (PATCH,) * 3,
             'he'),
            ('swinViT.patch_embed.proj.bias', (fs,), 'bias')]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = fs * 2 ** i
        stage = 'swinViT.layers{0}.0.'.format(i + 1)
        for b in range(depth):
            blk = stage + 'blocks.{0}.'.format(b)
            spec += [(blk + 'norm1.weight', (c,), 'ln_weight'),
                     (blk + 'norm1.bias', (c,), 'ln_bias'),
                     (blk + 'attn.relative_position_bias_table', (rows, h),
                      'table'),
                     (blk + 'attn.relative_position_index',
                      (len(relative_index()),) * 2, 'index'),
                     (blk + 'attn.qkv.weight', (3 * c, c), 'qkv'),
                     (blk + 'attn.qkv.bias', (3 * c,), 'trunc'),
                     (blk + 'attn.proj.weight', (c, c), 'trunc'),
                     (blk + 'attn.proj.bias', (c,), 'trunc'),
                     (blk + 'norm2.weight', (c,), 'ln_weight'),
                     (blk + 'norm2.bias', (c,), 'ln_bias'),
                     (blk + 'mlp.linear1.weight', (MLP_RATIO * c, c),
                      'trunc'),
                     (blk + 'mlp.linear1.bias', (MLP_RATIO * c,), 'trunc'),
                     (blk + 'mlp.linear2.weight', (c, MLP_RATIO * c),
                      'trunc'),
                     (blk + 'mlp.linear2.bias', (c,), 'trunc')]
        spec += [(stage + 'downsample.reduction.weight', (2 * c, 8 * c),
                  'trunc'),
                 (stage + 'downsample.norm.weight', (8 * c,), 'ln_weight'),
                 (stage + 'downsample.norm.bias', (8 * c,), 'ln_bias')]
    for name, a, b in (('encoder1', cin, fs), ('encoder2', fs, fs),
                       ('encoder3', 2 * fs, 2 * fs),
                       ('encoder4', 4 * fs, 4 * fs),
                       ('encoder10', 16 * fs, 16 * fs)):
        spec += _res_spec(name + '.layer', a, b)
    for name, a, b in (('decoder5', 16 * fs, 8 * fs),
                       ('decoder4', 8 * fs, 4 * fs),
                       ('decoder3', 4 * fs, 2 * fs), ('decoder2', 2 * fs, fs),
                       ('decoder1', fs, fs)):
        spec.append((name + '.transp_conv.conv.weight', (a, b, 2, 2, 2),
                     'he_transposed'))
        spec += _res_spec(name + '.conv_block', 2 * b, b)
    spec += [('out.conv.conv.weight', (net['class_num'], fs, 1, 1, 1), 'he'),
             ('out.conv.conv.bias', (net['class_num'],), 'bias')]
    return spec


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights, made on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` in two draws (one normal, one uniform) that the tensors
    slice: He-normal convolution weights (fan-in: input channels x taps; a
    transposed convolution's input channels), convolution biases N(0,
    0.05), linear weights and biases from a normal of std 0.02 truncated at
    2 std (MONAI's ``trunc_normal_``, drawn by the inverse of the normal's
    CDF), LayerNorm scales U(0.8, 1.2) and shifts N(0, 0.05), away from
    their 1 / 0 initialisation; the relative index as MONAI builds it.

    The attention is made selective, as a trained network's is: at MONAI's
    initial std of 0.02 every score is within a few tenths of 0 and the
    softmax near uniform, so that a wrong bias row, region or scale would
    hardly move the logits. The qkv weights of a block of C channels take
    the truncated normal at std sqrt(3 / C), so that q k^T d^-1/2 spreads
    by about 3 at every stage, and the bias tables at std 2."""
    spec = param_spec(net)
    normal_kinds = ('he', 'he_transposed', 'bias', 'ln_bias')
    unif_kinds = ('trunc', 'qkv', 'table', 'ln_weight')
    trunc_std = {'trunc': lambda shape: 0.02, 'table': lambda shape: 2.0,
                 'qkv': lambda shape: (3.0 / shape[1]) ** 0.5}
    n_normal = sum(_numel(s) for _, s, k in spec if k in normal_kinds)
    n_unif = sum(_numel(s) for _, s, k in spec if k in unif_kinds)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    weights, i_n, i_u = {}, 0, 0
    for name, shape, kind in spec:
        n = _numel(shape)
        if kind in normal_kinds:
            v = normal[i_n:i_n + n].view(shape)
            i_n += n
            if kind == 'he':
                v = v * (2.0 / (n // shape[0])) ** 0.5
            elif kind == 'he_transposed':
                v = v * (2.0 / shape[0]) ** 0.5
            else:
                v = v * 0.05
        elif kind in unif_kinds:
            u = unif[i_u:i_u + n].view(shape)
            i_u += n
            if kind in trunc_std:
                p = lo + (1.0 - 2.0 * lo) * u
                v = (torch.erfinv(2.0 * p - 1.0) * math.sqrt(2.0)
                     * trunc_std[kind](shape))
            else:
                v = u * 0.4 + 0.8
        else:
            v = relative_index().to(device)
        weights[name] = v.contiguous()
    return weights


def calibrate_foreground(net: dict, weights: Dict[str, torch.Tensor],
                         window: torch.Tensor, domain: int,
                         share: float) -> None:
    """Shift the head's class-1 bias so that ``share`` of the voxels of
    ``window [1, C, D, H, W]`` come out as foreground, as a trained
    generator labels a small tumour in a large volume. In place; two
    classes."""
    if net['class_num'] != 2:
        raise ValueError('the foreground calibration takes two classes')
    with torch.no_grad():
        logits = Net(net, weights)(window, domain)[0]
        margin = (logits[1] - logits[0]).flatten().float()
        k = max(1, int(round((1.0 - share) * margin.numel())))
        weights['out.conv.conv.bias'][1] -= margin.kthvalue(k).values


def window_and_shift(dims, shift):
    win, sh = list(WINDOW), list(shift)
    for i, d in enumerate(dims):
        if d <= WINDOW[i]:
            win[i], sh[i] = d, 0
    return tuple(win), tuple(sh)


def _partition(x, win):
    b, d, h, w, c = x.shape
    x = x.view(b, d // win[0], win[0], h // win[1], win[1], w // win[2],
               win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, win[0] * win[1] * win[2], c)


def _reverse(windows, win, dims):
    b, d, h, w = dims
    x = windows.view(b, d // win[0], h // win[1], w // win[2], win[0],
                     win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def compute_mask(dims, win, shift, device) -> torch.Tensor:
    """MONAI's ``compute_mask``: ``[nW, n, n]``, -100 between tokens of two
    regions, else 0."""
    img = torch.zeros((1,) + tuple(dims) + (1,), device=device)
    cnt = 0
    for d in (slice(-win[0]), slice(-win[0], -shift[0]),
              slice(-shift[0], None)):
        for h in (slice(-win[1]), slice(-win[1], -shift[1]),
                  slice(-shift[1], None)):
            for w in (slice(-win[2]), slice(-win[2], -shift[2]),
                      slice(-shift[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    m = _partition(img, win).squeeze(-1)
    mask = m.unsqueeze(1) - m.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


class Net:
    """``Net(net_cfg, weights)(x, domain, train=False, generators=None)``
    -> logits ``[N, class_num, D, H, W]`` of ``x [N, in_chns, D, H, W]``;
    an axis that is not a multiple of 32 is zero-padded at its end to the
    next multiple and the logits cropped back.

    Observers for the counts of work: ``on_conv(kind, x, w, out)`` (kind
    ``conv`` or ``transposed``), ``on_linear(x, w)`` and
    ``on_attention(windows, n, c)`` (one block's window attention over
    ``windows`` windows of ``n`` tokens and ``c`` channels)."""

    def __init__(self, net: dict, weights: Dict[str, torch.Tensor],
                 on_conv=None, on_linear=None, on_attention=None):
        self.net = net
        self.w = weights
        self.fs, self.depths, self.heads = _widths(net)
        self.on_conv = on_conv
        self.on_linear = on_linear
        self.on_attention = on_attention

    # -- layers ------------------------------------------------------------
    def _conv(self, name, x, stride=1, padding=0):
        w = self.w[name + '.weight']
        out = F.conv3d(x, w, self.w.get(name + '.bias'), stride=stride,
                       padding=padding)
        if self.on_conv is not None:
            self.on_conv('conv', x, w, out)
        return out

    def _transposed(self, name, x):
        w = self.w[name + '.weight']
        out = F.conv_transpose3d(x, w, stride=2)
        if self.on_conv is not None:
            self.on_conv('transposed', x, w, out)
        return out

    def _linear(self, name, x):
        w = self.w[name + '.weight']
        if self.on_linear is not None:
            self.on_linear(x, w)
        out = x @ w.t()
        b = self.w.get(name + '.bias')
        return out if b is None else out + b

    def _layer_norm(self, name, x):
        return F.layer_norm(x, x.shape[-1:], self.w[name + '.weight'],
                            self.w[name + '.bias'], EPS)

    @staticmethod
    def _instance_norm(x):
        dims = tuple(range(2, x.dim()))
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        return (x - mean) / torch.sqrt(var + EPS)

    def _res_block(self, prefix, x):
        out = self._conv(prefix + '.conv1.conv', x, padding=1)
        out = F.leaky_relu(self._instance_norm(out), 0.01)
        out = self._instance_norm(self._conv(prefix + '.conv2.conv', out,
                                             padding=1))
        if prefix + '.conv3.conv.weight' in self.w:
            x = self._instance_norm(self._conv(prefix + '.conv3.conv', x))
        return F.leaky_relu(out + x, 0.01)

    def _up_block(self, prefix, x, skip):
        up = self._transposed(prefix + '.transp_conv.conv', x)
        return self._res_block(prefix + '.conv_block',
                               torch.cat([up, skip], 1))

    # -- the Swin encoder ----------------------------------------------------
    def _attention(self, prefix, x, mask, heads):
        bw, n, c = x.shape
        if self.on_attention is not None:
            self.on_attention(bw, n, c)
        hd = c // heads
        qkv = self._linear(prefix + '.qkv', x).reshape(
            bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        index = self.w[prefix + '.relative_position_index'][:n, :n]
        bias = self.w[prefix + '.relative_position_bias_table'][
            index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(bw // nw, nw, heads, n, n)
                    + mask.unsqueeze(1).unsqueeze(0)).view(-1, heads, n, n)
        attn = torch.softmax(attn, -1)
        out = (attn @ v).transpose(1, 2).reshape(bw, n, c)
        return self._linear(prefix + '.proj', out)

    def _swin_block(self, prefix, x, heads, shift):
        b, d, h, w, c = x.shape
        win, sh = window_and_shift((d, h, w), shift)
        y = self._layer_norm(prefix + '.norm1', x)
        pad = [(win[i] - s % win[i]) % win[i] for i, s in enumerate((d, h, w))]
        y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        dims = (b,) + tuple(y.shape[1:4])
        mask = None
        if any(sh):
            y = torch.roll(y, shifts=tuple(-s for s in sh), dims=(1, 2, 3))
            mask = compute_mask(dims[1:], win, sh, x.device)
        out = self._attention(prefix + '.attn', _partition(y, win), mask,
                              heads)
        y = _reverse(out, win, dims)
        if any(sh):
            y = torch.roll(y, shifts=sh, dims=(1, 2, 3))
        x = x + y[:, :d, :h, :w, :]
        z = self._layer_norm(prefix + '.norm2', x)
        z = F.gelu(self._linear(prefix + '.mlp.linear1', z))
        return x + self._linear(prefix + '.mlp.linear2', z)

    def _merge(self, prefix, x):
        d, h, w = x.shape[1:4]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in MERGE_VIEWS],
                      -1)
        return self._linear(prefix + '.reduction',
                            self._layer_norm(prefix + '.norm', x))

    @staticmethod
    def _proj_out(x):
        y = x.permute(0, 2, 3, 4, 1)
        return F.layer_norm(y, y.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3)

    def swin_vit(self, x) -> List[torch.Tensor]:
        x = self._conv('swinViT.patch_embed.proj', x, stride=PATCH)
        hidden = [self._proj_out(x)]
        shift = tuple(w // 2 for w in WINDOW)
        for i, (depth, heads) in enumerate(zip(self.depths, self.heads)):
            stage = 'swinViT.layers{0}.0.'.format(i + 1)
            y = x.permute(0, 2, 3, 4, 1)
            for b in range(depth):
                y = self._swin_block(stage + 'blocks.{0}'.format(b), y,
                                     heads, shift if b % 2 else (0, 0, 0))
            x = self._merge(stage + 'downsample', y).permute(0, 4, 1, 2, 3)
            hidden.append(self._proj_out(x))
        return hidden

    def __call__(self, x, domain: int = 0, train: bool = False,
                 generators=None):
        dims = x.shape[2:]
        x = F.pad(x, (0, -dims[2] % 32, 0, -dims[1] % 32, 0, -dims[0] % 32))
        hidden = self.swin_vit(x)
        enc0 = self._res_block('encoder1.layer', x)
        enc1 = self._res_block('encoder2.layer', hidden[0])
        enc2 = self._res_block('encoder3.layer', hidden[1])
        enc3 = self._res_block('encoder4.layer', hidden[2])
        dec4 = self._res_block('encoder10.layer', hidden[4])
        dec3 = self._up_block('decoder5', dec4, hidden[3])
        dec2 = self._up_block('decoder4', dec3, enc3)
        dec1 = self._up_block('decoder3', dec2, enc2)
        dec0 = self._up_block('decoder2', dec1, enc1)
        out = self._up_block('decoder1', dec0, enc0)
        out = self._conv('out.conv.conv', out)
        return out[:, :, :dims[0], :dims[1], :dims[2]]


# -- the work of one window, from the layer shapes ---------------------------

def _blocks(net: dict, window: Sequence[int]):
    """Per Swin block of one window's forward: ``(padded tokens, window
    tokens, tokens, channels, heads)``."""
    fs, depths, heads = _widths(net)
    grid = [s // PATCH for s in window]
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = fs * 2 ** i
        win = window_and_shift(grid, (0, 0, 0))[0]
        padded = _numel([math.ceil(g / w) * w for g, w in zip(grid, win)])
        for _ in range(depth):
            yield padded, _numel(win), _numel(grid), c, h
        grid = [math.ceil(g / 2) for g in grid]


def window_attention_flops(net: dict, window: Sequence[int]) -> float:
    """The window-attention kernel's operations in one window's forward:
    QK^T and PV, ``4 x padded tokens x C x window tokens`` a block."""
    return float(sum(4 * t * c * n for t, n, _, c, _ in _blocks(net, window)))


def work_per_window(net: dict, window: Sequence[int],
                    itemsize: int = 4) -> dict:
    """One window's eval forward: ``conv`` MACs (output elements x input
    channels x taps; a k=2/s=2 transposed convolution's input elements x
    output channels x taps), ``matmul`` MACs (the linears over the tokens
    they see, the padded ones included in the attention's; QK^T and PV), and
    the window-attention kernel's bytes (q, k, v and its output once, and
    the bias table, at ``itemsize``) and launches (one a Swin block)."""
    fs, depths, heads = _widths(net)
    cin, k = net['in_chns'], net['class_num']
    vol = [_numel(window) // 8 ** j for j in range(6)]

    def res(a, b, v):
        return v * b * a * 27 + v * b * b * 27 + (v * b * a if a != b else 0)

    conv = vol[1] * fs * cin * PATCH ** 3
    conv += res(cin, fs, vol[0]) + res(fs, fs, vol[1])
    conv += res(2 * fs, 2 * fs, vol[2]) + res(4 * fs, 4 * fs, vol[3])
    conv += res(16 * fs, 16 * fs, vol[5])
    for j, (a, b) in enumerate(((16 * fs, 8 * fs), (8 * fs, 4 * fs),
                                (4 * fs, 2 * fs), (2 * fs, fs), (fs, fs))):
        v_in = vol[5 - j]
        conv += v_in * a * b * 8 + res(2 * b, b, vol[4 - j])
    conv += vol[0] * k * fs
    rows = _numel([2 * w - 1 for w in WINDOW])
    matmul = nbytes = launches = 0
    for padded, n, tokens, c, h in _blocks(net, window):
        matmul += padded * c * 4 * c + 2 * padded * n * c
        matmul += tokens * c * MLP_RATIO * c * 2
        nbytes += (4 * padded * c + rows * h) * itemsize
        launches += 1
    grid = [s // PATCH for s in window]
    for i in range(len(depths)):
        c = fs * 2 ** i
        grid = [math.ceil(g / 2) for g in grid]
        matmul += _numel(grid) * 8 * c * 2 * c
    return {'macs_by_class': {'conv': conv, 'matmul': matmul},
            'kernels': {'window_attention': {'bytes': nbytes,
                                             'launches': launches}}}
