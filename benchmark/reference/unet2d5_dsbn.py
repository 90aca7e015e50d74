"""Plain PyTorch reference of UNet2D5 with domain-specific batch norm, the
FPL+ network (HiLab-git/FPL-plus, PyMIC/pymic/net/net3d/unet2d5_dsbn.py),
as a function of a dict of weights.

It imports nothing of the program. The benchmark makes the weights from
the seed (``make_weights``), hands the same dict to the program (as its
checkpoint, loaded with ``strict=True``, which also checks every name and
shape here against the program's) and to ``forward`` here.

The network: five levels, ``conv_dims[i]`` 2 or 3; a 2D level runs its
convolutions slice by slice (depth folded into the batch, rows ``n*D +
d``) and pools H and W, a 3D level pools D, H and W. Each level is two
(conv 3 -> DSBN -> PReLU) stages with dropout between them; the decoder
upsamples with a k=2/s=2 transposed convolution and concatenates the
skip before the upsampled map; the head is a (1, 3, 3) convolution.

Departures from the published code, which the program shares: dropout
draws its keep masks from explicit ``torch.Generator`` s (one per
contiguous group of rows, uniform draws below ``1 - p`` are kept and
scaled by ``1 / (1 - p)``), so the reference can draw the program's masks
again from their seeds; a block allocates only the convolutions of its
own dimension (the published block holds unused 2D and 3D copies).

A configuration names this file under ``reference``; the harness loads
it by that path and uses it only through this interface, which every
network's reference file provides:

* ``Net(net_cfg, weights)``, called as ``(x, domain, train=False,
  generators=None)``: logits ``[N, class_num, D, H, W]``;
* ``make_weights(net_cfg, seed, device)``: the seeded weights under the
  program's state-dict names;
* ``calibrate_foreground(net_cfg, weights, window, domain, share)``;
* ``work_per_window(net_cfg, window, itemsize=4)``: one window's forward
  as ``{'macs_by_class': {'conv': ...}, 'kernels': {'dsbn': {'bytes':
  ..., 'launches': ...}}}``, the bytes at ``itemsize`` bytes an
  activation element; a kernel's key is the prefix of the work keys its
  roofline reads (``dsbn_bytes_per_item``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5


def _levels(net: dict):
    ft, dims, dp = net['feature_chns'], net['conv_dims'], net['dropout']
    if net.get('bilinear', False):
        raise ValueError('the reference covers the transposed-conv decoder')
    enc = [('block{0}'.format(i), net['in_chns'] if i == 0 else ft[i - 1],
            ft[i], dims[i], dp[i]) for i in range(5)]
    dec = [('up{0}'.format(j), ft[5 - j], ft[4 - j], dims[4 - j], dp[4 - j])
           for j in range(1, 5)]
    return enc, dec


def param_spec(net: dict) -> List[Tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every weight and buffer, in a fixed
    order. Kinds: ``he`` (convolution weights), ``bias``, ``bn_weight``,
    ``bn_bias``, ``rmean``, ``rvar``, ``prelu``, ``count``."""
    spec = []
    nd = net['num_domains']

    def block(prefix, cin, cout, dim):
        t = '{0}d'.format(dim)
        for j, c_in in ((1, cin), (2, cout)):
            conv = '{0}.conv{1}_{2}'.format(prefix, t, j)
            spec.append((conv + '.weight', (cout, c_in) + (3,) * dim, 'he'))
            spec.append((conv + '.bias', (cout,), 'bias'))
            for d in range(nd):
                bank = '{0}.bn{1}{2}.bns.{3}.'.format(prefix, t, j, d)
                spec.extend([(bank + 'weight', (cout,), 'bn_weight'),
                             (bank + 'bias', (cout,), 'bn_bias'),
                             (bank + 'running_mean', (cout,), 'rmean'),
                             (bank + 'running_var', (cout,), 'rvar'),
                             (bank + 'num_batches_tracked', (), 'count')])
            spec.append(('{0}.relu_{1}.weight'.format(prefix, j), (1,),
                         'prelu'))

    enc, dec = _levels(net)
    for name, cin, cout, dim, _ in enc:
        block(name + '.conv', cin, cout, dim)
    for name, cin, skip, dim, _ in dec:
        t = '{0}d'.format(dim)
        spec.append(('{0}.trans{1}.weight'.format(name, t),
                     (cin, skip) + (2,) * dim, 'he_transposed'))
        spec.append(('{0}.trans{1}.bias'.format(name, t), (skip,), 'bias'))
        block(name + '.conv', 2 * skip, skip, dim)
    spec.append(('out_conv.weight', (net['class_num'], net['feature_chns'][0],
                                     1, 3, 3), 'he'))
    spec.append(('out_conv.bias', (net['class_num'],), 'bias'))
    return spec


def make_weights(net: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights at a trained net's scales, made on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` in two draws (one normal, one
    uniform) that the tensors slice: He-normal convolution weights
    (fan-in: input channels x taps; a transposed convolution's input
    channels), biases N(0, 0.05), DSBN scale U(0.8, 1.2), shift N(0, 0.05),
    running mean N(0, 0.1), running variance U(0.5, 1.5), PReLU slopes
    0.25 (torch's default)."""
    spec = param_spec(net)
    normal_kinds = ('he', 'he_transposed', 'bias', 'bn_bias', 'rmean')
    n_normal = sum(_numel(s) for _, s, k in spec if k in normal_kinds)
    n_unif = sum(_numel(s) for _, s, k in spec if k in ('bn_weight', 'rvar'))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device)
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
            elif kind == 'rmean':
                v = v * 0.1
            else:
                v = v * 0.05
        elif kind in ('bn_weight', 'rvar'):
            v = unif[i_u:i_u + n].view(shape)
            i_u += n
            v = v * 0.4 + 0.8 if kind == 'bn_weight' else v + 0.5
        elif kind == 'prelu':
            v = torch.full(shape, 0.25, device=device)
        else:
            v = torch.zeros(shape, dtype=torch.long, device=device)
        weights[name] = v.contiguous()
    return weights


def calibrate_foreground(net: dict, weights: Dict[str, torch.Tensor],
                         window: torch.Tensor, domain: int,
                         share: float) -> None:
    """Shift the head's class-1 bias so that ``share`` of the voxels of
    ``window [1, C, D, H, W]`` come out as foreground, as a trained
    generator labels a small tumour in a large volume (random weights
    label about half the voxels). In place; two classes."""
    if net['class_num'] != 2:
        raise ValueError('the foreground calibration takes two classes')
    with torch.no_grad():
        logits = Net(net, weights)(window, domain)[0]
        margin = (logits[1] - logits[0]).flatten().float()
        k = max(1, int(round((1.0 - share) * margin.numel())))
        weights['out_conv.bias'][1] -= margin.kthvalue(k).values


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _fold(x):
    n, c, d = x.shape[:3]
    return x.permute(0, 2, 1, 3, 4).reshape((n * d, c) + x.shape[3:]), (n, d)


def _unfold(x, nd):
    n, d = nd
    return x.reshape((n, d) + x.shape[1:]).permute(0, 2, 1, 3, 4)


def dropout(x, p: float, generators):
    """Keep a value where a uniform draw is below ``1 - p``, scaled by
    ``1 / (1 - p)``: the rows split into ``len(generators)`` contiguous
    groups, group m drawn from generator m."""
    if p == 0 or generators is None:
        return x
    m = len(generators)
    shape = (x.shape[0] // m,) + tuple(x.shape[1:])
    u = torch.cat([torch.rand(shape, generator=g, device=x.device)
                   for g in generators])
    keep = 1.0 - p
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class Net:
    """``Net(net_cfg, weights)(x, domain, train=False, generators=None)``
    -> logits ``[N, class_num, D, H, W]`` of ``x [N, in_chns, D, H, W]``.

    ``train``: batch statistics (biased variance over every axis but the
    channels) instead of the running ones. ``on_conv(kind, x, w, out)``
    and ``on_norm(x)``: observers for the counts of work."""

    def __init__(self, net: dict, weights: Dict[str, torch.Tensor],
                 on_conv=None, on_norm=None):
        self.net = net
        self.w = weights
        self.on_conv = on_conv
        self.on_norm = on_norm
        self.enc, self.dec = _levels(net)

    def _conv(self, name, x, dim, padding):
        w, b = self.w[name + '.weight'], self.w[name + '.bias']
        conv = F.conv2d if dim == 2 else F.conv3d
        out = conv(x, w, b, padding=padding)
        if self.on_conv is not None:
            self.on_conv('conv', x, w, out)
        return out

    def _trans(self, name, x, dim):
        w, b = self.w[name + '.weight'], self.w[name + '.bias']
        conv = F.conv_transpose2d if dim == 2 else F.conv_transpose3d
        out = conv(x, w, b, stride=2)
        if self.on_conv is not None:
            self.on_conv('transposed', x, w, out)
        return out

    def _norm_act(self, bank, relu, x, train):
        if self.on_norm is not None:
            self.on_norm(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims, keepdim=True)
            var = ((x - mean) ** 2).mean(dims, keepdim=True)
        else:
            mean = self.w[bank + 'running_mean'].reshape(shape)
            var = self.w[bank + 'running_var'].reshape(shape)
        y = (x - mean) / torch.sqrt(var + EPS)
        y = y * self.w[bank + 'weight'].reshape(shape) \
            + self.w[bank + 'bias'].reshape(shape)
        a = self.w[relu + '.weight'].reshape(())
        return torch.where(y >= 0, y, a * y)

    def _block(self, prefix, x, dim, p, domain, train, generators):
        t = '{0}d'.format(dim)
        for j in (1, 2):
            if j == 2:
                x = dropout(x, p, generators)
            x = self._conv('{0}.conv{1}_{2}'.format(prefix, t, j), x, dim, 1)
            x = self._norm_act('{0}.bn{1}{2}.bns.{3}.'.format(prefix, t, j,
                                                             domain),
                               '{0}.relu_{1}'.format(prefix, j), x, train)
        return x

    def __call__(self, x, domain: int, train: bool = False,
                 generators=None):
        skips = []
        h = x
        for i, (name, _, _, dim, p) in enumerate(self.enc):
            fold = dim == 2
            if fold:
                h, nd = _fold(h)
            out = self._block(name + '.conv', h, dim, p, domain, train,
                              generators)
            down = None
            if i < 4:
                down = (F.max_pool2d if dim == 2 else F.max_pool3d)(out, 2)
            if fold:
                out = _unfold(out, nd)
                down = _unfold(down, nd) if down is not None else None
            skips.append(out)
            h = down
        y = skips[4]
        for j, (name, _, _, dim, p) in enumerate(self.dec):
            skip = skips[3 - j]
            fold = dim == 2
            if fold:
                y, nd = _fold(y)
                skip, _ = _fold(skip)
            up = self._trans('{0}.trans{1}d'.format(name, dim), y, dim)
            y = self._block(name + '.conv', torch.cat([skip, up], 1), dim, p,
                            domain, train, generators)
            if fold:
                y = _unfold(y, nd)
        return self._conv('out_conv', y, 3, (0, 1, 1))


def count_per_window(net: dict, window) -> Tuple[int, int, int]:
    """``(MACs, DSBN elements, DSBN stages)`` of one window's forward,
    counted from the shapes on the ``meta`` device: a convolution's output
    element costs input channels x taps MACs, a k=2/s=2 transposed
    convolution spreads each input element over output channels x taps
    outputs once; the DSBN elements are the inputs of the DSBN+PReLU
    stages (18 a forward)."""
    macs, elems, stages = [0], [0], [0]

    def on_conv(kind, x, w, out):
        n = x.numel() if kind == 'transposed' else out.numel()
        macs[0] += n * w[0].numel()

    def on_norm(x):
        elems[0] += x.numel()
        stages[0] += 1

    weights = {name: torch.empty(shape, device='meta',
                                 dtype=torch.long if kind == 'count'
                                 else torch.float32)
               for name, shape, kind in param_spec(net)}
    x = torch.empty((1, net['in_chns']) + tuple(window), device='meta')
    Net(net, weights, on_conv=on_conv, on_norm=on_norm)(x, 0)
    return macs[0], elems[0], stages[0]


def work_per_window(net: dict, window, itemsize: int = 4) -> dict:
    """One window's eval forward: its convolutions' MACs, and the eval
    DSBN+PReLU kernel's bytes (each input element read once and each
    output written once, at ``itemsize`` bytes) and launches (one a DSBN
    stage, whatever the batch)."""
    macs, elems, stages = count_per_window(net, window)
    return {'macs_by_class': {'conv': macs},
            'kernels': {'dsbn': {'bytes': 2 * elems * itemsize,
                                 'launches': stages}}}
