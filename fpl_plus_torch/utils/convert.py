"""Weight bridge: JAX-package variables -> this package's state dicts (the
reference PyTorch key layout for UNet2D5_dsbn and ``Dis``, the flax scopes
for the other networks), and the converter of JAX checkpoints.

The JAX variables arrive as nested dicts of numpy arrays (``params`` and
``batch_stats``), so no JAX is needed here. The mapping is the reference
layout of ``utils/torch_convert.py`` in the JAX package:

* flax ``block{i}/conv/conv{j}`` / ``bn{j}`` / ``act{j}`` ->
  ``block{i}.conv.conv{D}d_{j}`` / ``bn{D}d{j}.bns.{d}`` / ``relu_{j}``, D the
  block's conv dimension from ``conv_dims`` (only that dimension is emitted:
  this package allocates no unused copies);
* ``up{j}/proj`` -> ``up{j}.conv{D}d`` (bilinear), ``up{j}/up`` ->
  ``up{j}.trans{D}d`` (transposed conv);
* conv kernels ``[*k, in, out]`` -> ``[out, in, *k]``; transposed-conv
  kernels ``[*k, in, out]`` -> ``[in, out, *k]`` with the taps spatially
  flipped (flax's ConvTranspose without ``transpose_kernel`` is a
  fractionally strided conv, which for k=2/s=2 equals torch's
  gradient-style transpose after the flip);
* DSBN rows ``[n_domains, C]`` split into per-domain banks; the scalar PReLU
  ``alpha`` becomes ``weight`` of shape [1].

``dis_state_dict_from_jax`` does the same for the discriminator ``Dis``:
flax ``Conv_0`` .. ``Conv_3`` -> ``convs.{i}``, ``Conv_4`` -> ``out_conv``
(its InstanceNorms have no parameters).

``state_dict_from_multinet`` bridges a flax ``MultiNet`` (BiNet, TriNet):
its peers are the scopes ``{Class}_{i}`` (the flax class name of the
registry network and the peer's index), each converted as above and put
under ``nets.{i}``.

``state_dict_from_cls`` bridges the classification nets (ResNet18, VGG16,
MobileNetV2) to their torchvision names, the inverse of the JAX package's
torchvision converter (``utils/torch_convert.py:127-252`` there): kernel
transposes, one-bank BatchNorm rows ``[1, C]`` -> ``[C]``, and VGG16's
first dense layer, whose inputs the JAX net flattens channels-last
(h, w, c), permuted to torchvision's (c, h, w).

``state_dict_from_flax`` serves every other network (the UNet2D and UNet3D
families, ``AEs``), whose submodules the port names after the flax scopes:
an explicit scope name is kept, an automatic one shortened (``_SCOPES``,
``_AUTO``). A scope with ``scale`` is a one-bank BatchNorm (``[1, C]`` rows
-> ``weight``, ``bias``, ``running_mean``, ``running_var``); a ``kernel``
is a transposed convolution under ``ConvTranspose_{k}`` or ``upconv{..}``,
a dense layer when it has two axes (``[in, out]`` -> ``[out, in]``), else a
convolution.

``convert_jax_checkpoint`` (``python -m fpl_plus_torch.cli convert
in/prefix_IT.ckpt cfg out/prefix_IT.pt``) turns a JAX checkpoint (flax
msgpack of ``{'iteration', 'valid_pred', 'state': {params, batch_stats,
opt_state[, extra]}}``, read by ``utils/flax_msgpack.py``) into a
reference-layout ``.pt`` with its latest pointer (``engine/ckpt.py``). The
``[network]`` section picks the bridge: the classification nets, a
``MultiNet`` (its top-level scopes are ``{Class}_0`` .. ``{Class}_{n-1}``),
UNet2D5_dsbn / UNet2D5, else ``state_dict_from_flax``. A JAX discriminator
(``extra['dis_params']``) becomes ``dis_state_dict``, an EMA teacher
(``extra`` a params tree) ``ema_state_dict``. No optimizer state is
written, as the JAX package's own converter writes ``opt_state = ()``: a
resume from a converted checkpoint starts a fresh optimizer (and a fresh
discriminator optimizer) whose schedule is offset by the iteration.
"""
from __future__ import annotations

import os
import re
from typing import Dict

import numpy as np
import torch


def _conv_kernel(w) -> np.ndarray:
    """flax conv kernel [*k, in, out] -> torch [out, in, *k]."""
    w = np.asarray(w)
    k = w.ndim - 2
    return np.transpose(w, (k + 1, k) + tuple(range(k)))


def _conv_transpose_kernel(w) -> np.ndarray:
    """flax ConvTranspose kernel [*k, in, out] -> torch [in, out, *k],
    taps spatially flipped."""
    w = np.asarray(w)
    k = w.ndim - 2
    w = np.transpose(w, (k, k + 1) + tuple(range(k)))
    return np.flip(w, axis=tuple(range(2, w.ndim)))


_SCOPES = {'ConvBlock2D_0': 'block', 'ConvBlock3D_0': 'block',
           'ChannelSpatialSELayer_0': 'scse', 'ChannelSELayer_0': 'cse',
           'SpatialSELayer_0': 'sse'}
_AUTO = (('ConvTranspose_', 'convt'), ('Conv_', 'conv'), ('BatchNorm_', 'bn'),
         ('Dense_', 'fc'))


def _port_scope(scope: str) -> str:
    if scope in _SCOPES:
        return _SCOPES[scope]
    for prefix, short in _AUTO:
        if scope.startswith(prefix):
            return short + scope[len(prefix):]
    return scope


def state_dict_from_flax(params: Dict, batch_stats: Dict = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` of a network named after its flax
    scopes -> a state dict that its ``load_state_dict(..., strict=True)``
    accepts. Nested dicts of numpy arrays in, CPU tensors out."""
    sd: Dict[str, np.ndarray] = {}

    def walk(p, s, scopes):
        name = '.'.join(_port_scope(x) for x in scopes)
        if 'scale' in p:
            sd[name + '.weight'] = np.reshape(p['scale'], -1)
            sd[name + '.bias'] = np.reshape(p['bias'], -1)
            sd[name + '.running_mean'] = np.reshape(s['mean'], -1)
            sd[name + '.running_var'] = np.reshape(s['var'], -1)
            sd[name + '.num_batches_tracked'] = np.asarray(0, np.int64)
            return
        for key, value in p.items():
            if isinstance(value, dict):
                walk(value, (s or {}).get(key, {}), scopes + (key,))
            elif key == 'kernel':
                w = np.asarray(value)
                if scopes[-1].startswith(('ConvTranspose_', 'upconv')):
                    w = _conv_transpose_kernel(w)
                elif w.ndim == 2:
                    w = w.T
                else:
                    w = _conv_kernel(w)
                sd[name + '.weight'] = w
            else:
                sd[name + '.' + key] = np.asarray(value)

    walk(params, batch_stats or {}, ())
    return {k: torch.from_numpy(np.array(v, dtype=np.int64
                                         if k.endswith('num_batches_tracked')
                                         else np.float32))
            for k, v in sd.items()}


def state_dict_from_jax(params: Dict, batch_stats: Dict,
                        net_cfg: Dict) -> Dict[str, torch.Tensor]:
    """JAX UNet2D5_dsbn / UNet2D5 ``(params, batch_stats)`` -> a state dict
    that ``UNet2D5DSBN.load_state_dict(..., strict=True)`` accepts."""
    dims = list(net_cfg['conv_dims'])
    bilinear = net_cfg.get('bilinear', False)
    sd: Dict[str, np.ndarray] = {}

    def put_block(prefix, p, s, dim):
        t = '{0}d'.format(dim)
        for j in (1, 2):
            conv = p['conv{0}'.format(j)]
            sd['{0}.conv{1}_{2}.weight'.format(prefix, t, j)] = \
                _conv_kernel(conv['kernel'])
            sd['{0}.conv{1}_{2}.bias'.format(prefix, t, j)] = conv['bias']
            bn_p, bn_s = p['bn{0}'.format(j)], s['bn{0}'.format(j)]
            for dom in range(np.shape(bn_p['scale'])[0]):
                base = '{0}.bn{1}{2}.bns.{3}'.format(prefix, t, j, dom)
                sd[base + '.weight'] = np.asarray(bn_p['scale'])[dom]
                sd[base + '.bias'] = np.asarray(bn_p['bias'])[dom]
                sd[base + '.running_mean'] = np.asarray(bn_s['mean'])[dom]
                sd[base + '.running_var'] = np.asarray(bn_s['var'])[dom]
                sd[base + '.num_batches_tracked'] = np.asarray(0, np.int64)
            sd['{0}.relu_{1}.weight'.format(prefix, j)] = np.reshape(
                p['act{0}'.format(j)]['alpha'], (1,))

    for i in range(5):
        name = 'block{0}'.format(i)
        put_block(name + '.conv', params[name]['conv'],
                  batch_stats[name]['conv'], dims[i])
    for j, lvl in enumerate([3, 2, 1, 0]):
        name = 'up{0}'.format(j + 1)
        t = '{0}d'.format(dims[lvl])
        p_up = params[name]
        if bilinear:
            sd['{0}.conv{1}.weight'.format(name, t)] = \
                _conv_kernel(p_up['proj']['kernel'])
            sd['{0}.conv{1}.bias'.format(name, t)] = p_up['proj']['bias']
        else:
            sd['{0}.trans{1}.weight'.format(name, t)] = \
                _conv_transpose_kernel(p_up['up']['kernel'])
            sd['{0}.trans{1}.bias'.format(name, t)] = p_up['up']['bias']
        put_block(name + '.conv', p_up['conv'], batch_stats[name]['conv'],
                  dims[lvl])
    sd['out_conv.weight'] = _conv_kernel(params['out_conv']['kernel'])
    sd['out_conv.bias'] = params['out_conv']['bias']
    return {k: torch.from_numpy(np.array(v, dtype=np.int64
                                         if k.endswith('num_batches_tracked')
                                         else np.float32))
            for k, v in sd.items()}


def dis_state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``Dis`` params -> a state dict ``Dis.load_state_dict(...,
    strict=True)`` accepts."""
    sd = {}
    for i in range(5):
        conv = params['Conv_{0}'.format(i)]
        name = 'convs.{0}'.format(i) if i < 4 else 'out_conv'
        sd[name + '.weight'] = _conv_kernel(conv['kernel'])
        sd[name + '.bias'] = np.asarray(conv['bias'])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def state_dict_from_multinet(params: Dict, batch_stats: Dict,
                             net_cfg: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``MultiNet`` ``(params, batch_stats)`` of peers of
    ``net_cfg['net_type']`` -> a state dict that the port's ``MultiNet``
    loads with ``strict=True``."""
    unet2d5 = net_cfg['net_type'] in ('UNet2D5', 'UNet2D5_dsbn')
    peers = sorted(params, key=lambda scope: int(scope.rsplit('_', 1)[1]))
    sd = {}
    for i, scope in enumerate(peers):
        stats = (batch_stats or {}).get(scope, {})
        peer = (state_dict_from_jax(params[scope], stats, net_cfg) if unet2d5
                else state_dict_from_flax(params[scope], stats))
        sd.update({'nets.{0}.{1}'.format(i, k): v for k, v in peer.items()})
    return sd


_VGG16_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def state_dict_from_cls(params: Dict, batch_stats: Dict,
                        net_type: str) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` of a ``cls_nets`` network -> the
    torchvision-named state dict of the port's net of ``net_type``."""
    sd: Dict[str, np.ndarray] = {}
    stats = batch_stats or {}

    def conv(name, p, bias=False):
        sd[name + '.weight'] = _conv_kernel(p['kernel'])
        if bias:
            sd[name + '.bias'] = np.asarray(p['bias'])

    def dense(name, p, kernel=None):
        w = np.asarray(p['kernel']) if kernel is None else kernel
        sd[name + '.weight'] = w.T
        sd[name + '.bias'] = np.asarray(p['bias'])

    def bn(name, p, s):
        sd[name + '.weight'] = np.reshape(p['scale'], -1)
        sd[name + '.bias'] = np.reshape(p['bias'], -1)
        sd[name + '.running_mean'] = np.reshape(s['mean'], -1)
        sd[name + '.running_var'] = np.reshape(s['var'], -1)
        sd[name + '.num_batches_tracked'] = np.asarray(0, np.int64)

    if net_type == 'resnet18':
        conv('conv1', params['conv1'])
        bn('bn1', params['bn1'], stats['bn1'])
        for layer in range(1, 5):
            for b in range(2):
                scope = 'layer{0}_{1}'.format(layer, b)
                p, st = params[scope], stats[scope]
                pref = 'layer{0}.{1}'.format(layer, b)
                for j in (1, 2):
                    conv('{0}.conv{1}'.format(pref, j), p['conv{0}'.format(j)])
                    bn('{0}.bn{1}'.format(pref, j), p['bn{0}'.format(j)],
                       st['bn{0}'.format(j)])
                if 'downsample' in p:
                    conv(pref + '.downsample.0', p['downsample'])
                    bn(pref + '.downsample.1', p['bn_down'], st['bn_down'])
        dense('fc', params['fc'])
    elif net_type == 'vgg16':
        for i, idx in enumerate(_VGG16_CONVS):
            conv('features.{0}'.format(idx), params['conv{0}'.format(i)],
                 bias=True)
        k = np.asarray(params['fc1']['kernel'])          # [(h, w, c), out]
        k = np.transpose(k.reshape(7, 7, 512, -1), (2, 0, 1, 3)).reshape(
            k.shape)                                     # [(c, h, w), out]
        dense('classifier.0', params['fc1'], kernel=k)
        dense('classifier.3', params['fc2'])
        dense('classifier.6', params['head'])
    elif net_type == 'mobilenetv2':
        conv('features.0.0', params['stem'])
        bn('features.0.1', params['bn_stem'], stats['bn_stem'])
        for i in range(1, 18):
            scope = 'block{0}'.format(i - 1)
            p, st = params[scope], stats[scope]
            pref = 'features.{0}.conv'.format(i)
            j = 0
            if 'expand' in p:
                conv(pref + '.0.0', p['expand'])
                bn(pref + '.0.1', p['bn0'], st['bn0'])
                j = 1
            conv('{0}.{1}.0'.format(pref, j), p['dw'])
            bn('{0}.{1}.1'.format(pref, j), p['bn1'], st['bn1'])
            conv('{0}.{1}'.format(pref, j + 1), p['project'])
            bn('{0}.{1}'.format(pref, j + 2), p['bn2'], st['bn2'])
        conv('features.18.0', params['head_conv'])
        bn('features.18.1', params['bn_head'], stats['bn_head'])
        dense('classifier.1', params['classifier'])
    else:
        raise ValueError('Undefined network {0}'.format(net_type))
    return {k: torch.from_numpy(np.array(v, dtype=np.int64
                                         if k.endswith('num_batches_tracked')
                                         else np.float32))
            for k, v in sd.items()}


CLS_NETS = ('resnet18', 'vgg16', 'mobilenetv2')


def _host_tree(tree):
    """Nested dicts with numpy leaves (a bf16 tensor of the msgpack reader
    widened to f32)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _multinet_peers(params: Dict) -> bool:
    """Whether ``params`` is a flax MultiNet's: its top-level scopes are
    ``{Class}_0`` .. ``{Class}_{n-1}`` of one class, n >= 2."""
    found = [re.fullmatch(r'(.+)_(\d+)', k) for k in params]
    if len(found) < 2 or not all(found):
        return False
    return (len({m.group(1) for m in found}) == 1
            and sorted(int(m.group(2)) for m in found)
            == list(range(len(found))))


def state_dict_from_variables(params: Dict, batch_stats: Dict,
                              net_cfg: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``(params, batch_stats)`` of the ``[network]`` net -> the port's
    state dict, through the bridge that net needs."""
    net_type = net_cfg['net_type']
    if net_type in CLS_NETS:
        return state_dict_from_cls(params, batch_stats, net_type)
    if _multinet_peers(params):
        return state_dict_from_multinet(params, batch_stats, net_cfg)
    if net_type in ('UNet2D5', 'UNet2D5_dsbn'):
        return state_dict_from_jax(params, batch_stats, net_cfg)
    return state_dict_from_flax(params, batch_stats)


def convert_jax_checkpoint(ckpt_path: str, config: Dict,
                           out_path: str) -> str:
    """Write the JAX checkpoint ``ckpt_path`` of the ``config``'s network as
    the port checkpoint ``out_path`` (``{ckpt_dir}/{prefix}_{it}.pt``) and
    its latest pointer; returns the path written."""
    from fpl_plus_torch.engine import ckpt as ckpt_lib
    from fpl_plus_torch.utils.flax_msgpack import unpackb
    match = re.fullmatch(r'(.+)_(\d+)\.pt', os.path.basename(out_path))
    if match is None:
        raise ValueError('the output must be named <prefix>_<iteration>.pt, '
                         'got {0}'.format(out_path))
    with open(ckpt_path, 'rb') as f:
        payload = _host_tree(unpackb(f.read()))
    if not isinstance(payload, dict) or 'state' not in payload:
        raise ValueError('{0} is not a JAX checkpoint (no state)'.format(
            ckpt_path))
    state = payload['state']
    net_cfg = config['network']
    batch_stats = state.get('batch_stats') or {}
    out = {'model_state_dict': state_dict_from_variables(
        state['params'], batch_stats, net_cfg)}
    extra = state.get('extra') or {}
    if 'dis_params' in extra:
        out['dis_state_dict'] = dis_state_dict_from_jax(extra['dis_params'])
    elif extra:
        teacher = state_dict_from_variables(extra, batch_stats, net_cfg)
        out['ema_state_dict'] = {k: v for k, v in teacher.items()
                                 if not k.endswith(ckpt_lib.STATISTICS)}
    return ckpt_lib.save_checkpoint(
        os.path.dirname(out_path) or '.', match.group(1),
        int(match.group(2)), out, payload.get('valid_pred', 0.0))
