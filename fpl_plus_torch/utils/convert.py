"""Weight bridge: JAX-package variables -> this package's state dicts (the
reference PyTorch key layout for UNet2D5_dsbn and ``Dis``, the flax scopes
for the other networks).

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

``state_dict_from_flax`` serves every other network (the UNet2D and UNet3D
families, ``AEs``), whose submodules the port names after the flax scopes:
an explicit scope name is kept, an automatic one shortened (``_SCOPES``,
``_AUTO``). A scope with ``scale`` is a one-bank BatchNorm (``[1, C]`` rows
-> ``weight``, ``bias``, ``running_mean``, ``running_var``); a ``kernel``
is a transposed convolution under ``ConvTranspose_{k}`` or ``upconv{..}``,
a dense layer when it has two axes (``[in, out]`` -> ``[out, in]``), else a
convolution.
"""
from __future__ import annotations

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
