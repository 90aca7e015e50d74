"""Network registry (parity with reference SegNetDict, net_dict_seg.py:33-47,
and the JAX package's ``models/registry.py``, same names and defaults).

``create_network(net_cfg)`` builds an ``nn.Module`` from the ``[network]``
config section. Every segmentation net takes ``forward(x, domain_label=0,
dropout_generators=None)`` on channels-first input; nets with one
normalisation bank ignore the domain. ``Dis`` (the discriminator on
``class_num``-channel softmax maps) takes ``forward(x)``. Defaults:
``bilinear`` False for the UNet2D5 nets and True for the 2D nets,
``trilinear`` True, ``deep_supervise`` False (the ScSE UNet2D takes none, as
in JAX). The ``pallas_fused`` and ``flat25d`` keys are accepted and have no
effect: the eval DSBN+PReLU on the card always runs the fused kernel, and
the folded 2.5D layout is the only one. ``SwinUNETR`` is the port's own
(the JAX package has none): MONAI's network, built from ``feature_size``
(48), ``depths`` ([2,2,2,2]) and ``num_heads`` ([3,6,12,24]).
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from fpl_plus_torch.models.unet2d import (COPLENet, AttentionUNet2D,
                                          NestedUNet2D, UNet2D, UNet2DCCT,
                                          UNet2DDualBranch, UNet2DScSE,
                                          UNet2DURPC)
from fpl_plus_torch.models.swin_unetr import SwinUNETR
from fpl_plus_torch.models.unet2d5_dsbn import AEs, Dis, UNet2D5, UNet2D5DSBN
from fpl_plus_torch.models.unet3d import UNet3D, UNet3DScSE


def _common(cfg):
    return dict(in_chns=cfg['in_chns'],
                feature_chns=list(cfg['feature_chns']),
                dropout=list(cfg['dropout']),
                class_num=cfg['class_num'])


def _unet2d5(cfg):
    return dict(conv_dims=list(cfg['conv_dims']),
                bilinear=cfg.get('bilinear', False), **_common(cfg))


def _simple2d(cls):
    def build(cfg):
        return cls(bilinear=cfg.get('bilinear', True), **_common(cfg))
    return build


def _unet3d(cls):
    def build(cfg):
        return cls(trilinear=cfg.get('trilinear', True),
                   deep_supervise=cfg.get('deep_supervise', False),
                   **_common(cfg))
    return build


SegNetDict = {
    'UNet2D': lambda cfg: UNet2D(
        bilinear=cfg.get('bilinear', True),
        deep_supervise=cfg.get('deep_supervise', False), **_common(cfg)),
    'UNet2D_DualBranch': _simple2d(UNet2DDualBranch),
    'Dis': lambda cfg: Dis(cfg['class_num']),
    'AEs': lambda cfg: AEs(cfg.get('in_chns', 1)),
    'UNet2D_URPC': _simple2d(UNet2DURPC),
    'UNet2D_CCT': _simple2d(UNet2DCCT),
    'COPLENet': _simple2d(COPLENet),
    'AttentionUNet2D': _simple2d(AttentionUNet2D),
    'NestedUNet2D': _simple2d(NestedUNet2D),
    'UNet2D_ScSE': _simple2d(UNet2DScSE),
    'UNet2D5': lambda cfg: UNet2D5(**_unet2d5(cfg)),
    'UNet2D5_dsbn': lambda cfg: UNet2D5DSBN(
        num_domains=cfg.get('num_domains', 2), **_unet2d5(cfg)),
    'UNet3D': _unet3d(UNet3D),
    'UNet3D_ScSE': _unet3d(UNet3DScSE),
    'SwinUNETR': lambda cfg: SwinUNETR(
        cfg['in_chns'], cfg['class_num'], cfg.get('feature_size', 48),
        list(cfg.get('depths', (2, 2, 2, 2))),
        list(cfg.get('num_heads', (3, 6, 12, 24)))),
}

# nets that are intrinsically 3D (the others fold a depth axis slice-wise)
NETS_3D = {'UNet2D5', 'UNet2D5_dsbn', 'UNet3D', 'UNet3D_ScSE', 'Dis', 'AEs',
           'SwinUNETR'}


def create_network(net_cfg: Dict[str, Any]) -> nn.Module:
    name = net_cfg['net_type']
    if name not in SegNetDict:
        raise ValueError('Undefined network {0}'.format(name))
    return SegNetDict[name](net_cfg)


def param_count(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))
