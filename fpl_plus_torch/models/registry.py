"""Network registry (parity with reference SegNetDict, net_dict_seg.py:33-47).

``create_network(net_cfg)`` builds an ``nn.Module`` from the ``[network]``
config section. Ported so far: ``UNet2D5_dsbn``, ``UNet2D5`` and the
discriminator ``Dis`` (on ``class_num``-channel softmax maps). The
``pallas_fused`` and ``flat25d`` keys are accepted and have no effect: the
eval DSBN+PReLU on the card always runs the fused kernel, and the folded
2.5D layout is the only one.
"""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from fpl_plus_torch.models.unet2d5_dsbn import Dis, UNet2D5, UNet2D5DSBN

# names the JAX package's registry knows and this port does not yet build
_NOT_YET_PORTED = ('UNet2D', 'UNet2D_DualBranch', 'AEs', 'UNet2D_URPC',
                   'UNet2D_CCT', 'COPLENet', 'AttentionUNet2D',
                   'NestedUNet2D', 'UNet2D_ScSE', 'UNet3D', 'UNet3D_ScSE')


def _common(cfg):
    return dict(in_chns=cfg['in_chns'],
                feature_chns=list(cfg['feature_chns']),
                conv_dims=list(cfg['conv_dims']),
                dropout=list(cfg['dropout']),
                class_num=cfg['class_num'],
                bilinear=cfg.get('bilinear', False))


SegNetDict = {
    'Dis': lambda cfg: Dis(cfg['class_num']),
    'UNet2D5': lambda cfg: UNet2D5(**_common(cfg)),
    'UNet2D5_dsbn': lambda cfg: UNet2D5DSBN(
        num_domains=cfg.get('num_domains', 2), **_common(cfg)),
}


def create_network(net_cfg: Dict[str, Any]) -> nn.Module:
    name = net_cfg['net_type']
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(
            'network {0} is not yet ported to the PyTorch package (see '
            'ROADMAP.md)'.format(name))
    if name not in SegNetDict:
        raise ValueError('Undefined network {0}'.format(name))
    return SegNetDict[name](net_cfg)


def param_count(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))
