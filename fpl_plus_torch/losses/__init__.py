"""Loss registry and factory (reference loss_dict_seg.py:31-41 and the
agent loss factory net_run_dsbn/agent_seg.py:111-131; the JAX package's
``losses/__init__.py``, same names)."""
from __future__ import annotations

from fpl_plus_torch.losses.seg import (CombinedLoss, CrossEntropyLoss,
                                       DeepSuperviseLoss, DiceLoss,
                                       DiceLossWeight, EntropyLoss,
                                       ExpLogLoss, FocalDiceLoss,
                                       GeneralizedCELoss, MAELoss, MSELoss,
                                       MumfordShahLoss, NoiseRobustDiceLoss,
                                       SLSRLoss, TotalVariationLoss)

SegLossDict = {
    'CrossEntropyLoss': CrossEntropyLoss,
    'GeneralizedCELoss': GeneralizedCELoss,
    'DiceLoss': DiceLoss,
    'DiceLoss_weight': DiceLossWeight,
    'FocalDiceLoss': FocalDiceLoss,
    'NoiseRobustDiceLoss': NoiseRobustDiceLoss,
    'ExpLogLoss': ExpLogLoss,
    'MAELoss': MAELoss,
    'MSELoss': MSELoss,
    'SLSRLoss': SLSRLoss,
    'EntropyLoss': EntropyLoss,
    'TotalVariationLoss': TotalVariationLoss,
    'MumfordShahLoss': MumfordShahLoss,
}


def create_loss_calculator(config, loss_dict=None):
    """Build the training loss from the [training] section through
    ``loss_dict`` (default ``SegLossDict``; an agent passes its own,
    ``set_loss_dict``): a list-valued ``loss_type`` becomes a CombinedLoss
    with ``loss_weight``; ``[network] deep_supervise`` wraps it in a
    DeepSuperviseLoss with ``[network] deep_supervise_weight``."""
    loss_dict = SegLossDict if loss_dict is None else loss_dict
    train_cfg = config['training']
    loss_name = train_cfg['loss_type']
    if isinstance(loss_name, (list, tuple)):
        base_loss = CombinedLoss(train_cfg, loss_dict)
    elif loss_name not in loss_dict:
        raise ValueError('Undefined loss function {0}'.format(loss_name))
    else:
        base_loss = loss_dict[loss_name](train_cfg)
    net_cfg = config.get('network', {})
    if net_cfg.get('deep_supervise', False):
        return DeepSuperviseLoss({
            'deep_suervise_weight': net_cfg.get('deep_supervise_weight', None),
            'base_loss': base_loss})
    return base_loss


__all__ = ['SegLossDict', 'create_loss_calculator', 'CombinedLoss',
           'DeepSuperviseLoss', 'CrossEntropyLoss', 'DiceLoss',
           'DiceLossWeight']
