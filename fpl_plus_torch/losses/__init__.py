"""Loss registry and factory (reference loss_dict_seg.py:31-41 and the
agent loss factory net_run_dsbn/agent_seg.py:111-131), holding the losses
the FPL+ training stages use. The other losses of the JAX package's
registry raise ``NotImplementedError`` and name the ported ones."""
from __future__ import annotations

from fpl_plus_torch.losses.seg import (CombinedLoss, CrossEntropyLoss,
                                       DiceLoss, DiceLossWeight)

SegLossDict = {
    'CrossEntropyLoss': CrossEntropyLoss,
    'DiceLoss': DiceLoss,
    'DiceLoss_weight': DiceLossWeight,
}


def _check_ported(name):
    if name not in SegLossDict:
        raise NotImplementedError(
            'loss {0} is not yet ported (ported: {1})'.format(
                name, sorted(SegLossDict)))


def create_loss_calculator(config):
    """Build the training loss from the [training] section; a list-valued
    ``loss_type`` becomes a CombinedLoss with ``loss_weight``."""
    train_cfg = config['training']
    loss_name = train_cfg['loss_type']
    if config.get('network', {}).get('deep_supervise', False):
        raise NotImplementedError('deep supervision is not yet ported')
    if isinstance(loss_name, (list, tuple)):
        for name in loss_name:
            _check_ported(name)
        return CombinedLoss(train_cfg, SegLossDict)
    _check_ported(loss_name)
    return SegLossDict[loss_name](train_cfg)


__all__ = ['SegLossDict', 'create_loss_calculator', 'CombinedLoss',
           'CrossEntropyLoss', 'DiceLoss', 'DiceLossWeight']
