"""Checkpoint resolution and loading in the reference ``.pt`` layout.

Parity with the reference (PyMIC/pymic/net_run_dsbn/agent_abstract.py:136-153
and agent_seg.py:767-828): a checkpoint is ``{ckpt_dir}/{prefix}_{it}.pt``,
a ``torch.save`` of ``{'iteration', 'valid_pred', 'model_state_dict'}``
(training adds ``optimizer_state_dict``); the sidecar text files
``{prefix}_latest.txt`` / ``{prefix}_best.txt`` hold the iteration number.
``ckpt_mode`` 0 = latest, 1 = best, 2 = the explicit ``ckpt_name``; mode 3
(an ensemble list) and checkpoint writing belong to later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def ckpt_prefix_of(config: dict) -> str:
    ckpt_dir = config['training']['ckpt_save_dir']
    prefix = config['training'].get('ckpt_prefix', None)
    if prefix is None:
        prefix = ckpt_dir.split('/')[-1]
    return prefix


def get_checkpoint_name(config: dict) -> str:
    """Resolve the inference checkpoint exactly like the reference."""
    ckpt_mode = config['testing']['ckpt_mode']
    if ckpt_mode in (0, 1):
        ckpt_dir = config['training']['ckpt_save_dir']
        prefix = ckpt_prefix_of(config)
        txt = '{0}/{1}_{2}.txt'.format(
            ckpt_dir, prefix, 'latest' if ckpt_mode == 0 else 'best')
        with open(txt) as f:
            it_num = f.read().replace('\n', '')
        return '{0}/{1}_{2}.pt'.format(ckpt_dir, prefix, it_num)
    if ckpt_mode == 2:
        return config['testing']['ckpt_name']
    if ckpt_mode == 3:
        raise NotImplementedError(
            'ckpt_mode 3 (checkpoint ensembles) is not yet ported')
    raise ValueError('Undefined ckpt_mode {0}'.format(ckpt_mode))


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference-layout ``.pt`` checkpoint onto the CPU. Reference
    checkpoints carry numpy scalars (``valid_pred``), which torch's
    ``weights_only`` loader rejects, so the full unpickler runs: load only
    checkpoints this framework or the reference wrote."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    for key in ('iteration', 'model_state_dict'):
        if key not in ckpt:
            raise KeyError('{0} is not a reference-layout checkpoint (no '
                           '{1!r})'.format(path, key))
    return ckpt
