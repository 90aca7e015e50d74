"""PyTorch port, gradient accumulation in the joint step
(``grad_accum_steps = 2``) against the JAX package's ``step_joint_accum``,
and the accumulated train stage through the CLI.

One JAX program is compiled: the accumulating joint step of the tiny
UNet2D5_dsbn (feature_chns [4,8,8,8,8], dropout 0), 2 microbatches of 2+2
crops of [8,16,16], DiceLoss with ``train_fpl_uda``, Adam at 1e-3.
Tolerances are ``test_torch_port_train_step.py``'s: loss and dice (means
over the microbatches) rtol 1e-4; the mean gradient (Adam's first moment
after the one update / 0.1) by the per-tensor rule; the parameters by the
Adam rule and the DSBN statistics, threaded through both microbatches, by
the statistics rule.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import JointTrainStep
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.registry import create_network
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (CLI_CFG, TINY, TRAIN_CFG, _cl,
                                              _port_names, adam_mu,
                                              check_grads, check_params,
                                              make_batches, tiny_variables,
                                              torch_batches)
from tests.test_torch_port_train_units import write_train_domain

ACCUM = 2


def test_accumulated_joint_step_matches_jax():
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state, make_train_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    module = jax_network(TINY)
    params, stats = tiny_variables(9)
    micro = make_batches(seed=13, steps=ACCUM)      # [microbatch][domain]

    optimizer = jax_optimizer(TRAIN_CFG, dict(TRAIN_CFG, last_iter=-1))
    jstep = make_train_step(module.apply, jax_loss({'training': TRAIN_CFG}),
                            optimizer, num_domains=2, joint=True,
                            fpl_uda=True, accum_steps=ACCUM)
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    stacked = tuple({k: np.stack([micro[m][d][k] if k == 'image_weight'
                                  else _cl(micro[m][d][k])
                                  for m in range(ACCUM)])
                     for k in micro[0][d]} for d in range(2))
    state, ref = jstep(state, stacked, jax.random.PRNGKey(0))
    ref, ref_params, ref_stats, ref_mu = jax.device_get(
        (ref, state.params, state.batch_stats, adam_mu(state.opt_state)))
    ref_grads = jax.tree_util.tree_map(lambda x: x / 0.1, ref_mu)

    net = create_network(TINY)
    net.load_state_dict(_port_names(params, stats), strict=True)
    net.train()
    opt = create_optimizer(TRAIN_CFG, net.parameters())
    step = JointTrainStep(
        net, create_loss_calculator({'training': TRAIN_CFG}), opt,
        create_lr_schedule(dict(TRAIN_CFG, last_iter=-1)), num_domains=2,
        fpl_uda=True, accum_steps=ACCUM)
    per_domain = [[torch_batches(micro[m])[d] for m in range(ACCUM)]
                  for d in range(2)]
    m = step(per_domain, [[None] * ACCUM, None])
    for key in ('loss', 'class_dice_0', 'class_dice_1'):
        np.testing.assert_allclose(m[key].numpy(), ref[key], rtol=1e-4,
                                   err_msg=key)
    check_grads(ref_grads, ref_stats,
                {k: p.grad for k, p in net.named_parameters()})
    check_params(ref_params, ref_stats, ref_grads, net.state_dict())
    assert opt.param_groups[0]['update_count'] == 1
    counts = {int(v) for k, v in net.state_dict().items()
              if k.endswith('num_batches_tracked')}
    assert counts == {ACCUM}
    with pytest.raises(ValueError, match='microbatches'):
        step([per_domain[0][:1], per_domain[1]], [None, None])


def test_accumulated_train_cli(tmp_path, monkeypatch):
    """``cli train`` with ``grad_accum_steps = 2``: each iteration feeds the
    step two host batches per domain and updates once; microbatches that
    differ in their optional keys raise."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(3)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    cfg = os.path.join(root, 'train.cfg')
    with open(cfg, 'w') as f:
        f.write(CLI_CFG.format(root=root, extra='grad_accum_steps = 2'))
    seen = []
    real_call = JointTrainStep.__call__

    def recording_call(self, batches, generators):
        seen.append([len(b) for b in batches])
        return real_call(self, batches, generators)

    monkeypatch.setattr(JointTrainStep, '__call__', recording_call)
    assert torch_main(['train', cfg], device='cpu') == 0
    assert seen == [[ACCUM, ACCUM]] * 2
    saved = torch.load(os.path.join(root, 'model', 'gen', 'gen_2.pt'),
                       weights_only=False)
    opt = saved['optimizer_state_dict']
    assert opt['param_groups'][0]['update_count'] == 2
    assert {int(s['step']) for s in opt['state'].values()} == {2}
    with open(os.path.join(root, 'model', 'gen', 'scalars.jsonl')) as f:
        losses = [json.loads(r) for r in f]
    assert any(r['tag'] == 'loss' for r in losses)

    from fpl_plus_torch.agents.agent_seg import _check_micro_keys
    with pytest.raises(ValueError, match='microbatch 1 has keys'):
        _check_micro_keys([{'image': 0, 'pixel_weight': 0}, {'image': 0}])
