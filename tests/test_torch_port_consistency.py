"""PyTorch port, the dual-consistency step (``dual_consistency = True``)
against the JAX package's ``make_dual_consistency_step``, at gate 0 and
gate 1, and the dual-consistency train stage through the CLI.

One JAX program is compiled (the gate is a traced value): the step of the
tiny UNet2D5_dsbn (feature_chns [4,8,8,8,8], dropout 0), batch 2+2 crops
of [8,16,16] plus the domain-1 batch's ``image1``, DiceLoss with
``train_fpl_uda``, Adam at 1e-5, the entropy term. Tolerances are
``test_torch_port_train_step.py``'s: loss, dice and ``loss_consis`` rtol
1e-4; Adam's first moment after the two updates (0.9 x 0.1 g0 + 0.1 g1) by
the per-tensor gradient rule; the parameters and DSBN statistics by the
Adam and statistics rules at this rate.

Why 1e-5 and not the 1e-3 of the joint-step tests: the consistency target
is an eval-mode forward after the domain-0 update. The convolution biases
in front of a DSBN have a zero gradient in exact arithmetic, so each
framework's Adam moves them by +-rate on the sign of rounding noise; in
train mode the batch statistics cancel such a shift, in eval mode the
running statistics pass it to the logits (at 1e-3, ``loss_consis`` then
differed by 3.5e-4 relative). At 1e-5 the same effect is 100x smaller.
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
from fpl_plus_torch.engine.train import DualConsistencyStep
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.registry import create_network
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (CLI_CFG, TINY, TRAIN_CFG, _cl,
                                              _port_names, adam_mu,
                                              check_grads, check_params,
                                              make_batches, tiny_variables,
                                              torch_batches)
from tests.test_torch_port_train_units import write_train_domain


STEP_CFG = dict(TRAIN_CFG, learning_rate=1e-5)


@pytest.fixture(scope='module')
def jax_consistency():
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import make_dual_consistency_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    module = jax_network(TINY)
    optimizer = jax_optimizer(STEP_CFG, dict(STEP_CFG, last_iter=-1),
                              updates_per_iteration=2)
    step = make_dual_consistency_step(
        module.apply, jax_loss({'training': STEP_CFG}), optimizer,
        fpl_uda=True, entropy_coeff=1.0)
    return module, optimizer, step


@pytest.mark.parametrize('gate', [0.0, 1.0])
def test_consistency_step_matches_jax(jax_consistency, gate):
    from fpl_plus_tpu.engine.train import create_train_state
    module, optimizer, jstep = jax_consistency
    params, stats = tiny_variables(21)
    b0, b1 = make_batches(seed=17, steps=1)[0]
    rs = np.random.RandomState(18)
    b1['image1'] = (b1['image'] * 0.8 - 0.5 + rs.normal(
        0, 0.3, b1['image'].shape)).astype(np.float32)

    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    jb = tuple({k: (v if k == 'image_weight' else _cl(v))
                for k, v in b.items()} for b in (b0, b1))
    state, ref = jstep(state, jb, jax.random.PRNGKey(0),
                       {'consis_gate': jax.numpy.float32(gate)})
    ref, ref_params, ref_stats, ref_mu = jax.device_get(
        (ref, state.params, state.batch_stats, adam_mu(state.opt_state)))
    ref_grads = jax.tree_util.tree_map(lambda x: x / 0.1, ref_mu)

    net = create_network(TINY)
    net.load_state_dict(_port_names(params, stats), strict=True)
    net.train()
    opt = create_optimizer(STEP_CFG, net.parameters())
    step = DualConsistencyStep(
        net, create_loss_calculator({'training': STEP_CFG}), opt,
        create_lr_schedule(dict(STEP_CFG, last_iter=-1), 2), fpl_uda=True)
    m = step(torch_batches((b0, b1)), [None] * 3, gate)
    for key in ('loss', 'class_dice_0', 'class_dice_1', 'loss_consis'):
        np.testing.assert_allclose(m[key].numpy(), ref[key], rtol=1e-4,
                                   err_msg=key)
    assert float(m['loss_consis']) > 0 and net.training
    mu = {k: opt.state[p]['exp_avg'] / 0.1
          for k, p in net.named_parameters()}
    check_grads(ref_grads, ref_stats, mu)
    check_params(ref_params, ref_stats, ref_grads, net.state_dict(),
                 lr=STEP_CFG['learning_rate'])
    assert opt.param_groups[0]['update_count'] == 2
    with pytest.raises(ValueError, match='image1'):
        step(torch_batches((b0, b0)), [None] * 3, gate)


def write_image1(root, d, rs):
    """Add a fake-source ``image1`` volume per row of ``d{d}_train.csv``
    (the image, darkened and noised) as a fifth manifest column."""
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1.0, 1.0, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    path = os.path.join(root, 'd{0}_train.csv'.format(d))
    with open(path) as f:
        rows = [r.split(',') for r in f.read().splitlines()]
    for row in rows[1:]:
        img = load_image_as_nd_array(os.path.join(root, row[0]))
        fake = img['data_array'][0] * 0.7 + rs.normal(
            0, 0.2, img['data_array'].shape[1:]).astype(np.float32)
        row.append(row[0].replace('img', 'fake'))
        write_nifti(NiftiImage(fake.astype(np.float32), geom),
                    os.path.join(root, row[-1]))
    rows[0].append('image1')
    with open(path, 'w') as f:
        f.write(''.join(','.join(r) + '\n' for r in rows))


def test_consistency_train_cli(tmp_path, monkeypatch):
    """``cli train`` with ``dual_consistency = True``, an ``image1`` column,
    the dual transforms and ``consistency_start = 0``: two updates per
    iteration (the schedule per iteration), gate 0 then 1, one eval-mode
    forward per step (the module back in train mode after it), and the
    ``loss_consis`` / ``consis_gate`` scalars."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(8)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    write_image1(root, 1, rs)
    cfg = os.path.join(root, 'train.cfg')
    text = CLI_CFG.format(root=root, extra='dual_consistency = True\n'
                          'consistency_start = 0')
    text = text.replace('[NormalizeWithMeanStd, Pad, RandomCrop',
                        '[NormalizeWithMeanStd_dual, Pad_dual, RandomCrop')
    with open(cfg, 'w') as f:
        f.write(text)
    gates, evals = [], []
    real_call = DualConsistencyStep.__call__
    real_eval = DualConsistencyStep._eval_forward

    def recording_call(self, batches, generators, consis_gate):
        gates.append(consis_gate)
        assert 'image1' in batches[1] and len(generators) == 3
        return real_call(self, batches, generators, consis_gate)

    def recording_eval(self, params, x, domain):
        out = real_eval(self, params, x, domain)
        evals.append(self.module.training)
        return out

    monkeypatch.setattr(DualConsistencyStep, '__call__', recording_call)
    monkeypatch.setattr(DualConsistencyStep, '_eval_forward', recording_eval)
    assert torch_main(['train', cfg], device='cpu') == 0
    assert gates == [0.0, 1.0] and evals == [True, True]
    ckpt_dir = os.path.join(root, 'model', 'gen')
    saved = torch.load(os.path.join(ckpt_dir, 'gen_2.pt'),
                       weights_only=False)
    opt = saved['optimizer_state_dict']
    assert opt['param_groups'][0]['update_count'] == 4
    assert {int(s['step']) for s in opt['state'].values()} == {4}
    # lr_milestones [1] counts iterations: iteration 1 runs at half the rate
    assert opt['param_groups'][0]['lr'] == pytest.approx(
        TRAIN_CFG['learning_rate'] / 2)
    with open(os.path.join(ckpt_dir, 'scalars.jsonl')) as f:
        recs = [json.loads(r) for r in f]
    tags = {r['tag']: r for r in recs}
    assert np.isfinite(tags['loss_consis']['train'])
    assert tags['consis_gate']['train'] == 0.5
