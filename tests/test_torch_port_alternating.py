"""PyTorch port, the alternating per-domain step (``dual = False``) and its
schedule, against the JAX package's ``make_train_step(joint=False)`` with
the entropy term.

One JAX program is compiled: the alternating step of the tiny
UNet2D5_dsbn (feature_chns [4,8,8,8,8], dropout 0), batch 2+2 crops of
[8,16,16], DiceLoss with ``train_fpl_uda``, Adam at 1e-3, MultiStepLR
milestone 1 over iterations (2 updates per iteration). Tolerances are
``test_torch_port_train_step.py``'s: loss and dice rtol 1e-4; the first
moment of Adam after one iteration (0.9 x 0.1 g0 + 0.1 g1, g1 taken after
domain 0's update) by the per-tensor gradient rule; the parameters and the
DSBN statistics after the iteration's two updates by the Adam and
statistics rules.
"""
import jax
import numpy as np
import pytest
import torch

from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import AlternatingTrainStep, entropy_log2
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.registry import create_network
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import (LR, TINY, TRAIN_CFG, _cl,
                                              _port_names, adam_mu,
                                              check_grads, check_params,
                                              make_batches, tiny_variables,
                                              torch_batches)


def test_entropy_matches_jax():
    """``entropy_log2`` against the JAX function (rtol 1e-6)."""
    from fpl_plus_tpu.engine.train import entropy_log2 as jax_entropy
    logits = np.random.RandomState(1).normal(
        size=(2, 3, 4, 6, 5)).astype(np.float32) * 3
    got = float(entropy_log2(torch.from_numpy(logits)))
    want = float(jax_entropy(jax.numpy.asarray(_cl(logits))))
    assert got == pytest.approx(want, rel=1e-6)


def test_alternating_step_matches_jax():
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state, make_train_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    module = jax_network(TINY)
    params, stats = tiny_variables(5)
    batches = make_batches(seed=11)

    optimizer = jax_optimizer(TRAIN_CFG, dict(TRAIN_CFG, last_iter=-1),
                              updates_per_iteration=2)
    jstep = make_train_step(module.apply, jax_loss({'training': TRAIN_CFG}),
                            optimizer, num_domains=2, joint=False,
                            fpl_uda=True, entropy_coeff=1.0)
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    ref_metrics, after_first = [], None
    for i, step_batches in enumerate(batches):
        jb = tuple({k: (v if k == 'image_weight' else _cl(v))
                    for k, v in b.items()} for b in step_batches)
        state, m = jstep(state, jb, jax.random.PRNGKey(i))
        ref_metrics.append(jax.device_get(m))
        if i == 0:
            after_first = jax.device_get((state.params, state.batch_stats,
                                          adam_mu(state.opt_state)))
    jax_lr = float(state.opt_state.hyperparams['learning_rate'])

    net = create_network(TINY)
    net.load_state_dict(_port_names(params, stats), strict=True)
    net.train()
    opt = create_optimizer(TRAIN_CFG, net.parameters())
    lrs, real_step = [], opt.step

    def recording_step(*args, **kwargs):
        lrs.append(opt.param_groups[0]['lr'])
        return real_step(*args, **kwargs)

    opt.step = recording_step
    step = AlternatingTrainStep(
        net, create_loss_calculator({'training': TRAIN_CFG}), opt,
        create_lr_schedule(dict(TRAIN_CFG, last_iter=-1), 2), num_domains=2,
        fpl_uda=True, entropy_coeff=1.0)
    for i, step_batches in enumerate(batches):
        m = step(torch_batches(step_batches), [None, None])
        for key in ('loss', 'class_dice_0', 'class_dice_1'):
            np.testing.assert_allclose(m[key].numpy(), ref_metrics[i][key],
                                       rtol=1e-4, err_msg=key)
        if i == 0:
            ref_params, ref_stats, ref_mu = after_first
            mu = {k: opt.state[p]['exp_avg'] / 0.1
                  for k, p in net.named_parameters()}
            ref_grads = jax.tree_util.tree_map(lambda x: x / 0.1, ref_mu)
            check_grads(ref_grads, ref_stats, mu)
            check_params(ref_params, ref_stats, ref_grads, net.state_dict())
    # the schedule counts iterations, Adam's step counts updates
    assert lrs == [LR, LR, LR / 2, LR / 2]
    assert jax_lr == pytest.approx(LR / 2)
    assert opt.param_groups[0]['update_count'] == 4
    assert {int(s['step']) for s in opt.state.values()} == {4}


EVAL = """
[evaluation]
metric_1 = dice
metric_2 = assd
label_list = [1]
organ_name = cube
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/pairs.csv
"""


def test_alternating_train_cli_then_evaluation(tmp_path, monkeypatch):
    """``cli train`` with ``dual = False`` and an ``[evaluation]`` section:
    two updates per iteration, the auto test stage, then ``eva_main``'s
    reports over its labels."""
    import csv
    import os
    import sys
    from fpl_plus_torch.cli import main as torch_main
    from tests.test_torch_port_train_step import CLI_CFG
    from tests.test_torch_port_train_units import write_train_domain
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(7)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    with open(os.path.join(root, 'pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(
            'd1/lab{0}.nii.gz,img{0}.nii.gz\n'.format(c) for c in range(3)))
    cfg = os.path.join(root, 'train.cfg')
    with open(cfg, 'w') as f:
        f.write(CLI_CFG.format(root=root, extra='').replace(
            'dual = True', 'dual = False') + EVAL.format(root=root))
    assert torch_main(['train', cfg], device='cpu') == 0
    saved = torch.load(os.path.join(root, 'model', 'gen', 'gen_2.pt'),
                       weights_only=False)
    assert saved['optimizer_state_dict']['param_groups'][0][
        'update_count'] == 4
    seg_root = os.path.join(root, 'result', 'gen_d1_test')
    for metric in ('dice', 'assd'):
        with open(os.path.join(seg_root, 'test_cube_{0}_all.csv'.format(
                metric)), newline='') as f:
            rows = list(csv.reader(f))
        assert rows[0] == ['image', 'class_1']
        assert [r[0] for r in rows[1:]] == ['img0.nii.gz', 'img1.nii.gz',
                                            'img2.nii.gz', 'mean', 'std']
        assert all(np.isfinite(float(r[1])) for r in rows[1:])
