"""PyTorch port, the joint training step and the train stage as a whole,
against the JAX package's ``make_train_step``.

One JAX train step is compiled for the file (module-scoped fixture): tiny
UNet2D5_dsbn (feature_chns [4,8,8,8,8]), dropout 0, batch 2+2 crops of
[8,16,16], DiceLoss with ``train_fpl_uda`` (pixel and image weights), Adam
at 1e-3 with MultiStepLR milestone 1 (gamma 0.5: the second update runs at
half the rate). Both tests feed it batches and weights that the port used
too; JAX runs on the CPU, the port on the CPU (``device='cpu'``).

Gradients of JAX's first step are read from Adam's first moment (after one
update ``mu = (1 - b1) g``), so no second program is compiled for them.

Tolerances (f32; two convolution libraries summing in other orders through
~20 layers and a batch-statistics backward):

* loss and dice: rtol 1e-4;
* gradients: per tensor, max abs err <= 1e-3 x that tensor's max |g|
  + 1e-5 x the largest |g| of the network (the convolution biases in front
  of a DSBN have a gradient that is zero in exact arithmetic: rounding
  noise there is measured against the network's scale);
* parameters after 2 Adam steps: max abs err <= 0.5 x the rate where
  the element's first gradient is above 10 x that tensor's gradient
  tolerance, and <= 4 x the rate elsewhere. Adam divides each gradient by
  its own magnitude, so its update carries the gradient's relative error
  times the rate: a whole sign-flipped update where the gradient is at the
  noise level, and in the second update, which divides the first moment
  (0.09 g1 + 0.1 g2, cancelling where the two gradients oppose) by the
  second, a share of the rate even where both are well determined
  (measured: up to 0.23 x the rate on the CLI test's crops);
* DSBN running statistics: rtol 1e-4; atol 1e-6 for the variances and
  0.1 x 4 x the rate for the means (momentum times the bound above: the
  batch mean of the second step moves with a convolution bias that the
  first step updated on a noise-level gradient; the variance does not).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.engine import train as torch_train
from fpl_plus_torch.engine.optim import create_lr_schedule, create_optimizer
from fpl_plus_torch.engine.train import JointTrainStep
from fpl_plus_torch.losses import create_loss_calculator
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_models import (jax_init, one_torch_thread,  # noqa
                                          randomize_stats)
from tests.test_torch_port_train_units import write_train_domain

TINY = {'net_type': 'UNet2D5_dsbn', 'num_domains': 2, 'class_num': 2,
        'in_chns': 1, 'feature_chns': [4, 8, 8, 8, 8],
        'conv_dims': [2, 2, 3, 3, 3], 'dropout': [0.0] * 5,
        'bilinear': False}
TRAIN_CFG = {'optimizer': 'Adam', 'learning_rate': 1e-3, 'momentum': 0.9,
             'weight_decay': 0.0, 'lr_scheduler': 'MultiStepLR',
             'lr_gamma': 0.5, 'lr_milestones': [1], 'loss_type': 'DiceLoss'}
CROP = (8, 16, 16)
LR = TRAIN_CFG['learning_rate']


@pytest.fixture(scope='module')
def jax_step():
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import make_train_step
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    from fpl_plus_tpu.models.registry import create_network as jax_network
    module = jax_network(TINY)
    optimizer = jax_optimizer(TRAIN_CFG, dict(TRAIN_CFG, last_iter=-1))
    step = make_train_step(module.apply, jax_loss({'training': TRAIN_CFG}),
                           optimizer, num_domains=2, joint=True,
                           fpl_uda=True)
    return module, optimizer, step


def _cl(x):
    return np.moveaxis(np.asarray(x), 1, -1)


def adam_mu(opt_state):
    """The first moment of the Adam inside a JAX optimizer state."""
    import optax
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0].mu


def tiny_variables(seed, net_cfg=TINY):
    """JAX ``(params, batch_stats)`` of ``net_cfg`` without a JAX compile:
    the port's network initialised from ``seed`` through the JAX package's
    numpy converter, the DSBN statistics then made random."""
    from fpl_plus_tpu.utils.torch_convert import convert_unet2d5_dsbn
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        net = create_network(net_cfg)
    params, stats = convert_unet2d5_dsbn(
        {k: v.numpy() for k, v in net.state_dict().items()}, net_cfg)
    return params, randomize_stats(stats, seed)


def torch_batches(step_batches):
    """Per-domain numpy batches -> dicts of CPU tensors."""
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in step_batches]


def run_jax(jax_step, params, stats, batches):
    """Two JAX steps from ``(params, stats)`` on per-step tuples of
    channels-first numpy domain batches. Returns the metrics of each step,
    the first step's gradients, and the final params and stats."""
    from fpl_plus_tpu.engine.train import create_train_state
    _, optimizer, step = jax_step
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    metrics, grads = [], None
    for i, step_batches in enumerate(batches):
        jb = tuple({k: (v if k == 'image_weight' else _cl(v))
                    for k, v in b.items()} for b in step_batches)
        state, m = step(state, jb, jax.random.PRNGKey(i))
        metrics.append(jax.device_get(m))
        if i == 0:
            grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                           adam_mu(state.opt_state))
    return metrics, grads, jax.device_get((state.params, state.batch_stats))


def _port_names(params, stats):
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               jax.tree_util.tree_map(np.asarray, stats),
                               TINY)


def check_grads(ref_params_grads, stats, got, to_port=_port_names):
    ref = to_port(ref_params_grads, stats)
    top = max(float(v.abs().max()) for k, v in ref.items() if k in got)
    for name, g in got.items():
        tol = 1e-3 * float(ref[name].abs().max()) + 1e-5 * top
        err = float((g - ref[name]).abs().max())
        assert err <= tol, (name, err, tol)
    return top


def check_params(ref_params, ref_stats, ref_grads, got_sd, lr=LR,
                 to_port=_port_names):
    ref = to_port(ref_params, ref_stats)
    grads = to_port(ref_grads, ref_stats)
    top = max(float(v.abs().max()) for k, v in grads.items()
              if not k.endswith(('running_mean', 'running_var',
                                 'num_batches_tracked')))
    for name, want in ref.items():
        got = got_sd[name]
        if name.endswith('num_batches_tracked'):
            continue
        if name.endswith('running_var'):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            continue
        if name.endswith('running_mean'):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                       atol=0.1 * 4 * lr, err_msg=name)
            continue
        err = (got - want).abs().numpy()
        g = grads[name].abs().numpy()
        signal = g > 10 * (1e-3 * g.max() + 1e-5 * top)
        assert err[signal].max(initial=0) <= 0.5 * lr, name
        assert err.max() <= 4 * lr, name


def make_batches(seed, steps=2, n=2):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        doms = []
        for d in range(2):
            x = rs.normal(size=(n, 1) + CROP).astype(np.float32) + d
            y = (x[:, 0] > 0.8).astype(np.int64)
            doms.append({
                'image': x,
                'label_prob': np.moveaxis(np.eye(2, dtype=np.float32)[y],
                                          -1, 1),
                'pixel_weight': ((rs.uniform(size=(n, 1) + CROP) > 0.2)
                                 * 0.8).astype(np.float32),
                'image_weight': rs.uniform(0.5, 1.0, n).astype(np.float32)})
        out.append(tuple(doms))
    return out


def test_joint_step_matches_jax(jax_step):
    """Two joint steps of the port (sequential domains) against JAX's
    compiled step: loss, per-domain dice, the first step's gradients, the
    parameters and both DSBN banks' running statistics after two Adam
    steps, and the per-bank update counters."""
    module = jax_step[0]
    params, stats = jax_init(module, seed=3)
    stats = randomize_stats(stats, seed=3)
    batches = make_batches(seed=8)
    ref_metrics, ref_grads, (ref_params, ref_stats) = run_jax(
        jax_step, params, stats, batches)

    net = create_network(TINY)
    net.load_state_dict(_port_names(params, stats), strict=True)
    net.train()
    opt = create_optimizer(TRAIN_CFG, net.parameters())
    sched = create_lr_schedule(dict(TRAIN_CFG, last_iter=-1))
    step = JointTrainStep(net, create_loss_calculator(
        {'training': TRAIN_CFG}), opt, sched, num_domains=2, fpl_uda=True)
    for i, step_batches in enumerate(batches):
        m = step(torch_batches(step_batches), [None, None])
        for key in ('loss', 'class_dice_0', 'class_dice_1'):
            np.testing.assert_allclose(m[key].numpy(), ref_metrics[i][key],
                                       rtol=1e-4, err_msg=key)
        if i == 0:
            check_grads(ref_grads, stats, {
                k: p.grad for k, p in net.named_parameters()})
    assert opt.param_groups[0]['lr'] == LR / 2
    check_params(ref_params, ref_stats, ref_grads, net.state_dict())
    counts = {int(v) for k, v in net.state_dict().items()
              if k.endswith('num_batches_tracked')}
    assert counts == {2}


CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
1_train_csv = {root}/d0_train.csv
2_train_csv = {root}/d1_train.csv
1_valid_csv = {root}/d0_valid.csv
2_valid_csv = {root}/d1_valid.csv
test_csv = {root}/d1_test.csv
train_batch_size = 2
num_workder = 0
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip, LabelToProbability]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [8, 16, 16]
RandomCrop_output_size = [8, 16, 16]
RandomCrop_foreground_focus = True
RandomCrop_foreground_ratio = 0.5
RandomCrop_mask_label = [1]
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D5_dsbn
num_domains = 2
class_num = 2
in_chns = 1
feature_chns = [4, 8, 8, 8, 8]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.0, 0.0, 0.0]
bilinear = False

[training]
dual = True
fused_domain_forward = True
train_fpl_uda = True
val_t2 = True
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-3
momentum = 0.9
weight_decay = 0.0
lr_scheduler = MultiStepLR
lr_gamma = 0.5
lr_milestones = [1]
iter_start = 0
iter_max = 2
iter_valid = 2
iter_save = 2
random_seed = 4
ckpt_save_dir = {root}/model/gen
{extra}

[testing]
ckpt_mode = 0
domian_label = 1
output_dir = {root}/result
sliding_window_enable = True
sliding_window_size = [8, 16, 16]
sliding_window_stride = [6, 12, 12]
tta_mode = 1
"""


def test_train_cli_matches_jax_step(jax_step, tmp_path, monkeypatch):
    """``fpl_plus_torch.cli main(['train', cfg], device='cpu')``: 2
    iterations on a tiny weighted workspace, then the auto test stage. The
    port's initial weights (through the JAX package's reference-checkpoint
    converter) and the batches its agent fed the step go through the JAX
    step; the parameters in the written ``gen_2.pt`` match JAX's. The auto
    test stage wrote one label map per test volume."""
    from fpl_plus_tpu.utils.torch_convert import convert_unet2d5_dsbn
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    rs = np.random.RandomState(6)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    cfg = os.path.join(root, 'train.cfg')
    with open(cfg, 'w') as f:
        f.write(CLI_CFG.format(root=root, extra=''))

    seen = {'batches': []}
    real_call = JointTrainStep.__call__

    def recording_call(self, batches, generators):
        if not seen['batches']:
            seen['init'] = {k: v.detach().clone()
                            for k, v in self.module.state_dict().items()}
        seen['batches'].append(tuple({k: v.numpy().copy()
                                      for k, v in b.items()}
                                     for b in batches))
        out = real_call(self, batches, generators)
        seen.setdefault('metrics', []).append(
            {k: v.numpy() for k, v in out.items()})
        if 'grads' not in seen:
            seen['grads'] = {k: p.grad.clone()
                             for k, p in self.module.named_parameters()}
        return out

    monkeypatch.setattr(torch_train.JointTrainStep, '__call__',
                        recording_call)
    assert torch_main(['train', cfg], device='cpu') == 0
    assert len(seen['batches']) == 2
    assert sorted(seen['batches'][0][0]) == ['image', 'image_weight',
                                             'label_prob', 'pixel_weight']

    params, stats = convert_unet2d5_dsbn(
        {k: v.numpy() for k, v in seen['init'].items()}, TINY)
    ref_metrics, ref_grads, (ref_params, ref_stats) = run_jax(
        jax_step, params, stats, seen['batches'])
    for got, ref in zip(seen['metrics'], ref_metrics):
        for key in ('loss', 'class_dice_0', 'class_dice_1'):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=key)
    ckpt_dir = os.path.join(root, 'model', 'gen')
    saved = torch.load(os.path.join(ckpt_dir, 'gen_2.pt'),
                       weights_only=False)
    assert saved['iteration'] == 2
    assert saved['optimizer_state_dict']['param_groups'][0][
        'update_count'] == 2
    check_grads(ref_grads, ref_stats, seen['grads'])
    check_params(ref_params, ref_stats, ref_grads,
                 saved['model_state_dict'])
    with open(os.path.join(ckpt_dir, 'gen_latest.txt')) as f:
        assert f.read() == '2'
    assert os.path.isfile(os.path.join(ckpt_dir, 'gen_best.txt'))
    out = os.path.join(root, 'result', 'gen_d1_test')
    names = sorted(os.listdir(out))
    assert names == ['img0.nii.gz', 'img1.nii.gz', 'img2.nii.gz']
    lab = load_image_as_nd_array(os.path.join(out, names[0]))['data_array']
    assert lab.shape == (1, 12, 24, 24) and lab.dtype == np.uint8


def test_train_cli_refusals(tmp_path):
    """The ``[training]`` combinations the JAX package refuses raise
    ``ValueError`` before any training: gradient accumulation off the
    joint path (``dual = False``, ``dis``, ``dual_consistency``) and a
    count below 1."""
    root = str(tmp_path)
    write_train_domain(root, 0, np.random.RandomState(1), n=1)
    for extra, err in (
            ('grad_accum_steps = 2\ndual = False', 'dual = True'),
            ('grad_accum_steps = 2\ndis = True', 'dual_consistency / dis'),
            ('grad_accum_steps = 2\ndual_consistency = True',
             'dual_consistency / dis'),
            ('grad_accum_steps = 0', '>= 1')):
        cfg = os.path.join(root, 'r.cfg')
        with open(cfg, 'w') as f:
            f.write(CLI_CFG.format(root=root, extra=extra).replace(
                'dual = True\n', '' if 'dual = False' in extra else
                'dual = True\n'))
        with pytest.raises(ValueError, match=err):
            torch_main(['train', cfg], device='cpu')
    assert not os.path.exists(os.path.join(root, 'model', 'gen', 'gen_2.pt'))
