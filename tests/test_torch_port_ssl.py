"""PyTorch port, the semi-supervised agents against the JAX package's.

One step of each SSL method (``agents/ssl.py``; CCT, CPS and URPC in
``tests/test_torch_port_ssl_nets.py``) on the tiny UNet2D of the
JAX package's paradigm tests (widths [2,4,8,8], 16x16 inputs, 2 labelled +
2 unlabelled, DiceLoss, Adam at 1e-3, ``regular_w`` of iteration 5). The
JAX variables come from ``jax.eval_shape`` of the flax init filled from a
numpy seed (no init compile) and cross through the weight bridge; each
case compiles the JAX agent's jitted step once. The draws are made equal:
the teacher's input noise is zeroed on both sides (``_noise_like`` /
``noise_like`` monkeypatched), the network dropout is 0, and where a
network draws in train mode at rate 0 (URPC's head dropout, CCT's
perturbations) both sides read the same fixed masks, quantile and noise
(``shared_draws``).

Tolerances: the loss components and ``regular_w`` rtol 1e-4; the
parameters and BN statistics after the step as
``tests/test_torch_port_train_step.py`` holds them (``check_params``: 0.5
x the rate where the gradient is well above its noise, 4 x elsewhere); the
EMA teacher within 1 - alpha of those bounds, its share of the student's
update, and equal to its blend of the start and the updated student.

Beside the steps: the unlabelled stream against the JAX agent's, the EMA
teacher across a checkpoint and a resume, and one ``main_ssl`` train +
test + evaluation run of MeanTeacher on the CPU.
"""
import csv
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.agents import ssl as port_ssl
from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.optim import create_optimizer
from fpl_plus_torch.models import unet2d as port_unet2d
from fpl_plus_torch.models.multi_net import make_binet
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import (state_dict_from_flax,
                                          state_dict_from_multinet)
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_train_step import adam_mu, check_params
from tests.test_torch_port_zoo import random_variables

NET = {'net_type': 'UNet2D', 'class_num': 2, 'in_chns': 1,
       'feature_chns': [2, 4, 8, 8], 'dropout': [0.0] * 4, 'bilinear': True}
TRAIN = {'loss_type': 'DiceLoss', 'optimizer': 'Adam',
         'learning_rate': 1e-3, 'momentum': 0.9, 'weight_decay': 0.0,
         'lr_scheduler': None, 'iter_max': 100}
LR = TRAIN['learning_rate']
HYPER_IT = 5
FIXED_Q = 0.8          # CCT's feature-drop quantile under shared draws


def paradigm_config(section, net_extra=None, sec_extra=None):
    return {'dataset': {'task_type': 'seg'},
            'network': dict(NET, **(net_extra or {})),
            'training': dict(TRAIN), 'testing': {},
            section: dict({'regularize_w': 0.1, 'rampup_start': 0,
                           'rampup_end': 100}, **(sec_extra or {}))}


def fixed_uniform(shape, low=0.0, high=1.0):
    """Uniform draws fixed by ``shape`` and range (channels-first)."""
    key = zlib.crc32(repr((tuple(int(s) for s in shape), low, high))
                     .encode())
    return np.random.RandomState(key).uniform(low, high, shape).astype(
        np.float32)


@pytest.fixture
def shared_draws(monkeypatch):
    """The train-mode draws of UNet2D_URPC and UNet2D_CCT made equal on
    both sides: a dropout at rate p keeps where ``fixed_uniform`` of the
    channels-first shape is below 1 - p; CCT's quantile is FIXED_Q and its
    feature noise ``fixed_uniform`` in [-0.3, 0.3)."""
    import flax.linen as linen
    import fpl_plus_tpu.models.unet2d as jax_unet2d

    class FixedDropout(linen.Module):
        rate: float
        broadcast_dims: tuple = ()
        deterministic: bool = None
        rng_collection: str = 'dropout'

        def __call__(self, inputs, deterministic=None, rng=None):
            det = self.deterministic if deterministic is None \
                else deterministic
            if self.rate == 0 or det:
                return inputs
            cf = (inputs.shape[0], inputs.shape[-1]) + inputs.shape[1:-1]
            keep = np.moveaxis(fixed_uniform(cf) < 1.0 - self.rate, 1, -1)
            return jnp.where(keep, inputs / (1.0 - self.rate), 0)

    def jax_feature_dropout(x, rng):
        attention = jnp.mean(jnp.abs(x), axis=-1, keepdims=True)
        thresh = jnp.quantile(attention.reshape(x.shape[0], -1), FIXED_Q,
                              axis=1).reshape((-1,) + (1,) * (x.ndim - 1))
        return x * (attention < thresh)

    def jax_feature_noise(x, rng, uniform_range=0.3):
        cf = (x.shape[0], x.shape[-1]) + x.shape[1:-1]
        return x * (1.0 + np.moveaxis(fixed_uniform(cf, -0.3, 0.3), 1, -1))

    def port_dropout(x, p, generators=None):
        if p == 0 or generators is None:
            return x
        keep = torch.from_numpy(fixed_uniform(tuple(x.shape)) < 1.0 - p)
        return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype))

    def port_uniform(shape, low, high, generators, device):
        if shape == (1,):
            return torch.full((len(generators),), FIXED_Q)
        rows = shape[0] * len(generators)
        return torch.from_numpy(fixed_uniform((rows,) + tuple(shape[1:]),
                                              low, high))

    monkeypatch.setattr(linen, 'Dropout', FixedDropout)
    monkeypatch.setattr(jax_unet2d, '_feature_dropout', jax_feature_dropout)
    monkeypatch.setattr(jax_unet2d, '_feature_noise', jax_feature_noise)
    monkeypatch.setattr(port_unet2d, 'grouped_dropout', port_dropout)
    monkeypatch.setattr(port_unet2d, '_group_uniform', port_uniform)


@pytest.fixture
def no_noise(monkeypatch):
    """The teacher's input noise zeroed on both sides."""
    import fpl_plus_tpu.agents.ssl as jax_ssl
    import fpl_plus_tpu.agents.wsl as jax_wsl
    from fpl_plus_torch.agents import wsl as port_wsl
    for mod in (jax_ssl, jax_wsl):
        monkeypatch.setattr(mod, '_noise_like',
                            lambda rng, x: jnp.zeros_like(x))
    for mod in (port_ssl, port_wsl):
        monkeypatch.setattr(mod, 'noise_like',
                            lambda gen, x: torch.zeros_like(x))


def variables_and_port(cfg, binet, x_cl, seed):
    """Seeded JAX variables of the network (a BiNet when ``binet``), its
    flax module and the converter to port state dicts."""
    from fpl_plus_tpu.models.multi_net import make_binet as jax_binet
    from fpl_plus_tpu.models.registry import create_network as jax_create
    net_cfg = cfg['network']
    module = jax_binet(net_cfg) if binet else jax_create(net_cfg)
    params, stats = random_variables(module, x_cl, seed)
    if binet:
        def to_port(p, s):
            return state_dict_from_multinet(p, s, net_cfg)
    else:
        def to_port(p, s):
            return state_dict_from_flax(p, s)
    return module, params, stats, to_port


def run_jax(agent, module, params, stats, batches, hyper=None, step=None):
    """One step of the JAX agent's jitted step (``step`` when given: one
    compiled before) from ``(params, stats)``: its metrics and hyper (the
    agent's of iteration HYPER_IT unless given), the first gradient
    (Adam's first moment / 0.1), the post-step state and the step."""
    from fpl_plus_tpu.engine.optim import create_optimizer as jax_optimizer
    from fpl_plus_tpu.engine.train import create_train_state
    from fpl_plus_tpu.losses import create_loss_calculator as jax_loss
    cfg_t = agent.config['training']
    agent.module = module
    agent.variables = {'params': params, 'batch_stats': stats}
    optimizer = jax_optimizer(cfg_t, dict(cfg_t, last_iter=-1))
    state = create_train_state(jax.tree_util.tree_map(np.array, params),
                               jax.tree_util.tree_map(np.array, stats),
                               optimizer)
    state = agent.init_extra_state(state)
    if step is None:
        step = agent.build_train_step(optimizer, jax_loss(agent.config))
    if hyper is None:
        hyper = agent.training_hyper(HYPER_IT)
    state, metrics = step(state, batches, jax.random.PRNGKey(0),
                          {k: jnp.float32(v) for k, v in hyper.items()})
    grads = jax.tree_util.tree_map(lambda mu: np.asarray(mu) / 0.1,
                                   adam_mu(state.opt_state))
    return (jax.device_get(metrics), hyper, grads, jax.device_get(state),
            step)


def run_port(agent_cls, cfg, sd, binet, batches, hyper=None):
    """One step of the port agent's step object on the CPU (with the
    agent's hyper of iteration HYPER_IT unless given)."""
    agent = agent_cls(cfg, 'train', 'cpu')
    net = make_binet(cfg['network']) if binet else \
        create_network(cfg['network'])
    net.load_state_dict(sd, strict=True)
    agent.module = net.train()
    optimizer = create_optimizer(cfg['training'], net.parameters())
    step = agent._build_step(optimizer, None)
    if hyper is None:
        hyper = agent.training_hyper(HYPER_IT)
    metrics = step(batches, agent._step_generators(HYPER_IT), **hyper)
    return metrics, hyper, agent


def check_step(got, want, keys=('loss', 'loss_sup', 'loss_reg',
                                'class_dice_0')):
    for key in keys:
        np.testing.assert_allclose(np.asarray(got[key]), want[key],
                                   rtol=1e-4, err_msg=key)


def check_teacher(teacher, start, student, ref_extra, ref_stats, ref_grads,
                  to_port):
    """The port's teacher is ``alpha start + (1 - alpha) student`` (f32
    rounding), and JAX's within ``1 - alpha`` of ``check_params``'s
    bounds: 0.5 x the rate where the gradient is well above its noise, 4 x
    elsewhere."""
    a = teacher.alpha
    want = to_port(ref_extra, ref_stats)
    grads = to_port(ref_grads, ref_stats)
    top = max(float(g.abs().max()) for k, g in grads.items()
              if k in teacher.params)
    assert set(teacher.params) <= set(want)
    for name, got in teacher.params.items():
        blend = a * start[name] + (1 - a) * student[name].detach()
        torch.testing.assert_close(got, blend, rtol=1e-6, atol=1e-7)
        err = (got - want[name]).abs().numpy()
        g = grads[name].abs().numpy()
        signal = g > 10 * (1e-3 * g.max() + 1e-5 * top)
        assert err[signal].max(initial=0) <= 0.5 * LR * (1 - a) + 1e-7, name
        assert err.max() <= 4 * LR * (1 - a) + 1e-7, name


def images(rs, n=2, hw=16):
    x = rs.normal(size=(n, 1, hw, hw)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    return x, np.moveaxis(np.eye(2, dtype=np.float32)[y], -1, 1)


def cl(x):
    return np.moveaxis(x, 1, -1)


SSL_CASES = {
    'EntropyMinimization': ({}, {}),
    'MeanTeacher': ({}, {'ema_decay': 0.99}),
    'UAMT': ({}, {'uamt_mcdroput_n': 2}),
    'CCT': ({'net_type': 'UNet2D_CCT'}, {}),
    'CPS': ({}, {}),
    'URPC': ({'net_type': 'UNet2D_URPC'}, {}),
}


# the methods of this file; CCT, CPS and URPC (their own nets) are in
# tests/test_torch_port_ssl_nets.py, so that two workers share the compiles
UNET2D_METHODS = ['EntropyMinimization', 'MeanTeacher', 'UAMT']


@pytest.mark.parametrize('method', UNET2D_METHODS)
def test_ssl_step_matches_jax(method, no_noise, shared_draws):
    """One step of each method: loss components, ``regular_w``, the
    post-step parameters and BN statistics and, with a teacher, the EMA
    teacher, against the JAX agent's step."""
    ssl_step_matches_jax(method)


def ssl_step_matches_jax(method):
    """The check of ``test_ssl_step_matches_jax`` (with ``no_noise`` and
    ``shared_draws`` active)."""
    from fpl_plus_tpu.agents.ssl import SSLMethodDict as JaxSSL
    net_extra, sec_extra = SSL_CASES[method]
    cfg = paradigm_config('semi_supervised_learning', net_extra, sec_extra)
    binet = method == 'CPS'
    rs = np.random.RandomState(11)
    x0, y0 = images(rs)
    x1, _ = images(rs)
    module, params, stats, to_port = variables_and_port(
        cfg, binet, cl(np.concatenate([x0, x1])), seed=21)
    jax_agent = JaxSSL[method](cfg, 'train')
    ref, ref_hyper, ref_grads, ref_state, _ = run_jax(
        jax_agent, module, params, stats,
        {'lab': {'image': jnp.asarray(cl(x0)),
                 'label_prob': jnp.asarray(cl(y0))},
         'unlab': {'image': jnp.asarray(cl(x1))}})
    got, hyper, agent = run_port(
        port_ssl.SSLMethodDict[method], cfg, to_port(params, stats), binet,
        {'lab': {'image': torch.from_numpy(x0),
                 'label_prob': torch.from_numpy(y0)},
         'unlab': {'image': torch.from_numpy(x1)}})
    np.testing.assert_allclose(hyper['regular_w'], ref_hyper['regular_w'],
                               rtol=1e-4)
    check_step(got, ref)
    check_params(ref_state.params, ref_state.batch_stats, ref_grads,
                 agent.module.state_dict(), lr=LR, to_port=to_port)
    assert (agent.teacher is not None) == (ref_state.extra is not None)
    if agent.teacher is not None:
        check_teacher(agent.teacher, to_port(params, stats),
                      dict(agent.module.named_parameters()), ref_state.extra,
                      ref_state.batch_stats, ref_grads, to_port)


def test_teacher_forward_keeps_student_statistics():
    """A teacher forward (train mode, batch statistics) leaves the
    student's running statistics and update counters as they were."""
    cfg = paradigm_config('semi_supervised_learning')
    agent = port_ssl.SSLMeanTeacher(cfg, 'train', 'cpu')
    agent.module = create_network(cfg['network']).train()
    step = agent._build_step(create_optimizer(
        cfg['training'], agent.module.parameters()), None)
    before = {k: v.clone() for k, v in agent.module.named_buffers()}
    x = torch.from_numpy(images(np.random.RandomState(2))[0])
    head = step.teacher_head(x, None)
    assert head.shape == (2, 2, 16, 16)
    for k, v in agent.module.named_buffers():
        assert torch.equal(v, before[k]), k


def test_bf16_step_keeps_f32_state():
    """``[training] precision = bfloat16`` reaches the paradigm steps,
    the teacher's forwards included: a finite loss, f32 parameters, BN
    statistics and teacher after a MeanTeacher step."""
    cfg = paradigm_config('semi_supervised_learning')
    cfg['training']['precision'] = 'bfloat16'
    agent = port_ssl.SSLMeanTeacher(cfg, 'train', 'cpu')
    agent.module = create_network(cfg['network']).train()
    step = agent._build_step(create_optimizer(
        cfg['training'], agent.module.parameters()), None)
    assert step.compute_dtype == torch.bfloat16
    rs = np.random.RandomState(6)
    x0, y0 = images(rs)
    metrics = step({'lab': {'image': torch.from_numpy(x0),
                            'label_prob': torch.from_numpy(y0)},
                    'unlab': {'image': torch.from_numpy(images(rs)[0])}},
                   agent._step_generators(0), **agent.training_hyper(50))
    assert np.isfinite(float(metrics['loss']))
    assert float(metrics['loss_reg']) > 0
    tensors = (list(agent.module.parameters())
               + [b for k, b in agent.module.named_buffers()
                  if k.endswith(('running_mean', 'running_var'))]
               + list(agent.teacher.params.values()))
    assert all(t.dtype == torch.float32 for t in tensors)


def test_ema_teacher_persists_across_resume(tmp_path):
    """MeanTeacher's teacher rides in the checkpoint and a resumed agent
    restores it exactly (not a fresh copy of the student)."""
    cfg = paradigm_config('semi_supervised_learning', {},
                          {'ema_decay': 0.5})
    agent = port_ssl.SSLMeanTeacher(cfg, 'train', 'cpu')
    agent.module = create_network(cfg['network']).train()
    optimizer = create_optimizer(cfg['training'], agent.module.parameters())
    step = agent._build_step(optimizer, None)
    rs = np.random.RandomState(4)
    x0, y0 = images(rs)
    batches = {'lab': {'image': torch.from_numpy(x0),
                       'label_prob': torch.from_numpy(y0)},
               'unlab': {'image': torch.from_numpy(images(rs)[0])}}
    for it in range(3):       # the teacher drifts away from its start
        step(batches, agent._step_generators(it),
             **agent.training_hyper(it))
    ckpt_lib.save_checkpoint(str(tmp_path), 'mt', 3, dict(
        agent._ckpt_state(agent.module.state_dict(), optimizer),
        iteration=3), 0.5)
    saved = {k: v.clone() for k, v in agent.teacher.params.items()}

    agent2 = port_ssl.SSLMeanTeacher(cfg, 'train', 'cpu')
    agent2.module = create_network(cfg['network']).train()
    agent2._resume(agent2.module, str(tmp_path), 'mt', 3, {})
    agent2._build_step(create_optimizer(
        cfg['training'], agent2.module.parameters()), None)
    for name, value in saved.items():
        assert torch.equal(agent2.teacher.params[name], value), name
    student = dict(agent2.module.named_parameters())
    assert any(not torch.equal(student[k], v) for k, v in saved.items())


SSL_CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/d0_train.csv
train_csv_unlab = {root}/unlab.csv
valid_csv = {root}/d0_valid.csv
test_csv = {root}/d0_test.csv
train_batch_size = 1
train_batch_size_unlab = 2
num_workder = 0
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip, LabelToProbability]
train_transform_unlab = [NormalizeWithMeanStd, Pad, RandomCrop, RandomFlip]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [8, 16, 16]
RandomCrop_output_size = [8, 16, 16]
RandomCrop_foreground_focus = False
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D5
num_domains = 1
class_num = 2
in_chns = 1
feature_chns = [2, 4, 4, 4, 4]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.0, 0.1, 0.1]
bilinear = False

[training]
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-3
weight_decay = 0.0
lr_scheduler = None
iter_max = 2
iter_valid = 1
iter_save = 2
random_seed = 5
ckpt_save_dir = {root}/model/mt

[testing]
ckpt_mode = 0
output_dir = {root}/result
sliding_window_enable = True
sliding_window_size = [8, 16, 16]
sliding_window_stride = [6, 12, 12]
tta_mode = 1

[semi_supervised_learning]
ssl_method = {method}
regularize_w = 0.1
rampup_start = 0
rampup_end = 2
ema_decay = 0.9

[evaluation]
metric_1 = dice
label_list = [1]
organ_name = cube
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/pairs.csv
"""


def write_ssl_workspace(root, method='MeanTeacher'):
    from tests.test_torch_port_train_units import write_train_domain
    write_train_domain(root, 0, np.random.RandomState(3))
    write_train_domain(root, 1, np.random.RandomState(4))
    with open(os.path.join(root, 'unlab.csv'), 'w') as f:
        f.write('image\n' + ''.join('d1/img{0}.nii.gz\n'.format(c)
                                    for c in range(3)))
    with open(os.path.join(root, 'pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(
            'd0/lab{0}.nii.gz,img{0}.nii.gz\n'.format(c) for c in range(3)))
    cfg = os.path.join(root, 'ssl.cfg')
    with open(cfg, 'w') as f:
        f.write(SSL_CLI_CFG.format(root=root, method=method))
    return cfg


def test_unlabelled_stream_matches_jax_agent(tmp_path):
    """The port agent's unlabelled loader yields the JAX agent's stream
    (manifest, transforms, seed ``random_seed + 100``) over 2 epochs."""
    from fpl_plus_tpu.agents.ssl import SSLMeanTeacher as JaxMT
    from fpl_plus_tpu.config.parser import parse_config as jax_parse
    from fpl_plus_tpu.config.parser import synchronize_config as jax_sync
    from fpl_plus_torch.config.parser import (parse_config,
                                              synchronize_config)
    from fpl_plus_torch.io.loader import repeat_loader
    cfg = write_ssl_workspace(str(tmp_path))
    ref_agent = JaxMT(jax_sync(jax_parse(cfg)), 'train')
    ref_agent.create_dataset()
    agent = port_ssl.SSLMeanTeacher(synchronize_config(parse_config(cfg)),
                                    'train', 'cpu')
    agent.create_dataset()
    got = repeat_loader(agent.train_loader_unlab)
    try:
        for _ in range(3):
            a, b = next(ref_agent._unlab_iter), next(got)
            assert a['names'] == b['names']
            np.testing.assert_array_equal(b['image'], a['image'])
            assert b['RandomCrop_Param'] == a['RandomCrop_Param']
    finally:
        ref_agent.shutdown()


def test_main_ssl_train_test_evaluate(tmp_path, monkeypatch):
    """``main_ssl(['train', cfg], device='cpu')`` of MeanTeacher: 2
    iterations with validation after each, checkpoints carrying the
    teacher, the auto test stage's labels and the evaluation CSV; an
    unknown method raises ``ValueError``."""
    from fpl_plus_torch.cli import main_ssl
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    cfg = write_ssl_workspace(root)
    seen = []
    real = port_ssl.MeanTeacherStep.__call__

    def recording(self, batches, draws, regular_w):
        seen.append((tuple(batches['unlab']['image'].shape), regular_w))
        return real(self, batches, draws, regular_w)

    monkeypatch.setattr(port_ssl.MeanTeacherStep, '__call__', recording)
    assert main_ssl(['train', cfg], device='cpu') == 0
    assert [s[0] for s in seen] == [(2, 1, 8, 16, 16)] * 2
    # the sigmoid ramp to iteration 2: exp(-5) and exp(-5 / 4) of 0.1
    assert [s[1] for s in seen] == pytest.approx(
        [0.1 * np.exp(-5.0), 0.1 * np.exp(-1.25)])
    saved = torch.load(os.path.join(root, 'model', 'mt', 'mt_2.pt'),
                       weights_only=False)
    assert set(saved['ema_state_dict']) == {
        k for k, _ in create_network({
            'net_type': 'UNet2D5', 'num_domains': 1, 'class_num': 2,
            'in_chns': 1, 'feature_chns': [2, 4, 4, 4, 4],
            'conv_dims': [2, 2, 3, 3, 3],
            'dropout': [0.0] * 5}).named_parameters()}
    out = os.path.join(root, 'result', 'mt_d0_test')
    lab = load_image_as_nd_array(os.path.join(out, 'img0.nii.gz'))
    assert lab['data_array'].shape == (1, 12, 24, 24)
    with open(os.path.join(out, 'test_cube_dice_all.csv')) as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 + 3 and all(0 <= float(r[1]) <= 1
                                      for r in rows[1:])
    bad = cfg.replace('ssl.cfg', 'bad.cfg')
    with open(cfg) as f, open(bad, 'w') as g:
        g.write(f.read().replace('ssl_method = MeanTeacher',
                                 'ssl_method = NoSuchMethod'))
    with pytest.raises(ValueError, match='NoSuchMethod'):
        main_ssl(['train', bad], device='cpu')
