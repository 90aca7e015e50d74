"""PyTorch port, the weakly-supervised agents and the gated CRF loss
against the JAX package's.

One step of each WSL method (``agents/wsl.py``; USTM and DMPLS in
``tests/test_torch_port_wsl_draws.py``) on the tiny UNet2D of
``tests/test_torch_port_ssl.py`` (whose helpers and tolerances this file
uses): 2 scribble-labelled 16x16 images with a random ``pixel_weight``,
the teacher's input noise zeroed on both sides, dropout 0. USTM runs at
each rotation ``k`` in 0-3 through one compiled JAX step (``k`` is an
argument of the step); DMPLS at a fixed ``beta``; GatedCRF at radius 2.

``GatedCRFLoss`` against the JAX package's on the same softmax, image and
masks (none, source, destination, both): both in float64 (rtol 1e-7: the
XY-only kernel is f32 on both sides),
and the port's f32 loss against JAX's float64 one (rtol 1e-5). The loss is
the difference of two sums of the same order, so an f32 evaluation
cancels: JAX's own f32 loss is 1.1e-5 off its float64 value on the
unmasked case (measured), the port's 1.8e-7, so the two f32 losses are
not held against each other. Then one ``main_wsl`` train + test run
of GatedCRF on the CPU with scribbles through
``PartialLabelToProbability``.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.agents import wsl as port_wsl
from fpl_plus_torch.losses.gatedcrf import GatedCRFLoss
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import (LR, check_params, check_step,
                                       check_teacher, cl, images,
                                       no_noise,  # noqa: F401 (fixture)
                                       paradigm_config, run_jax, run_port,
                                       variables_and_port)


WSL_CASES = {
    'EntropyMinimization': ({}, None),
    'TotalVariation': ({}, None),
    'MumfordShah': ({'mumfordshahloss_lambda': 0.5}, None),
    'GatedCRF': ({'gatedcrfloss_radius': 2}, None),
    'USTM-k0': ({'ustm_mcdroput_n': 2}, 0),
    'USTM-k1': ({'ustm_mcdroput_n': 2}, 1),
    'USTM-k2': ({'ustm_mcdroput_n': 2}, 2),
    'USTM-k3': ({'ustm_mcdroput_n': 2}, 3),
    'DMPLS': ({}, None),
}
BETA = 0.3                           # DMPLS's mix under test
_JAX_STEPS = {}                      # USTM: one compiled step for every k


# the cases of this file; USTM and DMPLS (their per-iteration host draws)
# are in tests/test_torch_port_wsl_draws.py, so that two workers share the
# compiles
REGULARIZER_CASES = ['EntropyMinimization', 'TotalVariation', 'MumfordShah',
                     'GatedCRF']


@pytest.mark.parametrize('case', REGULARIZER_CASES)
def test_wsl_step_matches_jax(case, no_noise):
    """One step of each method: loss components, ``regular_w``, the
    post-step parameters and BN statistics and, for USTM, the EMA teacher,
    against the JAX agent's step."""
    wsl_step_matches_jax(case)


def wsl_step_matches_jax(case):
    """The check of ``test_wsl_step_matches_jax`` (with ``no_noise``
    active)."""
    from fpl_plus_tpu.agents.wsl import WSLMethodDict as JaxWSL
    method = case.split('-')[0]
    sec_extra, k = WSL_CASES[case]
    cfg = paradigm_config('weakly_supervised_learning', {}, sec_extra)
    binet = method == 'DMPLS'
    rs = np.random.RandomState(13)
    x, y = images(rs)
    pw = (rs.uniform(size=(2, 1, 16, 16)) > 0.6).astype(np.float32)
    module, params, stats, to_port = variables_and_port(cfg, binet, cl(x),
                                                        seed=23)
    jax_batch = {'image': jnp.asarray(cl(x)), 'label_prob': jnp.asarray(
        cl(y)), 'pixel_weight': jnp.asarray(cl(pw))}
    port_batch = {'image': torch.from_numpy(x),
                  'label_prob': torch.from_numpy(y),
                  'pixel_weight': torch.from_numpy(pw)}
    jax_batches, port_batches = (jax_batch,), (port_batch,)
    if k is not None:
        jax_batches += (jnp.int32(k),)
        port_batches += (k,)
    agent = JaxWSL[method](cfg, 'train')
    hyper = dict(agent.training_hyper(5), beta=BETA) if binet else None
    ref, ref_hyper, ref_grads, ref_state, step = run_jax(
        agent, module, params, stats, jax_batches, hyper,
        _JAX_STEPS.get(method))
    if k is not None:
        _JAX_STEPS[method] = step
    got, got_hyper, port_agent = run_port(
        port_wsl.WSLMethodDict[method], cfg, to_port(params, stats), binet,
        port_batches, dict(hyper) if binet else None)
    np.testing.assert_allclose(got_hyper['regular_w'],
                               ref_hyper['regular_w'], rtol=1e-4)
    check_step(got, ref)
    check_params(ref_state.params, ref_state.batch_stats, ref_grads,
                 port_agent.module.state_dict(), lr=LR, to_port=to_port)
    assert (port_agent.teacher is not None) == (ref_state.extra is not None)
    if port_agent.teacher is not None:
        check_teacher(port_agent.teacher, to_port(params, stats),
                      dict(port_agent.module.named_parameters()),
                      ref_state.extra, ref_state.batch_stats, ref_grads,
                      to_port)


CRF_MASKS = ['none', 'src', 'dst', 'both']


@pytest.mark.parametrize('masks', CRF_MASKS)
def test_gatedcrf_loss_matches_jax(masks):
    from fpl_plus_tpu.losses.gatedcrf import GatedCRFLoss as JaxCRF
    rs = np.random.RandomState(17)
    logits = rs.normal(size=(2, 3, 12, 14)).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    image = rs.normal(size=(2, 1, 12, 14)).astype(np.float32)

    def mask():
        m = rs.choice([0.0, 0.5, 1.0, 2.0], size=(2, 1, 12, 14)).astype(
            np.float32)
        m[0, 0, 0, :3] = np.nan
        return m

    src = mask() if masks in ('src', 'both') else None
    dst = mask() if masks in ('dst', 'both') else None
    kernels = [{'weight': 1.0, 'xy': 5, 'rgb': 0.1},
               {'weight': 0.7, 'xy': 3}]

    def jax_loss(soft, image, src, dst):
        return JaxCRF()(soft, kernels, 2, {'rgb': image}, 12, 14,
                        mask_src=src, mask_dst=dst)['loss']

    def port_loss(dtype):
        def t(a):
            return None if a is None else torch.from_numpy(a).to(dtype)
        return float(GatedCRFLoss()(t(soft), kernels, 2, {'rgb': t(image)},
                                    12, 14, mask_src=t(src),
                                    mask_dst=t(dst))['loss'])

    def f64_cl(a):
        return None if a is None else cl(a).astype(np.float64)

    with jax.enable_x64(True):
        want = float(jax.jit(jax_loss)(f64_cl(soft), f64_cl(image),
                                       f64_cl(src), f64_cl(dst)))
    assert np.isfinite(want) and want != 0
    # the same function in float64, but for the XY-only kernel, which both
    # compute in f32 (their mesh is f32): one f32 exp rounding apart
    np.testing.assert_allclose(port_loss(torch.float64), want, rtol=1e-7)
    # the port's f32 loss (the difference of two sums over 25 taps)
    np.testing.assert_allclose(port_loss(torch.float32), want, rtol=1e-5)


WSL_CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/scribble_train.csv
valid_csv = {root}/d0_valid.csv
test_csv = {root}/d0_test.csv
train_batch_size = 2
train_transform = [NormalizeWithMeanStd, Pad, RandomCrop, PartialLabelToProbability]
valid_transform = [NormalizeWithMeanStd, Pad, LabelToProbability]
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [8, 16, 16]
RandomCrop_output_size = [8, 16, 16]
RandomCrop_foreground_focus = False

[network]
net_type = UNet2D5
num_domains = 1
class_num = 2
in_chns = 1
feature_chns = [2, 4, 4, 4, 4]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.0, 0.0, 0.0]
bilinear = False

[training]
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-3
weight_decay = 0.0
lr_scheduler = None
iter_max = 2
iter_valid = 2
random_seed = 6
ckpt_save_dir = {root}/model/crf

[testing]
ckpt_mode = 0
output_dir = {root}/result
sliding_window_enable = False
tta_mode = 0

[weakly_supervised_learning]
wsl_method = GatedCRF
regularize_w = 0.1
rampup_start = 0
rampup_end = 2
gatedcrfloss_radius = 2
"""


def test_main_wsl_train_gatedcrf(tmp_path, monkeypatch):
    """``main_wsl(['train', cfg], device='cpu')`` of GatedCRF on scribbles
    (label 2 = unlabelled): the batches carry the scribbles' pixel
    weights, the regulariser is finite and non-zero, the checkpoint and
    the auto test stage's labels are written."""
    from fpl_plus_torch.cli import main_wsl
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
    from tests.test_torch_port_train_units import write_train_domain
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    write_train_domain(root, 0, np.random.RandomState(3))
    rs = np.random.RandomState(8)
    rows = []
    for c in range(3):
        lab = load_image_as_nd_array(os.path.join(
            root, 'd0', 'lab{0}.nii.gz'.format(c)))['data_array'][0]
        scribble = np.where(rs.uniform(size=lab.shape) < 0.1, lab, 2)
        name = 'd0/scribble{0}.nii.gz'.format(c)
        write_nifti(NiftiImage(scribble.astype(np.int16), ImageGeometry()),
                    os.path.join(root, name))
        rows.append('d0/img{0}.nii.gz,{1}\n'.format(c, name))
    with open(os.path.join(root, 'scribble_train.csv'), 'w') as f:
        f.write('image,label\n' + ''.join(rows))
    cfg = os.path.join(root, 'wsl.cfg')
    with open(cfg, 'w') as f:
        f.write(WSL_CLI_CFG.format(root=root))
    seen = []
    real = port_wsl.RegularizedStep.__call__

    def recording(self, batches, draws, regular_w):
        out = real(self, batches, draws, regular_w)
        seen.append((float(batches[0]['pixel_weight'].mean()),
                     float(out['loss_reg'])))
        return out

    monkeypatch.setattr(port_wsl.RegularizedStep, '__call__', recording)
    assert main_wsl(['train', cfg], device='cpu') == 0
    assert len(seen) == 2
    assert all(0.05 < w < 0.15 and np.isfinite(r) and r > 0
               for w, r in seen)
    assert os.path.isfile(os.path.join(root, 'model', 'crf', 'crf_2.pt'))
    lab = load_image_as_nd_array(os.path.join(
        root, 'result', 'crf_d0_test', 'img0.nii.gz'))['data_array']
    assert lab.shape == (1, 12, 24, 24)
