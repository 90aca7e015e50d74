"""PyTorch port, training units against the JAX package: train-mode DSBN,
the losses and the train dice, the train loader stream, and the
checkpoint writer and resume.

Inputs come from numpy seeds. JAX runs eagerly here (small ops, no
train-step compile). Tolerances are stated per test.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpl_plus_torch.engine import ckpt as ckpt_lib
from fpl_plus_torch.engine.optim import (create_lr_schedule, create_optimizer,
                                         set_scheduled_lr)
from fpl_plus_torch.engine.train import train_dice
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.losses import SegLossDict, create_loss_calculator
from fpl_plus_torch.models.dsbn import DomainBatchNorm
from tests.test_torch_port_models import one_torch_thread  # noqa: F401


def _cl(x):
    """channels-first numpy -> channels-last."""
    return np.moveaxis(np.asarray(x), 1, -1)


# -- 1. train-mode DSBN ------------------------------------------------------

@pytest.mark.parametrize('domain', [0, 1])
@pytest.mark.parametrize('shape', [(3, 5, 4, 6, 7), (6, 5, 8, 9)])
def test_dsbn_train_mode_matches_flax(domain, shape):
    """Output (DSBN, then PReLU with slope 0.25) and the updated running
    statistics against the flax ``DomainBatchNorm`` applied with
    ``mutable=['batch_stats']``; the other bank and its counter stay
    unchanged. f32, atol = rtol = 1e-5: one normalisation, with the
    variance summed in another order (flax: E[x^2] - E[x]^2)."""
    from fpl_plus_tpu.models.dsbn import DomainBatchNorm as JaxDSBN
    rs = np.random.RandomState(domain + len(shape))
    c = shape[1]
    x = (rs.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, (2, c)).astype(np.float32)
    bias = rs.normal(size=(2, c)).astype(np.float32)
    mean = rs.normal(size=(2, c)).astype(np.float32)
    var = rs.uniform(0.5, 2.0, (2, c)).astype(np.float32)

    jbn = JaxDSBN(c, 2)
    y_ref, upd = jbn.apply(
        {'params': {'scale': scale, 'bias': bias},
         'batch_stats': {'mean': mean, 'var': var}},
        jnp.asarray(_cl(x)), domain, False, mutable=['batch_stats'])
    y_ref = np.moveaxis(np.asarray(y_ref), -1, 1)
    y_ref = np.where(y_ref >= 0, y_ref, 0.25 * y_ref)

    bn = DomainBatchNorm(c, 2).train()
    with torch.no_grad():
        for d, b in enumerate(bn.bns):
            b.weight.copy_(torch.from_numpy(scale[d]))
            b.bias.copy_(torch.from_numpy(bias[d]))
            b.running_mean.copy_(torch.from_numpy(mean[d]))
            b.running_var.copy_(torch.from_numpy(var[d]))
    y = bn(torch.from_numpy(x), domain, torch.tensor([0.25]))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5,
                               atol=1e-5)
    for key, ref in (('running_mean', upd['batch_stats']['mean']),
                     ('running_var', upd['batch_stats']['var'])):
        got = np.stack([getattr(b, key).numpy() for b in bn.bns])
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    other = 1 - domain
    np.testing.assert_array_equal(bn.bns[other].running_mean.numpy(),
                                  mean[other])
    assert int(bn.bns[domain].num_batches_tracked) == 1
    assert int(bn.bns[other].num_batches_tracked) == 0


# -- 2. losses and the train dice -------------------------------------------

_LOSS_CASES = {
    'dice': ('DiceLoss', ()),
    'dice_pixel_weight': ('DiceLoss', ('pixel_weight',)),
    'dice_weight': ('DiceLoss_weight', ('pixel_weight', 'image_weight')),
    'ce': ('CrossEntropyLoss', ()),
    'ce_pixel_weight': ('CrossEntropyLoss', ('pixel_weight',)),
    'combined': (['DiceLoss', 'CrossEntropyLoss'], ('pixel_weight',)),
    'train_dice': (None, ()),
}


@pytest.mark.parametrize('case', sorted(_LOSS_CASES))
def test_losses_match_jax(case):
    """Each ported loss, with and without weights, and ``train_dice``
    against the JAX functions on the same arrays. f32, rtol 1e-5 (sums of
    ~1500 terms in another order)."""
    from fpl_plus_tpu.engine.train import train_dice as jax_train_dice
    from fpl_plus_tpu.losses import SegLossDict as JaxLossDict
    from fpl_plus_tpu.losses.seg import CombinedLoss as JaxCombined
    name, weights = _LOSS_CASES[case]
    rs = np.random.RandomState(len(case))
    logits = rs.normal(size=(3, 3, 4, 8, 8)).astype(np.float32)
    label = rs.randint(0, 3, size=(3, 4, 8, 8))
    onehot = np.moveaxis(np.eye(3, dtype=np.float32)[label], -1, 1)
    pix_w = (rs.uniform(size=(3, 1, 4, 8, 8)) > 0.3).astype(np.float32) \
        * rs.uniform(0.5, 1.0, (3, 1, 1, 1, 1)).astype(np.float32)
    img_w = rs.uniform(0.1, 1.0, 3).astype(np.float32)
    arrays = {'prediction': logits, 'ground_truth': onehot,
              'pixel_weight': pix_w, 'image_weight': img_w}
    keys = ('prediction', 'ground_truth') + weights

    def jax_in(k):
        a = arrays[k]
        return jnp.asarray(a if k == 'image_weight' else _cl(a))

    if name is None:
        ref = jax_train_dice(jax_in('prediction'), jax_in('ground_truth'))
        got = train_dice(torch.from_numpy(logits), torch.from_numpy(onehot))
    else:
        params = {'loss_type': name, 'loss_weight': [0.7, 0.3]}
        if isinstance(name, list):
            jax_loss = JaxCombined(params, JaxLossDict)
        else:
            jax_loss = JaxLossDict[name](params)
        ref = jax_loss({k: jax_in(k) for k in keys})
        loss = create_loss_calculator({'training': params})
        got = loss({k: torch.from_numpy(arrays[k]) for k in keys})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)


def test_unported_loss_raises_and_names_the_ported():
    """Every loss of the JAX registry is ported: an undefined name, alone
    or in a combined list, raises ``ValueError`` as there."""
    from fpl_plus_tpu.losses import SegLossDict as JaxSegLossDict
    assert sorted(SegLossDict) == sorted(JaxSegLossDict)
    with pytest.raises(ValueError, match='Undefined loss'):
        create_loss_calculator({'training': {'loss_type': 'NoSuchLoss'}})
    with pytest.raises(ValueError, match='NoSuchLoss'):
        create_loss_calculator({'training': {
            'loss_type': ['DiceLoss', 'NoSuchLoss'], 'loss_weight': [1, 1]}})


# -- 5. the train loader stream ---------------------------------------------

TRAIN_PARAMS = {
    'task': 'segmentation',
    'normalizewithmeanstd_channels': [0],
    'pad_output_size': [8, 16, 16],
    'randomcrop_output_size': [8, 16, 16],
    'randomcrop_foreground_focus': True,
    'randomcrop_foreground_ratio': 0.5,
    'randomcrop_mask_label': [1],
    'randomflip_flip_depth': False,
    'randomflip_flip_height': True,
    'randomflip_flip_width': True,
    'labeltoprobability_class_num': 2,
}
CHAIN = ['NormalizeWithMeanStd', 'Pad', 'RandomCrop', 'RandomFlip',
         'LabelToProbability']


def write_train_domain(root, d, rs, n=3, shape=(12, 24, 24)):
    """``n`` noisy volumes with a bright labelled cube at a random place,
    a random pixel-weight map each, and the weighted train manifest
    ``d{d}_train.csv`` (image, label, pixel_weight, image_weight) plus
    ``d{d}_valid.csv`` (image, label) and ``d{d}_test.csv`` (image)."""
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1.0, 1.0, 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    os.makedirs(os.path.join(root, 'd{0}'.format(d)), exist_ok=True)
    rows = []
    for c in range(n):
        vol = rs.normal(0, 1, size=shape).astype(np.float32)
        lab = np.zeros(shape, np.int16)
        z, y, x = (rs.randint(0, s - 6) for s in shape)
        lab[z:z + 4, y:y + 8, x:x + 8] = 1
        vol[lab > 0] += 2.0 + d
        pw = (rs.uniform(size=shape) > 0.2).astype(np.float32)
        names = ['d{0}/{1}{2}.nii.gz'.format(d, k, c)
                 for k in ('img', 'lab', 'pw')]
        for name, arr in zip(names, (vol, lab, pw)):
            write_nifti(NiftiImage(arr, geom), os.path.join(root, name))
        rows.append(names + ['{0:.2f}'.format(0.5 + 0.2 * c)])
    stem = os.path.join(root, 'd{0}_'.format(d))
    with open(stem + 'train.csv', 'w') as f:
        f.write('image,label,pixel_weight,image_weight\n'
                + ''.join(','.join(r) + '\n' for r in rows))
    with open(stem + 'valid.csv', 'w') as f:
        f.write('image,label\n'
                + ''.join(','.join(r[:2]) + '\n' for r in rows[:2]))
    with open(stem + 'test.csv', 'w') as f:
        f.write('image\n' + ''.join(r[0] + '\n' for r in rows))


@pytest.mark.parametrize('cache_bytes', [0, 1 << 26])
def test_train_stream_matches_jax_loader(tmp_path, cache_bytes):
    """The port's shuffled train stream, transforms included, yields the
    same arrays as the JAX package's ``DataLoader.stream`` for one manifest
    and seed over 2 epochs (3 items, batch 2: 3 batches), with and without
    the decoded-volume and transform-prefix caches. Exact: numpy only."""
    from fpl_plus_tpu.io.dataset import NiftyDataset as JaxDataset
    from fpl_plus_tpu.io.loader import DataLoader as JaxLoader
    from fpl_plus_tpu.transforms.trans_dict import TransformDict as JaxTD
    from fpl_plus_tpu.agents.agent_abstract import Compose as JaxCompose
    from fpl_plus_torch.io.dataset import NiftyDataset
    from fpl_plus_torch.io.loader import DataLoader, repeat_loader
    from fpl_plus_torch.transforms.trans_dict import Compose, TransformDict
    root = str(tmp_path)
    write_train_domain(root, 0, np.random.RandomState(3))
    csv_file = os.path.join(root, 'd0_train.csv')
    ref_set = JaxDataset(root, csv_file, with_label=True,
                         transform=JaxCompose([JaxTD[n](TRAIN_PARAMS)
                                               for n in CHAIN]),
                         cache_bytes=cache_bytes)
    got_set = NiftyDataset(root, csv_file, with_label=True,
                           transform=Compose([TransformDict[n](TRAIN_PARAMS)
                                              for n in CHAIN]),
                           cache_bytes=cache_bytes)
    ref = JaxLoader(ref_set, batch_size=2, shuffle=True, seed=12).stream()
    got = repeat_loader(DataLoader(got_set, batch_size=2, shuffle=True,
                                   seed=12))
    for _ in range(3):
        a, b = next(ref), next(got)
        assert a['names'] == b['names']
        for key in ('image', 'label', 'pixel_weight', 'image_weight',
                    'label_prob'):
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)
        assert b['RandomCrop_Param'] == a['RandomCrop_Param']
        assert b['RandomFlip_Param'] == a['RandomFlip_Param']


# -- 6. checkpoints -----------------------------------------------------------

def test_atomic_save_writes_artifact_before_pointer(tmp_path, monkeypatch):
    """``save_checkpoint``: the reference layout, no tmp file left, and the
    latest pointer renamed into place only after the artifact."""
    renames = []
    real_replace = os.replace

    def replace(src, dst):
        renames.append(os.path.basename(dst))
        real_replace(src, dst)

    monkeypatch.setattr(os, 'replace', replace)
    ckpt_dir = str(tmp_path / 'ck')
    state = {'model_state_dict': {'w': torch.arange(3.)},
             'optimizer_state_dict': {'state': {}, 'param_groups': []}}
    name = ckpt_lib.save_checkpoint(ckpt_dir, 'gen', 7, state, 0.5)
    assert renames == ['gen_7.pt', 'gen_latest.txt']
    assert sorted(os.listdir(ckpt_dir)) == ['gen_7.pt', 'gen_latest.txt']
    loaded = ckpt_lib.load_checkpoint(name)
    assert sorted(loaded) == ['iteration', 'model_state_dict',
                              'optimizer_state_dict', 'valid_pred']
    assert loaded['iteration'] == 7 and loaded['valid_pred'] == 0.5
    ckpt_lib.write_best_pointer(ckpt_dir, 'gen', 7)
    cfg = {'training': {'ckpt_save_dir': ckpt_dir, 'ckpt_prefix': 'gen'},
           'testing': {'ckpt_mode': 1}}
    assert ckpt_lib.get_checkpoint_name(cfg) == name


def test_async_writer_snapshots_flushes_and_reraises(tmp_path):
    """``submit`` copies the state at call time (a later in-place update
    does not reach the file); ``flush`` makes it durable; a worker error is
    re-raised by the next ``flush``."""
    ckpt_dir = str(tmp_path / 'ck')
    w = torch.zeros(4)
    writer = ckpt_lib.CheckpointWriter()
    writer.submit(ckpt_dir, 'gen', 2, {'model_state_dict': {'w': w}}, 0.1)
    w.add_(1.0)
    writer.flush()
    saved = ckpt_lib.load_checkpoint(os.path.join(ckpt_dir, 'gen_2.pt'))
    assert torch.equal(saved['model_state_dict']['w'], torch.zeros(4))
    with open(os.path.join(ckpt_dir, 'gen_latest.txt')) as f:
        assert f.read() == '2'
    blocked = str(tmp_path / 'a_file')
    with open(blocked, 'w') as f:
        f.write('x')
    writer.submit(blocked, 'gen', 4, {'model_state_dict': {'w': w}}, 0.1)
    with pytest.raises(OSError):
        writer.flush()
    writer.close()


def test_resume_restores_optimizer_state_and_schedule(tmp_path):
    """A step from an optimizer restored from a written checkpoint equals
    the step of the optimizer that kept running (Adam moments and the
    MultiStepLR position), exactly."""
    cfg = {'optimizer': 'Adam', 'learning_rate': 1e-2, 'weight_decay': 1e-4,
           'lr_scheduler': 'MultiStepLR', 'lr_gamma': 0.5,
           'lr_milestones': [2, 3]}
    schedule = create_lr_schedule(cfg)
    torch.manual_seed(0)
    net = torch.nn.Linear(4, 3)
    x = torch.randn(8, 4)

    def step(model, opt):
        opt.zero_grad()
        model(x).square().mean().backward()
        set_scheduled_lr(opt, schedule)
        opt.step()
        opt.param_groups[0]['update_count'] += 1

    opt = create_optimizer(cfg, net.parameters())
    for _ in range(2):
        step(net, opt)
    ckpt_lib.save_checkpoint(str(tmp_path), 'gen', 2, {
        'model_state_dict': net.state_dict(),
        'optimizer_state_dict': opt.state_dict()}, 0.0)
    loaded = ckpt_lib.load_checkpoint(str(tmp_path / 'gen_2.pt'))
    net2 = torch.nn.Linear(4, 3)
    net2.load_state_dict(loaded['model_state_dict'])
    opt2 = create_optimizer(cfg, net2.parameters())
    opt2.load_state_dict(loaded['optimizer_state_dict'])
    assert opt2.param_groups[0]['update_count'] == 2
    step(net, opt)
    step(net2, opt2)
    assert opt.param_groups[0]['lr'] == opt2.param_groups[0]['lr'] == 5e-3
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_multistep_schedule_matches_optax():
    """MultiStepLR over update counts, fresh and with a resume offset,
    against the JAX package's optax schedule (exact); LBFGS builds, with
    the update count the schedule reads."""
    from fpl_plus_tpu.engine.optim import create_lr_schedule as jax_schedule
    for last_iter in (-1, 0, 3):
        cfg = {'lr_scheduler': 'MultiStepLR', 'learning_rate': 0.1,
               'lr_gamma': 0.5, 'lr_milestones': [2, 5],
               'last_iter': last_iter}
        ref, got = jax_schedule(cfg), create_lr_schedule(cfg)
        assert [got(k) for k in range(8)] == pytest.approx(
            [float(ref(k)) for k in range(8)], rel=1e-7)
    assert create_lr_schedule({'lr_scheduler': 'ReduceLROnPlateau'}) is None
    lbfgs = create_optimizer({'optimizer': 'LBFGS', 'learning_rate': 1.0},
                             torch.nn.Linear(2, 2).parameters())
    assert lbfgs.param_groups[0]['update_count'] == 0


def test_manifest_weights_compose(tmp_path):
    """``pixel_weight`` < 1 is zeroed and the rest scaled by the row's
    ``image_weight``; an image_weight-only manifest gives constant maps."""
    from fpl_plus_torch.io.dataset import NiftyDataset
    root = str(tmp_path)
    write_train_domain(root, 1, np.random.RandomState(4), n=2)
    ds = NiftyDataset(root, os.path.join(root, 'd1_train.csv'),
                      with_label=True)
    item = ds[1]
    raw = ds._load_array(1, 2, np.float32)
    np.testing.assert_array_equal(item['pixel_weight'],
                                  np.where(raw < 1, 0, raw) * np.float32(0.7))
    assert item['label'].dtype == np.int32 and item['image_weight'] == \
        np.float32(0.7)
    with open(os.path.join(root, 'w.csv'), 'w') as f:
        f.write('image,label,image_weight\nd1/img0.nii.gz,d1/lab0.nii.gz,'
                '0.25\n')
    item = NiftyDataset(root, os.path.join(root, 'w.csv'), with_label=True)[0]
    assert np.all(item["pixel_weight"] == np.float32(0.25))
    assert json.dumps(item['names']) == '"d1/img0.nii.gz"'


def test_plain_kernel_path_keeps_gradients_on_cpu():
    """The grad refusal is for the card only: on the CPU the plain version
    runs under autograd and the affine terms and the slope get gradients
    (the card's refusal is checked by chip_smoke.py)."""
    from fpl_plus_torch.ops.dsbn_prelu import dsbn_prelu
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.normal(size=(2, 3, 4, 5)).astype(np.float32))
    tables = [torch.from_numpy(rs.uniform(0.5, 1.5, (2, 3)).astype(
        np.float32)).requires_grad_() for _ in range(4)]
    alpha = torch.tensor([0.25], requires_grad=True)
    dsbn_prelu(x, *tables, 1, alpha).sum().backward()
    assert float(tables[0].grad[1].abs().sum()) > 0
    assert float(tables[0].grad[0].abs().sum()) == 0
    assert alpha.grad is not None
