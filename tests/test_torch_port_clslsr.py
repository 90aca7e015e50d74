"""PyTorch port, the CLSLSR confidence maps and ``make_noise``
against the JAX package's.

* Confident learning: the 7 ``cl_type`` s and the 3 prune methods on 3
  seeds (4000 voxels, 3 classes, logits biased to the labels), and the
  hand example of ``tests/test_clslsr.py``: bit-equal masks.
* The CE-quantile fallback: equal flags.
* ``make_noise``: the same boxes, jigsaw copies and corrupted volumes from
  one seed, and its CLI's output volumes.
* End to end: ``python -m fpl_plus_torch.cli nll_clslsr`` on three 6x14x14
  NIfTI volumes whose {0, 255} labels reach the confident joint through
  ``LabelConvertNonzero``, padded to the [8,16,16] window and cropped back,
  against the JAX package's ``run_get_confidence_map`` on one set of random
  UNet2D5 weights (the JAX agent's eager network init stubbed, its window
  scanned): the same ``slsr_conf/`` maps voxel for voxel, the same manifest
  rows. The predictions agree to ~1e-6; the maps are equal because no
  pruning boundary falls within that of a tie. Then the port's error paths
  (a label beyond ``class_num`` without the conversion, a basename
  collision) and an ``SLSRLoss`` retrain on the written manifest.
"""
import csv
import os
import shutil
import sys

import numpy as np
import pytest
import scipy.special
import torch

from fpl_plus_torch.agents import nll_clslsr as port_cl
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.io.nifti import ImageGeometry, NiftiImage, write_nifti
from fpl_plus_torch.utils import make_noise as port_noise
from tests.test_torch_port_models import one_torch_thread  # noqa: F401

CL_TYPES = ('both', 'Qij', 'Cij', 'intersection', 'union', 'prune_by_class',
            'prune_by_noise_rate')
PRUNE = ('prune_by_class', 'prune_by_noise_rate', 'both')
SEEDS = (0, 1, 2)


def cl_inputs(seed, n=4000, k=3):
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, k, size=n)
    logits = rs.normal(size=(n, k)).astype(np.float32)
    logits[np.arange(n), gt] += 1.5
    flip = rs.uniform(size=n) < 0.1           # some labels made wrong
    gt = np.where(flip, (gt + 1) % k, gt)
    return gt, logits


def test_confident_joint_hand_example():
    labels = np.array([0, 0, 0, 1, 1, 1])
    probs = np.array([[0.9, 0.1], [0.8, 0.2], [0.4, 0.6],
                      [0.2, 0.8], [0.3, 0.7], [0.7, 0.3]])
    cj = port_cl.compute_confident_joint(labels, probs)
    np.testing.assert_array_equal(cj, [[2, 1], [1, 2]])
    np.testing.assert_array_equal(
        port_cl.calibrate_confident_joint(cj, labels), cj)
    for method in PRUNE:
        np.testing.assert_array_equal(
            port_cl.get_noise_mask(labels, probs, method),
            [False, False, True, False, False, True])


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('cl_type', CL_TYPES)
def test_confident_map_matches_jax(cl_type, seed):
    from fpl_plus_tpu.agents.nll_clslsr import get_confident_map
    gt, logits = cl_inputs(seed)
    want = get_confident_map(gt, logits, cl_type)
    got = port_cl.get_confident_map(gt, logits, cl_type)
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('prune', PRUNE)
def test_noise_mask_matches_jax(prune, seed):
    """The prune rules on float32 probabilities (the inference path's
    dtype) and on float64 ones, and the calibrated joint."""
    from fpl_plus_tpu.agents import nll_clslsr as jax_cl
    gt, logits = cl_inputs(seed)
    probs = scipy.special.softmax(logits, axis=1).astype(np.float32)
    for p in (probs, probs.astype(np.float64)):
        np.testing.assert_array_equal(port_cl.get_noise_mask(gt, p, prune),
                                      jax_cl.get_noise_mask(gt, p, prune))
    np.testing.assert_array_equal(
        port_cl.calibrate_confident_joint(
            port_cl.compute_confident_joint(gt, probs), gt),
        jax_cl.calibrate_confident_joint(
            jax_cl.compute_confident_joint(gt, probs), gt))
    with pytest.raises(ValueError):
        port_cl.get_noise_mask(gt, probs, 'bogus')


@pytest.mark.parametrize('ratio', [0.3, 0.05])
def test_quantile_map_matches_jax(ratio):
    """The CE-quantile fallback (``agents/nll.py``'s ``get_confident_map``)
    on channels-last inputs."""
    from fpl_plus_tpu.agents.nll import get_confident_map as jax_quantile
    from fpl_plus_torch.agents.nll import get_confident_map
    rs = np.random.RandomState(4)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (2, 9, 11))]
    logits = rs.normal(size=(2, 9, 11, 3)).astype(np.float32)
    want = np.asarray(jax_quantile(y, logits, ratio))
    got = get_confident_map(y, logits, ratio)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - ratio) < 0.02


def test_make_noise_matches_jax(tmp_path):
    """The same seed gives the same masks and corrupted labels, through
    the functions and the CLI."""
    from fpl_plus_tpu.utils import make_noise as jax_noise
    rs = np.random.RandomState(7)
    onehot2 = np.eye(2)[rs.randint(0, 2, (2, 20, 20))]
    onehot3 = np.eye(2)[rs.randint(0, 2, (1, 12, 20, 20))]
    for mask_type in ('squares_jigsaw', 'squares_zeros'):
        for fixed in (True, False):
            a = jax_noise.make_noise_masks_2d(
                onehot2.shape, mask_type, (3, 4), fixed, not fixed, 2,
                onehot2, np.random.RandomState(1))
            b = port_noise.make_noise_masks_2d(
                onehot2.shape, mask_type, (3, 4), fixed, not fixed, 2,
                onehot2, np.random.RandomState(1))
            np.testing.assert_array_equal(a, b)
            a = jax_noise.make_noise_masks_3d(
                onehot3.shape, mask_type, (2, 3), 2, onehot3, fixed,
                not fixed, np.random.RandomState(2))
            b = port_noise.make_noise_masks_3d(
                onehot3.shape, mask_type, (2, 3), 2, onehot3, fixed,
                not fixed, np.random.RandomState(2))
            np.testing.assert_array_equal(a, b)
    lab = np.zeros((12, 40, 40), np.int16)
    lab[3:10, 8:30, 10:32] = 1
    for roi in ('entire', 'box'):
        np.testing.assert_array_equal(
            port_noise.make_roi_mask(lab, roi, 2),
            jax_noise.make_roi_mask(lab, roi, 2))
    np.testing.assert_array_equal(
        port_noise.corrupt_label_boundary(lab, (4, 8, 8), 5,
                                          np.random.RandomState(3)),
        jax_noise.corrupt_label_boundary(lab, (4, 8, 8), 5,
                                         np.random.RandomState(3)))
    src = tmp_path / 'labels'
    os.makedirs(src)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1., 1., 2.),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    for c in range(3):
        shifted = np.roll(lab, 3 * c, axis=2)
        write_nifti(NiftiImage(shifted, geom),
                    str(src / 'case{0}.nii.gz'.format(c)))
    args = ['--patch-size', '4', '8', '8', '--patch-num', '5', '--seed',
            '11']
    assert jax_noise.main([str(src), str(tmp_path / 'jax')] + args) == 0
    assert port_noise.main([str(src), str(tmp_path / 'port')] + args) == 0
    changed = 0
    for c in range(3):
        name = 'case{0}.nii.gz'.format(c)
        want = load_image_as_nd_array(str(tmp_path / 'jax' / name))
        got = load_image_as_nd_array(str(tmp_path / 'port' / name))
        np.testing.assert_array_equal(got['data_array'], want['data_array'])
        assert got['spacing'] == want['spacing']
        changed += int((got['data_array'][0] != np.roll(lab, 3 * c, 2)
                        ).sum())
    assert changed > 0


NET = {'net_type': 'UNet2D5', 'num_domains': 1, 'class_num': 2,
       'in_chns': 1, 'feature_chns': [4, 8, 8, 8, 8],
       'conv_dims': [2, 2, 3, 3, 3], 'dropout': [0.0, 0.0, 0.2, 0.2, 0.2],
       'bilinear': False}

CL_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/{train_csv}
valid_csv = {root}/train.csv
test_csv = {root}/train.csv
train_batch_size = 2
train_transform = [NormalizeWithMeanStd, {conv}Pad, RandomCrop, LabelToProbability]
valid_transform = [NormalizeWithMeanStd, {conv}Pad, LabelToProbability]
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
feature_chns = [4, 8, 8, 8, 8]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.2, 0.2, 0.2]
bilinear = False

[training]
loss_type = {loss}
{loss_extra}
optimizer = Adam
learning_rate = 1e-3
weight_decay = 0.0
iter_max = 2
iter_valid = 2
iter_save = 2
random_seed = 3
ckpt_save_dir = {root}/model/{run}

[testing]
ckpt_mode = 0
domian_label = 0
output_dir = {root}/results
sliding_window_enable = True
sliding_window_size = [8, 16, 16]
sliding_window_stride = [8, 16, 16]
tta_mode = 1
cl_type = both
infer_unroll_max = 0
"""


def cl_cfg(root, name, conv='LabelConvertNonzero, ', train_csv='train.csv',
           loss='DiceLoss', loss_extra='', run='gen'):
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(CL_CFG.format(root=root, conv=conv, train_csv=train_csv,
                              loss=loss, loss_extra=loss_extra, run=run))
    return path


@pytest.fixture(scope='module')
def cl_workspace(tmp_path_factory):
    """Three 6x14x14 volumes, a bright block each, {0, 255} labels with a
    wrong corner; random UNet2D5 weights as a JAX msgpack checkpoint and a
    ``.pt``, both ``gen_2``; a second copy of the tree for the port."""
    import jax
    from fpl_plus_tpu.engine import ckpt as jax_ckpt
    from fpl_plus_torch.utils.convert import state_dict_from_jax
    from tests.test_torch_port_train_step import tiny_variables
    root = str(tmp_path_factory.mktemp('clslsr_jax'))
    rs = np.random.RandomState(11)
    geom = ImageGeometry(origin=(0., 0., 0.), spacing=(1., 1., 1.5),
                         direction=(1, 0, 0, 0, 1, 0, 0, 0, 1))
    os.makedirs(os.path.join(root, 'img'))
    os.makedirs(os.path.join(root, 'lab'))
    rows = []
    for c in range(3):
        vol = rs.normal(0, 1, size=(6, 14, 14)).astype(np.float32)
        lab = np.zeros((6, 14, 14), np.int16)
        lab[1:5, 3:10, 4:11] = 255
        vol[lab > 0] += 1.5
        lab[0:2, 0:4, 0:4] = 255                 # label noise
        names = ['img/case{0}.nii.gz'.format(c),
                 'lab/case{0}.nii.gz'.format(c)]
        write_nifti(NiftiImage(vol, geom), os.path.join(root, names[0]))
        write_nifti(NiftiImage(lab, geom), os.path.join(root, names[1]))
        rows.append(','.join(names))
    with open(os.path.join(root, 'train.csv'), 'w') as f:
        f.write('image,label\n' + '\n'.join(rows) + '\n')
    params, stats = tiny_variables(41, NET)
    params = jax.tree_util.tree_map(np.asarray, params)
    ckpt_dir = os.path.join(root, 'model', 'gen')
    jax_ckpt.save_checkpoint(ckpt_dir, 'gen', 2, {
        'params': params, 'batch_stats': stats, 'opt_state': ()}, 0.0)
    torch.save({'iteration': 2, 'valid_pred': 0.0,
                'model_state_dict': state_dict_from_jax(params, stats, NET)},
               os.path.join(ckpt_dir, 'gen_2.pt'))
    port_root = root + '_port'
    shutil.copytree(root, port_root)
    return {'jax': root, 'port': port_root, 'template': (params, stats)}


def read_rows(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_clslsr_matches_jax_run(cl_workspace, monkeypatch):
    from fpl_plus_tpu.agents.nll_clslsr import run_get_confidence_map
    from fpl_plus_tpu.config.parser import parse_config as jax_parse
    from fpl_plus_tpu.config.parser import synchronize_config as jax_sync
    from fpl_plus_torch.cli import main_nll_clslsr
    template = cl_workspace['template']
    monkeypatch.setattr('fpl_plus_tpu.agents.agent_seg.init_network',
                        lambda module, cfg, seed=0: template)
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    jax_root, root = cl_workspace['jax'], cl_workspace['port']
    want_csv = run_get_confidence_map(jax_sync(jax_parse(
        cl_cfg(jax_root, 'cl.cfg'))))
    assert main_nll_clslsr(['test', cl_cfg(root, 'cl.cfg')],
                           device='cpu') == 0
    got_csv = os.path.join(root, 'train_clslsr.csv')
    assert os.path.basename(want_csv) == 'train_clslsr.csv'
    assert read_rows(got_csv) == read_rows(want_csv)
    assert read_rows(got_csv)[0] == ['image', 'pixel_weight', 'label']
    flagged = 0
    for c in range(3):
        name = os.path.join('slsr_conf', 'case{0}.nii.gz'.format(c))
        want = load_image_as_nd_array(os.path.join(jax_root, name))
        got = load_image_as_nd_array(os.path.join(root, name))
        assert got['data_array'].shape == (1, 6, 14, 14)
        assert got['data_array'].dtype == np.uint8
        assert set(np.unique(got['data_array'])) <= {0, 255}
        np.testing.assert_array_equal(got['data_array'], want['data_array'])
        assert got['spacing'] == want['spacing']
        flagged += int((got['data_array'] > 0).sum())
    assert flagged > 0


def test_clslsr_error_paths(cl_workspace, monkeypatch):
    """Without the label conversion a 255 label is beyond ``class_num``;
    two labels that share a basename would share a map: both raise, as
    does a run without a card that does not ask for the CPU."""
    from fpl_plus_torch.cli import main_nll_clslsr
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = cl_workspace['port']
    with pytest.raises(ValueError, match='LabelConvert'):
        main_nll_clslsr([cl_cfg(root, 'raw.cfg', conv='')], device='cpu')
    with open(os.path.join(root, 'clash.csv'), 'w') as f:
        f.write('image,label\nimg/case0.nii.gz,lab/case0.nii.gz\n'
                'img/case1.nii.gz,lab2/case0.nii.gz\n')
    with pytest.raises(ValueError, match='collision'):
        main_nll_clslsr([cl_cfg(root, 'clash.cfg', train_csv='clash.csv')],
                        device='cpu')
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main_nll_clslsr([cl_cfg(root, 'cl2.cfg')])


def test_slsr_retrain_consumes_manifest(cl_workspace, monkeypatch):
    """The written manifest feeds a 2-iteration ``cli train`` with
    ``SLSRLoss``: its ``pixel_weight`` maps reach the loss."""
    from fpl_plus_torch.cli import main, main_nll_clslsr
    from fpl_plus_torch.losses.seg import SLSRLoss
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = cl_workspace['port']
    if not os.path.isfile(os.path.join(root, 'train_clslsr.csv')):
        assert main_nll_clslsr([cl_cfg(root, 'cl.cfg')], device='cpu') == 0
    seen = []
    real = SLSRLoss.__call__

    def recording(self, loss_input):
        if 'pixel_weight' in loss_input:
            seen.append(float(loss_input['pixel_weight'].sum()))
        return real(self, loss_input)

    monkeypatch.setattr(SLSRLoss, '__call__', recording)
    cfg = cl_cfg(root, 'slsr.cfg', train_csv='train_clslsr.csv',
                 loss='SLSRLoss',
                 loss_extra='train_fpl_uda = True\nslsrloss_epsilon = 0.25',
                 run='slsr')
    assert main(['train', cfg], device='cpu') == 0
    assert len(seen) >= 2 and all(np.isfinite(seen))
    assert os.path.isfile(os.path.join(root, 'model', 'slsr', 'slsr_2.pt'))
