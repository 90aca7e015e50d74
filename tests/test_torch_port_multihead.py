"""PyTorch port, multi-head inference and the supervised CLI path.

* The ``Inferer`` with a ``UNet2D_URPC`` predictor (4 heads at scales 1,
  1/2, 1/4, 1/8 of H and W; a 2.5D window, whose depth no head scales)
  against JAX's ``Inferer.run`` on the same weights, under both
  ``multiscale_counter`` modes. The 5x40x44 volume with window 3x16x16 and
  stride 2x12x12 overlaps windows in every axis, where the two modes differ.
  Tolerance: f32, atol = rtol = 1e-4 (two convolution libraries).
* One ``fpl_plus_torch.cli`` train run on the CPU of a single-domain
  deep-supervised ``UNet2D`` with the new transforms in its training chain
  (2 iterations, validation with the deep-supervision loss over all heads),
  then the auto test stage and the evaluation.
"""
import csv
import os
import sys

import numpy as np
import pytest
import torch

from fpl_plus_torch.engine.infer import Inferer
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_zoo import random_variables

URPC = {'net_type': 'UNet2D_URPC', 'in_chns': 1, 'class_num': 2,
        'feature_chns': [4, 8, 8, 16], 'dropout': [0.0, 0.0, 0.3, 0.4]}
# JAX compile knobs: scan-carried accumulation (one small program) and no
# shape bucketing. Bucketing un-flips a head on the padded grid; at 44
# wide the 1/8 head (5.5 voxels) then lands one voxel off its unbucketed
# place, where the port's result is (ROADMAP.md, section 3)
SW = {'sliding_window_enable': True, 'sliding_window_size': [3, 16, 16],
      'sliding_window_stride': [2, 12, 12], 'tta_mode': 1,
      'infer_unroll_max': 0, 'infer_shape_bucket': 0}


class _JaxPredictor:
    def __init__(self, module):
        self.module = module

    def __call__(self, ctx, x):
        return self.module.apply(ctx, x, 0, False)


@pytest.fixture(scope='module')
def urpc():
    from fpl_plus_tpu.models.registry import create_network as jax_create
    from fpl_plus_torch.models.registry import create_network
    from fpl_plus_torch.utils.convert import state_dict_from_flax
    module = jax_create(URPC)
    params, stats = random_variables(module, np.zeros((1, 3, 16, 16, 1),
                                                      np.float32), seed=6)
    net = create_network(URPC)
    net.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return module, {'params': params, 'batch_stats': stats}, net.eval()


@pytest.mark.parametrize('mode', ['exact', 'reference'])
def test_multiscale_inferer_matches_jax(urpc, mode):
    from fpl_plus_tpu.engine.infer import Inferer as JaxInferer
    module, variables, net = urpc
    image = np.random.RandomState(2).normal(
        size=(1, 1, 5, 40, 44)).astype(np.float32)
    cfg = dict(SW, output_mode='logits', multiscale_counter=mode)
    ref = JaxInferer(cfg).run(_JaxPredictor(module), variables, image)
    got = Inferer(cfg, 'cpu').run(lambda x: net(x), image)
    assert [g.shape for g in got] == [r.shape for r in ref] == [
        (1, 2, 5, 40, 44), (1, 2, 5, 20, 22), (1, 2, 5, 10, 11),
        (1, 2, 5, 5, 5)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-4)
    if mode == 'reference':
        exact = Inferer(dict(cfg, multiscale_counter='exact'), 'cpu').run(
            lambda x: net(x), image)
        # the reference counter scales every head by 1/n_heads and
        # misplaces the coarse heads' coverage near scaled-box edges
        np.testing.assert_allclose(got[0] * 4, exact[0], rtol=1e-5)
        assert not np.allclose(got[3] * 4, exact[3], rtol=1e-3)
        return
    labels = Inferer(dict(cfg, output_mode='label'), 'cpu').run_batch(
        lambda x: net(x), np.concatenate([image, image]))
    assert len(labels) == 4 and labels[1].shape == (2, 5, 20, 22)
    for lab, g in zip(labels, got):
        np.testing.assert_array_equal(lab[1], np.argmax(g[0], 0))
    with pytest.raises(ValueError, match='multiscale_counter'):
        Inferer(dict(cfg, multiscale_counter='nearest'), 'cpu')


CLI_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
train_csv = {root}/d0_train.csv
valid_csv = {root}/d0_valid.csv
test_csv = {root}/d0_test.csv
train_batch_size = 2
train_transform = [NormalizeWithPercentiles, RandomRescale, RandomRotate, GammaCorrection, GaussianNoise, Pad, RandomCrop, RandomFlip, LabelToProbability]
valid_transform = [NormalizeWithPercentiles, Pad, LabelToProbability]
test_transform = [NormalizeWithPercentiles, Pad]
NormalizeWithPercentiles_channels = [0]
NormalizeWithPercentiles_percentile_lower = 0.5
NormalizeWithPercentiles_percentile_upper = 99.5
RandomRescale_lower_bound = [1.0, 0.9, 0.9]
RandomRescale_upper_bound = [1.0, 1.1, 1.1]
RandomRotate_angle_range_d = [-15, 15]
RandomRotate_angle_range_h = None
RandomRotate_angle_range_w = None
GammaCorrection_channels = [0]
GammaCorrection_gamma_min = 0.8
GammaCorrection_gamma_max = 1.25
GammaCorrection_probability = 0.5
GaussianNoise_channels = [0]
GaussianNoise_mean = 0.0
GaussianNoise_std = 0.05
GaussianNoise_probability = 0.5
Pad_output_size = [4, 16, 16]
RandomCrop_output_size = [4, 16, 16]
RandomFlip_flip_depth = False
RandomFlip_flip_height = True
RandomFlip_flip_width = True

[network]
net_type = UNet2D
class_num = 2
in_chns = 1
feature_chns = [4, 8, 8, 16]
dropout = [0.0, 0.0, 0.3, 0.4]
deep_supervise = True
deep_supervise_weight = [1.0, 0.5, 0.25]

[training]
loss_type = DiceLoss
optimizer = Adam
learning_rate = 1e-3
momentum = 0.9
weight_decay = 0.0
lr_scheduler = MultiStepLR
lr_gamma = 0.5
lr_milestones = [1]
iter_max = 2
iter_valid = 2
random_seed = 4
ckpt_save_dir = {root}/model/sup

[testing]
ckpt_mode = 0
output_dir = {root}/result
sliding_window_enable = True
sliding_window_size = [4, 16, 16]
sliding_window_stride = [4, 12, 12]
tta_mode = 1

[evaluation]
metric_1 = dice
label_list = [1]
organ_name = cube
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/pairs.csv
"""


def test_supervised_cli_train_test_evaluate(tmp_path, monkeypatch):
    """``main(['train', cfg], device='cpu')``: 2 iterations of the
    single-domain (alternating, entropy term) step on the 3-head output,
    a checkpoint, the auto test stage's labels in the volumes' geometry and
    the dice CSV of the evaluation."""
    from fpl_plus_torch.cli import main as torch_main
    from fpl_plus_torch.engine import train as torch_train
    from fpl_plus_torch.io.image_io import load_image_as_nd_array
    from tests.test_torch_port_train_units import write_train_domain
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    root = str(tmp_path)
    write_train_domain(root, 0, np.random.RandomState(3))
    with open(os.path.join(root, 'pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(
            'd0/lab{0}.nii.gz,img{0}.nii.gz\n'.format(c) for c in range(3)))
    cfg = os.path.join(root, 'sup.cfg')
    with open(cfg, 'w') as f:
        f.write(CLI_CFG.format(root=root))
    seen = []
    real = torch_train.AlternatingTrainStep.__call__

    def recording(self, batches, generators):
        out = real(self, batches, generators)
        seen.append((len(generators), float(out['loss'])))
        return out

    monkeypatch.setattr(torch_train.AlternatingTrainStep, '__call__',
                        recording)
    assert torch_main(['train', cfg], device='cpu') == 0
    assert len(seen) == 2 and all(np.isfinite(v) for _, v in seen)
    saved = torch.load(os.path.join(root, 'model', 'sup', 'sup_2.pt'),
                       weights_only=False)
    assert 'decoder.out_conv2.weight' in saved['model_state_dict']
    out = os.path.join(root, 'result', 'sup_d0_test')
    for c in range(3):
        lab = load_image_as_nd_array(os.path.join(
            out, 'img{0}.nii.gz'.format(c)))['data_array']
        assert lab.shape == (1, 12, 24, 24) and lab.dtype == np.uint8
    with open(os.path.join(out, 'test_cube_dice_all.csv')) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ['image', 'class_1'] and len(rows) == 3 + 3
    assert all(0.0 <= float(r[1]) <= 1.0 for r in rows[1:])
