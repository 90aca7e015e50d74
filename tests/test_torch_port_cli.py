"""PyTorch port, CLI: the test stage of ``fpl_plus_torch.cli`` against the
JAX CLI's on one set of weights.

A seeded tiny workspace (the dry run's, ``fpl_plus_torch.dryrun.
write_workspace``, with three cases: noisy volumes with a bright cube; the
target domain's images are the test set) is labelled twice:
by the JAX CLI from a msgpack checkpoint and by the port's CLI on the CPU
from the same weights saved through the bridge as a reference-layout ``.pt``
checkpoint. Both resolve the checkpoint through the shared
``<prefix>_latest.txt`` pointer. The Pad transform adds real margins, so the
inverse crop runs. Tolerance: at least 99.9% of voxels agree (expected:
identical; a label can flip only where two logits tie to ~1e-5).
The workspace serves the host-path tests too
(``test_torch_port_host_inverse.py``, ``test_torch_port_ensemble.py``).
"""
import os

import numpy as np
import pytest
import torch

from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.dryrun import write_workspace
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.utils.convert import state_dict_from_jax
from fpl_plus_torch.models.registry import create_network as torch_network
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                         jax_init, one_torch_thread,
                                         randomize_stats)

CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
test_csv = {root}/d1_test_img.csv
test_batch_size = {batch}
test_transform = [NormalizeWithMeanStd, Pad]
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [16, 32, 32]

[network]
net_type = UNet2D5_dsbn
num_domains = 2
class_num = 2
in_chns = 1
feature_chns = [4, 8, 16, 16, 32]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False
pallas_fused = True

[training]
ckpt_save_dir = {root}/model/gen

[testing]
ckpt_mode = 0
domian_label = 1
output_dir = {root}/{out}
sliding_window_enable = True
sliding_window_size = [8, 16, 16]
sliding_window_stride = [6, 12, 12]
tta_mode = 1
infer_unroll_max = 0
{extra}
"""


def _write_workspace(root):
    """The dry run's workspace with three cases of 12x24x24, its target
    images (a bright cube in noise) listed in ``d1_test_img.csv``; returns
    the first, z-scored and reflect-padded as the test chain feeds it to
    the net."""
    write_workspace(root, cases=3)
    rows = ['d1/img/case{0}.nii.gz'.format(case) for case in range(3)]
    with open(os.path.join(root, 'd1_test_img.csv'), 'w') as f:
        f.write('image\n' + '\n'.join(rows) + '\n')
    vol = load_image_as_nd_array(os.path.join(root, rows[0]))[
        'data_array'][0]
    z = (vol - vol.mean()) / vol.std()
    return np.pad(z, ((2, 2), (4, 4), (4, 4)), 'reflect')[None, None]


def _cfg(root, name, out, batch=1, extra=''):
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(CFG.format(root=root, out=out, batch=batch, extra=extra))
    return path


def _labels(root, out):
    d = os.path.join(root, out, 'gen_d1_test_img')
    return {n: load_image_as_nd_array(os.path.join(d, n))['data_array']
            for n in sorted(os.listdir(d)) if n.endswith('.nii.gz')}


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    import jax
    from fpl_plus_tpu.engine import ckpt as jax_ckpt
    from fpl_plus_tpu.models.registry import create_network
    root = str(tmp_path_factory.mktemp('torch_port_cli'))
    probe = _write_workspace(root)
    params, stats = jax_init(create_network(SMALL), seed=7)
    params = jax.tree_util.tree_map(np.asarray, params)
    stats = randomize_stats(stats, seed=7)
    net = torch_network(SMALL).eval()
    net.load_state_dict(state_dict_from_jax(params, stats, SMALL))
    center_head(params, net, probe.astype(np.float32))
    ckpt_dir = os.path.join(root, 'model', 'gen')
    jax_ckpt.save_checkpoint(ckpt_dir, 'gen', 5,
                             {'params': params, 'batch_stats': stats,
                              'opt_state': ()}, 0.0)
    torch.save({'iteration': 5, 'valid_pred': 0.0,
                'model_state_dict': state_dict_from_jax(params, stats,
                                                        SMALL)},
               os.path.join(ckpt_dir, 'gen_5.pt'))
    return root


def test_port_labels_match_jax_cli(workspace):
    from fpl_plus_tpu.cli import main as jax_main
    root = workspace
    assert jax_main(['test', _cfg(root, 'jax.cfg', 'out_jax')]) == 0
    assert torch_main(['test', _cfg(root, 'torch.cfg', 'out_torch'),
                       '--device', 'cpu']) == 0
    ref, got = _labels(root, 'out_jax'), _labels(root, 'out_torch')
    assert list(got) == list(ref) == ['case0.nii.gz', 'case1.nii.gz',
                                      'case2.nii.gz']
    for name in ref:
        assert got[name].shape == ref[name].shape == (1, 12, 24, 24)
        assert got[name].dtype == np.uint8
        assert 0.05 < ref[name].mean() < 0.95, name   # both classes
        assert np.mean(got[name] == ref[name]) >= 0.999, name


def test_port_batched_and_bf16_stages(workspace):
    """test_batch_size > 1 runs each loader batch as one batched sliding
    window (the same labels as batch 1); bf16 serving writes binary labels
    that mostly agree with f32."""
    root = workspace
    if not os.path.isdir(os.path.join(root, 'out_torch')):
        assert torch_main(['test', _cfg(root, 'torch.cfg', 'out_torch')],
                          device='cpu') == 0
    assert torch_main(['inference', _cfg(root, 'b2.cfg', 'out_b2', batch=2)],
                      device='cpu') == 0
    assert torch_main(['test', _cfg(root, 'bf16.cfg', 'out_bf16',
                                    extra='precision = bfloat16')],
                      device='cpu') == 0
    f32 = _labels(root, 'out_torch')
    for name, lab in _labels(root, 'out_b2').items():
        np.testing.assert_array_equal(lab, f32[name])
    for name, lab in _labels(root, 'out_bf16').items():
        assert set(np.unique(lab)) <= {0, 1}
        assert np.mean(lab == f32[name]) > 0.95, name


def test_cli_refuses_what_is_not_ported(workspace):
    """A checkpoint list needs ``ckpt_mode = 3`` and mode 3 needs a list
    (``ValueError``, as the JAX agent); without a card and without
    ``device='cpu'`` the CLI raises."""
    cfg = _cfg(workspace, 'torch.cfg', 'out_torch')
    ckpt = os.path.join(workspace, 'model', 'gen', 'gen_5.pt')
    for mode, name in ((3, ckpt), (2, [ckpt, ckpt])):
        bad = _cfg(workspace, 'bad.cfg', 'out_bad', extra='ckpt_name = ' + (
            '[{0}, {0}]'.format(ckpt) if isinstance(name, list) else ckpt))
        with open(bad) as f:
            text = f.read().replace('ckpt_mode = 0',
                                    'ckpt_mode = {0}'.format(mode))
        with open(bad, 'w') as f:
            f.write(text)
        with pytest.raises(ValueError, match='ckpt_mode should be 3'):
            torch_main(['test', bad], device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            torch_main(['test', cfg])


EVALUATION = """
[evaluation]
metric_1 = dice
label_list = [1]
organ_name = cube
ground_truth_folder_root = {root}
test_evaluation_image_pair = {root}/cube_pairs.csv
"""


def test_inference_writes_evaluation_reports(workspace):
    """``main(['inference', cfg])`` with an ``[evaluation]`` section runs
    the test stage and then ``eva_main``, as the JAX CLI does: the dice
    CSV of the written labels against the cubes' ground truth (the
    workspace's target labels)."""
    import csv
    root = workspace
    rows = ['d1/lab/case{0}.nii.gz,case{0}.nii.gz\n'.format(case)
            for case in range(3)]
    with open(os.path.join(root, 'cube_pairs.csv'), 'w') as f:
        f.write('ground_truth,segmentation\n' + ''.join(rows))
    cfg = _cfg(root, 'eval.cfg', 'out_eval',
               extra=EVALUATION.format(root=root))
    assert torch_main(['inference', cfg], device='cpu') == 0
    assert len(_labels(root, 'out_eval')) == 3
    with open(os.path.join(root, 'out_eval', 'gen_d1_test_img',
                           'test_cube_dice_all.csv')) as f:
        table = list(csv.reader(f))
    assert table[0] == ['image', 'class_1'] and len(table) == 3 + 3
    assert all(0.0 <= float(r[1]) <= 1.0 for r in table[1:])
