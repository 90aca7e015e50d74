"""PyTorch port, the test stage's host path: a ``[NormalizeWithMeanStd,
CenterCrop]`` chain (an inverse that pastes into zeros, so no device-label
crop) through the port's CLI against the JAX CLI on one set of weights, and
``infer_device_label = False`` against the device-label path.

The workspace (``host_workspace``) is the CLI test's three noisy
12x24x24 volumes with a bright cube and a small UNet2D5_dsbn (feature_chns
[4,8,16,16,32], dropout as the flagship) made by the port from a seed and
carried to the JAX package by its numpy converter, saved as a msgpack
checkpoint for the JAX CLI and a ``.pt`` for the port; a second set of
weights (``gen_6``) serves the ensemble tests. The JAX CLI runs once here
(one sliding-window program). Tolerance: labels equal on at least 99.99%
of voxels (expected: identical; a label can flip only where the two
logits tie to ~1e-5). The host path against the device-label path: at
least 99.9% (the host takes the argmax of the softmax, whose f32 rounding
ties two probabilities whose logits differ by ~1e-7, and argmax then takes
class 0; the device takes the argmax of the logits; the random weights
leave many near-ties).
"""
import os

import jax
import numpy as np
import pytest
import torch

from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.models.registry import create_network
from fpl_plus_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_cli import _write_workspace
from tests.test_torch_port_models import (SMALL, center_head,  # noqa: F401
                                          one_torch_thread)
from tests.test_torch_port_train_step import tiny_variables

AGREE = 0.9999
HOST_AGREE = 0.999
# the JAX package's scanned sliding window compiles faster than the
# unrolled one; the port ignores the key
JAX_EXTRA = 'infer_unroll_max = 0'

HOST_CFG = """
[dataset]
task_type = seg
root_dir = {root}
modal_num = 1
test_csv = {root}/d1_test_img.csv
test_transform = {chain}
NormalizeWithMeanStd_channels = [0]
Pad_output_size = [16, 32, 32]
CenterCrop_output_size = [12, 16, 20]
Rescale_output_size = [12, 32, 32]

[network]
net_type = UNet2D5_dsbn
num_domains = 2
class_num = 2
in_chns = 1
feature_chns = [4, 8, 16, 16, 32]
conv_dims = [2, 2, 3, 3, 3]
dropout = [0.0, 0.0, 0.3, 0.4, 0.5]
bilinear = False

[training]
ckpt_save_dir = {root}/model/gen
random_seed = 3

[testing]
ckpt_mode = {mode}
{ckpt_name}
domian_label = 1
output_dir = {root}/{out}
sliding_window_enable = True
sliding_window_size = [8, 16, 16]
sliding_window_stride = [6, 12, 12]
tta_mode = 1
{extra}
"""


def host_cfg(root, out, chain='[NormalizeWithMeanStd, CenterCrop]', mode=0,
             ckpt_name='', extra=''):
    path = os.path.join(root, out + '.cfg')
    with open(path, 'w') as f:
        f.write(HOST_CFG.format(root=root, out=out, chain=chain, mode=mode,
                                ckpt_name=ckpt_name, extra=extra))
    return path


def host_labels(root, out):
    d = os.path.join(root, out, 'gen_d1_test_img')
    return {n: load_image_as_nd_array(os.path.join(d, n))['data_array']
            for n in sorted(os.listdir(d)) if n.endswith('.nii.gz')}


@pytest.fixture(scope='module')
def host_workspace(tmp_path_factory):
    from fpl_plus_tpu.engine import ckpt as jax_ckpt
    root = str(tmp_path_factory.mktemp('torch_port_host'))
    probe = _write_workspace(root).astype(np.float32)
    ckpt_dir = os.path.join(root, 'model', 'gen')
    for it, seed in ((5, 31), (6, 32)):
        params, stats = tiny_variables(seed, SMALL)
        params = jax.tree_util.tree_map(np.asarray, params)
        net = create_network(SMALL).eval()
        net.load_state_dict(state_dict_from_jax(params, stats, SMALL))
        center_head(params, net, probe)
        jax_ckpt.save_checkpoint(ckpt_dir, 'gen', it,
                                 {'params': params, 'batch_stats': stats,
                                  'opt_state': ()}, 0.0)
        torch.save({'iteration': it, 'valid_pred': 0.0,
                    'model_state_dict': state_dict_from_jax(params, stats,
                                                            SMALL)},
                   os.path.join(ckpt_dir, 'gen_{0}.pt'.format(it)))
    with open(os.path.join(ckpt_dir, 'gen_latest.txt'), 'w') as f:
        f.write('5')
    return root


def skip_jax_init(monkeypatch):
    """The JAX agent initialises its network eagerly (one small compile per
    op, ~50 s on the CPU) only to get the variable structure its
    checkpoint loader fills: hand it that structure instead."""
    template = tiny_variables(0, SMALL)
    monkeypatch.setattr('fpl_plus_tpu.agents.agent_seg.init_network',
                        lambda module, cfg, seed=0: template)


def test_center_crop_chain_matches_jax_cli(host_workspace, monkeypatch):
    from fpl_plus_tpu.cli import main as jax_main
    root = host_workspace
    skip_jax_init(monkeypatch)
    assert jax_main(['test', host_cfg(root, 'crop_jax',
                                      extra=JAX_EXTRA)]) == 0
    assert torch_main(['test', host_cfg(root, 'crop_torch')],
                      device='cpu') == 0
    ref, got = host_labels(root, 'crop_jax'), host_labels(root, 'crop_torch')
    assert list(got) == list(ref) == ['case0.nii.gz', 'case1.nii.gz',
                                      'case2.nii.gz']
    for name in ref:
        assert got[name].shape == ref[name].shape == (1, 12, 24, 24)
        # the inverse pasted into zeros: background outside the crop
        assert not got[name][:, :, :4].any() and not got[name][:, :, 20:].any()
        assert 0.05 < got[name][:, :, 4:20, 2:22].mean() < 0.95, name
        assert np.mean(got[name] == ref[name]) >= AGREE, name


def test_host_path_equals_device_label_path(host_workspace):
    """``infer_device_label = False`` on the crop-only chain (logits back,
    Pad's inverse and softmax + argmax on the host) writes the labels of
    the device-label path."""
    root = host_workspace
    chain = '[NormalizeWithMeanStd, Pad]'
    assert torch_main(['test', host_cfg(root, 'dev', chain)],
                      device='cpu') == 0
    assert torch_main(['test', host_cfg(root, 'host', chain,
                                        extra='infer_device_label = False')],
                      device='cpu') == 0
    dev, host = host_labels(root, 'dev'), host_labels(root, 'host')
    assert list(host) == list(dev)
    for name in dev:
        assert np.mean(host[name] == dev[name]) >= HOST_AGREE, name
