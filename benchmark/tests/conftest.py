"""The benchmark's own tests. Those that need the card carry the ``card``
marker and skip in the ``card`` fixture where there is none; the rest run
on the CPU at tiny sizes."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# the program's scalar writer imports TensorBoard when it can (slow, and
# nothing here reads it)
sys.modules.setdefault('torch.utils.tensorboard', None)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the chip: python -m pytest '
                    'benchmark/tests -m card)')
    return torch.device('cuda')


def tiny(config, traffic):
    """A cell shrunk to CPU sizes: narrow network, small windows, volumes
    and batches, few items."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config['network']['feature_chns'] = [4, 8, 8, 8, 8]
    for k in ('Pad_output_size', 'RandomCrop_output_size'):
        config['dataset'][k] = [8, 16, 16]
    config['dataset']['train_batch_size'] = 2
    config['dataset']['num_workder'] = 2
    config['testing']['sliding_window_size'] = [8, 16, 16]
    config['testing']['sliding_window_stride'] = [8, 16, 16]
    traffic.update(volume_shape=[12, 24, 40], distinct_volumes=4,
                   warmup=[1, 3], min_items=3, sample=2, warmup_steps=5)
    return config, traffic


@pytest.fixture
def shrink():
    return tiny
