"""The frozen work counts the per-layer metrics divide by."""
import json
import os

import pytest

from benchmark.reference import serve
from benchmark.reference.unet2d5_dsbn import param_spec, work_per_window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, 'benchmark', 'configs', name + '.json')) as f:
        return json.load(f)


NET = config('vs_t1s_g')['network']
WINDOW = config('vs_t1s_g')['testing']['sliding_window_size']


def test_parameters_of_the_published_network():
    n = sum(int(__import__('math').prod(s)) for _, s, k in param_spec(NET)
            if k not in ('rmean', 'rvar', 'count'))
    assert n == 22140628


def macs(net, window):
    return work_per_window(net, window)['macs_by_class']['conv']


def test_macs_per_window_forward():
    assert set(work_per_window(NET, WINDOW)['macs_by_class']) == {'conv'}
    assert round(macs(NET, WINDOW) / 1e9, 3) == 129.992


@pytest.mark.parametrize('cfg, passes, tflop', [('vs_t1s_g', 1, 12.48),
                                                 ('vs_t1s_weights', 6, 74.88)])
def test_flop_per_served_volume(cfg, passes, tflop):
    c = config(cfg)
    t = c['testing']
    starts, win = serve.grid([40, 160, 272], t['sliding_window_size'],
                             t['sliding_window_stride'])
    assert len(starts) == 12
    assert passes == (c['method']['fpl_passes'] if t['fpl'] else 1)
    assert round(2 * macs(c['network'], win) * len(starts) * 4 * passes
                 / 1e12, 2) == tflop


def test_flop_per_train_step():
    c = config('vs_t1s_g')
    step = 3 * 2 * macs(NET, c['dataset']['RandomCrop_output_size']) \
        * c['dataset']['train_batch_size'] * 2
    assert round(step / 1e12, 2) == 6.24


def test_dsbn_elements_match_the_activation_shapes():
    d, h, w = WINDOW
    ft = NET['feature_chns']
    # per level: (depth, height, width) of its activations; 2D levels pool
    # H and W only, 3D levels all three
    shapes = [(d, h, w), (d, h // 2, w // 2), (d, h // 4, w // 4),
              (d // 2, h // 8, w // 8), (d // 4, h // 16, w // 16)]
    vox = [a * b * c for a, b, c in shapes]
    # two DSBN stages in each encoder block, two in each decoder block of
    # levels 3..0
    want = 2 * sum(f * v for f, v in zip(ft, vox)) \
        + 2 * sum(f * v for f, v in zip(ft[:4], vox[:4]))
    # each input element read once and each output written once, in f32
    # and at 2 bytes; one launch a DSBN stage, 2 in each of 9 blocks
    for itemsize in (4, 2):
        k = work_per_window(NET, WINDOW, itemsize)['kernels']
        assert k == {'dsbn': {'bytes': 2 * want * itemsize,
                              'launches': 18}}
