"""The work the per-layer readers divide by: ``Run.work()``, composed from
the reference's ``work_per_window`` dict, against the formula it
replaced (frozen below), and the MFU readers' sum over classes of work,
each class over its own peak."""
import json
import math
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import cell
from benchmark.reference import serve
from benchmark.reference.unet2d5_dsbn import count_per_window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, 'benchmark', 'peaks.json')) as f:
    PEAKS = json.load(f)['NVIDIA H100 80GB HBM3']
CONFIGS = ['vs_t1s_g', 'vs_t1s_weights']
TRAFFIC = {'vs_t1s_g': 'vs_t1s_g.pseudo_label',
           'vs_t1s_weights': 'vs_t1s_weights.fpl_pass'}
WINDOWS = [[28, 128, 128], [16, 64, 96], [24, 160, 112]]


def frozen_work(stage, sections, traffic, net_cfg, fpl_passes):
    """``Run.work()`` as it was before the reference's work dict, frozen:
    every key and value the readers divided by."""
    d, te = sections['dataset'], sections['testing']
    tr = sections['training']
    if stage == 'train':
        crop = d['RandomCrop_output_size']
        macs, _, _ = count_per_window(net_cfg, crop)
        return {'flops_per_item': 6.0 * macs * d['train_batch_size']
                * net_cfg['num_domains'],
                'precision': tr.get('precision', 'float32')}
    window = te['sliding_window_size']
    shape = [max(s, w) for s, w in zip(traffic['volume_shape'], window)]
    starts, win = serve.grid(shape, window, te['sliding_window_stride'])
    macs, elems, _ = count_per_window(net_cfg, win)
    passes = fpl_passes if te.get('fpl', False) else 1
    variants = 4 if te.get('tta_mode', 0) else 1
    windows = len(starts) * variants * passes
    chunk = te.get('patch_chunk', 2)
    precision = te.get('precision', 'float32')
    itemsize = 4 if precision == 'float32' else 2
    return {'flops_per_item': 2.0 * macs * windows,
            'dsbn_bytes_per_item': 2.0 * elems * windows * itemsize,
            'dsbn_launches_per_item': 18 * math.ceil(len(starts) / chunk),
            'precision': precision}


def run_of(config, stage, window, precision='float32'):
    """A ``Run`` of ``config``'s cell with its window (and training crop)
    at ``window``, set up as far as ``work()`` needs."""
    def sized(cfg, traffic):
        cfg = json.loads(json.dumps(cfg))
        for k in ('sliding_window_size', 'sliding_window_stride'):
            cfg['testing'][k] = list(window)
        cfg['dataset']['RandomCrop_output_size'] = list(window)
        cfg['testing']['precision'] = precision
        cfg['training']['precision'] = precision
        return cfg, traffic

    run = cell.Run(cell.load_cell(TRAFFIC[config]), 1, 1.0, False, 'cpu',
                   shrink=sized)
    run.stage = stage
    run.sections = run._sections(SimpleNamespace(
        root='ws', path=lambda *parts: os.path.join('ws', *parts)))
    return run


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('window', WINDOWS, ids=str)
@pytest.mark.parametrize('stage', ['test', 'train'])
@pytest.mark.parametrize('config', CONFIGS)
def test_the_work_is_the_frozen_formula(config, stage, window, precision):
    run = run_of(config, stage, window, precision)
    work = run.work()
    want = frozen_work(stage, run.sections, run.traffic, run.net_cfg,
                       run.fpl_passes)
    assert set(work) == set(want) | {'flops_by_class'}
    for key, value in want.items():
        assert work[key] == value and type(work[key]) is type(value), key
    assert work['flops_by_class'] == {'conv': want['flops_per_item']}


def context(run, work, periods=16, length_us=2312345.678):
    run.view = SimpleNamespace(periods=periods, length_us=length_us)
    run.items = run.window_s = run.setup_s = run.peak_bytes = None
    run.work = lambda: work
    run.peaks = lambda: PEAKS
    return cell.Context(run)


@pytest.mark.parametrize('cudnn_tf32', [True, False])
@pytest.mark.parametrize('metric, stage', [('mfu.infer', 'test'),
                                           ('mfu.train', 'train')])
@pytest.mark.parametrize('config', CONFIGS)
def test_mfu_over_convolutions_alone_is_the_formula_of_before(
        config, metric, stage, cudnn_tf32, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', cudnn_tf32)
    run = run_of(config, stage, [28, 128, 128])
    ctx = context(run, run.work())
    t = ctx.trace
    # the readers' arithmetic before the sum over classes, frozen
    peak = PEAKS['dense_flops']['tf32' if cudnn_tf32 else 'float32']
    flops = ctx.work['flops_per_item'] * t.periods
    want = 100.0 * flops / (t.length_us / 1e6) / peak
    assert cell.reader(metric)(ctx) == want


@pytest.mark.parametrize('matmul_tf32', [True, False])
def test_mfu_takes_each_class_of_work_over_its_own_peak(matmul_tf32,
                                                        monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32',
                        matmul_tf32)
    run = run_of('vs_t1s_g', 'test', [28, 128, 128])
    work = {'flops_per_item': 5e12, 'precision': 'float32',
            'flops_by_class': {'conv': 4e12, 'matmul': 1e12}}
    ctx = context(run, work, periods=10, length_us=2e6)
    matmul_peak = PEAKS['dense_flops']['tf32' if matmul_tf32 else 'float32']
    # 4e13 operations at the TF32 peak, 1e13 at the matmuls' own, in 2 s
    want = 100.0 * (4e13 / 4.95e14 + 1e13 / matmul_peak) / 2.0
    assert cell.reader('mfu.infer')(ctx) == pytest.approx(want, rel=1e-12)
    assert matmul_peak == (4.95e14 if matmul_tf32 else 6.7e13)
    # at a half type, both classes take its peak, whatever the flags
    work['precision'] = 'bfloat16'
    assert cell.reader('mfu.infer')(ctx) == pytest.approx(
        100.0 * 5e13 / 9.89e14 / 2.0, rel=1e-12)


def test_a_class_of_work_without_a_peak_is_refused():
    with pytest.raises(ValueError, match="no peak for work of class 'fft'"):
        cell.dense_peak(PEAKS, 'float32', 'fft')
