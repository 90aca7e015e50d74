"""The Swin UNETR configuration's files: its reference's counts of work
against a counting forward of the reference, the attention's operations
against their formula, the foreground calibration, the seeded attention's
spread, the trace guard, the new readers on a synthetic trace, and the
cell's whole run on the CPU at a small size (feature size 12, which the
shared ``shrink`` fixture does not cut), sound, with a broken answer and
with a fault planted under the program's window attention; on the card,
the planted faults at the cell's own size."""
import copy
import importlib.util
import json
import math
import os

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.trace import TraceView
from benchmark.reference import swin_unetr as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = 'vs_swin_unetr.pseudo_label'
with open(os.path.join(ROOT, 'benchmark', 'configs',
                       'vs_swin_unetr.json')) as f:
    CONFIG = json.load(f)
NET = CONFIG['network']
WINDOW = CONFIG['testing']['sliding_window_size']
TINY = dict(NET, feature_size=12)


def counted(net, window):
    """``(conv MACs, matmul MACs, attention blocks)`` of a forward of the
    reference on the ``meta`` device, counted by its observers."""
    work = {'conv': 0, 'matmul': 0, 'blocks': 0}

    def on_conv(kind, x, w, out):
        n = x.numel() if kind == 'transposed' else out.numel()
        work['conv'] += n * w[0].numel()

    def on_linear(x, w):
        work['matmul'] += x.numel() // x.shape[-1] * w.numel()

    def on_attention(windows, n, c):
        work['matmul'] += 2 * windows * n * n * c
        work['blocks'] += 1

    weights = {name: torch.empty(shape, device='meta',
                                 dtype=torch.long if kind == 'index'
                                 else torch.float32)
               for name, shape, kind in ref.param_spec(net)}
    weights.update({k: v.to('meta') for k, v in ref.make_weights(
        net, 0, 'cpu').items() if k.endswith('relative_position_index')})
    x = torch.empty((1, net['in_chns']) + tuple(window), device='meta')
    ref.Net(net, weights, on_conv=on_conv, on_linear=on_linear,
            on_attention=on_attention)(x, 0)
    return work['conv'], work['matmul'], work['blocks']


@pytest.mark.parametrize('net, window', [(TINY, [32, 64, 64]),
                                         (NET, WINDOW), (NET, [64, 96, 160])])
def test_the_work_of_a_window_is_the_counting_forward(net, window):
    work = ref.work_per_window(net, window)
    conv, matmul, blocks = counted(net, window)
    assert work['macs_by_class'] == {'conv': conv, 'matmul': matmul}
    kernel = work['kernels']['window_attention']
    assert kernel['launches'] == blocks == 8
    assert ref.work_per_window(net, window, 2)['kernels'][
        'window_attention']['bytes'] * 2 == kernel['bytes']


def test_the_published_window_in_numbers():
    """[32, 128, 128]: 173.7 GMAC of convolutions and 18.6 GMAC of linears
    and attention a window; the kernel's 1.82 GB and 150 GFLOP a forward
    of batch 8."""
    work = ref.work_per_window(NET, WINDOW)
    assert round(work['macs_by_class']['conv'] / 1e9, 2) == 173.71
    assert round(work['macs_by_class']['matmul'] / 1e9, 2) == 18.6
    kernel = work['kernels']['window_attention']
    assert round(8 * kernel['bytes'] / 1e9, 2) == 1.82
    assert round(8 * ref.window_attention_flops(NET, WINDOW) / 1e9, 1) \
        == 149.8


def test_the_attention_operations_are_the_formula():
    """4 x padded tokens x C x window tokens a block, two blocks a stage:
    stage grids [16,64,64], [8,32,32], [4,16,16], [2,8,8] padded to whole
    windows of 343, 343, 196 (depth clipped to 4) and 98 tokens."""
    stages = [((21, 70, 70), 48, 343), ((14, 35, 35), 96, 343),
              ((4, 21, 21), 192, 196), ((2, 14, 14), 384, 98)]
    want = sum(2 * 4 * math.prod(p) * c * n for p, c, n in stages)
    assert ref.window_attention_flops(NET, WINDOW) == want


def test_the_calibration_reaches_its_share():
    weights = ref.make_weights(TINY, 11, 'cpu')
    x = torch.randn((1, 1, 32, 64, 64),
                    generator=torch.Generator().manual_seed(2))
    ref.calibrate_foreground(TINY, weights, x, 0, 0.01)
    with torch.no_grad():
        logits = ref.Net(TINY, weights)(x, 0)[0]
    share = float((logits[1] > logits[0]).float().mean())
    assert share == pytest.approx(0.01, abs=1e-4)


@pytest.mark.parametrize('stage', [0, 3])
def test_the_seeded_attention_is_selective(stage):
    """q k^T d^-1/2 spreads by 2-3 at every stage and the bias table by
    about 1.75, so that the softmax is far from uniform over 343 keys."""
    weights = ref.make_weights(NET, 2 ** 31 + 11, 'cpu')
    c, heads = 48 * 2 ** stage, 3 * 2 ** stage
    prefix = 'swinViT.layers{0}.0.blocks.1.attn.'.format(stage + 1)
    x = torch.nn.functional.layer_norm(torch.randn(
        343, c, generator=torch.Generator().manual_seed(5)), (c,))
    qkv = (x @ weights[prefix + 'qkv.weight'].t()
           + weights[prefix + 'qkv.bias']).view(343, 3, heads, 16)
    scores = torch.einsum('qhd,khd->hqk', qkv[:, 0], qkv[:, 1]) / 4
    assert 2.0 < float(scores.std()) < 3.0
    assert 1.5 < float(weights[prefix + 'relative_position_bias_table']
                       .std()) < 2.0
    assert float(scores.softmax(-1).amax(-1).mean()) > 0.1


def test_the_trace_guard_is_the_programs_counter_and_the_readers_names():
    from fpl_plus_torch.ops.window_attention import window_attention
    guard = CONFIG['trace_guard']
    before = cell.program_counter(guard['counter'])
    assert isinstance(before, int) and before == window_attention.launches
    window_attention.launches += 3
    try:
        assert cell.program_counter(guard['counter']) == before + 3
    finally:
        window_attention.launches -= 3
    assert guard['names'] == list(reader_module(
        'window_attention_roofline').NAMES)


def reader_module(metric):
    spec = importlib.util.spec_from_file_location(
        'm', os.path.join(ROOT, 'benchmark', 'metrics', metric + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ev(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'pid': 0}


def swin_trace(kernel=True):
    """Priming 0-50 us; four volumes 100-300, 400-600, 700-900,
    1000-1200, each one forward: ``swin_vit`` 40 us holding a window
    attention of 20 us, ``unetr_decoder`` 60 us."""
    events = [ev('kernel', 'spin_kernel', 0, 50)]
    for a in (100, 400, 700, 1000):
        events += [ev('gpu_user_annotation', 'infer_run', a, 200),
                   ev('gpu_user_annotation', 'infer_forward', a, 100),
                   ev('gpu_user_annotation', 'swin_vit', a, 40),
                   ev('gpu_user_annotation', 'unetr_decoder', a + 40, 60),
                   ev('kernel', 'sm90_conv', a + 40, 60)]
        if kernel:
            events.append(ev('kernel', 'window_attention_kernel', a + 10,
                             20))
    return events


def swin_ctx(events, precision='float32'):
    from benchmark.harness.cell import Context, Run
    spec = cell.load_cell(CELL)
    spec['peaks'] = {'NVIDIA H100 80GB HBM3': {
        'dense_flops': {'tf32': 4.95e14, 'float32': 6.7e13,
                        'bfloat16': 9.89e14, 'float16': 9.89e14},
        'hbm_bytes_per_s': 3.35e12}}
    run = Run(spec, 1, 1.0, True, 'cpu')
    run.stage = 'test'
    run.sections = {'dataset': CONFIG['dataset'], 'training': {},
                    'testing': dict(CONFIG['testing'], precision=precision)}
    run.view = TraceView(events, 'infer_run')
    run.peaks = lambda: spec['peaks']['NVIDIA H100 80GB HBM3']
    return Context(run)


def test_the_new_readers_on_a_synthetic_trace(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    c = swin_ctx(swin_trace())
    read = {m: reader_module(m).read for m in (
        'window_attention_roofline', 'swin_vit_device_ms',
        'unetr_decoder_device_ms', 'mfu.infer')}
    assert read['swin_vit_device_ms'](c) == pytest.approx(0.04)
    assert read['unetr_decoder_device_ms'](c) == pytest.approx(0.06)
    assert read['mfu.infer'](c) > 0
    # 12 windows x 4 flips a volume in 6 forwards of 8 launches; per
    # launch the larger of its bytes and its operations over the f32 peak
    windows = 12 * 4
    flops = ref.window_attention_flops(NET, WINDOW) * windows / 48
    nbytes = ref.work_per_window(NET, WINDOW)['kernels'][
        'window_attention']['bytes'] * windows / 48
    assert flops / 6.7e13 > nbytes / 3.35e12
    # the slice holds the volumes at 400 and 700: 2 events of 20 us
    assert read['window_attention_roofline'](c) == pytest.approx(
        100 * flops / 6.7e13 / 20e-6)
    bf16 = swin_ctx(swin_trace(), 'bfloat16')
    assert read['window_attention_roofline'](bf16) == pytest.approx(
        100 * nbytes / 2 / 3.35e12 / 20e-6)
    parent = swin_ctx([e for e in swin_trace(False)
                       if e['name'] not in ('swin_vit', 'unetr_decoder')])
    for m in ('window_attention_roofline', 'swin_vit_device_ms',
              'unetr_decoder_device_ms'):
        assert read[m](parent) is None


def small(config, traffic):
    """The cell at CPU sizes: feature size 12, a [32, 32, 64] window (the
    least whose deepest stage keeps two voxels for instance norm), one
    window a volume."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config['network']['feature_size'] = 12
    for k in ('Pad_output_size', 'RandomCrop_output_size'):
        config['dataset'][k] = [32, 32, 64]
    config['testing']['sliding_window_size'] = [32, 32, 64]
    config['testing']['sliding_window_stride'] = [32, 32, 64]
    traffic.update(volume_shape=[20, 30, 60], distinct_volumes=3,
                   warmup=[1, 3], min_items=3, sample=2)
    return config, traffic


@pytest.mark.parametrize('fault', [None, 'answer'])
def test_the_cell_runs_on_the_cpu(fault):
    r = cell.run_cell(CELL, 2 ** 31 + 4099, 0.05, False, device='cpu',
                      shrink=small, fault=fault)
    assert r['correct'] is (fault is None), r['checks']
    assert r['attempted'] >= 3 and r['failed'] == 0
    assert set(r['metrics']) == {'volumes_per_s', 'setup_s'}


KERNEL_FAULTS = ('no_bias', 'transposed_index', 'no_mask')


def plant(monkeypatch, fault):
    """Plant a fault under the program's eval window attention (on the card
    the Triton kernel, on the CPU its plain version): the bias left out,
    the relative index transposed (the table's rows reversed, which
    negates every offset: row ``R - 1 - r`` holds the offset ``-d`` where
    row ``r`` holds ``d``) or the shift mask left out."""
    from fpl_plus_torch.models import swin_unetr as program
    attend = program.window_attention

    def planted(qkv, table, num_heads, window, regions=None):
        if fault == 'no_bias':
            table = torch.zeros_like(table)
        elif fault == 'transposed_index':
            table = table.flip(0)
        elif fault == 'no_mask':
            regions = None
        return attend(qkv, table, num_heads, window, regions)

    monkeypatch.setattr(program, 'window_attention', planted)


def test_the_transposed_index_is_the_reversed_table():
    from fpl_plus_torch.ops.window_attention import relative_position_index
    index = relative_position_index((7, 7, 7))
    assert torch.equal(index.t(), 13 ** 3 - 1 - index)


@pytest.mark.parametrize('fault', KERNEL_FAULTS)
def test_a_fault_under_the_window_attention_is_not_correct(fault,
                                                           monkeypatch):
    plant(monkeypatch, fault)
    r = cell.run_cell(CELL, 2 ** 31 + 4099, 0.05, False, device='cpu',
                      shrink=small)
    assert not r['correct'], r['checks']


@pytest.mark.card
@pytest.mark.parametrize('fault', KERNEL_FAULTS)
def test_a_kernel_fault_is_not_correct_on_the_card(fault, card,
                                                   monkeypatch):
    plant(monkeypatch, fault)
    for seed in (13, 2 ** 31 + 9):
        r = cell.run_cell(CELL, seed, 3.0, False, device=card)
        assert not r['correct'], (seed, r['checks'])
