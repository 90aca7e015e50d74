"""The trace readers on a small synthetic chrome trace: the priming
skipped, the slice, gaps, unions, the per-layer readers, and a lost
kernel event detected."""
import importlib.util
import os
from types import SimpleNamespace

import pytest

from benchmark.harness.trace import TraceView, check_events, union

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'metrics')
KERNELS = {'dsbn_prelu': {'names': ['dsbn_prelu_kernel']},
           'batch_norm': {'name_parts': ['norm', 'bn_', 'welford']}}


def read(metric, ctx):
    spec = importlib.util.spec_from_file_location(
        'm', os.path.join(METRICS, metric + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def ev(cat, name, ts, dur, pid=0):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
            'pid': pid}


def trace(unit='infer_run'):
    """Priming 0-50 us; four unit spans 100-200, 250-350, 400-500,
    560-660, each holding a DSBN kernel of 40 us and a convolution; one
    kernel before the priming's end, which the readers must skip."""
    events = [ev('kernel', 'spin_kernel', 0, 50),
              ev('kernel', 'dsbn_prelu_kernel', 10, 20)]
    for a in (100, 250, 400, 560):
        events += [ev('gpu_user_annotation', unit, a, 100),
                   ev('user_annotation', unit, a - 30, 20, pid=1),
                   ev('kernel', 'dsbn_prelu_kernel', a, 40),
                   ev('kernel', 'cudnn::bn_fw_tr_kernel', a + 40, 10),
                   ev('kernel', 'sm90_conv', a + 50, 50)]
    events.append(ev('cpu_op', 'aten::copy_', 368, 12, pid=1))
    return events


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_slice_skips_the_priming():
    t = TraceView(trace(), 'infer_run')
    assert t.prime_end == 50
    assert (t.start, t.end, t.periods) == (250, 560, 2)
    assert t.busy_us() == 200
    assert t.idle_gaps() == [(350, 400), (500, 560)]
    assert t.count_kernels(['dsbn_prelu_kernel']) == 4


def test_breakdown_names_the_gaps_by_the_host():
    b = TraceView(trace(), 'infer_run').breakdown()
    assert b['device_ops'][0] == ['sm90_conv', 100e-6]
    assert b['idle_gaps'][0] == ['infer_run', 60e-6]
    assert b['idle_gaps'][1] == ['aten::copy_', 50e-6]


def ctx(unit, stage, work):
    peaks = {'dense_flops': {'tf32': 1e12, 'float32': 1e12,
                             'bfloat16': 1e12, 'float16': 1e12},
             'hbm_bytes_per_s': 1e9}
    return SimpleNamespace(trace=TraceView(trace(unit), unit), stage=stage,
                           work=work, peaks=peaks, kernels=KERNELS,
                           peak_flops=lambda kind='conv': 1e12)


def test_serving_readers():
    c = ctx('infer_run', 'test', {'flops_per_item': 1e6,
                                  'flops_by_class': {'conv': 1e6},
                                  'dsbn_bytes_per_item': 8e4,
                                  'dsbn_launches_per_item': 2,
                                  'precision': 'float32'})
    assert read('infer_gap_ms.serve', c) == pytest.approx((50 + 60) / 2e3)
    assert read('infer_device_ms.serve', c) == pytest.approx(0.1)
    assert read('fpl_device_ms', c) is None
    assert read('idle_share.infer', c) == pytest.approx(
        100 * (1 - 200 / 310))
    # 2 periods of 1e6 flops over 310 us at 1e12 flop/s
    assert read('mfu.infer', c) == pytest.approx(100 * 2e6 / 310e-6 / 1e12)
    # 2 events in the slice, 4e4 bytes each at 1e9 B/s = 40 us each
    assert read('dsbn_prelu_roofline', c) == pytest.approx(100.0)
    assert read('idle_share.train', c) is None


def test_training_readers():
    c = ctx('train_step', 'train', {'flops_per_item': 1e6,
                                    'flops_by_class': {'conv': 1e6},
                                    'precision': 'float32'})
    assert read('train_step_device_ms', c) == pytest.approx(0.1)
    # host ranges 220-240, 370-390, 530-550: gaps 130 and 140 us
    assert read('train_step_gap_ms', c) == pytest.approx(0.135)
    # the eval DSBN+PReLU kernel counts as batch norm too ('bn_')
    assert read('bn_share.train', c) == pytest.approx(100 * 100 / 200)
    assert read('mfu.train', c) == pytest.approx(100 * 2e6 / 310e-6 / 1e12)
    assert read('idle_share.infer', c) is None


def test_a_lost_kernel_event_fails_the_run():
    t = TraceView(trace(), 'infer_run')
    check_events(t, ['dsbn_prelu_kernel'], 4)
    with pytest.raises(RuntimeError, match='lost kernel events'):
        check_events(t, ['dsbn_prelu_kernel'], 5)
