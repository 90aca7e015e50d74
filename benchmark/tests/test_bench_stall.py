"""The readers of the program's layer spans and counters, and the naming
of idle gaps through launch correlation (``harness/stall.py``), on
synthetic chrome traces of a serial test stage: each volume's loader
wait, dispatch (a copy in, a forward, the accumulation, a copy out, each
launched by a runtime call with its correlation), fetch and save with its
geometry read and NIfTI write."""
import importlib.util
import os
from types import SimpleNamespace

import pytest

from benchmark.harness import stall
from benchmark.harness.trace import TraceView

METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'metrics')
NEW = ['loader_wait_ms.serve', 'decode_ms.serve', 'save_ms.serve',
       'fetch_wait_ms.serve', 'forward_device_ms', 'accumulate_device_ms',
       'idle_ms.loader', 'idle_ms.save', 'idle_ms.unnamed']
HOST_TID = 7
START = 100000.0          # the stage's first host time (us)
# per volume: (loader wait, save) in host us; six volumes, four periods.
# The card idles before each volume's copy in, through the save before it
# and the wait for it: before volume 2 mostly the wait, before 3, 4 and 5
# mostly the save (before 4 by 1600 against 1300 us)
LAYOUT = [(100, 3000), (100, 1200), (3000, 1200), (100, 1600), (1300, 3000),
          (100, 3000)]
COPY_IN, FORWARD, ACCUMULATE, COPY_OUT = 50.0, 3000.0, 400.0, 50.0
LATENCY = 5.0             # launch call to the earliest device start


def read(metric, ctx):
    spec = importlib.util.spec_from_file_location(
        'm', os.path.join(METRICS, metric + '.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def x(cat, name, ts, dur, tid=HOST_TID, **args):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur,
         'pid': 1, 'tid': tid}
    if args:
        e['args'] = args
    return e


def stage_trace(drift=0.0, layout=LAYOUT, boundaries=True):
    """The events of a serial test stage of ``layout``'s volumes, and the
    expected per-volume figures over the slice (volumes 1 to 4 of 0-5).
    Device times run ``1 + drift`` times the host's from 0; without
    ``boundaries`` only the dispatch spans are kept (the program before
    its layer spans)."""
    dev = lambda t: t * (1.0 + drift)          # noqa: E731
    events = [x('kernel', 'spin_kernel', 0.0, 50.0, tid=3)]
    host, device = [], []
    t, dev_end, corr = START, dev(START), 0
    per_volume = []

    def launch(at, name, dur, cat='kernel'):
        nonlocal dev_end, corr
        corr += 1
        host.append(x('cuda_runtime', 'cudaLaunchKernel', at, 2.0,
                      correlation=corr))
        start = max(dev_end, dev(at + LATENCY))
        device.append(x(cat, name, start, dur, tid=3, correlation=corr))
        dev_end = start + dur
        return start

    for wait, save in layout:
        v = {'wait': wait, 'save': save}
        host.append(x('user_annotation', 'test_loader_wait', t, wait))
        t += wait
        host.append(x('user_annotation', 'infer_run', t, 100.0))
        first = launch(t + 10, 'Memcpy HtoD', COPY_IN, 'gpu_memcpy')
        host.append(x('user_annotation', 'infer_forward', t + 20, 40.0))
        fwd = launch(t + 30, 'sm90_conv', FORWARD)
        device.append(x('gpu_user_annotation', 'infer_forward', fwd,
                        FORWARD, tid=3))
        host.append(x('user_annotation', 'infer_accumulate', t + 60, 20.0))
        acc = launch(t + 70, 'elementwise_add', ACCUMULATE)
        device.append(x('gpu_user_annotation', 'infer_accumulate', acc,
                        ACCUMULATE, tid=3))
        launch(t + 90, 'Memcpy DtoH', COPY_OUT, 'gpu_memcpy')
        device.append(x('gpu_user_annotation', 'infer_run', first,
                        dev_end - first, tid=3))
        t += 100
        # the fetch returns 10 us after the copy out ends (host clock)
        fetch_end = max(t, dev_end / (1.0 + drift)) + 10
        host.append(x('user_annotation', 'infer_fetch', t, fetch_end - t))
        v['fetch'] = fetch_end - t
        t = fetch_end
        host.append(x('user_annotation', 'save_outputs', t, save))
        host.append(x('user_annotation', 'save_geometry_read', t + 10,
                      save / 2 - 10))
        host.append(x('user_annotation', 'save_nifti_write', t + save / 2,
                      save / 2 - 10))
        t += save
        per_volume.append(v)
    if not boundaries:
        host = [e for e in host if e['cat'] != 'user_annotation'
                or e['name'] == 'infer_run']
        device = [e for e in device if e['cat'] != 'gpu_user_annotation'
                  or e['name'] == 'infer_run']
    return events + host + device, per_volume


def view(events):
    return TraceView([dict(e) for e in events], 'infer_run')


def ctx(events, stage='test'):
    return SimpleNamespace(trace=view(events), stage=stage)


def test_the_slice_is_the_middle_four_volumes():
    t = view(stage_trace()[0])
    assert t.periods == 4
    lo, hi = t.host_bounds('infer_run')
    assert [e['ts'] for e in t.host_spans('infer_run')].index(lo) == 1


@pytest.mark.parametrize('drift', [0.0, 0.006])
def test_correlation_names_each_gap_after_the_span_covering_most(drift):
    events, _ = stage_trace(drift)
    causes = stall.gap_causes(view(events))
    # one gap before each volume's copy in, volumes 2 to 5 (the slice ends
    # at volume 5's dispatch); what covers most of the host's time before
    # that launch: the save of the volume before, or the loader's wait
    assert [name for name, us in causes] == [
        'test_loader_wait', 'save_outputs', 'save_outputs', 'save_outputs']
    assert all(us > 1000 for name, us in causes)


def test_midpoint_naming_misnames_a_gap_under_drift_and_correlation_not():
    """With the device clock 0.6% fast, the gap before volume 4 (a save of
    1600 us, then a loader wait of 1300) has its middle in the save on the
    host, but its device middle maps 0.6% of 100 ms later, into the wait."""
    for drift, by_midpoint in ((0.006, 'test_loader_wait'),
                               (0.0, 'save_nifti_write')):
        t = view(stage_trace(drift)[0])
        # the trace's own breakdown names a gap by the innermost host
        # range at its device middle
        midpoint = {round(s * 1e6): n for n, s in t.breakdown()['idle_gaps']}
        gap = [(us, name) for name, us in stall.gap_causes(t)
               if 2900 < us < 3000]
        assert len(gap) == 1
        us, name = gap[0]
        assert name == 'save_outputs'
        assert midpoint[round(us)] == by_midpoint


def test_a_gap_without_its_launch_call_is_unnamed():
    events, _ = stage_trace()
    lost = [e for e in events if not (e['cat'] == 'cuda_runtime'
                                      and e['args']['correlation'] == 13)]
    # volume 3's copy in (its fourth launch call of four a volume)
    assert [name for name, us in stall.gap_causes(view(lost))] == [
        'test_loader_wait', None, 'save_outputs', 'save_outputs']


def test_the_readers_on_a_stage_trace():
    events, volumes = stage_trace()
    c = ctx(events)
    # the host window runs from volume 1's dispatch to volume 5's: the
    # waits for volumes 2 to 5, the fetches and saves of volumes 1 to 4
    assert read('loader_wait_ms.serve', c) == pytest.approx(
        sum(v['wait'] for v in volumes[2:6]) / 4e3)
    assert read('fetch_wait_ms.serve', c) == pytest.approx(
        sum(v['fetch'] for v in volumes[1:5]) / 4e3)
    assert read('save_ms.serve', c) == pytest.approx(
        sum(v['save'] for v in volumes[1:5]) / 4 / 1e3)
    assert read('forward_device_ms', c) == pytest.approx(FORWARD / 1e3)
    assert read('accumulate_device_ms', c) == pytest.approx(
        ACCUMULATE / 1e3)
    causes = stall.gap_causes(c.trace)
    for metric, names in (('idle_ms.loader', {'test_loader_wait'}),
                          ('idle_ms.save', {'save_outputs'}),
                          ('idle_ms.unnamed', {None})):
        want = sum(us for n, us in causes if n in names) / 4e3
        assert read(metric, c) == pytest.approx(want)
    assert read('idle_ms.loader', c) > 1 and read('idle_ms.save', c) > 1
    assert read('idle_ms.unnamed', c) == 0.0
    # the named idle is part of the slice's idle
    idle = c.trace.length_us - c.trace.busy_us()
    assert sum(read(m, c) for m in NEW if m.startswith('idle_ms.')) \
        <= idle / 4e3 + 1e-9


def test_every_new_reader_is_none_on_the_parents_trace(monkeypatch):
    from fpl_plus_torch.utils import trace_metrics
    events, _ = stage_trace(boundaries=False)
    c = ctx(events)
    monkeypatch.delattr(trace_metrics, 'counters', raising=False)
    for metric in NEW:
        assert read(metric, c) is None, metric
    none = SimpleNamespace(trace=None, stage='test')
    for metric in NEW:
        assert read(metric, none) is None, metric


def test_a_training_slice_reads_none():
    events, _ = stage_trace()
    c = ctx(events, stage='train')
    for metric in NEW:
        if metric not in ('forward_device_ms', 'accumulate_device_ms'):
            assert read(metric, c) is None, metric


def test_decode_reads_the_programs_produce_counter():
    from fpl_plus_torch.utils import trace_metrics
    c = ctx(stage_trace()[0])
    for _ in range(4):
        trace_metrics.count('test_loader_produce', 0.125)
    calls, seconds = trace_metrics.counters()['test_loader_produce']
    assert read('decode_ms.serve', c) == pytest.approx(1e3 * seconds / calls)
