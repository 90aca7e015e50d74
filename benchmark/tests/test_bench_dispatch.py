"""The harness takes a configuration's network from the reference file its
``reference`` key names, and guards a test stage's traced slice by the
configuration's ``trace_guard``: a copy of ``vs_t1s_g`` whose reference is
``recorded_reference.py`` runs its whole shrunk cell on the CPU through
that module alone, and comes out not correct when that module's network
is shifted; a train traffic on it stops at set-up. A traced train slice
has no guard, and its readers read it."""
import copy
import json
import os
from types import SimpleNamespace

import pytest

from benchmark.harness import cell, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RECORDED = 'benchmark/tests/recorded_reference.py'
SEED = 2 ** 31 + 4111


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def spec(cell_name, traffic, **config_keys):
    """``vs_t1s_g`` under ``traffic``, its config updated by
    ``config_keys``, with the limits of ``cell_name``."""
    config = copy.deepcopy(load('benchmark', 'configs', 'vs_t1s_g.json'))
    config.update(config_keys)
    return {'name': cell_name, 'manifest': load('BENCHMARK.json'),
            'cell': {'name': cell_name, 'config': 'vs_t1s_g',
                     'traffic': traffic, 'chips': 1},
            'config': config,
            'traffic': load('benchmark', 'workloads', traffic + '.json'),
            'limits': load('benchmark', 'limits', cell_name + '.json')}


@pytest.fixture
def recorded(monkeypatch):
    """The recording module, its calls cleared, with the module of the
    published configurations refusing every call."""
    module = cell.load_reference(RECORDED)
    module.CALLS.clear()
    default = cell.load_reference(load(
        'benchmark', 'configs', 'vs_t1s_g.json')['reference'])

    def refuse(*args, **kwargs):
        raise AssertionError('a call past the configured reference')

    for name in ('Net', 'make_weights', 'calibrate_foreground',
                 'work_per_window'):
        monkeypatch.setattr(default, name, refuse)
    return module


def workspace_paths():
    return SimpleNamespace(root='ws',
                           path=lambda *parts: os.path.join('ws', *parts))


def test_every_reference_call_goes_through_the_configured_file(recorded,
                                                               shrink):
    s = spec('vs_t1s_g.pseudo_label', 'pseudo_label', reference=RECORDED)
    r = cell.run_cell(s['name'], SEED, 0.05, False, device='cpu',
                      shrink=shrink, spec=s)
    assert r['correct'], r['checks']
    assert recorded.CALLS[:2] == ['make_weights', 'calibrate_foreground']
    # the judge's forwards: one Net call a sampled row's window group
    assert recorded.CALLS.count('Net') >= 2
    run = cell.Run(s, SEED, 0.05, False, 'cpu', shrink=shrink)
    run.stage = 'test'
    run.sections = run._sections(workspace_paths())
    assert run.work()['dsbn_launches_per_item'] > 0
    assert recorded.CALLS[-1] == 'work_per_window'
    assert set(recorded.CALLS) == {'make_weights', 'calibrate_foreground',
                                   'Net', 'work_per_window'}


def test_the_judge_uses_the_configured_network(recorded, shrink,
                                               monkeypatch):
    monkeypatch.setattr(recorded, 'Net', recorded.ShiftedNet)
    s = spec('vs_t1s_g.pseudo_label', 'pseudo_label', reference=RECORDED)
    r = cell.run_cell(s['name'], SEED, 0.05, False, device='cpu',
                      shrink=shrink, spec=s)
    gap = r['checks']['margin_gap_rel']
    assert not r['correct']
    assert gap['value'] > gap['limit']


def test_a_train_traffic_on_another_network_stops_at_set_up(recorded,
                                                            shrink):
    s = spec('vs_t1s_g.train_joint', 'train_joint', reference=RECORDED)
    with pytest.raises(ValueError, match='a train traffic needs the network '
                                         'that the training reference '
                                         'steps'):
        cell.run_cell(s['name'], SEED, 0.05, False, device='cpu',
                      shrink=shrink, spec=s)
    assert recorded.CALLS == []


@pytest.mark.parametrize('guard, message', [
    (None, 'the trace guard counted no launches in the traced slice: '
           'fpl_plus_torch.ops.dsbn_prelu:dsbn_prelu.launches'),
    ({'names': ['dsbn_prelu_kernel'],
      'counter': 'fpl_plus_torch.ops.dsbn_prelu:dsbn_prelu.bias_folds'},
     'the trace lost kernel events: 0 of'),
])
def test_the_traced_slice_is_guarded_by_the_configured_counter(
        guard, message, shrink):
    """On the CPU the program launches no kernel: the default guard counts
    no launches and fails the run; a guard on the plain version's bias
    folds counts some, and the trace holds none of the kernel's events
    that the configuration names for it."""
    keys = {} if guard is None else {'trace_guard': guard}
    s = spec('vs_t1s_g.pseudo_label', 'pseudo_label', **keys)

    def with_a_slice(config, traffic):
        # enough volumes that forwards run inside the traced slice
        config, traffic = shrink(config, traffic)
        traffic['min_items'] = 8
        return config, traffic

    with pytest.raises(RuntimeError, match=message):
        cell.run_cell(s['name'], SEED, 0.05, True, device='cpu',
                      shrink=with_a_slice, spec=s)


TRAIN_READERS = ('train_step_device_ms', 'train_step_gap_ms', 'bn_share.train',
                 'mfu.train', 'idle_share.train')


def test_a_traced_train_slice_is_read_without_a_guard(shrink, monkeypatch):
    """The program counts no train-mode kernel, so a train stage's traced
    slice has no guard: ``vs_t1s_g.train_joint`` traced on the CPU, with
    each host event mirrored where the card's trace puts its device
    events, passes ``close_slice``, is correct, and its readers read it
    (the H100's peaks stand in for the CPU's)."""
    events = trace.Profiler.events

    def mirrored(self, path):
        out = events(self, path)
        lanes = {trace.HOST_LANE: trace.DEVICE_LANE, 'cpu_op': 'kernel'}
        return out + [dict(e, cat=lanes[e['cat']]) for e in out
                      if e.get('cat') in lanes]

    monkeypatch.setattr(trace.Profiler, 'events', mirrored)
    s = spec('vs_t1s_g.train_joint', 'train_joint')
    s['manifest'] = copy.deepcopy(s['manifest'])
    s['manifest']['per_layer'] = [
        {'name': name, 'unit': '-', 'workloads': [s['name']]}
        for name in TRAIN_READERS]
    peaks = load('benchmark', 'peaks.json')
    s['peaks'] = {'cpu': peaks['NVIDIA H100 80GB HBM3']}
    closed = []
    close = cell.Run.close_slice

    def recorded_close(self, ws, unit):
        close(self, ws, unit)
        closed.append((unit, self.view.periods))

    monkeypatch.setattr(cell.Run, 'close_slice', recorded_close)
    r = cell.run_cell(s['name'], SEED, 2.0, True, device='cpu',
                      shrink=shrink, spec=s)
    assert closed and closed[0][0] == 'train_step' and closed[0][1] >= 2
    assert r['correct'], r['checks']
    assert set(r['metrics']) == set(TRAIN_READERS)
    assert all(m['value'] > 0 for m in r['metrics'].values()), r['metrics']
