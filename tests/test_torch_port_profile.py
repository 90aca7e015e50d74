"""PyTorch port, the profiling surface: ``[training]`` / ``[testing]
profile_dir`` under ``torch.profiler`` and ``utils/trace_metrics.py``
against the JAX package's.

* ``cli train`` with ``[training] profile_dir`` (the segmentation agent at
  4 iterations, ``iter_valid = 2``; ``main_ssl`` MeanTeacher at 2,
  ``iter_valid = 1``): one trace file, ``iter_valid`` ``train_step`` spans
  and no validation or Inferer span on its host lane (the trace ends
  before the first validation, as JAX's ``agents/agent_seg.py:618-622``),
  and checkpoints bit-equal to the same run without ``profile_dir``.
* ``cli test`` with ``[testing] profile_dir``: one trace with one
  ``infer_run`` span per volume, labels equal to the run without it;
  ``ckpt_mode = 3`` writes no trace (JAX returns before its trace starts).
* ``trace_metrics``: the same device events written in JAX's layout
  (``plugins/profile/<run>/host.trace.json.gz``, a ``/device:TPU:0``
  process with an 'XLA Modules' thread) and in torch's
  (``gpu_user_annotation`` spans) read the same in both packages; nested
  and overlapping spans count once; a trace without a device lane gives
  ``{}``, 0 and None in both.

All on the CPU at tiny widths; no JAX program is compiled. The profiler
records the host lane only here, so the device readers are checked on
written traces.
"""
import glob
import gzip
import json
import os
import sys

import numpy as np
import pytest
import torch

import fpl_plus_tpu.utils.trace_metrics as jax_tm
from fpl_plus_torch.cli import main as torch_main
from fpl_plus_torch.cli import main_ssl
from fpl_plus_torch.io.image_io import load_image_as_nd_array
from fpl_plus_torch.utils import trace_metrics as port_tm
from tests.test_torch_port_models import one_torch_thread  # noqa: F401
from tests.test_torch_port_ssl import write_ssl_workspace
from tests.test_torch_port_train_step import CLI_CFG
from tests.test_torch_port_train_units import write_train_domain

N_TEST = 3                         # write_train_domain's volumes per domain


def trace_files(trace_dir):
    return sorted(glob.glob(os.path.join(trace_dir, '*.pt.trace.json.gz')))


def host_spans(trace_dir):
    """The names of the ``record_function`` ranges on the host lane."""
    return [e['name'] for e in port_tm.trace_events(trace_dir)
            if e.get('ph') == 'X' and e.get('cat') == port_tm.HOST_LANE]


def assert_same(a, b, where=''):
    """Bit-equal nested checkpoint contents."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), where
        for k in a:
            assert_same(a[k], b[k], '{0}/{1}'.format(where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, '{0}/{1}'.format(where, i))
    else:
        assert a == b, where


def checkpoints(ckpt_dir):
    """``{iteration suffix: path}`` of the ``<dir name>_<it>.pt`` files."""
    prefix = os.path.basename(ckpt_dir)
    return {os.path.basename(p)[len(prefix):]: p
            for p in glob.glob(os.path.join(ckpt_dir, prefix + '_*.pt'))}


def assert_checkpoints_equal(dir_a, dir_b):
    a, b = checkpoints(dir_a), checkpoints(dir_b)
    assert a and sorted(a) == sorted(b)
    for it in a:
        assert_same(torch.load(a[it], weights_only=False),
                    torch.load(b[it], weights_only=False), it)


def seg_cfg(root, tag, ckpt=None, training='', testing=''):
    """``<tag>.cfg``: CLI_CFG at 4 iterations with a validation every 2,
    checkpoints in ``model/<ckpt or tag>``, labels in ``result_<tag>``
    and ``testing`` added to its ``[testing]`` section."""
    text = CLI_CFG.format(root=root, extra=training).replace(
        'iter_max = 2', 'iter_max = 4').replace(
        '{0}/model/gen'.format(root), '{0}/model/{1}'.format(root,
                                                             ckpt or tag)
    ).replace('{0}/result'.format(root), '{0}/result_{1}'.format(root, tag))
    path = os.path.join(root, tag + '.cfg')
    with open(path, 'w') as f:
        f.write(text + testing + '\n')
    return path


@pytest.fixture(scope='module')
def seg_workspace(tmp_path_factory):
    """Two tiny labelled domains and one ``cli train`` without a trace
    (checkpoints in ``model/plain``, auto-test labels in
    ``result_plain``)."""
    root = str(tmp_path_factory.mktemp('profile_seg'))
    rs = np.random.RandomState(2)
    for d in (0, 1):
        write_train_domain(root, d, rs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, 'torch.utils.tensorboard', None)
        assert torch_main(['train', seg_cfg(root, 'plain')],
                          device='cpu') == 0
    return root


def ssl_cfgs(root):
    """MeanTeacher's cfg without and with ``[training] profile_dir``."""
    base = write_ssl_workspace(root)
    with open(base) as f:
        text = f.read()
    prof = os.path.join(root, 'prof.cfg')
    with open(prof, 'w') as f:
        f.write(text.replace('/model/mt', '/model/mt_prof').replace(
            '/result', '/result_prof').replace(
            '[training]\n', '[training]\nprofile_dir = {0}/trace\n'.format(
                root)))
    return base, prof


@pytest.mark.parametrize('agent', ['segmentation', 'ssl'])
def test_training_profile_dir_traces_the_first_block(agent, request,
                                                     tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    if agent == 'segmentation':
        root = request.getfixturevalue('seg_workspace')
        iter_valid = 2
        cfg = seg_cfg(root, 'prof', training='profile_dir = {0}/trace'
                      .format(root))
        assert torch_main(['train', cfg], device='cpu') == 0
        plain, prof = (os.path.join(root, 'model', t)
                       for t in ('plain', 'prof'))
    else:
        root = str(tmp_path)
        iter_valid = 1
        base, cfg = ssl_cfgs(root)
        assert main_ssl(['train', base], device='cpu') == 0
        assert main_ssl(['train', cfg], device='cpu') == 0
        plain, prof = (os.path.join(root, 'model', t)
                       for t in ('mt', 'mt_prof'))
    trace_dir = os.path.join(root, 'trace')
    assert len(trace_files(trace_dir)) == 1
    spans = host_spans(trace_dir)
    assert spans.count('train_step') == iter_valid
    assert not [s for s in spans if s == 'validation_forward'
                or s.startswith('infer_')], spans
    # the CPU trace has no device lane
    assert port_tm.module_events_us(trace_dir) == {}
    assert_checkpoints_equal(plain, prof)


def test_testing_profile_dir_traces_the_volume_loop(seg_workspace):
    root = seg_workspace
    cfg = seg_cfg(root, 'test', ckpt='plain',
                  testing='profile_dir = {0}/trace_test'.format(root))
    assert torch_main(['test', cfg], device='cpu') == 0
    trace_dir = os.path.join(root, 'trace_test')
    assert len(trace_files(trace_dir)) == 1
    spans = host_spans(trace_dir)
    assert spans.count('infer_run') == N_TEST
    assert not [s for s in spans if s in ('train_step', 'validation_forward')]
    got = sorted(glob.glob(os.path.join(root, 'result_test', '*',
                                        '*.nii.gz')))
    want = sorted(glob.glob(os.path.join(root, 'result_plain', '*',
                                         '*.nii.gz')))
    assert len(got) == len(want) == N_TEST
    for a, b in zip(got, want):
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(
            load_image_as_nd_array(a)['data_array'],
            load_image_as_nd_array(b)['data_array'])

    names = ', '.join(os.path.join(root, 'model', 'plain',
                                   'plain_{0}.pt'.format(i)) for i in (2, 4))
    ens = seg_cfg(root, 'ens', ckpt='plain', testing=(
        'profile_dir = {0}/trace_ens\nckpt_name = [{1}]'.format(root, names)))
    with open(ens) as f:
        text = f.read()
    with open(ens, 'w') as f:
        f.write(text.replace('ckpt_mode = 0', 'ckpt_mode = 3'))
    assert torch_main(['test', ens], device='cpu') == 0
    assert len(glob.glob(os.path.join(root, 'result_ens', '*',
                                      '*.nii.gz'))) == N_TEST
    assert not os.path.exists(os.path.join(root, 'trace_ens'))


# -- trace_metrics against the JAX package's --------------------------------

# (name, start us, duration us) of dispatched programs on one device
PROGRAMS = [('train_step', 100.0, 40.0), ('train_step', 150.0, 42.0),
            ('infer_run', 200.0, 10.0), ('train_step', 215.0, 39.0),
            ('infer_run', 260.0, 12.5)]


def write_jax_trace(root, programs, children=(), device=True):
    """``programs`` on the 'XLA Modules' thread of a TPU process (JAX's
    names carry a ``(id)`` suffix), ``children`` on its 'XLA Ops' thread;
    with ``device=False`` the same events on a host process."""
    run = os.path.join(root, 'plugins', 'profile', '2026_10_17_12_00_00')
    os.makedirs(run)
    pname = '/device:TPU:0' if device else '/host:CPU'
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 1,
               'args': {'name': pname}},
              {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 1,
               'args': {'name': 'XLA Modules'}},
              {'ph': 'M', 'name': 'thread_name', 'pid': 1, 'tid': 2,
               'args': {'name': 'XLA Ops'}}]
    events += [{'ph': 'X', 'pid': 1, 'tid': 1, 'name': '{0}({1})'.format(
        name, i), 'ts': ts, 'dur': dur}
        for i, (name, ts, dur) in enumerate(programs)]
    events += [{'ph': 'X', 'pid': 1, 'tid': 2, 'name': name, 'ts': ts,
                'dur': dur} for name, ts, dur in children]
    with gzip.open(os.path.join(run, 'host.trace.json.gz'), 'wt') as f:
        json.dump({'traceEvents': events}, f)


def write_torch_trace(root, spans, device=True, gz=True):
    """``spans`` as device-lane mirrors of ``record_function`` ranges (GPU
    0, stream 7) beside their host-lane ranges and a kernel; with
    ``device=False`` the host lane only."""
    events = [{'ph': 'M', 'name': 'process_name', 'pid': 0,
               'args': {'name': 'GPU 0'}}] if device else []
    for name, ts, dur in spans:
        events.append({'ph': 'X', 'cat': 'user_annotation', 'name': name,
                       'pid': 4242, 'tid': 4242, 'ts': ts - 5.0, 'dur': 3.0})
        events.append({'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::conv3d',
                       'pid': 4242, 'tid': 4242, 'ts': ts - 4.0, 'dur': 1.0})
        if device:
            events.append({'ph': 'X', 'cat': 'gpu_user_annotation',
                           'name': name, 'pid': 0, 'tid': 7, 'ts': ts,
                           'dur': dur})
            events.append({'ph': 'X', 'cat': 'kernel', 'name': 'conv_kernel',
                           'pid': 0, 'tid': 7, 'ts': ts, 'dur': dur / 2})
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'trace_x.pt.trace.json' + ('.gz' if gz
                                                         else ''))
    with (gzip.open(path, 'wt') if gz else open(path, 'w')) as f:
        json.dump({'schemaVersion': 1, 'traceEvents': events}, f)
    return path


def readings(tm, root):
    return (tm.module_events_us(root), tm.device_busy_us(root),
            tm.dominant_module_median_ms(root))


@pytest.mark.parametrize('gz', [True, False])
def test_trace_readers_match_jax_on_the_same_events(tmp_path, gz):
    write_jax_trace(str(tmp_path / 'jax'), PROGRAMS)
    write_torch_trace(str(tmp_path / 'torch'), PROGRAMS, gz=gz)
    want = readings(jax_tm, str(tmp_path / 'jax'))
    got = readings(port_tm, str(tmp_path / 'torch'))
    assert want[0] == {'train_step': [40.0, 42.0, 39.0],
                       'infer_run': [10.0, 12.5]}
    assert got[0] == want[0]
    # the lists follow the spans' start, not the file's order
    write_torch_trace(str(tmp_path / 'reversed'), PROGRAMS[::-1], gz=gz)
    assert port_tm.module_events_us(str(tmp_path / 'reversed')) == want[0]
    assert got[1] == pytest.approx(want[1]) and want[1] == 143.5
    assert got[2] == pytest.approx(want[2]) and want[2] == 0.040
    # each span's kernel runs half of it
    assert port_tm.kernel_busy_us(str(tmp_path / 'torch')) == 71.75


def test_device_window_and_span_gaps(tmp_path):
    """The device's window runs from the first kernel's start (100) to the
    last one's end (260 + 12.5 / 2); the gaps between same-named spans
    follow their start order, whatever the file's."""
    for tag, programs in (('fwd', PROGRAMS), ('rev', PROGRAMS[::-1])):
        root = str(tmp_path / tag)
        write_torch_trace(root, programs)
        assert port_tm.device_window_us(root) == 166.25
        assert port_tm.span_gaps_us(root, 'infer_run') == [50.0]
        assert port_tm.span_gaps_us(root, 'train_step') == [10.0, 23.0]
        assert port_tm.span_gaps_us(root, 'validation_forward') == []
    write_torch_trace(str(tmp_path / 'host'), PROGRAMS, device=False)
    assert port_tm.device_window_us(str(tmp_path / 'host')) == 0.0
    assert port_tm.span_gaps_us(str(tmp_path / 'host'), 'infer_run') == []


def test_nested_and_overlapping_spans_count_once(tmp_path):
    # JAX: the 'XLA Ops' children of a program are not summed; torch: a
    # span nested in another, and an overlapping pair, are a union
    children = [('fusion.1', 101.0, 10.0), ('conv.2', 112.0, 20.0)]
    write_jax_trace(str(tmp_path / 'jax'), PROGRAMS, children)
    nested = PROGRAMS + [('validation_forward', 101.0, 10.0),
                         ('infer_run_logits', 112.0, 20.0)]
    write_torch_trace(str(tmp_path / 'torch'), nested)
    assert port_tm.device_busy_us(str(tmp_path / 'torch')) == pytest.approx(
        jax_tm.device_busy_us(str(tmp_path / 'jax')))
    write_torch_trace(str(tmp_path / 'overlap'),
                      [('a', 0.0, 10.0), ('b', 5.0, 10.0), ('c', 30.0, 1.0)])
    assert port_tm.device_busy_us(str(tmp_path / 'overlap')) == 16.0


def test_trace_without_device_lane_reads_empty_in_both(tmp_path):
    write_jax_trace(str(tmp_path / 'jax'), PROGRAMS, device=False)
    write_torch_trace(str(tmp_path / 'torch'), PROGRAMS, device=False)
    for tm, root in ((jax_tm, tmp_path / 'jax'),
                     (port_tm, tmp_path / 'torch'),
                     (jax_tm, tmp_path / 'none'),
                     (port_tm, tmp_path / 'none')):
        assert readings(tm, str(root)) == ({}, 0.0, None)
    assert port_tm.kernel_busy_us(str(tmp_path / 'torch')) == 0.0


def test_cpu_trace_files_and_traced_device_ms(tmp_path):
    """On the CPU: a rank-named file per trace, the newest read, the host
    lane recorded, no device lane (``traced_device_ms`` gives None);
    stopping twice raises."""
    root = str(tmp_path)
    port_tm.start_trace(root, 'cpu', rank=1)
    with pytest.raises(RuntimeError, match='already running'):
        port_tm.start_trace(root, 'cpu')
    with port_tm.span('train_step'):
        torch.ones(4).add_(1)
    first = port_tm.stop_trace()
    assert os.path.basename(first).endswith('_rank1.pt.trace.json.gz')
    with pytest.raises(RuntimeError, match='no trace'):
        port_tm.stop_trace()
    port_tm.start_trace(root, torch.device('cpu'))
    with port_tm.span('infer_run'):
        torch.ones(4).add_(1)
    second = port_tm.stop_trace()
    assert trace_files(root) == sorted([first, second])
    assert host_spans(root) == ['infer_run']
    assert host_spans(first) == ['train_step']
    assert port_tm.traced_device_ms(lambda: torch.ones(4).add_(1), 2,
                                    'ones') is None
