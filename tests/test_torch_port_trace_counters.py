"""PyTorch port, the counter table of ``utils/trace_metrics.py``: every
``span`` adds one call and its elapsed seconds under its name, with the
profiler off and on any thread; ``counters_since`` gives the growth since
a snapshot; ``prefetch_iter`` counts its producer's items and times its
consumer's waits under the name its caller gives. (A thread's span under
a running profiler: ``tests/test_torch_port_profile.py``, where the
profiler has started once already.)

CPU only, each test well under a second. The table is the process's, so
each test uses names of its own."""
import os
import sys
import threading
import time

import pytest
import torch

from fpl_plus_torch.io.loader import prefetch_iter
from fpl_plus_torch.utils import trace_metrics as tm


def calls_and_seconds(name):
    return tm.counters().get(name, (0, 0.0))


def test_span_counts_calls_and_seconds_with_the_profiler_off():
    assert not torch.autograd._profiler_enabled()
    before = calls_and_seconds('unit_sleep')
    for _ in range(3):
        with tm.span('unit_sleep'):
            time.sleep(0.01)
    calls, seconds = calls_and_seconds('unit_sleep')
    assert calls - before[0] == 3
    assert 0.03 <= seconds - before[1] < 0.5


def test_a_span_counts_when_its_body_raises():
    before = calls_and_seconds('unit_raises')
    with pytest.raises(ValueError):
        with tm.span('unit_raises'):
            raise ValueError('inside')
    assert calls_and_seconds('unit_raises')[0] == before[0] + 1


def test_counters_since_is_the_difference():
    for seconds in (1.0, 0.5):
        tm.count('unit_diff_a', seconds)
    before = tm.counters()
    tm.count('unit_diff_a', 0.25)
    for _ in range(3):
        tm.count('unit_diff_b', 0.5)
    grown = tm.counters_since(before)
    assert grown['unit_diff_a'] == (1, pytest.approx(0.25))
    assert grown['unit_diff_b'] == (3, pytest.approx(1.5))
    # a name not called since is left out
    assert tm.counters_since(tm.counters()) == {}
    snap = tm.counters()
    snap['unit_diff_a'] = (0, 0.0)     # a snapshot is a copy
    assert tm.counters()['unit_diff_a'][0] == 3


def test_prefetch_iter_counts_its_items_and_waits_by_name():
    def slow():
        for i in range(4):
            time.sleep(0.01)
            yield i

    before = tm.counters()
    assert list(prefetch_iter(slow(), depth=1, name='unit_loader')) == [
        0, 1, 2, 3]
    grown = tm.counters_since(before)
    produce_calls, produce_s = grown['unit_loader_produce']
    assert produce_calls == 4 and produce_s >= 0.04
    # one wait an item, and the one that finds the end of the stream
    assert grown['unit_loader_wait'][0] == 5
    # without a name the iterator counts nothing
    before = tm.counters()
    assert list(prefetch_iter(range(3))) == [0, 1, 2]
    assert not [k for k in tm.counters_since(before)
                if k.endswith(('_wait', '_produce'))]


def test_the_table_loses_no_update_under_contending_threads():
    workers, each = 2 * (os.cpu_count() or 1) + 2, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = calls_and_seconds('unit_contended')
        threads = [threading.Thread(target=lambda: [
            tm.count('unit_contended', 1e-3) for _ in range(each)])
            for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    calls, seconds = calls_and_seconds('unit_contended')
    assert calls - before[0] == workers * each
    assert seconds - before[1] == pytest.approx(workers * each * 1e-3)
