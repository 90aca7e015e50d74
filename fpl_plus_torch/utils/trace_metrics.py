"""Device time from ``torch.profiler`` chrome traces, and the profiler's
start and stop for the agents' ``profile_dir`` keys.

Counterpart of the JAX package's ``utils/trace_metrics.py``. There, the
'XLA Modules' lane of a ``jax.profiler`` trace holds one event per
dispatched program with its time on the device. Here the port's dispatch
points are ``record_function`` ranges (``span``: ``train_step``,
``dis_step``, ``validation_forward``, ``infer_run``, ...). Under the
profiler's CUDA activity each range gets a mirror on the device lane
(``cat == "gpu_user_annotation"``) that runs from the first to the last
device activity the range launched. Those mirrors are the counterpart of
JAX's module events. A benchmark reads its ``device_ms`` from them, a
figure that host jitter cannot move.

Every span also counts, with the profiler on or off and on any thread: its
calls and ``time.perf_counter`` seconds add up in a process-wide table
under its name (``counters``; ``counters_since`` gives a stage its own
share). A range opened in a thread other than the one that started the
profiler is not recorded in the trace, so the test loader's producer
thread and the checkpoint writer's thread are seen through the table
alone.

Trace files: ``start_trace(dir, device, rank)`` / ``stop_trace()`` write
one gzipped chrome trace per call, ``dir/trace_<time>[_rank<r>]
.pt.trace.json.gz``; under a mesh each rank writes its own. On the CPU the
profiler records the host lane only (``cat == "user_annotation"`` for the
ranges), and the device readers return ``{}``, 0 and None, as JAX's do for
a CPU process.
"""
from __future__ import annotations

import functools
import glob
import gzip
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_LANE = 'gpu_user_annotation'
HOST_LANE = 'user_annotation'
DEVICE_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')

# the running trace: torch runs one profiler session per process, so, as
# with jax.profiler's start_trace / stop_trace, its handle is the module's
_ACTIVE: Dict = {}
# A trace can lose the events of its first kernel launches: on an NVIDIA
# H100, each of 44 traces lost some, 124 in all (tools/torch_trace_sessions.py).
# So start_trace primes the trace on the card: PRIME_S of short kernels
# (PRIME_KERNEL, each waited for) take those first launches, and the
# device readers skip them. Primed, none of 44 traces lost an event.
PRIME_S = 0.05
PRIME_CYCLES = 20000
PRIME_KERNEL = 'spin_kernel'       # torch.cuda._sleep's kernel


# calls and seconds per span name, for the whole process; the producer
# and writer threads add to it too
_COUNTS: Dict[str, List] = {}
_COUNTS_LOCK = threading.Lock()


def count(name: str, seconds: float) -> None:
    """Add one call of ``seconds`` to the table's entry ``name``."""
    with _COUNTS_LOCK:
        entry = _COUNTS.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += seconds


def counters() -> Dict[str, Tuple[int, float]]:
    """A snapshot of the table: ``{name: (calls, seconds)}``."""
    with _COUNTS_LOCK:
        return {k: (v[0], v[1]) for k, v in _COUNTS.items()}


def counters_since(before: Dict[str, Tuple[int, float]]
                   ) -> Dict[str, Tuple[int, float]]:
    """What the table gained since the snapshot ``before``: ``{name:
    (calls, seconds)}`` of the names called since."""
    out = {}
    for k, (calls, seconds) in counters().items():
        calls0, seconds0 = before.get(k, (0, 0.0))
        if calls > calls0:
            out[k] = (calls - calls0, seconds - seconds0)
    return out


class _Span:
    """``span``'s context: the profiler's range when a profiler runs on
    this thread, and the table's count either way."""

    __slots__ = ('name', 'range', 't0')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = (torch.profiler.record_function(self.name).__enter__()
                      if torch.autograd._profiler_enabled() else None)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        count(self.name, seconds)
        return False


def span(name: str) -> _Span:
    """A program span: ``record_function(name)`` while a profiler runs on
    the calling thread, and always one call and its elapsed seconds added
    to the counter table under ``name``. It waits for nothing and launches
    nothing."""
    return _Span(name)


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _newest_trace(trace_root: str) -> Optional[str]:
    if os.path.isfile(trace_root):
        return trace_root
    paths = [p for pattern in ('*.pt.trace.json', '*.pt.trace.json.gz')
             for p in glob.glob(os.path.join(trace_root, '**', pattern),
                                recursive=True)]
    if not paths:
        return None
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def trace_events(trace_root: str) -> List[dict]:
    """The events of the newest ``torch.profiler`` chrome trace under
    ``trace_root`` (a trace file itself, or a directory searched
    recursively for ``*.pt.trace.json[.gz]``); [] when there is none."""
    path = _newest_trace(trace_root)
    if path is None:
        return []
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
        return json.load(f).get('traceEvents', [])


def _device_spans(trace_root: str) -> List[dict]:
    """The device-lane spans in the order they started."""
    return sorted((e for e in trace_events(trace_root)
                   if e.get('ph') == 'X' and e.get('cat') == DEVICE_LANE),
                  key=lambda e: float(e['ts']))


def _union_us(events) -> float:
    """The union of the events' intervals on each device (``pid``), summed
    over the devices."""
    by_device: Dict = {}
    for e in events:
        start = float(e['ts'])
        by_device.setdefault(e.get('pid'), []).append(
            (start, start + float(e['dur'])))
    busy = 0.0
    for intervals in by_device.values():
        intervals.sort()
        lo, hi = intervals[0]
        for a, b in intervals[1:]:
            if a > hi:
                busy += hi - lo
                lo, hi = a, b
            else:
                hi = max(hi, b)
        busy += hi - lo
    return busy


def module_events_us(trace_root: str) -> Dict[str, list]:
    """Per-span device durations (us) of the newest trace:
    ``{span name: [dur_us, ...]}``, one entry per device-lane mirror of a
    ``record_function`` range, in the order they started; {} for a trace
    without a device lane."""
    per_span: Dict[str, list] = {}
    for e in _device_spans(trace_root):
        per_span.setdefault(e['name'], []).append(float(e['dur']))
    return per_span


def device_busy_us(trace_root: str) -> float:
    """Device-busy time (us) of the newest trace: the union of the
    device-lane spans' intervals, so nested or overlapping spans count
    once."""
    return _union_us(_device_spans(trace_root))


def _device_work(trace_root: str) -> List[dict]:
    return [e for e in trace_events(trace_root)
            if e.get('ph') == 'X' and e.get('cat') in DEVICE_WORK
            and PRIME_KERNEL not in e['name']]


def kernel_busy_us(trace_root: str) -> float:
    """The time (us) the device ran work in the newest trace: the union of
    its kernels, copies and fills. Beside ``device_busy_us`` it gives the
    device's idle share inside the spans."""
    return _union_us(_device_work(trace_root))


def device_window_us(trace_root: str) -> float:
    """The time (us) from the newest trace's first device work (kernel,
    copy or fill) to the end of its last, gaps included; 0 without device
    work. Beside ``kernel_busy_us`` it gives the device's idle share over
    the whole traced window, between the spans as well as inside them."""
    work = _device_work(trace_root)
    if not work:
        return 0.0
    return (max(float(e['ts']) + float(e['dur']) for e in work)
            - min(float(e['ts']) for e in work))


def span_gaps_us(trace_root: str, name: str) -> List[float]:
    """The gaps (us) between consecutive device-lane spans ``name`` of the
    newest trace, in start order: each span's start less the end of the one
    before (negative where they overlap)."""
    spans = [e for e in _device_spans(trace_root) if e['name'] == name]
    return [float(b['ts']) - float(a['ts']) - float(a['dur'])
            for a, b in zip(spans, spans[1:])]


def start_trace(profile_dir: str, device, rank: Optional[int] = None):
    """Start ``torch.profiler`` (CPU activity, and CUDA activity when
    ``device`` is a card) for a trace that ``stop_trace`` writes into
    ``profile_dir``; ``rank`` (under a mesh) goes into the file name. On
    a card it returns after ``PRIME_S`` of priming kernels."""
    if _ACTIVE:
        raise RuntimeError('a trace is already running: {0}'.format(
            _ACTIVE['path']))
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    now = time.time()
    name = 'trace_{0}_{1:06d}{2}.pt.trace.json.gz'.format(
        time.strftime('%Y%m%d_%H%M%S', time.localtime(now)),
        int(now % 1 * 1e6), '' if rank is None else '_rank{0}'.format(rank))
    # one recording cycle per trace: nothing to clear between cycles
    prof = torch.profiler.profile(activities=activities, acc_events=True)
    prof.start()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        end = time.perf_counter() + PRIME_S
        while time.perf_counter() < end:
            torch.cuda._sleep(PRIME_CYCLES)
            torch.cuda.synchronize(device)
    _ACTIVE.update(prof=prof, device=device,
                   path=os.path.join(profile_dir, name))


def stop_trace() -> str:
    """Wait for the device, stop the running trace and write it; returns
    the file's path."""
    if not _ACTIVE:
        raise RuntimeError('no trace is running')
    prof, device, path = (_ACTIVE.pop(k) for k in ('prof', 'device', 'path'))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    prof.stop()
    plain = path[:-len('.gz')]
    prof.export_chrome_trace(plain)
    with open(plain, 'rb') as fin, gzip.open(path, 'wb') as fout:
        shutil.copyfileobj(fin, fout)
    os.remove(plain)
    return path


def traced_device_ms(fn: Callable[[], None], n_rep: int,
                     tag: str) -> Optional[float]:
    """Run ``fn`` ``n_rep`` times under the profiler (with the current
    card's activity when there is a card), each call inside
    ``record_function(tag)``; return the device-busy ms per repetition,
    or None when the trace has no device lane (on the CPU). A profiler
    error raises."""
    device = (torch.device('cuda', torch.cuda.current_device())
              if torch.cuda.is_available() else torch.device('cpu'))
    with tempfile.TemporaryDirectory(prefix='fplx_trace_' + tag) as trace_dir:
        start_trace(trace_dir, device)
        try:
            for _ in range(n_rep):
                with torch.profiler.record_function(tag):
                    fn()
        finally:
            stop_trace()
        if not module_events_us(trace_dir):
            return None
        return device_busy_us(trace_dir) / n_rep / 1e3
