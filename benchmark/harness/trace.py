"""The traced slice: ``torch.profiler`` started and primed on the card,
and the reading of its chrome trace.

Frozen from the program's ``utils/trace_metrics.py`` (its priming and its
union and span arithmetic), so that a later change to the program cannot
move the yardstick: a trace can lose the events of its first kernel
launches, so the start waits ``PRIME_S`` on the card with short sleep
kernels, each waited for, and the readings skip them.

The slice is a whole number of periods of the cell's unit of work: from
the start of the second device-lane span of the unit (``infer_run``,
``train_step``, ...) to the start of the last one. Every reading is over
that slice: device work clipped to it, spans that start in it.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

import torch

PRIME_S = 0.05
PRIME_CYCLES = 20000
PRIME_KERNEL = 'spin_kernel'        # torch.cuda._sleep's kernel
DEVICE_LANE = 'gpu_user_annotation'
HOST_LANE = 'user_annotation'
DEVICE_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Profiler:
    """Start and stop of one traced slice; ``events()`` after the stop."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.launches = None

    def start(self, launches: int = 0):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, acc_events=True)
        self.prof.start()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
            end = time.perf_counter() + PRIME_S
            while time.perf_counter() < end:
                torch.cuda._sleep(PRIME_CYCLES)
                torch.cuda.synchronize(self.device)
        self.launches = [launches, None]

    @property
    def running(self) -> bool:
        return self.launches is not None and self.launches[1] is None

    def stop(self, launches: int = 0):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.launches[1] = launches

    def events(self, path: str) -> List[dict]:
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get('traceEvents', [])


def union(intervals) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and merged."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class TraceView:
    """The events of one trace, read over the slice of ``unit`` spans."""

    def __init__(self, events: List[dict], unit: str):
        xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        for e in xs:
            e['ts'], e['dur'] = float(e['ts']), float(e['dur'])
        prime = [e['ts'] + e['dur'] for e in xs
                 if e.get('cat') == 'kernel' and PRIME_KERNEL in e['name']]
        self.prime_end = max(prime) if prime else float('-inf')
        self.events = [e for e in xs if e['ts'] >= self.prime_end
                       or e.get('cat') not in DEVICE_WORK]
        self.unit = unit
        units = self.device_spans(unit)
        self.periods = max(len(units) - 2, 0)
        if self.periods:
            self.start, self.end = units[1]['ts'], units[-1]['ts']
        else:
            self.start = self.end = 0.0

    @property
    def length_us(self) -> float:
        return self.end - self.start

    def device_spans(self, name: str) -> List[dict]:
        return sorted((e for e in self.events if e.get('cat') == DEVICE_LANE
                       and e['name'] == name and e['ts'] >= self.prime_end),
                      key=lambda e: e['ts'])

    def host_spans(self, name: str) -> List[dict]:
        return sorted((e for e in self.events if e.get('cat') == HOST_LANE
                       and e['name'] == name), key=lambda e: e['ts'])

    def host_bounds(self, name: str) -> Tuple[float, float]:
        """The host-lane counterpart of the slice: from the start of the
        second host range ``name`` to the start of the last."""
        host = self.host_spans(name)
        if len(host) < 3:
            return 0.0, 0.0
        return host[1]['ts'], host[-1]['ts']

    def in_slice(self, spans: List[dict]) -> List[dict]:
        return [e for e in spans if self.start <= e['ts'] < self.end]

    def work(self, cats=DEVICE_WORK) -> List[dict]:
        """Device events of ``cats`` that overlap the slice."""
        return [e for e in self.events if e.get('cat') in cats
                and e['ts'] < self.end and e['ts'] + e['dur'] > self.start]

    def kernels_in_slice(self) -> List[dict]:
        """Kernels that start in the slice."""
        return [e for e in self.events if e.get('cat') == 'kernel'
                and self.start <= e['ts'] < self.end]

    def busy_us(self) -> float:
        return sum(b - a for a, b in clip(
            union((e['ts'], e['ts'] + e['dur']) for e in self.work()),
            self.start, self.end))

    def idle_gaps(self) -> List[Tuple[float, float]]:
        busy = clip(union((e['ts'], e['ts'] + e['dur'])
                          for e in self.work()), self.start, self.end)
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def count_kernels(self, names) -> int:
        """Kernels (after the priming) whose name holds one of ``names``."""
        return sum(1 for e in self.events if e.get('cat') == 'kernel'
                   and any(n in e['name'] for n in names))

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations with most time in the slice, and the
        longest idle gaps named by the host activity at their middle (the
        shortest host range that holds it)."""
        per: Dict[str, float] = {}
        for e in self.kernels_in_slice():
            per[e['name']] = per.get(e['name'], 0.0) + e['dur'] / 1e6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        host = [e for e in self.events
                if e.get('cat') in (HOST_LANE, 'cpu_op', 'python_function')]
        gaps = sorted(self.idle_gaps(), key=lambda ab: ab[0] - ab[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            holding = [e for e in host if e['ts'] <= mid <= e['ts']
                       + e['dur']]
            name = (min(holding, key=lambda e: e['dur'])['name']
                    if holding else 'host: outside torch ops')
            named.append([name, (b - a) / 1e6])
        return {'device_ops': [[k, v] for k, v in ops], 'idle_gaps': named}


def check_events(view: TraceView, names, launched: int) -> None:
    """Raise when the trace holds fewer kernel events named ``names`` than
    the program counted launches of them while it ran: the profiler lost
    events, and every reading of the slice would be short."""
    seen = view.count_kernels(names)
    if seen < launched:
        raise RuntimeError('the trace lost kernel events: {0} of {1} '
                           'launches have an event'.format(seen, launched))


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
