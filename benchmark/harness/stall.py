"""The card's idle gaps named by the host's program spans, through launch
correlation rather than timestamps.

A trace's device clock can drift from its host clock by up to 0.6% of the
trace, so a gap placed on the host by its device timestamps can land in
the wrong host span late in a slice. The rule here compares no host time
with a device time:

* a gap in the slice is ended by the device event (kernel, copy or fill)
  that starts at its end; the CUDA API call that launched that event
  (``LAUNCH_CATS``) carries the same ``args.correlation``;
* the host interval of the gap's length that ends at that call's start is
  what the host did while the card waited;
* the gap is named after the program span (a ``record_function`` range on
  the host lane, on the launching thread) that covers most of that
  interval, the innermost of equals; a gap that no program span covers,
  or whose launch call the trace lacks, is unnamed (None).

Gap lengths are device durations and the interval is placed by a host
timestamp alone.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import DEVICE_WORK, HOST_LANE, TraceView

LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
# how far before a gap's end (us) the event that ends it may start (at
# most half the gap): the slice's end is a device span's start, written
# from the same event
_EDGE_US = 0.5


def _correlation(e: dict) -> Optional[int]:
    return (e.get('args') or {}).get('correlation')


def _cover(a: float, b: float, e: dict) -> float:
    return max(0.0, min(b, e['ts'] + e['dur']) - max(a, e['ts']))


def gap_causes(view: TraceView) -> List[Tuple[Optional[str], float]]:
    """``(span name or None, gap us)`` for each idle gap of the slice, in
    order. Computed once a view."""
    cached = getattr(view, '_gap_causes', None)
    if cached is not None:
        return cached
    device = sorted((e for e in view.events if e.get('cat') in DEVICE_WORK),
                    key=lambda e: e['ts'])
    launches: Dict[int, dict] = {}
    for e in view.events:
        if e.get('cat') in LAUNCH_CATS and _correlation(e) is not None:
            launches[_correlation(e)] = e
    spans = sorted((e for e in view.events if e.get('cat') == HOST_LANE),
                   key=lambda e: e['ts'])
    starts = [e['ts'] for e in spans]
    longest = max((e['dur'] for e in spans), default=0.0)
    out = []
    k = 0
    for a, b in view.idle_gaps():
        edge = b - min(_EDGE_US, (b - a) / 2)
        while k < len(device) and device[k]['ts'] < edge:
            k += 1
        call = (launches.get(_correlation(device[k])) if k < len(device)
                else None)
        name = None
        if call is not None:
            hi = call['ts']
            lo = hi - (b - a)
            best = (0.0, 0.0)
            for s in spans[bisect.bisect_left(starts, lo - longest):
                           bisect.bisect_left(starts, hi)]:
                if s.get('tid') != call.get('tid'):
                    continue
                covered = _cover(lo, hi, s)
                if covered > 0 and (covered, -s['dur']) > best:
                    best, name = (covered, -s['dur']), s['name']
        out.append((name, b - a))
    view._gap_causes = out
    return out


def has_host_span(view: TraceView, name: str) -> bool:
    return any(e.get('cat') == HOST_LANE and e['name'] == name
               for e in view.events)


def idle_ms(view: TraceView, names) -> float:
    """The slice's idle time named by one of ``names`` (None: unnamed),
    per period, in ms."""
    names = set(names)
    return sum(us for name, us in gap_causes(view)
               if name in names) / view.periods / 1e3


def host_ms_per_period(view: TraceView, name: str) -> Optional[float]:
    """The summed host time (ms) of the ranges ``name`` that start in the
    host-lane counterpart of the slice, per period; None without such a
    range in the trace."""
    total = host_sum(view, name)
    return None if total is None else total[0] / view.periods / 1e3


def host_sum(view: TraceView, name: str) -> Optional[Tuple[float, int]]:
    """``(summed us, count)`` of the host ranges ``name`` that start in the
    host-lane counterpart of the slice (``TraceView.host_bounds`` of the
    unit); None when the trace has no range ``name``."""
    if not has_host_span(view, name):
        return None
    lo, hi = view.host_bounds(view.unit)
    ranges = [e for e in view.host_spans(name) if lo <= e['ts'] < hi]
    return sum(e['dur'] for e in ranges), len(ranges)
