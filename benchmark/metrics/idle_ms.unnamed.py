"""The card idle while the host was in no program span: the slice's idle
gaps that launch correlation (``harness/stall.py``) names after no span,
per volume (ms). None where the program lacks the test stage's boundary
spans (``test_loader_wait``, ``infer_fetch``), without which most of the
host's time is in no span."""
from benchmark.harness.stall import has_host_span, idle_ms


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test' or not all(
            has_host_span(t, n) for n in ('test_loader_wait', 'infer_fetch')):
        return None
    return idle_ms(t, [None])
