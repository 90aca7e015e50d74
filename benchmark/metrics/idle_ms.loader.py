"""The card idle while the test stage's host waited on its loader: the
slice's idle gaps named ``test_loader_wait`` by launch correlation
(``harness/stall.py``), per volume (ms). None where the program has no
such span."""
from benchmark.harness.stall import has_host_span, idle_ms


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test' \
            or not has_host_span(t, 'test_loader_wait'):
        return None
    return idle_ms(t, ['test_loader_wait'])
