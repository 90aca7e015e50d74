"""The test stage's host blocked on the card: the summed host time of the
program's ``infer_fetch`` spans (the fetch's wait on its event and the
result's formatting) that start in the host-lane counterpart of the
slice, per volume (ms). None where the program has no such span."""
from benchmark.harness.stall import host_ms_per_period


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test':
        return None
    return host_ms_per_period(t, 'infer_fetch')
