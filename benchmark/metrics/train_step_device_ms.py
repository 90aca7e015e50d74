"""The train step's device time: the mean duration of the ``train_step``
device spans that start in the slice (ms)."""
from benchmark.harness.trace import mean


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    m = mean(e['dur'] for e in t.in_slice(t.device_spans('train_step')))
    return None if m is None else m / 1e3
