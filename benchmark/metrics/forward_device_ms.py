"""One network forward's device time in the inference engine: the mean
duration of the program's ``infer_forward`` device-lane spans that start
in the slice (ms). None where the program has no such span."""
from benchmark.harness.trace import mean


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    m = mean(e['dur'] for e in t.in_slice(t.device_spans('infer_forward')))
    return None if m is None else m / 1e3
