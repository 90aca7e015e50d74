"""Swin UNETR's transformer encoder in one forward: the mean duration of
the program's ``swin_vit`` device-lane spans (the patch embedding through
the last hidden state's norm) that start in the slice (ms). None where the
program has no such span."""
from benchmark.harness.trace import mean


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    m = mean(e['dur'] for e in t.in_slice(t.device_spans('swin_vit')))
    return None if m is None else m / 1e3
