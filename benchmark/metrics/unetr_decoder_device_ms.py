"""Swin UNETR's convolutional decoder in one forward: the mean duration of
the program's ``unetr_decoder`` device-lane spans (the residual blocks on
the input and the hidden states, the up path and the head) that start in
the slice (ms). None where the program has no such span."""
from benchmark.harness.trace import mean


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    m = mean(e['dur'] for e in t.in_slice(t.device_spans('unetr_decoder')))
    return None if m is None else m / 1e3
