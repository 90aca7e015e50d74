"""The label save's host time: the mean of the program's ``save_outputs``
spans (the source's geometry decode, the label's NIfTI encode and write)
that start in the host-lane counterpart of the slice (ms a saved volume).
None where the program has no such span or saves nothing."""
from benchmark.harness.stall import host_sum


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test':
        return None
    total = host_sum(t, 'save_outputs')
    if total is None or total[1] == 0:
        return None
    return total[0] / total[1] / 1e3
