"""The share of the slice in which no kernel, copy or fill ran on the
card (%), in a training cell."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'train':
        return None
    return 100.0 * (1.0 - t.busy_us() / t.length_us)
