"""The whole training step's share of the card's dense peak (%): 3 x 2 x
the convolutions' MACs of a window forward (forward and backward, no
recomputation) per crop, the crops of every domain, times the steps in
the slice, over the slice's time and the peak of the type the
convolutions run in."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'train' or ctx.peak_flops() is None:
        return None
    flops = ctx.work['flops_per_item'] * t.periods
    return 100.0 * flops / (t.length_us / 1e6) / ctx.peak_flops()
