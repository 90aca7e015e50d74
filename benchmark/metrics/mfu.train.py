"""The whole training step's share of the card's dense peak (%): 3 x 2 x
the MACs of a window forward (forward and backward, no recomputation) per
crop, the crops of every domain, times the steps in the slice, over the
slice's time, each class of work over the peak of the type it runs in
(``mfu.infer``)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'train' or ctx.peaks is None:
        return None
    seconds = t.length_us / 1e6
    return sum(100.0 * (flops * t.periods) / seconds / ctx.peak_flops(kind)
               for kind, flops in ctx.work['flops_by_class'].items())
