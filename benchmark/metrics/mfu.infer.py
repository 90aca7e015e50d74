"""The whole served volume's share of the card's dense peak (%): the
volumes' operations in the slice (2 x the MACs of every window forward,
by class of work, from the configuration's reference ``work_per_window``)
over the slice's time, each class over the published peak of the type it
runs in (at float32: TF32 for convolutions while cuDNN may use it, for
matrix products while cuBLAS may)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test' or ctx.peaks is None:
        return None
    seconds = t.length_us / 1e6
    return sum(100.0 * (flops * t.periods) / seconds / ctx.peak_flops(kind)
               for kind, flops in ctx.work['flops_by_class'].items())
