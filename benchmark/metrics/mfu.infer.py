"""The whole served volume's share of the card's dense peak (%): the
volumes' operations in the slice (2 x the convolutions' MACs of every
window forward, ``work_per_window``) over the slice's time and the
published peak of the type the convolutions run in (TF32 for float32
while cuDNN may use it)."""


def read(ctx):
    t = ctx.trace
    if t is None or ctx.stage != 'test' or ctx.peak_flops() is None:
        return None
    flops = ctx.work['flops_per_item'] * t.periods
    return 100.0 * flops / (t.length_us / 1e6) / ctx.peak_flops()
