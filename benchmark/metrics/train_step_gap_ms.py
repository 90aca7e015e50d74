"""The training loop's time outside the step: the mean host-lane gap
between consecutive ``train_step`` ranges that start in the slice (the
wait for the next batch, its copy to the card and the loop's
bookkeeping), ms."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    host = t.host_spans('train_step')
    lo, hi = t.host_bounds('train_step')
    gaps = [b['ts'] - a['ts'] - a['dur'] for a, b in zip(host, host[1:])
            if lo <= a['ts'] < hi]
    if not gaps:
        return None
    return sum(gaps) / len(gaps) / 1e3
