"""The card waiting on the test stage's host between volumes: the device
time between consecutive ``infer_run`` device spans in the slice, summed
and divided by the slice's volumes (ms)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.unit != 'infer_run':
        return None
    spans = t.device_spans('infer_run')
    gaps = [b['ts'] - a['ts'] - a['dur'] for a, b in zip(spans, spans[1:])
            if t.start <= a['ts'] < t.end]
    if not gaps:
        return None
    return max(sum(gaps), 0.0) / t.periods / 1e3
