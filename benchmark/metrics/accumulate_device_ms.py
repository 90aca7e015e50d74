"""The sliding window's accumulation on the card: the summed duration of
the program's ``infer_accumulate`` device-lane spans (each chunk's overlap
adds) that start in the slice, per volume (ms). None where the program
has no such span."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    spans = t.device_spans('infer_accumulate')
    if not spans:
        return None
    return sum(e['dur'] for e in t.in_slice(spans)) / t.periods / 1e3
