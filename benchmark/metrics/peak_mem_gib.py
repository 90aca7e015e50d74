"""The allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``, reset when the run starts)."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2.0 ** 30
