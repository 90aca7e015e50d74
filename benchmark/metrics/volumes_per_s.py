"""Volumes finished in the window (a label file written, or an FPL
uncertainty recorded) over the window's whole time."""


def read(ctx):
    if ctx.stage != 'test':
        return None
    return ctx.items / ctx.window_s
