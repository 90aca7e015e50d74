"""Iterations of the agent's training loop completed in the window over
the window's whole time, the loader's waits included."""


def read(ctx):
    if ctx.stage != 'train':
        return None
    return ctx.items / ctx.window_s
