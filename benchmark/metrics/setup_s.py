"""Seconds from the process's start to the first timed unit of work:
workspace, weights, the program's set-up and the warm-up."""


def read(ctx):
    return ctx.setup_s
