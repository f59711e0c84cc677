"""Seconds from the process's start to the window's: imports, the card's
start, the inputs, the kernel library (built on a checkout's first run)
and the warm-up call."""


def read(ctx):
    return ctx.setup_s
