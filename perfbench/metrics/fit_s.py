"""Seconds a calibration: the window's host-clock length over the fits it
completed."""


def read(ctx):
    return ctx.window.seconds / ctx.window.calls
