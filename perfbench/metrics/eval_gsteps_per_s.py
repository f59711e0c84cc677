"""Member-days evaluated (over every catchment) by the calls completed in
the window, in 10^9 a second of the window's host-clock length."""


def read(ctx):
    return ctx.window.work / ctx.window.seconds / 1e9
