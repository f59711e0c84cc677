"""(max - min) / max of the cards' busy seconds in the traced window: how
evenly the mesh splits the work."""


def read(ctx):
    if ctx.trace is None or len(ctx.trace.indices) < 2:
        return None
    busy = [ctx.trace.busy_s(i) for i in ctx.trace.indices]
    return (max(busy) - min(busy)) / max(busy) if max(busy) > 0 else None
