"""Device operations (kernels, copies, sets) that one entry call puts on
the cards, summed over the cards: the launches that the entry point, the
``ops`` wrappers and the benchmark's own draw and keep issue a call, each
a cost of the host and a gap on the device.  From the traced window's
device events, over the calls it completed."""


def read(ctx):
    if ctx.trace is None or not ctx.window.calls:
        return None
    t = ctx.trace
    count = sum(1 for i in t.indices for _, s, _ in t.events[i]
                if t.open_ns <= s < t.close_ns)
    return count / ctx.window.calls if count else None
