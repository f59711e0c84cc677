"""Arithmetic shared by the metric readers in ``metrics/``."""

from perfbench.census import PEAK_F32_FLOPS, bound_s


def kernel_roofline(ctx, match, ops, n_bytes):
    """A kernel's share of its roofline in %: the census's least time of
    one launch (``ops`` operations, ``n_bytes`` bytes, on one card) times
    the launches the trace holds, over their summed device time.  None
    without a trace or without a launch of the kernel."""
    if ctx.trace is None:
        return None
    events = ctx.trace.kernel_events(match)
    device_s = sum(e - s for _, s, e in events) / 1e9
    if not events or device_s <= 0:
        return None
    return 100.0 * len(events) * bound_s(ops, n_bytes) / device_s


def mfu(ctx):
    """The window's share of the cards' float32 peak in %: the census's
    operations of every member-day completed over the window's length and
    the cards' peak."""
    ops = ctx.window.work * ctx.run.member_day_ops()
    return 100.0 * ops / (ctx.window.seconds * PEAK_F32_FLOPS * ctx.chips)


def idle_share(ctx):
    """1 - device busy / window, averaged over the cell's cards."""
    if ctx.trace is None:
        return None
    return 1.0 - ctx.trace.busy_mean_s() / ctx.trace.window_s
