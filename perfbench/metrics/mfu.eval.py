"""The whole window's share of the cards' float32 peak, in %: the census's
operations of the member-days completed over the window and the cards."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
