"""The share of the traced window in which no operation ran on a card,
averaged over the cell's cards."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
