"""The share of the traced window in which the card idles while the host
waits in one of the program's ``sync`` spans (a read back, a pageable
copy)."""

from perfbench.program_spans import idle_in_syncs


def read(ctx):
    return idle_in_syncs(ctx)
