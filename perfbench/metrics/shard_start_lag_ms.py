"""How late the last shard of a mesh call starts on its card after the
first: per call, the latest device start of K5 (``gr4j_regional_kernel``)
among the call's shards less the earliest, in ms, averaged over the calls.
Each of the program's ``mesh.shard`` spans on a card is paired with that
card's K5 launches in order."""

from perfbench.program_spans import shard_start_lag_ms


def read(ctx):
    return shard_start_lag_ms(ctx, "gr4j_regional_kernel<")
