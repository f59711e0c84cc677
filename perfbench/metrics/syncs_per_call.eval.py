"""The host's waits for a card (a read back, a pageable copy) a call: the
program's ``sync`` spans of the traced window over its calls.  Each sync
site of the program counts one (``rrmpg_tpu_torch.utils.tracing.sync``)."""

from perfbench.program_spans import syncs_per_call


def read(ctx):
    return syncs_per_call(ctx)
