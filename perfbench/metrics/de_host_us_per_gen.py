"""Microseconds of host work a differential-evolution generation: the
mean length of the program's ``de.generation`` spans less the ``sync``
spans inside them (the proposal's bookkeeping, the objective's wrapper and
its launch, the convergence test's own work; not the waits)."""

from perfbench.program_spans import host_us_per_generation


def read(ctx):
    return host_us_per_generation(ctx)
