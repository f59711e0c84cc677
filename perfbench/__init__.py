"""The benchmark of ``rrmpg_tpu_torch``, the port's PyTorch and CUDA package.

``run.py`` runs one cell of ``BENCHMARK.json``; what belongs to one
configuration, traffic mix, cell or metric sits in a file of its own that
the harness finds by name (see ``harness.py``).
"""
