"""Batched model kernels: plain PyTorch (``'scan'``) and the fused CUDA
kernels' wrappers (``'fused'``).  Every function takes a leading member
axis on its parameters."""

from .fused_gr4j import (
    LAUNCHES,
    SUPPORTED_UH,
    gr4j_ensemble_mse_fused,
    gr4j_simulate_fused,
    reset_launches,
)
from .gr4j import GR4JState, run_gr4j, run_gr4j_warm
from .stats import losses_from_stats
from .uh import NUM_UH1, NUM_UH2, causal_fir, required_uh_lengths, uh_ordinates
