"""Batched model kernels: plain PyTorch (``'scan'``) and the fused CUDA
kernels' wrappers (``'fused'``).  Every function takes a leading member
axis on its parameters."""

from ._launch import LAUNCHES, reset_launches
from .abc import run_abcmodel, run_abcmodel_pscan, run_abcmodel_warm
from .cemaneige import (
    run_cemaneige,
    run_cemaneige_warm,
    run_cemaneigehyst,
    run_cemaneigehyst_warm,
    run_icemelt,
)
from .compositions import (
    run_cemaneigegr4j,
    run_cemaneigegr4j_warm,
    run_cemaneigegr4jice,
    run_cemaneigehystgr4j,
    run_cemaneigehystgr4j_warm,
    run_cemaneigehystgr4jice,
)
from .fused_abc import abc_fused, abc_fused_single
from .fused_gr4j import (
    SUPPORTED_UH,
    gr4j_ensemble_mse_fused,
    gr4j_regional_objective_fused,
    gr4j_simulate_fused,
)
from .fused_hbv import hbv_ensemble_mse_fused, hbv_simulate_fused
from .fused_snow import (
    cemaneige_ensemble_mse_fused,
    cemaneige_simulate_fused,
    q_sca_components_from_stats,
    q_sca_loss_from_stats,
    snowgr4j_ensemble_mse_fused,
    snowgr4j_regional_mse_fused,
    snowgr4j_simulate_fused,
)
from .gr4j import GR4JState, gr4j_initial_state, run_gr4j, run_gr4j_warm
from .hbvedu import run_hbvedu, run_hbvedu_warm
from .met import (
    calculate_solid_fraction,
    extrapolate_precipitation,
    extrapolate_temperature,
)
from .stats import losses_from_stats
from .uh import NUM_UH1, NUM_UH2, causal_fir, required_uh_lengths, uh_ordinates
