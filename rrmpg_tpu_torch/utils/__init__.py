"""Utility subpackage: metrics, signatures and input validation."""

from .array_checks import check_for_negatives, validate_array_input
from .metrics import (
    nse, mse, rmse, kge, alpha_nse, beta_nse, pearson_r,
    calc_nse, calc_mse, calc_rmse, calc_kge, calc_alpha_nse, calc_beta_nse,
    calc_r, calibration_loss,
)
from .signatures import (
    fdc_fhv, fdc_flv, fdc_fms, flashiness, runoff_ratio,
)
