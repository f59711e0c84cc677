"""Cemaneige snow-routine interface class (Valery 2010).

Counterpart of ``rrmpg_tpu.models.cemaneige.Cemaneige``: same parameters,
bounds, structured dtype, ``simulate``/``fit`` signatures, validation errors
and output shapes ((T, N) outflow, (T, L, N) storages), with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch (:mod:`..ops.cemaneige`);
* ``'fused'`` -- the snow-only mode of the hand-written CUDA kernels K8 /
  K9 (:mod:`..ops.fused_snow`) for CUDA tensors; on the CPU their plain
  versions.

Forecast mode (``initial_state`` / ``return_final_state``) waits for the
state bundles.
"""

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, DEFAULT_DTYPE
from ..ops.cemaneige import run_cemaneige
from ..ops.fused_snow import (
    cemaneige_ensemble_mse_fused,
    cemaneige_simulate_fused,
)
from ..utils.array_checks import validate_array_input
from ..utils.metrics import calibration_loss
from ._snow_base import (
    CemaneigeBase,
    _check_return_storage,
    _no_forecast_state,
    _no_mesh,
    stats_objective,
)
from .basemodel import check_engine


class Cemaneige(CemaneigeBase):
    """Interface to the Cemaneige snow accounting model."""

    _param_list = ['CTG', 'Kf']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=DEFAULT_DTYPE):
        super().__init__(params=params, device=device, dtype=dtype)

    def _prepare(self, prec, mean_temp, min_temp, max_temp,
                 met_station_height, altitudes, snow_pack_init,
                 thermal_state_init):
        """Validated layer forcing as tensors on the model's device, and
        the two initial states."""
        prec, mean_temp, frac_solid_prec, _, _ = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes)
        return (self._tensor(prec), self._tensor(mean_temp),
                self._tensor(frac_solid_prec),
                self._validate_number(snow_pack_init, 'snow_pack_init'),
                self._validate_number(thermal_state_init,
                                      'thermal_state_init'))

    def simulate(self, prec, mean_temp, min_temp, max_temp,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 altitudes=[], return_storages=False, params=None,
                 mesh=None, engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate the Cemaneige snow routine.

        Args:
            prec: (T,) daily precipitation sum [mm].
            mean_temp, min_temp, max_temp: (T,) daily temperatures [C].
            met_station_height: station elevation [m].
            snow_pack_init: (optional) initial snow pack storage.
            thermal_state_init: (optional) initial snowpack thermal state.
            altitudes: (optional) list of median layer elevations [m]; if
                given, forcings are extrapolated per elevation layer.
            return_storages: also return snowpack G and thermal state eTG
                ('scan' only).
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K9 in
                its snow-only mode, outflow only).

        Returns:
            outflow (T, N); plus G (T, L, N) and eTG (T, L, N) if
            ``return_storages``; tensors on the model's device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If there is a size mismatch between
                meteorological input arrays.
        """
        prec, mean_temp, frac_solid_prec, snow0, th0 = self._prepare(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, snow_pack_init, thermal_state_init)
        _check_return_storage(return_storages, 'return_storages')
        check_engine(engine)
        _no_mesh(mesh)
        _no_forecast_state(initial_state, return_final_state)

        param_dict, _ = self._prepare_params(params)
        if engine == "fused":
            if return_storages:
                raise ValueError(
                    "engine='fused' computes the outflow only; use "
                    "engine='scan' for storage trajectories.")
            return cemaneige_simulate_fused(prec, mean_temp, frac_solid_prec,
                                            snow0, th0, param_dict).T
        outflow, G, eTG = run_cemaneige(prec, mean_temp, frac_solid_prec,
                                        snow0, th0, param_dict)
        if return_storages:
            return outflow.T, G.permute(1, 2, 0), eTG.permute(1, 2, 0)
        return outflow.T

    def fit(self, obs, prec, mean_temp, min_temp, max_temp,
            met_station_height, snow_pack_init=0, thermal_state_init=0,
            altitudes=[], loss_metric="mse", seed=None, engine="scan",
            initial_state=None, **de_kwargs):
        """Calibrate CTG/Kf on an observed outflow series with differential
        evolution on the model's device.

        Args:
            obs: observed outflow; NaN marks a gap.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            engine: 'scan', or 'fused' to evaluate every DE generation with
                one launch of K8 in its snow-only mode.
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize`.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        check_engine(engine)
        _no_forecast_state(initial_state, False)
        loss = calibration_loss(loss_metric)
        qobs = self._tensor(validate_array_input(obs, np.float64, 'obs'))
        prec, mean_temp, frac_solid_prec, snow0, th0 = self._prepare(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, snow_pack_init, thermal_state_init)

        if engine == "fused":
            masked = bool(torch.isnan(qobs).any())
            fused_loss = stats_objective(
                lambda params, stats: cemaneige_ensemble_mse_fused(
                    prec, mean_temp, frac_solid_prec, qobs, snow0, th0,
                    params, stats=stats, masked=masked),
                qobs, loss_metric)

            def objective(X):
                return fused_loss(self._candidates(X))
        else:
            def objective(X):
                outflow, _, _ = run_cemaneige(
                    prec, mean_temp, frac_solid_prec, snow0, th0,
                    self._candidates(X))
                return loss(qobs[None, :], outflow, dim=-1)

        return self._minimize(objective, seed, de_kwargs)
