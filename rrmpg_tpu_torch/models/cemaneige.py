"""Cemaneige snow-routine interface class (Valery 2010).

Counterpart of ``rrmpg_tpu.models.cemaneige.Cemaneige``: same parameters,
bounds, structured dtype, ``simulate``/``fit`` signatures, validation errors
and output shapes ((T, N) outflow, (T, L, N) storages), with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch (:mod:`..ops.cemaneige`);
* ``'fused'`` -- the snow-only mode of the hand-written CUDA kernels K8 /
  K9 (:mod:`..ops.fused_snow`) for CUDA tensors; on the CPU their plain
  versions.

Forecast mode (``return_final_state`` / ``initial_state``, a
:class:`~.states.CemaneigeState`) runs on the ``'scan'`` engine only, in
``simulate`` and in ``fit``.  The state carries the snow-cover threshold of
the series that produced it; a continuation uses that, not one of its own
forcing.
"""

import numpy as np
import torch

from ..config import DEFAULT_DEVICE
from ..ops._launch import valid_count
from ..parallel.mesh import check_mesh
from ..ops.cemaneige import run_cemaneige, run_cemaneige_warm
from ..ops.fused_snow import (
    cemaneige_ensemble_mse_fused,
    cemaneige_simulate_fused,
)
from ..utils.array_checks import validate_array_input
from ..utils.metrics import calibration_loss
from ._snow_base import (
    CemaneigeBase,
    _check_return_storage,
    stats_objective,
)
from .basemodel import check_engine, check_fused_mesh
from .states import CemaneigeState, broadcast_state, check_state_type

_INIT_NAMES = ('snow_pack_init', 'thermal_state_init')


class Cemaneige(CemaneigeBase):
    """Interface to the Cemaneige snow accounting model."""

    _param_list = ['CTG', 'Kf']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=None):
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
            mesh: (optional) :class:`~..parallel.mesh.Mesh`; the
                members (and a warm state) are split over its 'ensemble'
                axis, ``engine='scan'`` only.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K9 in
                its snow-only mode, outflow only, cold starts only,
                single-device).
            initial_state: (optional) :class:`~.states.CemaneigeState`
                from a previous ``return_final_state=True`` call;
                continues that simulation (``engine='scan'`` only).
                Mutually exclusive with non-zero ``*_init`` scalars.
            return_final_state: also return the end-of-series
                :class:`~.states.CemaneigeState` (member axis leading).

        Returns:
            outflow (T, N); plus G (T, L, N) and eTG (T, L, N) if
            ``return_storages``; plus the final state if
            ``return_final_state``; tensors on the model's device.

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
        check_mesh(mesh)
        self._check_no_cold_inits(initial_state, (snow0, th0), _INIT_NAMES)

        param_dict, num = self._prepare_params(params)
        forcing = (prec, mean_temp, frac_solid_prec)
        if initial_state is not None or return_final_state:
            self._check_stateful_supported(engine)
            if initial_state is None:
                *series, final = self._ensemble(
                    _cold_final, (*forcing, snow0, th0), param_dict, mesh)
            else:
                state = self._warm_state(initial_state, prec.shape[1], num)
                *series, final = self._ensemble(_warm_final, forcing,
                                                param_dict, mesh, state=state)
            return self._stateful_output(
                self._to_reference_layout(series), final, return_storages,
                return_final_state)
        if engine == "fused":
            check_fused_mesh(mesh)
            if return_storages:
                raise ValueError(
                    "engine='fused' computes the outflow only; use "
                    "engine='scan' for storage trajectories.")
            return cemaneige_simulate_fused(prec, mean_temp, frac_solid_prec,
                                            snow0, th0, param_dict).T
        outflow, G, eTG = self._ensemble(run_cemaneige, (*forcing, snow0, th0),
                                         param_dict, mesh)
        if return_storages:
            return outflow.T, G.permute(1, 2, 0), eTG.permute(1, 2, 0)
        return outflow.T

    def _warm_state(self, initial_state, num_layers, num=None):
        """A checked ``initial_state``: batched over ``num`` members, or
        (``num=None``) the single shared state of a calibration."""
        check_state_type(initial_state, CemaneigeState, type(self).__name__)
        state = (self._single_member_state(initial_state) if num is None
                 else self._normalize_state(initial_state, num))
        self._check_layers(state.g.shape[-1], num_layers)
        return state

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
            initial_state: (optional) single-member
                :class:`~.states.CemaneigeState`: calibrate a continuation
                segment from a known initial condition (``engine='scan'``
                only).
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize` and on to
                ``differential_evolution``: ``key``, ``popsize``, ``maxiter``,
                ``tol``, ``checkpoint_path`` / ``checkpoint_every`` /
                ``resume_from`` (``*.npz`` or a directory), ``polish`` /
                ``polish_steps`` (skipped, with a note in the message, on the
                fused kernels, which have no backward); ``mesh`` /
                ``mesh_axis`` (each generation's population split over the
                mesh).

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        check_engine(engine)
        loss = calibration_loss(loss_metric)
        qobs = self._tensor(validate_array_input(obs, np.float64, 'obs'))
        prec, mean_temp, frac_solid_prec, snow0, th0 = self._prepare(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, snow_pack_init, thermal_state_init)
        self._check_no_cold_inits(initial_state, (snow0, th0), _INIT_NAMES)

        state = None
        if initial_state is not None:
            if engine != "scan":
                raise ValueError(
                    "fit(initial_state=) supports engine='scan' only.")
            state = self._warm_state(initial_state, prec.shape[1])

        def build(qobs, prec, mean_temp, frac_solid_prec, state):
            """The objective over tensors on one device."""
            if state is not None:
                def objective(X):
                    st = broadcast_state(state, X.shape[0])
                    outflow = run_cemaneige_warm(
                        prec, mean_temp, frac_solid_prec, (st.g, st.etg),
                        st.g_thresh, self._candidates(X))[0]
                    return loss(qobs[None, :], outflow, dim=-1)
                return objective
            if engine == "fused":
                masked = bool(torch.isnan(qobs).any())
                count = valid_count(qobs, masked)
                fused_loss = stats_objective(
                    lambda params, stats: cemaneige_ensemble_mse_fused(
                        prec, mean_temp, frac_solid_prec, qobs, snow0, th0,
                        params, stats=stats, masked=masked, count=count),
                    qobs, loss_metric)
                return lambda X: fused_loss(self._candidates(X))

            def objective(X):
                outflow, _, _ = run_cemaneige(
                    prec, mean_temp, frac_solid_prec, snow0, th0,
                    self._candidates(X))
                return loss(qobs[None, :], outflow, dim=-1)
            return objective

        objective = self._objective_per_device(
            build, (qobs, prec, mean_temp, frac_solid_prec, state),
            de_kwargs.get("mesh"))
        return self._minimize(objective, seed, de_kwargs, engine)


def _cold_final(prec, mean_temp, frac_solid_prec, snow0, th0, params):
    """A cold start with its final :class:`~.states.CemaneigeState`, the
    series' snow-cover threshold given to every member."""
    *series, (G, eTG, g_thresh) = run_cemaneige(
        prec, mean_temp, frac_solid_prec, snow0, th0, params,
        return_final=True)
    return (*series, CemaneigeState(g=G, etg=eTG,
                                    g_thresh=g_thresh.expand_as(G)))


def _warm_final(prec, mean_temp, frac_solid_prec, state, params):
    """A continuation from a batched state, with its final state."""
    *series, (G, eTG) = run_cemaneige_warm(
        prec, mean_temp, frac_solid_prec, (state.g, state.etg),
        state.g_thresh, params)
    return (*series, CemaneigeState(g=G, etg=eTG, g_thresh=state.g_thresh))
