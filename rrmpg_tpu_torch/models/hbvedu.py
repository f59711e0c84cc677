"""HBV-Edu interface class (Aghakouchak & Habib 2010).

Counterpart of ``rrmpg_tpu.models.hbvedu.HBVEdu``: same 11 parameters,
bounds, structured dtype, validation errors (month array in [1, 12],
monthly climatologies of length 12) and ``simulate``/``fit`` signatures,
with ``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch (:mod:`..ops.hbvedu`), any device;
* ``'fused'`` -- the hand-written CUDA kernels (:mod:`..ops.fused_hbv`)
  for CUDA tensors; on the CPU their plain versions.

Outputs are tensors on the model's device in the reference layout,
member axis last: ``(T, N)``.

Forecast mode: ``simulate(..., return_final_state=True)`` also returns the
end-of-series :class:`~.states.HBVEduState` (member axis leading), and
``initial_state=`` continues from one, on both engines (``'fused'``: the
state kernel K14); ``fit(initial_state=)`` calibrates a continuation
segment from one shared state (``'fused'``: the warm entry of K12).  A
continuation advances the carried storages at every step; a cold start
keeps the reference's initialization step at ``t = 0``.
"""

import functools

import numpy as np
import torch

from ..config import DEFAULT_DEVICE
from ..ops._launch import valid_count
from ..ops.fused_hbv import (hbv_ensemble_mse_fused, hbv_simulate_fused,
                             hbv_simulate_state_fused)
from ..ops.hbvedu import PARAM_NAMES, run_hbvedu, run_hbvedu_warm
from ..ops.stats import losses_from_stats
from ..parallel.mesh import check_mesh
from ..utils.array_checks import check_for_negatives, validate_array_input
from ..utils.metrics import calibration_loss
from .basemodel import (BaseModel, check_engine, check_fused_mesh,
                        check_stats_mesh)
from .states import HBVEduState, check_state_type

_INIT_NAMES = ("snow_init", "soil_init", "s1_init", "s2_init")


class HBVEdu(BaseModel):
    """Interface to the educational HBV model."""

    _param_list = list(PARAM_NAMES)

    _default_bounds = {'T_t': (-1, 1),
                       'DD': (3, 7),
                       'FC': (100, 200),
                       'Beta': (1, 7),
                       'C': (0.01, 0.07),
                       'PWP': (90, 180),
                       'K_0': (0.05, 0.2),
                       'K_1': (0.01, 0.1),
                       'K_2': (0.01, 0.05),
                       'K_p': (0.01, 0.05),
                       'L': (2, 5)}

    _dtype = np.dtype([(name, np.float64) for name in PARAM_NAMES])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=None):
        super().__init__(params=params, device=device, dtype=dtype)

    @staticmethod
    def _validate_inputs(temp, prec, month, PE_m, T_m):
        temp = validate_array_input(temp, np.float64, 'temperature')
        prec = validate_array_input(prec, np.float64, 'precipitation')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        month = validate_array_input(month, np.int8, 'month')
        if any(len(arr) != len(temp) for arr in [prec, month]):
            raise RuntimeError(
                "temp, prec and month series need matching lengths; got "
                f"{len(temp)}, {len(prec)} and {len(month)}.")

        PE_m = validate_array_input(PE_m, np.float64, 'PE_m')
        T_m = validate_array_input(T_m, np.float64, 'T_m')
        if any(len(arr) != 12 for arr in [PE_m, T_m]):
            raise RuntimeError(
                "PE_m and T_m are monthly climatologies and need exactly 12 "
                f"entries; got {len(PE_m)} and {len(T_m)}.")

        if (np.min(month) < 1) or (np.max(month) > 12):
            raise ValueError(
                "Month indices must be integers from 1 (January) through "
                "12 (December).")

        # 0-based month index for the climatology gather.
        month = (month - 1).astype(np.int64)
        return temp, prec, month, PE_m, T_m

    def _forcing_tensors(self, temp, prec, month, PE_m, T_m):
        """Validated forcings as tensors on the model's device."""
        temp, prec, month, PE_m, T_m = self._validate_inputs(
            temp, prec, month, PE_m, T_m)
        return (self._tensor(temp), self._tensor(prec),
                torch.as_tensor(month, device=self.device),
                self._tensor(PE_m), self._tensor(T_m))

    def simulate(self, temp, prec, month, PE_m, T_m, snow_init=0,
                 soil_init=0, s1_init=0, s2_init=0, return_storage=False,
                 params=None, mesh=None, engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate rainfall-runoff for the given forcings.

        Args:
            temp: (T,) mean temperature series.
            prec: (T,) precipitation series.
            month: (T,) month number of each timestep in [1, 12].
            PE_m: (12,) long-term monthly potential evapotranspiration.
            T_m: (12,) long-term monthly mean temperature.
            snow_init, soil_init, s1_init, s2_init: initial storages.
            return_storage: also return the four storage series ('scan'
                only).
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.
            mesh: (optional) :class:`~..parallel.mesh.Mesh`; the
                members (and a warm state) are split over its 'ensemble'
                axis, ``engine='scan'`` only.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K13,
                or K14 in forecast mode; discharge only, single-device).
            initial_state: (optional) :class:`~.states.HBVEduState` from a
                previous ``return_final_state=True`` call; continues that
                simulation.  Mutually exclusive with non-zero ``*_init``
                scalars.
            return_final_state: also return the end-of-series
                :class:`~.states.HBVEduState` (member axis leading).

        Returns:
            qsim (T, N); plus snow, soil, s1, s2 (each (T, N)) if
            ``return_storage``; plus the final state if
            ``return_final_state``; tensors on the model's device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If the monthly arrays are not of size 12 or there
                is a size mismatch between precipitation, temperature and
                the month array.
        """
        check_mesh(mesh)
        forcings = self._forcing_tensors(temp, prec, month, PE_m, T_m)
        inits = tuple(float(v) for v in (snow_init, soil_init, s1_init,
                                         s2_init))
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        check_engine(engine)
        self._check_warm_inputs(initial_state, inits, "warm continuation")

        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, return_storage, mesh)
            state = None
            if initial_state is not None:
                state = self._normalize_state(initial_state,
                                              param_dict['T_t'].shape[0])
            if engine == "fused":
                qsim, final = hbv_simulate_state_fused(
                    *forcings, *inits, param_dict, state=state)
                series = (qsim,)
            elif state is None:
                *series, final = self._ensemble(
                    functools.partial(run_hbvedu, return_final=True),
                    (*forcings, *inits), param_dict, mesh)
            else:
                *series, final = self._ensemble(
                    run_hbvedu_warm, forcings, param_dict, mesh,
                    state=tuple(state))
            return self._stateful_output(
                self._to_reference_layout(series), HBVEduState(*final),
                return_storage, return_final_state)
        if engine == "fused":
            check_fused_mesh(mesh)
            if return_storage:
                raise ValueError(
                    "engine='fused' computes discharge only; use "
                    "engine='scan' for storage trajectories.")
            return hbv_simulate_fused(*forcings, *inits, param_dict).T
        outputs = self._ensemble(run_hbvedu, (*forcings, *inits), param_dict,
                                 mesh)
        if return_storage:
            return tuple(x.T for x in outputs)
        return outputs[0].T

    def _check_warm_inputs(self, initial_state, inits, what):
        if initial_state is None:
            return
        check_state_type(initial_state, HBVEduState, type(self).__name__)
        if any(v != 0 for v in inits):
            raise ValueError(
                "Pass either the *_init scalars (cold start) or a "
                f"full initial_state ({what}), not both.")

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see ``GR4J._warm_cycle_pieces``).

        ``PE_m``/``T_m`` (the (12,) monthly climatologies) ride in
        ``sim_kwargs``, with the optional ``engine`` ('scan', or 'fused'
        for the warm entry of K14).  The months are validated and made
        0-based once, as ``simulate`` makes them.
        """
        kw = dict(sim_kwargs)
        pe_m = kw.pop('PE_m')
        t_m = kw.pop('T_m')
        engine = kw.pop('engine', 'scan')
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for HBVEdu cycling: "
                f"{sorted(kw)}.")
        check_engine(engine)
        temp, prec, month, pe_m, t_m = self._forcing_tensors(
            forcings['temp'], forcings['prec'], forcings['month'], pe_m, t_m)

        def warm_step(arrays, state, params):
            temp_w, prec_w, month_w = arrays
            if engine == "fused":
                qsim, final = hbv_simulate_state_fused(
                    temp_w, prec_w, month_w, pe_m, t_m, 0.0, 0.0, 0.0, 0.0,
                    params, state=tuple(state))
            else:
                qsim, *_, final = run_hbvedu_warm(
                    temp_w, prec_w, month_w, pe_m, t_m, tuple(state), params)
            return qsim, HBVEduState(*final)

        return (temp, prec, month), warm_step

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """(4, N) time-mean sufficient statistics from the fused kernel
        K12: the trajectory-free evaluation behind
        ``monte_carlo(return_qsim=False, engine='fused')``."""
        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        check_stats_mesh(kw)
        forcings = self._forcing_tensors(
            *(kw.pop(k) for k in ("temp", "prec", "month", "PE_m", "T_m")))
        inits = tuple(float(kw.pop(k, 0.0)) for k in _INIT_NAMES)
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        qobs = np.asarray(qobs, np.float64)
        return hbv_ensemble_mse_fused(
            *forcings, self._tensor(qobs), *inits, param_dict, stats=True,
            masked=bool(np.isnan(qobs).any()))

    def _batch_objective(self, qobs, forcings, inits, loss_metric, engine,
                         state=None):
        """The calibration objective: (P, 11) candidates -> (P,) losses.

        ``qobs`` and ``forcings`` are tensors on one device (the model's,
        or a mesh shard's).
        'fused' evaluates a whole DE generation with one launch of K12
        (MSE for 'mse'/'rmse', the sufficient statistics for
        'nse'/'kge'); 'scan' runs the plain batched simulation and the
        masked metrics.  ``state`` (a single-member
        :class:`~.states.HBVEduState`) makes every candidate a warm
        continuation from those shared storages.
        """
        check_engine(engine)
        loss = calibration_loss(loss_metric)
        if engine == "scan":
            def objective(X):
                params = {n: X[:, j] for j, n in enumerate(self._param_list)}
                if state is None:
                    qsim = run_hbvedu(*forcings, *inits, params)[0]
                else:
                    qsim = run_hbvedu_warm(*forcings, tuple(state),
                                           params)[0]
                return loss(qobs[None, :], qsim, dim=-1)

            return objective

        use_stats = loss_metric in ("nse", "kge")
        masked = bool(torch.isnan(qobs).any())
        count = valid_count(qobs, masked)

        def objective(X):
            params = {n: X[:, j].contiguous()
                      for j, n in enumerate(self._param_list)}
            out = hbv_ensemble_mse_fused(
                *forcings, qobs, *inits, params, stats=use_stats,
                masked=masked, state=state, count=count)
            if use_stats:
                return 1.0 - losses_from_stats(out, qobs)[loss_metric]
            if loss_metric == "rmse":
                return torch.sqrt(out)
            return out

        return objective

    def fit(self, qobs, temp, prec, month, PE_m, T_m, snow_init=0.,
            soil_init=0., s1_init=0., s2_init=0., loss_metric="mse",
            seed=None, engine="scan", initial_state=None, **de_kwargs):
        """Calibrate the model on observed discharge with differential
        evolution on the model's device.

        Args:
            qobs: observed discharge; NaN marks a gap.
            temp, prec, month, PE_m, T_m: forcings as in :meth:`simulate`.
            snow_init, soil_init, s1_init, s2_init: initial storages.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            engine: 'scan', or 'fused' to evaluate every DE generation
                with one launch of the fused objective kernel.
            initial_state: (optional) single-member
                :class:`~.states.HBVEduState`: calibrate a continuation
                segment from a known initial condition, on either engine.
                Mutually exclusive with non-zero ``*_init`` scalars.
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
            Candidates whose soil store went negative have NaN losses; the
            optimizer never selects them (``nonfinite_members()``).
        """
        calibration_loss(loss_metric)
        qobs = validate_array_input(qobs, np.float64, 'qobs')
        forcings = self._forcing_tensors(temp, prec, month, PE_m, T_m)
        inits = tuple(float(v) for v in (snow_init, soil_init, s1_init,
                                         s2_init))
        self._check_warm_inputs(initial_state, inits, "warm calibration")
        state = (None if initial_state is None
                 else self._single_member_state(initial_state))
        objective = self._objective_per_device(
            lambda qobs, forcings, state: self._batch_objective(
                qobs, forcings, inits, loss_metric, engine, state),
            (self._tensor(qobs), forcings, state), de_kwargs.get("mesh"))
        return self._minimize(objective, seed, de_kwargs, engine)
