"""GR4J interface class (Perrin, Michel & Andreassian 2003).

Counterpart of ``rrmpg_tpu.models.gr4j.GR4J``: same parameters, bounds,
structured dtype, validation errors and ``simulate``/``fit`` signatures,
with ``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch (:mod:`..ops.gr4j`), any device;
* ``'fused'`` -- the hand-written CUDA kernels
  (:mod:`..ops.fused_gr4j`) for CUDA tensors; on the CPU their plain
  versions.

A model lives on the card unless built with ``device='cpu'``.

Outputs are tensors on the model's device in the reference layout,
member axis last: ``(T, N)``.

Forecast mode: ``simulate(..., return_final_state=True)`` also returns the
end-of-series :class:`~..ops.gr4j.GR4JState` (member axis leading), and
``initial_state=`` continues from one, on both engines (``'fused'``: the
state kernel K4); ``fit(initial_state=)`` calibrates a continuation segment
from one shared state (``'fused'``: the warm entry of K1/K2).
"""

import functools
import numbers

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, DEFAULT_DTYPE
from ..ops._launch import valid_count
from ..ops.fused_gr4j import (gr4j_ensemble_mse_fused, gr4j_simulate_fused,
                              gr4j_simulate_state_fused)
from ..ops.gr4j import GR4JState, run_gr4j, run_gr4j_warm
from ..ops.stats import losses_from_stats
from ..ops.uh import NUM_UH1, NUM_UH2, required_uh_lengths
from ..parallel.mesh import check_mesh
from ..utils.array_checks import check_for_negatives, validate_array_input
from ..utils.metrics import calibration_loss
from .basemodel import (BaseModel, check_engine, check_fused_mesh,
                        check_stats_mesh)
from .states import broadcast_state, check_state_type


def fit_uh_lengths(x4_hi):
    """Short bounds-derived UH register lengths for the fused fit path:
    ``ceil(x4_hi)`` / ``ceil(2*x4_hi + 1)``, capped at (NUM_UH1, NUM_UH2).
    Under the class bounds (x4 <= 2.9) this is (3, 7)."""
    n1 = min(int(np.ceil(x4_hi)), NUM_UH1)
    n2 = min(int(np.ceil(2.0 * x4_hi + 1.0)), NUM_UH2)
    return n1, n2


class GR4J(BaseModel):
    """Interface to the GR4J model."""

    _param_list = ['x1', 'x2', 'x3', 'x4']

    _default_bounds = {'x1': (100, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 300),
                       'x4': (1.1, 2.9)}

    _dtype = np.dtype([('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=DEFAULT_DTYPE):
        super().__init__(params=params, device=device, dtype=dtype)

    @staticmethod
    def _validate_forcings(prec, etp):
        prec = validate_array_input(prec, np.float64, 'precipitation')
        etp = validate_array_input(etp, np.float64, 'pot. evapotranspiration')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")
        if len(prec) != len(etp):
            raise RuntimeError(
                f"prec and etp lengths differ: {len(prec)} vs {len(etp)}.")
        return prec, etp

    @staticmethod
    def _validate_inits(s_init, r_init):
        if not isinstance(s_init, numbers.Number):
            raise TypeError(
                f"'s_init' needs a numeric scalar, got {type(s_init).__name__}.")
        if not isinstance(r_init, numbers.Number):
            raise TypeError(
                f"'r_init' needs a numeric scalar, got {type(r_init).__name__}.")
        s_init = float(s_init)
        r_init = float(r_init)
        if not 0 <= s_init <= 1:
            raise ValueError(
                f"'s_init' is a fraction of x1 and must lie in [0, 1]; got "
                f"{s_init}.")
        if not 0 <= r_init <= 1:
            raise ValueError(
                f"'r_init' is a fraction of x3 and must lie in [0, 1]; got "
                f"{r_init}.")
        return s_init, r_init

    def simulate(self, prec, etp, s_init=0, r_init=0, return_storage=False,
                 params=None, mesh=None, engine="scan", initial_state=None,
                 return_final_state=False):
        """Simulate streamflow for the given forcings.

        Args:
            prec: (T,) precipitation [mm/day].
            etp: (T,) potential evapotranspiration [mm/day].
            s_init: initial production store filling as fraction of x1.
            r_init: initial routing store filling as fraction of x3.
            return_storage: also return the s/r store series ('scan' only).
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.
            mesh: (optional) :class:`~..parallel.mesh.Mesh`; the
                members (and a warm state) are split over its 'ensemble'
                axis, ``engine='scan'`` only.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K3,
                or K4 in forecast mode; discharge only, single-device).
            initial_state: (optional) :class:`~..ops.gr4j.GR4JState` from
                a previous ``return_final_state=True`` call; continues that
                simulation (stores and UH filter history carried across
                the boundary).  Mutually exclusive with non-zero
                ``s_init``/``r_init``.
            return_final_state: also return the end-of-series
                :class:`~..ops.gr4j.GR4JState` (member axis leading).

        Returns:
            qsim (T, N), plus s_store (T, N) and r_store (T, N) if
            ``return_storage``, plus the final state if
            ``return_final_state``; tensors on the model's device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If prec and etp differ in length.
        """
        check_mesh(mesh)
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        check_engine(engine)
        self._check_warm_inputs(initial_state, s_init, r_init,
                                "warm continuation")

        param_dict, _ = self._prepare_params(params)
        n1, n2 = required_uh_lengths(param_dict['x4'])
        prec, etp = self._tensor(prec), self._tensor(etp)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, return_storage, mesh)
            return self._simulate_stateful(
                prec, etp, s_init, r_init, initial_state,
                return_final_state, return_storage, param_dict, n1, n2,
                engine, mesh)
        if engine == "fused":
            check_fused_mesh(mesh)
            if return_storage:
                raise ValueError(
                    "engine='fused' computes discharge only; use "
                    "engine='scan' for storage trajectories.")
            qsim = gr4j_simulate_fused(prec, etp, s_init, r_init,
                                       param_dict, n1, n2)
            return qsim.T
        qsim, s_store, r_store = self._ensemble(
            functools.partial(run_gr4j, num_uh1=n1, num_uh2=n2),
            (prec, etp, s_init, r_init), param_dict, mesh)
        if return_storage:
            return qsim.T, s_store.T, r_store.T
        return qsim.T

    def _check_warm_inputs(self, initial_state, s_init, r_init, what):
        if initial_state is None:
            return
        check_state_type(initial_state, GR4JState, type(self).__name__)
        if s_init != 0 or r_init != 0:
            raise ValueError(
                "Pass either fractional s_init/r_init (cold start) or "
                f"a full initial_state ({what}), not both.")

    @staticmethod
    def _check_history_depth(h_avail, num_uh2, x4_values):
        """The carried UH history must cover the continuation's filter
        depth (an actionable rewording of the ops guard: the class API
        exposes no ``num_uh2``)."""
        h_needed = num_uh2 - 1
        if h_avail < h_needed:
            x4_max = float(torch.as_tensor(x4_values).max())
            raise ValueError(
                f"initial_state carries {h_avail} unit-hydrograph history "
                f"taps but x4={x4_max:g} "
                f"needs {h_needed}. The state was produced by a run with "
                "a smaller UH filter depth; produce it with return_final_"
                "state=True under parameters (or class bounds) whose x4 "
                "covers the continuation's, or keep the continuation x4 "
                "within the producing run's range.")

    def _simulate_stateful(self, prec, etp, s_init, r_init, initial_state,
                           return_final_state, return_storage, param_dict,
                           n1, n2, engine, mesh=None):
        """Forecast-mode execution: warm continuation and/or final state
        (on a mesh, ``'scan'`` only, the state split with the members)."""
        state = None
        if initial_state is not None:
            state = self._normalize_state(initial_state,
                                          param_dict['x1'].shape[0])
            self._check_history_depth(state.pr_history.shape[-1], n2,
                                      param_dict['x4'])
        if engine == "fused":
            qsim, final = gr4j_simulate_state_fused(
                prec, etp, param_dict, state=state, s_init=s_init,
                r_init=r_init, num_uh1=n1, num_uh2=n2)
            series = (qsim,)
        elif state is None:
            *series, final = self._ensemble(
                functools.partial(run_gr4j, num_uh1=n1, num_uh2=n2,
                                  return_final=True),
                (prec, etp, s_init, r_init), param_dict, mesh)
        else:
            *series, final = self._ensemble(
                functools.partial(run_gr4j_warm, num_uh1=n1, num_uh2=n2),
                (prec, etp), param_dict, mesh, state=state)
        return self._stateful_output(self._to_reference_layout(series),
                                     final, return_storage,
                                     return_final_state)

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """``(time_arrays, warm_step)`` for the device-resident assimilation
        cycle (:func:`rrmpg_tpu_torch.tools.assimilation.assimilation_cycle`
        with ``backend='scan'``): the validated full-series forcing as
        tensors on the model's device (leading time axis, windowed by the
        caller) and ``warm_step(window_arrays, state, params) -> (qsim (N,
        w), new_state)``.  ``sim_kwargs`` may name the ``engine``: 'scan'
        (default) or 'fused' (the warm entry of K4).  The UH lengths come
        from the class bound of x4, so a history keeps its width while the
        members' x4 move."""
        kw = dict(sim_kwargs)
        engine = kw.pop("engine", "scan")
        if kw:
            raise ValueError(
                f"GR4J.simulate takes no extra forcing kwargs; got "
                f"{sorted(kw)}.")
        check_engine(engine)
        prec, etp = self._validate_forcings(forcings['prec'],
                                            forcings['etp'])
        x4_hi = self._default_bounds['x4'][1]
        n1, n2 = required_uh_lengths(x4_hi)

        def warm_step(arrays, state, params):
            prec_w, etp_w = arrays
            self._check_history_depth(state.pr_history.shape[-1], n2,
                                      [x4_hi])
            if engine == "fused":
                return gr4j_simulate_state_fused(prec_w, etp_w, params,
                                                 state=state, num_uh1=n1,
                                                 num_uh2=n2)
            qsim, _, _, final = run_gr4j_warm(prec_w, etp_w, state, params,
                                              n1, n2)
            return qsim, final

        return (self._tensor(prec), self._tensor(etp)), warm_step

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """(4, N) time-mean sufficient statistics from the fused kernel K2:
        the trajectory-free evaluation behind
        ``monte_carlo(return_qsim=False, engine='fused')``."""
        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        check_stats_mesh(kw)
        prec = kw.pop("prec")
        etp = kw.pop("etp")
        s_init = kw.pop("s_init", 0.0)
        r_init = kw.pop("r_init", 0.0)
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        qobs = np.asarray(qobs, np.float64)
        n1, n2 = required_uh_lengths(param_dict['x4'])
        return gr4j_ensemble_mse_fused(
            self._tensor(prec), self._tensor(etp), self._tensor(qobs),
            s_init, r_init, param_dict, num_uh1=n1, num_uh2=n2, stats=True,
            masked=bool(np.isnan(qobs).any()))

    def _batch_objective(self, qobs, prec, etp, s_init, r_init, loss_metric,
                         engine, state=None):
        """The calibration objective: (P, 4) candidates -> (P,) losses.

        ``qobs``/``prec``/``etp`` are (T,) tensors on one device (the
        model's, or a mesh shard's).
        'fused' evaluates a whole DE generation with one launch of K1
        ('mse'/'rmse') or K2 ('nse'/'kge'); 'scan' runs the plain
        batched simulation and the masked metrics.  ``state`` (a
        single-member :class:`~..ops.gr4j.GR4JState`) makes every candidate
        a warm continuation from that one shared state, broadcast to the
        candidate batch.
        """
        check_engine(engine)
        loss = calibration_loss(loss_metric)
        if engine == "scan":
            def objective(X):
                params = {n: X[:, j] for j, n in enumerate(self._param_list)}
                if state is None:
                    qsim = run_gr4j(prec, etp, s_init, r_init, params)[0]
                else:
                    qsim = run_gr4j_warm(
                        prec, etp, broadcast_state(state, X.shape[0]),
                        params)[0]
                return loss(qobs[None, :], qsim, dim=-1)

            return objective

        x4_hi = self._default_bounds['x4'][1]
        n1, n2 = fit_uh_lengths(x4_hi)
        if state is not None:
            self._check_history_depth(state.pr_history.shape[-1], n2,
                                      [x4_hi])
        use_stats = loss_metric in ("nse", "kge")
        masked = bool(torch.isnan(qobs).any())
        count = valid_count(qobs, masked)

        def objective(X):
            params = {n: X[:, j].contiguous()
                      for j, n in enumerate(self._param_list)}
            out = gr4j_ensemble_mse_fused(
                prec, etp, qobs, s_init, r_init, params, num_uh1=n1,
                num_uh2=n2, stats=use_stats, masked=masked,
                state=(None if state is None
                       else broadcast_state(state, X.shape[0])),
                count=count)
            if use_stats:
                return 1.0 - losses_from_stats(out, qobs)[loss_metric]
            if loss_metric == "rmse":
                return torch.sqrt(out)
            return out

        return objective

    def fit(self, qobs, prec, etp, s_init=0., r_init=0., loss_metric="mse",
            seed=None, engine="scan", initial_state=None, **de_kwargs):
        """Calibrate the model on observed discharge with differential
        evolution on the model's device.

        Args:
            qobs: observed discharge; NaN marks a gap.
            prec, etp: forcing arrays.
            s_init, r_init: initial store fillings as fractions, in [0, 1].
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            engine: 'scan', or 'fused' to evaluate every DE generation
                with one launch of the fused objective kernel.
            initial_state: (optional) single-member
                :class:`~..ops.gr4j.GR4JState`: calibrate a continuation
                segment from a known initial condition (recalibration on
                recent data), on either engine.  Mutually exclusive with
                non-zero ``s_init``/``r_init``.
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize` and on
                to ``differential_evolution``: ``key``, ``popsize``,
                ``maxiter``, ``tol``, ``checkpoint_path`` /
                ``checkpoint_every`` / ``resume_from`` (``*.npz``),
                ``polish`` / ``polish_steps`` (skipped, with a note in
                the message, on the fused kernels, which have no
                backward); ``mesh`` / ``mesh_axis`` (each generation's
                population split over the mesh, one launch of the fused
                kernel a shard, the forcing copied once a device).

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize

        calibration_loss(loss_metric)
        qobs = validate_array_input(qobs, np.float64, 'qobs')
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        self._check_warm_inputs(initial_state, s_init, r_init,
                                "warm calibration")
        state = (None if initial_state is None
                 else self._single_member_state(initial_state))
        objective = self._objective_per_device(
            lambda qobs, prec, etp, state: self._batch_objective(
                qobs, prec, etp, s_init, r_init, loss_metric, engine, state),
            (self._tensor(qobs), self._tensor(prec), self._tensor(etp),
             state), de_kwargs.get("mesh"))
        bounds = tuple(self._default_bounds[p] for p in self._param_list)
        return minimize(objective, bounds, seed=seed, batched=True,
                        device=self.device, dtype=self.dtype, **de_kwargs)
