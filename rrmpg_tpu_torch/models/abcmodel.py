"""ABC-model interface class (Fiering 1967; Vogel & Sankarasubramanian 2003).

Counterpart of ``rrmpg_tpu.models.abcmodel.ABCModel``: same parameters,
bounds, structured dtype, constrained random sampling (b <= 1 - a),
validation errors and ``simulate``/``fit`` signatures, with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch: the linear storage recurrence as
  batched Toeplitz products (:func:`..ops.abc.run_abcmodel_matscan`, JAX's
  XLA engine), any device;
* ``'fused'`` -- the hand-written single-launch CUDA scan
  (:func:`..ops.fused_abc.abc_fused_single`) for CUDA tensors, all members
  in one launch; on the CPU its plain version.

Outputs are tensors on the model's device in the reference layout,
member axis last: ``(T, N)``.

Forecast mode: ``return_final_state=True`` also returns the end-of-series
:class:`~.states.ABCState` (of a cold start: the last storage row, on
either engine), and an ``ABCState`` as ``initial_state`` continues from
one, on the ``'scan'`` engine only (:func:`..ops.abc.run_abcmodel_warm`,
on the same products); ``fit`` takes a single-member ``ABCState`` too.
"""

import numbers

import numpy as np

from ..config import DEFAULT_DEVICE
from ..ops.abc import run_abcmodel_matscan, run_abcmodel_warm
from ..ops.fused_abc import abc_fused_single
from ..parallel.mesh import check_mesh
from ..utils.array_checks import check_for_negatives, validate_array_input
from ..utils.metrics import calibration_loss
from .basemodel import BaseModel, check_engine, check_fused_mesh
from .states import ABCState, check_state_type


def _cold_start(initial_state):
    """The initial storage of a cold start as a float."""
    if initial_state < 0:
        raise TypeError(
            "'initial_state' needs a non-negative numeric scalar (or an "
            f"ABCState for warm continuation); got {initial_state!r}.")
    return float(initial_state)


def _validate_prec(prec):
    prec = validate_array_input(prec, np.float64, 'precipitation')
    if check_for_negatives(prec):
        raise ValueError(
            "Precipitation must be non-negative; the input contains "
            "negative values.")
    return prec


class ABCModel(BaseModel):
    """Interface to the ABC model."""

    _param_list = ['a', 'b', 'c']

    _default_bounds = {'a': (0, 1),
                       'b': (0, 1),
                       'c': (0, 1)}

    _dtype = np.dtype([('a', np.float64),
                       ('b', np.float64),
                       ('c', np.float64)])

    def __init__(self, params=None, device=DEFAULT_DEVICE, dtype=None):
        super().__init__(params=params, device=device, dtype=dtype)

    def get_random_params(self, num=1):
        """Sample random parameters respecting the constraint b <= 1 - a,
        with the host numpy generator in the draw order a, c, b:
        ``np.random.seed(s)`` gives the same sets as ``rrmpg_tpu``."""
        params = np.zeros(num, dtype=self._dtype)
        params['a'] = np.random.uniform(*self._default_bounds['a'], size=num)
        params['c'] = np.random.uniform(*self._default_bounds['c'], size=num)
        params['b'] = np.random.uniform(self._default_bounds['b'][0],
                                        1 - params['a'], size=num)
        return params

    def simulate(self, prec, initial_state=0, return_storage=False,
                 params=None, mesh=None, engine="scan",
                 return_final_state=False):
        """Simulate streamflow for the passed precipitation.

        Args:
            prec: (T,) precipitation (list, numpy array or pandas.Series).
            initial_state: (optional) initial storage value (scalar, cold
                start with the reference's t=0 initialization step), or an
                :class:`~.states.ABCState` from a previous
                ``return_final_state=True`` call to continue that
                simulation (every step then advances the carried storage;
                ``engine='scan'`` only).
            return_storage: (optional) also return the storage series.
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.  Defaults to the instance's parameters.
            mesh: (optional) :class:`~..parallel.mesh.Mesh`; the
                members (and a warm state) are split over its 'ensemble'
                axis, ``engine='scan'`` only.
            engine: 'scan' (plain PyTorch, batched Toeplitz products) or
                'fused' (CUDA kernel K6, one launch for all members,
                single-device).
            return_final_state: also return the end-of-series
                :class:`~.states.ABCState` (member axis leading).

        Returns:
            qsim (T, N), plus storage (T, N) if requested, plus the final
            state if ``return_final_state``; tensors on the model's device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
        """
        check_mesh(mesh)
        prec = _validate_prec(prec)
        warm = not isinstance(initial_state, numbers.Number)
        if warm:
            check_state_type(initial_state, ABCState, type(self).__name__)
        else:
            initial_state = _cold_start(initial_state)
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        check_engine(engine)

        param_dict, num = self._prepare_params(params)
        if warm:
            self._check_stateful_supported(engine)
            state = self._normalize_state(initial_state, num)
            qsim, storage, final = self._ensemble(
                run_abcmodel_warm, (self._tensor(prec),), param_dict, mesh,
                state=state.storage)
        elif engine == "fused":
            check_fused_mesh(mesh)
            qsim, storage = abc_fused_single(self._tensor(prec),
                                             initial_state, param_dict)
        else:
            qsim, storage = self._ensemble(
                run_abcmodel_matscan, (self._tensor(prec), initial_state),
                param_dict, mesh)
        if not warm:
            # The storage series is the whole ABC state: its last row is
            # the final state of a cold start.
            final = storage[:, -1]
        return self._stateful_output(
            (qsim.T, storage.T), ABCState(storage=final), return_storage,
            return_final_state)

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see ``GR4J._warm_cycle_pieces``).
        ABC carries state on the sequential engine only: ``engine='fused'``
        raises as in ``simulate``."""
        kw = dict(sim_kwargs)
        engine = kw.pop("engine", "scan")
        if kw:
            raise ValueError(
                f"ABCModel.simulate takes no extra forcing kwargs; got "
                f"{sorted(kw)}.")
        check_engine(engine)
        self._check_stateful_supported(engine)
        prec = _validate_prec(forcings['prec'])

        def warm_step(arrays, state, params):
            qsim, _, final = run_abcmodel_warm(arrays[0], state.storage,
                                               params)
            return qsim, ABCState(storage=final)

        return (self._tensor(prec),), warm_step

    def _batch_objective(self, qobs, prec, initial_state, loss_metric):
        """The calibration objective: (P, 3) candidates -> (P,) losses.

        ``qobs``/``prec`` are (T,) tensors on one device (the model's, or a
        mesh shard's).  A generation is one batched call of the Toeplitz
        products (:func:`..ops.abc.run_abcmodel_matscan`, as JAX's
        objective; ``rrmpg_tpu`` has no fused ABC objective either) and the
        masked metrics.  ``initial_state`` is the cold-start storage (a
        float) or a single-member :class:`~.states.ABCState` to continue
        from.
        """
        loss = calibration_loss(loss_metric)

        def objective(X):
            params = {n: X[:, j] for j, n in enumerate(self._param_list)}
            if isinstance(initial_state, ABCState):
                qsim = run_abcmodel_warm(prec, initial_state.storage,
                                         params)[0]
            else:
                qsim = run_abcmodel_matscan(prec, initial_state, params)[0]
            return loss(qobs[None, :], qsim, dim=-1)

        return objective

    def fit(self, qobs, prec, initial_state=0, loss_metric="mse", seed=None,
            **de_kwargs):
        """Calibrate the model on observed discharge with differential
        evolution on the model's device.

        Args:
            qobs: observed discharge; NaN marks a gap.
            prec: precipitation array.
            initial_state: (optional) initial storage value (scalar cold
                start), or a single-member :class:`~.states.ABCState` to
                calibrate a continuation segment from a known initial
                condition.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize` and on to
                ``differential_evolution``: ``key``, ``popsize``, ``maxiter``,
                ``tol``, ``checkpoint_path`` / ``checkpoint_every`` /
                ``resume_from`` (``*.npz`` or a directory), ``polish`` /
                ``polish_steps``; ``mesh`` / ``mesh_axis`` (each generation's
                population split over the mesh).

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        qobs = validate_array_input(qobs, np.float64, 'qobs')
        prec = _validate_prec(prec)
        if isinstance(initial_state, numbers.Number):
            initial_state = _cold_start(initial_state)
        else:
            check_state_type(initial_state, ABCState, type(self).__name__)
            initial_state = self._single_member_state(initial_state)
        objective = self._objective_per_device(
            lambda qobs, prec, initial_state: self._batch_objective(
                qobs, prec, initial_state, loss_metric),
            (self._tensor(qobs), self._tensor(prec), initial_state),
            de_kwargs.get("mesh"))
        return self._minimize(objective, seed, de_kwargs)
