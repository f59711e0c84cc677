"""ABC-model interface class (Fiering 1967; Vogel & Sankarasubramanian 2003).

Counterpart of ``rrmpg_tpu.models.abcmodel.ABCModel``: same parameters,
bounds, structured dtype, constrained random sampling (b <= 1 - a),
validation errors and ``simulate``/``fit`` signatures, with
``engine='scan'|'fused'`` in place of ``'xla'|'pallas'``:

* ``'scan'`` -- plain batched PyTorch, stepping through time
  (:func:`..ops.abc.run_abcmodel`), any device;
* ``'fused'`` -- the hand-written single-launch CUDA scan
  (:func:`..ops.fused_abc.abc_fused_single`) for CUDA tensors, all members
  in one launch; on the CPU its plain version.

Outputs are tensors on the model's device in the reference layout,
member axis last: ``(T, N)``.  Forecast mode (an ``ABCState`` as
``initial_state``, ``return_final_state``) waits for the state bundles.
"""

import numbers

import numpy as np

from ..config import DEFAULT_DEVICE, DEFAULT_DTYPE
from ..ops.abc import run_abcmodel, run_abcmodel_pscan
from ..ops.fused_abc import abc_fused_single
from ..utils.array_checks import check_for_negatives, validate_array_input
from ..utils.metrics import calibration_loss
from .basemodel import BaseModel, check_engine


def _cold_start(initial_state, return_final_state=False):
    """The initial storage as a float; anything but a non-negative number
    (a carried ``ABCState``) is forecast mode, which is not ported."""
    if not isinstance(initial_state, numbers.Number) or return_final_state:
        raise NotImplementedError(
            "Forecast mode (an ABCState as initial_state, "
            "return_final_state) is not ported yet; it comes with the state "
            "bundles (ROADMAP.md, Queue 1, item 6).")
    if initial_state < 0:
        raise TypeError(
            "'initial_state' needs a non-negative numeric scalar; got "
            f"{initial_state!r}.")
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

    def __init__(self, params=None, device=DEFAULT_DEVICE,
                 dtype=DEFAULT_DTYPE):
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
                 params=None, engine="scan", return_final_state=False):
        """Simulate streamflow for the passed precipitation.

        Args:
            prec: (T,) precipitation (list, numpy array or pandas.Series).
            initial_state: (optional) initial storage value.
            return_storage: (optional) also return the storage series.
            params: (optional) structured array / dict of parameter sets,
                evaluated batched.  Defaults to the instance's parameters.
            engine: 'scan' (plain PyTorch) or 'fused' (CUDA kernel K6, one
                launch for all members).

        Returns:
            qsim (T, N), plus storage (T, N) if requested; tensors on the
            model's device.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
        """
        prec = _validate_prec(prec)
        initial_state = _cold_start(initial_state, return_final_state)
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        check_engine(engine)

        param_dict, _ = self._prepare_params(params)
        run = abc_fused_single if engine == "fused" else run_abcmodel
        qsim, storage = run(self._tensor(prec), initial_state, param_dict)
        if return_storage:
            return qsim.T, storage.T
        return qsim.T

    def _batch_objective(self, qobs, prec, initial_state, loss_metric):
        """The calibration objective: (P, 3) candidates -> (P,) losses.

        ``qobs``/``prec`` are (T,) tensors on the model's device.  A
        generation is one batched call of the plain parallel-prefix
        simulation (``rrmpg_tpu`` has no fused ABC objective either) and
        the masked metrics.
        """
        loss = calibration_loss(loss_metric)

        def objective(X):
            params = {n: X[:, j] for j, n in enumerate(self._param_list)}
            qsim, _ = run_abcmodel_pscan(prec, initial_state, params)
            return loss(qobs[None, :], qsim, dim=-1)

        return objective

    def fit(self, qobs, prec, initial_state=0, loss_metric="mse", seed=None,
            **de_kwargs):
        """Calibrate the model on observed discharge with differential
        evolution on the model's device.

        Args:
            qobs: observed discharge; NaN marks a gap.
            prec: precipitation array.
            initial_state: (optional) initial storage value.
            loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge'
                minimizing ``1 - score``.
            seed: (optional) seed of the optimizer's ``torch.Generator``.
            **de_kwargs: forwarded to
                :func:`rrmpg_tpu_torch.tools.calibration.minimize`.

        Returns:
            An :class:`~rrmpg_tpu_torch.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize

        qobs = validate_array_input(qobs, np.float64, 'qobs')
        objective = self._batch_objective(
            self._tensor(qobs), self._tensor(_validate_prec(prec)),
            _cold_start(initial_state), loss_metric)
        bounds = tuple(self._default_bounds[p] for p in self._param_list)
        return minimize(objective, bounds, seed=seed, device=self.device,
                        dtype=self.dtype, **de_kwargs)
