"""Parent class for all models: parameter registry, bounds and placement.

Keeps the public contract of ``rrmpg_tpu.models.basemodel.BaseModel`` (and
the reference ``rrmpg/models/basemodel.py:20-175``): structured-dtype
parameter arrays, uniform sampling within the default bounds, dict /
``np.void`` / structured-ndarray ``set_params``.

What differs: a model lives on an explicit ``device`` with an explicit
``dtype``; batched parameters are dicts of (N,) tensors there, and
device-side sampling takes a ``torch.Generator`` instead of a JAX key.
The classes are not ``nn.Module``s: nothing here trains by autograd.
"""

import numbers

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..parallel.ensemble import ensemble_run
from ..parallel.mesh import check_mesh, replicate, tree_leaves
from ..utils.tracing import to_device, traced
from .states import normalize_state, single_member_state

_ENGINES = ("scan", "fused")


def check_engine(engine):
    if engine not in _ENGINES:
        raise ValueError("engine must be 'scan' or 'fused'.")


def check_fused_mesh(mesh, what="sharded simulation"):
    """``engine='fused'`` runs on the model's device: a mesh raises, as
    JAX's ``engine='pallas'`` does."""
    if mesh is not None:
        raise ValueError(
            "engine='fused' simulate runs single-device through the class "
            "API and would silently ignore mesh; use engine='scan' for "
            f"{what}, or the regional/ensemble helpers in "
            "rrmpg_tpu_torch.parallel.")


class _PointOfBatch(torch.autograd.Function):
    """One candidate's loss from a batched ``(P, dim) -> (P,)`` objective,
    whose ``vmap`` is one call of the batched objective on the whole
    batch: the per-point form of a ``'scan'`` objective, as JAX's XLA
    objective is per point, without stepping a loop per candidate."""

    @staticmethod
    def forward(x, objective):
        return objective(x[None, :])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, x, objective):
        return objective(x.movedim(in_dims[0], 0)), 0


def check_stats_mesh(sim_kwargs):
    """The fused statistics path of ``monte_carlo`` runs on the model's
    device: a mesh in its simulate kwargs raises, as JAX's does."""
    if sim_kwargs.pop("mesh", None) is not None:
        raise ValueError(
            "The fused statistics path runs single-device; drop mesh= "
            "(shard with parallel.ensemble instead) or keep "
            "return_qsim=True.")


class BaseModel(object):
    """Base class for all rainfall-runoff models."""

    # List of strings containing all model parameters
    _param_list = []

    # Dict containing the default parameter bounds
    _default_bounds = {}

    # Structured numpy datatype (one float64 field per parameter).
    _dtype = np.dtype([])

    def __init__(self, params=None, device=DEFAULT_DEVICE, dtype=None):
        """Initialize a hydrological model.

        Args:
            params: (optional) dict with one value per model parameter; if
                omitted, random parameters are drawn within the bounds.
            device: where the model computes: the card (``'cuda'``, the
                default; raises on a machine without one) or ``'cpu'``.
            dtype: ``torch.float32`` or ``torch.float64``; by default
                :func:`~..config.default_float` (float32 unless
                :func:`~..config.enable_x64` was called).

        Raises:
            AttributeError: If a model parameter is missing in ``params``.
        """
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        if params:
            absent = sorted(set(self._param_list) - set(params))
            if absent:
                raise AttributeError(
                    f"Cannot construct {type(self).__name__}: no value given "
                    f"for parameter(s) {absent}.")
        else:
            params = self.get_random_params()
        self.set_params(params)

    # ------------------------------------------------------------------
    # Parameter registry (reference semantics)
    # ------------------------------------------------------------------

    def get_random_params(self, num=1):
        """Sample ``num`` parameter sets uniformly within bounds with the
        host numpy generator; returns a structured array of the model's
        dtype.  ``np.random.seed(s)`` gives the same draw as
        ``rrmpg_tpu``."""
        lows = np.array([self._default_bounds[p][0] for p in self._param_list])
        highs = np.array([self._default_bounds[p][1] for p in self._param_list])
        draws = np.random.uniform(lows, highs, size=(num, len(self._param_list)))
        params = np.empty(num, dtype=self._dtype)
        for j, p in enumerate(self._param_list):
            params[p] = draws[:, j]
        return params

    def sample_params(self, generator, num):
        """Uniform parameter sampling on the model's device.

        Args:
            generator: a ``torch.Generator`` on the model's device.
            num: number of parameter sets.

        Returns:
            dict of (num,) tensors.
        """
        out = {}
        for param in self._param_list:
            low, high = self._default_bounds[param]
            u = torch.rand(num, generator=generator, dtype=self.dtype,
                           device=self.device)
            out[param] = low + u * (high - low)
        return out

    def get_params(self):
        """Return the current parameter values keyed by name."""
        return {param: getattr(self, param) for param in self._param_list}

    def set_params(self, params):
        """Set model parameters from a dict, ``np.void`` or structured array.

        Raises:
            ValueError: If any parameter is not a numerical value.
            AttributeError: If the dict contains an unknown parameter name.
            TypeError: If a numpy array doesn't match the model's dtype, or
                the input is neither dict nor numpy array.
        """
        if isinstance(params, (np.void, np.ndarray)):
            if params.dtype != self._dtype:
                raise TypeError(
                    f"Structured parameter input for {type(self).__name__} "
                    f"must have dtype {self._dtype}, got {params.dtype}.")
            record = params if isinstance(params, np.void) else params[0]
            params = {p: record[p] for p in self._param_list}
        elif not isinstance(params, dict):
            raise TypeError(
                "set_params accepts a dict, a numpy record (np.void) or a "
                f"structured numpy array; got {type(params).__name__}.")

        for name, value in params.items():
            if name not in self._param_list:
                raise AttributeError(
                    f"'{name}' is not a parameter of {type(self).__name__}; "
                    f"valid names are {self._param_list}.")
            if not isinstance(value, numbers.Number):
                raise ValueError(
                    f"Parameter '{name}' needs a numeric value, got "
                    f"{type(value).__name__}.")
            setattr(self, name, value)

    def get_parameter_names(self):
        """Return the ordered names of this model's parameters."""
        return self._param_list

    def get_default_bounds(self):
        """Return the per-parameter (lower, upper) default bounds dict."""
        return self._default_bounds

    def get_dtype(self):
        """Return the structured numpy dtype used for parameter arrays."""
        return self._dtype

    # ------------------------------------------------------------------
    # Forecast mode (initial_state / return_final_state)
    # ------------------------------------------------------------------

    @staticmethod
    def _check_stateful_supported(engine):
        """Guard for forecast-mode calls on the classes that carry state on
        the sequential engine only (ABC, the snow-only Cemaneige)."""
        if engine != "scan":
            raise ValueError(
                "State-carrying simulation (initial_state / "
                "return_final_state) supports engine='scan' only for this "
                "model.")

    @staticmethod
    def _check_stateful_engine(engine, return_storage, mesh=None):
        """Guard for forecast-mode calls on the classes whose fused kernels
        carry state (GR4J, HBV-Edu and the snow compositions): both engines
        work, but the fused path is discharge-only and single-device."""
        check_engine(engine)
        if engine == "fused":
            check_fused_mesh(mesh, "sharded forecast ensembles")
            if return_storage:
                raise ValueError(
                    "engine='fused' computes discharge only; use "
                    "engine='scan' for storage trajectories.")

    def _normalize_state(self, initial_state, num):
        """``initial_state`` broadcast to ``num`` members, on the model's
        device in its dtype, clipped into its physical domain."""
        return normalize_state(initial_state, num, self.dtype, self.device)

    def _single_member_state(self, initial_state):
        """``initial_state`` as the one shared initial condition of a
        calibration (unbatched leaves)."""
        return single_member_state(initial_state, self.dtype, self.device)

    @staticmethod
    def _ensemble(kernel, forcing_args, params, mesh, state=None):
        """``kernel(*forcing_args, [state,] params)`` over the members, as
        a tuple of outputs with the member axis leading: one call, or on a
        mesh one call per shard through
        :func:`~..parallel.ensemble.ensemble_run` (the state split with the
        parameters)."""
        if mesh is not None:
            return ensemble_run(kernel, forcing_args, params, mesh,
                                state=state)
        state_args = () if state is None else (state,)
        out = kernel(*forcing_args, *state_args, params)
        return out if isinstance(out, tuple) else (out,)

    def _objective_per_device(self, build, inputs, mesh):
        """The calibration objective ``build(*inputs)``, a map from (P,
        dim) candidates to (P,) losses.  On a mesh, one objective per
        distinct device of the mesh, each built once (a ``fit``'s worth)
        from :func:`~..parallel.mesh.replicate`'s copy of ``inputs`` there,
        and each called with the candidates that lie on its device; the
        candidates on the model's own device (a polish) take the objective
        built from ``inputs`` as they are."""
        objective = build(*inputs)
        if mesh is None:
            return objective
        check_mesh(mesh)
        home = tree_leaves(inputs)[0].device
        objectives = {device: build(*copy) for device, copy in
                      replicate(inputs, mesh).items() if device != home}
        objectives[home] = objective
        return lambda X: objectives[X.device](X)

    @traced("fit")
    def _minimize(self, objective, seed, de_kwargs, engine="scan"):
        """``minimize`` of a batched objective on the model's device.
        SCE-UA on a mesh shards its complexes and takes a per-point
        objective, as JAX's does: there the ``'scan'`` engine's objective
        goes per point (:class:`_PointOfBatch`), and the fused one stays
        batched and raises, as JAX's Pallas objective does."""
        from ..tools.calibration import minimize

        per_point = (engine == "scan" and de_kwargs.get("method") == "sce"
                     and de_kwargs.get("mesh") is not None)
        if per_point:
            batched_objective = objective

            def objective(x):
                return _PointOfBatch.apply(x, batched_objective)
        bounds = tuple(self._default_bounds[p] for p in self._param_list)
        return minimize(objective, bounds, seed=seed, batched=not per_point,
                        device=self.device, dtype=self.dtype, **de_kwargs)

    @staticmethod
    def _to_reference_layout(series):
        """Member axis last (the reference output convention): (N, T) ->
        (T, N), (N, T, L) -> (T, L, N)."""
        return tuple(x.T if x.dim() == 2 else x.permute(1, 2, 0)
                     for x in series)

    @staticmethod
    def _stateful_output(series, final, return_storage, return_final_state):
        """What a forecast-mode ``simulate`` returns: discharge, the further
        series with ``return_storage``, the state with
        ``return_final_state``; a single output is not wrapped."""
        out = tuple(series) if return_storage else tuple(series[:1])
        if return_final_state:
            out = out + (final,)
        return out if len(out) > 1 else out[0]

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def _tensor(self, x):
        """``x`` as a tensor of the model's dtype on its device (host data
        to a card: a sync)."""
        return to_device("model.to_device", x, self.dtype, self.device)

    def _prepare_params(self, params):
        """Normalize a ``params`` argument to a dict of (N,) tensors.

        Accepts None (the instance's attributes), ``np.void``, a
        structured ndarray of the model dtype, or a dict of scalars /
        arrays / tensors.

        Returns:
            (param_dict, num_sets)
        """
        if params is None:
            pd = {p: self._tensor([getattr(self, p)])
                  for p in self._param_list}
            return pd, 1

        if isinstance(params, dict):
            arrs = {p: torch.atleast_1d(self._tensor(params[p]))
                    for p in self._param_list}
            num = max(a.shape[0] for a in arrs.values())
            pd = {p: a.expand(num).contiguous() for p, a in arrs.items()}
            return pd, num

        if isinstance(params, np.void):
            params = np.expand_dims(params, params.ndim)

        if isinstance(params, np.ndarray):
            if params.dtype != self._dtype:
                raise TypeError(
                    f"Structured parameter input for {type(self).__name__} "
                    f"must have dtype {self._dtype}, got {params.dtype}.")
            pd = {p: self._tensor(np.ascontiguousarray(params[p]))
                  for p in self._param_list}
            return pd, params.size

        raise TypeError(
            "Unsupported params input: pass None, a dict, a numpy record or "
            f"a structured array of dtype {self._dtype}.")
