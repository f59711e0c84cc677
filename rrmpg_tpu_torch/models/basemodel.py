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

from ..config import DEFAULT_DTYPE, resolve_device, resolve_dtype


class BaseModel(object):
    """Base class for all rainfall-runoff models."""

    # List of strings containing all model parameters
    _param_list = []

    # Dict containing the default parameter bounds
    _default_bounds = {}

    # Structured numpy datatype (one float64 field per parameter).
    _dtype = np.dtype([])

    def __init__(self, params=None, device="cpu", dtype=DEFAULT_DTYPE):
        """Initialize a hydrological model.

        Args:
            params: (optional) dict with one value per model parameter; if
                omitted, random parameters are drawn within the bounds.
            device: where the model computes (``'cpu'``, ``'cuda'``, ...).
            dtype: ``torch.float32`` (default) or ``torch.float64``.

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
    # Placement
    # ------------------------------------------------------------------

    def _tensor(self, x):
        """``x`` as a tensor of the model's dtype on its device."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

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
