"""Hand the same parameters and state to ``rrmpg_tpu`` and this package.

The JAX package takes parameters as a dict of arrays or a structured
numpy array and carries state as JAX ``NamedTuple``s; here they become
tensors on an explicit device.  Inputs are numpy (convert JAX arrays
with ``np.asarray`` first), so this module imports no JAX.
"""

import numpy as np
import torch

from .ops.gr4j import GR4JState


def params_from_numpy(params, device="cpu", dtype=torch.float32):
    """Dict of (N,) tensors from a dict of arrays or a structured array."""
    if isinstance(params, np.ndarray) and params.dtype.names:
        params = {name: params[name] for name in params.dtype.names}
    if not isinstance(params, dict):
        raise TypeError(
            "params_from_numpy takes a dict of arrays or a structured numpy "
            f"array; got {type(params).__name__}.")
    return {k: torch.tensor(np.atleast_1d(np.asarray(v, np.float64)),
                            dtype=dtype, device=device)
            for k, v in params.items()}


def gr4j_state_from_numpy(state, device="cpu", dtype=torch.float32):
    """Batched :class:`~rrmpg_tpu_torch.ops.gr4j.GR4JState` from the fields
    ``s`` (N,), ``r`` (N,) and ``pr_history`` (N, H) of a JAX ``GR4JState``
    (a single-member state with ``s``/``r`` scalars and ``pr_history``
    (H,) becomes N=1)."""
    def field(name):
        value = getattr(state, name) if hasattr(state, name) else state[name]
        return torch.tensor(np.asarray(value, np.float64), dtype=dtype,
                            device=device)

    s, r, hist = field("s"), field("r"), field("pr_history")
    return GR4JState(s=s.reshape(-1), r=r.reshape(-1),
                     pr_history=hist.reshape(s.numel(), -1))
