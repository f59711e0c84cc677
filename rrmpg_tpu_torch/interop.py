"""Hand the same parameters and state to ``rrmpg_tpu`` and this package.

The JAX package takes parameters as a dict of arrays or a structured
numpy array and carries state as JAX ``NamedTuple``s; here they become
tensors on an explicit device.  Inputs are numpy (convert JAX arrays
with ``np.asarray`` first), so this module imports no JAX.
"""

import numpy as np
import torch

from .config import DEFAULT_DEVICE, resolve_device
from .models import states as _states
from .ops.gr4j import GR4JState


def params_from_numpy(params, device=DEFAULT_DEVICE, dtype=torch.float32):
    """Dict of (N,) tensors from a dict of arrays or a structured array,
    on the card unless ``device='cpu'``."""
    device = resolve_device(device)
    if isinstance(params, np.ndarray) and params.dtype.names:
        params = {name: params[name] for name in params.dtype.names}
    if not isinstance(params, dict):
        raise TypeError(
            "params_from_numpy takes a dict of arrays or a structured numpy "
            f"array; got {type(params).__name__}.")
    return {k: torch.tensor(np.atleast_1d(np.asarray(v, np.float64)),
                            dtype=dtype, device=device)
            for k, v in params.items()}


def layer_forcing_from_numpy(prec, mean_temp, frac_solid_prec, frac_ice=None,
                             ndsi=None, device=DEFAULT_DEVICE,
                             dtype=torch.float32):
    """The snow ops' layer forcing as tensors, on the card unless
    ``device='cpu'``: ``(prec, mean_temp, frac_solid_prec)``, each (T, L),
    followed by ``frac_ice`` (L,) and ``ndsi`` (L, T; an array or a sequence
    of L band series) where given -- the arrays the JAX ops take as they
    are."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    layers = tuple(tensor(a) for a in (prec, mean_temp, frac_solid_prec))
    shape = layers[0].shape
    if len(shape) != 2 or any(x.shape != shape for x in layers):
        raise ValueError(
            "prec, mean_temp and frac_solid_prec must share one (T, L) "
            f"shape; got {[tuple(x.shape) for x in layers]}.")
    out = layers
    if frac_ice is not None:
        frac_ice = tensor(frac_ice)
        if frac_ice.shape != shape[1:]:
            raise ValueError(
                f"frac_ice must hold one fraction per layer ({shape[1]}); "
                f"got shape {tuple(frac_ice.shape)}.")
        out += (frac_ice,)
    if ndsi is not None:
        ndsi = tensor(np.stack([np.asarray(b, np.float64) for b in ndsi]))
        if ndsi.shape != (shape[1], shape[0]):
            raise ValueError(
                f"ndsi must be (L, T) = ({shape[1]}, {shape[0]}); got "
                f"{tuple(ndsi.shape)}.")
        out += (ndsi,)
    return out


def regional_forcing_from_numpy(*series, layers=None, frac_ice=None,
                                device=DEFAULT_DEVICE, dtype=torch.float32):
    """The regional objectives' inputs as tensors, on the card unless
    ``device='cpu'``: each of ``series`` (C, T) (``prec, etp, qobs`` for
    GR4J; ``etp, qobs`` for the snow compositions), then, where given, the
    three (C, T, L) ``layers`` (``prec, mean_temp, frac_solid_prec``) and
    ``frac_ice``, (L,) shared or (C, L) per catchment -- the arrays the JAX
    regional objectives take as they are (e.g. ``load_basins``' columns)."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    out = tuple(tensor(a) for a in series)
    shapes = [tuple(x.shape) for x in out]
    if any(len(s) != 2 or s != shapes[0] for s in shapes):
        raise ValueError(
            f"regional series must share one (C, T) shape; got {shapes}.")
    if layers is not None:
        layers = tuple(tensor(a) for a in layers)
        shape = tuple(layers[0].shape)
        if (len(layers) != 3 or len(shape) != 3
                or any(tuple(x.shape) != shape for x in layers)
                or (shapes and shape[:2] != shapes[0])):
            raise ValueError(
                "prec, mean_temp and frac_solid_prec must share one "
                "(C, T, L) shape, with the (C, T) of the series; got "
                f"{[tuple(x.shape) for x in layers]} and {shapes}.")
        out += layers
    if frac_ice is not None:
        frac_ice = tensor(frac_ice)
        if layers is None:
            raise ValueError("frac_ice needs the layer forcing (layers=).")
        c, _, num_layers = layers[0].shape
        if tuple(frac_ice.shape) not in ((num_layers,), (c, num_layers)):
            raise ValueError(
                f"frac_ice must be ({num_layers},) or ({c}, {num_layers}); "
                f"got {tuple(frac_ice.shape)}.")
        out += (frac_ice,)
    return out


def gr4j_state_from_numpy(state, device=DEFAULT_DEVICE,
                          dtype=torch.float32):
    """Batched :class:`~rrmpg_tpu_torch.ops.gr4j.GR4JState` from the fields
    ``s`` (N,), ``r`` (N,) and ``pr_history`` (N, H) of a JAX ``GR4JState``
    (a single-member state with ``s``/``r`` scalars and ``pr_history``
    (H,) becomes N=1)."""
    device = resolve_device(device)

    def field(name):
        value = getattr(state, name) if hasattr(state, name) else state[name]
        return torch.tensor(np.asarray(value, np.float64), dtype=dtype,
                            device=device)

    s, r, hist = field("s"), field("r"), field("pr_history")
    return GR4JState(s=s.reshape(-1), r=r.reshape(-1),
                     pr_history=hist.reshape(s.numel(), -1))


def state_from_numpy(bundle_name, leaves, device=DEFAULT_DEVICE,
                     dtype=torch.float32):
    """A state bundle of this package from the leaves of the JAX package's
    bundle of the same name, given as numpy arrays in field order
    (``tuple(np.asarray(x) for x in jax_state)``), on the card unless
    ``device='cpu'``.  For ``'SnowGR4JState'`` ``leaves`` is the nested
    pair ``((snow_bundle_name, snow_leaves), gr4j_leaves)``.  Shapes are
    kept: batched leaves stay batched, a single-member state unbatched.
    """
    device = resolve_device(device)
    if bundle_name == "SnowGR4JState":
        (snow_name, snow_leaves), gr4j_leaves = leaves
        return _states.SnowGR4JState(
            snow=state_from_numpy(snow_name, snow_leaves, device, dtype),
            gr4j=state_from_numpy("GR4JState", gr4j_leaves, device, dtype))
    try:
        cls = _states.FLAT_BUNDLES[bundle_name]
    except KeyError:
        raise TypeError(
            f"unknown state bundle {bundle_name!r}; known: "
            f"{sorted(_states.FLAT_BUNDLES)} and 'SnowGR4JState'.") from None
    return cls(*(torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                              device=device) for x in leaves))


def state_to_numpy(state):
    """``(bundle_name, leaves)`` of a state bundle, the leaves as float64
    numpy arrays in field order -- what :func:`state_from_numpy` takes, and
    what the JAX package's bundle of that name is built from
    (``Bundle(*leaves)``)."""
    name = type(state).__name__
    if name == "SnowGR4JState":
        snow_name, snow_leaves = state_to_numpy(state.snow)
        return name, ((snow_name, snow_leaves),
                      state_to_numpy(state.gr4j)[1])
    return name, tuple(
        (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x)).astype(np.float64) for x in state)
