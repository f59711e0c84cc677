"""Class-level simulation state bundles (forecast / operational mode).

Counterpart of ``rrmpg_tpu/models/states.py``.
``model.simulate(..., return_final_state=True)`` returns one of these
bundles; passing it back as ``initial_state=`` continues the simulation
where the previous call stopped.  Each bundle packs the ops-level carry
*plus* the series-derived constants its warm path needs (the Cemaneige
snow-cover threshold or mean annual solid precipitation of the ORIGINAL
series), so a state is self-contained.

Batching convention: every leaf is a tensor with a leading ensemble axis
``N`` matching the parameter batch of the call that produced it (``N = 1``
for an instance-parameter simulation).  ``initial_state`` inputs may
instead carry unbatched leaves (one shared state for all members), and
leaves may be numpy arrays (as :func:`~..tools.checkpoint.load_state`
returns them); :func:`normalize_state` broadcasts them and puts them on the
model's device in its dtype.
"""

import typing

import torch

from ..config import DEFAULT_DEVICE, resolve_device
from ..ops.gr4j import GR4JState


class ABCState(typing.NamedTuple):
    """ABC model state: the single storage."""
    storage: torch.Tensor  # (N,)


class HBVEduState(typing.NamedTuple):
    """HBV-Edu state: the four storages."""
    snow: torch.Tensor  # (N,)
    soil: torch.Tensor  # (N,)
    s1: torch.Tensor    # (N,)
    s2: torch.Tensor    # (N,)


class CemaneigeState(typing.NamedTuple):
    """Cemaneige state: per-layer snowpack/thermal state + the snow-cover
    threshold of the *original* series (a data-dependent precompute that a
    continuation segment must not recompute from its own, shorter
    forcing)."""
    g: torch.Tensor         # (N, L) snowpack SWE
    etg: torch.Tensor       # (N, L) snowpack thermal state
    g_thresh: torch.Tensor  # (N, L) snow-cover threshold, original series


class CemaneigeHystState(typing.NamedTuple):
    """Hysteresis-Cemaneige state: adds the SCA hysteresis carry and the
    original series' mean annual solid precipitation (the melt-threshold
    precompute)."""
    g: torch.Tensor            # (N, L)
    etg: torch.Tensor          # (N, L)
    sca: torch.Tensor          # (N, L) snow-covered area fraction
    swe_max: torch.Tensor      # (N, L) running SWE maximum
    psol_annual: torch.Tensor  # (N, L) annual solid precip, original series


class SnowGR4JState(typing.NamedTuple):
    """Combined state of the snow + GR4J composition classes."""
    snow: typing.Union[CemaneigeState, CemaneigeHystState]
    gr4j: GR4JState


# The flat bundles by name, as state files and interop tag them.
FLAT_BUNDLES = {cls.__name__: cls for cls in
                (ABCState, HBVEduState, CemaneigeState, CemaneigeHystState,
                 GR4JState)}


# Unbatched ("core") ndim of every field, for input normalization.
_CORE_NDIMS = {
    ABCState: (0,),
    HBVEduState: (0, 0, 0, 0),
    CemaneigeState: (1, 1, 1),
    CemaneigeHystState: (1, 1, 1, 1, 1),
    GR4JState: (0, 0, 1),
}


# Physical domain of every field, enforced by :func:`repair_state`:
# ``(low, high)`` clip bounds (None = unbounded on that side).  The
# hysteresis coupling ``swe_max >= g`` is handled separately.
_FIELD_DOMAINS = {
    ABCState: {"storage": (0.0, None)},
    HBVEduState: {"snow": (0.0, None), "soil": (0.0, None),
                  "s1": (0.0, None), "s2": (0.0, None)},
    CemaneigeState: {"g": (0.0, None), "etg": (None, 0.0),
                     "g_thresh": (0.0, None)},
    CemaneigeHystState: {"g": (0.0, None), "etg": (None, 0.0),
                         "sca": (0.0, 1.0), "swe_max": (0.0, None),
                         "psol_annual": (0.0, None)},
    GR4JState: {"s": (0.0, None), "r": (0.0, None),
                "pr_history": (0.0, None)},
}


def map_state(fn, state):
    """Apply ``fn`` to every leaf of a bundle (nested bundles included)."""
    if type(state) is SnowGR4JState:
        return SnowGR4JState(snow=map_state(fn, state.snow),
                             gr4j=map_state(fn, state.gr4j))
    return type(state)(*(fn(leaf) for leaf in state))


def repair_state(state):
    """Clip a state bundle back into its physical domain (idempotent).

    The simulation paths assume their carried states are physical: stores
    and filter histories non-negative, the Cemaneige thermal state
    ``etg <= 0``, the snow-cover fraction ``sca`` in ``[0, 1]``, and the
    hysteresis invariant ``swe_max >= g``.  States from a filter analysis,
    a hand-edited file or user code can violate these -- a negative GR4J
    routing store feeds ``x2 * (r / x3)**3.5`` a negative base and the
    whole continuation turns NaN.  This clips every field into its domain
    and restores ``swe_max >= g``.

    On an already-physical state this is a bit-exact identity, so it is
    safe to apply unconditionally at warm-continuation entry.

    Accepts any known bundle type (:data:`_FIELD_DOMAINS` keys),
    :class:`SnowGR4JState` (repaired recursively), or ``None`` (returned
    unchanged).  Leaves are tensors.
    """
    if state is None:
        return None
    cls = type(state)
    if cls is SnowGR4JState:
        return SnowGR4JState(snow=repair_state(state.snow),
                             gr4j=repair_state(state.gr4j))
    try:
        domains = _FIELD_DOMAINS[cls]
    except KeyError:
        raise TypeError(
            f"repair_state knows no physical domain for "
            f"{cls.__name__}; known bundles: "
            f"{sorted(c.__name__ for c in _FIELD_DOMAINS)} and "
            "SnowGR4JState.") from None
    repaired = {}
    for fld in cls._fields:
        low, high = domains[fld]
        leaf = torch.as_tensor(getattr(state, fld))
        # The bounds are filled in on the leaf's device, not copied there:
        # a repair inside a device-resident loop reads nothing back.
        if low is not None:
            leaf = torch.maximum(leaf, leaf.new_full((), low))
        if high is not None:
            leaf = torch.minimum(leaf, leaf.new_full((), high))
        repaired[fld] = leaf
    if cls is CemaneigeHystState:
        # Hysteresis coupling: the running SWE maximum can never sit
        # below the current snowpack.
        repaired["swe_max"] = torch.maximum(repaired["swe_max"],
                                            repaired["g"])
    return cls(**repaired)


def is_repairable(state):
    """True if :func:`repair_state` knows this bundle's domain."""
    cls = type(state)
    if cls is SnowGR4JState:
        return is_repairable(state.snow) and is_repairable(state.gr4j)
    return cls in _FIELD_DOMAINS


def _normalize_leaf(leaf, core_ndim, num, name, dtype, device):
    arr = torch.as_tensor(leaf, dtype=dtype, device=device)
    if arr.dim() == core_ndim:
        return arr.expand((num,) + tuple(arr.shape))
    if arr.dim() == core_ndim + 1:
        if arr.shape[0] == num:
            return arr
        if arr.shape[0] == 1:
            return arr.expand((num,) + tuple(arr.shape[1:]))
        raise ValueError(
            f"initial_state.{name} is batched over {arr.shape[0]} members "
            f"but {num} parameter set(s) are being simulated; the leading "
            "state axis must match the parameter batch (or be absent / 1 "
            "to share one state).")
    raise ValueError(
        f"initial_state.{name} has ndim {arr.dim()}; expected {core_ndim} "
        f"(one shared state) or {core_ndim + 1} (leading ensemble axis).")


def normalize_state(state, num, dtype, device=DEFAULT_DEVICE):
    """Broadcast/validate a state bundle to leading ensemble axis ``num``,
    as tensors of ``dtype`` on ``device`` (the card unless the caller names
    another).

    Accepts bundles whose leaves are unbatched (shared across members),
    batched over 1, or batched over exactly ``num``; anything else raises.
    Nested bundles (:class:`SnowGR4JState`) are handled recursively.

    The result is also passed through :func:`repair_state`: the warm paths
    assume physical carries, so an out-of-domain input (a raw
    filter-analysis state with a negative store) enters as clipped physics
    rather than propagating silent NaN.  Physical inputs pass through
    bit-exactly.
    """
    return repair_state(_normalize_shape(state, num, dtype,
                                         resolve_device(device)))


def _normalize_shape(state, num, dtype, device):
    cls = type(state)
    if cls is SnowGR4JState:
        return SnowGR4JState(
            snow=_normalize_shape(state.snow, num, dtype, device),
            gr4j=_normalize_shape(state.gr4j, num, dtype, device))
    core = _CORE_NDIMS[cls]
    fields = cls._fields
    return cls(*(_normalize_leaf(leaf, nd, num, f"{cls.__name__}.{fld}",
                                 dtype, device)
                 for leaf, nd, fld in zip(state, core, fields)))


def single_member_state(state, dtype, device=DEFAULT_DEVICE):
    """Collapse a state bundle to unbatched leaves.

    Calibration from a carried state (``fit(initial_state=)``) needs ONE
    initial condition shared by every candidate parameter vector; accepts
    unbatched leaves or a leading ensemble axis of exactly 1 (squeezed).
    The result is repaired into its physical domain (see
    :func:`repair_state`); physical inputs pass through bit-exactly.
    """
    return repair_state(_single_member_shape(state, dtype,
                                             resolve_device(device)))


def _single_member_shape(state, dtype, device):
    cls = type(state)
    if cls is SnowGR4JState:
        return SnowGR4JState(
            snow=_single_member_shape(state.snow, dtype, device),
            gr4j=_single_member_shape(state.gr4j, dtype, device))
    core = _CORE_NDIMS[cls]

    def collapse(leaf, core_ndim, name):
        arr = torch.as_tensor(leaf, dtype=dtype, device=device)
        if arr.dim() == core_ndim:
            return arr
        if arr.dim() == core_ndim + 1 and arr.shape[0] == 1:
            return arr[0]
        raise ValueError(
            f"Calibration from a state needs one initial condition, but "
            f"initial_state.{name} has shape {tuple(arr.shape)}; pass the "
            "state of a single member (e.g. index every leaf of the bundle "
            "with map_state(lambda x: x[i:i + 1], state)).")

    return cls(*(collapse(leaf, nd, f"{cls.__name__}.{fld}")
                 for leaf, nd, fld in zip(state, core, cls._fields)))


def broadcast_state(state, num):
    """A single-member bundle (unbatched leaves) as ``num`` identical
    members, every leaf contiguous: one shared initial condition for a
    whole candidate batch."""
    return map_state(
        lambda leaf: leaf.expand((num,) + tuple(leaf.shape)).contiguous(),
        state)


def check_state_type(state, expected, model_name, snow_cls=None):
    """Raise a helpful TypeError for a wrong ``initial_state`` input."""
    if not isinstance(state, expected):
        raise TypeError(
            f"'initial_state' for {model_name} must be a "
            f"{expected.__name__} (as returned by simulate(..., "
            f"return_final_state=True)); got {type(state).__name__}.")
    if snow_cls is not None and not isinstance(state.snow, snow_cls):
        raise TypeError(
            f"'initial_state.snow' for {model_name} must be a "
            f"{snow_cls.__name__}; got {type(state.snow).__name__}.")
