"""Ensemble data assimilation over simulation state bundles.

Counterpart of ``rrmpg_tpu/tools/assimilation.py``: the same public names
and parameters.  The forecast mode (``simulate(initial_state=/
return_final_state=)``) carries state bundles with a leading ensemble axis;
this module runs an ensemble forward over an observation window, then pulls
its states toward the measured discharge with the stochastic
(perturbed-observation) EnKF of Burgers, van Leeuwen & Evensen (1998), or
weights and resamples it with a bootstrap particle filter.

What differs from the JAX module:

* randomness comes from a ``torch.Generator`` on the state's device
  (``key=``; ``seed=`` seeds a new one, 0 if None); a JAX key raises
  ``TypeError``.  One generator is one stream, so every analysis draws a
  fixed set of variates in a fixed order whether it uses them or not: the
  EnKF its observation noise; the particle filter its resampling uniform,
  then the state jitter, then the parameter jitter.  The host and the scan
  backend then consume one stream alike;
* the dtype is that of the state's leaves (the model's, in a cycle);
* ``backend='scan'`` is a Python loop over windows that never reads the
  device: state, parameter matrix, importance weights and diagnostics stay
  on the device and come to the host once, after the last window.  The
  window step is the model's ``_warm_cycle_pieces``, whose ``engine``
  (from ``sim_kwargs``) picks the plain PyTorch ops or the warm entry of
  the state kernels K4 / K14 / K10;
* the systematic resampling index is clamped to N - 1 (JAX's gather clamps
  it; torch's would fail).

Domain guard: state bundles also pack *series-derived constants* (the
Cemaneige snow-cover threshold ``g_thresh``, the hysteresis annual solid
precipitation ``psol_annual``).  Those are facts about the forcing
climatology, not dynamical state, and are frozen by default
(:data:`CONSTANT_FIELDS`).
"""

import typing

import numpy as np
import torch

from ..models.states import is_repairable, repair_state
from .calibration import _generator

# State-bundle fields that are series-derived constants, not dynamical
# state: never updated by the filter unless explicitly un-frozen.
CONSTANT_FIELDS = frozenset({"g_thresh", "psol_annual"})

# Default ``postprocess``: repair known bundle types into their physical
# domain (see :func:`rrmpg_tpu_torch.models.states.repair_state`); pass
# ``postprocess=None`` explicitly to keep the raw analysis state.
REPAIR_KNOWN = "repair-known-bundles"


def _resolve_postprocess(postprocess, state):
    """Map the :data:`REPAIR_KNOWN` sentinel to :func:`repair_state` for
    known bundle types (no-op for other bundles); pass through any explicit
    callable or ``None``."""
    if postprocess is not REPAIR_KNOWN:
        return postprocess
    return repair_state if is_repairable(state) else None


class EnKFDiagnostics(typing.NamedTuple):
    """Per-cycle diagnostics of :func:`assimilation_cycle` (numpy arrays).

    Attributes:
        innovation: (C, 1) observation minus prior ensemble-mean
            prediction, per cycle.
        prior_spread: (C,) ensemble std (population, ddof 0) of the
            predicted observation before each update; weighted by the
            importance weights with ``method='pf'``.
        posterior_mean: the analysis-mean flattened state after each
            cycle, (C, S).
        param_mean: (C, K) analysis-mean parameters per cycle when
            ``estimate_params=True`` (columns in sorted-name order),
            else None.
        ess: (C,) effective sample size per cycle with ``method='pf'``,
            else None.
    """
    innovation: np.ndarray
    prior_spread: np.ndarray
    posterior_mean: np.ndarray
    param_mean: typing.Optional[np.ndarray] = None  # (C, K), joint mode
    ess: typing.Optional[np.ndarray] = None         # (C,), method='pf'


# ---------------------------------------------------------------------------
# State bundles as (N, S) matrices
# ---------------------------------------------------------------------------

def _is_bundle(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _named_leaves(state):
    """(field name, leaf) of every leaf of a NamedTuple bundle: fields in
    order, nested bundles depth first (the order of JAX's
    ``tree_flatten_with_path``)."""
    if not _is_bundle(state):
        raise TypeError(
            "a state must be a NamedTuple bundle of (N, ...) tensors (e.g. "
            "the state simulate(..., return_final_state=True) returns); "
            f"got {type(state).__name__}.")
    out = []
    for name, value in zip(state._fields, state):
        if _is_bundle(value):
            out.extend(_named_leaves(value))
        else:
            out.append((name, value))
    return out


def _rebuild_bundle(state, leaves):
    """``state``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    return type(state)(*(_rebuild_bundle(v, leaves) if _is_bundle(v)
                         else next(leaves) for v in state))


def _map_leaves(fn, state):
    return _rebuild_bundle(state, iter([fn(leaf) for _, leaf in
                                        _named_leaves(state)]))


def _flatten_state(state, frozen):
    """Split a state bundle into update-able and frozen leaves.

    Returns ``(X, rebuild)`` where ``X`` is the (N, S) matrix of all
    non-frozen state variables and ``rebuild(X_new)`` reassembles the full
    bundle (frozen leaves untouched).
    """
    named = _named_leaves(state)
    # Match frozen entries against the leaf's FIELD NAME, exactly:
    # substring matching would over-freeze -- frozen={'s'} on a GR4J
    # bundle must not also freeze 'pr_history'.
    leaves = [torch.as_tensor(leaf) for _, leaf in named]
    n = leaves[0].shape[0]
    update_idx = [i for i, (name, _) in enumerate(named)
                  if name not in frozen]
    if not update_idx:
        raise ValueError(
            "Every state field is frozen; nothing for the filter to "
            f"update (frozen={sorted(frozen)}).")
    shapes = [tuple(leaves[i].shape[1:]) for i in update_idx]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    X = torch.cat([leaves[i].reshape(n, -1) for i in update_idx], dim=1)

    def rebuild(X_new):
        out = list(leaves)
        off = 0
        for i, shape, size in zip(update_idx, shapes, sizes):
            out[i] = X_new[:, off:off + size].reshape((n,) + shape)
            off += size
        return _rebuild_bundle(state, iter(out))

    return X, rebuild


def _take(state, idx):
    """Every member-indexed leaf gathered at ``idx`` (constants too)."""
    return _map_leaves(lambda leaf: leaf.index_select(0, idx), state)


def _normal(generator, like, shape):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _perturb(X, z_mul, z_add, rel_std, abs_std):
    """Mean-preserving lognormal factors ``exp(sigma z - sigma^2 / 2)``
    (``rel_std`` a float or a 0-d tensor), then ``abs_std * z_add``."""
    X = X * torch.exp(rel_std * z_mul - 0.5 * rel_std ** 2)
    if abs_std:
        X = X + abs_std * z_add
    return X


def perturb_state(state, key, rel_std=0.2, abs_std=0.0,
                  frozen=CONSTANT_FIELDS):
    """Mean-preserving multiplicative perturbation of a state ensemble.

    An EnKF needs prior spread: an ensemble whose members share one state
    has zero covariance and a zero Kalman gain, so nothing assimilates.
    This spreads the members with lognormal factors
    ``exp(sigma * z - sigma^2 / 2)`` (unit mean, so the ensemble mean state
    is preserved and non-negative stores stay non-negative).

    Multiplicative factors leave *zero-valued* components at zero; either
    spin the ensemble up first or pass ``abs_std`` to add Gaussian floor
    noise to every perturbed component (not sign-safe: combine with a
    clipping ``postprocess`` downstream where a store must stay
    non-negative).

    Args:
        state: state bundle with leading ensemble axis ``N``.
        key: a ``torch.Generator`` on the state's device (None: a new one
            seeded with 0).  Draws the (N, S) factors' normals, then, with
            ``abs_std``, the additive ones.
        rel_std: relative (multiplicative) perturbation scale ``sigma``.
        abs_std: absolute (additive) Gaussian scale; 0 disables.
        frozen: exact leaf field names left unperturbed (default: the
            series-derived constants).

    Returns:
        The perturbed state bundle (frozen leaves unchanged).
    """
    X, rebuild = _flatten_state(state, frozenset(frozen))
    generator = _generator(key, None, X.device)
    z_mul = _normal(generator, X, X.shape)
    z_add = _normal(generator, X, X.shape) if abs_std else None
    return rebuild(_perturb(X, z_mul, z_add, rel_std, abs_std))


def _params_matrix(params, n, like):
    """Normalize a parameter ensemble (dict or structured array) to a name
    list, an (N, K) matrix in ``like``'s dtype on its device and a
    rebuilder into the original kind (a dict of (N,) tensors, or a
    structured numpy array)."""
    if isinstance(params, np.ndarray) and params.dtype.names:
        names = list(params.dtype.names)
        cols = [np.ascontiguousarray(params[nm]) for nm in names]
        out_dtype = params.dtype

        def rebuild(P):
            out = np.empty(n, dtype=out_dtype)
            host = P.cpu().numpy()
            for j, nm in enumerate(names):
                out[nm] = host[:, j]
            return out
    elif isinstance(params, dict):
        names = sorted(params)
        cols = [params[nm] for nm in names]

        def rebuild(P):
            return {nm: P[:, j] for j, nm in enumerate(names)}
    else:
        raise TypeError(
            "'params' must be a dict of (N,) arrays or a structured "
            f"numpy array; got {type(params).__name__}.")
    cols = [torch.as_tensor(c, dtype=like.dtype, device=like.device)
            for c in cols]
    for nm, c in zip(names, cols):
        if tuple(c.shape) != (n,):
            raise ValueError(
                f"params[{nm!r}] has shape {tuple(c.shape)}; expected ({n},) "
                "to match the state ensemble.")
    return names, torch.stack(cols, dim=1), rebuild


def _bounds_rows(param_bounds, names, like):
    """(K,) lower and upper clip bounds of the named parameters."""
    def row(k):
        return torch.tensor(
            [param_bounds.get(nm, (-np.inf, np.inf))[k] for nm in names],
            dtype=like.dtype, device=like.device)

    return row(0), row(1)


def _clip(P, lo, hi):
    return torch.minimum(torch.maximum(P, lo[None, :]), hi[None, :])


def _observations(predicted, obs, obs_std, like):
    """(Y (N, d), obs (d,), std (d,)) in ``like``'s dtype on its device,
    and the shape ``predicted`` came in."""
    Y = torch.as_tensor(predicted, dtype=like.dtype, device=like.device)
    shape = tuple(Y.shape)
    if Y.dim() == 1:
        Y = Y[:, None]
    obs_v = torch.atleast_1d(torch.as_tensor(obs, dtype=like.dtype,
                                             device=like.device))
    std_v = torch.broadcast_to(torch.as_tensor(obs_std, dtype=like.dtype,
                                               device=like.device),
                               obs_v.shape)
    return Y, obs_v, std_v, shape


# ---------------------------------------------------------------------------
# The ensemble Kalman filter
# ---------------------------------------------------------------------------

def _analysis(X, Y, obs_v, std_v, eps, inflation):
    """The EnKF analysis of the flattened (N, S) ensemble against the (N, d)
    predictions ``Y``, each member assimilating its own perturbed
    observation ``obs_v + eps`` (``eps`` the (N, d) noise, already scaled
    by ``std_v``)."""
    n = X.shape[0]
    x_mean = X.mean(dim=0)
    y_mean = Y.mean(dim=0)
    # Multiplicative inflation must scale the state AND the predicted-
    # observation anomalies together: inflating only Xa leaves pyy at the
    # uninflated spread, and the gain can exceed 1.
    Xa = (X - x_mean) * inflation
    Ya = (Y - y_mean) * inflation
    X = x_mean + Xa
    Y = y_mean + Ya
    pxy = Xa.T @ Ya / (n - 1)                            # (S, d)
    pyy = Ya.T @ Ya / (n - 1) + torch.diag(std_v ** 2)   # (d, d)
    innov = obs_v[None, :] + eps - Y                     # (N, d)
    # X_a = X + innov @ K^T with K = pxy @ pyy^{-1}, solved on the small
    # (d, d) system; solve_ex checks nothing, so it leaves the device alone.
    kt = torch.linalg.solve_ex(pyy, pxy.T, check_errors=False)[0]  # (d, S)
    return X + innov @ kt


def _enkf_step(X, rebuild, P, Y, obs_v, std_v, z, inflation, lo, hi,
               postprocess):
    """One analysis on the device: the flattened state ``X`` (and, with
    ``P`` (N, K), the parameters jointly) against ``Y``; ``z`` the (N, d)
    standard normals of the observation noise.  Returns (state, P)."""
    n_state = X.shape[1]
    if P is not None:
        X = torch.cat([X, P], dim=1)
    X_new = _analysis(X, Y, obs_v, std_v, std_v * z, inflation)
    if P is not None:
        X_new, P = X_new[:, :n_state], X_new[:, n_state:]
        if lo is not None:
            P = _clip(P, lo, hi)
    state = rebuild(X_new)
    if postprocess is not None:
        state = postprocess(state)
    return state, P


def enkf_update(state, predicted, obs, obs_std, key, inflation=1.0,
                frozen=CONSTANT_FIELDS, postprocess=REPAIR_KNOWN,
                params=None, param_bounds=None):
    """One stochastic-EnKF analysis step on an ensemble state bundle.

    Args:
        state: state bundle with leading ensemble axis ``N`` on every leaf
            (e.g. from ``simulate(..., return_final_state=True)`` under an
            ``N``-member parameter batch, or any NamedTuple of ``(N, ...)``
            tensors).
        predicted: (N,) or (N, d) per-member predicted observations.
        obs: scalar or (d,) measured value(s).
        obs_std: scalar or (d,) observation error standard deviation (R is
            diagonal).
        key: a ``torch.Generator`` on the state's device for the
            observation perturbations (None: a new one seeded with 0); one
            (N, d) draw of standard normals.
        inflation: multiplicative prior-spread inflation (1.0 = off).
        frozen: exact leaf field names excluded from the update (default
            :data:`CONSTANT_FIELDS`).
        postprocess: callable applied to the updated state.  Default
            :data:`REPAIR_KNOWN`: known bundle types are repaired into
            their physical domain (see
            :func:`rrmpg_tpu_torch.models.states.repair_state`).  ``None``
            keeps the raw analysis state.
        params: (optional) parameter ensemble (dict of (N,) arrays or
            structured numpy array) estimated jointly with the states (the
            augmented-state EnKF).
        param_bounds: (optional) dict of name -> (low, high); updated
            parameters are clipped into them.

    Returns:
        The updated state bundle -- or ``(state, params)`` when ``params``
        was given, ``params`` in its input kind.

    Raises:
        ValueError: on an ensemble of one or all-frozen states.
    """
    X, rebuild = _flatten_state(state, frozenset(frozen))
    n = X.shape[0]
    p_names = P = rebuild_params = None
    if params is not None:
        p_names, P, rebuild_params = _params_matrix(params, n, X)
    if n < 2:
        raise ValueError(
            "The EnKF needs an ensemble (N >= 2 members) to estimate "
            f"covariances; got N={n}. Simulate with a parameter batch "
            "or replicate the state with perturbations first.")
    Y, obs_v, std_v, shape = _observations(predicted, obs, obs_std, X)
    d = obs_v.shape[0]
    if tuple(Y.shape) != (n, d):
        raise ValueError(
            f"'predicted' has shape {shape}; expected ({n},) or ({n}, {d}) "
            f"to match the {n}-member ensemble and {d} observation(s).")
    postprocess = _resolve_postprocess(postprocess, state)
    generator = _generator(key, None, X.device)
    z = _normal(generator, X, Y.shape)
    lo = hi = None
    if P is not None and param_bounds:
        lo, hi = _bounds_rows(param_bounds, p_names, X)
    new_state, P_new = _enkf_step(X, rebuild, P, Y, obs_v, std_v, z,
                                  inflation, lo, hi, postprocess)
    if params is not None:
        return new_state, rebuild_params(P_new)
    return new_state


# ---------------------------------------------------------------------------
# The bootstrap particle filter
# ---------------------------------------------------------------------------

class PFInfo(typing.NamedTuple):
    """Diagnostics of one :func:`particle_filter_update` step.

    Attributes:
        ess: effective sample size ``1 / sum(w^2)`` of the posterior
            importance weights (N = uniform, 1 = degenerate).
        resampled: whether systematic resampling was triggered.
        weights: the (N,) posterior importance weights *before* any
            resampling (numpy).
        next_weights: the (N,) weights to carry into the next analysis
            step -- uniform after a resample, ``weights`` otherwise.
    """
    ess: float
    resampled: bool
    weights: np.ndarray
    next_weights: np.ndarray


def _pf_weights(Y, obs_v, std_v, w_prior):
    """Posterior importance weights: prior weights times the Gaussian
    observation likelihood, normalized (all in log space)."""
    log_w = (torch.log(w_prior)
             - 0.5 * torch.sum(((obs_v[None, :] - Y) / std_v) ** 2, dim=1))
    log_w = log_w - torch.logsumexp(log_w, dim=0)
    return torch.exp(log_w)


def _systematic_resample_indices(weights, u):
    """Systematic resampling: one uniform ``u`` in [0, 1), N stratified
    positions.  A cumulative sum that rounds below the last position would
    give index N; it is clamped to N - 1, as JAX's gather clamps it."""
    n = weights.shape[0]
    positions = (torch.arange(n, dtype=weights.dtype, device=weights.device)
                 + u) / n
    idx = torch.searchsorted(torch.cumsum(weights, dim=0), positions)
    return idx.clamp_(max=n - 1)


class _PFDraws(typing.NamedTuple):
    u: torch.Tensor                  # () resampling uniform
    z_state: typing.Optional[torch.Tensor]   # (N, S) state jitter
    z_params: typing.Optional[torch.Tensor]  # (N, K) parameter jitter


def _pf_draws(generator, like, n, n_state, n_params, jitter, param_jitter):
    """A particle filter step's variates, in the stream's fixed order: the
    resampling uniform, the state jitter's normals, the parameter
    jitter's; drawn whether the step resamples or not."""
    u = torch.rand((), generator=generator, dtype=like.dtype,
                   device=like.device)
    z_state = _normal(generator, like, (n, n_state)) if jitter else None
    z_params = (_normal(generator, like, (n, n_params)) if param_jitter
                else None)
    return _PFDraws(u, z_state, z_params)


def _pf_resample(state, P, idx, flag, draws, sigma, sigma_p, lo, hi,
                 frozen):
    """Gather the particles at ``idx``, then jitter with the scales
    ``sigma * flag`` / ``sigma_p * flag`` (0-d tensors; a flag of 0 gives
    factors ``exp(0) == 1`` exactly) and clip the parameters where
    ``flag``.  Returns (state, P)."""
    state = _take(state, idx)
    if P is not None:
        P = P.index_select(0, idx)
        if draws.z_params is not None:
            P = _perturb(P, draws.z_params, None, sigma_p * flag, 0.0)
            if lo is not None:
                P = torch.where(flag > 0, _clip(P, lo, hi), P)
    if draws.z_state is not None:
        X, rebuild = _flatten_state(state, frozen)
        state = rebuild(_perturb(X, draws.z_state, None, sigma * flag, 0.0))
    return state, P


def _scale(value, like):
    """A jitter scale as a 0-d tensor (made by a fill, not a copy)."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def particle_filter_update(state, predicted, obs, obs_std, key,
                           params=None, weights=None, ess_threshold=0.5,
                           jitter=0.0, param_jitter=0.0,
                           param_bounds=None, frozen=CONSTANT_FIELDS,
                           postprocess=REPAIR_KNOWN):
    """One bootstrap-particle-filter analysis step on a state ensemble.

    Members are *weighted* by the Gaussian observation likelihood of their
    predictions and systematically resampled when the effective sample size
    falls below ``ess_threshold * N``.  Weights persist between steps: pass
    the previous step's ``info.next_weights`` back as ``weights``.

    Args:
        state / predicted / obs / obs_std: as in :func:`enkf_update`.
        key: a ``torch.Generator`` on the state's device (None: a new one
            seeded with 0).  Every step draws the resampling uniform, then
            (with ``jitter``) the state jitter's (N, S) normals, then (with
            ``param_jitter`` and ``params``) the parameter jitter's, whether
            it resamples or not.
        params: (optional) parameter ensemble resampled *with* the states.
        weights: (N,) prior importance weights (uniform if omitted).
        ess_threshold: resample when ``ESS < ess_threshold * N`` (0 =
            never, 1 = always).
        jitter: relative scale of mean-preserving lognormal jitter applied
            to the non-frozen state variables after a resample.
        param_jitter: the same for ``params``, clipped into
            ``param_bounds`` when given.
        param_bounds: dict of name -> (low, high) for the parameter clip.
        frozen / postprocess: as in :func:`enkf_update` (``frozen`` only
            affects jitter; resampling permutes every leaf).

    Returns:
        ``(state, info)`` -- or ``(state, params, info)`` when ``params``
        was given -- with :class:`PFInfo` diagnostics.
    """
    frozen = frozenset(frozen)
    postprocess = _resolve_postprocess(postprocess, state)
    like = torch.as_tensor(_named_leaves(state)[0][1])
    Y, obs_v, std_v, shape = _observations(predicted, obs, obs_std, like)
    n = Y.shape[0]
    if n < 2:
        raise ValueError(
            "The particle filter needs an ensemble (N >= 2 members); "
            f"got N={n}.")
    if tuple(Y.shape) != (n, obs_v.shape[0]):
        raise ValueError(
            f"'predicted' has shape {shape}; expected ({n},) or "
            f"({n}, {obs_v.shape[0]}).")
    if weights is None:
        w_prior = torch.full((n,), 1.0 / n, dtype=like.dtype,
                             device=like.device)
    else:
        w_prior = torch.as_tensor(weights, dtype=like.dtype,
                                  device=like.device)
        if tuple(w_prior.shape) != (n,):
            raise ValueError(
                f"'weights' has shape {tuple(w_prior.shape)}; expected "
                f"({n},).")
    P = p_names = rebuild_params = None
    if params is not None:
        p_names, P, rebuild_params = _params_matrix(params, n, like)
    n_state = _flatten_state(state, frozen)[0].shape[1] if jitter else 0
    generator = _generator(key, None, like.device)
    draws = _pf_draws(generator, like, n, n_state,
                      0 if P is None else P.shape[1], jitter,
                      param_jitter if P is not None else 0.0)

    w_post = _pf_weights(Y, obs_v, std_v, w_prior)
    ess_t = 1.0 / torch.sum(w_post ** 2)
    resample = bool(ess_t < ess_threshold * n)
    ess = float(ess_t)
    if resample:
        lo = hi = None
        if P is not None and param_bounds:
            lo, hi = _bounds_rows(param_bounds, p_names, like)
        state, P = _pf_resample(
            state, P, _systematic_resample_indices(w_post, draws.u),
            like.new_ones(()), draws, _scale(jitter, like),
            _scale(param_jitter, like), lo, hi, frozen)
        next_w = torch.full((n,), 1.0 / n, dtype=like.dtype,
                            device=like.device)
    else:
        next_w = w_post
    if postprocess is not None:
        state = postprocess(state)
    info = PFInfo(ess=ess, resampled=resample,
                  weights=w_post.cpu().numpy(),
                  next_weights=next_w.cpu().numpy())
    if params is not None:
        new_params = rebuild_params(P) if resample else params
        return state, new_params, info
    return state, info


def _pf_step_device(state, P, y, obs_v, std_v, w, draws, ess_threshold,
                    uniform, members, sigma, sigma_p, lo, hi, frozen,
                    postprocess):
    """The branchless particle-filter analysis of the scan backend: the
    resample decision is a ``where`` over the gather indices (the identity
    when not resampling) and the jitter scales carry the 0/1 flag, so a
    step that does not resample leaves the ensemble bit for bit as
    :func:`particle_filter_update` does.  Returns (state, P, w, ess)."""
    n = y.shape[0]
    w_post = _pf_weights(y[:, None], obs_v, std_v, w)
    ess = 1.0 / torch.sum(w_post ** 2)
    resample = ess < ess_threshold * n
    flag = resample.to(y.dtype)
    idx = torch.where(resample, _systematic_resample_indices(w_post, draws.u),
                      members)
    state, P = _pf_resample(state, P, idx, flag, draws, sigma, sigma_p, lo,
                            hi, frozen)
    w_new = torch.where(resample, uniform, w_post)
    if postprocess is not None:
        state = postprocess(state)
    return state, P, w_new, ess


# ---------------------------------------------------------------------------
# Forecast / analysis cycling
# ---------------------------------------------------------------------------

def _forecast_stats(y, w):
    """(mean, spread) of the window-end predictions: unweighted (spread
    with ddof 0) for the EnKF, weighted by the importance weights ``w``
    for the particle filter."""
    if w is None:
        return y.mean(), y.std(correction=0)
    mean = w @ y
    return mean, torch.sqrt(w @ (y - mean) ** 2)


def _to_numpy(x):
    """``x`` on the host, C-ordered (the model's (T, N) discharge is a
    transposed view; both backends return the layout JAX's do)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().cpu().numpy()
    return np.ascontiguousarray(x)


def assimilation_cycle(model, forcings, obs, window, obs_std, params=None,
                       initial_state=None, key=None, seed=None,
                       inflation=1.0, frozen=CONSTANT_FIELDS,
                       postprocess=REPAIR_KNOWN, cold_start_kwargs=None,
                       estimate_params=False, param_bounds=None,
                       method="enkf", ess_threshold=0.5, jitter=0.0,
                       backend="host", **sim_kwargs):
    """Sequential forecast/analysis cycling over an observation series.

    Splits the forcing series into consecutive windows; for each window,
    runs the ensemble forward from its current states, then assimilates
    the window-end discharge observation with :func:`enkf_update` or
    :func:`particle_filter_update`.

    Args:
        model: a model class instance of this package whose ``simulate``
            supports forecast mode.
        forcings: dict of full-series forcing arrays keyed by the model's
            ``simulate`` argument names (e.g. ``{'prec': ..., 'etp': ...}``
            for GR4J).
        obs: (T,) observed discharge aligned with the forcings.
        window: assimilation window length in timesteps (the last
            ``T % window`` steps are left unassimilated).
        obs_std: observation error std (scalar).
        params: parameter ensemble (structured array / dict with N
            members); required (replicate one set for pure state
            estimation).
        initial_state: (optional) starting state bundle; cold start if
            omitted (``backend='host'`` only).
        key / seed: a ``torch.Generator`` on the model's device, or the
            seed of a new one (0 if None); every analysis draws from it.
        inflation / frozen / postprocess: see :func:`enkf_update`.
        cold_start_kwargs: (optional) keyword arguments for the first
            window when no ``initial_state`` is given.
        estimate_params: also update the parameter ensemble each cycle
            (requires ``params``).
        param_bounds: dict of name -> (low, high) clipping for the updated
            parameters (e.g. ``model._default_bounds``).
        method: ``'enkf'`` (default) or ``'pf'``.
        ess_threshold / jitter: particle-filter controls (see
            :func:`particle_filter_update`); with ``method='pf'`` and
            ``estimate_params=True`` ``jitter`` also applies to the
            parameters after resamples.
        backend: ``'host'`` (default) calls ``model.simulate`` once per
            window and reads the window's predictions on the host.
            ``'scan'`` runs the loop over windows on the device without a
            read from it until the last window: the model's
            ``_warm_cycle_pieces`` validate and preprocess the whole
            series once and advance one window (GR4J, ABC, HBV-Edu and the
            four snow compositions); it needs an ``initial_state``.
        **sim_kwargs: extra keyword arguments for every ``model.simulate``
            call (the scan backend's window step takes ``engine`` from
            them: ``'scan'`` by default, ``'fused'`` for the warm entry of
            the state kernels).

    Returns:
        ``(state, params, qsim, diagnostics)``: the final analysis bundle
        (tensors on the model's device), the final parameter ensemble in
        its input kind, the (T_assimilated, N) numpy array of prior
        (forecast) discharge of every window, and an
        :class:`EnKFDiagnostics`.
    """
    generator = _generator(key, seed, model.device)
    obs = _to_numpy(obs)
    lengths = {len(v) for v in forcings.values()}
    if len(lengths) != 1:
        raise ValueError(
            f"Forcing arrays have differing lengths {sorted(lengths)}.")
    (T,) = lengths
    if len(obs) != T:
        raise ValueError(
            f"obs has length {len(obs)} but the forcings have {T}.")
    n_cycles = T // window
    if n_cycles == 0:
        raise ValueError(
            f"window={window} exceeds the series length {T}.")
    if params is None:
        raise ValueError(
            "assimilation_cycle needs a 'params' ensemble (N >= 2 "
            "members): the EnKF estimates covariances across members. "
            "For pure state estimation replicate one parameter set, "
            "e.g. {k: np.full(n, v) for k, v in best.items()}.")
    if method not in ("enkf", "pf"):
        raise ValueError(
            f"Unsupported method {method!r}; choose 'enkf' or 'pf'.")
    if backend not in ("host", "scan"):
        raise ValueError(
            f"Unsupported backend {backend!r}; choose 'host' or 'scan'.")
    options = dict(inflation=inflation, frozen=frozenset(frozen),
                   postprocess=postprocess, estimate_params=estimate_params,
                   param_bounds=param_bounds, method=method,
                   ess_threshold=ess_threshold, jitter=jitter)
    if backend == "scan":
        if initial_state is None:
            raise ValueError(
                "backend='scan' needs an 'initial_state' (spin the "
                "ensemble up with one simulate(return_final_state=True) "
                "call); cold starts stay on backend='host'.")
        run, finish = _scan_program(model, forcings, obs, window, obs_std,
                                    params, initial_state, generator,
                                    n_cycles, sim_kwargs=sim_kwargs,
                                    **options)
        return finish(run())
    return _host_cycle(model, forcings, obs, window, obs_std, params,
                       initial_state, generator, n_cycles, cold_start_kwargs,
                       sim_kwargs, **options)


def _host_cycle(model, forcings, obs, window, obs_std, params, state,
                generator, n_cycles, cold_start_kwargs, sim_kwargs, *,
                inflation, frozen, postprocess, estimate_params,
                param_bounds, method, ess_threshold, jitter):
    """The host backend: ``model.simulate`` once per window."""
    qsim_parts, innovations, spreads, post_means = [], [], [], []
    param_means, ess_values = [], []
    pf_weights = None
    for c in range(n_cycles):
        sl = slice(c * window, (c + 1) * window)
        cycle_kwargs = {name: arr[sl] for name, arr in forcings.items()}
        cycle_kwargs.update(sim_kwargs)
        cycle_kwargs["params"] = params
        if state is not None:
            cycle_kwargs["initial_state"] = state
        elif cold_start_kwargs:
            cycle_kwargs.update(cold_start_kwargs)
        qsim, state = model.simulate(return_final_state=True,
                                     **cycle_kwargs)
        qsim_parts.append(_to_numpy(qsim))
        y_pred = qsim[-1]                                   # (N,)
        like = torch.as_tensor(_named_leaves(state)[0][1])
        obs_c = torch.as_tensor(obs[sl][-1:], dtype=like.dtype,
                                device=like.device)
        w = None
        if method == "pf":
            # The PF ensemble is weighted between resamples: its forecast
            # statistics are the weighted ones.
            n = y_pred.shape[0]
            w = (torch.full((n,), 1.0 / n, dtype=like.dtype,
                            device=like.device) if pf_weights is None
                 else torch.as_tensor(pf_weights, dtype=like.dtype,
                                      device=like.device))
        mean_pred, spread = _forecast_stats(y_pred, w)
        innovations.append(float(obs_c[0] - mean_pred))
        spreads.append(float(spread))
        if method == "pf":
            # params ALWAYS travel with their particle.
            state, params, info = particle_filter_update(
                state, y_pred, obs_c, obs_std, generator, params=params,
                weights=w, ess_threshold=ess_threshold, jitter=jitter,
                param_jitter=jitter if estimate_params else 0.0,
                param_bounds=param_bounds, frozen=frozen,
                postprocess=postprocess)
            pf_weights = info.next_weights
            ess_values.append(info.ess)
        elif estimate_params:
            state, params = enkf_update(
                state, y_pred, obs_c, obs_std, generator,
                inflation=inflation, frozen=frozen, postprocess=postprocess,
                params=params, param_bounds=param_bounds)
        else:
            state = enkf_update(state, y_pred, obs_c, obs_std, generator,
                                inflation=inflation, frozen=frozen,
                                postprocess=postprocess)
        if estimate_params:
            _, P, _ = _params_matrix(params, y_pred.shape[0], like)
            param_means.append(_to_numpy(P.mean(dim=0)))
        X, _ = _flatten_state(state, frozen)
        post_means.append(_to_numpy(X.mean(dim=0)))

    diags = EnKFDiagnostics(
        innovation=np.asarray(innovations)[:, None],
        prior_spread=np.asarray(spreads),
        posterior_mean=np.asarray(post_means),
        param_mean=np.asarray(param_means) if estimate_params else None,
        ess=np.asarray(ess_values) if method == "pf" else None)
    return state, params, np.concatenate(qsim_parts, axis=0), diags


def _scan_program(model, forcings, obs, window, obs_std, params,
                  initial_state, generator, n_cycles, *, inflation, frozen,
                  postprocess, estimate_params, param_bounds, method,
                  ess_threshold, jitter, sim_kwargs):
    """The scan backend as ``(run, finish)``: everything the loop needs is
    put on the device here; ``run()`` is the loop over windows, which
    reads nothing back from the device; ``finish(run())`` copies its
    results to the host once and returns what :func:`assimilation_cycle`
    returns."""
    dtype, device = model.dtype, model.device
    postprocess = _resolve_postprocess(postprocess, initial_state)
    state = _map_leaves(
        lambda x: torch.as_tensor(x, dtype=dtype, device=device),
        initial_state)
    if is_repairable(state):
        # The entry clamping the class warm path applies
        # (models/states.normalize_state).
        state = repair_state(state)
    like = torch.as_tensor(_named_leaves(state)[0][1])
    n = like.shape[0]
    names, P, rebuild_params = _params_matrix(params, n, like)
    pieces = getattr(model, "_warm_cycle_pieces", None)
    if pieces is None:
        raise ValueError(
            f"{type(model).__name__} does not support backend='scan' "
            "(no _warm_cycle_pieces); use backend='host'.")
    time_arrays, warm_step = pieces(forcings, sim_kwargs)

    T_used = n_cycles * window
    windowed = tuple(a[:T_used].reshape((n_cycles, window) + a.shape[1:])
                     for a in time_arrays)
    obs_end = torch.as_tensor(np.asarray(obs, dtype=np.float64)
                              [window - 1:T_used:window], dtype=dtype,
                              device=device)
    std_v = torch.as_tensor(obs_std, dtype=dtype, device=device).reshape(1)
    lo = hi = None
    if estimate_params and param_bounds:
        lo, hi = _bounds_rows(param_bounds, names, like)
    uniform = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    members = torch.arange(n, device=device)
    sigma, sigma_p = _scale(jitter, like), _scale(jitter, like)
    param_jitter = jitter if estimate_params else 0.0
    n_state = _flatten_state(state, frozen)[0].shape[1]

    def run():
        st, Pc, w = state, P, uniform
        qsims, innovs, spreads, post_means, p_means, ess_values = (
            [], [], [], [], [], [])
        for c in range(n_cycles):
            arrays = tuple(a[c] for a in windowed)
            qsim, st = warm_step(
                arrays, st, {nm: Pc[:, j] for j, nm in enumerate(names)})
            y = qsim[:, -1]
            obs_c = obs_end[c:c + 1]
            if method == "pf":
                mean_pred, spread = _forecast_stats(y, w)
                draws = _pf_draws(generator, like, n, n_state,
                                  Pc.shape[1], jitter, param_jitter)
                st, Pc, w, ess = _pf_step_device(
                    st, Pc, y, obs_c, std_v, w, draws, ess_threshold,
                    uniform, members, sigma, sigma_p, lo, hi, frozen,
                    postprocess)
                ess_values.append(ess)
            else:
                mean_pred, spread = _forecast_stats(y, None)
                z = _normal(generator, like, (n, 1))
                X, rebuild = _flatten_state(st, frozen)
                st, P_new = _enkf_step(
                    X, rebuild, Pc if estimate_params else None, y[:, None],
                    obs_c, std_v, z, inflation, lo, hi, postprocess)
                if estimate_params:
                    Pc = P_new
            qsims.append(qsim)
            innovs.append(obs_c[0] - mean_pred)
            spreads.append(spread)
            post_means.append(_flatten_state(st, frozen)[0].mean(dim=0))
            p_means.append(Pc.mean(dim=0))
        return st, Pc, qsims, innovs, spreads, post_means, p_means, ess_values

    def finish(out):
        st, Pc, qsims, innovs, spreads, post_means, p_means, ess_values = out
        diags = EnKFDiagnostics(
            innovation=_to_numpy(torch.stack(innovs))[:, None],
            prior_spread=_to_numpy(torch.stack(spreads)),
            posterior_mean=_to_numpy(torch.stack(post_means)),
            param_mean=(_to_numpy(torch.stack(p_means)) if estimate_params
                        else None),
            ess=_to_numpy(torch.stack(ess_values)) if method == "pf" else None)
        # (C, N, w) -> (C, w, N) -> (C w, N), the host backend's layout.
        qsim_all = _to_numpy(torch.stack(qsims).transpose(1, 2)
                             .reshape(T_used, n))
        # PF resampling permutes the parameter ensemble even without
        # estimate_params (a particle is the (state, params) pair).
        params_out = (rebuild_params(Pc)
                      if estimate_params or method == "pf" else params)
        return st, params_out, qsim_all, diags

    return run, finish
