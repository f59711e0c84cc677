"""Global sensitivity analysis: Sobol' indices and Morris screening.

Counterpart of ``rrmpg_tpu/tools/sensitivity.py``.  The whole design
matrix -- ``n (dim + 2)`` points for Saltelli, ``R (dim + 1)`` for Morris
-- is evaluated in a few batched calls on the device (with a fused
objective, one kernel launch a chunk):

* :func:`sobol_indices` -- first-order ``S1`` (Saltelli et al. 2010) and
  total-order ``ST`` (Jansen 1999) indices from a Saltelli design on a
  scrambled Sobol' sequence.
* :func:`morris_screening` -- elementary-effects ``mu``, ``mu_star``
  (Campolongo et al. 2007) and ``sigma`` from Morris (1991) trajectories.

The designs are made on the host with scipy's ``qmc.Sobol`` and numpy's
``default_rng``, as in the JAX package, so with the same ``seed`` both
packages evaluate the same points.  Objectives follow the calibration
contract: ``(dim,) -> scalar`` mapped over a chunk, or with
``batched=True`` ``(P, dim) -> (P,)``.  Results are float64 numpy.
"""

import typing
import warnings

import numpy as np
import torch

from ..config import (DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device,
                      resolve_dtype)
from ..parallel.mesh import check_mesh, pad_to_multiple
from .calibration import _generator, _mesh_shards, _population_objective


class SobolResult(typing.NamedTuple):
    """Variance-based sensitivity indices.

    Attributes:
        s1: (dim,) first-order indices (main effects).
        st: (dim,) total-order indices (main + all interactions).
        s1_conf / st_conf: (dim,) half-widths of the bootstrap 95%
            confidence intervals (zeros when ``bootstrap=0``).
        mean / var: moments of the model output over the design.
        n: base sample size of the Saltelli design.
        n_used: rows that survived the non-finite filter (a row is the
            complete tuple ``f(A_j), f(B_j), f(AB_ij) for all i``).
        nfev: total objective evaluations (``n * (dim + 2)``).
        names: parameter names, if given.
    """
    s1: np.ndarray
    st: np.ndarray
    s1_conf: np.ndarray
    st_conf: np.ndarray
    mean: float
    var: float
    n: int
    n_used: int
    nfev: int
    names: tuple


class MorrisResult(typing.NamedTuple):
    """Elementary-effects screening statistics.

    Attributes:
        mu: (dim,) mean elementary effect (signed).
        mu_star: (dim,) mean absolute elementary effect, the robust
            importance ranking of Campolongo et al. (2007).
        sigma: (dim,) standard deviation of the effects (interaction /
            nonlinearity indicator).
        mu_star_conf: (dim,) bootstrap 95% half-widths (zeros when
            ``bootstrap=0``).
        n_effects: (dim,) finite elementary effects per parameter.
        nfev: total objective evaluations (``R * (dim + 1)``).
        names: parameter names, if given.

    Elementary effects are taken in normalized [0, 1] coordinates, so
    ``mu_star`` is comparable across parameters of different units.
    """
    mu: np.ndarray
    mu_star: np.ndarray
    sigma: np.ndarray
    mu_star_conf: np.ndarray
    n_effects: np.ndarray
    nfev: int
    names: tuple


def _evaluate_design(objective, X, batched, batch_size, mesh, mesh_axis,
                     device, dtype):
    """Evaluate every row of the (m, dim) host design matrix in chunks of
    ``batch_size`` rows on ``device``; float64 numpy (m,).  On a mesh each
    chunk is split over ``mesh_axis``: ``batch_size`` is rounded up to a
    multiple of its shard count, and a short chunk is padded by repeating
    its last row, as JAX pads it (the padding's values are dropped)."""
    mesh_axis, n_shards = _mesh_shards(mesh, mesh_axis)
    m = X.shape[0]
    batch_size = pad_to_multiple(m if batch_size is None else batch_size,
                                 n_shards)
    out = np.empty(m, dtype=np.float64)
    for lo in range(0, m, batch_size):
        chunk = X[lo:lo + batch_size]
        n = chunk.shape[0]
        if n % n_shards:
            pad = pad_to_multiple(n, n_shards) - n
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        vals = _population_objective(objective, batched, chunk.shape[0],
                                     mesh, mesh_axis)(
            torch.as_tensor(chunk, dtype=dtype, device=device))[:n]
        out[lo:lo + n] = vals.detach().cpu().numpy()
    return out


def _parse_bounds(bounds, names):
    lows = np.asarray([b[0] for b in bounds], dtype=np.float64)
    highs = np.asarray([b[1] for b in bounds], dtype=np.float64)
    dim = len(bounds)
    if names is not None:
        names = tuple(names)
        if len(names) != dim:
            raise ValueError(
                f"Got {len(names)} names for {dim} parameters.")
    return lows, highs, dim, names


def _seed_from(key, seed, device):
    """The integer seed of the host design: ``seed``, or one drawn from the
    ``torch.Generator`` ``key`` (where JAX draws from its PRNG key)."""
    if key is None:
        return 0 if seed is None else seed
    generator = _generator(key, None, device)
    return int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=device))


def sobol_indices(objective, bounds, n=1024, key=None, seed=None,
                  batched=False, batch_size=None, mesh=None, mesh_axis=None,
                  bootstrap=100, names=None, device=DEFAULT_DEVICE,
                  dtype=DEFAULT_DTYPE):
    """First- and total-order Sobol' indices via a Saltelli design.

    The design is two independent quasi-random matrices ``A, B`` of ``n``
    points (a scrambled Sobol' sequence in ``2 dim`` dimensions, split
    column-wise) plus the ``dim`` hybrids ``AB_i`` (``A`` with column ``i``
    from ``B``): ``n (dim + 2)`` model evaluations.

    Args:
        objective: ``(dim,) -> scalar`` model output, mapped over a chunk;
            with ``batched=True``, ``(P, dim) -> (P,)`` (a fused kernel).
        bounds: sequence of (low, high) pairs, one per parameter.
        n: base sample size (powers of two keep the Sobol' sequence
            balanced; others work, scipy's warning suppressed).
        key: (optional) ``torch.Generator`` on ``device``; the design's
            integer seed is drawn from it.  Else ``seed`` (0 if None).
        seed: int seed of the sequence scrambling and the bootstrap.
        batched: see ``objective``.
        batch_size: evaluate the design in chunks of this many rows
            (default: one call for everything).
        mesh, mesh_axis: (optional) :class:`~..parallel.mesh.Mesh` and its
            axis (default 'ensemble'): every chunk of the design is split
            over the mesh, one call of the objective a shard.
        bootstrap: number of bootstrap resamples for the confidence
            intervals (0 disables).
        names: (optional) parameter names carried into the result.
        device, dtype: where (the card by default) and in which float type
            the design is evaluated.

    Returns:
        :class:`SobolResult`.  Rows where any of the ``dim + 2``
        evaluations is non-finite are excluded; ``n_used`` counts the rest.

    Raises:
        ValueError: if fewer than 8 complete rows survive the non-finite
            filter, or names/bounds lengths mismatch.
    """
    check_mesh(mesh)
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    lows, highs, dim, names = _parse_bounds(bounds, names)
    rng_seed = _seed_from(key, seed, device)

    from scipy.stats import qmc
    with warnings.catch_warnings():
        # Unbalanced (non power-of-two) n is the caller's informed choice.
        warnings.simplefilter("ignore", UserWarning)
        ab = qmc.Sobol(d=2 * dim, scramble=True, seed=rng_seed).random(n)
    A = ab[:, :dim]
    B = ab[:, dim:]

    # Design: [A; B; AB_0; ...; AB_{dim-1}] in normalized coordinates.
    blocks = [A, B]
    for i in range(dim):
        ab_i = A.copy()
        ab_i[:, i] = B[:, i]
        blocks.append(ab_i)
    X = lows + np.concatenate(blocks, axis=0) * (highs - lows)

    f = _evaluate_design(objective, X, batched, batch_size, mesh, mesh_axis,
                         device, dtype)
    f_A = f[:n]
    f_B = f[n:2 * n]
    f_AB = f[2 * n:].reshape(dim, n)

    keep = (np.isfinite(f_A) & np.isfinite(f_B)
            & np.isfinite(f_AB).all(axis=0))
    n_used = int(keep.sum())
    if n_used < 8:
        raise ValueError(
            f"Only {n_used}/{n} Saltelli rows produced finite outputs "
            "for every design point; the objective is non-finite over "
            "most of the bounded region. Tighten the bounds or guard "
            "the objective.")
    f_A, f_B, f_AB = f_A[keep], f_B[keep], f_AB[:, keep]

    def estimate(f_A, f_B, f_AB):
        # Centred outputs: the estimators' variance grows with the squared
        # output mean otherwise.
        mu = np.mean(np.concatenate([f_A, f_B]))
        f_A, f_B, f_AB = f_A - mu, f_B - mu, f_AB - mu
        var = np.var(np.concatenate([f_A, f_B]))
        if var == 0.0:
            z = np.zeros(dim)
            return z, z
        s1 = np.mean(f_B[None, :] * (f_AB - f_A[None, :]), axis=1) / var
        st = 0.5 * np.mean((f_A[None, :] - f_AB) ** 2, axis=1) / var
        return s1, st

    s1, st = estimate(f_A, f_B, f_AB)

    s1_conf = np.zeros(dim)
    st_conf = np.zeros(dim)
    if bootstrap:
        rng = np.random.default_rng(rng_seed + 1)
        s1_bs = np.empty((bootstrap, dim))
        st_bs = np.empty((bootstrap, dim))
        for b in range(bootstrap):
            idx = rng.integers(0, n_used, n_used)
            s1_bs[b], st_bs[b] = estimate(f_A[idx], f_B[idx], f_AB[:, idx])
        s1_conf = 1.96 * s1_bs.std(axis=0, ddof=1)
        st_conf = 1.96 * st_bs.std(axis=0, ddof=1)

    all_f = np.concatenate([f_A, f_B])
    return SobolResult(
        s1=s1, st=st, s1_conf=s1_conf, st_conf=st_conf,
        mean=float(all_f.mean()), var=float(np.var(all_f)),
        n=n, n_used=n_used, nfev=n * (dim + 2), names=names)


def _morris_trajectories(rng, R, dim, num_levels):
    """Build R Morris trajectories, each (dim + 1, dim), in [0, 1]."""
    delta = num_levels / (2.0 * (num_levels - 1))
    # Base points on the sub-grid {0, 1/(p-1), ...} that keeps x + delta
    # inside [0, 1].
    n_starts = num_levels // 2
    grid = np.arange(n_starts) / (num_levels - 1)

    J = np.ones((dim + 1, dim))
    B = np.tril(np.ones((dim + 1, dim)), k=-1)

    trajs = np.empty((R, dim + 1, dim))
    for r in range(R):
        x_star = rng.choice(grid, size=dim)
        # d_star only sets the order of the steps (start high and step
        # down, or start low and step up); every coordinate stays in
        # {x_star, x_star + delta}.
        d_star = rng.choice([-1.0, 1.0], size=dim)
        perm = rng.permutation(dim)
        P = np.eye(dim)[:, perm]
        trajs[r] = (J * x_star
                    + (delta / 2.0) * ((2.0 * B - J) * d_star + J)) @ P
    return trajs, delta


def morris_screening(objective, bounds, num_trajectories=64, num_levels=4,
                     key=None, seed=None, batched=False, batch_size=None,
                     mesh=None, mesh_axis=None, bootstrap=100, names=None,
                     device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """Morris (1991) elementary-effects screening.

    Each trajectory moves one parameter at a time by ``delta`` on a
    ``num_levels`` grid: one elementary effect per parameter per
    trajectory for ``dim + 1`` model runs, all
    ``num_trajectories (dim + 1)`` evaluated in batched calls.

    Args:
        objective / batched / batch_size / mesh / mesh_axis / key / seed /
            names / device / dtype: as in :func:`sobol_indices`.
        bounds: sequence of (low, high) pairs, one per parameter.
        num_trajectories: number of one-at-a-time trajectories (R).
        num_levels: grid levels p (even; 4 by default, as SALib's).
        bootstrap: resamples of each parameter's finite effects for the
            ``mu_star`` confidence interval (0 disables).

    Returns:
        :class:`MorrisResult`.  Non-finite elementary effects (either
        endpoint NaN/inf) are dropped per parameter; ``n_effects`` counts
        the rest.

    Raises:
        ValueError: if ``num_levels`` is odd or < 2, or any parameter ends
            with zero finite elementary effects.
    """
    if num_levels < 2 or num_levels % 2:
        raise ValueError(
            f"'num_levels' must be an even integer >= 2; got {num_levels}."
            " (Odd grids make the standard delta = p/(2(p-1)) step leave "
            "the unit interval.)")
    check_mesh(mesh)
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    lows, highs, dim, names = _parse_bounds(bounds, names)
    rng = np.random.default_rng(_seed_from(key, seed, device))

    R = num_trajectories
    trajs, delta = _morris_trajectories(rng, R, dim, num_levels)
    X = lows + trajs.reshape(R * (dim + 1), dim) * (highs - lows)
    f = _evaluate_design(objective, X, batched, batch_size, mesh, mesh_axis,
                         device, dtype).reshape(R, dim + 1)

    # Consecutive trajectory points differ in exactly one parameter; the
    # signed normalized step recovers which one and in which direction.
    dZ = trajs[:, 1:, :] - trajs[:, :-1, :]          # (R, dim, dim)
    which = np.abs(dZ).argmax(axis=2)                 # (R, dim)
    step = np.take_along_axis(dZ, which[:, :, None], axis=2)[:, :, 0]
    ee_flat = (f[:, 1:] - f[:, :-1]) / step           # effect of `which`

    ee = np.full((R, dim), np.nan)
    rows = np.repeat(np.arange(R), dim)
    ee[rows, which.ravel()] = ee_flat.ravel()

    finite = np.isfinite(ee)
    n_effects = finite.sum(axis=0)
    if (n_effects == 0).any():
        bad = [i for i in range(dim) if n_effects[i] == 0]
        label = [names[i] if names else str(i) for i in bad]
        raise ValueError(
            f"No finite elementary effects for parameter(s) {label}; "
            "the objective is non-finite wherever they were perturbed.")

    cnt = finite.sum(axis=0)
    mu = np.where(finite, ee, 0.0).sum(axis=0) / cnt
    mu_star = np.abs(np.where(finite, ee, 0.0)).sum(axis=0) / cnt
    sigma = np.sqrt(np.where(finite, (ee - mu) ** 2, 0.0).sum(axis=0)
                    / np.maximum(cnt - 1, 1))

    mu_star_conf = np.zeros(dim)
    if bootstrap:
        # Each parameter's own finite effects: a joint trajectory resample
        # can draw none for a parameter.
        for i in range(dim):
            e_i = np.abs(ee[finite[:, i], i])
            idx = rng.integers(0, len(e_i), (bootstrap, len(e_i)))
            mu_star_conf[i] = 1.96 * e_i[idx].mean(axis=1).std(ddof=1)

    return MorrisResult(
        mu=mu, mu_star=mu_star, sigma=sigma, mu_star_conf=mu_star_conf,
        n_effects=n_effects, nfev=R * (dim + 1), names=names)
