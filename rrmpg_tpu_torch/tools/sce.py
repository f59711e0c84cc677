"""Shuffled Complex Evolution (SCE-UA) calibration on the model's device.

Counterpart of ``rrmpg_tpu/tools/sce.py`` (Duan, Sorooshian & Gupta
1992), restructured around batched evaluation as there:

* All ``p`` complexes take their competitive-complex-evolution (CCE) step
  at once: the reflection, contraction and mutation candidates of every
  complex form one ``(3 p, dim)`` batch, evaluated in one call (one launch
  of a fused objective kernel), and each complex then picks by the
  standard priority (reflect if it beats the simplex worst, else contract
  if it does, else mutate unconditionally).
* Simplex members are drawn per complex with the trapezoidal rank weights
  of the original algorithm by a Gumbel-top-k draw.
* The evolve-shuffle loop is a Python loop with the population on the
  device; it waits for the device once per shuffle, for the convergence
  test.

As in the JAX package, all three candidates are always evaluated (``nfev``
counts them), and an out-of-bounds reflection falls back to a uniform
point in the bounds.  Non-finite objective values are quarantined as in
:func:`~.calibration.differential_evolution`: never selected as best and
never shielding an incumbent.  Sorts are stable, as ``jnp.argsort`` is, so
tied (quarantined) energies keep their order.  Random numbers come from a
``torch.Generator``, so trajectories differ from the JAX package's while
the algorithm is the same.
"""

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..parallel.mesh import pad_to_multiple
from .calibration import (OptimizeResult, _generator, _latin_hypercube,
                          _mesh_shards, _population_objective)


def _safe(e):
    """Energies with non-finite entries pushed to +inf for comparisons."""
    return torch.where(torch.isfinite(e), e, torch.inf)


def _sort_complexes(pop, energies):
    """Sort each complex's members ascending by (quarantined) energy."""
    order = torch.argsort(_safe(energies), dim=1, stable=True)
    return (torch.take_along_dim(pop, order[:, :, None], dim=1),
            torch.take_along_dim(energies, order, dim=1))


def _shuffle(pop, energies, p, m, dim):
    """Global sort, then deal point ``j`` to complex ``j % p`` (the
    original algorithm's partitioning, so every complex spans the whole
    quality range)."""
    flat_pop = pop.reshape(p * m, dim)
    flat_e = energies.reshape(p * m)
    order = torch.argsort(_safe(flat_e), stable=True)
    # Row j of the (m, p) deal is global rank j*p + k for complex k.
    pop = flat_pop[order].reshape(m, p, dim).transpose(0, 1)
    energies = flat_e[order].reshape(m, p).T
    return pop, energies


def sce_ua(objective, bounds, key=None, seed=None, n_complexes=None,
           maxiter=100, tol=0.01, atol=0.0, peps=1e-4, batched=False,
           mesh=None, mesh_axis=None, device=DEFAULT_DEVICE,
           dtype=None):
    """Minimize with Shuffled Complex Evolution (SCE-UA).

    Args:
        objective: ``(dim,) -> scalar`` loss, mapped over candidate batches
            as in :func:`~.calibration.differential_evolution`.  With
            ``batched=True``, maps a whole ``(P, dim)`` batch to ``(P,)``
            losses in one call (a fused kernel's launch).
        bounds: sequence of (low, high) pairs, one per dimension.
        key: (optional) ``torch.Generator`` on ``device``, JAX's PRNG key
            argument; else one seeded from ``seed`` (0 if None).
        seed: int seed.
        n_complexes: number of complexes ``p`` (default ``max(2, dim)``).
            Complex size, simplex size and evolution steps per shuffle use
            Duan's recommendations (``m = 2 dim + 1``, ``q = dim + 1``,
            ``beta = 2 dim + 1``).
        maxiter: maximum number of shuffling iterations.
        tol, atol: convergence tolerance on the population energy spread
            (``std(E) <= atol + tol * |mean(E)|``, DE's criterion).
        peps: geometric convergence: stop when the population's normalized
            parameter range ``exp(mean(log(range_i)))`` drops below it.
        mesh: (optional) :class:`~..parallel.mesh.Mesh`: ``p`` is rounded
            up to a multiple of the ``mesh_axis`` shard count and every
            batch of points is split over the mesh, as JAX shards its
            complex axis.  It needs a per-point objective: with
            ``batched=True`` it raises ``ValueError``, as JAX's does.
        mesh_axis: the mesh axis (default 'ensemble').
        device, dtype: where (the card by default) and in which float type
            the population lives.

    Returns:
        :class:`~.calibration.OptimizeResult`: ``population`` /
        ``population_energies`` hold the final shuffled population, ``nit``
        the number of shuffles, ``nfev`` every objective evaluation
        (``p m + nit beta 3 p``).
    """
    mesh_axis, n_shards = _mesh_shards(mesh, mesh_axis)
    if mesh is not None and batched:
        raise ValueError(
            "sce_ua(mesh=) shards the complex axis and needs a "
            "per-point (vmappable) objective; batched objectives "
            "run single-device. Use differential_evolution for "
            "mesh-sharded batched kernels.")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    lows = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    highs = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    dim = len(bounds)

    p = pad_to_multiple(n_complexes if n_complexes is not None
                        else max(2, dim), n_shards)
    m = 2 * dim + 1          # points per complex
    q = dim + 1              # simplex size
    beta = 2 * dim + 1       # CCE steps per shuffle

    def scale(z):
        return lows + z * (highs - lows)

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)

    energies_of_sample = _population_objective(objective, batched, p * m,
                                               mesh, mesh_axis)
    energies_of_candidates = _population_objective(objective, batched,
                                                   3 * p, mesh, mesh_axis)

    # Trapezoidal simplex-selection weights over within-complex ranks
    # (rank 0 = best): w_i = 2 (m - i) / (m (m + 1)).
    ranks = torch.arange(m, dtype=dtype, device=device)
    rank_logw = torch.log(2.0 * (m - ranks) / (m * (m + 1.0)))
    complexes = torch.arange(p, device=device)
    tiny = torch.finfo(dtype).tiny

    def cce_step(pop, energies):
        # Simplex indices per complex: best-biased sampling without
        # replacement (Gumbel-top-k).  Complex rows are kept sorted, so
        # sorted indices are energy-ordered.
        gumbel = -torch.log(-torch.log(rand(p, m).clamp_min(tiny)))
        chosen = torch.argsort(-(rank_logw + gumbel), dim=1,
                               stable=True)[:, :q]
        idx = torch.sort(chosen, dim=1).values                 # (p, q)
        simplex = torch.take_along_dim(pop, idx[:, :, None], dim=1)
        worst = simplex[:, -1]
        centroid = simplex[:, :-1].mean(dim=1)
        reflect = 2.0 * centroid - worst
        contract = 0.5 * (centroid + worst)
        mutate = rand(p, dim)
        # An out-of-bounds reflection is disqualified by mutating it.
        oob = ((reflect < 0.0) | (reflect > 1.0)).any(dim=1, keepdim=True)
        reflect = torch.where(oob, mutate, reflect)
        worst_row = idx[:, -1]
        e_worst = _safe(energies[complexes, worst_row])
        cands = torch.stack([reflect, contract, mutate], dim=1)  # (p, 3, d)
        e_cands = energies_of_candidates(
            scale(cands.reshape(3 * p, dim))).reshape(p, 3)
        e_safe = _safe(e_cands)
        take_r = e_safe[:, 0] < e_worst
        take_c = ~take_r & (e_safe[:, 1] < e_worst)
        pick = torch.where(take_r, 0, torch.where(take_c, 1, 2))
        pop = pop.clone()
        energies = energies.clone()
        pop[complexes, worst_row] = cands[complexes, pick]
        energies[complexes, worst_row] = e_cands[complexes, pick]
        return _sort_complexes(pop, energies)

    def converged(pop, energies):
        """One read of the device: the spread test or the collapse test."""
        e = energies.reshape(-1)
        spread_ok = (torch.isfinite(e).all()
                     & (e.std(correction=0)
                        <= atol + tol * torch.abs(e.mean())))
        flat = pop.reshape(-1, dim)
        rng = flat.amax(dim=0) - flat.amin(dim=0)
        gnrng = torch.exp(torch.log(rng.clamp_min(1e-30)).mean())
        return bool(spread_ok | (gnrng < peps))

    flat = _latin_hypercube(generator, p * m, dim, dtype, device)
    energies = energies_of_sample(scale(flat))
    pop, energies = _shuffle(flat.reshape(p, m, dim),
                             energies.reshape(p, m), p, m, dim)
    pop, energies = _sort_complexes(pop, energies)
    nit = 0
    success = converged(pop, energies)
    while nit < maxiter and not success:
        for _ in range(beta):
            pop, energies = cce_step(pop, energies)
        pop, energies = _sort_complexes(*_shuffle(pop, energies, p, m, dim))
        nit += 1
        success = converged(pop, energies)

    flat_pop = scale(pop.reshape(-1, dim)).cpu().numpy()
    flat_e = energies.reshape(-1).cpu().numpy()
    best_idx = int(np.argmin(np.where(np.isfinite(flat_e), flat_e, np.inf)))
    nfev = p * m + nit * beta * 3 * p
    message = ("Optimization terminated successfully." if success else
               "Maximum number of iterations has been exceeded.")
    n_bad = int(np.sum(~np.isfinite(flat_e)))
    if n_bad:
        message += (f" {n_bad}/{p * m} final members have non-finite "
                    "objectives (see population_energies).")
    return OptimizeResult(
        x=flat_pop[best_idx], fun=float(flat_e[best_idx]), nit=nit,
        nfev=nfev, success=success, message=message,
        population=flat_pop, population_energies=flat_e)
