"""Differential evolution on the model's device.

Counterpart of the DE core of ``rrmpg_tpu/tools/calibration.py``: scipy's
default configuration -- ``best1bin``, latin-hypercube initialization,
dithered mutation in [0.5, 1), binomial crossover 0.7, population
``popsize * dim``, out-of-bounds components resampled uniformly, and
scipy's convergence test ``std(E) <= atol + tol * |mean(E)|``.

The objective is batched: it maps the (P, dim) population to (P,) losses
in one call, so a fused kernel evaluates a whole generation with one
launch.  The generation loop is a Python loop on the device; it waits
for the device once per generation, for the convergence test.  Random
numbers come from a ``torch.Generator`` seeded from ``seed``; they differ
from ``jax.random``'s, so trajectories differ from ``rrmpg_tpu``'s while
the algorithm is the same.
"""

import typing

import numpy as np
import torch

from ..config import DEFAULT_DTYPE, resolve_device, resolve_dtype


class OptimizeResult(typing.NamedTuple):
    """Result of a calibration run (scipy-compatible field names)."""
    x: np.ndarray          # best parameter vector, shape (dim,)
    fun: float             # best objective value
    nit: int               # number of generations performed
    nfev: int              # number of objective evaluations
    success: bool
    message: str
    population: np.ndarray          # final population, (P, dim)
    population_energies: np.ndarray  # final energies, (P,)

    def nonfinite_members(self):
        """Final-population members whose objective was NaN/inf, as
        ``(members, energies)``.  The optimizer never selects them; this
        surfaces them for debugging."""
        bad = ~np.isfinite(self.population_energies)
        return self.population[bad], self.population_energies[bad]


def _latin_hypercube(generator, pop_size, dim, dtype, device):
    """Latin-hypercube sample in [0, 1]^dim, shape (P, dim)."""
    keys = torch.rand((dim, pop_size), generator=generator, device=device)
    perms = torch.argsort(keys, dim=1)                    # (dim, P)
    u = torch.rand((dim, pop_size), generator=generator, dtype=dtype,
                   device=device)
    return ((perms.to(dtype) + u) / pop_size).T


def _converged(energies, tol, atol):
    finite = bool(torch.isfinite(energies).all())
    if not finite:
        return False
    std = energies.std(correction=0)
    return bool(std <= atol + tol * torch.abs(energies.mean()))


def differential_evolution(objective, bounds, popsize=15, maxiter=1000,
                           tol=0.01, atol=0.0, mutation=(0.5, 1.0),
                           recombination=0.7, seed=None, device="cpu",
                           dtype=DEFAULT_DTYPE):
    """Global minimization by differential evolution.

    Args:
        objective: maps a (P, dim) tensor of candidates to (P,) losses.
        bounds: sequence of (low, high) pairs, one per dimension.
        popsize: population multiplier; population = popsize * dim.
        maxiter: maximum number of generations.
        tol, atol: relative / absolute convergence tolerance on the
            energy spread (scipy semantics).
        mutation: (min, max) dithering range of the mutation factor.
        recombination: crossover probability.
        seed: int seed of the ``torch.Generator`` on ``device`` that draws
            every random number (0 if None).
        device, dtype: where and in which float type the population lives.

    Returns:
        :class:`OptimizeResult`; ``nfev = P * (nit + 1)``.
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = torch.Generator(device=device)
    generator.manual_seed(0 if seed is None else int(seed))
    lows = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    highs = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    dim = len(bounds)
    pop_size = popsize * dim
    mut_lo, mut_hi = mutation
    own = torch.arange(pop_size, device=device)
    dims = torch.arange(dim, device=device)

    def scale(norm_pop):
        return lows + norm_pop * (highs - lows)

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)

    def randint(high, n):
        return torch.randint(0, high, (n,), generator=generator,
                             device=device)

    pop = _latin_hypercube(generator, pop_size, dim, dtype, device)
    energies = objective(scale(pop))
    nit = 0
    while nit < maxiter and not _converged(energies, tol, atol):
        # A non-finite energy is never selected as best and never shields
        # an incumbent from replacement.
        safe = torch.where(torch.isfinite(energies), energies, torch.inf)
        best = pop[torch.argmin(safe)]

        # best1bin with dithered F and distinct r1 != r2, both != i.
        f = mut_lo + (mut_hi - mut_lo) * rand()
        r1 = randint(pop_size - 1, pop_size)
        r1 = torch.where(r1 >= own, r1 + 1, r1)
        r2 = randint(pop_size - 2, pop_size)
        lo = torch.minimum(own, r1)
        hi = torch.maximum(own, r1)
        r2 = torch.where(r2 >= lo, r2 + 1, r2)
        r2 = torch.where(r2 >= hi, r2 + 1, r2)
        mutants = best[None, :] + f * (pop[r1] - pop[r2])

        # Binomial crossover with one guaranteed mutant dimension.
        cross = rand(pop_size, dim) < recombination
        cross = cross | (dims[None, :] == randint(dim, pop_size)[:, None])
        trials = torch.where(cross, mutants, pop)

        # Out-of-bounds components are resampled uniformly.
        out_of_bounds = (trials < 0.0) | (trials > 1.0)
        trials = torch.where(out_of_bounds, rand(pop_size, dim), trials)

        trial_energies = objective(scale(trials))
        trial_safe = torch.where(torch.isfinite(trial_energies),
                                 trial_energies, torch.inf)
        improved = trial_safe < safe
        pop = torch.where(improved[:, None], trials, pop)
        energies = torch.where(improved, trial_energies, energies)
        nit += 1

    success = _converged(energies, tol, atol)
    pop_np = scale(pop).cpu().numpy()
    energies_np = energies.cpu().numpy()
    best_idx = int(np.argmin(np.where(np.isfinite(energies_np), energies_np,
                                      np.inf)))
    message = ("Optimization terminated successfully." if success else
               "Maximum number of iterations has been exceeded.")
    n_bad = int(np.sum(~np.isfinite(energies_np)))
    if n_bad:
        message += (f" {n_bad}/{pop_size} final members have non-finite "
                    "objectives (see population_energies).")
    return OptimizeResult(
        x=pop_np[best_idx], fun=float(energies_np[best_idx]), nit=nit,
        nfev=pop_size * (nit + 1), success=success, message=message,
        population=pop_np, population_energies=energies_np)


def minimize(objective, bounds, method="de", **kwargs):
    """Dispatch to a named global optimizer (``'de'`` only so far).

    Args:
        objective / bounds: as in :func:`differential_evolution`.
        method: ``'de'``.
        **kwargs: forwarded to the optimizer.
    """
    if method == "de":
        return differential_evolution(objective, bounds, **kwargs)
    raise ValueError(
        f"Unsupported calibration method {method!r}; the port has 'de' "
        "(differential evolution). SCE-UA waits in ROADMAP.md, Queue 1, "
        "item 8.")
