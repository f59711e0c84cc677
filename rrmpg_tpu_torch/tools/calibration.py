"""Differential evolution on the model's device.

Counterpart of the DE core of ``rrmpg_tpu/tools/calibration.py``: scipy's
default configuration -- ``best1bin``, latin-hypercube initialization,
dithered mutation in [0.5, 1), binomial crossover 0.7, population
``popsize * dim``, out-of-bounds components resampled uniformly, and
scipy's convergence test ``std(E) <= atol + tol * |mean(E)|``.

The objective maps one (dim,) candidate to a scalar loss and is mapped
over the population (``torch.func.vmap``, or a loop where the objective
cannot be vmapped), as ``rrmpg_tpu``'s default; with ``batched=True`` it
maps the whole (P, dim) population to (P,) losses in one call, so a fused
kernel evaluates a whole generation with one launch (the model classes
calibrate this way).  The generation loop is a Python loop on the device; it waits
for the device once per generation, for the convergence test.  Random
numbers come from a ``torch.Generator`` seeded from ``seed``; they differ
from ``jax.random``'s, so trajectories differ from ``rrmpg_tpu``'s while
the algorithm is the same.  ``key=`` takes a ``torch.Generator`` of the
caller's in place of JAX's PRNG key.

Long calibrations checkpoint every ``checkpoint_every`` generations, as
JAX's routes them: to a ``*.npz`` file (the npz backend of
:mod:`.checkpoint`), or to a directory through
``torch.distributed.checkpoint`` where JAX writes Orbax (an existing
directory, or a new path without ``.npz``; every process of a group
saves and loads it).  A checkpoint holds the normalized population, its
energies, the generation count and, under ``key``, the generator's state,
so a resumed run draws the numbers the unbroken run would have drawn and
ends with the same bits.  :func:`gradient_descent` (Adam in normalized
coordinates, by autograd) polishes DE's best member with ``polish=True``;
:func:`random_search` keeps the best of sampled candidates.
"""

import os
import typing

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device, resolve_dtype
from ..parallel.mesh import (ENSEMBLE_AXIS, check_mesh, pad_to_multiple,
                             sharded_call)
from ..utils.tracing import span, sync, to_device
from .checkpoint import (load_checkpoint, load_checkpoint_dcp,
                         save_checkpoint, save_checkpoint_dcp)


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


def _device_index(device):
    """The card a device names; ``cuda`` without an index is the current
    one (a ``torch.Generator(device='cuda')`` reports no index)."""
    if device.type == "cuda" and device.index is None:
        return torch.cuda.current_device()
    return device.index


def _generator(key, seed, device):
    """The ``torch.Generator`` that draws a run's random numbers: ``key``
    itself (JAX's PRNG key argument), or a new one on ``device`` seeded from
    ``seed`` (0 if None)."""
    if key is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0 if seed is None else int(seed))
        return generator
    if not isinstance(key, torch.Generator):
        raise TypeError(
            f"key must be None or a torch.Generator on {device}, got "
            f"{type(key).__name__}: a JAX PRNG key cannot seed torch's "
            "random stream (pass seed= instead).")
    where = key.device
    if where.type != device.type or (
            device.index is not None
            and _device_index(where) != _device_index(device)):
        raise ValueError(
            f"key is a torch.Generator on {where}; the run draws on "
            f"{device}.")
    return key


def _is_directory(path):
    """Whether a DE checkpoint path is a directory checkpoint, as JAX's
    ``_is_orbax`` decides: an existing directory, or a new path without
    the ``.npz`` suffix (an existing file is an npz checkpoint under any
    name)."""
    if os.path.isdir(path):
        return True
    if os.path.isfile(path):
        return False
    return not str(path).endswith(".npz")


def _restore(path, generator, pop_size, dim, dtype, device):
    """(normalized population, energies, nit) of a DE checkpoint written by
    this package, with ``generator`` set to the state saved beside them."""
    ckpt = (load_checkpoint_dcp if _is_directory(path)
            else load_checkpoint)(path)
    key = np.asarray(ckpt["key"])
    if key.dtype != np.uint8:
        raise ValueError(
            f"{str(path)!r} holds a JAX PRNG key ({key.shape} {key.dtype}), "
            "written by rrmpg_tpu: a JAX key cannot seed torch's random "
            "stream. Resume it with rrmpg_tpu, or start a new run.")
    try:
        generator.set_state(torch.from_numpy(key.copy()))
    except RuntimeError as exc:
        raise ValueError(
            f"{str(path)!r} holds the state of a generator on another "
            f"device type than {device.type}: {exc}") from None
    pop = torch.as_tensor(ckpt["pop"], dtype=dtype, device=device)
    if tuple(pop.shape) != (pop_size, dim):
        raise ValueError(
            f"{str(path)!r} holds a population of shape "
            f"{tuple(pop.shape)}; this run has ({pop_size}, {dim}).")
    energies = torch.as_tensor(ckpt["energies"], dtype=dtype, device=device)
    return pop, energies, int(ckpt["nit"])


def _latin_hypercube(generator, pop_size, dim, dtype, device):
    """Latin-hypercube sample in [0, 1]^dim, shape (P, dim)."""
    keys = torch.rand((dim, pop_size), generator=generator, device=device)
    perms = torch.argsort(keys, dim=1)                    # (dim, P)
    u = torch.rand((dim, pop_size), generator=generator, dtype=dtype,
                   device=device)
    return ((perms.to(dtype) + u) / pop_size).T


def _converged(energies, tol, atol):
    finite = sync("de.converged.finite", bool, torch.isfinite(energies).all())
    if not finite:
        return False
    std = energies.std(correction=0)
    return sync("de.converged.spread", bool,
                std <= atol + tol * torch.abs(energies.mean()))


def _batch_map(objective, batched):
    """``objective`` as a map over the rows of a (P, dim) batch: itself with
    ``batched``, else mapped over the rows (vmap, or a loop where vmap
    cannot trace it)."""
    if batched:
        return objective
    vmapped = torch.func.vmap(objective)

    def mapped(pop):
        try:
            return vmapped(pop)
        except RuntimeError:
            return torch.stack([torch.as_tensor(objective(x)) for x in pop])

    return mapped


def _mesh_shards(mesh, mesh_axis):
    """(mesh axis, its shard count) of a calibration tool's ``mesh`` (the
    ensemble axis by default); (None, 1) without a mesh."""
    check_mesh(mesh)
    if mesh is None:
        return None, 1
    mesh_axis = ENSEMBLE_AXIS if mesh_axis is None else mesh_axis
    if mesh_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {mesh_axis!r}; its axes are "
                         f"{mesh.axis_names}.")
    return mesh_axis, mesh.shape[mesh_axis]


def _population_objective(objective, batched, pop_size, mesh=None,
                          mesh_axis=None):
    """``objective`` as a map from the (P, dim) population to its (P,)
    energies (:func:`_batch_map`); on a mesh the population is split over
    ``mesh_axis``, each shard evaluated on its device and the energies
    gathered onto the population's (:func:`~..parallel.mesh.sharded_call`).
    Energies of any other shape raise ``ValueError``."""
    mapped = _batch_map(objective, batched)
    if mesh is not None:
        local = mapped
        axis = _mesh_shards(mesh, mesh_axis)[0]

        def mapped(pop):
            return sharded_call(local, mesh, (pop,), (axis,), (axis,))

    def energies_of(pop):
        energies = torch.as_tensor(mapped(pop))
        if tuple(energies.shape) != (pop_size,):
            form = ("(P, dim) -> (P,)" if batched
                    else "(dim,) -> scalar, mapped over the population")
            raise ValueError(
                f"the objective ({form}) gave energies of shape "
                f"{tuple(energies.shape)} for a population of {pop_size}; "
                f"expected ({pop_size},). A population-wide objective "
                "needs batched=True.")
        return energies

    return energies_of


def differential_evolution(objective, bounds, key=None, popsize=15,
                           maxiter=1000, tol=0.01, atol=0.0,
                           mutation=(0.5, 1.0), recombination=0.7,
                           seed=None, batched=False, checkpoint_path=None,
                           checkpoint_every=None, resume_from=None,
                           mesh=None, mesh_axis=None, polish=False,
                           polish_steps=200, device=DEFAULT_DEVICE,
                           dtype=None):
    """Global minimization by differential evolution.

    Args:
        objective: maps a (dim,) candidate to a scalar loss; with
            ``batched=True`` it maps the (P, dim) population to (P,)
            losses in one call.
        bounds: sequence of (low, high) pairs, one per dimension.
        key: (optional) ``torch.Generator`` on ``device`` that draws every
            random number, JAX's PRNG key argument; else one seeded from
            ``seed``.  Anything else raises ``TypeError``.
        popsize: population multiplier; population = popsize * dim,
            rounded up to a multiple of the mesh axis's shard count when a
            mesh is given (as JAX's: 15 x 4 on 8 shards is 64).
        maxiter: maximum number of generations.
        tol, atol: relative / absolute convergence tolerance on the
            energy spread (scipy semantics).
        mutation: (min, max) dithering range of the mutation factor.
        recombination: crossover probability.
        seed: int seed of the generator if ``key`` is None (0 if None).
        batched: whether ``objective`` takes the whole population (see
            above); energies of another shape than (P,) raise
            ``ValueError``.
        checkpoint_path: (optional) where the evolution state is written
            every ``checkpoint_every`` generations and at the end: a
            ``*.npz`` file (atomic replacement), or a directory
            (:func:`~.checkpoint.save_checkpoint_dcp`, where ``rrmpg_tpu``
            writes Orbax: an existing directory, or a new path without
            ``.npz``).
        checkpoint_every: generations between checkpoints (None: only at
            the end).
        resume_from: (optional) checkpoint file or directory of this
            package to go on from: the initial population is skipped and
            the generator takes the saved state, so the run ends as the
            unbroken one would.  A checkpoint written by ``rrmpg_tpu`` (a
            JAX key, or an Orbax directory) raises ``ValueError``.
        mesh: (optional) :class:`~..parallel.mesh.Mesh`: each generation's
            population is split over its ``mesh_axis``, every shard is
            evaluated on its device (with ``batched=True``, one call of the
            objective a shard: a fused kernel's launch), and the energies
            come back to ``device``.  The population and the generator stay
            on ``device``, so a run equals the unsharded one of the same
            population size.  Anything but a mesh raises ``TypeError``.
        mesh_axis: the mesh axis of the population (default 'ensemble').
        polish: run :func:`gradient_descent` from the best member after
            evolution, and keep its point only if it improves the
            objective.  An objective that autograd cannot differentiate
            (the fused kernels on the card have no backward) leaves the
            result as it was, with " Polish skipped (<exception>)." in
            the message.
        polish_steps: Adam steps of the polish.
        device, dtype: where (the card by default) and in which float type
            the population lives.

    Returns:
        :class:`OptimizeResult`; ``nfev = P * (nit + 1)``, plus the
        polish's evaluations with ``polish=True``.
    """
    mesh_axis, n_shards = _mesh_shards(mesh, mesh_axis)
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    lows = to_device("de.bounds", [b[0] for b in bounds], dtype, device)
    highs = to_device("de.bounds", [b[1] for b in bounds], dtype, device)
    dim = len(bounds)
    pop_size = pad_to_multiple(popsize * dim, n_shards)
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

    energies_of = _population_objective(objective, batched, pop_size, mesh,
                                        mesh_axis)

    def generation(pop, energies):
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

        with span("de.evaluate"):
            trial_energies = energies_of(scale(trials))
        trial_safe = torch.where(torch.isfinite(trial_energies),
                                 trial_energies, torch.inf)
        improved = trial_safe < safe
        return (torch.where(improved[:, None], trials, pop),
                torch.where(improved, trial_energies, energies))

    with span("de.init"):
        if resume_from is not None:
            pop, energies, nit = _restore(resume_from, generator, pop_size,
                                          dim, dtype, device)
        else:
            pop = _latin_hypercube(generator, pop_size, dim, dtype, device)
            with span("de.evaluate"):
                energies = energies_of(scale(pop))
            nit = 0
    # Chunks of generations between checkpoints, as rrmpg_tpu's host loop.
    # A generation's span holds the convergence test that follows it within
    # its chunk.
    chunk = checkpoint_every if checkpoint_every else maxiter
    while nit < maxiter and not _converged(energies, tol, atol):
        target = min(nit + chunk, maxiter)
        stop = nit >= target or _converged(energies, tol, atol)
        while not stop:
            with span("de.generation"):
                pop, energies = generation(pop, energies)
                nit += 1
                stop = nit >= target or _converged(energies, tol, atol)
        if checkpoint_path is not None:
            (save_checkpoint_dcp if _is_directory(checkpoint_path)
             else save_checkpoint)(checkpoint_path, {
                 "key": generator.get_state(), "pop": pop,
                 "energies": energies, "nit": np.asarray(nit)})

    success = _converged(energies, tol, atol)
    with span("de.result"):
        pop_np = sync("de.result.population", scale(pop).cpu).numpy()
        energies_np = sync("de.result.energies", energies.cpu).numpy()
    best_idx = int(np.argmin(np.where(np.isfinite(energies_np), energies_np,
                                      np.inf)))
    x_best, fun_best = pop_np[best_idx], float(energies_np[best_idx])
    nfev = pop_size * (nit + 1)
    message = ("Optimization terminated successfully." if success else
               "Maximum number of iterations has been exceeded.")
    n_bad = int(np.sum(~np.isfinite(energies_np)))
    if n_bad:
        message += (f" {n_bad}/{pop_size} final members have non-finite "
                    "objectives (see population_energies).")
    if polish:
        if batched:
            def point_objective(x):
                return objective(x[None, :])[0]
        else:
            point_objective = objective
        try:
            gd = gradient_descent(point_objective, bounds, x0=x_best,
                                  steps=polish_steps, device=device,
                                  dtype=dtype)
            nfev += gd.nfev
            if np.isfinite(gd.fun) and gd.fun < fun_best:
                x_best, fun_best = gd.x, float(gd.fun)
                message += " Polished with gradient descent."
        except Exception as exc:  # an objective autograd cannot follow
            message += f" Polish skipped ({type(exc).__name__})."
    return OptimizeResult(
        x=x_best, fun=fun_best, nit=nit, nfev=nfev, success=success,
        message=message, population=pop_np, population_energies=energies_np)


def minimize(objective, bounds, method="de", **kwargs):
    """Dispatch to a named global optimizer.

    The model classes' ``fit`` methods route through this, so every class
    takes ``fit(..., method='sce')`` to calibrate with SCE-UA instead of
    differential evolution.

    Args:
        objective / bounds: as in :func:`differential_evolution`.
        method: ``'de'`` (default, :func:`differential_evolution`) or
            ``'sce'`` (:func:`rrmpg_tpu_torch.tools.sce.sce_ua`).
        **kwargs: forwarded to the chosen optimizer.

    Returns:
        :class:`OptimizeResult`.
    """
    if method == "de":
        return differential_evolution(objective, bounds, **kwargs)
    if method == "sce":
        from .sce import sce_ua
        return sce_ua(objective, bounds, **kwargs)
    raise ValueError(
        f"Unsupported calibration method {method!r}; choose 'de' "
        "(differential evolution) or 'sce' (SCE-UA).")


def gradient_descent(objective, bounds, x0=None, steps=500,
                     learning_rate=0.05, key=None, seed=None,
                     device=DEFAULT_DEVICE, dtype=None):
    """Projected gradient descent (Adam) on an objective autograd can
    differentiate (the ``'scan'`` engines; the fused kernels on the card
    have no backward).

    Parameters are optimized in normalized [0, 1] coordinates with
    ``torch.optim.Adam`` (betas (0.9, 0.999), eps 1e-8: optax's defaults)
    and clamped to the bounds after every step; non-finite gradients are
    set to 0, so the iterate stalls instead of breaking.  The best iterate
    is kept.

    Args:
        objective: (dim,) -> scalar loss.
        bounds: sequence of (low, high) pairs.
        x0: (optional) starting point in real coordinates; uniform within
            the bounds if omitted.
        steps: number of Adam steps.
        learning_rate: Adam learning rate (in normalized coordinates).
        key / seed: ``torch.Generator`` on ``device`` or int seed for the
            random start.
        device, dtype: where (the card by default) and in which float type
            the iterate lives.

    Returns:
        :class:`OptimizeResult` (``nit = steps``, ``nfev = steps + 1``;
        the population fields hold the best point).
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    lows = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    highs = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    if x0 is None:
        z0 = torch.rand((len(bounds),), generator=generator, dtype=dtype,
                        device=device)
    else:
        z0 = (torch.as_tensor(x0, dtype=dtype, device=device) - lows) / (
            highs - lows)

    def norm_objective(z):
        return objective(lows + z * (highs - lows))

    z = z0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=learning_rate)
    best_z = z0.detach().clone()
    best_val = torch.tensor(np.inf, dtype=dtype, device=device)
    for _ in range(steps):
        val = norm_objective(z)
        (grad,) = torch.autograd.grad(val, z)
        with torch.no_grad():
            better = val < best_val
            best_z = torch.where(better, z, best_z)
            best_val = torch.where(better, val, best_val)
            z.grad = torch.where(torch.isfinite(grad), grad, 0.0)
        opt.step()
        with torch.no_grad():
            z.clamp_(0.0, 1.0)
    with torch.no_grad():
        final_val = norm_objective(z)
        better = final_val < best_val
        best_z = torch.where(better, z, best_z)
        best_val = torch.where(better, final_val, best_val)
        x = (lows + best_z * (highs - lows)).cpu().numpy()
    fun = float(best_val)
    success = bool(np.isfinite(fun))
    return OptimizeResult(
        x=x, fun=fun, nit=steps, nfev=steps + 1, success=success,
        message=("Gradient descent finished." if success else
                 "Objective remained non-finite."),
        population=x[None, :], population_energies=np.asarray([fun]))


def random_search(objective, sample_fn, num, key=None, seed=None,
                  batch_size=None, batched=False, mesh=None, mesh_axis=None,
                  device=DEFAULT_DEVICE, dtype=None):
    """Monte-Carlo minimization: sample ``num`` candidates, keep the best.

    Args:
        objective: (dim,) -> scalar loss, mapped over each batch as in
            :func:`differential_evolution`; with ``batched=True`` it maps
            the (n, dim) batch to (n,) losses in one call.
        sample_fn: ``sample_fn(generator, n) -> (n, dim)`` candidates,
            drawn with the ``torch.Generator`` it is given (JAX's takes a
            key).
        num: number of candidates.
        key / seed: ``torch.Generator`` on ``device`` or int seed.
        batch_size: (optional) candidates a batch, to bound memory; with a
            mesh rounded up to a multiple of the shard count.
        mesh, mesh_axis: (optional) each batch's candidates are split over
            the mesh axis as in :func:`differential_evolution`; a last
            batch is rounded up to the shard count (more candidates drawn,
            as JAX draws them).
        device, dtype: where (the card by default) and in which float type
            the candidates are evaluated.

    Returns:
        :class:`OptimizeResult` (``nfev`` the candidates evaluated,
        those of a rounded-up last batch included; the population fields
        hold the *last* batch).
    """
    mesh_axis, n_shards = _mesh_shards(mesh, mesh_axis)
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    batch_size = pad_to_multiple(num if batch_size is None else batch_size,
                                 n_shards)
    best_x, best_fun = None, np.inf
    last_pop, last_energies = None, None
    evaluated = 0
    while evaluated < num:
        n = min(pad_to_multiple(num - evaluated, n_shards), batch_size)
        candidates = torch.as_tensor(sample_fn(generator, n)).to(
            device=device, dtype=dtype)
        energies = _population_objective(objective, batched, n, mesh,
                                         mesh_axis)(
            candidates).detach().cpu().numpy()
        finite = np.isfinite(energies)
        if finite.any():
            i = int(np.argmin(np.where(finite, energies, np.inf)))
            if energies[i] < best_fun:
                best_fun = float(energies[i])
                best_x = candidates[i].cpu().numpy()
        last_pop, last_energies = candidates.cpu().numpy(), energies
        evaluated += n
    success = best_x is not None
    return OptimizeResult(
        x=best_x, fun=best_fun, nit=1, nfev=evaluated, success=success,
        message=("Random search finished." if success else
                 "Every sampled candidate produced a non-finite loss."),
        population=last_pop, population_energies=last_energies)
