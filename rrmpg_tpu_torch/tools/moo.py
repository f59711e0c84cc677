"""Multi-objective calibration: NSGA-II on the model's device.

Counterpart of ``rrmpg_tpu/tools/moo.py`` (Deb et al. 2002).  Every
generation evaluates all offspring in one call (one launch of a fused
objective kernel); the non-dominated sort, crowding distances and
tournament selection are array programs on the device:

* Dominance is the dense ``(2P, 2P)`` boolean matrix
  ``all(f_i <= f_j) & any(f_i < f_j)``.
* Non-dominated sorting peels fronts in a Python loop on the device and
  reads one flag back per front (is anyone left?).  A generation ranks the
  combined ``2P`` pool once: the ranks of the members it keeps are their
  ranks in the next generation's population (the kept fronts are whole but
  the last, so no member loses a dominator), so a generation costs one
  read per front of the pool plus one.
* Crowding distances are computed per objective with rank-segmented sorts
  (``jnp.lexsort`` as two stable argsorts, the secondary key first), each
  gap normalized by the objective's range within the member's front.
* Variation is SBX crossover + polynomial mutation in normalized [0, 1]
  coordinates.

Non-finite objective vectors are quarantined: a member with a NaN/inf
component is dominated by every finite member and never enters the
returned front while a finite member exists.  Random numbers come from a
``torch.Generator``, so trajectories differ from the JAX package's while
the algorithm is the same.
"""

import typing

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device, resolve_dtype
from .calibration import _batch_map, _generator, _latin_hypercube

_INF_RANK = 10 ** 9


class ParetoResult(typing.NamedTuple):
    """Result of a multi-objective optimization.

    Attributes:
        x: (F, dim) parameter vectors of the final non-dominated front.
        f: (F, M) their objective vectors.
        population: (P, dim) the full final population.
        population_f: (P, M) its objective vectors.
        rank: (P,) non-domination rank of each member (0 = front).
        nit: generations performed.
        nfev: objective evaluations.
    """
    x: np.ndarray
    f: np.ndarray
    population: np.ndarray
    population_f: np.ndarray
    rank: np.ndarray
    nit: int
    nfev: int


def _dominance(F):
    """(P, P) matrix: [i, j] = member i dominates member j.

    A member with any non-finite objective never dominates and is
    dominated by every finite member.
    """
    finite = torch.isfinite(F).all(dim=1)
    Fs = torch.where(finite[:, None], F, torch.inf)
    le = (Fs[:, None, :] <= Fs[None, :, :]).all(dim=2)
    lt = (Fs[:, None, :] < Fs[None, :, :]).any(dim=2)
    # Break inf-vs-inf ties: non-finite members never dominate.
    return le & lt & finite[:, None]


def _nondominated_ranks(F):
    """(P,) dominance-depth ranks by iterative front peeling; one read of
    the device per front, and one more."""
    dom = _dominance(F)                      # dom[i, j]: i dominates j
    P = F.shape[0]
    ranks = torch.full((P,), _INF_RANK, dtype=torch.int64, device=F.device)
    k = 0
    while k < P:
        unassigned = ranks == _INF_RANK
        if not bool(unassigned.any()):
            break
        # Dominated by any *unassigned* member => not in this front.
        dominated = (dom & unassigned[:, None]).any(dim=0)
        in_front = unassigned & ~dominated
        # Safety: an empty front assigns every remaining member, so the
        # loop always progresses.
        in_front = torch.where(in_front.any(), in_front, unassigned)
        ranks = torch.where(in_front, k, ranks)
        k += 1
    return ranks


def _lexsort(primary, secondary):
    """Indices sorting by ``primary``, ties by ``secondary``, ties of both
    by index (``jnp.lexsort((secondary, primary))``)."""
    first = torch.argsort(secondary, stable=True)
    return first[torch.argsort(primary[first], stable=True)]


def crowding(F, ranks):
    """Crowding distance of each member within its front, (P,).

    Each objective's gap is normalized by that objective's range within
    the member's front (Deb's ``f_max - f_min``): without it, truncation
    and tournaments follow whichever objective has the larger physical
    scale.  A front's boundary members (and members whose neighbours'
    gap is NaN) get inf; an objective whose range over the front is zero
    or non-finite adds nothing for interior members.
    """
    n, num_obj = F.shape
    Fs = torch.where(torch.isfinite(F), F, torch.inf)
    total = torch.zeros(n, dtype=F.dtype, device=F.device)
    false = torch.zeros(1, dtype=torch.bool, device=F.device)
    for j in range(num_obj):
        col = Fs[:, j]
        f_lo = torch.full_like(col, torch.inf).scatter_reduce(
            0, ranks, col, "amin", include_self=False)
        f_hi = torch.full_like(col, -torch.inf).scatter_reduce(
            0, ranks, col, "amax", include_self=False)
        order = _lexsort(ranks, col)
        r_s, f_s = ranks[order], col[order]
        span_s = (f_hi - f_lo)[r_s]
        prev_same = torch.cat([false, r_s[1:] == r_s[:-1]])
        next_same = torch.cat([r_s[:-1] == r_s[1:], false])
        f_prev = torch.cat([f_s[:1], f_s[:-1]])
        f_next = torch.cat([f_s[1:], f_s[-1:]])
        ok = torch.isfinite(span_s) & (span_s > 0.0)
        gap = torch.where(ok, (f_next - f_prev)
                          / torch.where(ok, span_s, 1.0), 0.0)
        d_sorted = torch.where(prev_same & next_same, gap, torch.inf)
        d_sorted = torch.where(torch.isnan(d_sorted), torch.inf, d_sorted)
        contrib = torch.empty_like(d_sorted)
        contrib[order] = d_sorted
        total = total + contrib  # inf + x = inf: boundaries stay inf
    return total


def nsga2(objectives, bounds, pop_size=128, n_generations=100, key=None,
          seed=None, batched=False, crossover_prob=0.9, crossover_eta=15.0,
          mutation_eta=20.0, mutation_prob=None, device=DEFAULT_DEVICE,
          dtype=None):
    """Multi-objective minimization with NSGA-II.

    Args:
        objectives: ``(dim,) -> (M,)`` vector of losses to minimize jointly
            (mapped over the population).  With ``batched=True``, maps
            ``(P, dim) -> (P, M)`` in one call (a fused kernel's launch).
        bounds: sequence of (low, high) pairs, one per dimension.
        pop_size: population size (rounded up to an even number).
        n_generations: number of generations.
        key: (optional) ``torch.Generator`` on ``device``, JAX's PRNG key
            argument; else one seeded from ``seed`` (0 if None).
        seed: int seed.
        crossover_prob / crossover_eta: SBX crossover probability and
            distribution index.
        mutation_eta: polynomial-mutation distribution index.
        mutation_prob: per-gene mutation probability (default ``1 / dim``).
        device, dtype: where (the card by default) and in which float type
            the population lives.

    Returns:
        :class:`ParetoResult`: ``x`` / ``f`` hold the final non-dominated
        set (rank 0, duplicate members included as evolved).
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    lows = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    highs = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    dim = len(bounds)
    P = pop_size + (pop_size % 2)
    half = P // 2
    p_mut = (1.0 / dim) if mutation_prob is None else mutation_prob
    batch_objectives = _batch_map(objectives, batched)

    def scale(z):
        return lows + z * (highs - lows)

    def evaluate(z):
        F = torch.as_tensor(batch_objectives(scale(z)))
        if F.dim() != 2 or F.shape[0] != z.shape[0]:
            raise ValueError(
                f"the objectives gave shape {tuple(F.shape)} for "
                f"{z.shape[0]} candidates; expected ({z.shape[0]}, M).")
        return F

    def rand(*shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=device)

    def tournament(ranks, crowd):
        """P binary tournaments on (rank asc, crowding desc)."""
        a, b = torch.randint(0, P, (2, P), generator=generator,
                             device=device)
        a_wins = ((ranks[a] < ranks[b])
                  | ((ranks[a] == ranks[b]) & (crowd[a] > crowd[b])))
        return torch.where(a_wins, a, b)

    def sbx(parents):
        """Simulated binary crossover on (P, dim) normalized parents."""
        p1, p2 = parents[:half], parents[half:]
        u = rand(half, dim)
        expo = 1.0 / (crossover_eta + 1.0)
        beta = torch.where(u <= 0.5, (2.0 * u) ** expo,
                           (1.0 / (2.0 * (1.0 - u))) ** expo)
        c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
        c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
        # Per pair with crossover_prob, per gene with 0.5.
        mask = (rand(half, 1) < crossover_prob) & (rand(half, dim) < 0.5)
        return torch.cat([torch.where(mask, c1, p1),
                          torch.where(mask, c2, p2)]).clamp(0.0, 1.0)

    def poly_mutation(pop):
        u = rand(P, dim)
        expo = 1.0 / (mutation_eta + 1.0)
        delta = torch.where(u < 0.5, (2.0 * u) ** expo - 1.0,
                            1.0 - (2.0 * (1.0 - u)) ** expo)
        do = rand(P, dim) < p_mut
        return (pop + torch.where(do, delta, 0.0)).clamp(0.0, 1.0)

    pop = _latin_hypercube(generator, P, dim, dtype, device)
    F = evaluate(pop)
    ranks = _nondominated_ranks(F)
    for _ in range(n_generations):
        crowd = crowding(F, ranks)
        children = poly_mutation(sbx(pop[tournament(ranks, crowd)]))
        # Environmental selection on the combined 2P pool.
        pop2 = torch.cat([pop, children])
        F2 = torch.cat([F, evaluate(children)])
        ranks2 = _nondominated_ranks(F2)
        # By (rank asc, crowding desc); inf crowding first.
        keep = _lexsort(ranks2, -crowding(F2, ranks2))[:P]
        pop, F, ranks = pop2[keep], F2[keep], ranks2[keep]

    pop = scale(pop).cpu().numpy()
    F = F.cpu().numpy()
    ranks = ranks.cpu().numpy()
    front = ranks == 0
    return ParetoResult(
        x=pop[front], f=F[front], population=pop, population_f=F,
        rank=ranks, nit=n_generations, nfev=P * (n_generations + 1))


def hypervolume_2d(f, ref):
    """Exact dominated hypervolume of a bi-objective minimization front.

    The area dominated by the points and bounded by the reference point
    (larger is better).  Points not strictly better than ``ref`` in both
    objectives, and non-finite points, contribute nothing.

    Args:
        f: (P, 2) objective vectors (minimization).
        ref: (2,) reference point, worse than every interesting point
            (e.g. the nadir of the initial population).

    Returns:
        float dominated area.
    """
    f = np.asarray(f, dtype=float)
    ref = np.asarray(ref, dtype=float)
    if f.ndim != 2 or f.shape[1] != 2:
        raise ValueError(
            f"hypervolume_2d needs (P, 2) objectives; got {f.shape}.")
    keep = np.isfinite(f).all(axis=1) & (f < ref).all(axis=1)
    pts = f[keep]
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0])]
    hv = 0.0
    prev_y = ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)
