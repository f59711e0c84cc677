"""Bayesian parameter inference: DE-MC sampling on the model's device.

Counterpart of ``rrmpg_tpu/tools/mcmc.py``: Differential Evolution Markov
Chain (ter Braak 2006).  ``C`` parallel chains propose scaled differences
of two other chains (``x + gamma (x_r1 - x_r2) + eps``), which tunes the
proposal to the posterior's covariance; every Metropolis half-step
evaluates one half of the chains' proposals in one batched call (with a
fused likelihood, one kernel launch), so a step is two calls.

Priors are uniform over ``bounds``; out-of-bounds proposals have zero
prior density and are rejected.  The chains stay on the device, and their
draws are copied to the host once per segment of at most 512 steps, as the
JAX package fetches one ``lax.scan`` segment at a time.  Random numbers
come from a ``torch.Generator``, so chains differ from the JAX package's
while the algorithm is the same.
"""

import typing

import numpy as np
import torch

from ..config import (DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device,
                      resolve_dtype)
from ..parallel.mesh import pad_to_multiple
from .calibration import (_generator, _latin_hypercube, _mesh_shards,
                          _population_objective)

_SEGMENT = 512


class MCMCResult(typing.NamedTuple):
    """Posterior sample from :func:`demc_sample`.

    Attributes:
        samples: (S, C, dim) retained post-burn-in draws (S kept steps,
            C chains) in real parameter coordinates.
        log_probs: (S, C) their log-posterior values.
        acceptance_rate: mean Metropolis acceptance over all chains and
            retained steps.
        r_hat: (dim,) split-chain Gelman-Rubin statistic of the retained
            draws (near 1 at convergence; rule of thumb: < 1.05).
        x_map: (dim,) the highest-posterior draw seen (incl. burn-in).
        logp_map: its log-posterior.
    """
    samples: np.ndarray
    log_probs: np.ndarray
    acceptance_rate: float
    r_hat: np.ndarray
    x_map: np.ndarray
    logp_map: float

    def flat(self):
        """(S * C, dim) pooled posterior draws."""
        return self.samples.reshape(-1, self.samples.shape[-1])


def _split_r_hat(samples):
    """Split-chain Gelman-Rubin over (S, C, dim) draws."""
    S, C, dim = samples.shape
    half = S // 2
    if half < 2:
        return np.full(dim, np.nan)
    chains = np.concatenate([samples[:half], samples[half:2 * half]],
                            axis=1)                     # (half, 2C, dim)
    n = chains.shape[0]
    W = chains.var(axis=0, ddof=1).mean(axis=0)
    B = n * chains.mean(axis=0).var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / W)


def demc_sample(log_prob, bounds, num_chains=None, num_steps=2000,
                burn_in=0.5, thin=1, key=None, seed=None, batched=False,
                gamma=None, jitter=1e-6, mesh=None, mesh_axis=None,
                device=DEFAULT_DEVICE, dtype=DEFAULT_DTYPE):
    """Sample a posterior with Differential Evolution MCMC.

    Args:
        log_prob: ``(dim,) -> scalar`` log posterior density (up to a
            constant), mapped over the chains.  With ``batched=True``, maps
            ``(C, dim) -> (C,)`` in one call (a fused likelihood).
            Non-finite values are treated as log(0) (always rejected).
        bounds: sequence of (low, high) pairs; also the uniform prior's
            support, so proposals outside are rejected.
        num_chains: number of parallel chains (default ``max(8, 2 dim)``).
            Chains update as two half-ensembles, partners always drawn
            from the frozen other half (which keeps the parallel update a
            valid MCMC kernel), so odd counts round up to even.
        num_steps: Metropolis steps per chain.
        burn_in: fraction of initial steps to discard (0 <= b < 1).
        thin: keep every ``thin``-th post-burn-in step.
        key: (optional) ``torch.Generator`` on ``device``, JAX's PRNG key
            argument; else one seeded from ``seed`` (0 if None).
        seed: int seed.
        batched: see ``log_prob``.
        gamma: proposal scale (default ``2.38 / sqrt(2 dim)``); every 10th
            step uses ``gamma = 1`` for mode-to-mode jumps.
        jitter: scale of the small Gaussian ``eps`` added to proposals.
        mesh: (optional) :class:`~..parallel.mesh.Mesh`: the chain count
            is rounded up to a multiple of the ``mesh_axis`` shard count
            (of twice it, for an odd count, so that the halves stay
            equal), and every half-step's proposals are split over the
            mesh.  It needs a per-point ``log_prob``: with
            ``batched=True`` it raises ``ValueError``, as JAX's does.
        mesh_axis: the mesh axis (default 'ensemble').
        device, dtype: where (the card by default) and in which float type
            the chains live.

    Returns:
        :class:`MCMCResult`.

    Raises:
        ValueError: for an invalid ``burn_in`` / ``thin`` or fewer than 4
            chains.
    """
    if not 0 <= burn_in < 1:
        raise ValueError(f"'burn_in' must lie in [0, 1); got {burn_in}.")
    if not isinstance(thin, (int, np.integer)) or thin < 1:
        raise ValueError(f"'thin' must be a positive integer; got {thin}.")
    mesh_axis, n_shards = _mesh_shards(mesh, mesh_axis)
    if mesh is not None and batched:
        raise ValueError(
            "demc_sample(mesh=) shards the chain axis and needs a "
            "per-point (vmappable) log_prob; batched log_probs run "
            "single-device.")
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    generator = _generator(key, seed, device)
    lows = torch.tensor([b[0] for b in bounds], dtype=dtype, device=device)
    highs = torch.tensor([b[1] for b in bounds], dtype=dtype, device=device)
    dim = len(bounds)
    C = num_chains if num_chains is not None else max(8, 2 * dim)
    if mesh is not None:
        # Two equal half-ensembles AND a shard-count multiple.
        C = pad_to_multiple(C, n_shards if n_shards % 2 == 0
                            else 2 * n_shards)
    C = C + (C % 2)  # the red-black block update needs equal halves
    if C < 4:
        raise ValueError(
            f"DE-MC needs >= 4 chains to draw two distinct partners per "
            f"chain; got num_chains={C}.")
    H = C // 2
    g0 = gamma if gamma is not None else 2.38 / np.sqrt(2.0 * dim)

    def scale(z):
        return lows + z * (highs - lows)

    def safe_eval(z, energies_of):
        """Log-prob of normalized coords; out-of-bounds / NaN -> -inf."""
        lp = energies_of(scale(z))
        in_bounds = ((z >= 0.0) & (z <= 1.0)).all(dim=1)
        lp = torch.where(torch.isfinite(lp), lp, -torch.inf)
        return torch.where(in_bounds, lp, -torch.inf)

    log_prob_of_half = _population_objective(log_prob, batched, H, mesh,
                                             mesh_axis)

    def half_update(block, lp_block, other, g):
        """MH-update every chain of ``block`` at once, proposing with two
        distinct partners from the frozen other half: no block member's
        proposal reads another block member, so the parallel update
        leaves the posterior invariant."""
        r1 = torch.randint(0, H, (H,), generator=generator, device=device)
        r2 = torch.randint(0, H - 1, (H,), generator=generator,
                           device=device)
        r2 = torch.where(r2 >= r1, r2 + 1, r2)       # distinct partners
        eps = jitter * torch.randn((H, dim), generator=generator,
                                   dtype=dtype, device=device)
        proposal = block + g * (other[r1] - other[r2]) + eps
        lp_new = safe_eval(proposal, log_prob_of_half)
        u = torch.rand((H,), generator=generator, dtype=dtype,
                       device=device)
        accept = torch.log(u) < lp_new - lp_block
        return (torch.where(accept[:, None], proposal, block),
                torch.where(accept, lp_new, lp_block), accept)

    z = _latin_hypercube(generator, C, dim, dtype, device)
    lp = safe_eval(z, _population_objective(log_prob, batched, C, mesh,
                                            mesh_axis))
    zs_parts, lps_parts, acc_parts = [], [], []
    seg = min(_SEGMENT, num_steps)
    done = 0
    while done < num_steps:
        length = min(seg, num_steps - done)
        zs = torch.empty((length, C, dim), dtype=dtype, device=device)
        lps = torch.empty((length, C), dtype=dtype, device=device)
        accs = torch.empty((length, C), dtype=torch.bool, device=device)
        for i in range(length):
            g = 1.0 if (done + i) % 10 == 9 else g0
            za, lpa, acc_a = half_update(z[:H], lp[:H], z[H:], g)
            zb, lpb, acc_b = half_update(z[H:], lp[H:], za, g)
            z = torch.cat([za, zb])
            lp = torch.cat([lpa, lpb])
            zs[i], lps[i] = z, lp
            accs[i] = torch.cat([acc_a, acc_b])
        # One copy to the host per segment.
        zs_parts.append(zs.cpu().numpy())
        lps_parts.append(lps.cpu().numpy())
        acc_parts.append(accs.cpu().numpy())
        done += length
    zs = np.concatenate(zs_parts)
    lps = np.concatenate(lps_parts)
    accepts = np.concatenate(acc_parts)
    lows_np, highs_np = lows.cpu().numpy(), highs.cpu().numpy()
    x_all = lows_np + zs * (highs_np - lows_np)

    i_map = np.unravel_index(np.argmax(lps), lps.shape)
    x_map = x_all[i_map[0], i_map[1]]
    logp_map = float(lps[i_map])

    keep = slice(int(burn_in * num_steps), None, thin)
    samples = x_all[keep]
    return MCMCResult(
        samples=samples, log_probs=lps[keep],
        acceptance_rate=float(accepts[keep].mean()),
        r_hat=_split_r_hat(samples), x_map=x_map, logp_map=logp_map)
