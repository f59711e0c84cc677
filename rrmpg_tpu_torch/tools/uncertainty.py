"""GLUE-style uncertainty quantification over Monte-Carlo ensembles.

Counterpart of ``rrmpg_tpu/tools/uncertainty.py``: Generalized Likelihood
Uncertainty Estimation (Beven & Binley 1992) on top of
:func:`~.monte_carlo.monte_carlo`.  Per-member goodness-of-fit becomes
likelihood weights over the behavioural subset, then weighted prediction
limits per time step.  The (T, N) weighted quantiles are plain PyTorch
(``argsort``, ``cumsum``, ``gather``) on the card; JAX computes them outside
any Pallas kernel too, so there is no hand-written kernel here.  Results
are host numpy arrays, as in the JAX package.
"""

import numpy as np
import torch

from ..config import DEFAULT_DEVICE, resolve_device


def glue_weights(scores, behavioral_threshold=0.0, higher_is_better=True,
                 device=DEFAULT_DEVICE):
    """Likelihood weights over the behavioural ensemble subset.

    Args:
        scores: (N,) per-member goodness-of-fit (e.g. NSE or KGE from
            ``monte_carlo(..., metrics=('nse',))``; pass negated losses
            with ``higher_is_better=True`` or raw losses with False).
        behavioral_threshold: members with a score below (above, if
            ``higher_is_better=False``) the threshold get zero weight.
        higher_is_better: direction of the score.
        device: where the weights are computed (the card unless
            ``device='cpu'``).

    Returns:
        (N,) numpy array of weights summing to 1 over the behavioural
        members (all zero if no member is behavioural; non-finite scores
        are never behavioural).
    """
    device = resolve_device(device)
    s = torch.as_tensor(np.asarray(scores, np.float64), device=device)
    finite = torch.isfinite(s)
    if higher_is_better:
        behavioral = finite & (s > behavioral_threshold)
        raw = torch.where(behavioral, s - behavioral_threshold, 0.0)
    else:
        behavioral = finite & (s < behavioral_threshold)
        raw = torch.where(behavioral, behavioral_threshold - s, 0.0)
    total = raw.sum()
    w = torch.where(total > 0, raw / torch.where(total > 0, total, 1.0), 0.0)
    return w.cpu().numpy()


def _weighted_quantiles(qsim, weights, quantiles):
    """Weighted per-time-step quantiles of a (T, N) ensemble, (Q, T)."""
    order = torch.argsort(qsim, dim=1, stable=True)
    sorted_q = torch.gather(qsim, 1, order)
    cdf = torch.cumsum(weights[order], dim=1)
    total = cdf[:, -1:]
    cdf = cdf / torch.where(total > 0, total, 1.0)
    # The first member whose weighted CDF reaches q.
    return torch.stack([
        torch.gather(sorted_q, 1,
                     (cdf >= q).to(torch.int8).argmax(dim=1, keepdim=True))[:, 0]
        for q in quantiles])


def prediction_limits(qsim, weights, quantiles=(0.05, 0.5, 0.95),
                      batch_size=None, device=DEFAULT_DEVICE):
    """GLUE prediction limits: weighted quantiles of the ensemble.

    Args:
        qsim: (T, N) simulated discharge (``monte_carlo``'s output
            convention: time first, members last), an array or a tensor.
        weights: (N,) likelihood weights from :func:`glue_weights`.
        quantiles: quantile levels to extract.
        batch_size: (optional) process the time axis in chunks of this
            many steps: the per-step sort holds several (T, N) temporaries
            on the card (the quantiles of each step are independent, so the
            results are the same).
        device: where the quantiles are computed (the card unless
            ``device='cpu'``).

    Returns:
        (len(quantiles), T) numpy array of discharge limits.

    Raises:
        ValueError: if every weight is zero (no behavioural member).
        TypeError: for a ``batch_size`` that is not an integer >= 1.
    """
    device = resolve_device(device)
    weights = np.asarray(weights)
    if float(np.sum(weights)) <= 0.0:
        raise ValueError(
            "No behavioral ensemble member (all GLUE weights are zero); "
            "relax the behavioral threshold or enlarge the ensemble.")
    quantiles = tuple(float(q) for q in quantiles)
    num_steps = qsim.shape[0]

    def limits(chunk):
        q = (chunk.to(device) if isinstance(chunk, torch.Tensor)
             else torch.tensor(chunk, device=device))
        w = torch.tensor(weights, dtype=q.dtype, device=device)
        return _weighted_quantiles(q, w, quantiles).cpu().numpy()

    if batch_size is None or batch_size >= num_steps:
        return limits(qsim)
    if not isinstance(batch_size, int) or batch_size < 1:
        raise TypeError(
            f"'batch_size' must be an integer >= 1 or None; got "
            f"{batch_size!r}.")
    return np.concatenate([limits(qsim[lo:lo + batch_size])
                           for lo in range(0, num_steps, batch_size)],
                          axis=1)
