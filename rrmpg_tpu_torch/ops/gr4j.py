"""GR4J, plain batched PyTorch (the ``'scan'`` engine).

Counterpart of ``rrmpg_tpu/ops/gr4j.py`` (the XLA path), with the member
axis written out instead of ``vmap``.  Same decomposition and the same
equations (reference ``rrmpg/models/gr4j_model.py:15-192``):

    production store S  --(p_r series)-->  UH filters  -->  routing store R

* the production-store recurrence is a time loop over (N,) tensors;
* the unit hydrographs are causal FIR filters of p_r, applied to the
  whole (N, T) series at once (:func:`~.uh.causal_fir`);
* the routing-store recurrence is a second time loop.

Shapes: forcing (T,), parameters (N,), series (N, T).
"""

import typing

import torch

from ..config import (DEFAULT_DEVICE, DEFAULT_DTYPE, resolve_device,
                      resolve_dtype)
from .uh import NUM_UH1, NUM_UH2, causal_fir, uh_ordinates


class GR4JState(typing.NamedTuple):
    """Complete GR4J state for warm continuation, batched over members.

    ``s``/``r`` are absolute store levels (N,); ``pr_history`` (N, H)
    holds the most recent routing inputs p_r, oldest first -- the window
    the UH filters still integrate over.
    """
    s: torch.Tensor
    r: torch.Tensor
    pr_history: torch.Tensor


def gr4j_initial_state(s_init, r_init, params, num_uh2=NUM_UH2, dtype=None,
                       device=None):
    """Build a cold-start :class:`GR4JState`: ``s = s_init * x1``,
    ``r = r_init * x3`` and a zero routing-input history.

    Args:
        s_init, r_init: initial store levels as fractions of x1 / x3
            (reference convention), scalars or (N,).
        params: dict with 'x1' and 'x3', scalars or (N,).
        num_uh2: UH2 register length; the history holds ``num_uh2 - 1``
            inputs.
        dtype: float32 or float64; default the dtype of a floating-point
            ``x1`` tensor, else ``config.DEFAULT_DTYPE``.
        device: default ``config.DEFAULT_DEVICE`` (the card).

    Returns:
        :class:`GR4JState` with (N,) stores and an (N, H) history for (N,)
        parameters; scalar stores and an (H,) history for scalars.
    """
    device = resolve_device(DEFAULT_DEVICE if device is None else device)
    x1, x3 = (torch.as_tensor(params[k]) for k in ('x1', 'x3'))
    if dtype is None:
        dtype = x1.dtype if x1.is_floating_point() else DEFAULT_DTYPE
    dtype = resolve_dtype(dtype)
    s, r = torch.broadcast_tensors(
        *(torch.as_tensor(frac, dtype=dtype, device=device)
          * x.to(dtype=dtype, device=device)
          for frac, x in ((s_init, x1), (r_init, x3))))
    return GR4JState(
        s=s.contiguous(), r=r.contiguous(),
        pr_history=s.new_zeros((*s.shape, num_uh2 - 1)))


def production_store_scan(prec, etp, s_init_abs, x1):
    """Production-store recurrence; returns (s_store, p_r), each (N, T).

    Eq. 3/4 tanh interception and percolation of the reference
    (``gr4j_model.py:89-124``).
    """
    n, T = x1.shape[0], prec.shape[0]
    s_store = prec.new_empty((n, T))
    p_r = prec.new_empty((n, T))
    s = s_init_abs.expand(n).to(prec.dtype)
    for t in range(T):
        p, e = prec[t], etp[t]
        p_n = torch.clamp(p - e, min=0.0)
        pe_n = torch.clamp(e - p, min=0.0)
        sr = s / x1
        tanh_pn = torch.tanh(p_n / x1)
        tanh_pen = torch.tanh(pe_n / x1)
        rain_case = p >= e
        p_s = torch.where(
            rain_case,
            (x1 * (1.0 - sr ** 2) * tanh_pn) / (1.0 + sr * tanh_pn), 0.0)
        e_s = torch.where(
            rain_case, 0.0,
            (s * (2.0 - sr) * tanh_pen) / (1.0 + (1.0 - sr) * tanh_pen))
        s_interim = s - e_s + p_s
        perc = s_interim * (1.0 - (1.0 + (4.0 / 9.0 * s_interim / x1) ** 4)
                            ** (-0.25))
        s = s_interim - perc
        s_store[:, t] = s
        p_r[:, t] = perc + (p_n - p_s)
    return s_store, p_r


def routing_store_scan(q9, q1, r_init_abs, x2, x3):
    """Routing-store recurrence; returns (r_store, qsim), each (N, T).

    Groundwater exchange (eq. 18) and the non-linear outflow of the
    reference (``gr4j_model.py:139-154``).
    """
    n, T = q9.shape
    r_store = q9.new_empty((n, T))
    qsim = q9.new_empty((n, T))
    r = r_init_abs.expand(n).to(q9.dtype)
    for t in range(T):
        gw_exchange = x2 * (r / x3) ** 3.5
        r_interim = torch.clamp(r + q9[:, t] + gw_exchange, min=0.0)
        q_r = r_interim * (1.0 - (1.0 + (r_interim / x3) ** 4) ** (-0.25))
        r = r_interim - q_r
        q_d = torch.clamp(q1[:, t] + gw_exchange, min=0.0)
        r_store[:, t] = r
        qsim[:, t] = q_r + q_d
    return r_store, qsim


def _route(p_r_ext, h, x2, x3, x4, r0, num_uh1, num_uh2):
    """UH filters over ``[history | p_r]`` (outputs at the history
    positions discarded), then the routing store."""
    oh1, oh2 = uh_ordinates(x4, num_uh1, num_uh2)
    q9 = causal_fir(0.9 * p_r_ext, oh1)[:, h:]
    q1 = causal_fir(0.1 * p_r_ext, oh2)[:, h:]
    return routing_store_scan(q9, q1, r0, x2, x3)


def run_gr4j(prec, etp, s_init, r_init, params, num_uh1=NUM_UH1,
             num_uh2=NUM_UH2, return_final=False):
    """Simulate GR4J for a batch of parameter sets.

    Args:
        prec, etp: (T,) forcing tensors; ``prec`` may also be (T, N), one
            series per member (the snow compositions' liquid water).
        s_init, r_init: initial store levels as fractions of x1 / x3
            (reference convention), scalars or (N,) tensors.
        params: dict of (N,) tensors 'x1', 'x2', 'x3', 'x4'.
        num_uh1, num_uh2: UH register lengths (>= ceil(x4),
            ceil(2*x4+1) for every member).
        return_final: also return the end-of-series :class:`GR4JState`.

    Returns:
        (qsim, s_store, r_store), each (N, T); with ``return_final``
        additionally the final :class:`GR4JState`.
    """
    x1, x2, x3, x4 = params['x1'], params['x2'], params['x3'], params['x4']
    s_store, p_r = production_store_scan(prec, etp, s_init * x1, x1)
    r_store, qsim = _route(p_r, 0, x2, x3, x4, r_init * x3, num_uh1,
                           num_uh2)
    if not return_final:
        return qsim, s_store, r_store
    # A cold start has zero pre-series routing history.
    h = num_uh2 - 1
    hist = torch.cat([p_r.new_zeros((p_r.shape[0], h)), p_r], dim=1)
    final = GR4JState(s=s_store[:, -1], r=r_store[:, -1],
                      pr_history=hist[:, hist.shape[1] - h:])
    return qsim, s_store, r_store, final


def run_gr4j_warm(prec, etp, state, params, num_uh1=NUM_UH1,
                  num_uh2=NUM_UH2):
    """Continue a GR4J simulation from a batched :class:`GR4JState`.

    Splitting a series anywhere and carrying the state across the
    boundary reproduces one uninterrupted run.

    Returns:
        (qsim, s_store, r_store, final_state).
    """
    x1, x2, x3, x4 = params['x1'], params['x2'], params['x3'], params['x4']
    h = state.pr_history.shape[1]
    h_needed = num_uh2 - 1
    if h < h_needed:
        raise ValueError(
            f"state.pr_history holds {h} routing inputs but num_uh2="
            f"{num_uh2} needs {h_needed}; build the state with a matching "
            "(or larger) num_uh2 -- a short history would silently "
            "zero-fill pre-split routed water.")
    s_store, p_r = production_store_scan(prec, etp, state.s, x1)
    hist = state.pr_history[:, h - h_needed:]
    r_store, qsim = _route(torch.cat([hist, p_r], dim=1), h_needed, x2, x3,
                           x4, state.r, num_uh1, num_uh2)
    full_hist = torch.cat([state.pr_history, p_r], dim=1)
    final = GR4JState(s=s_store[:, -1], r=r_store[:, -1],
                      pr_history=full_hist[:, full_hist.shape[1] - h:])
    return qsim, s_store, r_store, final
