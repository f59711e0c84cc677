"""ABC model (Fiering 1967), plain batched PyTorch.

Counterpart of ``rrmpg_tpu/ops/abc.py``, with the member axis written out
instead of ``vmap``.  State transition (reference
``rrmpg/models/abcmodel_model.py:53-59``)::

    qsim[t]    = (1 - a - b) * prec[t] + c * storage[t-1]
    storage[t] = (1 - c) * storage[t-1] + a * prec[t]

with ``storage[0] = initial_state`` and ``qsim[0] = 0``.

Three forms of the cold start: :func:`run_abcmodel_matscan` solves the
linear storage recurrence as batched Toeplitz products
(:mod:`.linear_scan`; the ``'scan'`` engine, as JAX's XLA engine),
:func:`run_abcmodel` steps through time, and :func:`run_abcmodel_pscan`
composes the affine maps ``S -> (1 - c)*S + B[t]`` by recursive doubling in
log2(T) passes over whole tensors, the plain version of the fused CUDA
kernels (:mod:`.fused_abc`).  The warm start runs on the Toeplitz
products too.

The Toeplitz forms build the decay's powers ``(1 - c)^k`` from ``c`` as
``exp(k log1p(-c))``, never from a rounded ``1 - c``: in float32 that
rounding carries up to 4e-4 of a small ``c`` (7e-5), and the storage level
(proportional to 1 / c) carries it too.

Shapes: ``prec`` (T,); parameters and initial state scalars or (N,)
tensors; series (N, T), or (T,) when every parameter is a scalar.
"""

import torch

from .linear_scan import solve


def _members(prec, initial_state, params):
    """(a, b, c, s0) as (N,) tensors of ``prec``'s dtype and device, plus
    whether the caller passed scalars only (series then drop the member
    axis)."""
    values = (params['a'], params['b'], params['c'], initial_state)
    for v in values:
        if isinstance(v, torch.Tensor) and v.device != prec.device:
            raise ValueError(
                "ABC parameters and the series must share one device; got "
                f"{v.device} and {prec.device}.")
    values = [torch.as_tensor(v, dtype=prec.dtype, device=prec.device)
              for v in values]
    single = all(v.dim() == 0 for v in values)
    n = max([v.shape[0] for v in values if v.dim()], default=1)
    return [v.expand(n) for v in values], single


def _finish(series, single):
    return tuple(x[0] for x in series) if single else series


def run_abcmodel(prec, initial_state, params):
    """Simulate the ABC model step by step (sequential over time, batched
    over members).

    Args:
        prec: (T,) precipitation tensor.
        initial_state: initial storage, scalar or (N,).
        params: dict with entries 'a', 'b', 'c', scalars or (N,) tensors.

    Returns:
        (qsim, storage), each (N, T) -- or (T,) for scalar parameters.
    """
    (a, b, c, s0), single = _members(prec, initial_state, params)
    T = prec.shape[0]
    qsim = prec.new_zeros((a.shape[0], T))
    storage = prec.new_empty((a.shape[0], T))
    s = s0.clone()
    storage[:, 0] = s
    for t in range(1, T):
        p = prec[t]
        qsim[:, t] = (1.0 - a - b) * p + c * s
        s = (1.0 - c) * s + a * p
        storage[:, t] = s
    return _finish((qsim, storage), single)


def affine_prefix(decay, B):
    """Inclusive prefix of the affine maps ``S -> (1 - decay)*S + B[..., t]``
    under composition, by recursive doubling along the last axis.

    Returns (D_cum, B_cum) with ``S[t] = (1 - D_cum[t]) * S_before +
    B_cum[t]``.  A map is kept as ``D = 1 - A``, never as ``A``: in float32
    a rounded ``1 - c`` carries up to 4e-4 of a small ``c`` (7e-5), which
    the doubling then raises to every power, where ``D`` composes as
    ``D1 + D2 - D1*D2`` with no such rounding (the CUDA kernels keep their
    maps the same way).  No powers are formed other than by these
    products, so ``decay = 0`` and ``decay = 1`` need no special case.
    """
    D = decay.expand_as(B)
    d = 1
    while d < B.shape[-1]:
        hi, lo_b = D[..., d:], B[..., :-d]
        B = torch.cat([B[..., :d], lo_b - hi * lo_b + B[..., d:]], dim=-1)
        D = torch.cat([D[..., :d], D[..., :-d] + hi - D[..., :-d] * hi],
                      dim=-1)
        d *= 2
    return D, B


def decay_power(c):
    """``(k, rows) -> (1 - c[rows])^k``, (rows,) + ``k.shape``, from ``c``
    itself: ``exp(k log1p(-c))``, with ``(1 - c)^0 = 1`` also at ``c = 1``
    and the sign of ``1 - c < 0`` for ``c > 1``."""
    above = c > 1
    log_decay = torch.where(above, torch.log((c - 1).clamp_min(
        torch.finfo(c.dtype).tiny)), torch.log1p(-c.clamp(max=1)))
    log_decay = log_decay.clamp_min(torch.finfo(c.dtype).min)

    def power(k, rows):
        shape = (-1,) + (1,) * k.dim()
        p = torch.exp(k * log_decay[rows].reshape(shape))
        return torch.where(above[rows].reshape(shape) & (k % 2 == 1), -p, p)

    return power


def run_abcmodel_matscan(prec, initial_state, params):
    """Simulate the ABC model by batched Toeplitz products (the ``'scan'``
    engine).

    The same trajectory as :func:`run_abcmodel` (floating-point
    reassociation aside), computed with the chunked recurrence of
    :mod:`.linear_scan`: one batched matmul a level for all members.
    Arguments and results as :func:`run_abcmodel`.
    """
    (a, b, c, s0), single = _members(prec, initial_state, params)
    # Steps t = 1 .. T-1; step 0 is the initialization.
    tail = solve(decay_power(c), a[:, None] * prec[1:], s0)
    storage = torch.cat([s0[:, None], tail], dim=1)
    qsim = _outputs(prec, a, b, c, s0, storage)
    qsim[:, 0] = 0.0
    return _finish((qsim, storage), single)


def _outputs(prec, a, b, c, s_before, storage):
    """qsim from the storage series and the storage before its first
    element."""
    s_prev = torch.cat([s_before[:, None], storage[:, :-1]], dim=1)
    return (1.0 - a - b)[:, None] * prec + c[:, None] * s_prev


def run_abcmodel_pscan(prec, initial_state, params):
    """Simulate the ABC model by parallel prefix over affine maps.

    The same trajectory as :func:`run_abcmodel` (floating-point
    reassociation aside), in log2(T) whole-tensor passes.  Arguments and
    results as :func:`run_abcmodel`.
    """
    (a, b, c, s0), single = _members(prec, initial_state, params)
    # Maps of steps t = 1 .. T-1; step 0 is the initialization.
    D_cum, B_cum = affine_prefix(c[:, None], a[:, None] * prec[1:])
    s0_col = s0[:, None]
    storage = torch.cat([s0_col, s0_col - D_cum * s0_col + B_cum], dim=1)
    qsim = _outputs(prec, a, b, c, s0, storage)
    qsim[:, 0] = 0.0
    return _finish((qsim, storage), single)


def run_abcmodel_warm(prec, state, params):
    """Continue an ABC simulation from a carried storage value.

    Unlike the cold starts, every timestep advances the model from
    ``state``, so chaining segments through the returned final storage
    reproduces the unbroken trajectory.  Built on the Toeplitz products of
    :func:`run_abcmodel_matscan`.

    Args:
        prec: (T,) continuation-segment precipitation.
        state: carried storage, scalar or (N,).
        params: dict with entries 'a', 'b', 'c'.

    Returns:
        (qsim, storage, final_state): series (N, T) and final (N,) -- or
        (T,) and a scalar tensor for scalar parameters.
    """
    (a, b, c, s_prev), single = _members(prec, state, params)
    storage = solve(decay_power(c), a[:, None] * prec, s_prev)
    qsim = _outputs(prec, a, b, c, s_prev, storage)
    return _finish((qsim, storage, storage[:, -1]), single)
