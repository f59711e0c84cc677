"""ABC model (Fiering 1967), plain batched PyTorch.

Counterpart of ``rrmpg_tpu/ops/abc.py``, with the member axis written out
instead of ``vmap``.  State transition (reference
``rrmpg/models/abcmodel_model.py:53-59``)::

    qsim[t]    = (1 - a - b) * prec[t] + c * storage[t-1]
    storage[t] = (1 - c) * storage[t-1] + a * prec[t]

with ``storage[0] = initial_state`` and ``qsim[0] = 0``.

Two engines for the cold start: :func:`run_abcmodel` steps through time
(the ``'scan'`` engine), :func:`run_abcmodel_pscan` composes the affine
maps ``S -> alpha*S + B[t]`` by recursive doubling in log2(T) passes over
whole tensors.  The second is the plain version of the fused CUDA kernels
(:mod:`.fused_abc`): the only plain form that is usable at ten million
steps.

Shapes: ``prec`` (T,); parameters and initial state scalars or (N,)
tensors; series (N, T), or (T,) when every parameter is a scalar.
"""

import torch


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


def affine_prefix(alpha, B):
    """Inclusive prefix of the affine maps ``S -> alpha*S + B[..., t]``
    under composition, by recursive doubling along the last axis.

    Returns (A_cum, B_cum) with ``S[t] = A_cum[t] * S_before + B_cum[t]``.
    No powers of ``alpha`` are formed other than by these products, so
    ``alpha = 0`` and ``alpha = 1`` need no special case.
    """
    A = alpha.expand_as(B)
    d = 1
    while d < B.shape[-1]:
        hi = A[..., d:]
        B = torch.cat([B[..., :d], hi * B[..., :-d] + B[..., d:]], dim=-1)
        A = torch.cat([A[..., :d], hi * A[..., :-d]], dim=-1)
        d *= 2
    return A, B


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
    A_cum, B_cum = affine_prefix((1.0 - c)[:, None], a[:, None] * prec[1:])
    storage = torch.cat([s0[:, None], A_cum * s0[:, None] + B_cum], dim=1)
    qsim = _outputs(prec, a, b, c, s0, storage)
    qsim[:, 0] = 0.0
    return _finish((qsim, storage), single)


def run_abcmodel_warm(prec, state, params):
    """Continue an ABC simulation from a carried storage value.

    Unlike the cold starts, every timestep advances the model from
    ``state``, so chaining segments through the returned final storage
    reproduces the unbroken trajectory.

    Args:
        prec: (T,) continuation-segment precipitation.
        state: carried storage, scalar or (N,).
        params: dict with entries 'a', 'b', 'c'.

    Returns:
        (qsim, storage, final_state): series (N, T) and final (N,) -- or
        (T,) and a scalar tensor for scalar parameters.
    """
    (a, b, c, s_prev), single = _members(prec, state, params)
    A_cum, B_cum = affine_prefix((1.0 - c)[:, None], a[:, None] * prec)
    storage = A_cum * s_prev[:, None] + B_cum
    qsim = _outputs(prec, a, b, c, s_prev, storage)
    return _finish((qsim, storage, storage[:, -1]), single)
