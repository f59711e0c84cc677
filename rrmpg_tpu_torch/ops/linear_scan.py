"""First-order linear recurrences as batched Toeplitz products.

Counterpart of ``rrmpg_tpu/ops/linear_scan.py``.  Solves
``S[t] = alpha * S[t-1] + b[t]`` without a loop over time:

* Split the series into chunks of length C.  Within a chunk,
  ``S[i] = alpha^(i+1) * s_start + sum_{j<=i} alpha^(i-j) b[j]``: the sum
  is a product with the lower-triangular Toeplitz matrix
  ``M[i, j] = alpha^(i-j)``, so all chunks evaluate as one batched
  (T/C, C) x (C, C) ``torch.matmul``.
* The chunk-boundary states follow the same recurrence at stride C
  (coefficient ``alpha^C``) on the chunk aggregates, so the construction
  recurses on them: four levels reach 10M steps with C = 128.

A leading member axis stands in for JAX's ``vmap``: per-member ``alpha``
gives one batched matmul.  The products are at least full float32
whatever ``torch.get_float32_matmul_precision()`` says, as JAX passes
``Precision.HIGHEST``: float32 operands are multiplied in float64
(:func:`_product`), so TF32 never enters.

Each level builds one (C, C) matrix a member.  Members go through in
groups of at most ``MATRIX_ELEMENTS // C**2`` (8192 at C = 128), so that
the matrices of a level (and their float64 copies) stay near 1 GB however
many members a Monte-Carlo run or a population holds; fewer members make
one group.

Used by the ABC model's ``'scan'`` engine
(:func:`~.abc.run_abcmodel_matscan`, :func:`~.abc.run_abcmodel_warm`),
which builds its powers from ``c`` instead of a rounded ``1 - c``.
"""

import torch
import torch.nn.functional as F

from ..config import DEFAULT_DEVICE, default_float, resolve_device

# The most (member, C, C) matrix elements one level builds at once.
MATRIX_ELEMENTS = 2 ** 27


def _product(x, y):
    """``x @ y``; float32 operands are multiplied and summed in float64 and
    rounded once, so that no TF32 (nor another reduced precision the
    process may have set) enters, as JAX asks for ``Precision.HIGHEST``."""
    if x.dtype == torch.float32:
        return torch.matmul(x.double(), y.double()).float()
    return torch.matmul(x, y)


def _toeplitz_lower(power, C, device):
    """(N, C, C) lower-triangular matrices M[n, i, j] = alpha_n^(i-j)."""
    k = torch.arange(C, device=device)
    diff = k[:, None] - k[None, :]
    M = power(diff.clamp_min(0))
    return torch.where(diff >= 0, M, torch.zeros((), dtype=M.dtype,
                                                 device=device))


def solve(power, b, s0, chunk=128):
    """S (N, n) with ``S[:, k] = alpha * S[:, k-1] + b[:, k]``, ``S[:, -1] =
    s0`` (N,), where ``power(k, rows)`` gives ``alpha^k`` for the members
    ``rows`` (a slice), (rows,) + ``k.shape``, for an integer tensor ``k``.
    Members go through in groups (see the module's docstring)."""
    N = b.shape[0]
    group = max(1, MATRIX_ELEMENTS // (chunk * chunk))
    if N <= group:
        return _solve(lambda k: power(k, slice(None)), b, s0, chunk)
    return torch.cat([
        _solve(lambda k, rows=slice(lo, lo + group): power(k, rows),
               b[lo:lo + group], s0[lo:lo + group], chunk)
        for lo in range(0, N, group)])


def _solve(power, b, s0, chunk):
    """:func:`solve` for one group of members, ``power(k)`` theirs."""
    N, n = b.shape
    if n == 0:
        return b
    device = b.device
    if n <= chunk:
        conv = _product(_toeplitz_lower(power, n, device),
                        b[:, :, None])[:, :, 0]
        powers = power(torch.arange(1, n + 1, device=device))
        return conv + powers * s0[:, None]
    m = -(-n // chunk)
    # within[:, k, i] = sum_{j<=i} alpha^(i-j) b[:, k*C + j]: one batched
    # product over all chunks of all members.  The matrices are freed
    # before the recursion builds the next level's.
    within = _product(F.pad(b, (0, m * chunk - n)).reshape(N, m, chunk),
                      _toeplitz_lower(power, chunk, device).transpose(1, 2))
    # The states before each chunk: the same recurrence at stride C on the
    # chunk aggregates, coefficient alpha^C.
    starts_tail = _solve(lambda k: power(k * chunk), within[:, :-1, -1], s0,
                         chunk)
    starts = torch.cat([s0[:, None], starts_tail], dim=1)
    powers = power(torch.arange(1, chunk + 1, device=device))
    S = within + powers[:, None, :] * starts[:, :, None]
    return S.reshape(N, m * chunk)[:, :n]


def linear_recurrence(alpha, b, s0, chunk=128, device=None):
    """Solve ``S[k] = alpha * S[k-1] + b[k]`` for k = 0..n-1 with
    ``S[-1] = s0``.

    Args:
        alpha: recurrence coefficient, scalar or (N,).
        b: (n,) input series, or (N, n) one per member.  A tensor stays on
            its device and keeps its dtype; anything else becomes a tensor
            of ``config.default_float()`` on ``device``.
        s0: initial state (the value *before* b[0] is applied), scalar or
            (N,).
        chunk: Toeplitz block size.
        device: where a ``b`` that is not a tensor goes; default
            ``config.DEFAULT_DEVICE`` (the card).

    Returns:
        (n,) states S[0..n-1] when every argument is unbatched, else (N, n).
    """
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=default_float(), device=resolve_device(
            DEFAULT_DEVICE if device is None else device))
    elif device is not None:
        b = b.to(resolve_device(device))
    alpha, s0 = (torch.as_tensor(v, dtype=b.dtype, device=b.device)
                 for v in (alpha, s0))
    single = alpha.dim() == 0 and s0.dim() == 0 and b.dim() == 1
    n = b.shape[-1]
    N = max([alpha.shape[0] if alpha.dim() else 1,
             s0.shape[0] if s0.dim() else 1,
             b.shape[0] if b.dim() == 2 else 1])
    alpha = alpha.expand(N)

    def power(k, rows):
        return alpha[rows].reshape((-1,) + (1,) * k.dim()) ** k.to(b.dtype)

    out = solve(power, b.expand(N, n), s0.expand(N), chunk)
    return out[0] if single else out
