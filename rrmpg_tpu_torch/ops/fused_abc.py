"""Fused ABC-model kernels: wrappers and their plain version.

Counterpart of ``rrmpg_tpu/ops/pallas_linear_scan.py``.  The kernels are
CUDA C++ in ``rrmpg_tpu_torch/csrc/abc_scan.cu``: a chunked parallel scan
over the affine maps ``S -> (1-c) S + a P[t]``.

* K6 :func:`abc_fused_single` -- one launch; the series is read once and
  both outputs are written once (chunks publish their composed maps in
  global memory, the last chunk of each group of 32 its group's, and each
  chunk composes its incoming state from the groups before its own and
  the chunks before it in its group, in an order its index fixes: the
  same bits on every run);
* K7 :func:`abc_fused` -- the same function in three launches (chunk
  totals, carries, outputs), reading the series twice.

Both return ``(qsim, storage)``; with scalar parameters each is (T,), with
per-member (N,) parameters each is (N, T) from one launch.  On a CUDA
tensor a wrapper launches its kernel or raises; only for tensors the
caller put on the CPU it runs the plain version,
:func:`~.abc.run_abcmodel_pscan`.
"""

import torch

from ._launch import check_inputs, launch, register_kernels
from .abc import _finish, _members, run_abcmodel_pscan

register_kernels("abc_fused_single", "abc_fused")


def _run(kernel, prec, initial_state, params):
    (a, b, c, s0), single = _members(prec, initial_state, params)
    scal = torch.stack([1.0 - a - b, c, a, s0]).contiguous()     # (4, N)
    t_len = check_inputs("ABC", (prec,), scal, 4)
    if prec.device.type == "cpu":
        return run_abcmodel_pscan(prec, initial_state, params)
    from ._build import load_library

    lib = load_library()
    n = scal.shape[1]
    chunk = lib.rrmpg_abc_chunk_size(int(prec.dtype == torch.float64))
    blocks = n * (-(-t_len // chunk))
    qsim = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    storage = torch.empty_like(qsim)
    scratch_real = torch.empty(3 * blocks, dtype=prec.dtype,
                               device=prec.device)
    args = [prec.data_ptr(), scal.data_ptr(), n, t_len]
    if kernel == "abc_fused_single":
        # The ticket, and the 64-bit words in which each chunk publishes
        # its pair (two a pair in float32, four in float64); the entry
        # point zeroes them.
        scratch_int = torch.empty(1 + blocks * prec.element_size() // 2,
                                  dtype=torch.int64, device=prec.device)
        args.append(scratch_int.data_ptr())
        fns = (lib.rrmpg_abc_single_f32, lib.rrmpg_abc_single_f64)
    else:
        fns = (lib.rrmpg_abc_chunked_f32, lib.rrmpg_abc_chunked_f64)
    launch(kernel, *fns, prec.dtype, prec.device, *args,
           scratch_real.data_ptr(), qsim.data_ptr(), storage.data_ptr())
    return _finish((qsim, storage), single)


def abc_fused_single(prec, initial_state, params):
    """ABC-model simulation in one kernel launch (K6).

    Args:
        prec: (T,) precipitation tensor.
        initial_state: initial storage, scalar or (N,).
        params: dict with entries 'a', 'b', 'c', scalars or (N,) tensors.

    Returns:
        (qsim, storage), each (N, T) -- or (T,) for scalar parameters.
    """
    return _run("abc_fused_single", prec, initial_state, params)


def abc_fused(prec, initial_state, params):
    """ABC-model simulation as a three-launch chunked scan (K7); arguments
    and results as :func:`abc_fused_single`."""
    return _run("abc_fused", prec, initial_state, params)
