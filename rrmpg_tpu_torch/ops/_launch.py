"""Launching the CUDA library's entry points, and counting the launches.

Shared by the fused kernel modules (:mod:`.fused_gr4j`, :mod:`.fused_abc`,
:mod:`.fused_hbv`, :mod:`.fused_snow`).  :data:`LAUNCHES` holds one count per kernel; a
wrapper adds one where it launches its kernel and nowhere else, so a run
can show which kernels it went through.  The counts live in
:mod:`..utils.tracing` with the port's other counters and spans; this
module hands on the same objects.
"""

import torch

from ..config import FLOAT_DTYPES
from ..utils.tracing import (LAUNCHES, annotate,  # noqa: F401
                             register_kernels, reset_launches, sync)


def check_inputs(family, series, packed, rows):
    """Device, dtype, shape and contiguity checks shared by the wrappers:
    ``series`` are (T,) tensors, ``packed`` the (rows, N) parameter block.
    Returns T."""
    ref = series[0]
    if ref.dtype not in FLOAT_DTYPES:
        raise TypeError(f"fused {family} kernels take float32 or float64, "
                        f"got {ref.dtype}.")
    t_len = ref.shape[0]
    for x in (*series, packed):
        if x.device != ref.device or x.dtype != ref.dtype:
            raise ValueError(
                f"every input of a fused {family} kernel must share one "
                f"device and dtype; got {x.device}/{x.dtype} and "
                f"{ref.device}/{ref.dtype}.")
        if not x.is_contiguous():
            raise ValueError(
                f"fused {family} kernel inputs must be contiguous.")
    for x in series:
        if x.dim() != 1 or x.shape[0] != t_len:
            raise ValueError(
                f"forcing and observation series must all be (T,), got "
                f"{[tuple(s.shape) for s in series]}.")
    if packed.dim() != 2 or packed.shape[0] != rows:
        raise ValueError(f"packed params must be ({rows}, N), got "
                         f"{tuple(packed.shape)}.")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused {family} kernels run on CUDA tensors (or, "
                         f"in their plain version, CPU tensors); got "
                         f"{ref.device}.")
    return t_len


def check_block(family, ref, block, shape, name):
    """A further input block of a wrapper (state rows, a history): it must
    have ``shape`` and be contiguous on ``ref``'s device in its dtype."""
    if (block.device != ref.device or block.dtype != ref.dtype
            or tuple(block.shape) != tuple(shape)
            or not block.is_contiguous()):
        raise ValueError(
            f"{name} of a fused {family} kernel must be a contiguous "
            f"{tuple(shape)} block on {ref.device}/{ref.dtype}; got "
            f"{tuple(block.shape)} on {block.device}/{block.dtype}.")


def check_regional_inputs(family, series, packed, rows):
    """The checks of :func:`check_inputs` for a regional wrapper: ``series``
    are (C, T) tensors, one row per catchment, and ``packed`` the (rows, N)
    parameter block every catchment shares.  Returns (C, T)."""
    ref = series[0]
    if ref.dtype not in FLOAT_DTYPES:
        raise TypeError(f"fused {family} kernels take float32 or float64, "
                        f"got {ref.dtype}.")
    if ref.dim() != 2 or ref.shape[0] < 1 or any(
            tuple(x.shape) != tuple(ref.shape) for x in series):
        raise ValueError(
            f"regional series must all be (C, T), one row per catchment; "
            f"got {[tuple(x.shape) for x in series]}.")
    check_inputs(family, [x[0] for x in series], packed, rows)
    for x in series:
        if not x.is_contiguous():
            raise ValueError(
                f"fused {family} kernel inputs must be contiguous.")
    return tuple(ref.shape)


def valid_counts(qobs, masked):
    """``(counts, masked)`` for a (C, T) record: the (C,) steps each
    catchment averages over, on the record's device and in its dtype, and
    whether the objective masks.  ``masked=None`` masks where the record
    has a NaN; a masked catchment with no finite observation raises,
    naming it.  Detection and check share one read back to the host."""
    num_catchments, t_len = qobs.shape
    if masked is not False:
        counts = torch.isfinite(qobs).sum(dim=1)
        on_host = sync("ops.valid_counts", counts.tolist)
        if masked is None:
            masked = any(k < t_len for k in on_host)
    if not masked:
        return qobs.new_full((num_catchments,), float(t_len)), False
    empty = [c for c, k in enumerate(on_host) if k == 0]
    if empty:
        raise ValueError(
            f"catchment {empty[0]} has no finite observation (all-NaN "
            f"catchments: {empty}): a masked objective over zero valid "
            "steps is undefined.")
    return counts.to(qobs.dtype), True


def valid_count(qobs, masked):
    """Steps a masked objective averages over; raises if there is none."""
    if not masked:
        return qobs.shape[0]
    count = sync("ops.valid_count", int, torch.isfinite(qobs).sum())
    if count == 0:
        raise ValueError(
            "qobs has no finite value: a masked objective over zero "
            "valid steps is undefined.")
    return count


def launch(kernel, fn_f32, fn_f64, dtype, device, *args):
    """Call the float32 or float64 entry point on ``device``'s current
    stream, raise on a CUDA error and count one launch of ``kernel``.

    The entry points select ``device`` themselves (``cudaSetDevice`` of
    the library's own, static CUDA runtime), which moves the calling
    thread's current device; the call runs under ``torch.cuda.device``,
    so the caller's current device is back when it returns (a mesh
    launches on every device in turn)."""
    fn = fn_f32 if dtype == torch.float32 else fn_f64
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed with cudaError_t {err}.")
    LAUNCHES[kernel] += 1
    annotate(kernel=kernel)
