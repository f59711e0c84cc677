"""Fused GR4J ensemble kernels: wrappers and their plain versions.

Counterpart of ``rrmpg_tpu/ops/pallas_gr4j.py``.  The kernels are CUDA C++
in ``rrmpg_tpu_torch/csrc/gr4j_fused.cu``: one thread per member, stores
and UH shift registers in registers for the whole time loop.

* K3 :func:`gr4j_simulate_fused` -- (N, T) discharge trajectories;
* K1 :func:`gr4j_ensemble_mse_fused` -- fused simulate + MSE, one
  number per member (the Monte-Carlo / calibration production path);
* K2 the same with ``stats=True`` -- (4, N) time means
  [mse, mean_q, mean_q^2, mean_q*qobs] for NSE/KGE via
  :func:`~.stats.losses_from_stats`.

Each wrapper takes its kernel for CUDA tensors (or raises) and, only
because the tensors lie on the CPU, its plain PyTorch version
(``*_reference``): a batched shift-register loop written like the kernel.
:data:`LAUNCHES` counts kernel launches per kernel.
"""

import torch

from ..config import FLOAT_DTYPES
from .uh import NUM_UH1, NUM_UH2, uh_ordinates

# UH register lengths the CUDA library is instantiated for.
SUPPORTED_UH = ((3, 7), (NUM_UH1, NUM_UH2))

# Kernel launches since the last reset_launches(), by kernel.
LAUNCHES = {"gr4j_mse": 0, "gr4j_stats": 0, "gr4j_traj": 0}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_uh(num_uh1, num_uh2):
    if (num_uh1, num_uh2) not in SUPPORTED_UH:
        raise ValueError(
            f"The fused GR4J kernels support UH register lengths "
            f"{SUPPORTED_UH}; got ({num_uh1}, {num_uh2}). Use engine='scan' "
            "for x4 above 10.")


def pack_params(params, s_init, r_init):
    """(6, N) contiguous [x1, x2, x3, x4, s0, r0], with s0/r0 absolute."""
    x1, x3 = params['x1'], params['x3']
    return torch.stack([x1, params['x2'], x3, params['x4'],
                        s_init * x1, r_init * x3]).contiguous()


def _check_inputs(series, packed):
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    ref = series[0]
    if ref.dtype not in FLOAT_DTYPES:
        raise TypeError(f"fused GR4J kernels take float32 or float64, got "
                        f"{ref.dtype}.")
    t_len = ref.shape[0]
    for x in (*series, packed):
        if x.device != ref.device or x.dtype != ref.dtype:
            raise ValueError(
                "every input of a fused GR4J kernel must share one device "
                f"and dtype; got {x.device}/{x.dtype} and "
                f"{ref.device}/{ref.dtype}.")
        if not x.is_contiguous():
            raise ValueError("fused GR4J kernel inputs must be contiguous.")
    for x in series:
        if x.dim() != 1 or x.shape[0] != t_len:
            raise ValueError(
                f"forcing and observation series must all be (T,), got "
                f"{[tuple(s.shape) for s in series]}.")
    if packed.dim() != 2 or packed.shape[0] != 6:
        raise ValueError(f"packed params must be (6, N), got "
                         f"{tuple(packed.shape)}.")
    if ref.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused GR4J kernels run on CUDA tensors (or, in "
                         f"their plain version, CPU tensors); got "
                         f"{ref.device}.")
    return t_len


def _launch(fn_f32, fn_f64, dtype, device, *args):
    fn = fn_f32 if dtype == torch.float32 else fn_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"{fn.__name__} failed with cudaError_t {err}.")


# ---------------------------------------------------------------------------
# Plain versions: the kernel's loop, batched over members
# ---------------------------------------------------------------------------

class _Members:
    """Per-member parameters and state, as the kernel keeps in registers."""

    def __init__(self, packed, num_uh1, num_uh2):
        x1, x2, x3, x4, s0, r0 = packed
        self.x1, self.x2 = x1, x2
        self.ix1, self.ix3 = 1.0 / x1, 1.0 / x3
        self.s, self.r = s0.clone(), r0.clone()
        self.oh1, self.oh2 = uh_ordinates(x4, num_uh1, num_uh2)
        self.uh1 = torch.zeros_like(self.oh1)
        self.uh2 = torch.zeros_like(self.oh2)

    def step(self, p, e):
        """One GR4J step (``gr4j_step`` in the CUDA source); returns q."""
        p_n = torch.clamp(p - e, min=0.0)
        pe_n = torch.clamp(e - p, min=0.0)
        s, x1, ix1, ix3 = self.s, self.x1, self.ix1, self.ix3
        sr = s * ix1
        tanh_pn = torch.tanh(p_n * ix1)
        tanh_pen = torch.tanh(pe_n * ix1)
        p_s = (x1 * (1.0 - sr * sr) * tanh_pn) / (1.0 + sr * tanh_pn)
        e_s = (s * (2.0 - sr) * tanh_pen) / (1.0 + (1.0 - sr) * tanh_pen)
        s_interim = s - e_s + p_s
        zs = (s_interim * ix1 * (4.0 / 9.0)) ** 2
        perc = s_interim * (1.0 - torch.rsqrt(torch.sqrt(1.0 + zs * zs)))
        self.s = s_interim - perc
        p_r = perc + (p_n - p_s)

        # Shift registers: uh[j] <- uh[j+1] + oh[j] * pr, uh[-1] <- oh[-1] * pr.
        self.uh1 = (torch.nn.functional.pad(self.uh1[:, 1:], (0, 1))
                    + self.oh1 * (0.9 * p_r)[:, None])
        self.uh2 = (torch.nn.functional.pad(self.uh2[:, 1:], (0, 1))
                    + self.oh2 * (0.1 * p_r)[:, None])

        r = self.r
        rx = r * ix3
        gw_exchange = self.x2 * (rx * rx * rx * torch.sqrt(rx))
        r_interim = torch.clamp(r + self.uh1[:, 0] + gw_exchange, min=0.0)
        zr = (r_interim * ix3) ** 2
        q_r = r_interim * (1.0 - torch.rsqrt(torch.sqrt(1.0 + zr * zr)))
        self.r = r_interim - q_r
        q_d = torch.clamp(self.uh2[:, 0] + gw_exchange, min=0.0)
        return q_r + q_d


def gr4j_simulate_reference(prec, etp, packed, num_uh1=NUM_UH1,
                            num_uh2=NUM_UH2):
    """Plain version of K3: (N, T) trajectories."""
    m = _Members(packed, num_uh1, num_uh2)
    out = prec.new_empty((packed.shape[1], prec.shape[0]))
    for t in range(prec.shape[0]):
        out[:, t] = m.step(prec[t], etp[t])
    return out


def gr4j_objective_reference(prec, etp, qobs, packed, num_uh1=NUM_UH1,
                             num_uh2=NUM_UH2, stats=False, masked=False,
                             count=None):
    """Plain version of K1 (``stats=False``, (N,)) and K2 (``stats=True``,
    (4, N)).  ``masked`` drops steps whose observation is NaN; the sums
    are divided by ``count`` (default T)."""
    m = _Members(packed, num_uh1, num_uh2)
    T = prec.shape[0]
    valid = torch.isfinite(qobs) if masked else None
    acc = packed.new_zeros((4 if stats else 1, packed.shape[1]))
    for t in range(T):
        q = m.step(prec[t], etp[t])
        qo = qobs[t]
        diff = q - qo
        terms = [diff * diff]
        if stats:
            terms += [q, q * q, q * qo]
        terms = torch.stack(terms)
        if masked:
            terms = torch.where(valid[t], terms, 0.0)
        acc += terms
    out = acc / (T if count is None else count)
    return out if stats else out[0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def gr4j_simulate_fused(prec, etp, s_init, r_init, params, num_uh1=NUM_UH1,
                        num_uh2=NUM_UH2):
    """Fused-ensemble GR4J simulation (K3); returns qsim of shape (N, T).

    Args:
        prec, etp: (T,) forcing tensors.
        s_init, r_init: store initializations as fractions of x1 / x3.
        params: dict of (N,) tensors x1..x4 on the forcing's device.
        num_uh1, num_uh2: UH register lengths, one of ``SUPPORTED_UH``.
    """
    _check_uh(num_uh1, num_uh2)
    packed = pack_params(params, s_init, r_init)
    t_len = _check_inputs((prec, etp), packed)
    if prec.device.type == "cpu":
        return gr4j_simulate_reference(prec, etp, packed, num_uh1, num_uh2)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    _launch(lib.rrmpg_gr4j_simulate_f32, lib.rrmpg_gr4j_simulate_f64,
            prec.dtype, prec.device, prec.data_ptr(), etp.data_ptr(),
            packed.data_ptr(), n, t_len, num_uh1, num_uh2, out.data_ptr())
    LAUNCHES["gr4j_traj"] += 1
    return out


def gr4j_ensemble_mse_fused(prec, etp, qobs, s_init, r_init, params,
                            num_uh1=NUM_UH1, num_uh2=NUM_UH2, stats=False,
                            masked=False, state=None):
    """Fused GR4J simulate + objective (K1, or K2 with ``stats=True``).

    Returns (N,) mean squared errors, or with ``stats=True`` a (4, N)
    tensor of time means [mse, mean_q, mean_q^2, mean_q*qobs].

    ``masked=True`` treats NaN observations as gaps: they are left out of
    the sums, which are normalized over the valid count.  An observation
    record with no valid step raises ``ValueError``.

    ``state`` (warm entry from a carried state) is not ported yet.
    """
    if state is not None:
        raise NotImplementedError(
            "Warm entry (state=) of the fused GR4J objective is not ported "
            "yet; see ROADMAP.md, Queue 1, item 6 (forecast state).")
    _check_uh(num_uh1, num_uh2)
    packed = pack_params(params, s_init, r_init)
    t_len = _check_inputs((prec, etp, qobs), packed)
    count = t_len
    if masked:
        count = int(torch.isfinite(qobs).sum())
        if count == 0:
            raise ValueError(
                "qobs has no finite value: a masked objective over zero "
                "valid steps is undefined.")
    if prec.device.type == "cpu":
        return gr4j_objective_reference(prec, etp, qobs, packed, num_uh1,
                                        num_uh2, stats, masked, count)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((4, n) if stats else (n,), dtype=prec.dtype,
                      device=prec.device)
    _launch(lib.rrmpg_gr4j_objective_f32, lib.rrmpg_gr4j_objective_f64,
            prec.dtype, prec.device, prec.data_ptr(), etp.data_ptr(),
            qobs.data_ptr(), packed.data_ptr(), n, t_len, num_uh1, num_uh2,
            int(stats), int(masked), float(count), out.data_ptr())
    LAUNCHES["gr4j_stats" if stats else "gr4j_mse"] += 1
    return out
