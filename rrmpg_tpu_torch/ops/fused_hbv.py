"""Fused HBV-Edu ensemble kernels: wrappers and their plain versions.

Counterpart of ``rrmpg_tpu/ops/pallas_hbv.py``.  The kernels are CUDA C++
in ``rrmpg_tpu_torch/csrc/hbv_fused.cu``: one thread per member, the four
stores and the member's constants in registers for the whole time loop;
K12 stages its five series 64 steps at a time in shared memory and, in
float32, takes the soil power as ``exp2(Beta * log2(x))`` where ``x >= 0``
and ``Beta != 0`` (IEEE ``powf`` elsewhere, so its NaN members are the
plain version's).

* K13 :func:`hbv_simulate_fused` -- (N, T) discharge trajectories;
* K12 :func:`hbv_ensemble_mse_fused` -- fused simulate + MSE, one number
  per member, or with ``stats=True`` the (4, N) time means
  [mse, mean_q, mean_q^2, mean_q*qobs] for NSE/KGE via
  :func:`~.stats.losses_from_stats`;
* K14 :func:`hbv_simulate_state_fused` -- forecast mode: trajectories plus
  the four end-of-series stores, entering cold or from carried stores; K12
  enters from carried stores too (``state=``).

A cold start freezes the stores at ``t = 0`` and gives ``q = 0`` there (the
reference's initialization step); a warm continuation advances them at
every step.  ``state`` is any ``(snow, soil, s1, s2)`` tuple of scalars or
(N,) tensors (an ``HBVEduState``); it takes the place of the ``*_init``
scalars in the packed rows.

On a CUDA tensor a wrapper launches its kernel or raises; only for tensors
the caller put on the CPU it runs its plain PyTorch version
(``*_reference``), written operation for operation like the kernel: the
step multiplies by the packed ``1/FC`` and ``1/PWP`` where
:mod:`.hbvedu` divides.

A negative soil store gives NaN through the ``Beta`` power, in the kernels
as in the plain versions; a NaN discharge at a step with an observation
makes that member's result NaN.
"""

import torch

from ..utils.tracing import traced
from ._launch import check_inputs, launch, register_kernels, valid_count
from .hbvedu import PARAM_NAMES

register_kernels("hbv_mse", "hbv_stats", "hbv_traj", "hbv_traj_state")

NUM_ROWS = 17


def pack_params(params, snow_init, soil_init, s1_init, s2_init):
    """(17, N) contiguous: the 11 parameters in ``PARAM_NAMES`` order, the
    four initial stores, ``1/FC`` and ``1/PWP``."""
    ref = params['T_t']
    rows = [params[k] for k in PARAM_NAMES]
    rows += [torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
             .expand_as(ref) for v in (snow_init, soil_init, s1_init, s2_init)]
    rows += [1.0 / params['FC'], 1.0 / params['PWP']]
    return torch.stack(rows).contiguous()


def _month_series(month, pe_m, t_m):
    """The climatologies gathered to one value per step."""
    return pe_m[month].contiguous(), t_m[month].contiguous()


# ---------------------------------------------------------------------------
# Plain versions: the kernel's loop, batched over members
# ---------------------------------------------------------------------------

class _Members:
    """Per-member constants and stores, as the kernel keeps in registers."""

    def __init__(self, packed, warm=False):
        self.warm = warm
        (self.T_t, self.DD, _, self.Beta, self.C, self.PWP, self.K_0,
         self.K_1, self.K_2, self.K_p, self.L, snow, soil, s1, s2,
         self.iFC, self.iPWP) = packed
        self.snow, self.soil = snow.clone(), soil.clone()
        self.s1, self.s2 = s1.clone(), s2.clone()

    def step(self, t, temp, prec, pe_month, t_month):
        """One HBV-Edu step (``hbv_step`` in the CUDA source); returns q.
        Step 0 of a cold start is the initialization step."""
        if t == 0 and not self.warm:
            return torch.zeros_like(self.snow)
        freezing = temp < self.T_t
        melt_pot = self.DD * (temp - self.T_t)
        snow = torch.where(freezing, self.snow + prec,
                           torch.clamp(self.snow - melt_pot, min=0.0))
        liquid = torch.where(freezing, 0.0,
                             prec + torch.minimum(self.snow, melt_pot))
        prec_eff = liquid * torch.pow(self.soil * self.iFC, self.Beta)
        pe = (1.0 + self.C * (temp - t_month)) * pe_month
        ea = torch.where(self.soil > self.PWP, pe,
                         pe * (self.soil * self.iPWP))
        soil = self.soil + liquid - prec_eff - ea
        overflow = torch.clamp(self.s1 - self.L, min=0.0) * self.K_0
        s1 = (self.s1 + prec_eff - overflow - self.s1 * self.K_1
              - self.s1 * self.K_p)
        s2 = self.s2 + self.s1 * self.K_p - self.s2 * self.K_2
        self.snow, self.soil, self.s1, self.s2 = snow, soil, s1, s2
        return overflow + s1 * self.K_1 + s2 * self.K_2


def hbv_simulate_reference(temp, prec, pe_series, tm_series, packed):
    """Plain version of K13: (N, T) trajectories."""
    m = _Members(packed)
    out = prec.new_empty((packed.shape[1], prec.shape[0]))
    for t in range(prec.shape[0]):
        out[:, t] = m.step(t, temp[t], prec[t], pe_series[t], tm_series[t])
    return out


def hbv_simulate_state_reference(temp, prec, pe_series, tm_series, packed,
                                 warm=False):
    """Plain version of K14: (N, T) trajectories and the (4, N) final
    stores [snow, soil, s1, s2]; ``warm`` advances the stores at every
    step."""
    m = _Members(packed, warm)
    out = prec.new_empty((packed.shape[1], prec.shape[0]))
    for t in range(prec.shape[0]):
        out[:, t] = m.step(t, temp[t], prec[t], pe_series[t], tm_series[t])
    return out, torch.stack([m.snow, m.soil, m.s1, m.s2])


def hbv_objective_reference(temp, prec, pe_series, tm_series, qobs, packed,
                            stats=False, masked=False, count=None,
                            warm=False):
    """Plain version of K12: (N,) mean squared errors, or with
    ``stats=True`` the (4, N) time means.  ``masked`` drops steps whose
    observation is NaN; the sums are divided by ``count`` (default T);
    ``warm`` advances the stores at every step."""
    m = _Members(packed, warm)
    T = prec.shape[0]
    valid = torch.isfinite(qobs) if masked else None
    acc = packed.new_zeros((4 if stats else 1, packed.shape[1]))
    for t in range(T):
        q = m.step(t, temp[t], prec[t], pe_series[t], tm_series[t])
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

@traced("ops.hbv_simulate_fused")
def hbv_simulate_fused(temp, prec, month, pe_m, t_m, snow_init, soil_init,
                       s1_init, s2_init, params):
    """Fused-ensemble HBV-Edu simulation (K13); returns qsim of shape
    (N, T).

    Args:
        temp, prec: (T,) forcing tensors.
        month: (T,) 0-based integer month indices.
        pe_m, t_m: (12,) monthly climatologies.
        snow_init, soil_init, s1_init, s2_init: initial storages.
        params: dict of (N,) tensors for the 11 HBV parameters.
    """
    packed = pack_params(params, snow_init, soil_init, s1_init, s2_init)
    pe_series, tm_series = _month_series(month, pe_m, t_m)
    series = (temp, prec, pe_series, tm_series)
    t_len = check_inputs("HBV-Edu", series, packed, NUM_ROWS)
    if prec.device.type == "cpu":
        return hbv_simulate_reference(*series, packed)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    launch("hbv_traj", lib.rrmpg_hbv_simulate_f32, lib.rrmpg_hbv_simulate_f64,
           prec.dtype, prec.device, *(x.data_ptr() for x in series),
           packed.data_ptr(), n, t_len, out.data_ptr())
    return out


def _inits(state, snow_init, soil_init, s1_init, s2_init):
    """The four initial stores: the carried ones of a warm entry, else the
    cold-start scalars."""
    if state is None:
        return snow_init, soil_init, s1_init, s2_init
    return tuple(state)


@traced("ops.hbv_simulate_state_fused")
def hbv_simulate_state_fused(temp, prec, month, pe_m, t_m, snow_init,
                             soil_init, s1_init, s2_init, params, state=None):
    """Forecast-mode fused HBV-Edu (K14); returns (qsim (N, T), final
    stores ``(snow, soil, s1, s2)``, each (N,)).

    With ``state`` (carried stores, scalars or (N,) tensors) every step
    advances them, as :func:`~.hbvedu.run_hbvedu_warm`; without, the run is
    :func:`hbv_simulate_fused`'s cold start.  Chaining segments through the
    returned stores reproduces the unbroken run.  Other args as
    :func:`hbv_simulate_fused`; T >= 1.
    """
    warm = state is not None
    packed = pack_params(params, *_inits(state, snow_init, soil_init,
                                         s1_init, s2_init))
    pe_series, tm_series = _month_series(month, pe_m, t_m)
    series = (temp, prec, pe_series, tm_series)
    t_len = check_inputs("HBV-Edu", series, packed, NUM_ROWS)
    if t_len < 1:
        raise ValueError("a state-carrying simulation needs T >= 1.")
    if prec.device.type == "cpu":
        out, fstate = hbv_simulate_state_reference(*series, packed, warm)
        return out, tuple(fstate)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    fstate = torch.empty((4, n), dtype=prec.dtype, device=prec.device)
    launch("hbv_traj_state", lib.rrmpg_hbv_simulate_state_f32,
           lib.rrmpg_hbv_simulate_state_f64, prec.dtype, prec.device,
           *(x.data_ptr() for x in series), packed.data_ptr(), n, t_len,
           int(warm), out.data_ptr(), fstate.data_ptr())
    return out, tuple(fstate)


@traced("ops.hbv_ensemble_mse_fused")
def hbv_ensemble_mse_fused(temp, prec, month, pe_m, t_m, qobs, snow_init,
                           soil_init, s1_init, s2_init, params, stats=False,
                           masked=False, state=None, count=None):
    """Fused HBV-Edu simulate + objective (K12).

    Returns (N,) mean squared errors, or with ``stats=True`` a (4, N)
    tensor of time means [mse, mean_q, mean_q^2, mean_q*qobs].

    ``masked=True`` treats NaN observations as gaps: they are left out of
    the sums, which are normalized over the valid count.  An observation
    record with no valid step raises ``ValueError``.

    With ``state`` (carried stores ``(snow, soil, s1, s2)``, scalars or
    (N,) tensors) the objective is that of a warm continuation: every step
    advances the stores and the ``*_init`` scalars are not read.

    ``count`` (optional) is :func:`~._launch.valid_count` of ``qobs``, taken
    once by a caller that launches many times.
    """
    warm = state is not None
    packed = pack_params(params, *_inits(state, snow_init, soil_init,
                                         s1_init, s2_init))
    pe_series, tm_series = _month_series(month, pe_m, t_m)
    series = (temp, prec, pe_series, tm_series, qobs)
    t_len = check_inputs("HBV-Edu", series, packed, NUM_ROWS)
    if count is None:
        count = valid_count(qobs, masked)
    if prec.device.type == "cpu":
        return hbv_objective_reference(*series, packed, stats, masked, count,
                                       warm)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((4, n) if stats else (n,), dtype=prec.dtype,
                      device=prec.device)
    launch("hbv_stats" if stats else "hbv_mse", lib.rrmpg_hbv_objective_f32,
           lib.rrmpg_hbv_objective_f64, prec.dtype, prec.device,
           *(x.data_ptr() for x in series), packed.data_ptr(), n, t_len,
           int(stats), int(masked), int(warm), float(count), out.data_ptr())
    return out
