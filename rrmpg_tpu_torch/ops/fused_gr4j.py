"""Fused GR4J ensemble kernels: wrappers and their plain versions.

Counterpart of ``rrmpg_tpu/ops/pallas_gr4j.py``.  The kernels are CUDA C++
in ``rrmpg_tpu_torch/csrc/gr4j_fused.cu``: one thread per member, stores
and UH shift registers in registers for the whole time loop.  The
objectives K1/K2 stage their forcing in shared memory and compute one
production arm a step; for ensembles of at most :func:`split_members`
members they run the production and the routing halves of each member's
step in separate warps (a calibration's population is latency-bound).
K3 and K4 stage their forcing the same way, compute one production arm a
step and gather their trajectories in shared-memory tiles that leave as
whole member rows (one time loop; K3 is K4 without the state, bit for bit
its cold entry); for ensembles of at most :func:`traj_split_members`
members (a calibrated member's simulation, a forecast's one-member
spin-up) they split the step between warps too.

* K3 :func:`gr4j_simulate_fused` -- (N, T) discharge trajectories;
* K1 :func:`gr4j_ensemble_mse_fused` -- fused simulate + MSE, one
  number per member (the Monte-Carlo / calibration production path);
* K2 the same with ``stats=True`` -- (4, N) time means
  [mse, mean_q, mean_q^2, mean_q*qobs] for NSE/KGE via
  :func:`~.stats.losses_from_stats`;
* K4 :func:`gr4j_simulate_state_fused` -- forecast mode: trajectories plus
  the end-of-series :class:`~.gr4j.GR4JState`, entering cold or from a
  carried state; K1/K2 enter from a carried state too (``state=``);
* K5 :func:`gr4j_regional_objective_fused` -- K1/K2 over C catchments in one
  launch: (C, T) series, one (N,) parameter set shared by every catchment,
  (C, N) losses or (4, C, N) statistics, each catchment normalized over its
  own valid count (the regional Monte-Carlo / calibration path,
  :mod:`~..parallel.regional`).

A carried state is batched over the members (one row per member).  One
state shared by every member is broadcast by the caller
(:func:`~..models.states.broadcast_state`) before it reaches a wrapper; the
kernels read a history row per member.

The card is the port's default device: models put their tensors there,
and on a CUDA tensor a wrapper launches its kernel or raises.  Only for
tensors the caller put on the CPU (``device='cpu'``, as the CPU tests do)
a wrapper runs its plain PyTorch version (``*_reference``): a batched
shift-register loop written like the kernel.  :data:`LAUNCHES` (shared
with the other kernel modules, :mod:`._launch`) counts launches per kernel.
"""

import torch

from ._launch import (LAUNCHES, check_block, check_inputs,  # noqa: F401
                      check_regional_inputs, launch, register_kernels,
                      reset_launches, valid_count, valid_counts)
from .gr4j import GR4JState
from .uh import NUM_UH1, NUM_UH2, uh_ordinates

register_kernels("gr4j_mse", "gr4j_stats", "gr4j_traj", "gr4j_traj_state",
                 "gr4j_regional")

# UH register lengths the CUDA library is instantiated for.
SUPPORTED_UH = ((3, 7), (NUM_UH1, NUM_UH2))


def split_members():
    """The largest ensemble for which K1/K2 run the production and the
    routing halves of the step in separate warps (a constant of the CUDA
    library); larger ones run one member a thread."""
    from ._build import load_library

    return load_library().rrmpg_gr4j_split_members()


def traj_split_members():
    """The largest ensemble for which K3 and K4 run the production and the
    routing halves of the step in separate warps (a constant of the CUDA
    library); larger ones gather their trajectories in shared-memory
    tiles, one member a thread."""
    from ._build import load_library

    return load_library().rrmpg_gr4j_traj_split_members()


def _check_uh(num_uh1, num_uh2):
    if (num_uh1, num_uh2) not in SUPPORTED_UH:
        raise ValueError(
            f"The fused GR4J kernels support UH register lengths "
            f"{SUPPORTED_UH}; got ({num_uh1}, {num_uh2}). Use engine='scan' "
            "for x4 above 10.")


def pack_params(params, s_init, r_init, state=None):
    """(6, N) contiguous [x1, x2, x3, x4, s0, r0], with s0/r0 absolute: the
    fractions ``s_init``/``r_init`` of x1/x3, or the carried levels of a
    batched ``state``."""
    x1, x3 = params['x1'], params['x3']
    if state is None:
        s0, r0 = s_init * x1, r_init * x3
    else:
        s0, r0 = (x.to(dtype=x1.dtype).expand_as(x1)
                  for x in (state.s, state.r))
    return torch.stack([x1, params['x2'], x3, params['x4'], s0,
                        r0]).contiguous()


def history_rows(state, num_uh2, like):
    """The routing-input history of a batched :class:`~.gr4j.GR4JState` as
    the kernels take it: the last ``num_uh2 - 1`` inputs as contiguous
    (H, N) rows, oldest first, in ``like``'s dtype.  A longer history (a
    state from a run with longer UH registers) is trimmed; a shorter one
    raises."""
    h_needed = num_uh2 - 1
    hist = state.pr_history
    h = hist.shape[1]
    if h < h_needed:
        raise ValueError(
            f"state.pr_history holds {h} routing inputs but num_uh2="
            f"{num_uh2} needs {h_needed}; build the state with a matching "
            "(or larger) num_uh2 -- a short history would silently "
            "zero-fill pre-split routed water.")
    return hist[:, h - h_needed:].to(dtype=like.dtype).T.contiguous()


# ---------------------------------------------------------------------------
# Plain versions: the kernel's loop, batched over members
# ---------------------------------------------------------------------------

class _Members:
    """Per-member parameters and state, as the kernel keeps in registers."""

    def __init__(self, packed, num_uh1, num_uh2, hist=None):
        x1, x2, x3, x4, s0, r0 = packed
        self.x1, self.x2 = x1, x2
        self.ix1, self.ix3 = 1.0 / x1, 1.0 / x3
        self.s, self.r = s0.clone(), r0.clone()
        self.oh1, self.oh2 = uh_ordinates(x4, num_uh1, num_uh2)
        self.uh1 = torch.zeros_like(self.oh1)
        self.uh2 = torch.zeros_like(self.oh2)
        self.p_r = None
        if hist is not None:
            self._warm_registers(hist)

    def _warm_registers(self, hist):
        """Warm entry (``gr4j_init`` with a history): push the (H, N)
        carried routing inputs, oldest first, through the empty registers.
        That leaves ``uh[j] = sum_k oh[j + k] * (share * hist[H-1-k])``,
        the partial filter sums still owed by past inputs."""
        for p_r in hist:
            self._push(p_r)

    def _push(self, p_r):
        """``uh_push``: uh[j] <- uh[j+1] + oh[j] * pr, uh[-1] <- oh[-1] * pr."""
        self.uh1 = (torch.nn.functional.pad(self.uh1[:, 1:], (0, 1))
                    + self.oh1 * (0.9 * p_r)[:, None])
        self.uh2 = (torch.nn.functional.pad(self.uh2[:, 1:], (0, 1))
                    + self.oh2 * (0.1 * p_r)[:, None])

    def step(self, p, e):
        """One GR4J step (``gr4j_step_pr`` in the CUDA source); returns q
        and keeps the routing input in ``self.p_r``."""
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
        self.p_r = p_r

        self._push(p_r)

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


def final_history(hist, p_r_steps):
    """The (H, N) history after a segment: the last H rows of
    ``[hist | p_r of every step]``."""
    full = torch.cat([hist, torch.stack(p_r_steps)])
    return full[full.shape[0] - hist.shape[0]:]


def gr4j_simulate_state_reference(prec, etp, packed, hist=None,
                                  num_uh1=NUM_UH1, num_uh2=NUM_UH2):
    """Plain version of K4: (N, T) trajectories and the (2 + H, N) state
    rows [s, r, history].  ``hist`` is the (H, N) incoming history, oldest
    first (warm entry), or None (cold: empty registers, zero history)."""
    m = _Members(packed, num_uh1, num_uh2, hist)
    n = packed.shape[1]
    if hist is None:
        hist = packed.new_zeros((num_uh2 - 1, n))
    out = prec.new_empty((n, prec.shape[0]))
    p_r_steps = []
    for t in range(prec.shape[0]):
        out[:, t] = m.step(prec[t], etp[t])
        p_r_steps.append(m.p_r)
    fstate = torch.cat([m.s[None], m.r[None],
                        final_history(hist, p_r_steps)])
    return out, fstate


def gr4j_objective_reference(prec, etp, qobs, packed, num_uh1=NUM_UH1,
                             num_uh2=NUM_UH2, stats=False, masked=False,
                             count=None, hist=None):
    """Plain version of K1 (``stats=False``, (N,)) and K2 (``stats=True``,
    (4, N)).  ``masked`` drops steps whose observation is NaN; the sums
    are divided by ``count`` (default T).  With ``hist`` ((H, N), oldest
    first) the members enter warm."""
    m = _Members(packed, num_uh1, num_uh2, hist)
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


def catchment_members(packed, num_catchments):
    """(rows, N) packed parameters -> (rows, C * N): catchment c's members
    are columns c * N .. c * N + N - 1, the kernel's (C, N) output order."""
    return packed.repeat(1, num_catchments)


def per_member(series_t, n):
    """A (C,) or (C, L) slice of catchment series at one step -> one row per
    member of :func:`catchment_members`' layout, (C * N,) or (C * N, L)."""
    c = series_t.shape[0]
    return series_t.unsqueeze(1).expand(c, n, *series_t.shape[1:]).reshape(
        c * n, *series_t.shape[1:])


def gr4j_regional_objective_reference(prec, etp, qobs, packed,
                                      num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                      stats=False, masked=False, counts=None):
    """Plain version of K5: (C, N) mean squared errors, with ``stats`` the
    (4, C, N) time means.  ``prec``, ``etp``, ``qobs`` are (C, T); every
    catchment runs the same (6, N) ``packed`` members, all catchments in
    one time loop over C * N members.  ``masked`` drops NaN observations;
    catchment c's sums are divided by ``counts[c]`` (a (C,) tensor,
    default T)."""
    num_catchments, t_len = prec.shape
    n = packed.shape[1]
    m = _Members(catchment_members(packed, num_catchments), num_uh1, num_uh2)
    valid = torch.isfinite(qobs) if masked else None
    acc = packed.new_zeros((4 if stats else 1, num_catchments * n))
    for t in range(t_len):
        q = m.step(per_member(prec[:, t], n), per_member(etp[:, t], n))
        qo = per_member(qobs[:, t], n)
        diff = q - qo
        terms = [diff * diff]
        if stats:
            terms += [q, q * q, q * qo]
        terms = torch.stack(terms)
        if masked:
            terms = torch.where(per_member(valid[:, t], n), terms, 0.0)
        acc += terms
    if counts is None:
        counts = prec.new_full((num_catchments,), float(t_len))
    out = acc.reshape(-1, num_catchments, n) / counts[:, None]
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
    t_len = check_inputs("GR4J", (prec, etp), packed, 6)
    if prec.device.type == "cpu":
        return gr4j_simulate_reference(prec, etp, packed, num_uh1, num_uh2)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    launch("gr4j_traj", lib.rrmpg_gr4j_simulate_f32,
           lib.rrmpg_gr4j_simulate_f64, prec.dtype, prec.device,
           prec.data_ptr(), etp.data_ptr(), packed.data_ptr(), n, t_len,
           num_uh1, num_uh2, out.data_ptr())
    return out


def state_from_rows(fstate):
    """(2 + H, N) state rows -> batched :class:`~.gr4j.GR4JState`."""
    return GR4JState(s=fstate[0], r=fstate[1],
                     pr_history=fstate[2:].T.contiguous())


def gr4j_simulate_state_fused(prec, etp, params, state=None, s_init=0.0,
                              r_init=0.0, num_uh1=NUM_UH1, num_uh2=NUM_UH2):
    """Forecast-mode fused GR4J (K4); returns (qsim (N, T), final
    :class:`~.gr4j.GR4JState`).

    The counterpart of ``run_gr4j(return_final=True)`` /
    :func:`~.gr4j.run_gr4j_warm`: chaining segments through the returned
    state reproduces the unbroken run.

    Args:
        prec, etp: (T,) forcing tensors, T >= 1.
        params: dict of (N,) tensors x1..x4 on the forcing's device.
        state: (optional) batched :class:`~.gr4j.GR4JState` to continue
            from (``pr_history`` is trimmed to the last ``num_uh2 - 1``
            inputs); a cold start from the fractions ``s_init``/``r_init``
            if omitted.
        num_uh1, num_uh2: UH register lengths, one of ``SUPPORTED_UH``.
    """
    _check_uh(num_uh1, num_uh2)
    packed = pack_params(params, s_init, r_init, state)
    t_len = check_inputs("GR4J", (prec, etp), packed, 6)
    if t_len < 1:
        raise ValueError("a state-carrying simulation needs T >= 1.")
    n = packed.shape[1]
    hist = None
    if state is not None:
        hist = history_rows(state, num_uh2, prec)
        check_block("GR4J", prec, hist, (num_uh2 - 1, n), "the history")
    if prec.device.type == "cpu":
        out, fstate = gr4j_simulate_state_reference(prec, etp, packed, hist,
                                                    num_uh1, num_uh2)
        return out, state_from_rows(fstate)
    from ._build import load_library

    lib = load_library()
    out = torch.empty((n, t_len), dtype=prec.dtype, device=prec.device)
    fstate = torch.empty((num_uh2 + 1, n), dtype=prec.dtype,
                         device=prec.device)
    launch("gr4j_traj_state", lib.rrmpg_gr4j_simulate_state_f32,
           lib.rrmpg_gr4j_simulate_state_f64, prec.dtype, prec.device,
           prec.data_ptr(), etp.data_ptr(), packed.data_ptr(),
           None if hist is None else hist.data_ptr(), n, t_len, num_uh1,
           num_uh2, out.data_ptr(), fstate.data_ptr())
    return out, state_from_rows(fstate)


def gr4j_ensemble_mse_fused(prec, etp, qobs, s_init, r_init, params,
                            num_uh1=NUM_UH1, num_uh2=NUM_UH2, stats=False,
                            masked=False, state=None, count=None):
    """Fused GR4J simulate + objective (K1, or K2 with ``stats=True``).

    Returns (N,) mean squared errors, or with ``stats=True`` a (4, N)
    tensor of time means [mse, mean_q, mean_q^2, mean_q*qobs].

    ``masked=True`` treats NaN observations as gaps: they are left out of
    the sums, which are normalized over the valid count.  An observation
    record with no valid step raises ``ValueError``.

    With ``state`` (a batched :class:`~.gr4j.GR4JState`) the objective is
    that of a warm continuation: the stores enter at the carried levels and
    the UH registers are rebuilt from the routing-input history, as in
    :func:`gr4j_simulate_state_fused`; ``s_init``/``r_init`` are not read.

    ``count`` (optional) is :func:`~._launch.valid_count` of ``qobs``, taken
    once by a caller that launches many times (a calibration's objective):
    without it a masked call reads the count back to the host.
    """
    _check_uh(num_uh1, num_uh2)
    packed = pack_params(params, s_init, r_init, state)
    t_len = check_inputs("GR4J", (prec, etp, qobs), packed, 6)
    if count is None:
        count = valid_count(qobs, masked)
    n = packed.shape[1]
    hist = None
    if state is not None:
        hist = history_rows(state, num_uh2, prec)
        check_block("GR4J", prec, hist, (num_uh2 - 1, n), "the history")
    if prec.device.type == "cpu":
        return gr4j_objective_reference(prec, etp, qobs, packed, num_uh1,
                                        num_uh2, stats, masked, count, hist)
    from ._build import load_library

    lib = load_library()
    out = torch.empty((4, n) if stats else (n,), dtype=prec.dtype,
                      device=prec.device)
    launch("gr4j_stats" if stats else "gr4j_mse",
           lib.rrmpg_gr4j_objective_f32, lib.rrmpg_gr4j_objective_f64,
           prec.dtype, prec.device, prec.data_ptr(), etp.data_ptr(),
           qobs.data_ptr(), packed.data_ptr(),
           None if hist is None else hist.data_ptr(), n, t_len, num_uh1,
           num_uh2, int(stats), int(masked), float(count), out.data_ptr())
    return out


def gr4j_regional_objective_fused(prec, etp, qobs, s_init, r_init, params,
                                  num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                  stats=False, masked=False, counts=None):
    """Fused regional GR4J objective (K5): every member over every
    catchment in one launch.

    Returns (C, N) mean squared errors, or with ``stats=True`` a
    (4, C, N) tensor of time means [mse, mean_q, mean_q^2, mean_q*qobs]
    (the layout of ``rrmpg_tpu``'s ``gr4j_regional_mse_pallas``).

    Args:
        prec, etp, qobs: (C, T) tensors, one row per catchment; records of
            unequal length are NaN-padded in ``qobs`` and run ``masked``.
        s_init, r_init: store initializations as fractions of x1 / x3.
        params: dict of (N,) tensors x1..x4, shared by every catchment.
        num_uh1, num_uh2: UH register lengths, one of ``SUPPORTED_UH``.
        masked: treat NaN observations as gaps; each catchment is
            normalized over its own valid count.  A catchment with no valid
            step raises ``ValueError`` naming it (the JAX kernel returns
            inf/NaN there).  ``None`` masks where ``qobs`` has a NaN.
        counts: (optional) the (C,) valid counts of ``qobs`` on its device,
            as :func:`~._launch.valid_counts` gives them with the bool
            ``masked`` (a split takes them once, before its shards launch);
            else they are counted here, with one read back to the host.
    """
    _check_uh(num_uh1, num_uh2)
    packed = pack_params(params, s_init, r_init)
    num_catchments, t_len = check_regional_inputs("GR4J", (prec, etp, qobs),
                                                  packed, 6)
    if counts is None:
        counts, masked = valid_counts(qobs, masked)
    if prec.device.type == "cpu":
        return gr4j_regional_objective_reference(
            prec, etp, qobs, packed, num_uh1, num_uh2, stats, masked, counts)
    from ._build import load_library

    lib = load_library()
    n = packed.shape[1]
    shape = (4, num_catchments, n) if stats else (num_catchments, n)
    out = torch.empty(shape, dtype=prec.dtype, device=prec.device)
    launch("gr4j_regional", lib.rrmpg_gr4j_regional_objective_f32,
           lib.rrmpg_gr4j_regional_objective_f64, prec.dtype, prec.device,
           prec.data_ptr(), etp.data_ptr(), qobs.data_ptr(),
           packed.data_ptr(), counts.data_ptr(), n, t_len, num_catchments,
           num_uh1, num_uh2, int(stats), int(masked), out.data_ptr())
    return out
