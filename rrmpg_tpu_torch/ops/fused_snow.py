"""Fused Cemaneige snow + GR4J ensemble kernels: wrappers and their plain
versions.

Counterpart of ``rrmpg_tpu/ops/pallas_snow.py``.  One kernel family covers
the standalone snow routine and its four GR4J compositions (plain /
hysteresis x with / without glacier ice melt).  The kernels are CUDA C++,
the objectives K8 and K11 and the trajectories K9 in
``rrmpg_tpu_torch/csrc/snow_objective.cu`` and K10 in ``snow_fused.cu``,
sharing the snow step of ``snow_step.cuh``: one thread per member, the
GR4J stores and UH registers in registers for the whole time loop.  The
per-layer snow states live in shared memory, except in K8, K9 and K11 at 1
and 5 layers, whose layer count is a compile-time constant and whose layer
states are registers; K8, K9 and K11 also stage the forcing (64 steps at a
time, K9 32) in shared memory, and K9 gathers each tile of its trajectory
there so that every member's steps leave as one contiguous run.  Any layer
count runs.

* K8 :func:`snowgr4j_ensemble_mse_fused` -- fused simulate + objective:
  (N,) mean squared errors, with ``stats=True`` the (4, N) time means
  [mse, mean_q, mean_q^2, mean_q*qobs] (NSE/KGE via
  :func:`~.stats.losses_from_stats`), with ``sca_stats=True`` those plus
  four statistics of 100*SCA against NDSI per elevation band, (4 + 4L, N),
  for the Q+SCA calibration (:func:`q_sca_loss_from_stats`);
  :func:`cemaneige_ensemble_mse_fused` is its snow-only mode;
* K9 :func:`snowgr4j_simulate_fused` -- (N, T) discharge trajectories;
  :func:`cemaneige_simulate_fused` the snow-only outflow;
* K10 :func:`snowgr4j_simulate_state_fused` -- forecast mode: trajectories
  plus the end-of-series :class:`~..models.states.SnowGR4JState`, entering
  cold or from a carried state; K8 enters from a carried state too
  (``state=``, the ``mse`` and ``stats`` objectives);
* K11 :func:`snowgr4j_regional_mse_fused` -- K8's objective over C
  catchments in one launch (a regional variant of K8's kernel, each block
  staging its own catchment's forcing): (C, T, L) layer forcing, (N,)
  members shared by every catchment, each catchment's layer constants from
  its own forcing and its own glacier fractions, (C, N) losses or (4, C, N)
  statistics (:mod:`~..parallel.regional`).

A warm entry takes its layer constants from the state: the snow-cover
threshold (or, with hysteresis, the mean annual solid precipitation) is a
precompute over the ORIGINAL series, one (L,) vector per member, and a
continuation must not recompute it from its own shorter forcing.  The state
is batched over the members; one state shared by all is broadcast by the
caller (:func:`~..models.states.broadcast_state`).

On a CUDA tensor a wrapper launches its kernel or raises; only for tensors
the caller put on the CPU it runs its plain PyTorch version
(``*_reference``), written operation for operation like the kernel: the
layer sum runs in layer order and is divided by ``float(L)``, and the
accumulation branch multiplies by the packed ``1/Thacc`` where
:mod:`.cemaneige` divides.

Every step's branches hang on exact comparisons (``th == 0``, ``g == 0``,
``balance >= 0``), so the kernel writes the snow step's products without
fused multiply-adds: its snow state is the plain version's, bit for bit,
on the same inputs.
"""

import torch

from ..utils.tracing import sync, traced
from ._launch import (check_block, check_inputs, check_regional_inputs,
                      launch, register_kernels, valid_count, valid_counts)
from .fused_gr4j import _Members as _GR4JMembers
from .fused_gr4j import (_check_uh, catchment_members, final_history,
                         history_rows, per_member, state_from_rows)
from .stats import losses_from_stats
from .uh import NUM_UH1, NUM_UH2

register_kernels("snow_mse", "snow_stats", "snow_sca_stats", "snow_traj",
                 "snow_traj_state", "snow_regional")

NUM_ROWS = 11


def _guarded_reciprocal(x):
    """1/x, and 0 where x is 0: a parameter a variant lacks is packed as a
    zero row, and the block stays finite."""
    nonzero = x != 0.0
    return torch.where(nonzero, 1.0 / torch.where(nonzero, x, 1.0), 0.0)


def pack_params(params, s_init, r_init, snow_only=False, gr4j_state=None):
    """(11, N) contiguous [x1, x2, x3, x4, s0, r0, CTG, Kf, 1/Thacc, Rsp,
    DDF] with s0/r0 absolute (the carried levels of a batched
    ``gr4j_state`` on warm entry); parameters the variant lacks are zero
    rows (``snow_only``: inert GR4J rows)."""
    ref = params['CTG']
    zeros = torch.zeros_like(ref)

    def row(key):
        return params[key] if key in params else zeros

    if snow_only:
        ones = torch.ones_like(ref)
        gr4j_rows = [ones, zeros, ones, ones, zeros, zeros]
    else:
        x1, x3 = params['x1'], params['x3']
        if gr4j_state is None:
            s0, r0 = s_init * x1, r_init * x3
        else:
            s0, r0 = (x.to(dtype=x1.dtype).expand_as(x1)
                      for x in (gr4j_state.s, gr4j_state.r))
        gr4j_rows = [x1, params['x2'], x3, params['x4'], s0, r0]
    return torch.stack(gr4j_rows + [
        ref, params['Kf'], _guarded_reciprocal(row('Thacc')), row('Rsp'),
        row('DDF')]).contiguous()


def layer_inputs(prec, frac_solid_prec, hyst):
    """(snow, rain, layer_consts): the (T, L) solid and liquid
    precipitation and the (L,) series constant of each layer, the
    snow-cover threshold (plain) or the mean annual solid precipitation
    (``hyst``).  For (C, T, L) forcing the constants are (C, L), each
    catchment's from its own series, reduced over that (T, L) series alone:
    the bits of a catchment's constants depend neither on the other
    catchments nor on their number (a mesh's catchment shards take the
    unsharded call's constants, and a catchment the single-catchment
    call's)."""
    snow = prec * frac_solid_prec
    rain = prec - snow
    if snow.dim() == 3:
        psol = 365.25 * torch.stack([s.mean(dim=0) for s in snow])
    else:
        psol = 365.25 * snow.mean(dim=0)
    return (snow.contiguous(), rain.contiguous(),
            (psol if hyst else 0.9 * psol).contiguous())


def warm_rows(state, hyst, num_layers, num_uh2, like):
    """A batched :class:`~..models.states.SnowGR4JState` as the kernels take
    it, in ``like``'s dtype: ``(state_in, layer_consts, hist)`` -- the
    (4L, N) layer rows [G | eTG | sca | swe_max] (zero rows for what a plain
    snow state lacks), the (L, N) constants of the original series and the
    (H, N) routing-input history, oldest first."""
    sg = state.snow
    if hyst:
        leaves, consts = (sg.g, sg.etg, sg.sca, sg.swe_max), sg.psol_annual
    else:
        zeros = torch.zeros_like(sg.g)
        leaves, consts = (sg.g, sg.etg, zeros, zeros), sg.g_thresh
    n = sg.g.shape[0]
    for leaf in (*leaves, consts):
        if tuple(leaf.shape) != (n, num_layers):
            raise ValueError(
                f"every snow leaf of the state must be (N, {num_layers}); "
                f"got {tuple(leaf.shape)}.")
    state_in = torch.cat([leaf.to(dtype=like.dtype).T for leaf in leaves])
    return (state_in.contiguous(),
            consts.to(dtype=like.dtype).T.contiguous(),
            history_rows(state.gr4j, num_uh2, like))


def bundle_from_rows(fstate, layer_consts, hyst, num_uh2):
    """K10's (2 + H + 4L, N) state rows and the (N, L) layer constants ->
    :class:`~..models.states.SnowGR4JState`, member axis leading."""
    from ..models.states import (CemaneigeHystState, CemaneigeState,
                                 SnowGR4JState)

    h = num_uh2 - 1
    num_layers = layer_consts.shape[1]
    G, eTG, sca, swe = (
        fstate[2 + h + k * num_layers:2 + h + (k + 1) * num_layers]
        .T.contiguous() for k in range(4))
    if hyst:
        snow = CemaneigeHystState(g=G, etg=eTG, sca=sca, swe_max=swe,
                                  psol_annual=layer_consts)
    else:
        snow = CemaneigeState(g=G, etg=eTG, g_thresh=layer_consts)
    return SnowGR4JState(snow=snow, gr4j=state_from_rows(fstate[:2 + h]))


# ---------------------------------------------------------------------------
# Plain versions: the kernel's loop, batched over members
# ---------------------------------------------------------------------------

class _Members:
    """Per-member parameters and state as the kernel keeps them: GR4J in
    :class:`~.fused_gr4j._Members`, the layer states as (N, L) blocks."""

    def __init__(self, packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 snow_only, num_uh1, num_uh2, state_in=None, hist=None):
        self.gr4j = (None if snow_only
                     else _GR4JMembers(packed[:6], num_uh1, num_uh2, hist))
        (self.ctg, self.kf, self.ithacc, self.rsp,
         self.ddf) = (row[:, None] for row in packed[6:])
        self.one_minus_ctg = 1.0 - self.ctg
        # (L,) for all members, or (L, N) rows, one column per member.
        self.layer_consts = (layer_consts if layer_consts.dim() == 1
                             else layer_consts.T)
        self.frac_ice = frac_ice
        self.warm = state_in is not None
        self.snow0, self.th0 = snow0, th0
        self.hyst, self.ice = hyst, ice
        n, L = packed.shape[1], layer_consts.shape[0]
        # A tensor, not a Python number: PyTorch divides by a Python scalar
        # as a multiply by its reciprocal, the kernel really divides.
        self.num_layers = packed.new_full((), float(L))
        if self.warm:
            self.G, self.eTG, self.sca, self.swe = (
                state_in[k * L:(k + 1) * L].T.clone() for k in range(4))
        else:
            self.G = packed.new_zeros((n, L))
            self.eTG, self.sca, self.swe = (torch.zeros_like(self.G)
                                            for _ in range(3))

    def _layers(self, t, snow, rain, temp):
        """``snow_layer_step`` of the CUDA source on all layers at once;
        returns the (N, L) liquid water.  Step 0 of a cold start is the
        initialization step."""
        if t == 0 and not self.warm:
            g = torch.full_like(self.G, self.snow0)
            th = torch.full_like(self.G, self.th0)
        else:
            g = self.G + snow
            th = self.ctg * self.eTG + self.one_minus_ctg * temp
        th = torch.clamp(th, max=0.0)
        melting = (th == 0.0) & (temp > 0.0)
        pot_melt = torch.where(melting, torch.minimum(self.kf * temp, g),
                               0.0)
        if self.hyst:
            th_melt = self.layer_consts * self.rsp
            balance = snow - pot_melt
            accumulating = balance >= 0.0
            sca_acc = self.sca + balance * self.ithacc
            th_max = torch.minimum(self.swe, th_melt)
            positive = th_max > 0.0
            sca_abl = torch.where(
                positive, g / torch.where(positive, th_max, 1.0), 0.0)
            sca = torch.clamp(torch.where(accumulating, sca_acc, sca_abl),
                              0.0, 1.0)
            swe = torch.where(accumulating, torch.maximum(self.swe, g),
                              self.swe)
            melt = torch.minimum((0.9 * sca + 0.1) * pot_melt, g)
            g = g - melt
            self.sca, self.swe = sca, torch.where(g == 0.0, 0.0, swe)
        else:
            consts = self.layer_consts
            safe = torch.where(consts > 0.0, consts, 1.0)
            ratio = torch.where(g < consts, g / safe, 1.0)
            melt = (0.9 * ratio + 0.1) * pot_melt
            g = g - melt
        self.G, self.eTG = g, th
        return rain + melt

    @staticmethod
    def _layer_sum(x):
        """Sum over the layer axis in layer order, as the kernel's loop."""
        total = x[:, 0]
        for l in range(1, x.shape[1]):
            total = total + x[:, l]
        return total

    def step(self, t, snow, rain, temp, etp):
        """One step of all layers and of GR4J; returns q of shape (N,)."""
        liquid = self._layers(t, snow, rain, temp)
        p = self._layer_sum(liquid) / self.num_layers
        if self.ice:
            melt = torch.clamp(self.ddf * temp, min=0.0)
            p = p + self._layer_sum(
                torch.where(self.G > 1.0, 0.0, melt) * self.frac_ice)
        return p if self.gr4j is None else self.gr4j.step(p, etp)


def snowgr4j_simulate_reference(snow, rain, temp, etp, packed, layer_consts,
                                frac_ice, snow0, th0, hyst=False, ice=False,
                                snow_only=False, num_uh1=NUM_UH1,
                                num_uh2=NUM_UH2):
    """Plain version of K9: (N, T) trajectories."""
    m = _Members(packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 snow_only, num_uh1, num_uh2)
    out = snow.new_empty((packed.shape[1], snow.shape[0]))
    for t in range(snow.shape[0]):
        out[:, t] = m.step(t, snow[t], rain[t], temp[t], etp[t])
    return out


def snowgr4j_simulate_state_reference(snow, rain, temp, etp, packed,
                                      layer_consts, frac_ice, snow0, th0,
                                      hyst=False, ice=False, num_uh1=NUM_UH1,
                                      num_uh2=NUM_UH2, state_in=None,
                                      hist=None):
    """Plain version of K10: (N, T) trajectories and the (2 + H + 4L, N)
    state rows [s, r, history, G, eTG, sca, swe_max] (the last 2L zero
    without ``hyst``).  ``state_in`` ((4L, N)) and ``hist`` ((H, N)) give a
    warm entry; ``layer_consts`` is then (L, N)."""
    m = _Members(packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 False, num_uh1, num_uh2, state_in, hist)
    n = packed.shape[1]
    if hist is None:
        hist = packed.new_zeros((num_uh2 - 1, n))
    out = snow.new_empty((n, snow.shape[0]))
    p_r_steps = []
    for t in range(snow.shape[0]):
        out[:, t] = m.step(t, snow[t], rain[t], temp[t], etp[t])
        p_r_steps.append(m.gr4j.p_r)
    layer_rows = [m.G.T, m.eTG.T]
    layer_rows += ([m.sca.T, m.swe.T] if hyst
                   else [torch.zeros_like(m.G.T)] * 2)
    fstate = torch.cat([m.gr4j.s[None], m.gr4j.r[None],
                        final_history(hist, p_r_steps), *layer_rows])
    return out, fstate


def snowgr4j_objective_reference(snow, rain, temp, etp, qobs, packed,
                                 layer_consts, frac_ice, snow0, th0,
                                 hyst=False, ice=False, snow_only=False,
                                 num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                 stats=False, masked=False, count=None,
                                 ndsi=None, band_counts=None, state_in=None,
                                 hist=None):
    """Plain version of K8: (N,) mean squared errors, with ``stats`` the
    (4, N) time means, with ``ndsi`` ((T, L); needs ``hyst``) the
    (4 + 4L, N) discharge and per-band SCA statistics.  ``masked`` drops
    NaN observations, discharge and each band by their own gaps; the
    discharge sums are divided by ``count`` (default T), band l's by
    ``band_counts[l]``.  ``state_in`` and ``hist`` give a warm entry, as in
    :func:`snowgr4j_simulate_state_reference`."""
    m = _Members(packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 snow_only, num_uh1, num_uh2, state_in, hist)
    T, L = snow.shape
    n = packed.shape[1]
    acc = packed.new_zeros((4, n))
    band_acc = packed.new_zeros((L, 4, n))
    valid = torch.isfinite(qobs) if masked else None
    for t in range(T):
        q = m.step(t, snow[t], rain[t], temp[t], etp[t])
        qo = qobs[t]
        diff = q - qo
        terms = torch.stack([diff * diff, q, q * q, q * qo])
        if masked:
            terms = torch.where(valid[t], terms, 0.0)
        acc += terms
        if ndsi is None:
            continue
        s100 = (100.0 * m.sca).T                       # (L, N)
        nd = ndsi[t][:, None]                          # (L, 1)
        d = s100 - nd
        terms = torch.stack([d * d, s100, s100 * s100, s100 * nd], dim=1)
        if masked:
            terms = torch.where(torch.isnan(nd)[:, None], 0.0, terms)
        band_acc += terms
    out = acc / (T if count is None else count)
    if ndsi is not None:
        bands = band_acc / band_counts[:, None, None]
        return torch.cat([out, bands.reshape(4 * L, n)])
    return out if stats else out[0]


def snowgr4j_regional_objective_reference(snow, rain, temp, etp, qobs, packed,
                                          layer_consts, frac_ice, snow0, th0,
                                          hyst=False, ice=False,
                                          num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                          stats=False, masked=False,
                                          counts=None):
    """Plain version of K11: (C, N) mean squared errors, with ``stats`` the
    (4, C, N) time means.  ``snow``, ``rain``, ``temp`` are (C, T, L),
    ``etp`` and ``qobs`` (C, T), ``layer_consts`` and ``frac_ice`` (C, L);
    every catchment runs the same (11, N) ``packed`` members, all
    catchments in one time loop over C * N members.  ``masked`` drops NaN
    observations; catchment c's sums are divided by ``counts[c]`` (a (C,)
    tensor, default T)."""
    num_catchments, t_len, _ = snow.shape
    n = packed.shape[1]
    m = _Members(catchment_members(packed, num_catchments),
                 per_member(layer_consts, n).T, per_member(frac_ice, n),
                 snow0, th0, hyst, ice, False, num_uh1, num_uh2)
    acc = packed.new_zeros((4, num_catchments * n))
    valid = torch.isfinite(qobs) if masked else None
    for t in range(t_len):
        q = m.step(t, per_member(snow[:, t], n), per_member(rain[:, t], n),
                   per_member(temp[:, t], n), per_member(etp[:, t], n))
        qo = per_member(qobs[:, t], n)
        diff = q - qo
        terms = torch.stack([diff * diff, q, q * q, q * qo])
        if masked:
            terms = torch.where(per_member(valid[:, t], n), terms, 0.0)
        acc += terms
    if counts is None:
        counts = etp.new_full((num_catchments,), float(t_len))
    out = acc.reshape(4, num_catchments, n) / counts[:, None]
    return out if stats else out[0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _prepare(prec, mean_temp, etp, frac_solid_prec, params, s_init, r_init,
             frac_ice, hyst, ice, snow_only, num_uh1, num_uh2, extra=(),
             state=None):
    """Checks and packing shared by the wrappers; returns
    (snow, rain, temp, layer_consts, frac_ice, packed, T, L, state_in,
    hist).  With a batched ``state`` the layer constants are the state's
    (L, N) rows and ``state_in`` / ``hist`` its warm-entry rows; else both
    are None and the constants the (L,) vector of this call's forcing."""
    if snow_only and (hyst or ice):
        raise ValueError(
            "snow_only is the standalone Cemaneige routine: it has no "
            "hysteresis or ice-melt variant.")
    if not snow_only:
        _check_uh(num_uh1, num_uh2)
    if ice and frac_ice is None:
        raise ValueError("The ice-melt variants need 'frac_ice'.")
    if state is not None and snow_only:
        raise ValueError(
            "The fused snow-only kernels start cold; carry a Cemaneige "
            "state on engine='scan'.")
    packed = pack_params(params, s_init, r_init, snow_only,
                         None if state is None else state.gr4j)
    t_len = check_inputs("snow", (etp, *extra), packed, NUM_ROWS)
    layers = (prec, mean_temp, frac_solid_prec)
    if prec.dim() != 2 or prec.shape[0] != t_len or prec.shape[1] < 1:
        raise ValueError(
            f"layer forcing must be (T, L) with T={t_len} and L >= 1, got "
            f"{tuple(prec.shape)}.")
    num_layers = prec.shape[1]
    if frac_ice is None:
        frac_ice = prec.new_zeros(num_layers)
    for x in (*layers, frac_ice):
        if x.device != etp.device or x.dtype != etp.dtype:
            raise ValueError(
                "every input of a fused snow kernel must share one device "
                f"and dtype; got {x.device}/{x.dtype} and "
                f"{etp.device}/{etp.dtype}.")
    if any(x.shape != prec.shape for x in layers):
        raise ValueError(
            "prec, mean_temp and frac_solid_prec must share one (T, L) "
            f"shape, got {[tuple(x.shape) for x in layers]}.")
    if frac_ice.shape != (num_layers,):
        raise ValueError(
            f"frac_ice must be ({num_layers},), one fraction per layer; "
            f"got {tuple(frac_ice.shape)}.")
    snow, rain, layer_consts = layer_inputs(prec, frac_solid_prec, hyst)
    state_in = hist = None
    if state is not None:
        n = packed.shape[1]
        state_in, layer_consts, hist = warm_rows(state, hyst, num_layers,
                                                 num_uh2, etp)
        check_block("snow", etp, state_in, (4 * num_layers, n),
                    "the layer state")
        check_block("snow", etp, layer_consts, (num_layers, n),
                    "the layer constants")
        check_block("snow", etp, hist, (num_uh2 - 1, n), "the history")
    return (snow, rain, mean_temp.contiguous(), layer_consts,
            frac_ice.contiguous(), packed, t_len, num_layers, state_in, hist)


def _check_layer_count(lib, num_layers, rows_per_layer, dtype):
    """Raise if the layer states of one block do not fit its shared
    memory (the kernels keep them there at any count but 1 and 5 in the
    objectives, K8 and K11)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    most = lib.rrmpg_snow_max_layers(rows_per_layer, itemsize)
    if num_layers > most:
        raise ValueError(
            f"The fused snow kernels take at most {most} elevation layers "
            f"in this mode and dtype ({rows_per_layer} shared values per "
            f"layer and member); got {num_layers}. Use engine='scan'.")


@traced("ops.snowgr4j_simulate_fused")
def snowgr4j_simulate_fused(prec, mean_temp, etp, frac_solid_prec,
                            snow_pack_init, thermal_state_init, s_init,
                            r_init, params, frac_ice=None, hyst=False,
                            ice=False, snow_only=False, num_uh1=NUM_UH1,
                            num_uh2=NUM_UH2):
    """Fused coupled-model ensemble simulation (K9); returns qsim (N, T).

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing tensors.
        etp: (T,) potential evapotranspiration.
        snow_pack_init, thermal_state_init, s_init, r_init: scalars
            (reference init conventions).
        params: dict of (N,) tensors -- CTG, Kf, x1..x4 and, per variant,
            Thacc/Rsp (``hyst``) and DDF (``ice``).
        frac_ice: (L,) glacier fractions (``ice``).
        hyst, ice, snow_only: the variant.
        num_uh1, num_uh2: UH register lengths, one of
            :data:`~.fused_gr4j.SUPPORTED_UH`.
    """
    (snow, rain, temp, layer_consts, frac_ice, packed, t_len, num_layers, _,
     _) = _prepare(prec, mean_temp, etp, frac_solid_prec, params, s_init,
                   r_init, frac_ice, hyst, ice, snow_only, num_uh1, num_uh2)
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
    if etp.device.type == "cpu":
        return snowgr4j_simulate_reference(
            snow, rain, temp, etp, packed, layer_consts, frac_ice, snow0,
            th0, hyst, ice, snow_only, num_uh1, num_uh2)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers, _shared_rows(hyst), etp.dtype)
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=etp.dtype, device=etp.device)
    launch("snow_traj", lib.rrmpg_snow_simulate_f32,
           lib.rrmpg_snow_simulate_f64, etp.dtype, etp.device,
           snow.data_ptr(), rain.data_ptr(), temp.data_ptr(), etp.data_ptr(),
           packed.data_ptr(), layer_consts.data_ptr(), frac_ice.data_ptr(),
           n, t_len, num_layers, num_uh1, num_uh2, int(hyst), int(ice),
           int(snow_only), snow0, th0, out.data_ptr())
    return out


def _shared_rows(hyst, sca_stats=False):
    """Shared-memory values per layer and member: the layer states (2, with
    hysteresis 4), the layer constant and, with the SCA statistics, four
    band sums."""
    return (4 if hyst else 2) + 1 + (4 if sca_stats else 0)


def _pointer(x):
    return None if x is None else x.data_ptr()


@traced("ops.snowgr4j_simulate_state_fused")
def snowgr4j_simulate_state_fused(prec, mean_temp, etp, frac_solid_prec,
                                  params, state=None, snow_pack_init=0.0,
                                  thermal_state_init=0.0, s_init=0.0,
                                  r_init=0.0, frac_ice=None, hyst=False,
                                  ice=False, num_uh1=NUM_UH1,
                                  num_uh2=NUM_UH2):
    """Forecast-mode fused snow + GR4J simulation (K10); returns
    (qsim (N, T), final :class:`~..models.states.SnowGR4JState`).

    The counterpart of the warm / cold-final compositions of
    :mod:`.compositions`: chaining segments through the returned state
    reproduces the unbroken run.  The series-derived layer constants travel
    with the state: a warm segment uses the ORIGINAL series' snow-cover
    threshold / annual solid precipitation from the bundle, and returns it
    unchanged.

    Args:
        state: (optional) batched
            :class:`~..models.states.SnowGR4JState` to continue from
            (its snow half a ``CemaneigeHystState`` with ``hyst``, else a
            ``CemaneigeState``; ``pr_history`` is trimmed to the last
            ``num_uh2 - 1`` inputs); a cold start from the init scalars
            (reference conventions) if omitted.

    Other args as :func:`snowgr4j_simulate_fused`; T >= 1.
    """
    (snow, rain, temp, layer_consts, frac_ice, packed, t_len, num_layers,
     state_in, hist) = _prepare(prec, mean_temp, etp, frac_solid_prec,
                                params, s_init, r_init, frac_ice, hyst, ice,
                                False, num_uh1, num_uh2, state=state)
    if t_len < 1:
        raise ValueError("a state-carrying simulation needs T >= 1.")
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
    n = packed.shape[1]
    # The constants of the final bundle, (N, L): carried ones pass through.
    consts_nl = (layer_consts.expand(n, num_layers).contiguous()
                 if state is None else layer_consts.T.contiguous())
    if etp.device.type == "cpu":
        out, fstate = snowgr4j_simulate_state_reference(
            snow, rain, temp, etp, packed, layer_consts, frac_ice, snow0,
            th0, hyst, ice, num_uh1, num_uh2, state_in, hist)
        return out, bundle_from_rows(fstate, consts_nl, hyst, num_uh2)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers, _shared_rows(hyst), etp.dtype)
    out = torch.empty((n, t_len), dtype=etp.dtype, device=etp.device)
    fstate = torch.empty((num_uh2 + 1 + 4 * num_layers, n), dtype=etp.dtype,
                         device=etp.device)
    launch("snow_traj_state", lib.rrmpg_snow_simulate_state_f32,
           lib.rrmpg_snow_simulate_state_f64, etp.dtype, etp.device,
           snow.data_ptr(), rain.data_ptr(), temp.data_ptr(), etp.data_ptr(),
           packed.data_ptr(), layer_consts.data_ptr(), frac_ice.data_ptr(),
           _pointer(state_in), _pointer(hist), n, t_len, num_layers, num_uh1,
           num_uh2, int(hyst), int(ice), int(state is not None), snow0, th0,
           out.data_ptr(), fstate.data_ptr())
    return out, bundle_from_rows(fstate, consts_nl, hyst, num_uh2)


def _band_counts(ndsi, masked):
    """(L,) steps each band's statistics average over; raises if a band
    has none."""
    num_layers, t_len = ndsi.shape
    if not masked:
        return ndsi.new_full((num_layers,), float(t_len))
    counts = torch.isfinite(ndsi).sum(dim=1)
    if sync("ops.band_counts", bool, (counts == 0).any()):
        raise ValueError(
            "an NDSI band has no finite value: masked statistics over zero "
            "valid steps are undefined.")
    return counts.to(ndsi.dtype)


@traced("ops.snowgr4j_ensemble_mse_fused")
def snowgr4j_ensemble_mse_fused(prec, mean_temp, etp, frac_solid_prec, qobs,
                                snow_pack_init, thermal_state_init, s_init,
                                r_init, params, frac_ice=None, ndsi=None,
                                hyst=False, ice=False, stats=False,
                                sca_stats=False, snow_only=False,
                                num_uh1=NUM_UH1, num_uh2=NUM_UH2, state=None,
                                masked=False, count=None):
    """Fused coupled-model simulate + objective (K8).

    Returns (N,) mean squared errors; with ``stats=True`` a (4, N) tensor
    of time means [mse, mean_q, mean_q^2, mean_q*qobs]; with
    ``sca_stats=True`` (needs ``hyst=True`` and ``ndsi`` of shape (L, T))
    a (4 + 4L, N) tensor, the discharge statistics followed per band by
    the means of [(100 sca - ndsi)^2, 100 sca, (100 sca)^2,
    100 sca * ndsi].

    ``masked=True`` treats NaN observations as gaps, each series by its own
    (discharge and every NDSI band), and normalizes each over its own valid
    count.  A record or a band with no valid step raises ``ValueError``.

    With ``state`` (a batched :class:`~..models.states.SnowGR4JState`) the
    objective is that of a warm continuation, as in
    :func:`snowgr4j_simulate_state_fused`: the snowpack and GR4J state enter
    from the bundle, the layer constants are the bundle's, and the init
    scalars are not read.  ``mse`` and ``stats`` only.

    ``count`` (optional) is :func:`~._launch.valid_count` of ``qobs``, taken
    once by a caller that launches many times.

    Other args as :func:`snowgr4j_simulate_fused`.
    """
    if state is not None and sca_stats:
        raise ValueError(
            "Warm (state=) evaluation supports the mse/stats objectives; "
            "Q+SCA calibration from a carried state runs on engine='scan'.")
    if sca_stats and not hyst:
        raise ValueError("sca_stats requires the hysteresis variant.")
    if sca_stats and (snow_only or ndsi is None):
        raise ValueError(
            "sca_stats needs 'ndsi' of shape (L, T) and a GR4J composition.")
    (snow, rain, temp, layer_consts, frac_ice, packed, t_len, num_layers,
     state_in, hist) = _prepare(prec, mean_temp, etp, frac_solid_prec,
                                params, s_init, r_init, frac_ice, hyst, ice,
                                snow_only, num_uh1, num_uh2, extra=(qobs,),
                                state=state)
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
    if count is None:
        count = valid_count(qobs, masked)
    ndsi_t = band_counts = None
    if sca_stats:
        if (ndsi.shape != (num_layers, t_len) or ndsi.dtype != etp.dtype
                or ndsi.device != etp.device):
            raise ValueError(
                f"ndsi must be ({num_layers}, {t_len}) on the forcing's "
                f"device and dtype, got {tuple(ndsi.shape)} "
                f"{ndsi.device}/{ndsi.dtype}.")
        band_counts = _band_counts(ndsi, masked)
        ndsi_t = ndsi.T.contiguous()                   # (T, L), as the forcing
    if etp.device.type == "cpu":
        return snowgr4j_objective_reference(
            snow, rain, temp, etp, qobs, packed, layer_consts, frac_ice,
            snow0, th0, hyst, ice, snow_only, num_uh1, num_uh2, stats, masked,
            count, ndsi_t, band_counts, state_in, hist)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers, _shared_rows(hyst, sca_stats),
                       etp.dtype)
    n = packed.shape[1]
    if sca_stats:
        kernel, shape = "snow_sca_stats", (4 + 4 * num_layers, n)
    elif stats:
        kernel, shape = "snow_stats", (4, n)
    else:
        kernel, shape = "snow_mse", (n,)
    out = torch.empty(shape, dtype=etp.dtype, device=etp.device)
    launch(kernel, lib.rrmpg_snow_objective_f32, lib.rrmpg_snow_objective_f64,
           etp.dtype, etp.device, snow.data_ptr(), rain.data_ptr(),
           temp.data_ptr(), etp.data_ptr(), qobs.data_ptr(),
           _pointer(ndsi_t), packed.data_ptr(), layer_consts.data_ptr(),
           frac_ice.data_ptr(), _pointer(band_counts), _pointer(state_in),
           _pointer(hist), n, t_len, num_layers, num_uh1, num_uh2, int(hyst),
           int(ice), int(snow_only), int(stats), int(sca_stats), int(masked),
           int(state is not None), snow0, th0, float(count), out.data_ptr())
    return out


@traced("ops.snowgr4j_regional_mse_fused")
def snowgr4j_regional_mse_fused(prec, mean_temp, etp, frac_solid_prec, qobs,
                                snow_pack_init, thermal_state_init, s_init,
                                r_init, params, frac_ice=None, hyst=False,
                                ice=False, stats=False, num_uh1=NUM_UH1,
                                num_uh2=NUM_UH2, masked=False, counts=None):
    """Fused regional coupled-model objective (K11): every member over
    every catchment in one launch.

    Returns (C, N) mean squared errors, or with ``stats=True`` a (4, C, N)
    tensor of time means [mse, mean_q, mean_q^2, mean_q*qobs] (the layout
    of ``rrmpg_tpu``'s ``snowgr4j_regional_mse_pallas``).

    Args:
        prec, mean_temp, frac_solid_prec: (C, T, L) layer forcing; each
            catchment's snow-cover threshold / mean annual solid
            precipitation comes from its own series.
        etp, qobs: (C, T) tensors.
        snow_pack_init, thermal_state_init, s_init, r_init: scalars
            (reference init conventions), shared by every catchment.
        params: dict of (N,) tensors (as :func:`snowgr4j_simulate_fused`),
            shared by every catchment.
        frac_ice: (L,) glacier fractions shared by every catchment, or
            (C, L), one row per catchment (``ice``).
        hyst, ice: the variant.
        masked: treat NaN observations as gaps; each catchment is
            normalized over its own valid count, and one with no valid step
            raises ``ValueError`` naming it.  ``None`` masks where ``qobs``
            has a NaN.
        counts: (optional) the (C,) valid counts with the bool ``masked``,
            as in :func:`~.fused_gr4j.gr4j_regional_objective_fused`.
    """
    _check_uh(num_uh1, num_uh2)
    if ice and frac_ice is None:
        raise ValueError("The ice-melt variants need 'frac_ice'.")
    packed = pack_params(params, s_init, r_init)
    num_catchments, t_len = check_regional_inputs("snow", (etp, qobs), packed,
                                                  NUM_ROWS)
    layers = (prec, mean_temp, frac_solid_prec)
    if (prec.dim() != 3 or tuple(prec.shape[:2]) != (num_catchments, t_len)
            or prec.shape[2] < 1
            or any(x.shape != prec.shape for x in layers)):
        raise ValueError(
            f"regional layer forcing must be (C, T, L) with C={num_catchments},"
            f" T={t_len} and L >= 1, one shape for prec, mean_temp and "
            f"frac_solid_prec; got {[tuple(x.shape) for x in layers]}.")
    num_layers = prec.shape[2]
    if frac_ice is None:
        frac_ice = prec.new_zeros(num_layers)
    for x in (*layers, frac_ice):
        if x.device != etp.device or x.dtype != etp.dtype:
            raise ValueError(
                "every input of a fused snow kernel must share one device "
                f"and dtype; got {x.device}/{x.dtype} and "
                f"{etp.device}/{etp.dtype}.")
    if tuple(frac_ice.shape) not in ((num_layers,),
                                     (num_catchments, num_layers)):
        raise ValueError(
            f"frac_ice must be ({num_layers},) or ({num_catchments}, "
            f"{num_layers}); got {tuple(frac_ice.shape)}.")
    frac_ice = frac_ice.expand(num_catchments, num_layers).contiguous()
    if counts is None:
        counts, masked = valid_counts(qobs, masked)
    snow, rain, layer_consts = layer_inputs(prec, frac_solid_prec, hyst)
    temp = mean_temp.contiguous()
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
    if etp.device.type == "cpu":
        return snowgr4j_regional_objective_reference(
            snow, rain, temp, etp, qobs, packed, layer_consts, frac_ice,
            snow0, th0, hyst, ice, num_uh1, num_uh2, stats, masked, counts)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers, _shared_rows(hyst), etp.dtype)
    n = packed.shape[1]
    shape = (4, num_catchments, n) if stats else (num_catchments, n)
    out = torch.empty(shape, dtype=etp.dtype, device=etp.device)
    launch("snow_regional", lib.rrmpg_snow_regional_objective_f32,
           lib.rrmpg_snow_regional_objective_f64, etp.dtype, etp.device,
           snow.data_ptr(), rain.data_ptr(), temp.data_ptr(), etp.data_ptr(),
           qobs.data_ptr(), packed.data_ptr(), layer_consts.data_ptr(),
           frac_ice.data_ptr(), counts.data_ptr(), n, t_len, num_layers,
           num_catchments, num_uh1, num_uh2, int(hyst), int(ice), int(stats),
           int(masked), snow0, th0, out.data_ptr())
    return out


@traced("ops.cemaneige_simulate_fused")
def cemaneige_simulate_fused(prec, mean_temp, frac_solid_prec,
                             snow_pack_init, thermal_state_init, params):
    """Fused standalone-Cemaneige ensemble simulation; returns (N, T).

    Snow-only mode of K9: the catchment outflow (layer-mean rain + melt,
    ``rrmpg/models/cemaneige_model.py:121-125``) is written per member.
    """
    etp = prec.new_zeros(prec.shape[0])               # unused in snow_only
    return snowgr4j_simulate_fused(
        prec, mean_temp, etp, frac_solid_prec, snow_pack_init,
        thermal_state_init, 0.0, 0.0, params, snow_only=True)


@traced("ops.cemaneige_ensemble_mse_fused")
def cemaneige_ensemble_mse_fused(prec, mean_temp, frac_solid_prec, qobs,
                                 snow_pack_init, thermal_state_init, params,
                                 stats=False, masked=False, count=None):
    """Fused standalone-Cemaneige objective, the snow-only mode of K8;
    returns (N,) losses ((4, N) sufficient statistics with ``stats=True``).
    ``masked`` excludes NaN observations; ``count`` as in
    :func:`snowgr4j_ensemble_mse_fused`."""
    etp = prec.new_zeros(prec.shape[0])
    return snowgr4j_ensemble_mse_fused(
        prec, mean_temp, etp, frac_solid_prec, qobs, snow_pack_init,
        thermal_state_init, 0.0, 0.0, params, snow_only=True, stats=stats,
        masked=masked, count=count)


# ---------------------------------------------------------------------------
# Q+SCA objectives from the statistics
# ---------------------------------------------------------------------------

def q_sca_components_from_stats(stats, qobs, ndsi, loss_metric="mse"):
    """Separate (L_q, L_sca) components from K8's ``sca_stats`` output,
    each (N,).  ``L_sca`` is the sum over the elevation bands of
    ``L(NDSI_b, 100 sca_b)``; 'kge' minimizes ``1 - KGE`` per term.

    Args:
        stats: (4 + 4L, N) tensor from
            ``snowgr4j_ensemble_mse_fused(..., sca_stats=True)``.
        qobs: (T,) observed discharge.
        ndsi: (L, T) observed NDSI bands.
    """
    num_layers = (stats.shape[0] - 4) // 4
    q_losses = losses_from_stats(stats[:4], qobs)
    if loss_metric == "mse":
        loss_sca = sum(stats[4 + 4 * l] for l in range(num_layers))
        return q_losses['mse'], loss_sca
    if loss_metric == "kge":
        loss_sca = sum(
            1.0 - losses_from_stats(stats[4 + 4 * l:8 + 4 * l],
                                    ndsi[l])['kge']
            for l in range(num_layers))
        return 1.0 - q_losses['kge'], loss_sca
    raise ValueError(
        f"Unsupported loss_metric {loss_metric!r}; supported: 'mse', 'kge'.")


def q_sca_loss_from_stats(stats, qobs, ndsi, loss_metric="mse"):
    """Multi-objective Q+SCA loss from K8's ``sca_stats`` output, (N,): the
    reference weighting, 0.75 on discharge and 0.05 per elevation band
    (``rrmpg/models/cemaneigehystgr4j.py:663-689``)."""
    loss_q, loss_sca = q_sca_components_from_stats(stats, qobs, ndsi,
                                                   loss_metric)
    return 0.75 * loss_q + 0.05 * loss_sca
