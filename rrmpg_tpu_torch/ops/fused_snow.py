"""Fused Cemaneige snow + GR4J ensemble kernels: wrappers and their plain
versions.

Counterpart of ``rrmpg_tpu/ops/pallas_snow.py``.  One kernel family covers
the standalone snow routine and its four GR4J compositions (plain /
hysteresis x with / without glacier ice melt).  The kernels are CUDA C++ in
``rrmpg_tpu_torch/csrc/snow_fused.cu``: one thread per member, the GR4J
stores and UH registers in registers, the per-layer snow states in shared
memory, for the whole time loop.

* K8 :func:`snowgr4j_ensemble_mse_fused` -- fused simulate + objective:
  (N,) mean squared errors, with ``stats=True`` the (4, N) time means
  [mse, mean_q, mean_q^2, mean_q*qobs] (NSE/KGE via
  :func:`~.stats.losses_from_stats`), with ``sca_stats=True`` those plus
  four statistics of 100*SCA against NDSI per elevation band, (4 + 4L, N),
  for the Q+SCA calibration (:func:`q_sca_loss_from_stats`);
  :func:`cemaneige_ensemble_mse_fused` is its snow-only mode;
* K9 :func:`snowgr4j_simulate_fused` -- (N, T) discharge trajectories;
  :func:`cemaneige_simulate_fused` the snow-only outflow.

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

from ._launch import check_inputs, launch, register_kernels, valid_count
from .fused_gr4j import _Members as _GR4JMembers
from .fused_gr4j import _check_uh
from .stats import losses_from_stats
from .uh import NUM_UH1, NUM_UH2

register_kernels("snow_mse", "snow_stats", "snow_sca_stats", "snow_traj")

NUM_ROWS = 11


def _guarded_reciprocal(x):
    """1/x, and 0 where x is 0: a parameter a variant lacks is packed as a
    zero row, and the block stays finite."""
    nonzero = x != 0.0
    return torch.where(nonzero, 1.0 / torch.where(nonzero, x, 1.0), 0.0)


def pack_params(params, s_init, r_init, snow_only=False):
    """(11, N) contiguous [x1, x2, x3, x4, s0, r0, CTG, Kf, 1/Thacc, Rsp,
    DDF] with s0/r0 absolute; parameters the variant lacks are zero rows
    (``snow_only``: inert GR4J rows)."""
    ref = params['CTG']
    zeros = torch.zeros_like(ref)

    def row(key):
        return params[key] if key in params else zeros

    if snow_only:
        ones = torch.ones_like(ref)
        gr4j_rows = [ones, zeros, ones, ones, zeros, zeros]
    else:
        x1, x3 = params['x1'], params['x3']
        gr4j_rows = [x1, params['x2'], x3, params['x4'], s_init * x1,
                     r_init * x3]
    return torch.stack(gr4j_rows + [
        ref, params['Kf'], _guarded_reciprocal(row('Thacc')), row('Rsp'),
        row('DDF')]).contiguous()


def layer_inputs(prec, frac_solid_prec, hyst):
    """(snow, rain, layer_consts): the (T, L) solid and liquid
    precipitation and the (L,) series constant of each layer, the
    snow-cover threshold (plain) or the mean annual solid precipitation
    (``hyst``)."""
    snow = prec * frac_solid_prec
    rain = prec - snow
    psol = 365.25 * snow.mean(dim=0)
    return (snow.contiguous(), rain.contiguous(),
            (psol if hyst else 0.9 * psol).contiguous())


# ---------------------------------------------------------------------------
# Plain versions: the kernel's loop, batched over members
# ---------------------------------------------------------------------------

class _Members:
    """Per-member parameters and state as the kernel keeps them: GR4J in
    :class:`~.fused_gr4j._Members`, the layer states as (N, L) blocks."""

    def __init__(self, packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 snow_only, num_uh1, num_uh2):
        self.gr4j = (None if snow_only
                     else _GR4JMembers(packed[:6], num_uh1, num_uh2))
        (self.ctg, self.kf, self.ithacc, self.rsp,
         self.ddf) = (row[:, None] for row in packed[6:])
        self.one_minus_ctg = 1.0 - self.ctg
        self.layer_consts, self.frac_ice = layer_consts, frac_ice
        self.snow0, self.th0 = snow0, th0
        self.hyst, self.ice = hyst, ice
        n, L = packed.shape[1], layer_consts.shape[0]
        # A tensor, not a Python number: PyTorch divides by a Python scalar
        # as a multiply by its reciprocal, the kernel really divides.
        self.num_layers = packed.new_full((), float(L))
        self.G = packed.new_zeros((n, L))
        self.eTG, self.sca, self.swe = (torch.zeros_like(self.G)
                                        for _ in range(3))

    def _layers(self, t, snow, rain, temp):
        """``snow_layer_step`` of the CUDA source on all layers at once;
        returns the (N, L) liquid water."""
        if t == 0:
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


def snowgr4j_objective_reference(snow, rain, temp, etp, qobs, packed,
                                 layer_consts, frac_ice, snow0, th0,
                                 hyst=False, ice=False, snow_only=False,
                                 num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                 stats=False, masked=False, count=None,
                                 ndsi=None, band_counts=None):
    """Plain version of K8: (N,) mean squared errors, with ``stats`` the
    (4, N) time means, with ``ndsi`` ((T, L); needs ``hyst``) the
    (4 + 4L, N) discharge and per-band SCA statistics.  ``masked`` drops
    NaN observations, discharge and each band by their own gaps; the
    discharge sums are divided by ``count`` (default T), band l's by
    ``band_counts[l]``."""
    m = _Members(packed, layer_consts, frac_ice, snow0, th0, hyst, ice,
                 snow_only, num_uh1, num_uh2)
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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _prepare(prec, mean_temp, etp, frac_solid_prec, params, s_init, r_init,
             frac_ice, hyst, ice, snow_only, num_uh1, num_uh2, extra=()):
    """Checks and packing shared by the wrappers; returns
    (snow, rain, temp, layer_consts, frac_ice, packed, T, L)."""
    if snow_only and (hyst or ice):
        raise ValueError(
            "snow_only is the standalone Cemaneige routine: it has no "
            "hysteresis or ice-melt variant.")
    if not snow_only:
        _check_uh(num_uh1, num_uh2)
    if ice and frac_ice is None:
        raise ValueError("The ice-melt variants need 'frac_ice'.")
    packed = pack_params(params, s_init, r_init, snow_only)
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
    return (snow, rain, mean_temp.contiguous(), layer_consts,
            frac_ice.contiguous(), packed, t_len, num_layers)


def _check_layer_count(lib, num_layers, rows_per_layer, dtype):
    """Raise if the layer states of one block do not fit its shared
    memory."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    most = lib.rrmpg_snow_max_layers(rows_per_layer, itemsize)
    if num_layers > most:
        raise ValueError(
            f"The fused snow kernels take at most {most} elevation layers "
            f"in this mode and dtype ({rows_per_layer} shared values per "
            f"layer and member); got {num_layers}. Use engine='scan'.")


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
    (snow, rain, temp, layer_consts, frac_ice, packed, t_len,
     num_layers) = _prepare(prec, mean_temp, etp, frac_solid_prec, params,
                            s_init, r_init, frac_ice, hyst, ice, snow_only,
                            num_uh1, num_uh2)
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
    if etp.device.type == "cpu":
        return snowgr4j_simulate_reference(
            snow, rain, temp, etp, packed, layer_consts, frac_ice, snow0,
            th0, hyst, ice, snow_only, num_uh1, num_uh2)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers, 4 if hyst else 2, etp.dtype)
    n = packed.shape[1]
    out = torch.empty((n, t_len), dtype=etp.dtype, device=etp.device)
    launch("snow_traj", lib.rrmpg_snow_simulate_f32,
           lib.rrmpg_snow_simulate_f64, etp.dtype, etp.device,
           snow.data_ptr(), rain.data_ptr(), temp.data_ptr(), etp.data_ptr(),
           packed.data_ptr(), layer_consts.data_ptr(), frac_ice.data_ptr(),
           n, t_len, num_layers, num_uh1, num_uh2, int(hyst), int(ice),
           int(snow_only), snow0, th0, out.data_ptr())
    return out


def _band_counts(ndsi, masked):
    """(L,) steps each band's statistics average over; raises if a band
    has none."""
    num_layers, t_len = ndsi.shape
    if not masked:
        return ndsi.new_full((num_layers,), float(t_len))
    counts = torch.isfinite(ndsi).sum(dim=1)
    if bool((counts == 0).any()):
        raise ValueError(
            "an NDSI band has no finite value: masked statistics over zero "
            "valid steps are undefined.")
    return counts.to(ndsi.dtype)


def snowgr4j_ensemble_mse_fused(prec, mean_temp, etp, frac_solid_prec, qobs,
                                snow_pack_init, thermal_state_init, s_init,
                                r_init, params, frac_ice=None, ndsi=None,
                                hyst=False, ice=False, stats=False,
                                sca_stats=False, snow_only=False,
                                num_uh1=NUM_UH1, num_uh2=NUM_UH2, state=None,
                                masked=False):
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

    Other args as :func:`snowgr4j_simulate_fused`.  ``state`` (warm entry
    from a carried state) is not ported yet.
    """
    if state is not None:
        raise NotImplementedError(
            "Warm entry (state=) of the fused snow objective is not ported "
            "yet; see ROADMAP.md, Queue 1, item 6 (forecast state).")
    if sca_stats and not hyst:
        raise ValueError("sca_stats requires the hysteresis variant.")
    if sca_stats and (snow_only or ndsi is None):
        raise ValueError(
            "sca_stats needs 'ndsi' of shape (L, T) and a GR4J composition.")
    (snow, rain, temp, layer_consts, frac_ice, packed, t_len,
     num_layers) = _prepare(prec, mean_temp, etp, frac_solid_prec, params,
                            s_init, r_init, frac_ice, hyst, ice, snow_only,
                            num_uh1, num_uh2, extra=(qobs,))
    snow0, th0 = float(snow_pack_init), float(thermal_state_init)
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
            count, ndsi_t, band_counts)
    from ._build import load_library

    lib = load_library()
    _check_layer_count(lib, num_layers,
                       (4 if hyst else 2) + (4 if sca_stats else 0),
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
           ndsi_t.data_ptr() if sca_stats else None, packed.data_ptr(),
           layer_consts.data_ptr(), frac_ice.data_ptr(),
           band_counts.data_ptr() if sca_stats else None, n, t_len,
           num_layers, num_uh1, num_uh2, int(hyst), int(ice), int(snow_only),
           int(stats), int(sca_stats), int(masked), snow0, th0, float(count),
           out.data_ptr())
    return out


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


def cemaneige_ensemble_mse_fused(prec, mean_temp, frac_solid_prec, qobs,
                                 snow_pack_init, thermal_state_init, params,
                                 stats=False, masked=False):
    """Fused standalone-Cemaneige objective, the snow-only mode of K8;
    returns (N,) losses ((4, N) sufficient statistics with ``stats=True``).
    ``masked`` excludes NaN observations."""
    etp = prec.new_zeros(prec.shape[0])
    return snowgr4j_ensemble_mse_fused(
        prec, mean_temp, etp, frac_solid_prec, qobs, snow_pack_init,
        thermal_state_init, 0.0, 0.0, params, snow_only=True, stats=stats,
        masked=masked)


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
