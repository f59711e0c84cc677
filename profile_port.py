#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's main paths, on one NVIDIA GPU.

    python3 profile_port.py        # from the repository root; needs one card
    python3 profile_port.py assim  # the assimilation cycle alone
    python3 profile_port.py abc-scan  # ABC's 'scan' engine: walls, memory

Each path is driven through the entry points a user calls, in float32, at
the shapes ``chip_smoke.py`` drives (the forecast path too: a 131072-member
warm continuation of the last 365 days from one shared state and a warm
``fit`` per family that carries state through kernels; the regional path: the
GR4J and snow objectives over 8 catchments x 131072 members, and GLUE over a
20000-member Monte-Carlo; the tools phase's SCE-UA fit of GR4J, Pareto fit
of the hysteresis + ice model and DE-MC chain; the assim phase's GR4J EnKF
cycle of 131072 members x 36 windows on both backends, with K4's share of
the wall): warmed up once,
run three times untraced (host clock, synchronised) and once under ``torch.profiler``.
Per path one line: the untraced walls, the traced wall, the device's busy
time (kernels and copies), its idle share (1 - busy / traced wall), and the
device time by kernel name.  Every line carries the card's name and power
limit.  The numbers of PERF.md section 5 come from here.

``abc-scan`` times ABC's ``'scan'`` engine on CAMELS 01031500 at 4096
and 131072 members: the Toeplitz scan (members in groups, and in one
group as before the groups), the doubling scan it replaced in the fit
objective, the class's ``simulate`` and a one-generation ``fit`` of that
population; per call the median wall of three (host clock, synchronised)
and the peak of ``torch.cuda.max_memory_allocated`` above what was
allocated before it.
"""

import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

UNTRACED_RUNS = 3
TRACE_ATTEMPTS = 2
TOP_KERNELS = 4


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def device_time_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def trace(card, label, fn):
    """Print one path's line; returns the device time by kernel name."""
    fn()
    untraced = [wall_ms(fn) for _ in range(UNTRACED_RUNS)]
    # A traced run whose trace holds no device event is traced once more
    # (the profiler drops a cycle's events now and then); two empty
    # traces fail.
    for _ in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = wall_ms(fn)
        by_name = {}
        for event in prof.key_averages():
            # Device-side events only (kernels, copies): a host operator's
            # entry repeats the device time of the kernels it launched.
            if event.device_type != DeviceType.CUDA:
                continue
            us = device_time_us(event)
            if us > 0:
                by_name[event.key] = (us / 1e3, event.count)
        busy = sum(ms for ms, _ in by_name.values())
        if busy > 0:
            break
    if busy == 0:
        raise cs.SmokeFailure(
            f"{label}: the trace shows no device time; the profiler does "
            "not see the card")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    kernels = "; ".join(f"{name[:60]} {ms:.3f} ms x{count}"
                        for name, (ms, count) in top)
    print(f"[profile] {label}: untraced "
          f"{' / '.join(f'{w:.2f}' for w in untraced)} ms, traced "
          f"{traced:.2f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / traced:.3f}; {kernels}; {card}")
    return by_name, traced


def profile_assimilation(card, prec, etp):
    """The GR4J assimilation cycle of chip_smoke.py's assim phase: 131072
    members from a dry, spread start, the last 365 days of CAMELS 01031500
    in 36 windows of 10 days, the EnKF on the host and the scan backend
    through K4's warm entry; per backend the wall, K4's share of it and the
    idle share."""
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.tools import assimilation_cycle

    days, w, n = cs.FORECAST_DAYS, cs.ASSIM_WINDOW, cs.ASSIM_MEMBERS
    split = len(prec) - days
    model = GR4J(params={'x1': 350.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7})
    _, state = model.simulate(prec[:split], etp[:split],
                              return_final_state=True, engine='fused')
    truth = model.simulate(prec, etp, engine='fused')[split:, 0]
    obs = truth.cpu().numpy() + np.random.default_rng(0).normal(
        0.0, cs.ASSIM_NOISE, days)
    members = cs.shared_params(model, n)
    ens = cs.assim_ensemble(model, state, n, 2)
    tail = dict(prec=prec[split:], etp=etp[split:])
    for backend in ("host", "scan"):
        by_name, traced = trace(
            card, f"GR4J EnKF assimilation_cycle backend='{backend}' {n} x "
            f"{days // w} windows of {w} (fused)",
            lambda: assimilation_cycle(
                model, tail, obs, w, 0.05, params=members, initial_state=ens,
                key=cs.generator(3), backend=backend, engine='fused'))
        k4 = sum(ms for name, (ms, _) in by_name.items()
                 if "gr4j_traj_state" in name)
        print(f"[profile]     backend='{backend}': K4 {k4:.3f} ms of the "
              f"traced {traced:.2f} ms ({k4 / traced:.3f}); {card}")


def peak_call(fn):
    """(median wall ms of three calls after a warm-up, peak bytes above
    the allocation before the call), or None on running out of memory."""
    try:
        fn()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = [wall_ms(fn) for _ in range(UNTRACED_RUNS)]
        return (sorted(walls)[len(walls) // 2],
                torch.cuda.max_memory_allocated() - base)
    except torch.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None


def profile_abc_scan(card, qobs, prec):
    """ABC's 'scan' engine at the Monte-Carlo's 4096 members and at
    MC_MEMBERS, on the basin's days (float32)."""
    from rrmpg_tpu_torch.models import ABCModel
    from rrmpg_tpu_torch.ops import abc, linear_scan

    prec_t = cs.as_tensor(prec, cs.F32)
    for n in (cs.ABC_MC_MEMBERS, cs.MC_MEMBERS):
        params, s0 = cs.abc_members(np.random.default_rng(3), n, cs.F32)
        members = {k: v.cpu().numpy() for k, v in params.items()}
        grouped = linear_scan.MATRIX_ELEMENTS

        def one_group():
            linear_scan.MATRIX_ELEMENTS = 2 ** 62
            try:
                return abc.run_abcmodel_matscan(prec_t, s0, params)
            finally:
                linear_scan.MATRIX_ELEMENTS = grouped

        popsize = -(-n // len(ABCModel._param_list))
        calls = (
            ("run_abcmodel_matscan (groups of "
             f"{grouped // 128 ** 2})", lambda: abc.run_abcmodel_matscan(
                 prec_t, s0, params)),
            ("run_abcmodel_matscan (one group)", one_group),
            ("run_abcmodel_pscan (the fit objective's scan before)",
             lambda: abc.run_abcmodel_pscan(prec_t, s0, params)),
            ("ABCModel.simulate(engine='scan')", lambda: ABCModel().simulate(
                prec, params=members, engine='scan')),
            (f"ABCModel.fit popsize {popsize} ({popsize * 3} members), "
             "maxiter 1", lambda: ABCModel().fit(qobs, prec, seed=0,
                                                 popsize=popsize,
                                                 maxiter=1)))
        for label, fn in calls:
            got = peak_call(fn)
            text = ("out of memory" if got is None else
                    f"{got[0]:.3f} ms, peak {got[1] / 2 ** 30:.3f} GiB")
            print(f"[profile] ABC 'scan' {n} x {len(prec)} float32: "
                  f"{label}: {text}; {card}")
        del params, s0, members


def main():
    only_assim = sys.argv[1:] == ["assim"]
    card = cs.phase_environment()
    if sys.argv[1:] == ["abc-scan"]:          # no kernel on this path
        qobs, prec, _ = cs.basin()
        profile_abc_scan(card, qobs, prec)
        print(card)
        return
    cs.phase_build()
    if only_assim:
        _, prec, etp = cs.basin()
        profile_assimilation(card, prec, etp)
        print(card)
        return
    from rrmpg_tpu_torch.models import (GR4J, ABCModel,
                                        CemaneigeHystGR4JIce, HBVEdu)
    from rrmpg_tpu_torch.ops import abc_fused, abc_fused_single
    from rrmpg_tpu_torch.tools import monte_carlo

    qobs, prec, etp = cs.basin()
    forcing, qsim_matlab = cs.hbv_data()
    snow, soil, s1, s2 = cs.HBV_INITS
    hbv_kw = dict(forcing, snow_init=snow, soil_init=soil, s1_init=s1,
                  s2_init=s2)
    hbv_qobs = qsim_matlab * (24 * 60 * 60) / (cs.HBV_AREA * 1000)
    hbv_qobs[::97] = np.nan
    mc_kw = dict(return_qsim=False, engine='fused',
                 metrics=('mse', 'nse', 'kge'))

    def seeded(fn):
        def run():
            np.random.seed(0)
            return fn()
        return run

    n = cs.MC_MEMBERS
    trace(card, f"GR4J MC {n} x {len(prec)}", seeded(lambda: monte_carlo(
        GR4J(), num=n, qobs=qobs, prec=prec, etp=etp, **mc_kw)))
    for loss in ('mse', 'kge'):
        trace(card, f"GR4J fit {loss} (60 members x {len(prec)}, "
              "maxiter 30)", lambda: GR4J().fit(
                  qobs, prec, etp, engine='fused', seed=0, maxiter=30,
                  loss_metric=loss))
    trace(card, f"GR4J simulate 1 x {len(prec)} (fused)",
          lambda: GR4J(params=cs.GR4J_GOLDEN).simulate(prec, etp,
                                                      engine='fused'))

    trace(card, f"HBV-Edu MC {n} x {len(hbv_qobs)}",
          seeded(lambda: monte_carlo(HBVEdu(), num=n, qobs=hbv_qobs,
                                     **mc_kw, **hbv_kw)))
    for loss in ('mse', 'kge'):
        trace(card, f"HBV-Edu fit {loss} (165 members x {len(hbv_qobs)}, "
              "maxiter 30)", lambda: HBVEdu().fit(
                  hbv_qobs, **hbv_kw, engine='fused', seed=0, maxiter=30,
                  loss_metric=loss))
    trace(card, f"HBV-Edu simulate 1 x {len(hbv_qobs)} (fused)",
          lambda: HBVEdu(params=cs.HBV_GOLDEN).simulate(
              **hbv_kw, engine='fused'))

    met, snow_qobs, ndsi = cs.snow_main_data()
    snow_forcing = (*met.values(), cs.FRAC_ICE_GOLDEN)
    snow_kw = dict(met_station_height=700, altitudes=cs.ALTITUDES,
                   s_init=0.5, r_init=0.4)
    snow_fit = dict(engine='fused', seed=0, maxiter=cs.SNOW_FIT_MAXITER,
                    **snow_kw)
    shape = f"{len(snow_qobs)} x {len(cs.ALTITUDES)} layers"
    trace(card, f"CemaneigeHystGR4JIce MC {n} x {shape}",
          seeded(lambda: monte_carlo(
              CemaneigeHystGR4JIce(), num=n, qobs=snow_qobs, **mc_kw, **met,
              frac_ice=cs.FRAC_ICE_GOLDEN, **snow_kw)))
    for loss in ('mse', 'kge'):
        trace(card, f"CemaneigeHystGR4JIce fit {loss} (135 members x "
              f"{shape}, maxiter {cs.SNOW_FIT_MAXITER})",
              lambda: CemaneigeHystGR4JIce().fit(
                  snow_qobs, *snow_forcing, loss_metric=loss, **snow_fit))
    trace(card, f"CemaneigeHystGR4JIce fit_Q_SCA kge (135 members x "
          f"{shape}, maxiter {cs.SNOW_FIT_MAXITER})",
          lambda: CemaneigeHystGR4JIce().fit_Q_SCA(
              snow_qobs, *snow_forcing, *ndsi, loss_metric='kge',
              **snow_fit))
    trace(card, f"CemaneigeHystGR4JIce simulate 1 x {shape} (fused)",
          lambda: CemaneigeHystGR4JIce(
              params=dict(cs.HYST_GOLDEN, DDF=5)).simulate(
                  *snow_forcing, engine='fused', **snow_kw))

    # The analysis tools at chip_smoke.py's tools-phase shapes: SCE-UA (one
    # K1 launch a CCE step), the Pareto fit (one K8 launch a generation)
    # and DE-MC (two K1 launches a step).
    from rrmpg_tpu_torch.tools import demc_sample

    trace(card, f"GR4J fit method='sce' (12 candidates a launch x "
          f"{len(prec)}, maxiter {cs.TOOLS_SCE_MAXITER})",
          lambda: GR4J().fit(qobs, prec, etp, method='sce', engine='fused',
                             seed=0, maxiter=cs.TOOLS_SCE_MAXITER))
    trace(card, f"CemaneigeHystGR4JIce fit_Q_SCA(pareto=True) kge (pop "
          f"{cs.TOOLS_PARETO['pop_size']} x {shape}, "
          f"{cs.TOOLS_PARETO['n_generations']} generations)",
          lambda: CemaneigeHystGR4JIce().fit_Q_SCA(
              snow_qobs, *snow_forcing, *ndsi, loss_metric='kge',
              pareto=True, engine='fused', seed=0, **snow_kw,
              **cs.TOOLS_PARETO))
    demc_objective, _ = cs.gr4j_mse_objective(
        *(cs.as_tensor(a, cs.F32) for a in (prec, etp, qobs)))
    demc_scale = -0.5 * len(prec) / cs.TOOLS_DEMC_SIGMA ** 2
    trace(card, f"DE-MC GR4J Gaussian likelihood ({cs.TOOLS_DEMC['num_chains']}"
          f" chains x {cs.TOOLS_DEMC['num_steps']} steps x {len(prec)})",
          lambda: demc_sample(
              lambda X: demc_scale * demc_objective(X),
              [GR4J._default_bounds[p] for p in GR4J._param_list], seed=0,
              batched=True, **cs.TOOLS_DEMC))

    # The forecast path: spin-up to a state, then the full-width warm
    # continuation and the warm recalibration of the last days from it.
    days = cs.FORECAST_DAYS
    hbv_cold = dict(snow_init=snow, soil_init=soil, s1_init=s1, s2_init=s2)
    families = (
        ("GR4J", GR4J, {'x1': 350.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7},
         lambda lo, hi: dict(prec=prec[lo:hi], etp=etp[lo:hi]), {}, qobs),
        ("HBV-Edu", HBVEdu, cs.HBV_GOLDEN,
         lambda lo, hi: dict(forcing, temp=forcing['temp'][lo:hi],
                             prec=forcing['prec'][lo:hi],
                             month=forcing['month'][lo:hi]), hbv_cold,
         hbv_qobs),
        ("CemaneigeHystGR4JIce", CemaneigeHystGR4JIce,
         dict(cs.HYST_GOLDEN, DDF=5),
         lambda lo, hi: dict({k: v[lo:hi] for k, v in met.items()},
                             frac_ice=cs.FRAC_ICE_GOLDEN,
                             met_station_height=700,
                             altitudes=cs.ALTITUDES),
         dict(s_init=0.5, r_init=0.4), snow_qobs))
    for label, model_cls, params, cut, cold_kw, obs in families:
        split = len(obs) - days
        model = model_cls(params=params)
        _, state = model.simulate(**cut(0, split), **cold_kw,
                                  return_final_state=True, engine='fused')
        np.random.seed(1)
        members = model_cls().get_random_params(n)
        tail = cut(split, len(obs))
        trace(card, f"{label} spin-up 1 x {split} with final state (fused)",
              lambda: model.simulate(**cut(0, split), **cold_kw,
                                     return_final_state=True,
                                     engine='fused'))
        trace(card, f"{label} warm continuation {n} x {days} from one "
              "state, with final state (fused)", lambda: model.simulate(
                  **tail, params=members, initial_state=state,
                  return_final_state=True, engine='fused'))
        for loss in ('mse', 'kge'):
            trace(card, f"{label} warm fit {loss} (x {days}, maxiter "
                  f"{cs.FORECAST_FIT_MAXITER})", lambda: model_cls().fit(
                      obs[split:], **tail, initial_state=state,
                      engine='fused', seed=0, loss_metric=loss,
                      maxiter=cs.FORECAST_FIT_MAXITER))

    # The regional path: the eight CAMELS-format basins of chip_smoke.py
    # loaded with load_basins(join='outer'), the snow region from the Excel
    # sheet, members sampled per call; then GLUE.
    from rrmpg_tpu_torch import interop
    from rrmpg_tpu_torch.data import CAMELSLoader
    from rrmpg_tpu_torch.models import CemaneigeGR4J
    from rrmpg_tpu_torch.parallel import (regional_gr4j_objective,
                                          regional_snow_objective)
    from rrmpg_tpu_torch.tools import glue_weights, prediction_limits

    with tempfile.TemporaryDirectory() as tmp:
        cs.write_region(Path(tmp))
        _, arrays = CAMELSLoader(tmp).load_basins(join='outer')
    region = interop.regional_forcing_from_numpy(
        arrays['prcp(mm/day)'], arrays['PET'], arrays['QObs(mm/d)'])
    c, t_region = region[0].shape
    for loss in ('mse', 'kge'):
        trace(card, f"regional GR4J {loss} {c} catchments x {n} x "
              f"{t_region} (K5)", seeded(lambda: regional_gr4j_objective(
                  *region, 0.3, 0.3, interop.params_from_numpy(
                      GR4J().get_random_params(n)), loss_metric=loss)))
    snow_np = cs.region_snow_arrays()
    etp_s, qobs_s, *layers, frac_ice = interop.regional_forcing_from_numpy(
        snow_np["etp"], snow_np["qobs"],
        layers=(snow_np["prec"], snow_np["temp"], snow_np["frac"]),
        frac_ice=snow_np["frac_ice"])
    for loss in ('mse', 'kge'):
        trace(card, f"regional CemaneigeHystGR4JIce {loss} {c} catchments x "
              f"{n} x {etp_s.shape[1]} x {layers[0].shape[2]} layers (K11)",
              seeded(lambda: regional_snow_objective(
                  layers[0], layers[1], etp_s, layers[2], qobs_s, 0.0, 0.0,
                  0.5, 0.4, interop.params_from_numpy(
                      CemaneigeHystGR4JIce().get_random_params(n)),
                  frac_ice=frac_ice, hyst=True, ice=True, loss_metric=loss)))
    df = CAMELSLoader().load_basin('01031500').iloc[:cs.GLUE_DAYS]
    glue_qobs = df['QObs(mm/d)'].to_numpy()
    glue_kw = dict(prec=df['prcp(mm/day)'].to_numpy(),
                   mean_temp=((df['tmax(C)'] + df['tmin(C)']) / 2).to_numpy(),
                   min_temp=df['tmin(C)'].to_numpy(),
                   max_temp=df['tmax(C)'].to_numpy(), etp=df['PET'].to_numpy(),
                   met_station_height=CAMELSLoader().get_station_height(
                       '01031500'))
    glue_mc = seeded(lambda: monte_carlo(
        CemaneigeGR4J(), num=cs.GLUE_MEMBERS, qobs=glue_qobs, **glue_kw,
        metrics=('nse',), engine='fused'))
    trace(card, f"GLUE monte_carlo CemaneigeGR4J {cs.GLUE_MEMBERS} x "
          f"{cs.GLUE_DAYS} with trajectories (K9)", glue_mc)
    mc = glue_mc()
    trace(card, f"GLUE weights and 3 prediction limits over {cs.GLUE_DAYS} "
          f"x {cs.GLUE_MEMBERS}", lambda: prediction_limits(
              mc['qsim'], glue_weights(mc['nse'], behavioral_threshold=0.3)))

    prec_long = np.random.default_rng(0).uniform(0, 20, cs.ABC_STEPS)
    prec_t = cs.as_tensor(prec_long, cs.F32)
    model = ABCModel(params=cs.ABC_PARAMS)
    trace(card, f"ABC simulate 1 x {cs.ABC_STEPS} from a numpy series "
          "(fused)", lambda: model.simulate(prec_long, engine='fused',
                                            return_storage=True))
    trace(card, f"ABC op abc_fused_single 1 x {cs.ABC_STEPS} on a device "
          "tensor", lambda: abc_fused_single(prec_t, 0.0, cs.ABC_PARAMS))
    trace(card, f"ABC op abc_fused 1 x {cs.ABC_STEPS} on a device tensor",
          lambda: abc_fused(prec_t, 0.0, cs.ABC_PARAMS))
    trace(card, f"ABC MC {cs.ABC_MC_MEMBERS} x {len(prec)} (fused)",
          seeded(lambda: monte_carlo(
              ABCModel(), num=cs.ABC_MC_MEMBERS, qobs=qobs, prec=prec,
              return_qsim=False, engine='fused', metrics=('mse', 'nse'))))
    trace(card, f"ABC fit mse (45 members x {len(prec)}, maxiter 30, plain "
          "doubling scan)", lambda: ABCModel().fit(qobs, prec, seed=0,
                                                   maxiter=30))
    profile_assimilation(card, prec, etp)
    print(card)


if __name__ == "__main__":
    try:
        main()
    except cs.SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
