#!/usr/bin/env python3
"""Drive the PyTorch port's GR4J main path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order (each prints its lines; any failure exits non-zero):

1. environment -- card name and power limit, torch / CUDA / nvcc / triton;
2. build       -- compile ``rrmpg_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels     -- each fused kernel (K1 MSE, K2 stats, K3 trajectories)
                  against its plain PyTorch version on the same CUDA
                  tensors: float64 and float32, both UH register pairs,
                  with and without NaN gaps in qobs;
4. golden      -- the fused engine in float64 against the authors' Excel
                  GR4J trajectory (tests/data/gr4j_example_data.csv);
5. main path   -- on CAMELS basin 01031500, float32: a 131072-member
                  Monte-Carlo through the fused stats kernel, two DE
                  calibrations (MSE, KGE) through the fused objectives,
                  and a fused simulation of the calibrated model.  The
                  launch counters must show every kernel ran; then each
                  kernel is compared with its plain version at the shapes
                  the main path gave it;
6. times       -- each kernel against its plain version at
                  131072 members x 3651 days, and the main path's wall
                  times.

The last two lines are a JSON object describing the kernels and the
result line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import rrmpg_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
SOURCE = "rrmpg_tpu_torch/csrc/gr4j_fused.cu"
REPLACES = {"gr4j_mse": "rrmpg_tpu/ops/pallas_gr4j.py:228",
            "gr4j_stats": "rrmpg_tpu/ops/pallas_gr4j.py:285",
            "gr4j_traj": "rrmpg_tpu/ops/pallas_gr4j.py:156"}
BOUNDS_X4_WIDE = 9.9      # exercises every tap of the (10, 21) registers
MC_MEMBERS = 131072
TIME_MEMBERS, TIME_STEPS = 131072, 3651
# Golden parameters (tests/test_models_golden.py:test_gr4j_against_excel).
GOLDEN_PARAMS = {'x1': np.exp(5.76865628090826),
                 'x2': np.sinh(1.61742503661094),
                 'x3': np.exp(4.24316129943456),
                 'x4': np.exp(-0.117506799276908) + 0.5}
# Tolerances of the kernel-vs-plain checks.  float64: the same operations
# in another order (FMA contraction) and libdevice vs ATen tanh.  float32:
# rounding compounds over thousands of steps of the recurrence; the
# fused-vs-XLA float32 drift of rrmpg_tpu is 8.5e-3 relative.
TOL = {torch.float64: {"traj": (1e-9, 1e-12), "obj": (1e-9, 1e-12)},
       torch.float32: {"traj": (5e-3, 1e-3), "obj": (2e-2, 0.0)}}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def errors(got, want, rtol, atol):
    """(max abs err, max rel err, within allclose(rtol, atol))."""
    got, want = got.double(), want.double()
    check(torch.isfinite(got).all().item(), "kernel output is not finite")
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(torch.finfo(torch.float64).tiny)
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return float(diff.max()), float(rel.max()), ok


def timed(fn, reps):
    """Median wall time in ms of ``reps`` synchronized calls after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def basin():
    from rrmpg_tpu_torch.data import CAMELSLoader

    df = CAMELSLoader().load_basin('01031500')
    return (df['QObs(mm/d)'].to_numpy(), df['prcp(mm/day)'].to_numpy(),
            df['PET'].to_numpy())


def random_params(rng, n, x4_hi, dtype):
    p = {'x1': rng.uniform(100, 1200, n), 'x2': rng.uniform(-5, 3, n),
         'x3': rng.uniform(20, 300, n), 'x4': rng.uniform(1.1, x4_hi, n)}
    return {k: torch.tensor(v, dtype=dtype, device=DEVICE)
            for k, v in p.items()}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment():
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an "
              "NVIDIA GPU.", file=sys.stderr)
        sys.exit(2)
    card = card_line()
    print(card)
    nvcc = subprocess.run(
        [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                      "nvcc"), "--version"], capture_output=True, text=True)
    nvcc_line = (nvcc.stdout.strip().splitlines() or ["nvcc: none"])[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(f"[1 environment] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"{nvcc_line}, triton {triton_version}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from rrmpg_tpu_torch.ops._build import load_library

    lib = load_library()
    print(f"[2 build] {lib.path.name} built in {lib.build_seconds:.1f} s "
          f"(0.0 = found built)")
    # One line per kernel instantiation from nvcc's -Xptxas -v output.
    kernel, spill = None, 0
    for ln in lib.log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(gr4j_(?:objective|traj)_kernel)I(\w+?)EEv", ln)
            kernel, spill = (m.group(1) + "<" + m.group(2) + ">") if m \
                else ln.split("'")[1], 0
        elif "spill stores" in ln:
            spill = max(spill, int(ln.split("bytes spill stores")[0]
                                   .split(",")[-1]))
        elif "Used" in ln and "registers" in ln and kernel:
            regs = ln.split("Used")[1].split("registers")[0].strip()
            print(f"    ptxas: {kernel}: {regs} registers, {spill} bytes "
                  "spill stores")
            kernel = None


def phase_kernels(prec_np, etp_np, qobs_np, n=1000, t_len=3651):
    """Every kernel against its plain version: both dtypes, both UH pairs,
    with and without gaps."""
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    qobs_gap = qobs_np[:t_len].copy()
    qobs_gap[::17] = np.nan
    qobs_gap[400:430] = np.nan
    n_checks = 0
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        as_t = lambda a: torch.tensor(a[:t_len], dtype=dtype, device=DEVICE)
        prec, etp = as_t(prec_np), as_t(etp_np)
        for n1, n2 in fg.SUPPORTED_UH:
            rng = np.random.default_rng(n1)
            params = random_params(rng, n, 2.9 if n1 == 3 else BOUNDS_X4_WIDE,
                                   dtype)
            packed = fg.pack_params(params, 0.4, 0.3)
            cases = [("traj", fg.gr4j_simulate_fused(
                          prec, etp, 0.4, 0.3, params, n1, n2),
                      fg.gr4j_simulate_reference(prec, etp, packed, n1, n2))]
            for masked, qo in ((False, qobs_np), (True, qobs_gap)):
                qo = as_t(qo)
                count = int(torch.isfinite(qo).sum()) if masked else t_len
                for stats in (False, True):
                    name = ("stats" if stats else "mse") + (
                        "+masked" if masked else "")
                    cases.append((name, fg.gr4j_ensemble_mse_fused(
                        prec, etp, qo, 0.4, 0.3, params, n1, n2,
                        stats=stats, masked=masked),
                        fg.gr4j_objective_reference(
                            prec, etp, qo, packed, n1, n2, stats, masked,
                            count)))
            for name, got, want in cases:
                torch.cuda.synchronize()
                rtol, atol = tol["traj" if name == "traj" else "obj"]
                abs_err, rel_err, ok = errors(got, want, rtol, atol)
                print(f"    {str(dtype)[6:]} uh=({n1},{n2}) {name:13s} "
                      f"shape={tuple(got.shape)} max_abs={abs_err:.3e} "
                      f"max_rel={rel_err:.3e} rtol={rtol:g} atol={atol:g} "
                      f"{'ok' if ok else 'FAIL'}")
                check(ok, f"{name} kernel disagrees with its plain version")
                n_checks += 1
    print(f"[3 kernels] {n_checks} kernel-vs-plain checks passed at "
          f"N={n}, T={t_len}")


def phase_golden():
    import pandas as pd
    from rrmpg_tpu_torch.models import GR4J

    data = pd.read_csv(REPO / "tests" / "data" / "gr4j_example_data.csv")
    model = GR4J(params=GOLDEN_PARAMS, device=DEVICE, dtype=torch.float64)
    qsim = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                          engine='fused')
    q = qsim.cpu().numpy().ravel()
    err = float(np.max(np.abs(q - data.qsim_excel.to_numpy())))
    ok = np.allclose(q, data.qsim_excel)
    print(f"[4 golden] fused float64 vs Excel qsim: T={len(q)} "
          f"max_abs={err:.3e} np.allclose={ok}")
    check(ok, "fused GR4J does not reproduce the Excel trajectory")


def phase_main_path(card, qobs, prec, etp):
    from rrmpg_tpu_torch.models import GR4J
    from rrmpg_tpu_torch.ops import fused_gr4j as fg
    from rrmpg_tpu_torch.tools import monte_carlo

    names = GR4J._param_list
    np.random.seed(0)
    fg.reset_launches()
    t0 = time.perf_counter()
    mc = monte_carlo(GR4J(device=DEVICE), num=MC_MEMBERS, qobs=qobs,
                     prec=prec, etp=etp, return_qsim=False, engine='fused',
                     metrics=('mse', 'nse', 'kge'))
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_mse = GR4J(device=DEVICE).fit(qobs, prec, etp, engine='fused',
                                      seed=0, maxiter=30)
    fit_mse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_kge = GR4J(device=DEVICE).fit(qobs, prec, etp, engine='fused',
                                      seed=0, maxiter=30, loss_metric='kge')
    fit_kge_s = time.perf_counter() - t0
    calibrated = GR4J(params={k: float(v) for k, v in zip(names, res_kge.x)},
                      device=DEVICE)
    qsim = calibrated.simulate(prec, etp, engine='fused')
    torch.cuda.synchronize()
    launches = dict(fg.LAUNCHES)

    for m in ('mse', 'nse', 'kge'):
        check(mc[m].shape == (MC_MEMBERS,), f"MC {m} has shape {mc[m].shape}")
        check(np.isfinite(mc[m]).all(), f"MC {m} has non-finite values")
    bounds = GR4J._default_bounds
    for res in (res_mse, res_kge):
        check(np.isfinite(res.fun), f"fit fun is not finite: {res.fun}")
        for name, v in zip(names, res.x):
            lo, hi = bounds[name]
            check(lo - 1e-5 * abs(lo) <= v <= hi + 1e-5 * abs(hi),
                  f"fit {name}={v} outside {bounds[name]}")
    check(qsim.shape == (len(prec), 1) and bool(torch.isfinite(qsim).all()),
          "calibrated simulation is not a finite (T, 1) series")
    expect = {"gr4j_stats": 1 + res_kge.nit + 1,
              "gr4j_mse": res_mse.nit + 1, "gr4j_traj": 1}
    check(launches == expect,
          f"launch counts {launches} differ from the expected {expect}")
    print(f"[5 main path] CAMELS 01031500 T={len(prec)} float32: MC "
          f"{MC_MEMBERS} members best NSE {np.max(mc['nse']):.4f} in "
          f"{mc_s:.3f} s; fit mse nit={res_mse.nit} fun={res_mse.fun:.5f} in "
          f"{fit_mse_s:.3f} s; fit kge nit={res_kge.nit} "
          f"1-KGE={res_kge.fun:.5f} in {fit_kge_s:.3f} s; launches "
          f"{launches} == expected; {card}")

    # Each kernel against its plain version at the shapes the main path
    # gave it (these launches are not counted above).
    as_t = lambda a: torch.tensor(np.asarray(a, np.float64),
                                  dtype=torch.float32, device=DEVICE)
    prec_t, etp_t, qobs_t = as_t(prec), as_t(etp), as_t(qobs)
    masked = bool(np.isnan(qobs).any())
    count = int(np.isfinite(qobs).sum())
    model = GR4J(device=DEVICE)
    mc_params, _ = model._prepare_params(mc['params'])
    pop = torch.tensor(res_kge.population, dtype=torch.float32,
                       device=DEVICE)
    pop_params = {n: pop[:, j].contiguous() for j, n in enumerate(names)}
    cal_params, _ = calibrated._prepare_params(None)
    rtol_o = TOL[torch.float32]["obj"]
    rtol_t = TOL[torch.float32]["traj"]
    cases = [
        ("gr4j_stats", "MC", mc_params, (10, 21), True, rtol_o),
        ("gr4j_mse", "fit population", pop_params, (3, 7), False, rtol_o),
        ("gr4j_stats", "fit population", pop_params, (3, 7), True, rtol_o),
        ("gr4j_traj", "calibrated", cal_params, (10, 21), None, rtol_t),
    ]
    max_abs = {}
    for kernel, what, params, (n1, n2), stats, (rtol, atol) in cases:
        packed = fg.pack_params(params, 0.0, 0.0)
        if stats is None:
            got = fg.gr4j_simulate_fused(prec_t, etp_t, 0.0, 0.0, params,
                                         n1, n2)
            want = fg.gr4j_simulate_reference(prec_t, etp_t, packed, n1, n2)
        else:
            got = fg.gr4j_ensemble_mse_fused(prec_t, etp_t, qobs_t, 0.0, 0.0,
                                             params, n1, n2, stats=stats,
                                             masked=masked)
            want = fg.gr4j_objective_reference(prec_t, etp_t, qobs_t, packed,
                                               n1, n2, stats, masked, count)
        torch.cuda.synchronize()
        abs_err, rel_err, ok = errors(got, want, rtol, atol)
        max_abs[kernel] = max(max_abs.get(kernel, 0.0), abs_err)
        print(f"    main-path shape {kernel} ({what}) "
              f"shape={tuple(got.shape)} max_abs={abs_err:.3e} "
              f"max_rel={rel_err:.3e} rtol={rtol:g} atol={atol:g} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{kernel} disagrees with its plain version at the main "
                  f"path's shape ({what})")
    walls = {"mc_s": mc_s, "fit_mse_s": fit_mse_s, "fit_kge_s": fit_kge_s}
    return launches, max_abs, walls


def phase_times(card, prec_np, etp_np, qobs_np):
    from rrmpg_tpu_torch.ops import fused_gr4j as fg

    as_t = lambda a: torch.tensor(a[:TIME_STEPS], dtype=torch.float32,
                                  device=DEVICE)
    prec, etp, qobs = as_t(prec_np), as_t(etp_np), as_t(qobs_np)
    params = random_params(np.random.default_rng(1), TIME_MEMBERS, 2.9,
                           torch.float32)
    packed = fg.pack_params(params, 0.0, 0.0)
    n1, n2 = fg.SUPPORTED_UH[1]
    runs = {
        "gr4j_mse": (
            lambda: fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0,
                                               params, n1, n2),
            lambda: fg.gr4j_objective_reference(prec, etp, qobs, packed,
                                                n1, n2)),
        "gr4j_stats": (
            lambda: fg.gr4j_ensemble_mse_fused(prec, etp, qobs, 0.0, 0.0,
                                               params, n1, n2, stats=True),
            lambda: fg.gr4j_objective_reference(prec, etp, qobs, packed,
                                                n1, n2, stats=True)),
        "gr4j_traj": (
            lambda: fg.gr4j_simulate_fused(prec, etp, 0.0, 0.0, params,
                                           n1, n2),
            lambda: fg.gr4j_simulate_reference(prec, etp, packed, n1, n2)),
    }
    times = {}
    for name, (kernel, plain) in runs.items():
        # plain, kernel, kernel, plain: drift shows as a plain/plain gap.
        plain_a = timed(plain, 2)
        kernel_a = timed(kernel, 5)
        kernel_b = timed(kernel, 5)
        plain_b = timed(plain, 2)
        ms, plain_ms = min(kernel_a, kernel_b), min(plain_a, plain_b)
        times[name] = (ms, plain_ms)
        rate = TIME_MEMBERS * TIME_STEPS / (ms * 1e-3)
        print(f"[6 times] {name} float32 uh=({n1},{n2}) N={TIME_MEMBERS} "
              f"T={TIME_STEPS}: kernel {kernel_a:.3f}/{kernel_b:.3f} ms, "
              f"plain {plain_a:.1f}/{plain_b:.1f} ms (median of runs), "
              f"{rate:.4e} member-steps/s; {card}")
    return times


def main():
    card = phase_environment()
    phase_build()
    qobs, prec, etp = basin()
    phase_kernels(prec, etp, qobs)
    phase_golden()
    launches, max_abs, walls = phase_main_path(card, qobs, prec, etp)
    times = phase_times(card, prec, etp, qobs)
    print(f"[6 times] main path wall: MC {walls['mc_s']:.3f} s, fit mse "
          f"{walls['fit_mse_s']:.3f} s, fit kge {walls['fit_kge_s']:.3f} s; "
          f"{card}")
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max_abs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name in ("gr4j_mse", "gr4j_stats", "gr4j_traj")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
