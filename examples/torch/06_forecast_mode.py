"""Operational forecast mode: warm-state continuation.

The PyTorch port's counterpart of ``examples/06_forecast_mode.py``.  No
reference counterpart -- its ``*_init`` arguments cover only the stores,
so a split run never reproduces an unbroken one.  Here the full state
(GR4J stores + unit-hydrograph filter history; per-layer snowpack states)
carries across segment boundaries exactly: calibrate on history, then step
the model forward day by day (or batch by batch) as new forcing arrives,
without ever re-running the past.

The first part drives the ops (``gr4j_initial_state``, ``run_gr4j_warm``,
plain PyTorch on the chosen device); the class API then runs on the card
through the fused state kernels (GR4J and the snow composition) and
recalibrates through the warm entry of the fused GR4J objective.

    python -c "exec(open('examples/torch/06_forecast_mode.py').read(), \
{'__file__': 'examples/torch/06_forecast_mode.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.models import CemaneigeGR4J, GR4J
from rrmpg_tpu_torch.ops import GR4JState, gr4j_initial_state, run_gr4j_warm


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the fused kernels) or 'cpu' (plain "
                        "PyTorch)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    engine = "fused" if device.type == "cuda" else "scan"

    rng = np.random.default_rng(1)
    T = 1000
    np_prec = rng.uniform(0, 15, T)
    np_etp = rng.uniform(0, 4, T)
    prec = torch.as_tensor(np_prec, dtype=torch.float32, device=device)
    etp = torch.as_tensor(np_etp, dtype=torch.float32, device=device)
    params = {'x1': 320.0, 'x2': 1.1, 'x3': 90.0, 'x4': 2.3}
    # The ops take a leading member axis: one member here.
    members = {k: torch.tensor([v], dtype=torch.float32, device=device)
               for k, v in params.items()}
    uh = dict(num_uh1=3, num_uh2=7)

    # One unbroken simulation.
    state0 = gr4j_initial_state(0.4, 0.6, members, num_uh2=7,
                                dtype=torch.float32, device=device)
    q_full, _, _, _ = run_gr4j_warm(prec, etp, state0, members, **uh)
    q_full = q_full[0].cpu().numpy()

    # The same series as 5 chained segments (e.g. weekly forecast cycles).
    qs, state = [], state0
    for lo in range(0, T, 200):
        q, _, _, state = run_gr4j_warm(prec[lo:lo + 200], etp[lo:lo + 200],
                                       state, members, **uh)
        qs.append(q[0].cpu().numpy())
    q_chained = np.concatenate(qs)
    d_chained = float(np.abs(q_chained - q_full).max())
    print(f"unbroken vs 5 chained segments: max |dq| = {d_chained:.2e} "
          f"(carried: {GR4JState.__name__}{GR4JState._fields}, history "
          f"{tuple(state.pr_history.shape)})")

    # Day-by-day operational loop over the last 30 days.
    warm_start = T - 30
    _, _, _, state = run_gr4j_warm(prec[:warm_start], etp[:warm_start],
                                   state0, members, **uh)
    q30 = []
    for t in range(warm_start, T):
        q, _, _, state = run_gr4j_warm(prec[t:t + 1], etp[t:t + 1], state,
                                       members, **uh)
        q30.append(float(q[0, 0]))
    d_daily = float(np.abs(np.asarray(q30) - q_full[warm_start:]).max())
    print(f"day-by-day loop (30 single-step continuations): "
          f"max |dq| vs unbroken = {d_daily:.2e}")

    # ------------------------------------------------------------------
    # The same workflow through the class API: simulate returns a state
    # bundle and accepts it back -- including for the snow compositions,
    # whose bundles also carry the original series' data-dependent
    # snow-cover constants.
    # ------------------------------------------------------------------
    model = GR4J(params=params, device=device)
    q_ref = model.simulate(np_prec, np_etp, s_init=0.4, r_init=0.6,
                           engine=engine)
    q_hist, state = model.simulate(np_prec[:700], np_etp[:700],
                                   s_init=0.4, r_init=0.6,
                                   return_final_state=True, engine=engine)
    q_fc = model.simulate(np_prec[700:], np_etp[700:], initial_state=state,
                          engine=engine)
    d_class = float((torch.cat([q_hist, q_fc]) - q_ref).abs().max())
    print(f"class API (GR4J): history + forecast vs unbroken: "
          f"max |dq| = {d_class:.2e}")

    snow = CemaneigeGR4J(device=device)
    mean_t = rng.uniform(-10, 15, T)
    kw = dict(met_station_height=495, altitudes=[550, 620, 700, 785, 920],
              engine=engine)
    margs = (rng.uniform(0, 15, T), mean_t, mean_t - rng.uniform(0, 5, T),
             mean_t + rng.uniform(0, 5, T), rng.uniform(0, 4, T))
    _, st = snow.simulate(*(a[:700] for a in margs),
                          return_final_state=True, **kw)
    q_one = snow.simulate(*(a[700:] for a in margs), initial_state=st, **kw)
    q_h1, st_mid = snow.simulate(*(a[700:850] for a in margs),
                                 initial_state=st, return_final_state=True,
                                 **kw)
    q_h2 = snow.simulate(*(a[850:] for a in margs), initial_state=st_mid,
                         **kw)
    d_snow = float((torch.cat([q_h1, q_h2]) - q_one).abs().max())
    print(f"class API (CemaneigeGR4J): chained snow forecast segments: "
          f"max |dq| = {d_snow:.2e}")

    # ------------------------------------------------------------------
    # Operational recalibration: fit the parameters on a recent segment
    # from the carried state (a cold-start fit of the same segment is
    # structurally wrong -- its zero-history assumption biases routing).
    # ------------------------------------------------------------------
    q_seg = q_ref[700:, 0].cpu().numpy()
    warm_fit = model.fit(q_seg, np_prec[700:], np_etp[700:],
                         initial_state=state, seed=0, maxiter=40,
                         engine=engine)
    cold_fit = model.fit(q_seg, np_prec[700:], np_etp[700:], seed=0,
                         maxiter=40, engine=engine)
    print(f"recalibration on the last 300 days: warm-fit MSE "
          f"{warm_fit.fun:.2e} vs cold-start {cold_fit.fun:.2e}")
    return {"q_full": q_full, "q_chained": q_chained,
            "chained_max_dq": d_chained, "daily_max_dq": d_daily,
            "class_max_dq": d_class, "snow_max_dq": d_snow,
            "warm_fit_mse": float(warm_fit.fun),
            "cold_fit_mse": float(cold_fit.fun)}


if __name__ == "__main__":
    main()
