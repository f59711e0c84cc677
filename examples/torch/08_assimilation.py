"""Ensemble data assimilation: EnKF state updating for forecasts.

The PyTorch port's counterpart of ``examples/08_assimilation.py``.  No
reference counterpart -- the reference cannot even resume a simulation,
let alone correct its states against observations.  This twin experiment
shows the full operational loop on CAMELS forcing: truth run -> biased
ensemble -> forecast/analysis cycling with the stochastic EnKF
(``rrmpg_tpu_torch.tools.assimilation``) -> forecast errors.  On the card
each window's forecast is one launch of the warm entry of the fused GR4J
state kernel.  The cycle runs twice: on the host backend (one ``simulate``
per window, as the JAX example does) and on the scan backend (the loop
over windows on the device, nothing read back until the end); both draw
from one seed alike, so they agree.

    python -c "exec(open('examples/torch/08_assimilation.py').read(), \
{'__file__': 'examples/torch/08_assimilation.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.data import CAMELSLoader
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.tools import assimilation_cycle, perturb_state


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

    df = CAMELSLoader().load_basin('01031500')
    T, window = 252, 12
    prec = df['prcp(mm/day)'].values[:T]
    etp = df['PET'].values[:T]

    truth_params = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
    model = GR4J(params=truth_params, device=device)

    # Truth: wet initial stores; observations = truth + sensor noise.
    q_true = model.simulate(prec, etp, s_init=0.85, r_init=0.7,
                            engine=engine)[:, 0].cpu().numpy()
    rng = np.random.default_rng(0)
    obs = q_true + rng.normal(0, 0.02, T)

    # Ensemble: same parameters (pure state estimation), biased-dry
    # start, spread from mean-preserving lognormal perturbations.
    n = 256
    params_ens = {k: np.full(n, v) for k, v in truth_params.items()}
    _, state0 = model.simulate(prec[:window], etp[:window], s_init=0.2,
                               r_init=0.2, params=params_ens,
                               return_final_state=True, engine=engine)
    state0 = perturb_state(state0,
                           torch.Generator(device=device).manual_seed(7),
                           rel_std=0.4)
    print(f"ensemble: {n} members, biased-dry start "
          f"(truth s=0.85, ensemble 0.2)")

    # Free run: no assimilation.
    q_free = model.simulate(prec[window:], etp[window:], params=params_ens,
                            initial_state=state0,
                            engine=engine).cpu().numpy()

    # Forecast/analysis cycling: each 12-day window runs from the last
    # analysis and assimilates the window-end observation.
    cycle_kw = dict(obs_std=0.05, params=params_ens, seed=0,
                    initial_state=state0, engine=engine)
    forcings = {'prec': prec[window:], 'etp': etp[window:]}
    state, _, q_prior, diags = assimilation_cycle(
        model, forcings, obs[window:], window, **cycle_kw)

    t0 = 4 * window  # skip the spin-up cycles
    truth_tail = q_true[window:]

    def rmse(q):
        d = q[t0:].mean(axis=1) - truth_tail[t0:len(q)]
        return float(np.sqrt(np.mean(d ** 2)))

    print(f"free-run  forecast RMSE (day {t0}-{len(q_free)}): "
          f"{rmse(q_free):.4f}")
    print(f"EnKF      forecast RMSE (day {t0}-{len(q_prior)}): "
          f"{rmse(q_prior):.4f}")
    inn = np.abs(diags.innovation[:, 0])
    print(f"innovation |obs - forecast mean| first 3 cycles: "
          f"{inn[:3].mean():.3f}, last 3: {inn[-3:].mean():.3f}")

    # The analysis states themselves: the filter recovered the truth's
    # production store from discharge observations alone.
    s_analysis = float(state.s.mean())
    _, st_t = model.simulate(prec, etp, s_init=0.85, r_init=0.7,
                             return_final_state=True, engine=engine)
    s_truth = float(st_t.s[0])
    print(f"analysis production store mean: {s_analysis:.1f} mm "
          f"(truth trajectory {s_truth:.1f} mm)")

    # The same cycle on the scan backend: the window loop stays on the
    # device; one seed gives both backends the same draws.
    state_scan, _, q_scan, _ = assimilation_cycle(
        model, forcings, obs[window:], window, backend='scan', **cycle_kw)
    d_backends = float(np.abs(q_scan - q_prior).max())
    print(f"scan backend: EnKF forecast RMSE {rmse(q_scan):.4f}, "
          f"production store mean {float(state_scan.s.mean()):.1f} mm; "
          f"max |dq| against the host backend {d_backends:.2e}")
    return {"rmse_free": rmse(q_free), "rmse_enkf": rmse(q_prior),
            "innovation_first": float(inn[:3].mean()),
            "innovation_last": float(inn[-3:].mean()),
            "s_analysis": s_analysis, "s_truth": s_truth,
            "rmse_enkf_scan": rmse(q_scan), "backends_max_dq": d_backends}


if __name__ == "__main__":
    main()
