"""Multi-objective calibration: the Q-vs-SCA Pareto front.

The PyTorch port's counterpart of ``examples/09_pareto_front.py``.  The
reference's ``fit_Q_SCA`` collapses the discharge error and the
snow-cover error into one number at fixed weights (0.75 / 0.05,
``cemaneigehystgr4j.py:663-689``) -- one point on a tradeoff it never
shows.  ``fit_Q_SCA(pareto=True)`` runs the same two objectives through
the device-resident NSGA-II (``rrmpg_tpu_torch.tools.moo``) on the real
Alpine catchment of the hysteresis tutorial and returns the entire front:
every front member is a defensible calibration, and the spread quantifies
how much discharge accuracy a snow-cover-faithful model costs (and vice
versa).  On the card each generation is one launch of the fused snow
objective kernel with its snow-cover statistics, and the two end members
are simulated through the fused trajectory kernel.

The Q-axis is multimodal (a second basin at 1-KGE ~ 0.21 catches small
populations); 256 members explore past it reliably.

    python -c "exec(open('examples/torch/09_pareto_front.py').read(), \
{'__file__': 'examples/torch/09_pareto_front.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import os

import numpy as np
import pandas as pd

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.models import CemaneigeHystGR4J
from rrmpg_tpu_torch.utils import calc_kge

ELEVATION = [2277.84423828125, 2641.563720703125, 2845.09521484375,
             3002.329833984375, 3227.36669921875]
MEAN_ELEV = 2798.84033203125

FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


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

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "data", "hyst_ice_input.csv")
    df = pd.read_csv(path, index_col="Date", sep=";", decimal=".",
                     parse_dates=["Date"])
    ndsi = [(0.06 + 1.21 * df[f"NDSI{b}"]).clip(upper=100)
            for b in range(1, 6)]
    common = dict(met_station_height=MEAN_ELEV, altitudes=ELEVATION,
                  s_init=0.5, r_init=0.4, sca_init=0.2,
                  loss_metric="kge")
    met = [df['P'], df['Tmean'], df['Tmin'], df['Tmax'], df['ET0']]

    model = CemaneigeHystGR4J(device=device)
    pop, gens = (32, 10) if FAST else (256, 300)
    res = model.fit_Q_SCA(df["Qmm"], *met, *ndsi, seed=0, pareto=True,
                          pop_size=pop, n_generations=gens, engine=engine,
                          **common)

    f = res.f  # (F, 2): [1-KGE on Q, summed 1-KGE over 5 SCA bands]
    order = np.argsort(f[:, 0])
    f, x = f[order], res.x[order]
    print(f"front: {len(f)} non-dominated members from a "
          f"{res.population.shape[0]}-member population "
          f"({res.nfev} evaluations)")
    print(f"discharge-first end:  1-KGE_Q = {f[0, 0]:.3f}, "
          f"SCA loss = {f[0, 1]:.3f}")
    print(f"snow-first end:       1-KGE_Q = {f[-1, 0]:.3f}, "
          f"SCA loss = {f[-1, 1]:.3f}")

    # Where does the reference's fixed 75/5 blend land on this front?
    blend = 0.75 * f[:, 0] + 0.05 * f[:, 1]
    i = int(np.argmin(blend))
    print(f"scalarized reference blend lands at 1-KGE_Q = {f[i, 0]:.3f}, "
          f"SCA = {f[i, 1]:.3f}")

    # Simulate the two front endpoints and report their discharge KGE.
    kge = []
    for member in (x[0], x[-1]):
        model.set_params(dict(zip(model.get_parameter_names(),
                                  map(float, member))))
        qsim = model.simulate(*met, sca_init=0.2,
                              met_station_height=MEAN_ELEV,
                              altitudes=ELEVATION, s_init=0.5,
                              r_init=0.4, engine=engine)[:, 0]
        kge.append(calc_kge(df["Qmm"].to_numpy(), qsim))
    print(f"discharge KGE along the front: {kge[0]:.3f} (Q-first) .. "
          f"{kge[1]:.3f} (SCA-first)")
    return {"front_size": len(f), "q_first": f[0], "sca_first": f[-1],
            "blend": f[i], "kge_q_first": kge[0], "kge_sca_first": kge[1],
            "nfev": int(res.nfev)}


if __name__ == "__main__":
    main()
