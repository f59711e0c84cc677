"""The check the four-card cell rests on: the regional objective on a
2 x 2 mesh of four cards gives, bit for bit, what one card gives on the
same inputs.

    python3 perfbench/meshcheck.py [--catchments 8] [--members 8192]

It builds the regional cell's catchments at a small size, runs
``regional_gr4j_objective`` once without a mesh on ``cuda:0`` and once on
``ensemble_catchment_mesh(2, 2, cuda:0..3)``, for 'kge' (statistics,
masked) and 'mse', and compares the losses with ``torch.equal``.  It also
runs the GR4J trajectory kernel in float64, whose block opts in to more
than 48 KB of shared memory, on every card against ``cuda:0``, and reports
the caller's current device after each mesh call (``--members`` of at
least 2816 make the trajectories' 3 x members exceed 8448).  Prints one
JSON line.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--catchments", type=int, default=8)
    parser.add_argument("--members", type=int, default=8192)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from perfbench.harness import resolve
    from perfbench.loops.regional import make_region
    from rrmpg_tpu_torch import ops
    from rrmpg_tpu_torch.parallel import (ensemble_catchment_mesh,
                                          regional_gr4j_objective)

    if torch.cuda.device_count() < 4:
        sys.exit("the mesh check needs four CUDA devices.")
    plan = resolve("gr4j.regional-mesh4", ROOT)
    cfg, model = plan.config, plan.model
    region = make_region(model.record(cfg), model.water_years(cfg),
                         args.catchments,
                         plan.traffic["gauges_opened_after_years"],
                         np.random.default_rng(args.seed))
    home = torch.device("cuda", 0)
    s = {k: torch.tensor(v, dtype=torch.float32, device=home)
         for k, v in region.items()}
    gen = torch.Generator(device=home)
    gen.manual_seed(args.seed)
    lows, span = model.bounds(cfg, model.PARAMS, home, torch.float32)
    draws = torch.addcmul(lows, span, torch.rand(
        (4, args.members), generator=gen, device=home))
    params = {k: draws[j] for j, k in enumerate(model.PARAMS)}
    mesh = ensemble_catchment_mesh(
        2, 2, devices=[torch.device("cuda", i) for i in range(4)])
    out = {"catchments": args.catchments, "members": args.members,
           "mesh": repr(mesh)}
    for metric in ("kge", "mse"):
        kw = dict(engine="fused", loss_metric=metric, masked=True,
                  num_uh1=cfg["uh"][0], num_uh2=cfg["uh"][1])
        one = regional_gr4j_objective(s["prec"], s["etp"], s["qobs"], 0.0,
                                      0.0, params, **kw)
        four = regional_gr4j_objective(s["prec"], s["etp"], s["qobs"], 0.0,
                                       0.0, params, mesh=mesh, **kw)
        out[metric] = {"bit_equal": bool(torch.equal(one, four)),
                       "max_abs": float((one - four).abs().max()),
                       "current_device": torch.cuda.current_device(),
                       "on": str(four.device)}
    traj = {}
    # Above 8448 members the trajectory kernel runs one member a thread
    # with its 68 KB store tile (float64), the block that needs the opt-in.
    p64 = {k: v.double().repeat(3) for k, v in params.items()}
    prec64, etp64 = s["prec"][0].double(), s["etp"][0].double()
    want = ops.gr4j_simulate_fused(prec64, etp64, 0.0, 0.0, p64, 3, 7)
    for i in range(4):
        dev = torch.device("cuda", i)
        got = ops.gr4j_simulate_fused(
            prec64.to(dev), etp64.to(dev), 0.0, 0.0,
            {k: v.to(dev) for k, v in p64.items()}, 3, 7)
        traj[str(dev)] = bool(torch.equal(got.to(home), want))
    out["float64_trajectories_equal"] = traj
    out["current_device_after"] = torch.cuda.current_device()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
