"""Large-scale sharded ensembles on a device mesh.

The PyTorch port's counterpart of ``examples/04_large_scale_ensembles.py``.
Demonstrates what has no counterpart in the reference package:

* a Monte-Carlo sweep sharded over a device mesh,
* device-side parameter sampling from a ``torch.Generator``,
* a fused-kernel calibration on the mesh (one launch of the fused GR4J
  objective a shard and generation) with checkpoint/resume,
* regional mode: a parameter ensemble crossed with many catchments on a
  2-D (ensemble, catchment) mesh.

On the card the mesh is ``default_mesh()``: every visible GPU, one shard
each.  ``--device cpu`` builds the mesh from CPU shards
(``default_mesh(['cpu'] * 4)``), which behave like four devices.  The
Monte-Carlo and the regional run are the plain ``ops.run_gr4j`` on every
shard, as the JAX example's are; the calibration is fused on the card.

    python -c "exec(open('examples/torch/04_large_scale_ensembles.py').read(), \
{'__file__': 'examples/torch/04_large_scale_ensembles.py', '__name__': \
'__main__'})" --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from rrmpg_tpu_torch.config import resolve_device
from rrmpg_tpu_torch.models import GR4J
from rrmpg_tpu_torch.ops import run_gr4j
from rrmpg_tpu_torch.parallel import (
    default_mesh,
    ensemble_catchment_mesh,
    ensemble_objective,
    regional_run,
)

CPU_SHARDS = 4   # shards of a CPU mesh (--device cpu)

FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (every visible GPU, the fused "
                        "kernels) or 'cpu' (CPU shards, plain PyTorch)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    engine = "fused" if device.type == "cuda" else "scan"
    devices = None if device.type == "cuda" else [device] * CPU_SHARDS
    mesh = default_mesh(devices)
    n_dev = mesh.size
    print(f"devices: {[str(d) for d in mesh.devices.ravel()]}")
    rng = np.random.default_rng(0)

    T = 731 if FAST else 3651
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    model = GR4J(device=device)

    def tensor(a):
        return torch.as_tensor(a, dtype=model.dtype, device=device)

    qobs = run_gr4j(tensor(prec), tensor(etp), 0.3, 0.3,
                    {k: tensor([v]) for k, v in truth.items()})[0][0]
    qobs = qobs.cpu().numpy()

    # --- sharded Monte Carlo with device-side sampling ---
    n = 4096 if FAST else 65_536
    generator = torch.Generator(device=device).manual_seed(0)
    params = model.sample_params(generator, n)
    losses, best_idx, best_loss = ensemble_objective(
        run_gr4j, (prec, etp, 0.3, 0.3), params, qobs, mesh)
    best = {k: float(v[best_idx]) for k, v in params.items()}
    print(f"MC {n} members: best MSE {float(best_loss):.4f} at "
          f"{ {k: round(v, 1) for k, v in best.items()} }")

    # --- calibration on the mesh, with checkpointing ---
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "gr4j_fit.npz")
        res = model.fit(qobs, prec, etp, seed=0, engine=engine, tol=1e-4,
                        maxiter=10 if FAST else 1000, mesh=mesh,
                        checkpoint_path=ckpt, checkpoint_every=25)
        saved = os.path.exists(ckpt)
    print(f"DE ({engine}, {n_dev} shard(s)): fun={res.fun:.2e} "
          f"nit={res.nit} x={np.round(res.x, 2)}  (checkpointed: {saved})")

    # --- regional mode: ensemble x catchments on a 2-D mesh ---
    mesh2 = ensemble_catchment_mesh(ensemble=max(n_dev // 2, 1),
                                    catchment=2 if n_dev > 1 else 1,
                                    devices=devices)
    C, N = (4, 128) if FAST else (8, 512)
    precs = tensor(rng.uniform(0, 15, (C, T)))
    etps = tensor(rng.uniform(0, 4, (C, T)))
    ens = model.sample_params(torch.Generator(device=device).manual_seed(1),
                              N)
    qsim, _, _ = regional_run(
        lambda p, e, pa: run_gr4j(p, e, 0.2, 0.2, pa), (precs, etps),
        ens, mesh=mesh2)
    print(f"regional: {C} catchments x {N} members on a "
          f"{mesh2.shape} mesh -> qsim {tuple(qsim.shape)}")
    return {"mc_best_mse": float(best_loss), "mc_best": best,
            "fit_fun": float(res.fun), "fit_nit": int(res.nit),
            "fit_x": np.asarray(res.x), "checkpointed": saved,
            "regional_shape": tuple(qsim.shape),
            "regional_finite": bool(torch.isfinite(qsim).all())}


if __name__ == "__main__":
    main()
