"""GR4J on a CAMELS basin: the inputs the benchmark makes, the program's
entry points it calls, and the plain reference that judges them.

The forcing is read once through the program's own CAMELS loader (pandas,
no device work) and handed to both sides: the program gets it as tensors
in the configuration's dtype, the reference the same values in float64.
"""

import numpy as np
import torch

from perfbench.census import gr4j as census
from perfbench.reference import gr4j as reference
from perfbench.reference import losses

PARAMS = reference.PARAMS

# The program's entry that each loop kind's timed path reaches: (module,
# attribute, {positional series: time axis}); ``perfbench/faults.py``
# plants its faults there.
ENTRIES = {
    "mc": ("rrmpg_tpu_torch.ops", "gr4j_ensemble_mse_fused",
           {0: 0, 1: 0, 2: 0}),
    "fit": ("rrmpg_tpu_torch.models.gr4j", "gr4j_ensemble_mse_fused",
            {0: 0, 1: 0, 2: 0}),
    "regional": ("rrmpg_tpu_torch.ops.fused_gr4j",
                 "gr4j_regional_objective_fused", {0: 1, 1: 1, 2: 1}),
}


def dtype_of(cfg):
    return getattr(torch, cfg["dtype"])


def record(cfg):
    """The basin's whole record as float64 arrays, keyed as the
    configuration's ``forcing`` names them."""
    from rrmpg_tpu_torch.data import CAMELSLoader

    frame = CAMELSLoader().load_basin(cfg["basin"])
    return {key: frame[column].to_numpy(np.float64)
            for key, column in cfg["forcing"].items()}


def bounds(cfg, names, device, dtype):
    """(P, 1) lower bounds and widths of the members' uniform draws."""
    lo_hi = torch.tensor([cfg["bounds"][k] for k in names],
                         dtype=torch.float64)
    lows = lo_hi[:, 0:1].to(device=device, dtype=dtype)
    return lows, (lo_hi[:, 1:2] - lo_hi[:, 0:1]).to(device=device,
                                                    dtype=dtype)


class Objective:
    """The fused GR4J objective over the first ``days`` days of the
    record: the program's K1/K2 wrapper and the reference's time means."""

    params = PARAMS

    def __init__(self, cfg, days, device):
        self.cfg, self.uh = cfg, tuple(cfg["uh"])
        dtype = dtype_of(cfg)
        full = record(cfg)
        self.days = len(full["qobs"][:days])
        self.series = {k: torch.tensor(v[:days], dtype=dtype, device=device)
                       for k, v in full.items()}
        self.qobs = self.series["qobs"]
        self.masked = bool(torch.isnan(self.qobs).any())
        self.lows, self.span = bounds(cfg, PARAMS, device, dtype)

    def program_stats(self, params):
        from rrmpg_tpu_torch import ops

        s = self.series
        return ops.gr4j_ensemble_mse_fused(
            s["prec"], s["etp"], s["qobs"], self.cfg["s_init"],
            self.cfg["r_init"], params, num_uh1=self.uh[0],
            num_uh2=self.uh[1], stats=True, masked=self.masked)

    def reference_stats(self, params, dtype=torch.float64):
        """(4, M) time means of (M,) float64 ``params`` by the reference,
        computed in ``dtype`` on the host from the program's inputs."""
        s = {k: v.to("cpu", torch.float64).to(dtype)
             for k, v in self.series.items()}
        p = {k: v.to(dtype) for k, v in params.items()}
        return reference.objective_stats(
            s["prec"], s["etp"], s["qobs"], p, self.cfg["s_init"],
            self.cfg["r_init"], *self.uh)

    def member_day_ops(self):
        return census.member_day_ops(self.uh, True)


def water_years(cfg):
    """The hydrological year (October to September) of each day of the
    record."""
    from rrmpg_tpu_torch.data import CAMELSLoader

    index = CAMELSLoader().load_basin(cfg["basin"]).index
    return np.asarray(index.year + (index.month >= 10), np.int64)


def as_program_input(array, cfg):
    """The float64 values the program sees of ``array``: rounded to the
    configuration's dtype."""
    return torch.tensor(array, dtype=dtype_of(cfg)).to(torch.float64)


class Fit:
    """``GR4J.fit`` on the whole record with the fused engine, and the
    reference's loss of the parameters it returns."""

    def __init__(self, cfg, traffic, device):
        from rrmpg_tpu_torch.models import GR4J

        if traffic["loss_metric"] != "mse":
            raise ValueError("the GR4J fit cell's reference judges 'mse'.")
        self.cfg = cfg
        days = traffic.get("days")
        self.rec = {k: v[:days] for k, v in record(cfg).items()}
        self.days = len(self.rec["qobs"])
        self.model = GR4J(device=device, dtype=dtype_of(cfg))
        self.kw = dict(s_init=cfg["s_init"], r_init=cfg["r_init"],
                       loss_metric=traffic["loss_metric"], engine="fused",
                       popsize=traffic["popsize"], maxiter=traffic["maxiter"],
                       tol=traffic["tol"], polish=traffic["polish"])
        self.pop_size = traffic["popsize"] * len(PARAMS)

    def run(self, seed):
        r = self.rec
        return self.model.fit(r["qobs"], r["prec"], r["etp"], seed=seed,
                              **self.kw)

    def reference_mse(self, xs, dtype=torch.float64):
        """The reference's mean squared error of each row of the (M, 4)
        float64 parameter rows ``xs``, in ``dtype``."""
        s = {k: as_program_input(v, self.cfg).to(dtype)
             for k, v in self.rec.items()}
        params = {k: xs[:, j].to(dtype) for j, k in enumerate(PARAMS)}
        stats = reference.objective_stats(
            s["prec"], s["etp"], s["qobs"], params, self.cfg["s_init"],
            self.cfg["r_init"], *self.cfg["uh"])
        return stats[0]

    def member_day_ops(self):
        return census.member_day_ops(tuple(self.cfg["uh"]), False)


class Regional:
    """The regional GR4J objective on a (ensemble, catchment) mesh over
    (C, T) catchment series, and the reference's losses of single
    (catchment, member) pairs."""

    params = PARAMS

    def __init__(self, cfg, traffic, series, devices):
        from rrmpg_tpu_torch.parallel import ensemble_catchment_mesh

        self.cfg, self.uh = cfg, tuple(cfg["uh"])
        self.loss_metric = traffic["loss_metric"]
        dtype = dtype_of(cfg)
        home = devices[0]
        self.series = {k: torch.tensor(v, dtype=dtype, device=home)
                       for k, v in series.items()}
        ens, cat = traffic["mesh"]
        self.mesh = ensemble_catchment_mesh(ens, cat, devices=list(devices))
        self.lows, self.span = bounds(cfg, PARAMS, home, dtype)

    def program_losses(self, params):
        from rrmpg_tpu_torch.parallel import regional_gr4j_objective

        s = self.series
        return regional_gr4j_objective(
            s["prec"], s["etp"], s["qobs"], self.cfg["s_init"],
            self.cfg["r_init"], params, mesh=self.mesh, engine="fused",
            loss_metric=self.loss_metric, masked=True, num_uh1=self.uh[0],
            num_uh2=self.uh[1])

    def reference_losses(self, catchment, params, dtype=torch.float64):
        """The reference's loss of member ``params`` (dict of (M,) float64)
        on catchment ``catchment`` ((M,) indices), computed in ``dtype`` on
        the host from the program's inputs."""
        s = {k: v.to("cpu", torch.float64)[catchment].T.to(dtype)
             for k, v in self.series.items()}
        p = {k: v.to(dtype) for k, v in params.items()}
        stats = reference.objective_stats(
            s["prec"], s["etp"], s["qobs"], p, self.cfg["s_init"],
            self.cfg["r_init"], *self.uh)
        if self.loss_metric == "mse":
            return stats[0]
        return 1.0 - losses.scores(stats, s["qobs"])[self.loss_metric]

    def member_day_ops(self):
        return census.member_day_ops(
            self.uh, self.loss_metric in ("nse", "kge"))
