"""K1, the GR4J squared-error objective of a calibration's population
(``gr4j_objective_split_kernel``: production and routing in separate
warps), against its roofline.  The roofline counts no serial latency, so
a population of 60 members reads near 0."""

from perfbench.census import gr4j
from perfbench.readers import kernel_roofline


def read(ctx):
    tr, uh = ctx.plan.traffic, tuple(ctx.plan.config["uh"])
    members = tr["popsize"] * len(ctx.plan.model.PARAMS)
    stats = tr["loss_metric"] in ("nse", "kge")
    ops, n_bytes = gr4j.objective(members, ctx.run.days, uh, stats)
    return kernel_roofline(ctx, lambda n: "gr4j_objective_split_kernel<" in n,
                           ops, n_bytes)
