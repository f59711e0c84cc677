"""K5, the regional GR4J objective (``gr4j_regional_kernel``), against its
roofline: each launch is one (member shard, catchment shard) block of the
mesh on one card; the shares of the launches on every card are pooled."""

from perfbench.census import gr4j
from perfbench.readers import kernel_roofline


def read(ctx):
    tr, uh = ctx.plan.traffic, tuple(ctx.plan.config["uh"])
    ens, cat = tr["mesh"]
    stats = tr["loss_metric"] in ("nse", "kge")
    ops, n_bytes = gr4j.objective(tr["members"] // ens, ctx.run.days, uh,
                                  stats, catchments=tr["catchments"] // cat)
    return kernel_roofline(ctx, lambda n: "gr4j_regional_kernel<" in n,
                           ops, n_bytes)
