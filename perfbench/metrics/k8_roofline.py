"""K8, the coupled snow + GR4J objective (``snow_objective_kernel``),
against its roofline at the cell's chunk."""

from perfbench.census import snow
from perfbench.readers import kernel_roofline


def read(ctx):
    cfg, tr = ctx.plan.config, ctx.plan.traffic
    ops, n_bytes = snow.objective(tr["members"], ctx.run.days,
                                  len(cfg["altitudes"]), cfg["hyst"],
                                  cfg["ice"], tuple(cfg["uh"]), True)
    return kernel_roofline(ctx, lambda n: "snow_objective_kernel<" in n,
                           ops, n_bytes)
