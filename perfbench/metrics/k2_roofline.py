"""K2, the GR4J statistics objective over one member a thread
(``gr4j_objective_kernel``), against its roofline at the cell's chunk."""

from perfbench.census import gr4j
from perfbench.readers import kernel_roofline


def read(ctx):
    tr, uh = ctx.plan.traffic, tuple(ctx.plan.config["uh"])
    ops, n_bytes = gr4j.objective(tr["members"], ctx.run.days, uh, True)
    return kernel_roofline(ctx, lambda n: "gr4j_objective_kernel<" in n,
                           ops, n_bytes)
