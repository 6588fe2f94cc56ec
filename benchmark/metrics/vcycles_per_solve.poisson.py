"""vcycles_per_solve.poisson: linear multigrid V-cycles per Poisson solve
over the window (pysco_tpu_torch.models.multigrid.STATS, FAS taken
out)."""


def read(ctx):
    s = ctx.stats
    solves = s["solves"] - s["fas_solves"]
    return (s["cycles"] - s["fas_cycles"]) / solves if solves else None
