"""vcycles_per_solve.fas: FAS V-cycles per f(R) scalaron solve over the
window (pysco_tpu_torch.models.multigrid.STATS)."""


def read(ctx):
    s = ctx.stats
    return s["fas_cycles"] / s["fas_solves"] if s["fas_solves"] else None
