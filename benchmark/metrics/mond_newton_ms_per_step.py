"""mond_newton_ms_per_step: device time a traced step of QUMOND's
Newtonian potential: its source 1.5 a Om_m (rho - 1) and its Poisson
solve, multigrid from the previous step's potential (the program's span
mond.newton). None where the program opens no such span."""

import program_spans

SPAN = "mond.newton"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["spans"][SPAN]["device_ms"] / ctx.steps
