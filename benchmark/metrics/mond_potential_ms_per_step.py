"""mond_potential_ms_per_step: device time a traced step of QUMOND's
second Poisson solve, the potential from the QUMOND source, multigrid
from the previous step's potential rescaled by the growth (the program's
span mond.potential). None where the program opens no such span."""

import program_spans

SPAN = "mond.potential"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["spans"][SPAN]["device_ms"] / ctx.steps
