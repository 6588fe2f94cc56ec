"""mond_source_ms_per_step: device time a traced step of the QUMOND
source, div[nu(|grad phi_N| / g0) grad phi_N] on each cell's six faces
(the program's span mond.source: models/mond.rhs). None where the
program opens no such span."""

import program_spans

SPAN = "mond.source"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["spans"][SPAN]["device_ms"] / ctx.steps
