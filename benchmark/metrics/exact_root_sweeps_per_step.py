"""exact_root_sweeps_per_step: exact-root colour updates a traced step,
on every level (the program's counter exact_root_sweeps, 2 a red-black
sweep). None where the program opens no span mg.exact_root: a program
without it counts n = 2's updates nowhere."""

import program_spans

SPAN = "mg.exact_root"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["counters"].get("exact_root_sweeps", 0) / ctx.steps
