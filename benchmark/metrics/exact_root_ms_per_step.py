"""exact_root_ms_per_step: device time a traced step of the exact scalaron
roots: the colour updates of every exact-root smoothing call on every
level, without the pack and unpack around them (the program's span
mg.exact_root: the n = 1 sweep kernel, the n = 2 float64 torch passes).
None where the program opens no such span."""

import program_spans

SPAN = "mg.exact_root"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["spans"][SPAN]["device_ms"] / ctx.steps
