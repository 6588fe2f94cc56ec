"""newton_root_ms_per_step: device time a traced step of the Newton
scalaron roots: the colour updates of every Newton-root smoothing call on
every level, without the pack and unpack around them (the program's span
mg.newton_root: the scalaron sweep kernel of csrc/scalaron_sweep.cu, its
guard and its guarded cells' roots included). None where the program
opens no such span."""

import program_spans

SPAN = "mg.newton_root"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["spans"][SPAN]["device_ms"] / ctx.steps
