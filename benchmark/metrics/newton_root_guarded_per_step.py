"""newton_root_guarded_per_step: cells a traced step whose three float32
Newton steps left the root's bracket and took the safe root instead, on
every level (the program's device counter newton_root_guarded, counted by
the scalaron sweep kernel). A polish that starts further from the root,
or a state that screens more deeply, raises it. None where the program
opens no span mg.newton_root: a program without it has no guard."""

import program_spans

SPAN = "mg.newton_root"


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    return t["counters"].get("newton_root_guarded", 0) / ctx.steps
