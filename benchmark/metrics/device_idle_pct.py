"""device_idle_pct: the share of the traced stretches of the window in
which no operation ran on the card, percent: 1 - (union of device
activity) / their wall time. The profiler's own callbacks slow the host
in them: the run's ``traced_step_s`` beside ``plain_step_s`` says by how
much."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_s) if ctx.traced_s else None
