"""step_ms: the measured window's wall time over every step completed in
it, the window closed by a device synchronise (host clock)."""


def read(ctx):
    return 1e3 * ctx.window_s / ctx.steps if ctx.steps else None
