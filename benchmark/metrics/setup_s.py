"""setup_s: process start to the window's first step (host clock)."""


def read(ctx):
    return ctx.setup_s
