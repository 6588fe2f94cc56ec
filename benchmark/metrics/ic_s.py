"""ic_s: seconds of the 2LPT initial conditions on the card, the
program's own host clock around a call that ends in a synchronise
(pysco_tpu_torch.ic_device.TIMES["generate_lpt"])."""


def read(ctx):
    return ctx.ic_s
