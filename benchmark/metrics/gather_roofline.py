"""gather_roofline: the gather kernel's (csrc/gather.cu, gather_march)
least time over its measured device time, percent; bytes counted once
per call of ``tiled_pm.gather_vec_cl`` (the program's LAUNCHES counter):
three force components at every particle."""

import devtrace as tracing
import yardstick


def read(ctx):
    sec, _ = tracing.kernel_time(ctx.kernels,
                                 lambda k: "gather_march" in k)
    return yardstick.roofline_pct(
        ctx.launches["gather"], yardstick.gather_bytes(ctx.npart, ctx.n), sec)
