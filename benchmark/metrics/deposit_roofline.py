"""deposit_roofline: the deposit kernel's (csrc/deposit.cu,
deposit_tiles) least time over its measured device time, percent. A deposit is
several launches, one per residue class of tiles; its bytes are counted
once per call of ``tiled_pm.deposit`` (the program's LAUNCHES counter):
all particles on the whole grid."""

import devtrace as tracing
import yardstick


def read(ctx):
    sec, _ = tracing.kernel_time(ctx.kernels,
                                 lambda k: "deposit_tiles" in k)
    return yardstick.roofline_pct(
        ctx.launches["deposit"], yardstick.deposit_bytes(ctx.npart, ctx.n),
        sec)
