"""sort_ms_per_step: device time of the radix-sort kernels (the tile
sort's torch.sort, ops/tiled_pm.sort_particles) over the traced window's
steps."""

import devtrace as tracing


def is_sort(name: str) -> bool:
    return "RadixSort" in name or "radixSort" in name


def read(ctx):
    sec, calls = tracing.kernel_time(ctx.kernels, is_sort)
    return 1e3 * sec / ctx.steps if calls and ctx.steps else None
