"""tile_sort_ms_per_step: device time a traced step of the tile sort
whole: tile keys, the CUB radix sort and the permutation (the program's
span pm.sort, around ops/tiled_pm.sort_particles)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.sort")
