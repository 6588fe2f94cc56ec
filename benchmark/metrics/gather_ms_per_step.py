"""gather_ms_per_step: device time a traced step of the gather whole
(ops/tiled_pm.gather_vec_cl, csrc/gather.cu: the program's span
pm.gather)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.gather")
