"""smoothing_ms_per_step: device time a traced step of the multigrid
smoothing on every level: the red-black sweeps and the scalaron roots
(the program's spans mg.smooth)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "mg.smooth")
