"""host_syncs_per_step: the step's fetches of device values to the host
a traced step (the program's counter host_syncs: the multigrid's
per-cycle residual and the solves' tolerances); the loop's own
diagnostics fetch is not counted."""

import program_spans


def read(ctx):
    return program_spans.counter_per_step(ctx, "host_syncs")
