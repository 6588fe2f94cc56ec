"""gradient_ms_per_step: device time a traced step of the force mesh's
gradient (mesh.derivative, derivative_fR: the program's span
pm.gradient)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.gradient")
