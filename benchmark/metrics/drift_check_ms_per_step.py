"""drift_check_ms_per_step: device time a traced step of the lazy
steps' drift-bound count (the program's span pm.drift_check, around
ops/tiled_pm.drift_violations)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.drift_check")
