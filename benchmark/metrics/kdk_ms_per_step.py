"""kdk_ms_per_step: device time a traced step of the step's own eager
passes: the program's spans step.kick_drift (first half kick, drift,
periodic wrap) and step.close (closing half kick, diagnostics)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "step.kick_drift",
                                            "step.close")
