"""outside_step_ms_per_step: mean stream time between two consecutive
traced steps of one traced stretch, from the CUDA event at the end of a
step span to the one at the start of the next: the card waits on the
driving loop (the diagnostics fetch, dt, P(k) writes, restarts)."""

import program_spans


def read(ctx):
    return program_spans.outside_step_ms(ctx)
