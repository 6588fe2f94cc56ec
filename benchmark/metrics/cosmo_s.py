"""cosmo_s: seconds of the background tables in set-up (the
program's phase cosmo.generate: the growth ODE solve and the table
write)."""

import program_spans


def read(ctx):
    return program_spans.phase_s("cosmo.generate")
