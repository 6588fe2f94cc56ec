"""pk_bins_s: seconds of the P(k) bin table's build in set-up (the
program's phase pk_bins: the host argsort of the modes by bin)."""

import program_spans


def read(ctx):
    return program_spans.phase_s("pk_bins")
