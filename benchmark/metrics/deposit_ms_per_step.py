"""deposit_ms_per_step: device time a traced step of the deposit whole:
zeroing, the residue-class launches of csrc/deposit.cu, the folds and
the normalisation (the program's span pm.deposit)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.deposit")
