"""field_solve_ms_per_step: device time a traced step of the field solve:
the extra field (the f(R) scalaron's FAS sources and solve), the Poisson
rhs and its FFT or multigrid solve, without P(k) and the gradient (the
program's span pm.solve)."""

import program_spans


def read(ctx):
    return program_spans.device_ms_per_step(ctx, "pm.solve")
