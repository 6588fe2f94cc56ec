"""fft_ms_per_step: device time of cuFFT's kernels (ops/fourier's
rfftn/irfftn: the Poisson solve, and the P(k) at outputs) over the
traced window's steps."""

import devtrace as tracing


def is_fft(name: str) -> bool:
    return "fft" in name.lower()


def read(ctx):
    sec, calls = tracing.kernel_time(ctx.kernels, is_fft)
    return 1e3 * sec / ctx.steps if calls and ctx.steps else None
