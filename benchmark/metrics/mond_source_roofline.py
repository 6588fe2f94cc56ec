"""mond_source_roofline: share of the QUMOND source's least time in its
device time, percent. The least time of one call is its bytes over the
card's 3.35 TB/s: the float32 potential read once and the float32 source
written once, 8 n^3 bytes, whatever the passes in between re-read. The
time is the program's span mond.source, a call at a time. None where the
program opens no such span."""

import program_spans
import yardstick

SPAN = "mond.source"


def source_bytes(n: int) -> int:
    """models/mond.rhs, one call: phi_N in, the source out, n^3 float32
    each."""
    return 2 * yardstick.F32 * n ** 3


def read(ctx):
    t = program_spans.totals(ctx)
    if t is None or SPAN not in t["spans"]:
        return None
    span = t["spans"][SPAN]
    return yardstick.roofline_pct(span["calls"], source_bytes(ctx.n),
                                  span["device_ms"] / 1e3)
