"""scalaron_sweep_roofline: share of the Newton scalaron sweeps' least
time in their device time, percent. A colour update's least time is its
bytes over the card's 3.35 TB/s (``yardstick.scalaron_sweep_bytes``: the
other colour, this colour and h^2 b in, this colour out, and the FAS
coefficient plane in on the coarse levels), at its level's grid size.
Each span mg.newton_root of the traced steps gives its level and, in its
record, its colour updates (counter newton_root_sweeps); the time is the
spans' device time, the launch gaps of the small coarse levels included.
None where the program opens no such span or records no colour updates
in it."""

import program_spans
import yardstick

SPAN = "mg.newton_root"
SWEEPS = "newton_root_sweeps"


def read(ctx):
    if program_spans.totals(ctx) is None:
        return None
    from pysco_tpu_torch.utils import profiling

    recs = profiling.span_records()
    roots = [r for r in recs if r["name"] == "step" and r["parent"] is None]
    steps = {r["step"] for r in roots[len(roots) - ctx.steps:]}
    spans = [r for r in recs if r["name"] == SPAN and r["step"] in steps]
    if not spans or any(not (r.get("counters") or {}).get(SWEEPS)
                        or r["level"] is None for r in spans):
        return None
    moved = sum(r["counters"][SWEEPS] * yardstick.scalaron_sweep_bytes(
        ctx.n >> r["level"], r["level"] > 0) for r in spans)
    seconds = sum(r["device_ms"] for r in spans) / 1e3
    return yardstick.roofline_pct(1, moved, seconds)
