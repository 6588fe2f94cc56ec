"""The program's own spans, counters and set-up phases
(``pysco_tpu_torch.utils.profiling``) for the per-layer readers.

The program records spans only while a profiler runs, so its store holds
the window's traced steps; a reader takes the last ``ctx.steps`` step
trees (the traced steps), which keeps a stale store from an earlier run
in the same process out of its numbers. A program without spans, or a
store that holds fewer trees, gives no reading."""

from pysco_tpu_torch.utils import profiling


def totals(ctx):
    """``profiling.span_totals`` over the traced steps, or None."""
    read = getattr(profiling, "span_totals", None)
    steps = getattr(ctx, "steps", 0)
    if read is None or not steps:
        return None
    t = read(last_steps=steps)
    return t if t["steps"] == steps else None


def device_ms_per_step(ctx, *names):
    """Device ms a traced step of the spans called ``names`` (0 where none
    of them ran in the traced steps: a lazy stretch may hold no sort)."""
    t = totals(ctx)
    if t is None:
        return None
    spans = t["spans"]
    return sum(spans[n]["device_ms"] for n in names if n in spans) / ctx.steps


def counter_per_step(ctx, name):
    """A counter of the program a traced step (0 where it never counted)."""
    t = totals(ctx)
    return t["counters"].get(name, 0) / ctx.steps if t is not None else None


def outside_step_ms(ctx):
    """Mean stream time between two consecutive traced steps."""
    t = totals(ctx)
    gaps = t["outside_step_ms"] if t is not None else []
    return sum(gaps) / len(gaps) if gaps else None


def phase_s(name):
    """Seconds of a set-up phase (``profiling.PHASES``), or None."""
    return getattr(profiling, "PHASES", {}).get(name)
