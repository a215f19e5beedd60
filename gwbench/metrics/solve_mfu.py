"""The whole solve's share of the card's peak: the least time the traced
solves' counted work needs (`gwbench.work.solve_work`; the larger of its
float32 operations over the peak rate and its bytes over the peak
bandwidth), divided by the traced stretch's wall, in %."""

from gwbench import peaks, work


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    stages = ctx.profiled.get("work")
    if not stages or ctx.trace.window_s <= 0.0:
        return None
    w = work.total(stages)
    return 100.0 * peaks.least_seconds(w.flops, w.bytes, ctx.peaks) \
        / ctx.trace.window_s
