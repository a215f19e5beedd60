"""Serving's share of the card's peak: the least time the counted work of
the requests answered in the window needs (`gwbench.work.solve_work` at
each request's own sizes and reported iterations: no padding, no finished
lanes), divided by the window, in %."""

from gwbench import peaks


def read(ctx):
    served = ctx.window.get("served")
    if ctx.peaks is None or served is None or served.bytes <= 0.0:
        return None
    return 100.0 * peaks.least_seconds(served.flops, served.bytes,
                                       ctx.peaks) / ctx.window["seconds"]
