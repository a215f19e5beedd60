"""The engine's useful share of the inner lane-iterations it ran: the
program's counters `GWEngine.stats` ``useful_inner / executed_inner`` over
the window (lanes run in lockstep, so a batch pays its slowest lane's
sweeps on every lane, padding and finished lanes included), in %."""


def read(ctx):
    stats = ctx.window.get("stats") or {}
    if ctx.kind != "serve" or not stats.get("executed_inner"):
        return None
    return 100.0 * stats["useful_inner"] / stats["executed_inner"]
