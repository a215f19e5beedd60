"""Kernel launches a solve: the kernels the device ran in the traced
stretch's whole solves, over those solves.  Layer: the solve driver
(`core/gw.py`, `core/solver.py`), whose host loop issues every launch."""


def read(ctx):
    solves = ctx.profiled.get("solves", 0)
    if ctx.trace is None or not solves or not ctx.trace.launches:
        return None
    return ctx.trace.launches / solves
