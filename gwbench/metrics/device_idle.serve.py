"""The device's idle share over the traced stretch of serving: 1 − (the
union of the device operations' intervals / the stretch's wall), in %."""


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
