"""B1/B2's share of their bytes roofline in the solve cells: the bytes the
traced solves' half-steps need (`gwbench.work.half_steps`: the cost read
once a half-step, the vectors once) over the card's bandwidth, divided by
the device time of the half-step kernels (`kernels/csrc/sinkhorn_step.cu`),
in %."""

#: the kernels of B1 (rows) and B2 (columns and their merge)
KERNELS = ("row_kernel", "col_kernel", "col_finish")


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    t = ctx.trace.device_seconds(KERNELS)
    need = ctx.profiled.get("half_steps")
    if t <= 0.0 or need is None or need.bytes <= 0.0:
        return None
    return 100.0 * need.bytes / ctx.peaks["hbm_bytes_per_s"] / t
