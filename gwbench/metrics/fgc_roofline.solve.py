"""B3's share of its bytes roofline in the solve cells: the bytes the
traced solves' D̃ passes need (`gwbench.work.fgc_work`: each pass reads
and writes its array once) over the card's bandwidth, divided by the device
time of the FGC scan kernels (`kernels/csrc/fgc_scan.cu`), in %."""

#: B3's two kernels: the segment pass and the carry between segments
KERNELS = ("scan_pass", "scan_carry")


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    t = ctx.trace.device_seconds(KERNELS)
    need = ctx.profiled.get("fgc")
    if t <= 0.0 or need is None or need.bytes <= 0.0:
        return None
    return 100.0 * need.bytes / ctx.peaks["hbm_bytes_per_s"] / t
