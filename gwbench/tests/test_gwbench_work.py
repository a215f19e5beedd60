"""The counted work (`gwbench.work`) against hand counts at small shapes,
and the whole solve's share of the peak reading the same whatever
implements the solve."""
import importlib.util

import numpy as np
import pytest
import torch

from gwbench import peaks, run, work
from gwbench.record import Context
from gwbench.trace import Summary
from repro_torch.core import GWConfig, Grid1D, Grid2D, entropic_gw

G1 = work.Side("Grid1D", 4)
G1b = work.Side("Grid1D", 6)
G2 = work.Side("Grid2D", 3)


def test_half_steps_bytes_and_flops():
    # row: C (15 × 4 B) + g (5), log μ (3) read, f (3) written; column: C
    # + f (3), log ν (5) read, g (5) written
    w = work.half_steps(3, 5, 1, "float32")
    assert w.bytes == 60 + 4 * (5 + 3 + 3) + 60 + 4 * (3 + 5 + 5)
    assert w.flops == 2 * 4 * 15
    assert work.half_steps(3, 5, 7, "float32").bytes == 7 * w.bytes
    # a bfloat16 cost halves what the half-steps read of C
    assert work.half_steps(3, 5, 1, "float32", "bf16").bytes == w.bytes - 60


@pytest.mark.parametrize("side,power,passes", [
    (G1, 1, [1]), (G1, 2, [2]), (G2, 1, [1, 1]), (G2, 2, [2, 1, 1, 2]),
    (work.Side("Grid2D", 3, 2), 1, [2, 1, 1, 2])])
def test_fgc_passes(side, power, passes):
    assert work.fgc_passes(side, power) == passes


def test_fgc_work_1d():
    # (D∘D)μ and (D∘D)ν: one pass on 4 and on 6 floats; each of 3 products
    # (2 outer steps, the energy): one pass on the 4 × 6 plan a side
    w = work.fgc_work(G1, G1b, 2, "float32")
    assert w.bytes == 2 * 4 * 4 + 2 * 6 * 4 + 3 * 2 * (2 * 24 * 4)
    assert w.flops == (19 * 4 + 19 * 6) + 3 * 2 * 9 * 24


def test_fgc_work_2d():
    # 9 points a side: (D∘D)μ is four passes on 9 floats a side; a product
    # two passes on the 81 entries a side
    w = work.fgc_work(G2, G2, 1, "float64")
    assert w.bytes == 2 * 4 * (2 * 9 * 8) + 2 * 2 * 2 * (2 * 81 * 8)


def test_kernel_iterations():
    w = work.kernel_iterations(3, 5, 2, "float32")
    assert w.bytes == 2 * (2 * 15 * 4 + 3 * 8 * 4)
    assert w.flops == 2 * (4 * 15 + 8)


def test_solve_work_stages():
    st = work.solve_work(G1, G1b, 2, 10, "float32")
    assert set(st) == {"constant", "product", "cost", "plan", "energy",
                       "sinkhorn"}
    assert st["sinkhorn"].bytes == work.half_steps(4, 6, 10,
                                                   "float32").bytes
    # each (M, N) apply reads and writes the plan once
    assert st["product"].bytes == 3 * 2 * (2 * 24 * 4)
    kern = work.solve_work(G1, G1b, 2, 10, "float32", mode="kernel")
    assert kern["sinkhorn"].bytes == 2 * 2 * 24 * 4 + \
        work.kernel_iterations(4, 6, 10, "float32").bytes
    tol = work.solve_work(G1, G1b, 2, 60, "float32", tol=1e-5, chunk=25)
    assert tol["residual"].bytes == 3 * 24 * 4 + 2 * 2 * 24 * 4


def _mfu(answers, side):
    """solve_mfu's reading of a traced stretch of 1 s holding these
    solves."""
    stages = {}
    for outer, inner in answers:
        for k, w in work.solve_work(side, side, outer, inner,
                                    "float64").items():
            stages[k] = stages.get(k, work.Work()) + w
    ctx = Context(kind="closed_solve", trace=Summary({}, 0.5, 1.0, 1, {}),
                  peaks=peaks.H100_SXM, profiled={"solves": len(answers),
                                                  "work": stages})
    path = run.HERE / "metrics" / "solve_mfu.py"
    spec = importlib.util.spec_from_file_location("solve_mfu", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


@pytest.mark.parametrize("grid,side", [(Grid1D(24, 1 / 23), work.Side(
    "Grid1D", 24)), (Grid2D(5, 1 / 4), work.Side("Grid2D", 5))])
def test_solve_mfu_same_for_kernel_and_plain_backends(grid, side):
    rng = np.random.default_rng(3)
    mu = rng.random(grid.size) + 0.05
    nu = rng.random(grid.size) + 0.05
    mu, nu = mu / mu.sum(), nu / nu.sum()
    reads = []
    for backend, sk in (("kernel", "auto"), ("cumsum", "torch"),
                        ("dense", "torch")):
        res = entropic_gw(grid, grid, mu, nu, GWConfig(
            eps=5e-2, outer_iters=3, sinkhorn_iters=20, backend=backend,
            sinkhorn_backend=sk), device="cpu")
        reads.append(_mfu([(res.info.outer_iters, res.info.inner_iters)],
                          side))
    assert reads[0] > 0 and reads[0] == reads[1] == reads[2]


def test_least_seconds_takes_the_larger_bound():
    p = peaks.H100_SXM
    assert peaks.least_seconds(0.0, 3.35e12, p) == pytest.approx(1.0)
    assert peaks.least_seconds(67e12, 0.0, p) == pytest.approx(1.0)
    assert peaks.for_device("NVIDIA H100 80GB HBM3") is p
    assert peaks.for_device("cpu") is None
