"""The plain reference (`gwbench.reference`) against the port on small
grids in float64: the same plan, value and counts, on the paths the cells
run (log and kernel modes, a fixed schedule and an annealed one with a
tolerance).  The test imports the port; the reference does not."""
import numpy as np
import pytest
import torch

from gwbench import reference
from repro_torch.core import GWConfig, Grid1D, Grid2D, entropic_gw

CASES = {
    "log-fixed": dict(eps=2e-2, outer_iters=6, sinkhorn_iters=80,
                      sinkhorn_mode="log"),
    "kernel-fixed": dict(eps=5e-2, outer_iters=5, sinkhorn_iters=30,
                         sinkhorn_mode="kernel"),
    "log-annealed": dict(eps=8e-3, outer_iters=20, sinkhorn_iters=300,
                         sinkhorn_mode="log", tol=1e-7, eps_init=5e-2,
                         anneal_decay=0.5),
}


def _measures(size, seed):
    rng = np.random.default_rng(seed)
    u = rng.random((2, size)) + 0.05
    return torch.tensor(u / u.sum(axis=1, keepdims=True))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind,n", [("Grid1D", 64), ("Grid2D", 8)])
def test_reference_matches_the_port(kind, n, case):
    knobs = CASES[case]
    grid = (Grid1D if kind == "Grid1D" else Grid2D)(n, 1.0 / (n - 1), 1)
    mu, nu = _measures(grid.size, n)
    res = entropic_gw(grid, grid, mu, nu, GWConfig(
        backend="cumsum", sinkhorn_backend="torch", **knobs), device="cpu")
    sol = reference.solve(
        reference.Problem(kind, n, kind, n, 1, mu, nu),
        reference.Settings(eps=knobs["eps"],
                           outer_iters=knobs["outer_iters"],
                           sinkhorn_iters=knobs["sinkhorn_iters"],
                           mode=knobs["sinkhorn_mode"],
                           tol=knobs.get("tol", 0.0),
                           eps_init=knobs.get("eps_init"),
                           anneal_decay=knobs.get("anneal_decay", 0.5)))
    assert (sol.outer_iters, sol.inner_iters) == (res.info.outer_iters,
                                                  res.info.inner_iters)
    assert float((res.plan - sol.plan).abs().sum()) < 1e-9
    assert abs(float(res.value) - sol.value) < 1e-10 * abs(sol.value)
    assert reference.energy(reference.Problem(kind, n, kind, n, 1, mu, nu),
                            res.plan) == pytest.approx(float(res.value),
                                                       rel=1e-10)


def test_distance_matrices():
    d = reference.gw.distance("Grid2D", 3, 1, 1, torch.float64, "cpu")
    # points (0, 0) and (2, 1): Manhattan 3 steps of h = 1/2
    assert float(d[0, 2 * 3 + 1]) == pytest.approx(1.5)
    d2 = reference.gw.distance("Grid1D", 5, 1, 2, torch.float64, "cpu")
    assert float(d2[0, 4]) == pytest.approx(1.0)
