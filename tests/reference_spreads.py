"""The reference's own spread between its backends on the cases whose
bars in the port's parity tests are that spread, and the port's distance
from it, on the CPU in float64:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/reference_spreads.py [case ...]

Cases: ``coot`` (tests/test_coot.py:39: two grids, uniform marginals),
``bary_adaptive`` (tests/test_solver.py:341), ``bary_plans``
(tests/test_barycenter.py:16 and Run M's controls annealed),
``grad_3d`` (the factored gradient on random 3-D clouds; the card's side
is tools/grad_spread_3d.py), ``coot_symmetry`` (COOT on Grid1D(512)
distances, uniform against random marginals, the port's cumsum, scan and
grid-less routes) and ``grid_bias`` (sliced GW's grid method against the
sorted one, on Gaussian and on bounded box clouds of 2000 and 2·10⁴
points; minutes).  Not a test: pytest does not collect it."""
import itertools
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)

from repro import core as J  # noqa: E402
from repro.core import coot as jcoot  # noqa: E402
from repro.core.geometry import PointCloudGeometry as JPC  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import coot as tcoot  # noqa: E402


def measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def uniform(n):
    return np.full(n, 1.0 / n)


def dbar_apart(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max())


def coot():
    n, m = 20, 25
    gx, gy = J.Grid1D(n, 1 / (n - 1), 1), J.Grid1D(m, 1 / (m - 1), 1)
    x, y = np.asarray(gx.dist_matrix()), np.asarray(gy.dist_matrix())
    marg = [uniform(k) for k in (n, m, n, m)]
    plans = {}
    for be in ("cumsum", "scan", "dense", "pallas", "none"):
        grids = {} if be == "none" else dict(grid_x=gx, grid_y=gy)
        cfg = jcoot.COOTConfig(outer_iters=6, sinkhorn_iters=150,
                               backend="cumsum" if be == "none" else be)
        plans["ref " + be] = np.asarray(jcoot.entropic_coot(
            *(jnp.asarray(a) for a in (x, y, *marg)), cfg, **grids)[0])
    tx, ty = T.Grid1D(n, 1 / (n - 1), 1), T.Grid1D(m, 1 / (m - 1), 1)
    for be in ("cumsum", "scan", "dense"):
        plans["port " + be] = tcoot.entropic_coot(
            x, y, *marg, tcoot.COOTConfig(outer_iters=6, sinkhorn_iters=150,
                                          backend=be),
            grid_x=tx, grid_y=ty, device="cpu")[0].numpy()
    for a, b in itertools.combinations(plans, 2):
        print(f"coot ‖Δπ_s‖_F {a} / {b}: "
              f"{np.linalg.norm(plans[a] - plans[b]):.3e}")


def _bary(fields, grids, measures_, weights, mu_bar, backends, port=True):
    out = {}
    for be in backends:
        d, p = J.gw_barycenter([J.Grid1D(g.n, g.h, g.k) for g in grids],
                               [jnp.asarray(v) for v in measures_], weights,
                               jnp.asarray(mu_bar),
                               J.BarycenterConfig(backend=be, **fields))
        out["ref " + be] = (np.asarray(d), [np.asarray(x) for x in p])
    if port:
        d, p = T.gw_barycenter(grids, measures_, weights, mu_bar,
                               T.BarycenterConfig(**fields), device="cpu")
        out["port cumsum"] = (d.numpy(), [x.numpy() for x in p])
    return out


def _print_bary(label, out):
    for a, b in itertools.combinations(out, 2):
        plans = max(np.linalg.norm(x - y)
                    for x, y in zip(out[a][1], out[b][1]))
        print(f"{label} {a} / {b}: D̄ {dbar_apart(out[a][0], out[b][0]):.3e}"
              f", plans ‖Δ‖_F {plans:.3e}")


def bary_adaptive():
    grids = [T.Grid1D(20, 1 / 19, 1), T.Grid1D(25, 1 / 24, 1)]
    _print_bary("barycenter :341", _bary(
        dict(eps=5e-3, outer_iters=3, gw_iters=10, sinkhorn_iters=200,
             tol=1e-6), grids, [measures(20, 16), measures(25, 17)],
        [0.5, 0.5], np.full(22, 1 / 22.),
        ("cumsum", "scan", "dense", "pallas")))


def bary_plans():
    grids = [T.Grid1D(20, 1 / 19, 1), T.Grid1D(25, 1 / 24, 1)]
    _print_bary("barycenter :16", _bary(
        dict(eps=5e-3, outer_iters=3, gw_iters=3, sinkhorn_iters=100),
        grids, [measures(20, 0), measures(25, 1)], [0.5, 0.5],
        np.full(22, 1 / 22.), ("cumsum", "scan", "dense", "pallas")))
    sizes = (16, 20, 24)
    _print_bary("barycenter annealed", _bary(
        dict(eps=5e-3, outer_iters=3, gw_iters=5, sinkhorn_iters=100,
             tol=1e-6, eps_init=5e-2),
        [T.Grid1D(s, 1 / (s - 1), 1) for s in sizes],
        [measures(s, 60 + i) for i, s in enumerate(sizes)], [0.5, 0.3, 0.2],
        np.full(24, 1 / 24.), ("cumsum", "scan", "dense", "pallas")))


def grad_3d():
    m, n = 300, 260
    mu, nu = measures(m, 3), measures(n, 4)
    px = np.random.default_rng(5).normal(size=(m, 3))
    py = np.random.default_rng(6).normal(size=(n, 3))
    grads = {}
    for be in ("xla", "pallas"):
        cfg = J.GWConfig(eps=5e-2, tol=1e-10, outer_iters=100,
                         sinkhorn_iters=400, plan="lowrank", plan_rank=6,
                         lr_gamma=5.0, lowrank_backend=be)

        def value(pts, mu_):
            return J.entropic_gw(JPC(pts), JPC(jnp.asarray(py)), mu_,
                                 jnp.asarray(nu), cfg).value
        grads[be] = [np.asarray(g) for g in jax.jit(jax.grad(
            value, argnums=(0, 1)))(jnp.asarray(px), jnp.asarray(mu))]
    for k, name in enumerate(("points", "mu")):
        a, b = grads["pallas"][k], grads["xla"][k]
        print(f"3-D gradient, reference pallas / xla, in {name}: "
              f"{np.abs(a - b).max() / np.abs(b).max():.3e}")


def coot_symmetry():
    n = 512
    g = T.Grid1D(n, 1 / (n - 1), 1)
    x = g.dist_matrix().numpy()
    for label, marg in (("uniform", [uniform(n)] * 4),
                        ("random", [measures(n, s) for s in (1, 2, 3, 4)])):
        res = {}
        for be in ("cumsum", "scan", "none"):
            grids = {} if be == "none" else dict(grid_x=g, grid_y=g)
            res[be] = tcoot.entropic_coot(
                x, x, *marg, tcoot.COOTConfig(
                    outer_iters=10, sinkhorn_iters=100,
                    backend="cumsum" if be == "none" else be),
                device="cpu", **grids)
        for be in ("scan", "none"):
            l1 = float((res["cumsum"][0] - res[be][0]).abs().sum()
                       + (res["cumsum"][1] - res[be][1]).abs().sum())
            print(f"COOT Grid1D({n}) {label} marginals, port cumsum / {be}:"
                  f" plans L1 {l1:.3e}")


def grid_bias():
    def gauss(n, seed, scale=1.0):
        return np.random.default_rng(seed).standard_normal((n, 3)) \
            * np.array([1.0, 2.0, 3.0]) * scale

    def box(n, seed, scale=1.0):
        return (np.random.default_rng(seed).random((n, 3)) - 0.5) \
            * np.array([1.0, 2.0, 3.0]) * scale

    for name, make, sizes in (("gaussian", gauss, (2000, 20_000)),
                              ("box", box, (2000, 20_000))):
        for n in sizes:
            ga = T.PointCloudGeometry(torch.tensor(make(n, 1)))
            gb = T.PointCloudGeometry(torch.tensor(make(n, 2, 1.3)))
            t0 = time.perf_counter()
            grid = T.sliced_gw(ga, gb, n_proj=4, method="grid", grid_n=512,
                               device="cpu")
            srt = T.sliced_gw(ga, gb, n_proj=4, device="cpu")
            print(f"sliced grid / sorted, {name} clouds of {n}: "
                  f"{(grid.profile / srt.profile).numpy().round(3)} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)


CASES = dict(coot=coot, bary_adaptive=bary_adaptive, bary_plans=bary_plans,
             grad_3d=grad_3d, coot_symmetry=coot_symmetry,
             grid_bias=grid_bias)

if __name__ == "__main__":
    for case in sys.argv[1:] or CASES:
        CASES[case]()
