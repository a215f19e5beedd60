"""The factored (low-rank) plan of the port against the reference on the
CPU: the cold starts and couplings, the Dykstra projection, the factored
gradient operator (plain and fused routes), and ``entropic_gw`` with
``plan="lowrank"`` end to end, static rank and ``"auto"``.  Inputs are made
with numpy from a seed and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import coupling as jcoup
from repro.core import gradient as jgrad
from repro.core import sinkhorn as jsk
from repro.core.geometry import LowRankGeometry as JLR
from repro.core.geometry import PointCloudGeometry as JPC
from repro_torch import convert, core
from repro_torch.core import sinkhorn as sk

# the reference's own cross-backend bar for the factored solve
# (tests/test_lowrank_plan.py): equal counts, factors at rtol 1e-10 and
# atol 1e-12, value at rtol 1e-10
FAC = dict(rtol=1e-10, atol=1e-12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _clustered(n_per, centers, seed):
    r = np.random.default_rng(seed)
    return np.concatenate([c + 0.3 * r.normal(size=(n_per, len(c)))
                           for c in np.asarray(centers, float)])


def _clouds(nx, ny, seed):
    px = _clustered(nx, [[0.0, 0.0], [8.0, 0.0]], seed)
    py = _clustered(ny, [[0.0, 0.0], [0.0, 9.0]], seed + 1)
    return px, py


def _unif(n):
    return np.ones(n) / n


def _pc(p):
    return core.PointCloudGeometry(_t(p))


def _assert_coupling(tc, jc, **tol):
    for name in ("q", "r", "g"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)),
                                   **(tol or FAC))


# ---------------------------------------------------------------------------
# couplings and cold starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["rank2", "kmeans"])
def test_lowrank_init_matches_reference_zero_mass_exact(method):
    px, py = _clouds(10, 12, 3)
    mu = _unif(20)
    mu[-3:] = 0.0
    mu /= mu.sum()
    nu = _unif(24)
    geoms = dict(geom_x=_pc(px), geom_y=_pc(py)) if method == "kmeans" \
        else {}
    jgeoms = dict(geom_x=JPC(jnp.asarray(px)), geom_y=JPC(jnp.asarray(py))) \
        if method == "kmeans" else {}
    tc = core.lowrank_init(_t(mu), _t(nu), 4, method=method, **geoms)
    jc = jcoup.lowrank_init(jnp.asarray(mu), jnp.asarray(nu), 4,
                            method=method, **jgeoms)
    _assert_coupling(tc, jc, rtol=1e-13, atol=1e-15)
    assert float(tc.q[-3:].abs().max()) == 0.0
    np.testing.assert_allclose(tc.q.sum(1).numpy(), mu, atol=1e-14)
    with pytest.raises(ValueError, match="unknown lowrank"):
        core.lowrank_init(_t(mu), _t(nu), 4, method="pca")


def test_kmeans_init_on_low_rank_and_grid_embeddings():
    """k-means seeds from the cost-factor rows and from 1-D grid
    positions, as the reference's; dense matrices have no embedding."""
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(16, 3)), rng.normal(size=(16, 3))
    n = 18
    mu, nu = _unif(16), _unif(n)
    tc = core.lowrank_init(
        _t(mu), _t(nu), 3, method="kmeans",
        geom_x=core.LowRankGeometry(_t(a), _t(b)),
        geom_y=core.as_geometry(core.Grid1D(n, 1 / (n - 1), 1)))
    jc = jcoup.lowrank_init(
        jnp.asarray(mu), jnp.asarray(nu), 3, method="kmeans",
        geom_x=JLR(jnp.asarray(a), jnp.asarray(b)),
        geom_y=jcore.geometry.as_geometry(jcore.Grid1D(n, 1 / (n - 1), 1)))
    _assert_coupling(tc, jc, rtol=1e-13, atol=1e-15)
    with pytest.raises(ValueError, match="kmeans"):
        core.lowrank_init(_t(mu), _t(mu), 3, method="kmeans",
                          geom_x=core.DenseGeometry(torch.eye(16)),
                          geom_y=core.DenseGeometry(torch.eye(16)))


def test_pad_rank_marginals_dense_match_reference():
    mu, nu = _unif(9), _unif(11)
    mu[-2:] = 0.0
    mu /= mu.sum()
    tc = core.lowrank_init(_t(mu), _t(nu), 4).pad_rank(8, _t(mu), _t(nu))
    jc = jcoup.lowrank_init(jnp.asarray(mu), jnp.asarray(nu), 4).pad_rank(
        8, jnp.asarray(mu), jnp.asarray(nu))
    _assert_coupling(tc, jc, rtol=1e-14, atol=0)
    assert tc.rank == 8 and float(tc.q[-2:].abs().max()) == 0.0
    for x, y in zip(tc.marginals(), jc.marginals()):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-14,
                                   atol=1e-16)
    np.testing.assert_allclose(tc.dense().numpy(), np.asarray(jc.dense()),
                               rtol=1e-14, atol=1e-16)
    assert tc.pad_rank(8, _t(mu), _t(nu)) is tc
    sl = tc.slice_to(5, 6)
    assert sl.q.shape == (5, 8) and sl.r.shape == (6, 8)


# ---------------------------------------------------------------------------
# the Dykstra projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters,chunk,tol", [(1, 1, 0.0), (30, 10, 0.0),
                                             (400, 20, 1e-10)])
def test_lr_dykstra_log_matches_reference(iters, chunk, tol):
    """The reference's per-sweep parity cases: equal iteration counts,
    q, r, g and the residual at its own cross-backend bar (rtol 1e-12,
    atol 1e-13)."""
    rng = np.random.default_rng(51)
    m, n, r = 45, 60, 6
    mu = rng.random(m) + 0.1
    nu = rng.random(n) + 0.1
    mu, nu = mu / mu.sum(), nu / nu.sum()
    lk_q, lk_r = rng.normal(size=(m, r)), rng.normal(size=(n, r))
    lk_g = rng.normal(size=r)
    want = jsk.lr_dykstra_log(*(jnp.asarray(x) for x in
                                (lk_q, lk_r, lk_g, mu, nu)),
                              iters, chunk, tol, jnp.log(1e-10),
                              backend="xla")
    got = sk.lr_dykstra_log(*(_t(x) for x in (lk_q, lk_r, lk_g, mu, nu)),
                            iters, chunk, tol,
                            torch.log(torch.tensor(1e-10, dtype=torch.float64)),
                            backend="torch")
    assert got[4] == int(want[4])
    for x, y in zip(got[:4], want[:4]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-12,
                                   atol=1e-13)


# ---------------------------------------------------------------------------
# the factored gradient operator
# ---------------------------------------------------------------------------

def _force_fused(monkeypatch):
    """The fused route (plain B6/B7 on the CPU) on factor pairs."""
    monkeypatch.setattr(
        core.LowRankGradientOperator, "_use_fused",
        lambda self: isinstance(self.geom_x, core.LowRankGeometry)
        and isinstance(self.geom_y, core.LowRankGeometry))


def _operator_case(kind):
    rng = np.random.default_rng(8)
    if kind == "cloud":
        px, py = rng.normal(size=(30, 3)), rng.normal(size=(36, 3))
        return (_pc(px), _pc(py), JPC(jnp.asarray(px)), JPC(jnp.asarray(py)),
                30, 36)
    n = 50
    return (core.Grid1D(n, 1 / (n - 1), 1), core.Grid1D(n, 1 / (n - 1), 1),
            jcore.Grid1D(n, 1 / (n - 1), 1), jcore.Grid1D(n, 1 / (n - 1), 1),
            n, n)


@pytest.mark.parametrize("kind,route", [("cloud", "plain"),
                                        ("cloud", "fused"),
                                        ("grid", "plain")])
def test_lowrank_gradient_operator_matches_reference(kind, route,
                                                     monkeypatch):
    tx, ty, jx, jy, m, n = _operator_case(kind)
    rng = np.random.default_rng(9)
    mu, nu = rng.random(m) + 0.1, rng.random(n) + 0.1
    mu, nu = mu / mu.sum(), nu / nu.sum()
    jc = jcoup.lowrank_init(jnp.asarray(mu), jnp.asarray(nu), 6)
    # move the factors off the cold start so every term is exercised
    jc = jcoup.LowRankCoupling(jc.q * jnp.asarray(rng.random((m, 6)) + 0.5),
                               jc.r * jnp.asarray(rng.random((n, 6)) + 0.5),
                               jc.g)
    tcp = convert.low_rank_coupling(jc.q, jc.r, jc.g, device="cpu")
    if route == "fused":
        _force_fused(monkeypatch)
    jop = jgrad.LowRankGradientOperator(
        jx, jy, lowrank_backend="pallas" if route == "fused" else "xla")
    top = core.LowRankGradientOperator(tx, ty)
    assert top._use_fused() == (route == "fused")
    jd = jop.constant_term(jnp.asarray(mu), jnp.asarray(nu))
    td = top.constant_term(_t(mu), _t(nu))
    for x, y in zip(td, jd):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-13)
    # gradients: sums over the factors' rows, reassociated in ulps
    for x, y in zip(top.grads(tcp, *td), jop.grads(jc, *jd)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-11,
                                   atol=1e-11 * float(np.abs(y).max()))
    np.testing.assert_allclose(float(top.energy(tcp)), float(jop.energy(jc)),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# entropic_gw with plan="lowrank"
# ---------------------------------------------------------------------------

ANNEALED = dict(eps=5e-2, outer_iters=20, tol=1e-6, eps_init=0.5,
                anneal_decay=0.7, sinkhorn_iters=100, plan="lowrank",
                plan_rank=8, lr_gamma=30.0)


@pytest.mark.parametrize("route", ["torch", "fused"])
def test_entropic_gw_lowrank_matches_reference(route, monkeypatch):
    """The reference's annealed cross-backend case: the port's torch route
    against its xla route, the port's fused route (plain B6/B7) against its
    pallas route (interpret mode)."""
    px, py = _clouds(20, 25, 0)
    mu, nu = _unif(40), _unif(50)
    jcfg = jcore.GWConfig(**ANNEALED, lowrank_backend="xla" if route ==
                          "torch" else "pallas")
    want = jcore.entropic_gw(JPC(jnp.asarray(px)), JPC(jnp.asarray(py)),
                             jnp.asarray(mu), jnp.asarray(nu), jcfg)
    if route == "fused":
        _force_fused(monkeypatch)
    cfg = convert.gw_config(dataclasses.asdict(jcfg))
    got = core.entropic_gw(convert.point_cloud_geometry(px, device="cpu"),
                           convert.point_cloud_geometry(py, device="cpu"),
                           mu, nu, dataclasses.replace(cfg,
                                                       lowrank_backend="auto"),
                           device="cpu")
    assert got.plan is None and got.f is None and got.g is None
    assert got.info.outer_iters == int(want.info.outer_iters)
    assert got.info.inner_iters == int(want.info.inner_iters)
    assert got.info.converged == bool(want.info.converged)
    _assert_coupling(got.coupling, want.coupling)
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=1e-10)


def test_entropic_gw_auto_rank_matches_reference():
    """plan_rank="auto" at the reference's own case: the same final rank
    and the same counts accumulated over the restarts."""
    px, py = _clustered(15, [[0.0, 0.0], [8.0, 0.0]], 11), \
        _clustered(15, [[0.0, 0.0], [0.0, 9.0]], 12)
    mu = nu = _unif(30)
    jcfg = jcore.GWConfig(eps=5e-2, outer_iters=60, tol=1e-6, eps_init=0.3,
                          anneal_decay=0.7, sinkhorn_iters=200,
                          plan="lowrank", plan_rank="auto",
                          plan_rank_max=32, lr_gamma=30.0)
    want = jcore.entropic_gw(JPC(jnp.asarray(px)), JPC(jnp.asarray(py)),
                             jnp.asarray(mu), jnp.asarray(nu), jcfg)
    got = core.entropic_gw(_pc(px), _pc(py), mu, nu,
                           convert.gw_config(dataclasses.asdict(jcfg)),
                           device="cpu")
    assert got.coupling.rank == want.coupling.rank
    assert got.info.outer_iters == int(want.info.outer_iters)
    assert got.info.inner_iters == int(want.info.inner_iters)
    assert got.info.converged == bool(want.info.converged)
    np.testing.assert_allclose(float(got.value), float(want.value),
                               rtol=1e-10)


def test_entropic_gw_lowrank_f32_keeps_dtype_and_grids_run():
    px, py = _clouds(8, 9, 5)
    cfg = core.GWConfig(eps=5e-2, outer_iters=3, sinkhorn_iters=20,
                        plan="lowrank", plan_rank=4)
    res = core.entropic_gw(_pc(px.astype(np.float32)),
                           _pc(py.astype(np.float32)),
                           _unif(16).astype(np.float32),
                           _unif(18).astype(np.float32), cfg, device="cpu")
    assert res.coupling.q.dtype == res.value.dtype == torch.float32
    assert np.isfinite(float(res.value))
    n = 20
    grid = core.Grid1D(n, 1 / (n - 1), 1)
    res = core.entropic_gw(grid, grid, _unif(n), _unif(n), cfg, device="cpu")
    assert res.coupling.q.shape == (n, 4) and np.isfinite(float(res.value))


def test_lowrank_configs_rejected_as_in_reference():
    px, py = _clouds(5, 5, 1)
    cfg = core.GWConfig(plan="lowrank", plan_rank=4)
    with pytest.raises(ValueError, match="gamma0"):
        core.entropic_gw(_pc(px), _pc(py), _unif(10), _unif(10), cfg,
                         gamma0=np.ones((10, 10)) / 100, device="cpu")
    for bad in (dict(plan_rank="adaptive"), dict(lowrank_backend="pallas"),
                dict(lowrank_init="pca"), dict(plan="sparse")):
        with pytest.raises(ValueError):
            core.GWConfig(**bad)
    with pytest.raises(ValueError, match="auto"):
        core.gw_init_state(torch.ones(3) / 3, torch.ones(3) / 3,
                           cfg=core.GWConfig(plan="lowrank",
                                             plan_rank="auto"))
    assert convert.gw_config(dataclasses.asdict(jcore.GWConfig(
        lowrank_backend="pallas"))).lowrank_backend == "kernel"
    with pytest.raises(ValueError, match="CUDA"):
        core.entropic_gw(_pc(px), _pc(py), _unif(10), _unif(10),
                         dataclasses.replace(cfg, lowrank_backend="kernel"),
                         device="cpu")
