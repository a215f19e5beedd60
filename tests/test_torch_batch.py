"""Batched solves: the port's ``entropic_gw_batch`` against the reference's
and against its own ``entropic_gw``, on the CPU.  The cases replay the
reference's batch tests (tests/test_gw_batch.py, tests/test_geometry.py,
tests/test_solver.py, tests/test_lowrank_plan.py) at their own bars, plus
segmented solves and a reference ``resume_state`` continued in the port.
Inputs are made with numpy from a seed and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core.geometry import LowRankGeometry as JLR
from repro.core.geometry import PointCloudGeometry as JPC
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, core

CFG = dict(eps=2e-3, outer_iters=6, sinkhorn_iters=120, backend="cumsum")
# the reference's bars (tests/test_gw_batch.py, tests/test_solver.py)
PLAN_ATOL = 1e-10
VALUE_ATOL = 1e-10


def _measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def _points(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _grids(sizes, k=1):
    """The same ragged Grid1D problems for both packages."""
    tp, jp = [], []
    for i, (m, n) in enumerate(sizes):
        mu, nu = _measures(m, 2 * i), _measures(n, 2 * i + 1)
        tp.append((core.Grid1D(m, 1 / (m - 1), k),
                   core.Grid1D(n, 1 / (n - 1), k), mu, nu))
        jp.append((jcore.Grid1D(m, 1 / (m - 1), k),
                   jcore.Grid1D(n, 1 / (n - 1), k), jnp.asarray(mu),
                   jnp.asarray(nu)))
    return tp, jp


def _configs(**kw):
    jcfg = jcore.GWConfig(**kw)
    return convert.gw_config(dataclasses.asdict(jcfg)), jcfg


def _batch(tp, cfg, **kw):
    return core.entropic_gw_batch(tp, cfg, device="cpu", **kw)


def _assert_dense(rt, rj, atol=PLAN_ATOL):
    assert rt.plan.shape == tuple(np.asarray(rj.plan).shape)
    np.testing.assert_allclose(rt.plan.numpy(), np.asarray(rj.plan),
                               rtol=0, atol=atol)
    assert abs(float(rt.value) - float(rj.value)) < VALUE_ATOL
    assert rt.info.outer_iters == int(rj.info.outer_iters)
    assert rt.info.inner_iters == int(rj.info.inner_iters)
    assert rt.info.converged == bool(rj.info.converged)
    assert np.isfinite(rt.plan.numpy()).all()


def _assert_factors(rt, rj, atol=1e-10):
    for name in ("q", "r", "g"):
        np.testing.assert_allclose(getattr(rt.coupling, name).numpy(),
                                   np.asarray(getattr(rj.coupling, name)),
                                   rtol=0, atol=atol)
    np.testing.assert_allclose(float(rt.value), float(rj.value), rtol=1e-9,
                               atol=1e-12)
    assert rt.info.outer_iters == int(rj.info.outer_iters)
    assert rt.info.inner_iters == int(rj.info.inner_iters)


def _solo(p, cfg, **kw):
    return core.entropic_gw(*p, cfg, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_gw_batch.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["log", "kernel"])
def test_batch_matches_reference_ragged(mode):
    """Ragged Grid1D lanes, padded with zero-mass atoms: each lane matches
    the reference's batch lane and the port's own solo solve.  Kernel mode
    (ε 5e-2: exp(−C/ε) underflows at 2e-3) shifts its duals by each padded
    lane's row and column minima, padding included, as the reference's
    does, so its lanes are held to the reference's batch."""
    tp, jp = _grids([(30, 30), (25, 40), (40, 33), (17, 22)])
    knobs = dict(CFG, sinkhorn_mode=mode) if mode == "log" else \
        dict(CFG, sinkhorn_mode=mode, eps=5e-2)
    cfg, jcfg = _configs(**knobs)
    batch = _batch(tp, cfg)
    for rt, rj, p in zip(batch, jcore.entropic_gw_batch(jp, jcfg), tp):
        _assert_dense(rt, rj)
        solo = _solo(p, cfg)
        np.testing.assert_allclose(rt.plan.numpy(), solo.plan.numpy(),
                                   rtol=0, atol=PLAN_ATOL)
        assert (rt.info.outer_iters, rt.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)


def test_batch_explicit_pad_to():
    """Serving buckets: padding past the largest problem matches the
    reference's padded batch, and the unpadded batch to the reference's
    own bar for a longer cumsum (1e-6)."""
    tp, jp = _grids([(20, 25), (24, 30)])
    cfg, jcfg = _configs(**CFG)
    padded = _batch(tp, cfg, pad_to=(64, 64))
    for rt, rj in zip(padded, jcore.entropic_gw_batch(jp, jcfg,
                                                      pad_to=(64, 64))):
        _assert_dense(rt, rj)
    for a, b in zip(_batch(tp, cfg), padded):
        np.testing.assert_allclose(a.plan.numpy(), b.plan.numpy(), atol=1e-6)


def test_batch_varying_spacing():
    """h is per lane: grids may differ in spacing inside a batch."""
    spec = [((20, 0.05), (20, 0.02)), ((20, 0.10), (20, 0.03))]
    tp = [(core.Grid1D(m, hx, 1), core.Grid1D(n, hy, 1), _measures(m, 2 * i),
           _measures(n, 2 * i + 1))
          for i, ((m, hx), (n, hy)) in enumerate(spec)]
    jp = [(jcore.Grid1D(m, hx, 1), jcore.Grid1D(n, hy, 1),
           jnp.asarray(_measures(m, 2 * i)), jnp.asarray(_measures(n, 2 * i + 1)))
          for i, ((m, hx), (n, hy)) in enumerate(spec)]
    cfg, jcfg = _configs(**CFG)
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        _assert_dense(rt, rj)
        np.testing.assert_allclose(rt.plan.numpy(), _solo(p, cfg).plan.numpy(),
                                   atol=PLAN_ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_batch_grid2d_equal_sizes(k):
    n = 5
    cfg, jcfg = _configs(eps=4e-3, outer_iters=4, sinkhorn_iters=80,
                         backend="cumsum")
    tp = [(core.Grid2D(n, 1 / (n - 1), k), core.Grid2D(n, 1 / (n - 1), k),
           _measures(n * n, s), _measures(n * n, s + 10)) for s in range(3)]
    jp = [(jcore.Grid2D(n, 1 / (n - 1), k), jcore.Grid2D(n, 1 / (n - 1), k),
           jnp.asarray(mu), jnp.asarray(nu)) for _, _, mu, nu in tp]
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        _assert_dense(rt, rj)
        np.testing.assert_allclose(rt.plan.numpy(), _solo(p, cfg).plan.numpy(),
                                   atol=PLAN_ATOL)
    with pytest.raises(ValueError, match="equal-sized"):
        _batch(tp, cfg, pad_to=(30, 30))


def test_batch_rejects_mixed_k():
    tp = _grids([(10, 10)], k=1)[0] + _grids([(10, 10)], k=2)[0]
    with pytest.raises(ValueError, match="compatible geometries"):
        _batch(tp, core.GWConfig(**CFG))


def test_batch_empty():
    cfg = core.GWConfig(**CFG)
    assert _batch([], cfg) == []
    assert _batch([], cfg, max_outer_segment=2) == ([], None)


def test_batch_rejects_malformed_measure():
    gx = core.Grid1D(5, 0.1, 1)
    with pytest.raises(ValueError, match="measure length 20"):
        _batch([(gx, gx, _measures(20, 0), _measures(5, 1))],
               core.GWConfig(**CFG))


def test_batch_refuses_what_is_not_ported():
    tp, _ = _grids([(10, 12)])
    # features need an FGWConfig (its theta), as the reference's
    with pytest.raises(ValueError, match="FGWConfig"):
        _batch(tp, core.GWConfig(**CFG), features=[np.ones((10, 12))])
    with pytest.raises(ValueError, match="plan_rank='auto'"):
        _batch(tp, core.GWConfig(plan="lowrank", plan_rank="auto"))
    with pytest.raises(ValueError, match="1 controls for 2 problems"):
        _batch(tp + tp, core.GWConfig(**CFG),
               controls=[core.SolveControls.make(2e-3)])


# ---------------------------------------------------------------------------
# tests/test_geometry.py: clouds, factors, mixed sides
# ---------------------------------------------------------------------------

GEO_CFG = dict(eps=5e-2, outer_iters=8, sinkhorn_iters=200)


def _pc_problems(sizes, d=2, seed=20, pad_points=False):
    tp, jp = [], []
    for i, n in enumerate(sizes):
        pts = _points(n, d, seed + i)
        mu, nu = _measures(n, 30 + i), _measures(n, 40 + i)
        tp.append((core.PointCloudGeometry(_t(pts)),
                   core.PointCloudGeometry(_t(pts)), mu, nu))
        jp.append((JPC(jnp.asarray(pts)), JPC(jnp.asarray(pts)),
                   jnp.asarray(mu), jnp.asarray(nu)))
    return tp, jp


def test_batch_ragged_pointclouds():
    tp, jp = _pc_problems([20, 26, 15, 22])
    cfg, jcfg = _configs(**GEO_CFG)
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        _assert_dense(rt, rj)
        np.testing.assert_allclose(rt.plan.numpy(), _solo(p, cfg).plan.numpy(),
                                   atol=PLAN_ATOL)


def test_batch_ragged_lowrank_costs():
    tp, jp = [], []
    for i, n in enumerate([18, 25, 21]):
        pts = _points(n, 2, 50 + i)
        lr = core.PointCloudGeometry(_t(pts)).to_low_rank()
        jlr = JPC(jnp.asarray(pts)).to_low_rank()
        mu, nu = _measures(n, 60 + i), _measures(n, 70 + i)
        tp.append((lr, lr, mu, nu))
        jp.append((jlr, jlr, jnp.asarray(mu), jnp.asarray(nu)))
    cfg, jcfg = _configs(**GEO_CFG)
    out = _batch(tp, cfg, pad_to=(32, 32))
    for rt, rj, p in zip(out, jcore.entropic_gw_batch(jp, jcfg,
                                                      pad_to=(32, 32)), tp):
        _assert_dense(rt, rj)
        # the reference's own bar for a padded factored cost against the
        # unpadded one (tests/test_geometry.py)
        np.testing.assert_allclose(rt.plan.numpy(), _solo(p, cfg).plan.numpy(),
                                   atol=1e-8)


def test_batch_mixed_geometry_sides():
    """A grid side and a point-cloud side, ragged on both."""
    tp, jp = [], []
    for i, (m, n) in enumerate([(20, 17), (25, 21), (16, 26)]):
        pts = _points(n, 2, 80 + i)
        mu, nu = _measures(m, 90 + i), _measures(n, 95 + i)
        tp.append((core.Grid1D(m, 1.0 / (m - 1), 1),
                   core.PointCloudGeometry(_t(pts)), mu, nu))
        jp.append((jcore.Grid1D(m, 1.0 / (m - 1), 1), JPC(jnp.asarray(pts)),
                   jnp.asarray(mu), jnp.asarray(nu)))
    cfg, jcfg = _configs(**GEO_CFG)
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        _assert_dense(rt, rj)
        np.testing.assert_allclose(rt.plan.numpy(), _solo(p, cfg).plan.numpy(),
                                   atol=PLAN_ATOL)


def test_batch_rejects_mixed_ranks():
    a = core.PointCloudGeometry(_t(_points(10, 2, 0))).to_low_rank()
    b = core.PointCloudGeometry(_t(_points(10, 3, 1))).to_low_rank()
    probs = [(a, a, _measures(10, 0), _measures(10, 1)),
             (b, b, _measures(10, 2), _measures(10, 3))]
    with pytest.raises(ValueError, match="compatible geometries"):
        _batch(probs, core.GWConfig(**GEO_CFG))


def test_batch_preserves_geometry_dtype():
    """f64 points under f32 measures keep their dtype in the stack; the
    solve agrees with the solo one to f32 accuracy (the reference's
    bar)."""
    from repro_torch.core.gw import _stack_side
    n = 18
    pc = core.PointCloudGeometry(_t(_points(n, 2, 77)))
    mu = _measures(n, 0).astype(np.float32)
    nu = _measures(n, 1).astype(np.float32)
    stacked, measures = _stack_side([pc], [torch.from_numpy(mu)], None)
    assert stacked.points.dtype == torch.float64
    assert measures.dtype == torch.float32
    cfg = core.GWConfig(**GEO_CFG)
    [res] = _batch([(pc, pc, mu, nu)], cfg)
    np.testing.assert_allclose(res.plan.numpy(),
                               _solo((pc, pc, mu, nu), cfg).plan.numpy(),
                               atol=5e-4)


def test_batch_num_results_skips_duplicates():
    tp, jp = _pc_problems([12])
    cfg, jcfg = _configs(**GEO_CFG)
    out = _batch(tp * 3, cfg, num_results=1)
    assert len(out) == 1
    _assert_dense(out[0], jcore.entropic_gw(*jp[0], jcfg))
    np.testing.assert_allclose(out[0].plan.numpy(),
                               _solo(tp[0], cfg).plan.numpy(), atol=PLAN_ATOL)


def test_pad_to_zero_mass_exactness():
    """Padded support points change nothing when they carry zero mass, and
    the padded rows of the plan are exactly 0."""
    n = 14
    tp, _ = _pc_problems([n], seed=11)
    pc, _, mu, nu = tp[0]
    cfg = core.GWConfig(**GEO_CFG)
    base = _solo(tp[0], cfg)
    padded = _solo((pc.pad_to(20), pc.pad_to(20), np.pad(mu, (0, 6)),
                    np.pad(nu, (0, 6))), cfg)
    np.testing.assert_allclose(padded.plan[:n, :n].numpy(), base.plan.numpy(),
                               atol=PLAN_ATOL)
    assert float(padded.plan[n:, :].abs().max()) == 0.0


def test_geometry_batch_keys():
    """pad_to, paddable, spec_unsized and batch_key as the reference's."""
    from repro.core.geometry import GridGeometry as JGG
    pts = _points(6, 3, 0)
    pairs = [(core.GridGeometry(core.Grid1D(8, 0.1, 2)),
              JGG(jcore.Grid1D(8, 0.1, 2))),
             (core.GridGeometry(core.Grid2D(3, 0.5, 1)),
              JGG(jcore.Grid2D(3, 0.5, 1))),
             (core.PointCloudGeometry(_t(pts), "euclidean"),
              JPC(jnp.asarray(pts), "euclidean")),
             (core.LowRankGeometry(torch.ones(5, 2), torch.ones(5, 2)),
              JLR(jnp.ones((5, 2)), jnp.ones((5, 2)))),
             (core.DenseGeometry(torch.eye(4, dtype=torch.float64)),
              jcore.geometry.DenseGeometry(jnp.eye(4)))]
    for tg, jg in pairs:
        assert tg.batch_key() == jg.batch_key()
        assert tg.paddable == jg.paddable
        if tg.paddable:
            tp, jpad = tg.pad_to(tg.size + 3), jg.pad_to(jg.size + 3)
            assert tp.size == jpad.size == tg.size + 3
            np.testing.assert_array_equal(
                tp.dist_matrix().numpy(), np.asarray(jpad.dist_matrix()))
    with pytest.raises(ValueError, match="Grid2D"):
        pairs[1][0].pad_to(12)


# ---------------------------------------------------------------------------
# tests/test_solver.py: per-lane stopping and stage clocks
# ---------------------------------------------------------------------------

def test_deep_annealed_batch_matches_solo_convergence():
    """ε = 1e-3 from 2e-2 over three lanes of different sizes: every lane
    converges batched and solo, and the values agree (the reference's bar,
    1e-12)."""
    tp, jp = [], []
    for n, seed in ((16, 0), (20, 1), (12, 2)):
        rng = np.random.default_rng(seed)
        mu, nu = rng.dirichlet(np.ones(n)), rng.dirichlet(np.ones(n + 4))
        tp.append((core.Grid1D(n, 1 / (n - 1), 1),
                   core.Grid1D(n + 4, 1 / (n + 3), 1), mu, nu))
        jp.append((jcore.Grid1D(n, 1 / (n - 1), 1),
                   jcore.Grid1D(n + 4, 1 / (n + 3), 1), jnp.asarray(mu),
                   jnp.asarray(nu)))
    cfg, jcfg = _configs(eps=1e-3, eps_init=2e-2, anneal_decay=0.5, tol=1e-6,
                         outer_iters=40, sinkhorn_iters=800,
                         sinkhorn_chunk=25)
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        solo = _solo(p, cfg)
        assert rt.info.converged and solo.info.converged
        assert float(rt.info.marginal_err) <= 1e-6
        np.testing.assert_allclose(float(rt.value), float(solo.value),
                                   rtol=0, atol=1e-12)
        _assert_dense(rt, rj)


def test_masked_batch_matches_unbatched_adaptive():
    """Each lane stops on its own counts: plans and counts equal the solo
    solves and the reference's lanes, at more than one outer count."""
    tp, jp = _grids([(30, 30), (25, 40), (17, 22)])
    cfg, jcfg = _configs(eps=5e-2, outer_iters=40, sinkhorn_iters=300,
                         tol=1e-6)
    outer = set()
    for rt, rj, p in zip(_batch(tp, cfg), jcore.entropic_gw_batch(jp, jcfg),
                         tp):
        _assert_dense(rt, rj)
        solo = _solo(p, cfg)
        np.testing.assert_allclose(rt.plan.numpy(), solo.plan.numpy(),
                                   atol=PLAN_ATOL)
        assert (rt.info.outer_iters, rt.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)
        assert rt.info.converged
        outer.add(rt.info.outer_iters)
    assert len(outer) > 1


def test_per_lane_controls_match_reference():
    """Every lane its own ε, tol and schedule (the serving cycle of ε)."""
    tp, jp = _grids([(24, 24), (20, 28), (26, 18), (22, 22)])
    knobs = [dict(eps=e, tol=1e-6, eps_init=5e-2, anneal_decay=d,
                  inner_loosen=l)
             for e, d, l in ((5e-2, 0.5, 1.0), (2e-2, 0.7, 0.0),
                             (8e-3, 0.5, 0.5), (2e-3, 0.6, 1.0))]
    cfg, jcfg = _configs(eps=2e-3, outer_iters=30, sinkhorn_iters=300,
                         tol=1e-6)
    tctl = [core.SolveControls.make(**k) for k in knobs]
    jctl = [jcore.SolveControls.make(**k) for k in knobs]
    batch = _batch(tp, cfg, controls=tctl)
    for rt, rj, p, c in zip(batch, jcore.entropic_gw_batch(
            jp, jcfg, controls=jctl), tp, tctl):
        _assert_dense(rt, rj)
        solo = _solo(p, cfg, controls=c)
        assert (rt.info.outer_iters, rt.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)


# ---------------------------------------------------------------------------
# tests/test_lowrank_plan.py: factored lanes
# ---------------------------------------------------------------------------

def _lr_problems(sizes):
    tp, jp = [], []
    for i, (m, n) in enumerate(sizes):
        px, py = _points(m, 2, i), _points(n, 2, 100 + i)
        mu, nu = np.ones(m) / m, np.ones(n) / n
        tp.append((core.PointCloudGeometry(_t(px)),
                   core.PointCloudGeometry(_t(py)), mu, nu))
        jp.append((JPC(jnp.asarray(px)), JPC(jnp.asarray(py)),
                   jnp.asarray(mu), jnp.asarray(nu)))
    return tp, jp


def test_lowrank_batch_padded_matches_unbatched():
    tp, jp = _lr_problems([(30, 40), (45, 35), (40, 40)])
    cfg, jcfg = _configs(eps=5e-2, outer_iters=8, tol=1e-6, eps_init=0.2,
                         sinkhorn_iters=100, plan="lowrank", plan_rank=8,
                         lowrank_backend="xla")
    batch = _batch(tp, cfg, pad_to=(64, 64))
    for rt, rj, p in zip(batch, jcore.entropic_gw_batch(jp, jcfg,
                                                        pad_to=(64, 64)), tp):
        assert isinstance(rt.coupling, core.LowRankCoupling)
        assert rt.coupling.q.shape == (p[2].shape[0], 8)
        _assert_factors(rt, rj)
        _assert_factors(rt, _solo(p, cfg))


def test_lowrank_zero_mass_padded_lanes():
    """Ragged factored problems padded with zero-mass atoms, a side > 128
    so whole kernel row blocks are dead: NaN-free, and each lane matches
    the reference's batch lane and the port's solo solve with equal
    counts."""
    tp, jp = _lr_problems([(140, 90), (100, 130), (90, 90)])
    cfg, jcfg = _configs(eps=5e-2, outer_iters=6, tol=1e-6,
                         sinkhorn_iters=60, plan="lowrank", plan_rank=8,
                         lowrank_backend="xla")
    out = _batch(tp, cfg, pad_to=(192, 192))
    for rt, rj, p in zip(out, jcore.entropic_gw_batch(jp, jcfg,
                                                      pad_to=(192, 192)), tp):
        for leaf in (rt.coupling.q, rt.coupling.r, rt.coupling.g):
            assert not bool(torch.isnan(leaf).any())
        assert rt.coupling.q.shape[0] == p[2].shape[0]
        # the reference's own xla-against-pallas bar for these lanes
        _assert_factors(rt, rj, atol=1e-10)
        solo = _solo(p, cfg)
        assert (rt.info.outer_iters, rt.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)
        np.testing.assert_allclose(rt.coupling.q.numpy(),
                                   solo.coupling.q.numpy(), atol=1e-10)


def test_lowrank_batch_kmeans_seeding():
    """k-means seeded factored lanes: each lane seeds from its own
    (padded) cloud, as the reference's vmapped init does."""
    tp, jp = _lr_problems([(30, 26), (22, 34)])
    cfg, jcfg = _configs(eps=5e-2, outer_iters=5, tol=1e-6,
                         sinkhorn_iters=60, plan="lowrank", plan_rank=4,
                         lowrank_init="kmeans", lowrank_backend="xla")
    for rt, rj in zip(_batch(tp, cfg, pad_to=(40, 40)),
                      jcore.entropic_gw_batch(jp, jcfg, pad_to=(40, 40))):
        _assert_factors(rt, rj)


# ---------------------------------------------------------------------------
# segmented solves and resumes
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    ia, ib = a.info, b.info
    if (ia.outer_iters, ia.inner_iters, ia.converged) != \
            (ib.outer_iters, ib.inner_iters, ib.converged):
        return False
    ta = [a.plan, a.f, a.g] if a.plan is not None else \
        [a.coupling.q, a.coupling.r, a.coupling.g]
    tb = [b.plan, b.f, b.g] if b.plan is not None else \
        [b.coupling.q, b.coupling.r, b.coupling.g]
    return all(torch.equal(x, y) for x, y in zip(ta, tb)) and \
        torch.equal(a.value, b.value) and \
        torch.equal(ia.err_trace.isnan(), ib.err_trace.isnan())


@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_segmented_batch_is_bitwise_one_shot(plan):
    if plan == "full":
        tp, _ = _grids([(26, 30), (20, 24), (30, 18)])
        cfg = core.GWConfig(eps=5e-3, eps_init=5e-2, tol=1e-6,
                            outer_iters=20, sinkhorn_iters=200)
    else:
        tp, _ = _lr_problems([(30, 40), (45, 35)])
        cfg = core.GWConfig(eps=5e-2, outer_iters=10, tol=1e-6, eps_init=0.2,
                            sinkhorn_iters=80, plan="lowrank", plan_rank=6)
    one = _batch(tp, cfg)
    carry, segments = None, 0
    while carry is None or any(not d and t < cfg.outer_iters
                               for t, d in zip(carry.t, carry.done)):
        res, carry = _batch(tp, cfg, resume_state=carry, max_outer_segment=3)
        segments += 1
    assert segments > 1
    assert all(_bits_equal(a, b) for a, b in zip(one, res))
    # resume_state alone runs the rest to completion
    _, part = _batch(tp, cfg, max_outer_segment=2)
    rest, _ = _batch(tp, cfg, resume_state=part)
    assert all(_bits_equal(a, b) for a, b in zip(one, rest))


def test_solo_is_a_batch_of_one():
    """entropic_gw runs the batch's code path: its result is the one-lane
    batch's, bit for bit."""
    tp, _ = _grids([(21, 27)])
    cfg = core.GWConfig(eps=5e-3, eps_init=5e-2, tol=1e-6, outer_iters=20)
    assert _bits_equal(_solo(tp[0], cfg), _batch(tp, cfg)[0])


@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_resume_reference_batch_carry_in_port(plan):
    """A reference batch run k segments, its stacked carry carried across
    (`convert.mirror_carry`, `convert.solve_controls`) and finished in the
    port: each lane equals the reference's uninterrupted batch lane."""
    if plan == "full":
        tp, jp = _grids([(26, 30), (20, 24)])
        knobs = dict(eps=5e-3, eps_init=5e-2, tol=1e-6, outer_iters=20,
                     sinkhorn_iters=200)
    else:
        tp, jp = _lr_problems([(30, 40), (45, 35)])
        knobs = dict(eps=5e-2, outer_iters=8, tol=1e-6, eps_init=0.2,
                     sinkhorn_iters=100, plan="lowrank", plan_rank=6,
                     lowrank_backend="xla")
    cfg, jcfg = _configs(**knobs)
    whole = jcore.entropic_gw_batch(jp, jcfg)
    _, jc = jcore.entropic_gw_batch(jp, jcfg, max_outer_segment=2)
    leaves = (jc.state.plan, jc.state.f, jc.state.g) if plan == "full" \
        else (jc.state.q, jc.state.r, jc.state.g)
    carry = convert.mirror_carry(
        *(np.asarray(x) for x in leaves), np.asarray(jc.t),
        np.asarray(jc.stage), np.asarray(jc.inner), np.asarray(jc.err),
        np.asarray(jc.done), np.asarray(jc.trace), device="cpu", plan=plan)
    assert carry.lanes == 2 and carry.t == (2, 2)
    jctl = jcore.SolveControls.from_config(jcfg)
    ctl = convert.solve_controls(
        *(np.full(2, float(v)) for v in (
            jctl.eps, jctl.tol, jctl.eps_init, jctl.anneal_decay,
            jctl.inner_loosen, jctl.lr_gamma)), device="cpu")
    assert ctl.eps.shape == (2,)
    out, _ = _batch(tp, cfg, resume_state=carry,
                    controls=[core.SolveControls(*(v[b] for v in
                                                   dataclasses.astuple(ctl)))
                              for b in range(2)])
    for rt, rj in zip(out, whole):
        if plan == "full":
            _assert_dense(rt, rj)
        else:
            _assert_factors(rt, rj)


def test_coupling_pad_and_slice_are_inverse():
    """FullCoupling/LowRankCoupling pad_to and slice_to, as the
    reference's: −inf potentials and zero plan mass or zero factor rows on
    the padding."""
    from repro.core import coupling as jcoup
    rng = np.random.default_rng(3)
    plan, f, g = rng.random((4, 5)), rng.normal(size=4), rng.normal(size=5)
    tc = core.FullCoupling(_t(plan), _t(f), _t(g)).pad_to(6, 8)
    jc = jcoup.FullCoupling(jnp.asarray(plan), jnp.asarray(f),
                            jnp.asarray(g)).pad_to(6, 8)
    for a, b in ((tc.plan, jc.plan), (tc.f, jc.f), (tc.g, jc.g)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tc.slice_to(4, 5)
    assert torch.equal(back.plan, _t(plan)) and torch.equal(back.f, _t(f))
    q, r, w = rng.random((4, 3)), rng.random((5, 3)), rng.random(3)
    lc = core.LowRankCoupling(_t(q), _t(r), _t(w)).pad_to(7, 9)
    jl = jcoup.LowRankCoupling(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(w)).pad_to(7, 9)
    np.testing.assert_array_equal(lc.q.numpy(), np.asarray(jl.q))
    np.testing.assert_array_equal(lc.r.numpy(), np.asarray(jl.r))
    assert torch.equal(lc.slice_to(4, 5).q, _t(q))


def test_init_lane_fills_a_slot_as_the_batch_does():
    """`_init_lane` (one problem's fresh carry, a freed slot's) stacked
    over the lanes equals the batch's `_init_stacked`, bit for bit, for
    both plans."""
    from repro_torch.core.gw import _init_lane, _init_stacked
    for cfg, tp in (
            (core.GWConfig(**CFG), _grids([(20, 25), (24, 18)])[0]),
            (core.GWConfig(plan="lowrank", plan_rank=4,
                           lowrank_init="kmeans"),
             _lr_problems([(20, 26), (24, 18)])[0])):
        ops, gxs, gys = core.stack_problems(tp, cfg, pad_to=(30, 30),
                                            device="cpu")
        whole = _init_stacked(*ops[:4], cfg)
        lanes = core.MirrorCarry.stack([
            _init_lane(ops[0].lane(b), ops[1].lane(b), ops[2][b], ops[3][b],
                       cfg) for b in range(2)])
        assert lanes.t == whole.t == (0, 0)
        for a, b in zip(dataclasses.astuple(lanes.state),
                        dataclasses.astuple(whole.state)):
            assert torch.equal(a, b)


def test_lane_schedule_is_the_solo_schedule():
    """Each lane of stacked controls, read to the host, runs the schedule
    of that lane's own controls: the same Python floats."""
    knobs = [dict(eps=5e-2, tol=1e-6, eps_init=5e-1, anneal_decay=0.7),
             dict(eps=2e-3, tol=0.0, eps_init=5e-2, anneal_decay=0.5,
                  inner_loosen=0.5)]
    solo = [core.SolveControls.make(**k) for k in knobs]
    lanes = core.stack_controls(solo, core.GWConfig(), 2).lanes_on_host(2)
    for lane, one in zip(lanes, solo):
        for t in range(40):
            assert lane.eps_at(t) == one.eps_at(t)
            assert lane.inner_tol_at(t) == one.inner_tol_at(t)
            assert lane.anneal_done(t) == one.anneal_done(t)


@pytest.mark.parametrize("side", ["grid", "lowrank", "pointcloud", "dense"])
def test_one_geometry_applies_as_its_stack_of_one(side):
    """A geometry's apply is its stack of one's, and an operator's
    `on_lanes` form gives its one-problem results on a lane axis, bit for
    bit."""
    pts = _t(_points(9, 2, 5))
    geom = {"grid": core.GridGeometry(core.Grid1D(9, 0.125, 1)),
            "lowrank": core.PointCloudGeometry(pts).to_low_rank(),
            "pointcloud": core.PointCloudGeometry(pts),
            "dense": core.DenseGeometry(
                core.PointCloudGeometry(pts).dist_matrix())}[side]
    x = _t(np.random.default_rng(6).random((9, 9)))
    stacked = core.geometry.stack([geom])
    for axis, power in ((0, 1), (1, 2), (-1, 0)):
        assert torch.equal(geom.apply_dist(x, axis, power),
                           stacked.apply_dist(x[None], axis % 2 + 1,
                                              power)[0])
    op = core.GradientOperator(geom, geom)
    lanes = op.on_lanes()
    assert op.lanes is None and lanes.lanes == 1 and lanes.on_lanes() is lanes
    assert torch.equal(op.product(x), lanes.product(x[None])[0])
