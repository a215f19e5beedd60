"""The port's sliced tier, refine tier, hardness calibration, plan routing
and FGW buckets, against the reference's engine, on the CPU.

Replays the serving cases of tests/test_sliced.py (:246–:437) and the
engine cases of tests/test_lowrank_plan.py (:223–:300, :708–:752), and
tests/test_sinkhorn_backend.py::test_serve_config_backend_override.  The
sliced tier draws the reference's direction bank where results are
compared with the reference's (``convert.serve_config``'s
``sliced_directions``); the port's own bank (a CPU generator seeded with
``sliced_seed``) where the port is compared with itself.  The reference's
``test_sliced_service_single_dispatch_and_jit_stable`` counts jit
executables; its counterpart here is one call of the sliced tier a
request, no segment, no bucket."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve import (WARM_SOLVER, WARM_TOL, assert_parity,
                          assert_same_bits, engines, port_engine,
                          reference_bank, submit, t)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro import core as jcore
from repro.core.geometry import DenseGeometry as JDense
from repro.core.geometry import PointCloudGeometry as JPC
from repro_torch import convert, core
from repro_torch.core.coupling import FullCoupling, LowRankCoupling
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.calibration import HardnessCalibrator

SLICED_RTOL = 1e-10     # the two packages' sorted estimates, one bank


def _cloud(n, seed, d=3, scale=1.0):
    return np.random.default_rng(seed).normal(size=(n, d)) * scale


def _uni(n):
    return np.full((n,), 1.0 / n)


def _pair(x, y, mu=None, nu=None):
    """(reference, port) problem of two point clouds."""
    mu = _uni(len(x)) if mu is None else mu
    nu = _uni(len(y)) if nu is None else nu
    return ((JPC(jnp.asarray(x)), JPC(jnp.asarray(y)), jnp.asarray(mu),
             jnp.asarray(nu)),
            (core.PointCloudGeometry(t(x)), core.PointCloudGeometry(t(y)),
             t(mu), t(nu)))


def _engines(d=3, **kw):
    defaults = dict(max_batch=4, size_bucket=16, tol=WARM_TOL,
                    scheduler="pipeline", segment_iters=5)
    defaults.update(kw)
    return engines(WARM_SOLVER, banks={d: reference_bank(d)}, **defaults)


def _port(**kw):
    defaults = dict(max_batch=4, size_bucket=16, tol=WARM_TOL,
                    scheduler="pipeline", segment_iters=5)
    defaults.update(kw)
    return port_engine(WARM_SOLVER, **defaults)


# ---------------------------------------------------------------------------
# the sliced and refine tiers
# ---------------------------------------------------------------------------

def test_sliced_service_single_call_per_request(monkeypatch):
    """One call of the sliced tier a request and nothing else (no bucket,
    no segment); ragged sizes share the bucket's padded shape; each value
    is the reference engine's on its bank, and the port's own
    ``sliced_gw`` on the same bank (padding roundoff, rtol 1e-5 as the
    reference holds it)."""
    engs = _engines(service="sliced")
    calls = []
    real = engine_mod._sliced_core
    monkeypatch.setattr(engine_mod, "_sliced_core",
                        lambda ex, *a: calls.append(ex.shape) or real(ex, *a))
    pairs = [_pair(_cloud(m, 30 + m), _cloud(n, 60 + n))
             for m, n in [(9, 11), (12, 8), (10, 14)]]
    rids = [submit(engs, p) for p in pairs]
    out_j, out = engs[0].flush(), engs[1].flush()
    s = engs[1].stats
    assert s["dispatches"] == 3 and s["sliced_answers"] == 3
    assert s["refills"] == 0
    assert len(calls) == 3 and set(calls) == {(16, 3)}
    bank = engs[1].cfg.sliced_directions[3]
    for rid, p in zip(rids, pairs):
        res = out[rid]
        assert res.plan is None and res.coupling is None
        assert res.info.outer_iters == 0 and res.info.converged
        np.testing.assert_allclose(float(res.value), float(out_j[rid].value),
                                   rtol=SLICED_RTOL)
        ref = core.sliced_gw(*p[1], n_proj=32, directions=bank, device="cpu")
        np.testing.assert_allclose(float(res.value), float(ref.estimate),
                                   rtol=1e-5)


def test_sliced_answer_equals_sliced_gw_when_unpadded():
    """A request whose sizes fill its bucket: the answer is the port's
    ``sliced_gw(n_proj, seed=sliced_seed)``, bit for bit."""
    eng = _port(service="sliced", sliced_seed=7)
    p = _pair(_cloud(16, 1), _cloud(32, 2))[1]
    rid = eng.submit(*p)
    got = eng.flush()[rid]
    ref = core.sliced_gw(*p, n_proj=32, seed=7, device="cpu")
    assert torch.equal(got.value, ref.estimate)


def test_sliced_answer_padding_invariant():
    p = _pair(_cloud(9, 40), _cloud(11, 41))[1]
    small, big = _port(service="sliced"), _port(service="sliced",
                                                size_bucket=64)
    r1, r2 = small.submit(*p), big.submit(*p)
    np.testing.assert_allclose(float(small.flush()[r1].value),
                               float(big.flush()[r2].value), rtol=1e-5)


def test_refine_matches_cold_exact():
    """One side a rotated, re-indexed copy of the other: the refined solve
    lands where the cold one does, and both match the reference's."""
    pts = _cloud(12, 50, d=2)
    th = 0.7
    q = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    rot = (pts @ q.T)[np.random.default_rng(51).permutation(12)]
    pair = _pair(pts, rot)
    cold_e = _engines(d=2)
    rc = submit(cold_e, pair)
    cold_j, cold = cold_e[0].flush()[rc], cold_e[1].flush()[rc]
    assert cold.info.converged
    assert_parity(cold, cold_j)
    engs = _engines(d=2, service="refine")
    rr = submit(engs, pair)
    out_j, out = engs[0].flush()[rr], engs[1].flush()[rr]
    assert out.info.converged
    assert float(cold.value) < 1e-2
    np.testing.assert_allclose(float(out.value), float(cold.value),
                               atol=1e-3)
    assert engs[1].stats["sliced_answers"] == 1
    assert_parity(out, out_j)


def test_refine_yields_preliminary_then_final_in_serve():
    """``serve`` yields the sliced preliminary (the seed plan, zero steps)
    and then the refined result; the refined one is the one-lane
    ``entropic_gw_batch`` resumed from ``init_carry`` of
    ``FullCoupling.from_sliced`` of the same ``sliced_plan``, annealing
    on, bit for bit."""
    pair = _pair(_cloud(16, 52, d=2), _cloud(16, 53, d=2))
    engs = _engines(d=2, service="refine")
    outs = list(engs[1].serve(iter([pair[1]])))
    outs_j = list(engs[0].serve(iter([pair[0]])))
    assert [r for r, _ in outs] == [0, 0]
    (_, pre), (_, final) = outs
    assert pre.info.outer_iters == 0 and pre.coupling is not None
    assert final.info.outer_iters > 0 and final.info.converged
    bank = engs[1].cfg.sliced_directions[2]
    sp = core.sliced_plan(*pair[1], n_proj=32, directions=bank,
                          device="cpu")
    np.testing.assert_allclose(float(pre.value), float(sp.estimate),
                               rtol=1e-5)
    assert torch.equal(pre.plan, sp.plan)
    cfg = engs[1].cfg.solver_cfg()
    carry = core.init_carry(FullCoupling.stack([FullCoupling.from_sliced(
        sp.plan, pair[1][2], pair[1][3])]), cfg.outer_iters, "cpu", 1)
    (solo,), _ = core.entropic_gw_batch([pair[1]], cfg, resume_state=carry,
                                        device="cpu")
    assert_same_bits(final, solo)
    assert_parity(pre, outs_j[0][1])
    assert_parity(final, outs_j[1][1])


def test_refine_priority_sorts_bucket_queue_exact_first():
    eng = _port(max_batch=2)
    for i, s in enumerate(["refine", "exact", "refine", "exact"]):
        eng.submit(*_pair(_cloud(10, 80 + i, d=2), _cloud(12, 90 + i, d=2))[1],
                   service=s)
    for req in eng._queue:
        eng._resolve(req)
    key = eng._bucket_key(eng._queue[0])
    run = engine_mod._BucketRun(eng, key, list(eng._queue))
    order = [r.service for r in list(run.slots) + list(run.pending)
             if r is not None]
    assert order == ["exact", "exact", "refine", "refine"]
    eng._queue.clear()


def test_exact_requests_never_starved_by_refine_backlog():
    eng = _port(max_batch=2, max_inflight_buckets=4)
    pairs = [_pair(_cloud(10, 100 + i, d=2), _cloud(12, 120 + i, d=2))[1]
             for i in range(8)]
    svcs = ["refine"] * 6 + ["exact"] * 2
    outs = list(eng.serve((p, {"service": s}) for p, s in zip(pairs, svcs)))
    finals = {}
    for pos, (rid, res) in enumerate(outs):
        finals[rid] = (pos, res)
    assert len(finals) == 8 and len(outs) == 6 * 2 + 2
    rids = sorted(finals)
    for rid in rids:
        assert finals[rid][1].info.converged
    assert max(finals[r][0] for r in rids[6:]) < \
        max(finals[r][0] for r in rids[:6])


def test_submit_rejects_unsliceable_and_fgw_fast_requests():
    rng = np.random.default_rng(0)
    dense = core.DenseGeometry(t(rng.random((6, 6))))
    eng = _port()
    with pytest.raises(ValueError, match="coordinate embedding"):
        eng.submit(dense, dense, _uni(6), _uni(6), service="sliced")
    ga = core.PointCloudGeometry(t(_cloud(6, 70)))
    with pytest.raises(ValueError, match="exact service"):
        eng.submit(ga, ga, _uni(6), _uni(6), service="refine",
                   feature_cost=np.zeros((6, 6)))
    with pytest.raises(ValueError, match="unknown service"):
        eng.submit(ga, ga, _uni(6), _uni(6), service="turbo")
    cost = rng.random((6, 6))
    cost = cost + cost.T
    np.fill_diagonal(cost, 0.0)
    engs = _engines(service="sliced")
    rid = submit(engs, ((JDense(jnp.asarray(cost)), JDense(jnp.asarray(cost)),
                         jnp.asarray(_uni(6)), jnp.asarray(_uni(6))),
                        (core.DenseGeometry(t(cost)),
                         core.DenseGeometry(t(cost)), t(_uni(6)),
                         t(_uni(6)))))
    out_j, out = engs[0].flush()[rid], engs[1].flush()[rid]
    assert out.plan is not None            # solved exactly instead
    assert engs[1].stats["sliced_answers"] == 0
    assert_parity(out, out_j)


# ---------------------------------------------------------------------------
# hardness calibration
# ---------------------------------------------------------------------------

def test_calibrator_fallback_then_learns():
    cal = HardnessCalibrator(2, min_obs=4)
    assert cal.predict("k", [1.0, 1.0]) is None
    for i in range(8):
        cal.observe("k", [1.0, float(i)], 3.0 + 2.0 * i)
    assert cal.n_obs("k") == 8
    lo, hi = cal.predict("k", [1.0, 1.0]), cal.predict("k", [1.0, 5.0])
    assert lo is not None and hi is not None and hi > lo
    np.testing.assert_allclose(hi, 13.0, rtol=0.15)
    assert cal.predict("other", [1.0, 1.0]) is None
    cal.observe("k", [1.0, np.nan], 1.0)
    assert cal.n_obs("k") == 8
    with pytest.raises(ValueError):
        cal.observe("k", [1.0], 1.0)
    with pytest.raises(ValueError):
        HardnessCalibrator(0)


def test_engine_calibration_observes_and_takes_over():
    eng = _port(calibrate_hardness=True, calib_min_obs=3)
    pairs = [_pair(_cloud(10, 80 + i, d=2), _cloud(12, 90 + i, d=2))[1]
             for i in range(4)]
    for p in pairs:
        eng.submit(*p)
    eng.flush()
    assert eng.calib.observations == 4
    eng.submit(*pairs[0])
    req = eng._queue[-1]
    eng._resolve(req)
    key = eng._bucket_key(req)
    assert eng.calib.n_obs(key) >= 3
    assert eng.predicted_hardness(req) >= 0.0
    assert eng.calib.predict(key, eng._hardness_features(req)) is not None
    eng.flush()
    fresh = _port(calibrate_hardness=True)
    fresh.submit(*pairs[0])
    req2 = fresh._queue[-1]
    fresh._resolve(req2)
    assert fresh.calib.predict(fresh._bucket_key(req2),
                               fresh._hardness_features(req2)) is None
    assert fresh.predicted_hardness(req2) > 0.0
    fresh.flush()


# ---------------------------------------------------------------------------
# tests/test_lowrank_plan.py: size routing, plan pins, FGW buckets
# ---------------------------------------------------------------------------

SERVE_SOLVER = jcore.GWConfig(eps=5e-2, outer_iters=8, tol=1e-6,
                              eps_init=0.2, sinkhorn_iters=100, plan_rank=8)


def _lr_pair(n, seed_x, seed_y, m=None):
    m = n if m is None else m
    return _pair(_cloud(n, seed_x, d=2), _cloud(m, seed_y, d=2))


def test_engine_routes_by_size_threshold():
    engs = engines(SERVE_SOLVER, lowrank_above=40, size_bucket=32,
                   max_batch=4)
    small, big = _lr_pair(30, 0, 1, 24), _lr_pair(45, 2, 3, 35)
    rids = [submit(engs, small), submit(engs, big)]
    out_j, out = engs[0].flush(), engs[1].flush()
    assert isinstance(out[rids[0]].coupling, FullCoupling)
    assert out[rids[0]].plan is not None
    assert isinstance(out[rids[1]].coupling, LowRankCoupling)
    for rid in rids:
        assert_parity(out[rid], out_j[rid])
    cfg = engs[1].cfg.solver_cfg()
    ref_lr = core.entropic_gw(*big[1], dataclasses.replace(cfg,
                                                          plan="lowrank"),
                              device="cpu")
    np.testing.assert_allclose(out[rids[1]].coupling.q.numpy(),
                               ref_lr.coupling.q.numpy(), atol=1e-10)


def test_engine_submit_plan_pins_representation():
    engs = engines(SERVE_SOLVER, lowrank_above=40, size_bucket=32,
                   max_batch=4)
    small, big = _lr_pair(30, 0, 1, 24), _lr_pair(45, 2, 3, 35)
    rid_lr = submit(engs, small, plan="lowrank")
    rid_full = submit(engs, big, plan="full")
    out_j, out = engs[0].flush(), engs[1].flush()
    assert isinstance(out[rid_lr].coupling, LowRankCoupling)
    assert isinstance(out[rid_full].coupling, FullCoupling)
    for rid in (rid_lr, rid_full):
        assert_parity(out[rid], out_j[rid])
    with pytest.raises(ValueError, match="unknown plan"):
        engs[1].submit(*small[1], plan="midrank")


def test_engine_mixed_plan_flush_returns_every_request():
    engs = engines(SERVE_SOLVER, lowrank_above=40, size_bucket=32,
                   max_batch=2, segment_iters=3)
    rids = {}
    for i in range(5):
        n = 24 if i % 2 == 0 else 45
        rids[submit(engs, _lr_pair(n, i, 50 + i))] = n
    out_j, out = engs[0].flush(), engs[1].flush()
    assert set(out) == set(out_j) == set(rids)
    for rid, n in rids.items():
        assert isinstance(out[rid].coupling,
                          LowRankCoupling if n >= 40 else FullCoupling)
        assert_parity(out[rid], out_j[rid])


def test_engine_hardness_is_plan_aware():
    eng = port_engine(SERVE_SOLVER)
    big = _lr_pair(400, 0, 1)[1]
    knobs = (5e-2, 1e-6, 5e-2, 0.5)
    as_full = engine_mod._Request(0, big, {}, knobs=knobs, plan="full")
    as_lr = engine_mod._Request(1, big, {}, knobs=knobs, plan="lowrank")
    assert eng.predicted_hardness(as_lr) < eng.predicted_hardness(as_full)


def _fgw_pairs(sizes, seed0):
    out = []
    for i, (m, n) in enumerate(sizes):
        rng = np.random.default_rng(seed0 + i)
        x = np.random.default_rng(seed0 + i).normal(size=(m, 2))
        y = np.random.default_rng(77 + i).normal(size=(n, 2))
        out.append((_pair(x, y), rng.random((m, n))))
    return out


@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_fgw_serving_continuous_equals_barrier_and_unbatched(plan):
    """FGW requests bucket apart from GW (and by θ); continuous == barrier
    bit for bit, both against the reference's continuous engine and the
    port's unbatched ``entropic_fgw`` (counts exact)."""
    solver = jcore.GWConfig(eps=5e-2, outer_iters=8, tol=1e-6,
                            sinkhorn_iters=60, plan=plan, plan_rank=6)
    items = _fgw_pairs([(20, 26), (26, 18), (24, 24)], 80)
    theta = 0.35
    kw = dict(max_batch=4, size_bucket=32, segment_iters=3)
    cont = engines(solver, scheduler="continuous", **kw)
    barr = port_engine(solver, scheduler="barrier", **kw)
    rids = []
    for pair, f in items:
        rids.append(submit(cont, pair, feature_cost=f, theta=theta))
        assert barr.submit(*pair[1], feature_cost=f, theta=theta) == \
            rids[-1]
    rid_gw = submit(cont, items[0][0])
    assert barr.submit(*items[0][0][1]) == rid_gw
    out_j, out_c, out_b = cont[0].flush(), cont[1].flush(), barr.flush()
    assert sorted(out_c) == sorted(out_b) == sorted(rids + [rid_gw])
    fcfg = convert.gw_config(dict(dataclasses.asdict(solver), theta=theta))
    for rid, (pair, f) in zip(rids, items):
        assert_same_bits(out_c[rid], out_b[rid])
        assert_parity(out_c[rid], out_j[rid])
        ref = core.entropic_fgw(pair[1][0], pair[1][1], f, pair[1][2],
                                pair[1][3], fcfg, device="cpu")
        assert (out_c[rid].info.outer_iters, out_c[rid].info.inner_iters) \
            == (ref.info.outer_iters, ref.info.inner_iters)
        np.testing.assert_allclose(float(out_c[rid].value), float(ref.value),
                                   rtol=1e-9, atol=1e-12)
    assert_parity(out_c[rid_gw], out_j[rid_gw])


def test_fgw_submit_validation():
    eng = port_engine(SERVE_SOLVER)
    p = _lr_pair(10, 0, 1, 12)[1]
    with pytest.raises(ValueError, match="theta"):
        eng.submit(*p, theta=0.5)
    with pytest.raises(ValueError, match="feature cost shape"):
        eng.submit(*p, feature_cost=np.zeros((12, 10)))


def test_serve_config_backend_overrides():
    """``sinkhorn_backend`` / ``lowrank_backend`` override the solver's at
    resolution, and only then; ``convert.serve_config`` maps the
    reference's names."""
    solver = core.GWConfig(lowrank_backend="torch", sinkhorn_backend="torch")
    cfg = engine_mod.GWServeConfig(solver=solver)
    assert cfg.solver_cfg().lowrank_backend == "torch"
    assert cfg.solver_cfg().sinkhorn_backend == "torch"
    cfg = engine_mod.GWServeConfig(solver=solver, lowrank_backend="kernel",
                                   sinkhorn_backend="kernel")
    assert cfg.solver_cfg().lowrank_backend == "kernel"
    assert cfg.solver_cfg().sinkhorn_backend == "kernel"
    from repro.serve.engine import GWServeConfig as JServeConfig
    jcfg = JServeConfig(solver=jcore.GWConfig(sinkhorn_backend="xla",
                                              backend="pallas"),
                        lowrank_backend="pallas")
    got = convert.serve_config(dataclasses.asdict(jcfg), device="cpu")
    assert (got.solver.sinkhorn_backend, got.solver.backend,
            got.lowrank_backend, got.sinkhorn_backend) == \
        ("torch", "kernel", "kernel", None)
    with pytest.raises(ValueError, match="unknown lowrank backend"):
        core.GWConfig(lowrank_backend="cuda")


def test_static_key_zeroes_value_knobs_only():
    """``GWConfig.static_key`` equals the reference's on every field."""
    j = jcore.GWConfig(eps=3e-2, tol=1e-5, eps_init=0.5, anneal_decay=0.7,
                       inner_loosen=0.5, lr_gamma=12.0, plan="lowrank",
                       plan_rank=8, backend="pallas")
    got = convert.gw_config(dataclasses.asdict(j)).static_key()
    want = convert.gw_config(dataclasses.asdict(j.static_key()))
    assert got == want
    assert got.plan_rank == 8 and got.eps == 0.0 and got.eps_init is None
