"""The port's GW serving engine on the continuous and barrier schedulers,
against the reference's engine, on the CPU.

Replays tests/test_serve_continuous.py, the engine cases of
tests/test_gw_batch.py (:94–:166),
tests/test_solver.py::test_engine_tol_knob_and_per_request_info (:360) and
tests/test_geometry.py::test_engine_pointcloud_stream_bucketed_no_recompile
(:314): the same streams go through ``repro.serve.engine.GWEngine`` and
``repro_torch.serve.engine.GWEngine``.  Bars against the reference: dense
plans ‖ΔP‖_F < 1e-12, factors rtol 1e-10 / atol 1e-12, values rtol 1e-10,
counts and returned ids equal.  The port's own scheduler invariances
(continuous == barrier, segmented == one-shot, orderings) are bitwise on
plans, potentials, factors and counts.

The reference pins its jit cache (≤ log2(max_batch)+1 executables a
bucket); the port has no compile cache, so its counterpart is the
slot-width menu: every segment a bucket dispatches has one of at most
log2(max_batch)+1 widths, and a second stream of the same shapes adds
none."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _prop import given, settings, st
from _torch_serve import (SOLVER, TOL, assert_parity, assert_same_bits,
                          controls, engines, measures, port_engine,
                          port_solo, problem, submit, t)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro import core as jcore
from repro.core.geometry import PointCloudGeometry as JPC
from repro.core.geometry import as_geometry as j_as_geometry
from repro.serve import engine as jengine_mod
from repro_torch import convert, core
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import GWEngine, GWServeConfig


def _configs(solver, **kw):
    return convert.gw_config(dataclasses.asdict(solver)), solver


class Widths:
    """Records the width of every segment a bucket dispatches, by the
    bucket's padded shape and geometry class."""

    def __init__(self, monkeypatch):
        self.seen = set()
        real = engine_mod._segment_stacked

        def rec(gx, gy, mus, nus, *rest):
            self.seen.add(((type(gx).__name__, mus.shape[1], nus.shape[1]),
                           mus.shape[0]))
            return real(gx, gy, mus, nus, *rest)
        monkeypatch.setattr(engine_mod, "_segment_stacked", rec)

    def by_bucket(self):
        out = {}
        for bucket, width in self.seen:
            out.setdefault(bucket, set()).add(width)
        return out


# ---------------------------------------------------------------------------
# the keystone: segmented + resumed == uninterrupted, bit for bit
# ---------------------------------------------------------------------------

def _segmented(probs, cfg, ctls, segment):
    res, carry = core.entropic_gw_batch(probs, cfg, controls=ctls,
                                        max_outer_segment=segment,
                                        device="cpu")
    while not all(r.info.converged or r.info.outer_iters >= cfg.outer_iters
                  for r in res):
        res, carry = core.entropic_gw_batch(probs, cfg, controls=ctls,
                                            max_outer_segment=segment,
                                            resume_state=carry, device="cpu")
    return res


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("segment", [1, 3, 5])
def test_resume_bit_identical_to_uninterrupted(kind, segment):
    jcfg = dataclasses.replace(SOLVER, tol=TOL, eps_init=5e-2)
    cfg, _ = _configs(jcfg)
    pairs = [problem(kind, 10 * kind + i) for i in range(3)]
    ctls = [controls(100 + i) for i in range(3)]
    probs, tctl = [p[1] for p in pairs], [c[1] for c in ctls]
    full = core.entropic_gw_batch(probs, cfg, controls=tctl, device="cpu")
    for a, b in zip(full, _segmented(probs, cfg, tctl, segment)):
        assert_same_bits(a, b, value_rtol=0.0)
    ref = jcore.entropic_gw_batch([p[0] for p in pairs], jcfg,
                                  controls=[c[0] for c in ctls])
    for a, r in zip(full, ref):
        assert_parity(a, r)


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("segment", [1, 4])
def test_resume_bit_identical_lowrank(kind, segment):
    jcfg = dataclasses.replace(SOLVER, tol=TOL, eps_init=5e-2,
                               plan="lowrank", plan_rank=6)
    cfg, _ = _configs(jcfg)
    pairs = [problem(kind, 40 + 10 * kind + i) for i in range(3)]
    ctls = [controls(200 + i) for i in range(3)]
    probs, tctl = [p[1] for p in pairs], [c[1] for c in ctls]
    full = core.entropic_gw_batch(probs, cfg, controls=tctl, device="cpu")
    for a, b in zip(full, _segmented(probs, cfg, tctl, segment)):
        assert_same_bits(a, b, value_rtol=0.0)
    ref = jcore.entropic_gw_batch([p[0] for p in pairs], jcfg,
                                  controls=[c[0] for c in ctls])
    for a, r in zip(full, ref):
        assert_parity(a, r)


def test_lowrank_stream_continuous_equals_barrier():
    """Factored lanes: continuous == barrier bit for bit, and both match
    the reference's continuous engine."""
    lr = dataclasses.replace(SOLVER, plan="lowrank", plan_rank=6)
    kw = dict(max_batch=4, size_bucket=16, tol=TOL, segment_iters=3)
    cont = engines(lr, scheduler="continuous", **kw)
    barr = port_engine(lr, scheduler="barrier", **kw)
    rids = []
    for i in range(5):
        pair, ctl = problem(i % 3, 500 + i), controls(500 + i)
        rids.append(submit(cont, pair, ctl))
        assert barr.submit(*pair[1], controls=ctl[1]) == rids[-1]
    out_j, out_c, out_b = cont[0].flush(), cont[1].flush(), barr.flush()
    assert set(out_j) == set(out_c) == set(out_b) == set(rids)
    for rid in rids:
        assert out_c[rid].plan is None
        assert_same_bits(out_c[rid], out_b[rid])
        assert_parity(out_c[rid], out_j[rid])


# ---------------------------------------------------------------------------
# (a) + (b): random submit/flush streams over mixed geometries
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_stream_ids_once_and_results_exact(seed):
    rng = np.random.default_rng(seed)
    kw = dict(max_batch=4, size_bucket=16, tol=TOL, segment_iters=3)
    cont = engines(scheduler="continuous", **kw)
    barr = port_engine(scheduler="barrier", **kw)
    expect, got, got_b, got_j = {}, {}, {}, {}

    def do_flush():
        out_j, out, out_b = cont[0].flush(), cont[1].flush(), barr.flush()
        assert set(out) == set(out_b) == set(out_j)
        for rid, res in out.items():
            assert rid not in got, f"request {rid} returned twice"
            got[rid], got_b[rid], got_j[rid] = res, out_b[rid], out_j[rid]

    for _ in range(int(rng.integers(4, 10))):
        if expect and rng.random() < 0.35:
            do_flush()
        else:
            kind = int(rng.integers(0, 3))
            s = int(rng.integers(0, 10 ** 8))
            pair, ctl = problem(kind, s), controls(s)
            rid = submit(cont, pair, ctl)
            assert barr.submit(*pair[1], controls=ctl[1]) == rid
            expect[rid] = (pair[1], ctl[1])
    do_flush()
    do_flush()      # drained queue: nothing returned twice
    assert sorted(got) == sorted(expect)
    for rid in got:
        assert_same_bits(got[rid], got_b[rid])
        assert_parity(got[rid], got_j[rid])
    # spot-check lanes against the port's own unbatched solve (padding
    # roundoff, counts exact)
    for rid in list(got)[:2]:
        prob, ctl = expect[rid]
        ref = port_solo(prob, ctl)
        np.testing.assert_allclose(got[rid].plan.numpy(), ref.plan.numpy(),
                                   atol=1e-10)
        assert (got[rid].info.outer_iters, got[rid].info.inner_iters) == \
            (ref.info.outer_iters, ref.info.inner_iters)


# ---------------------------------------------------------------------------
# (c) the slot-width menu bounds a shape-varying stream
# ---------------------------------------------------------------------------

def test_slot_width_menu_bounded_by_buckets(monkeypatch):
    """The reference's test_compile_cache_bounded_by_buckets counts jit
    executables; the port has no compile cache, and its counterpart is the
    slot-width menu: ≤ log2(max_batch)+1 widths a bucket, and a second
    stream of the same shapes with fresh data and knobs adds no (bucket,
    width) pair."""
    widths = Widths(monkeypatch)
    eng = port_engine(max_batch=4, size_bucket=16, tol=TOL, segment_iters=3)

    def rounds(offset):
        for i, count in enumerate([1, 2, 3, 4, 5, 7]):
            for j in range(count):
                s = offset + 13 * i + j
                eng.submit(*problem((i + j) % 2, s)[1],
                           controls=controls(s)[1])
            assert len(eng.flush()) == count

    rounds(0)
    menu = widths.by_bucket()
    assert len(menu) == 2                 # grid and point-cloud buckets
    for ws in menu.values():
        assert ws <= {1, 2, 4} and len(ws) <= 3
    seen = set(widths.seen)
    rounds(10 ** 6)
    assert widths.seen == seen


# ---------------------------------------------------------------------------
# difficulty-aware admission
# ---------------------------------------------------------------------------

def test_hardness_predictor_orders_sensibly():
    """The port's predictor orders as the reference's and gives its
    numbers."""
    jeng, eng = engines(tol=TOL)
    jprob, prob = problem(0, 0)

    def both(rid, knobs, errs=None):
        return (jeng.predicted_hardness(jengine_mod._Request(
                    rid, jprob, {}, knobs=knobs, errs=errs)),
                eng.predicted_hardness(engine_mod._Request(
                    rid, prob, {}, knobs=knobs, errs=errs)))

    cases = {
        "easy": both(0, (5e-2, TOL, 5e-2, 0.5)),
        "sharp": both(1, (2e-3, TOL, 2e-3, 0.5)),
        "annealed": both(2, (2e-3, TOL, 5e-2, 0.5)),
        "slow": both(3, (5e-2, TOL, 5e-2, 0.5),
                     np.array([1e-2, 9.9e-3, 9.8e-3])),
        "fast": both(4, (5e-2, TOL, 5e-2, 0.5),
                     np.array([1e-2, 1e-4, 1e-6]))}
    for hj, ht in cases.values():
        assert ht == pytest.approx(hj, rel=1e-14)
    h = {k: v[1] for k, v in cases.items()}
    assert h["sharp"] > h["easy"]
    assert h["annealed"] > h["sharp"]
    assert h["slow"] > h["fast"]
    assert h["slow"] > h["easy"]


def test_hardness_ordering_changes_schedule_not_results():
    def run(order):
        eng = port_engine(max_batch=2, size_bucket=16, tol=TOL,
                          segment_iters=2, order_by_hardness=order)
        for i, eps in enumerate([5e-2, 8e-3, 5e-2, 2e-2, 8e-3]):
            eng.submit(*problem(0, 777 + i)[1], eps=eps, eps_init=5e-2)
        return eng.flush()

    out_a, out_b = run(True), run(False)
    assert set(out_a) == set(out_b) == set(range(5))
    for rid in out_a:
        assert_same_bits(out_a[rid], out_b[rid])


# ---------------------------------------------------------------------------
# failure isolation in the continuous scheduler
# ---------------------------------------------------------------------------

def _big_problem():
    """A Grid1D(24) request: its own pad-24 bucket at size_bucket 8."""
    jx = j_as_geometry(jcore.Grid1D(24, 1 / 23, 1), SOLVER.backend)
    tx = core.as_geometry(core.Grid1D(24, 1 / 23, 1), SOLVER.backend)
    mu, nu = measures(24, 90), measures(24, 91)
    return ((jx, jx, jax.numpy.asarray(mu), jax.numpy.asarray(nu)),
            (tx, tx, t(mu), t(nu)))


def test_continuous_bucket_failure_isolates_and_requeues(monkeypatch):
    eng = port_engine(max_batch=4, size_bucket=8, tol=TOL, segment_iters=2)
    good = [eng.submit(*problem(0, 50 + i)[1], controls=controls(50 + i)[1])
            for i in range(2)]
    jbig, big = _big_problem()
    ctl_b = core.SolveControls.make(8e-3, TOL, 5e-2, 0.5)
    bad = eng.submit(*big, controls=ctl_b)
    real = engine_mod._segment_stacked
    calls = {"n": 0}

    def failing(gx, gy, mus, nus, feats, ctls, carry, cfg, segment):
        if mus.shape[1] >= 24:        # only the big bucket
            calls["n"] += 1
            if calls["n"] >= 2:       # fail on its second segment
                raise RuntimeError("injected mid-solve failure")
        return real(gx, gy, mus, nus, feats, ctls, carry, cfg, segment)

    monkeypatch.setattr(engine_mod, "_segment_stacked", failing)
    out = eng.flush()                 # must not raise: good bucket solved
    assert set(out) == set(good)
    assert all(out[rid].info.converged for rid in good)
    # the interrupted request is requeued cold, with its observed trace as
    # a hardness hint
    assert [r.rid for r in eng._queue] == [bad]
    req = eng._queue[0]
    assert req.errs is not None and np.isfinite(req.errs).sum() >= 1
    fresh = engine_mod._Request(99, big, {}, knobs=(8e-3, TOL, 5e-2, 0.5))
    assert eng.predicted_hardness(req) >= eng.predicted_hardness(fresh)
    assert len(eng.last_errors) == 1
    assert isinstance(eng.last_errors[0][1], RuntimeError)
    with pytest.raises(RuntimeError):
        eng.flush()
    monkeypatch.setattr(engine_mod, "_segment_stacked", real)
    out2 = eng.flush()
    assert set(out2) == {bad} and eng._queue == []
    # the interruption left no trace in the result
    ref = jcore.entropic_gw(*jbig, SOLVER, controls=jcore.SolveControls.make(
        8e-3, TOL, 5e-2, 0.5))
    assert_parity(out2[bad], ref)


# ---------------------------------------------------------------------------
# per-request knobs through submit()
# ---------------------------------------------------------------------------

def test_unknown_scheduler_rejected():
    eng = port_engine(scheduler="continous")
    eng.submit(*problem(0, 1)[1])
    with pytest.raises(ValueError, match="unknown scheduler"):
        eng.flush()


def test_engine_needs_a_device():
    """Without a card and without device="cpu" the engine raises, as every
    entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GWEngine(GWServeConfig())


def test_engine_knob_retune_reaches_queued_requests():
    """Engine-level knobs resolve at flush time: a request queued before a
    ``cfg.tol`` retune solves under the new tolerance; an explicitly pinned
    one keeps its own."""
    engs = engines(max_batch=4, size_bucket=16, tol=1e-2, segment_iters=3)
    pair = problem(0, 42)
    rid_default = submit(engs, pair)
    rid_pinned = submit(engs, pair, tol=1e-2)
    for e in engs:
        e.cfg.tol = TOL
    out_j, out = engs[0].flush(), engs[1].flush()
    assert float(out[rid_default].info.marginal_err) <= TOL
    assert out[rid_pinned].info.outer_iters < \
        out[rid_default].info.outer_iters
    for rid in (rid_default, rid_pinned):
        assert_parity(out[rid], out_j[rid])


def test_per_request_eps_mixed_stream_converges_to_each_target():
    engs = engines(max_batch=4, size_bucket=16, tol=TOL, segment_iters=3)
    reqs = {}
    for i, eps in enumerate([5e-2, 2e-2, 8e-3, 5e-2, 8e-3]):
        pair = problem(0, 300 + i)
        reqs[submit(engs, pair, eps=eps, eps_init=5e-2)] = (pair, eps)
    out_j, out = engs[0].flush(), engs[1].flush()
    assert set(out) == set(out_j) == set(reqs)
    counts = set()
    for rid, (pair, eps) in reqs.items():
        assert out[rid].info.converged
        assert float(out[rid].info.marginal_err) <= TOL
        assert_parity(out[rid], out_j[rid])
        counts.add(out[rid].info.outer_iters)
    assert len(counts) > 1     # difficulties genuinely differ


# ---------------------------------------------------------------------------
# tests/test_gw_batch.py, test_solver.py and test_geometry.py engine cases
# ---------------------------------------------------------------------------

BATCH_CFG = jcore.GWConfig(eps=2e-3, outer_iters=6, sinkhorn_iters=120,
                           backend="cumsum")


def _grid_pairs(sizes, seed0=0):
    out = []
    for i, (m, n) in enumerate(sizes):
        mu, nu = measures(m, seed0 + 2 * i), measures(n, seed0 + 2 * i + 1)
        out.append(((jcore.Grid1D(m, 1 / (m - 1), 1),
                     jcore.Grid1D(n, 1 / (n - 1), 1), jax.numpy.asarray(mu),
                     jax.numpy.asarray(nu)),
                    (core.Grid1D(m, 1 / (m - 1), 1),
                     core.Grid1D(n, 1 / (n - 1), 1), t(mu), t(nu))))
    return out


@pytest.mark.parametrize("backend", ["cumsum", "scan", "dense", "blocked"])
def test_engine_flush_matches_single(backend):
    """A grid bucket on each FGC backend of the CPU against the
    reference's engine on the same backend, and against the port's solo
    solves (atol 1e-8, the reference's bar)."""
    solver = dataclasses.replace(BATCH_CFG, backend=backend)
    engs = engines(solver, max_batch=3, size_bucket=32)
    pairs = _grid_pairs([(20, 25), (30, 18), (25, 25), (50, 40), (12, 12)])
    rids = [submit(engs, p) for p in pairs]
    out_j, out = engs[0].flush(), engs[1].flush()
    assert set(out) == set(out_j) == set(rids)
    for rid, (_, p) in zip(rids, pairs):
        assert_parity(out[rid], out_j[rid])
        assert out[rid].plan.shape == (p[0].size, p[1].size)
        ref = port_solo(p, None, solver)
        np.testing.assert_allclose(out[rid].plan.numpy(), ref.plan.numpy(),
                                   atol=1e-8)
    assert engs[1].flush() == {}       # queue drained


def test_engine_rejects_malformed_request_at_submit():
    eng = port_engine(BATCH_CFG, size_bucket=16)
    gx = core.Grid1D(5, 0.1, 1)
    with pytest.raises(ValueError):
        eng.submit(gx, gx, measures(20, 0), measures(5, 1))
    assert eng._queue == []
    with pytest.raises(ValueError):
        core.entropic_gw_batch([(gx, gx, measures(20, 0), measures(5, 1))],
                               convert.gw_config(dataclasses.asdict(
                                   BATCH_CFG)), device="cpu")


def test_engine_partial_failure_isolates_bucket(monkeypatch):
    """Barrier scheduler: a bucket that raises leaves its requests queued
    and records the error; other buckets still return."""
    eng = port_engine(BATCH_CFG, size_bucket=16, scheduler="barrier")
    good = [p[1] for p in _grid_pairs([(10, 12), (14, 9)])]
    good_rids = [eng.submit(*p) for p in good]
    bad = core.Grid1D(40, 0.1, 1)
    bad_rid = eng.submit(bad, bad, measures(40, 0), measures(40, 1))
    real = engine_mod.entropic_gw_batch

    def failing(probs, cfg, pad_to=None, **kw):
        if pad_to and pad_to[0] >= 48:   # only the bad request's bucket
            raise RuntimeError("injected bucket failure")
        return real(probs, cfg, pad_to=pad_to, **kw)

    monkeypatch.setattr(engine_mod, "entropic_gw_batch", failing)
    out = eng.flush()
    assert set(out) == set(good_rids)
    for rid, p in zip(good_rids, good):
        np.testing.assert_allclose(out[rid].plan.numpy(),
                                   port_solo(p, None, BATCH_CFG).plan.numpy(),
                                   atol=1e-8)
    assert [r.rid for r in eng._queue] == [bad_rid]
    assert len(eng.last_errors) == 1
    assert isinstance(eng.last_errors[0][1], RuntimeError)
    with pytest.raises(RuntimeError):
        eng.flush()
    assert [r.rid for r in eng._queue] == [bad_rid]
    monkeypatch.setattr(engine_mod, "entropic_gw_batch", real)
    out2 = eng.flush()
    assert set(out2) == {bad_rid} and eng._queue == []


def test_engine_mixed_grid_pointcloud_queue():
    engs = engines(BATCH_CFG, max_batch=4, size_bucket=32)
    rng = np.random.default_rng(7)
    rids = [submit(engs, p) for p in
            _grid_pairs([(20, 25), (30, 18), (25, 25)])]
    for i, n in enumerate([22, 17, 28]):
        pts = rng.normal(size=(n, 2))
        mu, nu = measures(n, 50 + i), measures(n, 60 + i)
        jp, tp = JPC(jax.numpy.asarray(pts)), core.PointCloudGeometry(t(pts))
        rids.append(submit(engs, ((jp, jp, jax.numpy.asarray(mu),
                                   jax.numpy.asarray(nu)),
                                  (tp, tp, t(mu), t(nu)))))
    keys = {engs[1]._bucket_key(r) for r in engs[1]._queue
            if engs[1]._resolve(r) is None}
    assert len(keys) == 2
    out_j, out = engs[0].flush(), engs[1].flush()
    assert set(out) == set(out_j) == set(rids)
    for rid in rids:
        assert_parity(out[rid], out_j[rid])
    assert engs[1].flush() == {}


def test_engine_tol_knob_and_per_request_info(monkeypatch):
    """Per-request ConvergenceInfo, and a serving-tol retune that reuses
    the bucket's slot widths (the reference: no recompilation)."""
    widths = Widths(monkeypatch)
    solver = jcore.GWConfig(eps=5e-2, outer_iters=30, sinkhorn_iters=300)
    engs = engines(solver, max_batch=4, size_bucket=32, tol=1e-6)
    pairs = _grid_pairs([(20, 25), (30, 18), (25, 25)])
    rids = [submit(engs, p) for p in pairs]
    out_j, out = engs[0].flush(), engs[1].flush()
    assert len(out) == 3
    for rid, (_, p) in zip(rids, pairs):
        res = out[rid]
        assert res.info.converged
        assert res.info.inner_iters < 30 * 300
        assert float(res.info.marginal_err) <= 1e-6
        assert tuple(res.errs.shape) == (30,)
        assert_parity(res, out_j[rid])
    seen = set(widths.seen)
    engs[1].cfg.tol = 1e-4
    for _, p in pairs:
        engs[1].submit(*p)
    assert len(engs[1].flush()) == 3
    assert widths.seen == seen


def test_engine_pointcloud_stream_bucketed_widths(monkeypatch):
    """tests/test_geometry.py:314 on the port: a ragged point-cloud stream
    in two buckets, each result against the reference's engine; a second
    wave of the same buckets adds no slot width."""
    widths = Widths(monkeypatch)
    solver = jcore.GWConfig(eps=5e-3, outer_iters=5, sinkhorn_iters=100)
    engs = engines(solver, max_batch=4, size_bucket=16)
    rng = np.random.default_rng(123)

    def wave(sizes, s0):
        rids = []
        for i, n in enumerate(sizes):
            pts = rng.normal(size=(n, 2))
            mu, nu = measures(n, s0 + i), measures(n, s0 + 100 + i)
            jp, tp = JPC(jax.numpy.asarray(pts)), \
                core.PointCloudGeometry(t(pts))
            rids.append(submit(engs, ((jp, jp, jax.numpy.asarray(mu),
                                       jax.numpy.asarray(nu)),
                                      (tp, tp, t(mu), t(nu)))))
        out_j, out = engs[0].flush(), engs[1].flush()
        assert set(out) == set(out_j) == set(rids)
        for rid in rids:
            assert_parity(out[rid], out_j[rid])

    wave([10, 13, 16, 9, 20, 11, 18], 200)
    menu = widths.by_bucket()
    assert len(menu) == 2 and all(ws <= {1, 2, 4} for ws in menu.values())
    seen = set(widths.seen)
    wave([12, 15, 14, 9, 19, 17], 400)
    assert widths.seen == seen
