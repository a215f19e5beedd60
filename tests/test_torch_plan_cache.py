"""The port's plan cache (`repro_torch.serve.cache`) and the engine's cache
stages, against the reference's, on the CPU.

Replays tests/test_plan_cache.py.  Fingerprints take numpy arrays or
tensors (a tensor's host bytes, so a tensor and its numpy copy share a
digest); the unit cases run on both.  Engine cases run the same streams
through the reference's and the port's engines (the sliced profile stage
on the reference's direction bank, carried by ``convert.serve_config``),
at the serving bars (tests/_torch_serve.py), and keep the reference's own
claims: exact hits are the first answer's bits with no dispatch, near and
profile hits converge in strictly fewer outer steps to the same optimum.
Plus: a cache entry is unchanged after later flushes refill its slot."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve import (TOL, WARM_SOLVER, WARM_TOL, assert_parity,
                          assert_same_bits, controls, engines, pc_problem,
                          port_engine, problem, reference_bank, submit, t)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.geometry import PointCloudGeometry as JPC
from repro.serve.cache import fingerprint as j_fingerprint
from repro_torch import core
from repro_torch.kernels import ops
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.cache import PlanCache, fingerprint

LEAF_KINDS = ["numpy", "tensor"]


def _leaf(kind):
    return (lambda a: np.asarray(a)) if kind == "numpy" else \
        (lambda a: torch.from_numpy(np.array(a)))


# ---------------------------------------------------------------------------
# fingerprint unit behaviour
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_fingerprint_exact_and_near_digests(kind):
    L = _leaf(kind)
    r = np.random.default_rng(0)
    raw = [r.normal(size=(5, 3)), r.random(5)]
    leaves = [L(a) for a in raw]
    knobs = [1e-1, 1e-6]
    fp = fingerprint(("s",), leaves, knobs, near_tol=1e-3)
    same = fingerprint(("s",), [L(np.array(a)) for a in raw], list(knobs),
                       near_tol=1e-3)
    assert fp == same
    nearby = fingerprint(("s",), [L(raw[0] + 1e-7), leaves[1]], knobs,
                         near_tol=1e-3)
    assert nearby.exact != fp.exact and nearby.near == fp.near
    far = fingerprint(("s",), [L(raw[0] + 1.0), leaves[1]], knobs,
                      near_tol=1e-3)
    assert far.exact != fp.exact and far.near != fp.near
    assert fingerprint(("s",), leaves, [2e-1, 1e-6],
                       near_tol=1e-3).exact != fp.exact
    assert fingerprint(("s",), leaves, knobs).near is None
    # a leaf's digest is its host bytes: the reference's digest of the
    # numpy copy
    jfp = j_fingerprint(("s",), raw, knobs, near_tol=1e-3)
    assert (fp.exact, fp.near) == (jfp.exact, jfp.near)


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_fingerprint_shape_dtype_and_static_separate(kind):
    L = _leaf(kind)
    a = np.arange(6, dtype=np.float64)
    fp_flat = fingerprint(("s",), [L(a)], [], near_tol=1e-3)
    fp_2d = fingerprint(("s",), [L(a.reshape(2, 3))], [], near_tol=1e-3)
    fp_f32 = fingerprint(("s",), [L(a.astype(np.float32))], [],
                         near_tol=1e-3)
    assert len({fp_flat.exact, fp_2d.exact, fp_f32.exact}) == 3
    assert fingerprint(("t",), [L(a)], []).static != fp_flat.static


def test_cache_rejects_bad_construction():
    with pytest.raises(ValueError, match="capacity"):
        PlanCache(0)
    with pytest.raises(ValueError, match="near_tol"):
        PlanCache(4, near_tol=-1e-3)


def test_cache_lru_eviction_and_counters():
    c = PlanCache(2, near_tol=1e-3)
    fps = [fingerprint(("s",), [np.full(3, float(i))], [], 1e-3)
           for i in range(3)]
    c.store(fps[0], "r0")
    c.store(fps[1], "r1")
    assert c.lookup(fps[0]) == ("exact", "r0")
    c.store(fps[2], "r2")
    assert len(c) == 2 and c.evictions == 1
    assert c.lookup(fps[1]) == (None, None)
    assert c.lookup(fps[0]) == ("exact", "r0")
    assert c.lookup(fps[2]) == ("exact", "r2")
    assert (c.hits, c.misses) == (3, 1)
    near1 = fingerprint(("s",), [np.full(3, 1.0) + 1e-7], [], 1e-3)
    assert near1.near == fps[1].near
    assert c.lookup(near1) == (None, None)


def test_cache_near_hit_latest_wins():
    c = PlanCache(4, near_tol=1e-3)
    base = np.linspace(0.0, 1.0, 4)
    fp_a = fingerprint(("s",), [base], [], 1e-3)
    fp_b = fingerprint(("s",), [base + 1e-8], [], 1e-3)
    assert fp_a.exact != fp_b.exact and fp_a.near == fp_b.near
    c.store(fp_a, "old")
    c.store(fp_b, "new")
    assert c.lookup(fingerprint(("s",), [base + 2e-8], [], 1e-3)) == \
        ("near", "new")
    assert c.near_hits == 1
    assert c.lookup(fingerprint(("t",), [base + 2e-8], [], 1e-3)) == \
        (None, None)


@pytest.mark.parametrize("kind", LEAF_KINDS)
def test_nan_leaf_never_collides_with_inf_leaf(kind):
    L = _leaf(kind)
    fa, fb, fc = (fingerprint(("s",), [L([1.0, v, 3.0])], [], near_tol=1e-3)
                  for v in (np.nan, np.inf, -np.inf))
    assert len({fa.near, fb.near, fc.near}) == 3
    assert len({fa.exact, fb.exact, fc.exact}) == 3
    payload = np.frombuffer(np.uint64(0x7FF8000000000001).tobytes(),
                            np.float64)[0]
    fa2 = fingerprint(("s",), [L(np.array([1.0, payload, 3.0]))], [],
                      near_tol=1e-3)
    assert fa2.near == fa.near and fa2.exact != fa.exact
    fa3 = fingerprint(("s",), [L([np.nan, 1.0, 3.0])], [], near_tol=1e-3)
    assert fa3.near != fa.near


def test_near_digest_separates_close_knobs():
    leaves = [np.arange(6.0)]
    f3 = fingerprint(("s",), leaves, [1e-3], near_tol=1e-2)
    f4 = fingerprint(("s",), leaves, [1e-4], near_tol=1e-2)
    assert f3.exact != f4.exact and f3.near != f4.near


def test_profile_match_unit_gates_on_knobs_static_and_distance():
    cache = PlanCache(4, near_tol=1e-3)
    fp = fingerprint(("s",), [np.arange(4.0)], [0.1], near_tol=1e-3)
    prof = np.array([1.0, 2.0, 3.0])
    cache.store(fp, "R", profile=prof, knob_key=b"k1", aux=("ox", "oy"))
    assert cache.profile_match(("s",), b"k1", prof + 1e-9, 0.05) == \
        ("R", ("ox", "oy"))
    assert cache.profile_hits == 1
    assert cache.profile_match(("s",), b"k2", prof, 0.05) is None
    assert cache.profile_match(("t",), b"k1", prof, 0.05) is None
    assert cache.profile_match(("s",), b"k1", prof * 3, 0.05) is None
    assert cache.profile_match(("s",), b"k1", np.ones(5), 0.05) is None
    fp2 = fingerprint(("s",), [np.arange(4.0) + 9], [0.1], near_tol=1e-3)
    cache.store(fp2, "S")
    assert cache.profile_match(("s",), None, prof * 0 + 99, 1e9) is None
    small = PlanCache(1, near_tol=1e-3)
    small.store(fp, "R", profile=prof, knob_key=b"k", aux=None)
    small.store(fp2, "S", profile=prof + 10, knob_key=b"k", aux=None)
    assert small.profile_match(("s",), b"k", prof, 0.05) is None
    assert small.profile_match(("s",), b"k", prof + 10, 0.05) is not None


# ---------------------------------------------------------------------------
# engine: exact hits, near hits, eviction, structural isolation
# ---------------------------------------------------------------------------

def _cache_engines(**kw):
    return engines(max_batch=4, size_bucket=16, tol=TOL,
                   scheduler="pipeline", segment_iters=3, **kw)


def test_exact_hit_bit_identical_without_any_dispatch(monkeypatch):
    """Exact repeats: the first answers' objects, no segment dispatched and
    no kernel launched."""
    engs = _cache_engines(cache_capacity=8)
    pairs = [(problem(k, 600 + k), controls(600 + k)) for k in range(3)]
    rids = [submit(engs, p, c) for p, c in pairs]
    cold_j, cold = engs[0].flush(), engs[1].flush()
    for rid in rids:
        assert_parity(cold[rid], cold_j[rid])
    eng = engs[1]
    assert eng.stats["cache_hits"] == 0 and eng.stats["dispatches"] > 0
    calls = []
    real = engine_mod._segment_stacked
    monkeypatch.setattr(engine_mod, "_segment_stacked",
                        lambda *a: calls.append(1) or real(*a))
    ops.reset_launch_counts()
    rids2 = [eng.submit(*p[1], controls=c[1]) for p, c in pairs]
    hot = eng.flush()
    assert eng.stats["cache_hits"] == 3
    assert eng.stats["dispatches"] == 0 and eng.stats["refills"] == 0
    assert calls == [] and not any(ops.LAUNCHES.values())
    for r0, r1 in zip(rids, rids2):
        assert hot[r1] is cold[r0]
        assert_same_bits(cold[r0], hot[r1], value_rtol=0.0)


def test_cache_disabled_by_default_and_knob_flip_misses():
    assert port_engine(tol=TOL).cache is None
    eng = port_engine(max_batch=4, size_bucket=16, tol=TOL,
                      scheduler="pipeline", segment_iters=3,
                      cache_capacity=8)
    prob = problem(1, 640)[1]
    eng.submit(*prob, eps=5e-2)
    eng.flush()
    eng.submit(*prob, eps=2e-2)
    eng.flush()
    assert eng.stats["cache_hits"] == 0
    assert eng.stats["cache_misses"] == 1
    assert eng.stats["dispatches"] > 0


def _perturb(pair, delta):
    (jx, jy, jmu, jnu), (tx, ty, tmu, tnu) = pair
    return ((JPC(jx.points + delta, jx.metric),
             JPC(jy.points + delta, jy.metric), jmu, jnu),
            (core.PointCloudGeometry(tx.points + delta, tx.metric),
             core.PointCloudGeometry(ty.points + delta, ty.metric), tmu, tnu))


@pytest.mark.parametrize("scheduler", ["pipeline", "continuous"])
def test_near_hit_warm_start_converges_faster_same_optimum(scheduler):
    engs = engines(WARM_SOLVER, max_batch=4, size_bucket=16, tol=WARM_TOL,
                   scheduler=scheduler, segment_iters=5, cache_capacity=8,
                   cache_near_tol=1e-3)
    pairs = [pc_problem(8, 12, 0), pc_problem(12, 8, 1)]
    cold_rids = [submit(engs, p) for p in pairs]
    cold_j, cold = engs[0].flush(), engs[1].flush()
    for rid in cold_rids:
        assert cold[rid].info.converged
        assert_parity(cold[rid], cold_j[rid])
    warm_rids = [submit(engs, _perturb(p, 1e-7)) for p in pairs]
    warm_j, warm = engs[0].flush(), engs[1].flush()
    eng = engs[1]
    assert eng.stats["cache_warm_starts"] == 2
    assert eng.stats["cache_hits"] == 0
    for crid, wrid in zip(cold_rids, warm_rids):
        c, w = cold[crid], warm[wrid]
        assert w.info.converged
        assert w.info.outer_iters < c.info.outer_iters
        assert float((w.plan - c.plan).abs().sum()) < 1e-3
        np.testing.assert_allclose(float(w.value), float(c.value),
                                   rtol=1e-3, atol=1e-6)
        assert_parity(w, warm_j[wrid])


def test_near_hit_is_miss_under_barrier():
    eng = port_engine(WARM_SOLVER, max_batch=4, size_bucket=16, tol=WARM_TOL,
                      scheduler="barrier", cache_capacity=8,
                      cache_near_tol=1e-3)
    pair = pc_problem(8, 12, 2)
    rid0 = eng.submit(*pair[1])
    cold = eng.flush()
    rid1 = eng.submit(*_perturb(pair, 1e-7)[1])
    out = eng.flush()
    assert eng.stats["cache_warm_starts"] == 0
    assert eng.stats["cache_misses"] == 1
    assert eng.stats["dispatches"] > 0
    assert out[rid1].info.outer_iters == cold[rid0].info.outer_iters


def test_engine_cache_eviction_respects_capacity():
    eng = port_engine(max_batch=4, size_bucket=16, tol=TOL,
                      scheduler="pipeline", segment_iters=3,
                      cache_capacity=2)
    probs = [(problem(0, 660 + i)[1], controls(660 + i)[1])
             for i in range(3)]
    for p, c in probs:
        eng.submit(*p, controls=c)
    eng.flush()
    assert len(eng.cache) == 2 and eng.cache.evictions == 1
    eng.submit(*probs[0][0], controls=probs[0][1])   # evicted → miss
    eng.submit(*probs[2][0], controls=probs[2][1])   # resident → hit
    assert len(eng.flush()) == 2
    assert eng.stats["cache_hits"] == 1
    assert eng.stats["cache_misses"] == 1
    assert len(eng.cache) == 2


def test_plan_flip_never_cross_contaminates():
    eng = port_engine(max_batch=4, size_bucket=16, tol=TOL,
                      scheduler="pipeline", segment_iters=3,
                      cache_capacity=8, cache_near_tol=1e-3)
    prob, ctl = problem(1, 680)[1], controls(680)[1]
    eng.submit(*prob, controls=ctl)
    assert len(eng.flush()) == 1
    rid = eng.submit(*prob, controls=ctl, plan="lowrank")
    out = eng.flush()
    assert eng.stats["cache_hits"] == 0
    assert eng.stats["cache_warm_starts"] == 0
    assert eng.stats["cache_misses"] == 1
    assert out[rid].plan is None and out[rid].coupling is not None
    assert len(eng.cache) == 2


def test_backend_flip_changes_static_fingerprint():
    eng = port_engine(max_batch=4, size_bucket=16, tol=TOL,
                      scheduler="pipeline", segment_iters=3,
                      cache_capacity=8)
    prob, ctl = problem(1, 690)[1], controls(690)[1]
    eng.submit(*prob, controls=ctl)
    eng.flush()
    eng.cfg.solver = dataclasses.replace(eng.cfg.solver,
                                         sinkhorn_backend="torch")
    eng.submit(*prob, controls=ctl)
    eng.flush()
    assert eng.stats["cache_hits"] == 0
    assert eng.stats["cache_misses"] == 1
    assert len(eng.cache) == 2


def test_cache_entry_unchanged_after_later_flushes():
    """A stored entry owns its tensors: later flushes of the same bucket,
    which refill the slot it was harvested from, leave its bits."""
    eng = port_engine(max_batch=2, size_bucket=16, tol=TOL,
                      scheduler="pipeline", segment_iters=3,
                      cache_capacity=16)
    rid = eng.submit(*problem(0, 700)[1], controls=controls(700)[1])
    entry = eng.flush()[rid]
    snap = [x.clone() for x in (entry.plan, entry.f, entry.g, entry.value)]
    for k in range(2):
        for i in range(4):
            s = 710 + 10 * k + i
            eng.submit(*problem(0, s)[1], controls=controls(s)[1])
        eng.flush()
        assert eng.stats["refills"] > 0
    (hit,) = [v for v in eng.cache._entries.values() if v is entry]
    for x, y in zip((hit.plan, hit.f, hit.g, hit.value), snap):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# second stage: sliced-profile matching
# ---------------------------------------------------------------------------

def _rot_perm(pair, seed, rotate=True, permute=True):
    """A semantically identical copy of a point-cloud problem pair: each
    side rotated and/or re-indexed (atoms and weights together)."""
    r = np.random.default_rng(seed)

    def side(pts, w):
        p, wn = np.asarray(pts), np.asarray(w)
        if rotate:
            th = r.uniform(0.0, 2.0 * np.pi)
            q = np.array([[np.cos(th), -np.sin(th)],
                          [np.sin(th), np.cos(th)]])
            p = p @ q.T
        if permute:
            perm = r.permutation(len(p))
            p, wn = p[perm], wn[perm]
        return p, wn

    (jx, jy, jmu, jnu), _ = pair
    (x, mu), (y, nu) = side(jx.points, jmu), side(jy.points, jnu)
    return ((JPC(jnp.asarray(x)), JPC(jnp.asarray(y)), jnp.asarray(mu),
             jnp.asarray(nu)),
            (core.PointCloudGeometry(t(x)), core.PointCloudGeometry(t(y)),
             t(mu), t(nu)))


def _profile_engines(**kw):
    defaults = dict(max_batch=4, size_bucket=16, tol=WARM_TOL,
                    scheduler="pipeline", segment_iters=5,
                    cache_capacity=16, cache_near_tol=1e-3,
                    cache_profile_tol=0.08)
    defaults.update(kw)
    return engines(WARM_SOLVER, banks={2: reference_bank(2)}, **defaults)


@pytest.mark.parametrize("variant", ["rotate", "permute", "both"])
def test_profile_stage_realigns_rotated_and_reindexed_repeats(variant):
    engs = _profile_engines()
    pair = pc_problem(10, 12, 40)
    rid0 = submit(engs, pair)
    cold_j, cold = engs[0].flush()[rid0], engs[1].flush()[rid0]
    assert cold.info.converged and cold.info.outer_iters > 1
    assert_parity(cold, cold_j)
    copy = _rot_perm(pair, 41, rotate=variant != "permute",
                     permute=variant != "rotate")
    rid1 = submit(engs, copy)
    warm_j, warm = engs[0].flush()[rid1], engs[1].flush()[rid1]
    s = engs[1].stats
    assert s["cache_hits"] == 0
    assert s["cache_profile_hits"] == 1
    assert s["cache_warm_starts"] == 1
    assert s["cache_misses"] == 0
    assert warm.info.converged
    assert warm.info.outer_iters < cold.info.outer_iters
    np.testing.assert_allclose(float(warm.value), float(cold.value),
                               rtol=1e-3, atol=1e-6)
    assert_parity(warm, warm_j)


def test_mixed_stream_converts_majority_of_misses_to_warm_starts():
    engs = _profile_engines()
    bases = [pc_problem(10, 12, 50 + i) for i in range(5)]
    cold_rids = [submit(engs, p) for p in bases]
    res_j, res = engs[0].flush(), engs[1].flush()
    cold = [res[r] for r in cold_rids]
    assert all(c.info.converged for c in cold)
    rng = np.random.default_rng(60)
    repeats, fresh = [], []
    for j in range(10):
        if j % 3 == 0:
            i = int(rng.integers(len(bases)))
            repeats.append((i, submit(engs, _rot_perm(bases[i], 70 + j))))
        else:
            fresh.append(submit(engs, pc_problem(10, 12, 80 + j)))
    out_j, out = engs[0].flush(), engs[1].flush()
    s = engs[1].stats
    assert s["cache_hits"] == 0
    assert s["cache_profile_hits"] >= (len(repeats) + 1) // 2 + 1
    assert s["cache_profile_hits"] == engs[0].stats["cache_profile_hits"]
    for i, rid in repeats:
        w = out[rid]
        assert w.info.converged
        assert w.info.outer_iters < cold[i].info.outer_iters
        np.testing.assert_allclose(float(w.value), float(cold[i].value),
                                   rtol=1e-3, atol=1e-6)
    for rid in fresh:
        assert out[rid].info.converged
    for rid in out:
        assert_parity(out[rid], out_j[rid])


def test_profile_stage_respects_barrier_and_knob_boundaries():
    eng = port_engine(WARM_SOLVER, max_batch=4, size_bucket=16,
                      tol=WARM_TOL, scheduler="barrier", cache_capacity=8,
                      cache_near_tol=1e-3, cache_profile_tol=0.08)
    pair = pc_problem(8, 12, 90)
    eng.submit(*pair[1])
    eng.flush()
    eng.submit(*_rot_perm(pair, 91)[1])
    eng.flush()
    assert eng.stats["cache_profile_hits"] == 0
    assert eng.stats["cache_misses"] == 1
    eng2 = _profile_engines()[1]
    eng2.submit(*pair[1], eps=2e-1)
    eng2.flush()
    eng2.submit(*_rot_perm(pair, 92)[1], eps=1e-1)
    eng2.flush()
    assert eng2.stats["cache_profile_hits"] == 0
    assert eng2.stats["cache_misses"] == 1
