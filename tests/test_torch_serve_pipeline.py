"""The port's pipelined scheduler and standing event loop, against the
reference's engine, on the CPU.

Replays tests/test_serve_pipeline.py.  The port runs each in-flight
bucket's segment on a worker thread (on the card, on a CUDA stream of its
own); on the CPU the same threads run without streams.  Its contract:

  (a) every request id returned exactly once;
  (b) results bit for bit those of the barrier and continuous schedulers
      (plans, potentials, factors and counts; values within 1e-12), with
      or without ``donate_carries`` (the port has one code path; the
      reference promises 1e-12 for its donating executable), and at the
      stated bars against the reference's engine;
  (c) the dispatch-depth telemetry records ≥ 2 segments in flight when two
      buckets run;
  (d) a failing bucket is isolated and its requests requeued;
  (e) ``serve`` / ``run_event_loop`` return the flush's results.

Plus: a harvested result is unchanged after its slot is refilled twice,
and the kernels' launch counters lose no count under two threads."""
import sys
import threading

import numpy as np
import pytest
import torch

from _prop import given, settings, st
from _torch_serve import (SOLVER, TOL, assert_parity, assert_same_bits,
                          controls, engines, measures, port_engine,
                          port_solo, problem, submit, t)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.serve.engine import run_event_loop as j_run_event_loop
from repro_torch import core
from repro_torch.kernels import ops
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import run_event_loop


def _mk(sched, **kw):
    kw.setdefault("max_batch", 4)
    return port_engine(size_bucket=16, tol=TOL, scheduler=sched,
                       segment_iters=3, **kw)


def _both(sched, **kw):
    kw.setdefault("max_batch", 4)
    return engines(size_bucket=16, tol=TOL, scheduler=sched,
                   segment_iters=3, **kw)


def _mixed_stream(n, base_seed):
    """n (problem pair, controls pair) cycling over grid / point-cloud /
    low-rank geometries: three buckets."""
    return [(problem(i % 3, base_seed + i), controls(base_seed + i))
            for i in range(n)]


# ---------------------------------------------------------------------------
# (a) + (b): pipeline == barrier == continuous, bit for bit
# ---------------------------------------------------------------------------

@settings(max_examples=4, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=10 ** 6))
def test_pipeline_ids_once_and_identical_to_other_schedulers(seed):
    rng = np.random.default_rng(seed)
    pipe = _both("pipeline", donate_carries=False)
    cont, barr = _mk("continuous"), _mk("barrier")
    expect, got = {}, {}

    def do_flush():
        out_j, out_p = pipe[0].flush(), pipe[1].flush()
        out_c, out_b = cont.flush(), barr.flush()
        assert set(out_p) == set(out_c) == set(out_b) == set(out_j)
        for rid, res in out_p.items():
            assert rid not in got, f"request {rid} returned twice"
            got[rid] = res
            assert_same_bits(res, out_c[rid])
            assert_same_bits(res, out_b[rid])
            assert_parity(res, out_j[rid])

    for _ in range(int(rng.integers(4, 9))):
        if expect and rng.random() < 0.3:
            do_flush()
        else:
            kind = int(rng.integers(0, 3))
            s = int(rng.integers(0, 10 ** 8))
            pair, ctl = problem(kind, s), controls(s)
            rid = submit(pipe, pair, ctl)
            assert cont.submit(*pair[1], controls=ctl[1]) == rid
            assert barr.submit(*pair[1], controls=ctl[1]) == rid
            expect[rid] = (pair[1], ctl[1])
    do_flush()
    do_flush()          # drained queue: nothing returned twice
    assert sorted(got) == sorted(expect)
    rid = sorted(got)[int(rng.integers(len(got)))]
    prob, ctl = expect[rid]
    ref = port_solo(prob, ctl)
    if got[rid].plan is not None:
        np.testing.assert_allclose(got[rid].plan.numpy(), ref.plan.numpy(),
                                   atol=1e-10)
    assert got[rid].info.outer_iters == ref.info.outer_iters


def test_pipeline_no_donation_is_bitwise_with_continuous():
    pipe, cont = _mk("pipeline", donate_carries=False), _mk("continuous")
    for pair, ctl in _mixed_stream(5, 9000):
        assert pipe.submit(*pair[1], controls=ctl[1]) == \
            cont.submit(*pair[1], controls=ctl[1])
    out_p, out_c = pipe.flush(), cont.flush()
    assert set(out_p) == set(out_c) == set(range(5))
    for rid in out_p:
        assert_same_bits(out_p[rid], out_c[rid])


def test_pipeline_donation_is_bitwise():
    """The reference's donating dispatch is a separate executable held to
    1e-12; the port has one code path, so ``donate_carries`` changes no
    bit."""
    don = _both("pipeline", donate_carries=True)
    ref = _mk("pipeline", donate_carries=False)
    for pair, ctl in _mixed_stream(5, 9100):
        assert submit(don, pair, ctl) == ref.submit(*pair[1],
                                                    controls=ctl[1])
    out_j, out_d, out_r = don[0].flush(), don[1].flush(), ref.flush()
    assert set(out_d) == set(out_r) == set(out_j) == set(range(5))
    for rid in out_d:
        assert_same_bits(out_d[rid], out_r[rid], value_rtol=0.0)
        assert_parity(out_d[rid], out_j[rid])


# ---------------------------------------------------------------------------
# (c) telemetry
# ---------------------------------------------------------------------------

def test_pipeline_telemetry_records_overlap():
    pipe = _mk("pipeline", max_inflight_buckets=2)
    for pair, ctl in _mixed_stream(6, 4000):
        pipe.submit(*pair[1], controls=ctl[1])
    assert len(pipe.flush()) == 6
    s = pipe.stats
    assert s["dispatches"] > 0
    assert s["flush_wall_s"] > 0.0
    assert 0.0 <= s["device_idle_s"] <= s["flush_wall_s"]
    assert sum(s["dispatch_depth"].values()) == s["dispatches"]
    assert max(s["dispatch_depth"]) >= 2


def test_pipeline_depth_one_degrades_to_serial():
    pipe = _mk("pipeline", max_inflight_buckets=1)
    cont = _mk("continuous")
    for pair, ctl in _mixed_stream(4, 4100):
        assert pipe.submit(*pair[1], controls=ctl[1]) == \
            cont.submit(*pair[1], controls=ctl[1])
    out_p, out_c = pipe.flush(), cont.flush()
    assert max(pipe.stats["dispatch_depth"]) == 1
    for rid in out_p:
        assert_same_bits(out_p[rid], out_c[rid])


# ---------------------------------------------------------------------------
# (d) failure isolation
# ---------------------------------------------------------------------------

def test_pipeline_bucket_failure_isolates_and_requeues(monkeypatch):
    """A segment that raises on a worker thread surfaces at its harvest:
    the bucket's error is recorded, its request requeued, and the other
    bucket's results land."""
    eng = _mk("pipeline", max_inflight_buckets=2)
    good = [eng.submit(*problem(0, 50 + i)[1], controls=controls(50 + i)[1])
            for i in range(2)]
    big = core.as_geometry(core.Grid1D(24, 1 / 23, 1), SOLVER.backend)
    pb = (big, big, t(measures(24, 90)), t(measures(24, 91)))
    ctl_b = core.SolveControls.make(8e-3, TOL, 5e-2, 0.5)
    bad = eng.submit(*pb, controls=ctl_b)
    real = engine_mod._segment_stacked
    calls = {"n": 0}

    def failing(gx, gy, mus, nus, feats, ctls, carry, cfg, segment):
        if mus.shape[1] >= 24:
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("injected mid-solve failure")
        return real(gx, gy, mus, nus, feats, ctls, carry, cfg, segment)

    monkeypatch.setattr(engine_mod, "_segment_stacked", failing)
    out = eng.flush()
    assert set(out) == set(good)
    assert all(out[rid].info.converged for rid in good)
    assert [r.rid for r in eng._queue] == [bad]
    assert eng._queue[0].errs is not None
    assert len(eng.last_errors) == 1
    assert isinstance(eng.last_errors[0][1], RuntimeError)
    monkeypatch.setattr(engine_mod, "_segment_stacked", real)
    out2 = eng.flush()
    assert set(out2) == {bad} and eng._queue == []
    ref = port_solo(pb, ctl_b)
    np.testing.assert_allclose(out2[bad].plan.numpy(), ref.plan.numpy(),
                               atol=1e-10)
    assert out2[bad].info.outer_iters == ref.info.outer_iters


# ---------------------------------------------------------------------------
# (e) the standing event loop
# ---------------------------------------------------------------------------

def test_event_loop_matches_flush():
    """The loop admits incrementally, so a bucket may run at other slot
    widths than a one-shot flush: plans, potentials and factors keep their
    bits (every lane is its solo solve's), counts are equal; and the loop
    matches the reference's event loop at the stated bars."""
    stream = _mixed_stream(6, 7000)
    cont = _mk("continuous")
    for pair, ctl in stream:
        cont.submit(*pair[1], controls=ctl[1])
    ref = cont.flush()
    served = _both("pipeline", max_inflight_buckets=2)
    seen = []
    got = run_event_loop(served[1], [((*p[1],), {"controls": c[1]})
                                     for p, c in stream],
                         on_result=lambda rid, res: seen.append(rid))
    got_j = j_run_event_loop(served[0], [((*p[0],), {"controls": c[0]})
                                         for p, c in stream])
    assert sorted(got) == sorted(ref) == sorted(seen) == sorted(got_j)
    assert len(seen) == len(set(seen))
    for rid in got:
        assert_same_bits(got[rid], ref[rid])
        assert_parity(got[rid], got_j[rid])


def test_event_loop_handles_lazy_source():
    def source():
        for pair, ctl in _mixed_stream(5, 7500):
            yield ((*pair[1],), {"controls": ctl[1]})

    eng = _mk("pipeline", max_inflight_buckets=2, max_batch=2)
    got = run_event_loop(eng, source())
    assert sorted(got) == list(range(5))
    for res in got.values():
        assert res.info.converged or \
            res.info.outer_iters >= SOLVER.outer_iters


def test_warm_start_hardness_near_zero():
    eng = _mk("continuous")
    prob = problem(1, 0)[1]
    cold = engine_mod._Request(0, prob, {}, knobs=(8e-3, TOL, 5e-2, 0.5))
    warm = engine_mod._Request(1, prob, {}, knobs=(8e-3, TOL, 5e-2, 0.5))
    warm.warm = object()
    assert eng.predicted_hardness(warm) < eng.predicted_hardness(cold) / 10
    easy = engine_mod._Request(2, prob, {}, knobs=(5e-2, TOL, 5e-2, 0.5))
    assert eng.predicted_hardness(warm) < eng.predicted_hardness(easy)


def test_serve_closes_trailing_idle_window_and_matches_flush_stats():
    stream = _mixed_stream(6, 8200)
    flushed = _mk("pipeline", max_inflight_buckets=2)
    for pair, ctl in stream:
        flushed.submit(*pair[1], controls=ctl[1])
    flushed.flush()
    served = _mk("pipeline", max_inflight_buckets=2)
    got = run_event_loop(served, [((*p[1],), {"controls": c[1]})
                                  for p, c in stream])
    assert len(got) == len(stream)
    for eng in (flushed, served):
        s = eng.stats
        assert eng._idle_since is None
        assert eng._inflight == 0
        assert s["flush_wall_s"] > 0.0
        assert 0.0 <= s["device_idle_s"] <= s["flush_wall_s"]
    assert served.stats["device_idle_s"] > 0.0
    assert set(served.stats) == set(flushed.stats)
    assert served.stats["dispatches"] >= flushed.stats["dispatches"]


# ---------------------------------------------------------------------------
# harvested results own their tensors; the launch counters under threads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sched", ["continuous", "pipeline"])
def test_harvested_result_unchanged_after_its_slot_is_refilled(sched,
                                                               monkeypatch):
    """Two slots, eight requests of one bucket: the first harvested lane's
    slot is refilled at least twice while the flush (or the event loop)
    runs on, and the result already harvested keeps every bit, in storage
    of its own."""
    eng = _mk(sched, max_batch=2)
    first, refilled = [], []
    real_harvest = engine_mod.GWEngine._harvest
    real_scatter = engine_mod._BucketRun._scatter

    def harvest(self, carry, values, i, req):
        res = real_harvest(self, carry, values, i, req)
        if not first:
            first.append((res, [x.clone() for x in (res.plan, res.f, res.g,
                                                    res.value)],
                          i, len(refilled)))
        return res

    def scatter(self, refills):
        refilled.extend(i for i, _ in refills)
        return real_scatter(self, refills)

    monkeypatch.setattr(engine_mod.GWEngine, "_harvest", harvest)
    monkeypatch.setattr(engine_mod._BucketRun, "_scatter", scatter)
    stream = [problem(0, 3000 + i)[1] for i in range(8)]
    if sched == "pipeline":
        assert len(run_event_loop(eng, stream)) == 8
    else:
        for p in stream:
            eng.submit(*p)
        assert len(eng.flush()) == 8
    res, snap, slot, before = first[0]
    assert refilled[before:].count(slot) >= 2
    for x, y in zip((res.plan, res.f, res.g, res.value), snap):
        assert torch.equal(x, y)
    assert res.plan.untyped_storage().nbytes() == res.plan.numel() * 8


def test_launch_counts_exact_under_two_threads():
    """The kernels' launch counters are taken under a lock: two threads
    counting at once lose nothing."""
    ops.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            for _ in range(20000):
                ops.count_launch("sinkhorn_row_update")
        threads = [threading.Thread(target=count) for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(interval)
    assert ops.LAUNCHES["sinkhorn_row_update"] == 40000
    ops.reset_launch_counts()
    assert not any(ops.LAUNCHES.values())
