"""Shared inputs and bars of the port's serving tests (not collected).

The same request streams, made with numpy from a seed, go through the
reference's ``repro.serve.engine.GWEngine`` and the port's
``repro_torch.serve.engine.GWEngine`` (``device="cpu"``, its config from
``convert.serve_config``).  The generators follow
tests/test_serve_continuous.py and tests/test_plan_cache.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import core as jcore
from repro.core.geometry import PointCloudGeometry as JPC
from repro.core.geometry import as_geometry as j_as_geometry
from repro.serve.engine import GWEngine as JEngine
from repro.serve.engine import GWServeConfig as JServeConfig
from repro_torch import convert, core
from repro_torch.core.solver import fields_of
from repro_torch.serve.engine import GWEngine

SOLVER = jcore.GWConfig(eps=5e-2, outer_iters=16, sinkhorn_iters=120,
                        sinkhorn_chunk=20)
TOL = 1e-6
SIZES = [8, 12, 16]
EPS_MENU = [5e-2, 2e-2, 8e-3]
# tests/test_plan_cache.py's annealed solver, on which small point-cloud
# problems converge (not cap out)
WARM_SOLVER = jcore.GWConfig(eps=2e-1, outer_iters=80, sinkhorn_iters=300,
                             sinkhorn_chunk=25, backend="dense", eps_init=1.0,
                             anneal_decay=0.7)
WARM_TOL = 1e-4

# the bars against the reference
PLAN_FRO = 1e-12
# a lane that stops at its outer cap unconverged (point clouds at
# ε = 8e-3 in the random streams, the inner solve at its cap on every step)
# is held to ‖ΔP‖_F < 1e-10, just above the largest distance measured on
# the streams' capped lanes (2.3e-11): the port's solo solve already sits
# 9.2e-13 from the reference's on such a lane (the cost's matmul rounds
# otherwise under MKL than under XLA, and unconverged steps amplify it),
# and its engine lane equals that solo solve bit for bit
CAPPED_PLAN_FRO = 1e-10
FAC_RTOL, FAC_ATOL = 1e-10, 1e-12
VALUE_RTOL = 1e-10
# the value's absolute floor: E(Γ) is the difference of O(1)–O(10) terms,
# so a near-zero value (isometric copies) carries their rounding, ~3e-13
VALUE_ATOL = 1e-12


def t(a):
    return torch.from_numpy(np.array(a))


def measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def geometry(kind: int, n: int, seed: int):
    """(reference, port) geometry.  kind 0: uniform grid (FGC); 1: raw
    point cloud; 2: its exact low-rank sqeuclidean factorization."""
    if kind == 0:
        return (j_as_geometry(jcore.Grid1D(n, 1 / (n - 1), 1),
                              SOLVER.backend),
                core.as_geometry(core.Grid1D(n, 1 / (n - 1), 1),
                                 convert.FGC_BACKEND_NAMES[SOLVER.backend]))
    pts = np.random.default_rng(seed).normal(size=(n, 2))
    jp, tp = JPC(jnp.asarray(pts)), core.PointCloudGeometry(t(pts))
    return (jp, tp) if kind == 1 else (jp.to_low_rank(), tp.to_low_rank())


def problem(kind: int, seed: int):
    """(reference problem, port problem) of tests/test_serve_continuous.py's
    ``_problem``."""
    r = np.random.default_rng(seed)
    m, n = int(r.choice(SIZES)), int(r.choice(SIZES))
    (jx, tx), (jy, ty) = geometry(kind, m, seed), geometry(kind, n, seed + 1)
    mu, nu = measures(m, seed + 2), measures(n, seed + 3)
    return (jx, jy, jnp.asarray(mu), jnp.asarray(nu)), (tx, ty, t(mu), t(nu))


def controls(seed: int):
    """(reference, port) controls of ``_controls``."""
    r = np.random.default_rng(seed)
    eps = float(r.choice(EPS_MENU))
    eps_init = max(eps, 5e-2) if r.random() < 0.5 else eps
    return (jcore.SolveControls.make(eps, TOL, eps_init, 0.5),
            core.SolveControls.make(eps, TOL, eps_init, 0.5))


def pc_problem(m, n, seed, d=2):
    """(reference, port) point-cloud problem of test_plan_cache.py's
    ``_pc_problem``."""
    r = np.random.default_rng(seed)
    x, y = r.normal(size=(m, d)), r.normal(size=(n, d))
    mu, nu = r.random(m) + 0.5, r.random(n) + 0.5
    mu, nu = mu / mu.sum(), nu / nu.sum()
    return ((JPC(jnp.asarray(x)), JPC(jnp.asarray(y)), jnp.asarray(mu),
             jnp.asarray(nu)),
            (core.PointCloudGeometry(t(x)), core.PointCloudGeometry(t(y)),
             t(mu), t(nu)))


def engines(solver=SOLVER, banks=None, **kw):
    """(reference engine, port engine) on one config; ``banks`` maps an
    embedding dimension to the reference's direction bank, so the sliced
    tier sees the reference's directions."""
    jcfg = JServeConfig(solver=solver, **kw)
    return JEngine(jcfg), GWEngine(convert.serve_config(
        dataclasses.asdict(jcfg), device="cpu", sliced_directions=banks))


def reference_bank(d_max: int, n_proj: int = 32, seed: int = 0):
    """The reference sliced tier's (d_max, n_proj) direction bank."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (d_max, n_proj),
                                        jnp.result_type(float)))


def port_engine(solver=SOLVER, **kw):
    return GWEngine(convert.serve_config(
        dataclasses.asdict(JServeConfig(solver=solver, **kw)), device="cpu"))


def submit(engs, pair, ctl=None, **kw):
    """Submit one problem to both engines (port controls from ``ctl``'s
    port half); returns the shared request id."""
    (je, te), (jp, tp) = engs, pair
    if ctl is not None:
        kw_j, kw_t = dict(kw, controls=ctl[0]), dict(kw, controls=ctl[1])
    else:
        kw_j = kw_t = kw
    rid = je.submit(*jp, **kw_j)
    assert te.submit(*tp, **kw_t) == rid
    return rid


def assert_parity(rt, rj):
    """A port result against the reference's: dense plans within
    ‖ΔP‖_F < 1e-12 (< 1e-10 where the reference's solve stopped at its cap
    unconverged, see CAPPED_PLAN_FRO), factors rtol 1e-10 /
    atol 1e-12, values rtol 1e-10 (atol 1e-12), counts equal."""
    if rj.plan is not None:
        assert rt.plan is not None
        d = rt.plan.numpy() - np.asarray(rj.plan)
        bar = PLAN_FRO if bool(rj.info.converged) else CAPPED_PLAN_FRO
        assert np.linalg.norm(d) < bar, np.linalg.norm(d)
    elif rj.coupling is not None:
        for name in ("q", "r", "g"):
            np.testing.assert_allclose(
                getattr(rt.coupling, name).numpy(),
                np.asarray(getattr(rj.coupling, name)), rtol=FAC_RTOL,
                atol=FAC_ATOL)
    else:
        assert rt.plan is None and rt.coupling is None
    np.testing.assert_allclose(float(rt.value), float(rj.value),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    assert rt.info.outer_iters == int(rj.info.outer_iters)
    assert rt.info.inner_iters == int(rj.info.inner_iters)
    assert rt.info.converged == bool(rj.info.converged)


def assert_same_bits(a, b, value_rtol=1e-12):
    """Two port results of one request: plans, potentials and factors the
    same bits, counts equal, values within ``value_rtol`` (a batch's value
    is a reduction over its width)."""
    if a.plan is not None or b.plan is not None:
        for x, y in ((a.plan, b.plan), (a.f, b.f), (a.g, b.g)):
            assert torch.equal(x, y)
    else:
        for x, y in zip(fields_of(a.coupling), fields_of(b.coupling)):
            assert torch.equal(x, y)
    np.testing.assert_allclose(float(a.value), float(b.value),
                               rtol=value_rtol, atol=1e-15)
    assert (a.info.outer_iters, a.info.inner_iters, a.info.converged) == \
        (b.info.outer_iters, b.info.inner_iters, b.info.converged)


def port_solo(prob, ctl, solver=SOLVER, **kw):
    """The port's unbatched solve of a problem."""
    cfg = convert.gw_config(dataclasses.asdict(solver))
    return core.entropic_gw(*prob, dataclasses.replace(cfg, **kw),
                            controls=ctl, device="cpu")
