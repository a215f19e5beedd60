"""The GW variants: the port's unbalanced Sinkhorn, ``entropic_ugw``,
``bilinear_product``, ``entropic_coot`` and ``gw_barycenter`` against the
reference's, replaying the reference's own cases
(tests/test_gw_solvers.py:59, tests/test_coot.py, tests/test_barycenter.py,
tests/test_solver.py:308,327,341) with the port's answer also held to the
reference's output.  Inputs are made with numpy from a seed and handed to
both packages; the port runs on the CPU in float64."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import coot as jcoot
from repro.core import sinkhorn as jsk
from repro.core.gradient import bilinear_product as jbilinear_product
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, core
from repro_torch.core import coot, ugw

# plans of one solve in both packages (tests/test_torch_gw.py's bar)
PLAN_TOL = 1e-12
VALUE_RTOL = 1e-10


def _measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def _uniform(n):
    return np.full(n, 1.0 / n)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close_plans(got, want, tol=PLAN_TOL):
    d = float(np.linalg.norm(got.numpy() - np.asarray(want)))
    assert d < tol, d


# ---------------------------------------------------------------------------
# rel_entr and the unbalanced Sinkhorn
# ---------------------------------------------------------------------------

def test_rel_entr_zero_mass_cases():
    """scipy's rel_entr: a log a − a log b where a, b > 0; 0 where
    a = 0 ≤ b (a = b = 0 included, where xlogy(a, a/b) is NaN); +inf where
    a > 0 = b or either is negative.  Equal to the reference's."""
    a = np.array([0.0, 0.0, 0.3, 0.3, 1e-300, 0.2, -0.1, 0.0])
    b = np.array([0.0, 0.5, 0.0, 0.6, 1e-300, 0.2, 0.3, -0.2])
    got = ugw.rel_entr(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(jax.scipy.special.rel_entr(*_j(a, b)))
    assert got[0] == 0.0 and got[1] == 0.0
    assert got[2] == np.inf and got[6] == np.inf and got[7] == np.inf
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-15, atol=0)


def _ub_problem(m, n, seed, zero_rows=0, zero_cols=0):
    r = np.random.default_rng(seed)
    cost = r.random((m, n))
    mu, nu = _measures(m, seed + 1), _measures(n, seed + 2)
    mu[m - zero_rows:] = 0.0
    nu[n - zero_cols:] = 0.0
    return cost, mu / mu.sum(), nu / nu.sum()


@pytest.mark.parametrize("zeros", [(0, 0), (3, 2)])
def test_unbalanced_log_matches_reference(zeros):
    """The fixed-count unbalanced solve, with zero-mass atoms or without:
    the reference's plan and potentials; zero-mass rows/columns carry no
    plan mass."""
    cost, mu, nu = _ub_problem(14, 11, 3, *zeros)
    args = (0.05, 0.7, 1.3, 40)
    plan, f, g = core.sinkhorn.sinkhorn_unbalanced_log(
        torch.tensor(cost), torch.tensor(mu), torch.tensor(nu), *args)
    jplan, jf, jg = jsk.sinkhorn_unbalanced_log(*_j(cost, mu, nu), *args)
    _close_plans(plan, jplan)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-13)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-13)
    assert not plan[14 - zeros[0]:].any() and not plan[:, 11 - zeros[1]:].any()


@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_unbalanced_chunked_matches_reference_and_lanes(tol):
    """The chunked solve: the reference's plan, drift and count; tol = 0
    equals the fixed loop bit for bit; three lanes in one call equal each
    lane alone (its own ε, ρ and count)."""
    probs = [_ub_problem(12, 12, s, z, z) for s, z in ((5, 0), (6, 2),
                                                      (7, 0))]
    eps, rho = [0.05, 0.1, 0.02], [1.0, 0.5, 2.0]
    solo = []
    for (cost, mu, nu), e, r in zip(probs, eps, rho):
        out = core.sinkhorn.sinkhorn_unbalanced_log_chunked(
            torch.tensor(cost), torch.tensor(mu), torch.tensor(nu), e, r, r,
            300, 25, tol)
        jout = jsk.sinkhorn_unbalanced_log_chunked(
            *_j(cost, mu, nu), e, r, r, 300, 25, tol)
        _close_plans(out[0], jout[0])
        assert out[4] == int(jout[4])
        np.testing.assert_allclose(float(out[3]), float(jout[3]), rtol=1e-6,
                                   atol=1e-15)
        if tol == 0.0:
            fixed = core.sinkhorn.sinkhorn_unbalanced_log(
                torch.tensor(cost), torch.tensor(mu), torch.tensor(nu), e, r,
                r, 300)
            assert torch.equal(fixed[0], out[0])
        solo.append(out)
    stack = [torch.tensor(np.stack(x)) for x in zip(*probs)]
    eps_t, rho_t = (torch.tensor(v, dtype=torch.float64) for v in (eps, rho))
    lanes = core.sinkhorn.sinkhorn_unbalanced_log_chunked(
        *stack, eps_t, rho_t, rho_t, 300, 25, tol)
    for b, out in enumerate(solo):
        assert lanes[4][b] == out[4]
        torch.testing.assert_close(lanes[0][b], out[0], rtol=1e-13,
                                   atol=1e-16)
        assert float(lanes[3][b]) == pytest.approx(float(out[3]), rel=1e-6,
                                                   abs=1e-15)


# ---------------------------------------------------------------------------
# UGW
# ---------------------------------------------------------------------------

def _ugw_pair(n, fields):
    jcfg = jcore.UGWConfig(**fields)
    cfg = convert.ugw_config(dataclasses.asdict(jcfg))
    return (core.Grid1D(n, 1 / (n - 1), 1), jcore.Grid1D(n, 1 / (n - 1), 1),
            cfg, jcfg)


def _assert_same_ugw(rt, rj):
    assert rt.info.outer_iters == int(rj.info.outer_iters)
    assert rt.info.inner_iters == int(rj.info.inner_iters)
    assert rt.info.converged == bool(rj.info.converged)
    _close_plans(rt.plan, rj.plan)
    np.testing.assert_allclose(float(rt.value), float(rj.value),
                               rtol=VALUE_RTOL)


@pytest.mark.parametrize("backend", ["cumsum", "dense"])
def test_ugw_matches_dense_and_reference(backend):
    """tests/test_gw_solvers.py:59 (FGC applies to UGW unchanged: the
    cumsum plan is the dense one's within 1e-10), and each backend's plan,
    value and counts are the reference's."""
    n = 30
    g, jg, cfg, jcfg = _ugw_pair(n, dict(eps=1e-2, rho=1.0, outer_iters=6,
                                         sinkhorn_iters=150,
                                         backend=backend))
    mu, nu = _measures(n, 6), _measures(n, 7)
    rt = core.entropic_ugw(g, g, mu, nu, cfg, device="cpu")
    rj = jcore.entropic_ugw(jg, jg, *_j(mu, nu), jcfg)
    _assert_same_ugw(rt, rj)
    rd = core.entropic_ugw(g, g, mu, nu, dataclasses.replace(
        cfg, backend="dense"), device="cpu")
    assert float(torch.linalg.norm(rt.plan - rd.plan)) < 1e-10
    assert np.isfinite(float(rt.value))
    assert isinstance(rt.coupling, core.FullCoupling)


def test_ugw_adaptive_converges():
    """tests/test_solver.py:308: the adaptive solve converges on its drift,
    spends fewer updates than the deep fixed one and lands on its plan
    (atol 1e-5) and value (1e-6); counts and plan are the reference's."""
    n = 25
    fixed_f = dict(eps=1e-2, rho=1.0, outer_iters=30, sinkhorn_iters=300)
    g, jg, cfg, jcfg = _ugw_pair(n, dict(fixed_f, tol=1e-7))
    mu, nu = _measures(n, 12), _measures(n, 13)
    fixed = core.entropic_ugw(g, g, mu, nu, core.UGWConfig(**fixed_f),
                              device="cpu")
    ad = core.entropic_ugw(g, g, mu, nu, cfg, device="cpu")
    assert ad.info.converged
    assert ad.info.inner_iters < fixed.info.inner_iters
    np.testing.assert_allclose(ad.plan.numpy(), fixed.plan.numpy(),
                               atol=1e-5)
    assert abs(float(ad.value - fixed.value)) < 1e-6
    rj = jcore.entropic_ugw(jg, jg, *_j(mu, nu), jcfg)
    _assert_same_ugw(ad, rj)
    np.testing.assert_allclose(ad.info.err_trace.numpy(),
                               np.asarray(rj.info.err_trace), rtol=1e-6,
                               atol=1e-15)


def test_ugw_annealed_matches_reference():
    """ε-annealing and the inner tolerance ramp: the reference's counts,
    plan and value."""
    n = 24
    g, jg, cfg, jcfg = _ugw_pair(n, dict(eps=1e-2, rho=0.5, outer_iters=30,
                                         sinkhorn_iters=200, tol=1e-7,
                                         eps_init=1e-1))
    mu, nu = _measures(n, 20), _measures(n, 21)
    _assert_same_ugw(core.entropic_ugw(g, g, mu, nu, cfg, device="cpu"),
                     jcore.entropic_ugw(jg, jg, *_j(mu, nu), jcfg))


def test_ugw_zero_mass_padding():
    """Zero-mass (padded) atoms: the reference's plan on the padded
    problem, no mass on the padding, and the unpadded solve's plan and
    value (1e-12)."""
    n, pad = 20, 6
    g, jg, cfg, jcfg = _ugw_pair(n + pad, dict(eps=1e-2, rho=1.0,
                                               outer_iters=5,
                                               sinkhorn_iters=100))
    mu, nu = _measures(n, 30), _measures(n, 31)
    mu_p, nu_p = np.pad(mu, (0, pad)), np.pad(nu, (0, pad))
    h = 1 / (n + pad - 1)
    rp = core.entropic_ugw(g, g, mu_p, nu_p, cfg, device="cpu")
    _assert_same_ugw(rp, jcore.entropic_ugw(jg, jg, *_j(mu_p, nu_p), jcfg))
    assert not rp.plan[n:].any() and not rp.plan[:, n:].any()
    assert bool(torch.isfinite(rp.f).all() and torch.isfinite(rp.g).all())
    small = core.Grid1D(n, h, 1)
    ru = core.entropic_ugw(small, small, mu, nu, cfg, device="cpu")
    assert float(torch.linalg.norm(rp.plan[:n, :n] - ru.plan)) < 1e-12
    np.testing.assert_allclose(float(rp.value), float(ru.value), rtol=1e-12)


# ---------------------------------------------------------------------------
# bilinear_product and COOT
# ---------------------------------------------------------------------------

def _coot_pair(**kw):
    jcfg = jcoot.COOTConfig(**kw)
    return convert.coot_config(dataclasses.asdict(jcfg)), jcfg


@pytest.mark.parametrize("sides", ["xy", "x", "y", ""])
def test_bilinear_product_matches_dense_and_reference(sides):
    """X π Yᵀ with the FGC apply on the grid sides equals the dense
    product (1e-12, tests/test_coot.py:60) and the reference's, for one
    problem's π and for lane-leading ones."""
    n, m = 20, 25
    gx, gy = core.Grid1D(n, 1 / (n - 1), 1), core.Grid1D(m, 1 / (m - 1), 2)
    jgx, jgy = jcore.Grid1D(n, 1 / (n - 1), 1), jcore.Grid1D(m, 1 / (m - 1), 2)
    x, y = gx.dist_matrix(), gy.dist_matrix()
    pi = torch.tensor(np.random.default_rng(4).random((n, m)))
    use = dict(grid_x=gx if "x" in sides else None,
               grid_y=gy if "y" in sides else None)
    got = core.bilinear_product(x, pi, y, backend="cumsum", **use)
    dense = core.bilinear_product(x, pi, y, None, None)
    assert float((got - dense).abs().max()) < 1e-12
    want = jbilinear_product(jnp.asarray(x.numpy()), jnp.asarray(pi.numpy()),
                             jnp.asarray(y.numpy()),
                             jgx if "x" in sides else None,
                             jgy if "y" in sides else None, "cumsum")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-15)
    lanes = core.bilinear_product(x, torch.stack([pi, 2 * pi]), y,
                                  backend="cumsum", **use)
    torch.testing.assert_close(lanes[0], got, rtol=0, atol=0)
    torch.testing.assert_close(lanes[1], 2 * got, rtol=1e-14, atol=1e-15)


def _coot_both(x, y, marg, cfg, jcfg, **grids):
    jgrids = {k: jcore.Grid1D(v.n, v.h, v.k) for k, v in grids.items()}
    rt = coot.entropic_coot(x, y, *marg, cfg, return_info=True,
                            device="cpu", **grids)
    rj = jcoot.entropic_coot(*_j(x, y, *marg), jcfg, return_info=True,
                             **jgrids)
    return rt, rj


def _assert_same_coot(rt, rj, plan_tol=PLAN_TOL, value_rtol=VALUE_RTOL):
    assert rt[3].outer_iters == int(rj[3].outer_iters)
    assert rt[3].inner_iters == int(rj[3].inner_iters)
    assert rt[3].converged == bool(rj[3].converged)
    _close_plans(rt[0], rj[0], plan_tol)
    _close_plans(rt[1], rj[1], plan_tol)
    np.testing.assert_allclose(float(rt[2]), float(rj[2]), rtol=value_rtol,
                               atol=1e-14)


def test_coot_self_alignment_near_identity():
    """tests/test_coot.py:16: COOT(X, X) recovers near-identity plans on
    both sides; the reference's plans, value and counts."""
    x = np.random.default_rng(41).normal(size=(12, 8)) * 2.0
    cfg, jcfg = _coot_pair(eps_samples=5e-3, eps_features=5e-3,
                           outer_iters=12, sinkhorn_iters=200)
    rt, rj = _coot_both(x, x, [_uniform(k) for k in (12, 12, 8, 8)], cfg,
                        jcfg)
    pi_s, pi_v, val, _ = rt
    assert (pi_s.argmax(1).numpy() == np.arange(12)).mean() > 0.8
    assert (pi_v.argmax(1).numpy() == np.arange(8)).mean() > 0.7
    assert float(val) < 0.5
    _assert_same_coot(rt, rj)


def test_coot_marginals_and_value_finite():
    """tests/test_coot.py:29: feasible plans (atol 1e-5), finite value;
    the reference's."""
    # the reference module's generator, as its second test draws from it
    r = np.random.default_rng(41)
    r.normal(size=(12, 8))
    x, y = r.normal(size=(10, 6)), r.normal(size=(14, 9))
    cfg, jcfg = _coot_pair(outer_iters=6, sinkhorn_iters=150)
    rt, rj = _coot_both(x, y, [_uniform(k) for k in (10, 14, 6, 9)], cfg,
                        jcfg)
    np.testing.assert_allclose(rt[0].sum(1).numpy(), 1 / 10, atol=1e-5)
    np.testing.assert_allclose(rt[1].sum(0).numpy(), 1 / 9, atol=1e-5)
    assert np.isfinite(float(rt[2]))
    _assert_same_coot(rt, rj)


# tests/test_coot.py:39's case has uniform marginals on two grids: the
# reflection symmetry is unbroken, and rounding picks the BCD's branch, so
# any two routes part at ~1e-6.  The reference's own routes (cumsum, scan,
# dense, pallas, grid-less) lie up to 4.9e-6 apart in ‖Δπ_s‖_F on these
# inputs, and its test holds FGC against dense to 1e-5 (plan) and 1e-8
# (value): that cross-route bar is this case's bar against the reference
# (the port's routes measured 0.2e-6–1.9e-6 from the reference's same
# route; `tests/reference_spreads.py coot`, CPU, float64)
COOT_GW_BAR = (1e-5, 1e-8)


@pytest.mark.parametrize("backend", ["cumsum", "scan", "dense"])
def test_coot_gw_specialization_fgc_matches_dense(backend):
    """tests/test_coot.py:39: X, Y grid distance matrices (the reference's
    own, so both packages read the same bits), the FGC product route
    against the dense one at the reference's bars, and against the
    reference's same route at its cross-route bar."""
    n, m = 20, 25
    gx, gy = core.Grid1D(n, 1 / (n - 1), 1), core.Grid1D(m, 1 / (m - 1), 1)
    x = np.asarray(jcore.Grid1D(n, 1 / (n - 1), 1).dist_matrix())
    y = np.asarray(jcore.Grid1D(m, 1 / (m - 1), 1).dist_matrix())
    marg = [_uniform(k) for k in (n, m, n, m)]
    cfg, jcfg = _coot_pair(outer_iters=6, sinkhorn_iters=150,
                           backend=backend)
    rt, rj = _coot_both(x, y, marg, cfg, jcfg, grid_x=gx, grid_y=gy)
    rd = coot.entropic_coot(x, y, *marg, cfg, device="cpu")
    assert float(torch.linalg.norm(rt[0] - rd[0])) < COOT_GW_BAR[0]
    assert abs(float(rt[2] - rd[2])) < COOT_GW_BAR[1]
    assert rt[3].inner_iters == int(rj[3].inner_iters)
    _close_plans(rt[0], rj[0], COOT_GW_BAR[0])
    assert abs(float(rt[2]) - float(rj[2])) < COOT_GW_BAR[1]


def test_coot_gw_specialization_random_marginals_matches_reference():
    """The same specialization with random marginals (the symmetry broken):
    the FGC route equals the dense one and the reference's at the full
    bars."""
    n, m = 20, 25
    gx, gy = core.Grid1D(n, 1 / (n - 1), 1), core.Grid1D(m, 1 / (m - 1), 1)
    x, y = gx.dist_matrix().numpy(), gy.dist_matrix().numpy()
    marg = [_measures(k, 50 + i) for i, k in enumerate((n, m, n, m))]
    cfg, jcfg = _coot_pair(outer_iters=6, sinkhorn_iters=150)
    rt, rj = _coot_both(x, y, marg, cfg, jcfg, grid_x=gx, grid_y=gy)
    rd = coot.entropic_coot(x, y, *marg, cfg, device="cpu")
    assert float(torch.linalg.norm(rt[0] - rd[0])) < PLAN_TOL
    _assert_same_coot(rt, rj)


def test_coot_adaptive_converges_with_info():
    """tests/test_solver.py:327: the adaptive solve converges before its
    cap with near-identity samples plan; the reference's counts and plans.
    Also annealed, both plans' ε on one ramp."""
    x = np.random.default_rng(14).normal(size=(12, 8))
    marg = [_uniform(k) for k in (12, 12, 8, 8)]
    cfg, jcfg = _coot_pair(eps_samples=5e-3, eps_features=5e-3,
                           outer_iters=30, sinkhorn_iters=200, tol=1e-7)
    rt, rj = _coot_both(x, x, marg, cfg, jcfg)
    assert rt[3].converged and rt[3].outer_iters < 30
    assert (rt[0].argmax(1).numpy() == np.arange(12)).mean() > 0.8
    assert np.isfinite(float(rt[2]))
    _assert_same_coot(rt, rj)
    cfg, jcfg = _coot_pair(eps_samples=5e-3, eps_features=1e-2,
                           outer_iters=30, sinkhorn_iters=200, tol=1e-7,
                           eps_init=5e-2)
    _assert_same_coot(*_coot_both(x, x, marg, cfg, jcfg))


# ---------------------------------------------------------------------------
# the barycenter
# ---------------------------------------------------------------------------

def _bary(grids, measures, weights, mu_bar, fields):
    jcfg = jcore.BarycenterConfig(**fields)
    cfg = convert.barycenter_config(dataclasses.asdict(jcfg))
    rt = core.gw_barycenter(grids, measures, weights, mu_bar, cfg,
                            device="cpu")
    rj = jcore.gw_barycenter([jcore.Grid1D(g.n, g.h, g.k) for g in grids],
                             [jnp.asarray(m) for m in measures], weights,
                             jnp.asarray(mu_bar), jcfg)
    return rt, rj


# The plans of a barycenter run through several plan solves, each of which
# amplifies rounding: the reference's own cumsum, scan, dense and pallas
# routes give plans up to 1.06e-11 apart (‖ΔP‖_F) on
# tests/test_barycenter.py:16's case and up to 4.13e-11 on the annealed
# case below (`tests/reference_spreads.py bary_plans`, CPU, float64; the
# port lies 1.4e-12–5.3e-12 and 2.5e-12 from the reference's cumsum
# route).  Those spreads, not 1e-12, are the plans' bars there; D̄ is held
# to 1e-10 (normwise).
BARY_PLAN_SPREAD = {"runs": 1.1e-11, "annealed": 4.2e-11}


def _dbar_apart(a, b):
    """max |ΔD̄| over the larger of the two max |D̄| (Run M's measure)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), np.abs(b).max())


def _close_dbar(dbar, jdbar, tol=1e-10):
    d = _dbar_apart(dbar.numpy(), jdbar)
    assert d < tol, d


def _assert_feasible(plans, measures, mu_bar, atol):
    for plan, nu in zip(plans, measures):
        np.testing.assert_allclose(plan.sum(0).numpy(), nu, atol=atol)
        np.testing.assert_allclose(plan.sum(1).numpy(), mu_bar, atol=atol)


def test_barycenter_runs_and_plans_feasible():
    """tests/test_barycenter.py:16: a finite (22, 22) D̄ and feasible plans
    (atol 1e-3); D̄ within 1e-10 and the plans within the reference's own
    cross-backend spread of the reference's."""
    grids = [core.Grid1D(20, 1 / 19, 1), core.Grid1D(25, 1 / 24, 1)]
    measures = [_measures(20, 0), _measures(25, 1)]
    mu_bar = np.full(22, 1 / 22.)
    (dbar, plans), (jdbar, jplans) = _bary(
        grids, measures, [0.5, 0.5], mu_bar,
        dict(eps=5e-3, outer_iters=3, gw_iters=3, sinkhorn_iters=100))
    assert dbar.shape == (22, 22) and bool(torch.isfinite(dbar).all())
    _assert_feasible(plans, measures, mu_bar, 1e-3)
    _close_dbar(dbar, jdbar)
    for p, jp in zip(plans, jplans):
        _close_plans(p, jp, BARY_PLAN_SPREAD["runs"])


def test_barycenter_of_identical_inputs_recovers_geometry():
    """tests/test_barycenter.py:33: the barycenter of two copies of one
    measure recovers its grid's spectrum (0.35 relative); D̄ the
    reference's (1e-10)."""
    g = core.Grid1D(18, 1 / 17, 1)
    nu = _measures(18, 2)
    (dbar, _), (jdbar, _) = _bary(
        [g, g], [nu, nu], [0.5, 0.5], nu,
        dict(eps=2e-3, outer_iters=4, gw_iters=4, sinkhorn_iters=200))
    d_true = g.dist_matrix().numpy()
    ev_b = np.sort(np.linalg.eigvalsh(dbar.numpy()))
    ev_t = np.sort(np.linalg.eigvalsh(d_true))
    assert np.abs(ev_b - ev_t).max() / np.abs(ev_t).max() < 0.35
    _close_dbar(dbar, jdbar)


# tests/test_solver.py:341's case runs adaptive plan solves at ε = 5e-3
# with no annealing, 10 steps a solve, where mirror descent amplifies
# rounding step after step, so the reference's own backends end far
# apart: over its cumsum, scan, dense
# and pallas routes, D̄s up to 0.725 apart (`_dbar_apart`) and plans up to
# 0.177 in ‖·‖_F (`tests/reference_spreads.py bary_adaptive`, CPU,
# float64; the port's cumsum route 0.711 and 0.139).  That spread
# is this case's bar against the reference; Run M's controls, annealed,
# are held at the full bars below.
BARY_ADAPTIVE_SPREAD = (0.725, 0.177)


def test_barycenter_adaptive_plans_feasible():
    """tests/test_solver.py:341: adaptive plan solves stay feasible (atol
    1e-4) and D̄ finite; against the reference within its own
    cross-backend spread."""
    grids = [core.Grid1D(20, 1 / 19, 1), core.Grid1D(25, 1 / 24, 1)]
    measures = [_measures(20, 16), _measures(25, 17)]
    mu_bar = np.full(22, 1 / 22.)
    (dbar, plans), (jdbar, jplans) = _bary(
        grids, measures, [0.5, 0.5], mu_bar,
        dict(eps=5e-3, outer_iters=3, gw_iters=10, sinkhorn_iters=200,
             tol=1e-6))
    assert bool(torch.isfinite(dbar).all())
    _assert_feasible(plans, measures, mu_bar, 1e-4)
    _close_dbar(dbar, jdbar, BARY_ADAPTIVE_SPREAD[0])
    for p, jp in zip(plans, jplans):
        _close_plans(p, jp, BARY_ADAPTIVE_SPREAD[1])


def test_barycenter_annealed_matches_reference():
    """Run M's controls at a small size (annealed cold sweep, warm sweeps
    without the ramp, tol 1e-6): D̄ within 1e-10 and the plans within the
    reference's own cross-backend spread of the reference's; feasible
    (1e-4)."""
    sizes = (16, 20, 24)
    grids = [core.Grid1D(s, 1 / (s - 1), 1) for s in sizes]
    measures = [_measures(s, 60 + i) for i, s in enumerate(sizes)]
    mu_bar = np.full(24, 1 / 24.)
    (dbar, plans), (jdbar, jplans) = _bary(
        grids, measures, [0.5, 0.3, 0.2], mu_bar,
        dict(eps=5e-3, outer_iters=3, gw_iters=5, sinkhorn_iters=100,
             tol=1e-6, eps_init=5e-2))
    _close_dbar(dbar, jdbar)
    for p, jp in zip(plans, jplans):
        _close_plans(p, jp, BARY_PLAN_SPREAD["annealed"])
    _assert_feasible(plans, measures, mu_bar, 1e-4)


# ---------------------------------------------------------------------------
# the card is the default
# ---------------------------------------------------------------------------

def test_entry_points_need_a_device_without_a_card(monkeypatch):
    """With no CUDA device and no ``device``, every entry point raises
    instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = core.Grid1D(8, 1 / 7, 1)
    mu = _uniform(8)
    x = np.eye(8)
    calls = [
        lambda: core.entropic_ugw(g, g, mu, mu),
        lambda: coot.entropic_coot(x, x, mu, mu, mu, mu),
        lambda: core.gw_barycenter([g], [mu], [1.0], mu),
        lambda: core.sliced_gw(core.as_geometry(g), core.as_geometry(g)),
        lambda: core.sliced_plan(core.as_geometry(g), core.as_geometry(g)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
