"""Sliced GW: the port's ``sliced_gw`` (sorted and grid methods),
``sliced_plan``, the sliced warm start ``FullCoupling.from_sliced`` and
their pieces against the reference's, replaying the reference's own cases
(tests/test_sliced.py:92–222; its serving cases belong to the serving
slice) with the reference's direction bank carried across
(`repro_torch.convert.direction_bank`).  Inputs are made with numpy from a
seed and handed to both packages; the port runs on the CPU in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import sliced as jsliced
from repro.core.geometry import DenseGeometry as JDense
from repro.core.geometry import GridGeometry as JGridGeometry
from repro.core.geometry import PointCloudGeometry as JCloud
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, core
from repro_torch.core import sliced

# estimates and profiles of the two packages (float64): the directions,
# sorts and moment sums agree to rounding
EST_RTOL = 1e-10


def _cloud(n, seed, d=3, scale=1.0):
    return np.random.default_rng(seed).normal(size=(n, d)) * scale


def _bank(d, n_proj, seed=0):
    """The reference's bank for PRNGKey(seed), carried across."""
    bank = jax.random.normal(jax.random.PRNGKey(seed), (d, n_proj),
                             jnp.float64)
    return convert.direction_bank(np.asarray(bank), device="cpu")


def _pc(points, metric="sqeuclidean"):
    return core.PointCloudGeometry(torch.tensor(points), metric)


def _jpc(points, metric="sqeuclidean"):
    return JCloud(jnp.asarray(points), metric)


def _assert_same_estimate(est, jest, rtol=EST_RTOL):
    np.testing.assert_allclose(float(est.estimate), float(jest.estimate),
                               rtol=rtol)
    np.testing.assert_allclose(est.profile.numpy(), np.asarray(jest.profile),
                               rtol=rtol)


def _brute_1d(x, wx, y, wy, px, py):
    """Exact 1D GW by brute force (tests/test_sliced.py:45): the NW
    coupling between the sorted marginals for both orientations, the
    quadratic energy directly, the smaller."""
    def nw(wa, wb):
        plan = np.zeros((len(wa), len(wb)))
        i = j = 0
        ra, rb = wa[0], wb[0]
        while True:
            m = min(ra, rb)
            plan[i, j] += m
            ra -= m
            rb -= m
            if ra <= 1e-15:
                i += 1
                if i == len(wa):
                    break
                ra = wa[i]
            if rb <= 1e-15:
                j += 1
                if j == len(wb):
                    break
                rb = wb[j]
        return plan

    def energy(xs, ys, plan):
        cx = np.abs(xs[:, None] - xs[None, :]) ** px
        cy = np.abs(ys[:, None] - ys[None, :]) ** py
        c2 = (cx[:, None, :, None] - cy[None, :, None, :]) ** 2
        return np.einsum("ij,kl,ijkl->", plan, plan, c2)

    ox, oy = np.argsort(x), np.argsort(y)
    xs, wxs = x[ox], wx[ox]
    ys, wys = y[oy], wy[oy]
    return min(energy(xs, ys, nw(wxs, wys)),
               energy(xs, ys[::-1], nw(wxs, wys[::-1])))


# ---------------------------------------------------------------------------
# the closed form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [(1, 1), (2, 2)])
def test_closed_form_matches_brute_force_1d(p):
    """tests/test_sliced.py:92: the per-direction closed form is the 1D GW
    optimum (brute force, rtol 1e-8); the reference's estimate."""
    px, py = p
    r = np.random.default_rng(90 + px)
    x, y = r.normal(size=7), r.normal(size=9) * 1.7
    wx, wy = r.random(7) + 0.2, r.random(9) + 0.2
    wx, wy = wx / wx.sum(), wy / wy.sum()
    mx = "sqeuclidean" if px == 2 else "euclidean"
    est = core.sliced_gw(_pc(x[:, None], mx), _pc(y[:, None], mx), wx, wy,
                         n_proj=1, device="cpu")
    np.testing.assert_allclose(float(est.estimate),
                               _brute_1d(x, wx, y, wy, px, py), rtol=1e-8,
                               atol=1e-10)
    jest = jsliced.sliced_gw(_jpc(x[:, None], mx), _jpc(y[:, None], mx),
                             jnp.asarray(wx), jnp.asarray(wy), n_proj=1)
    _assert_same_estimate(est, jest)


def test_1d_grids_match_exact_entropic_solve():
    """tests/test_sliced.py:114: two Grid1D geometries need no directions:
    the estimate is the 1D GW optimum (brute force 1e-8), which the port's
    entropic solver approaches as ε → 0 (2e-2); the reference's
    estimate."""
    gx = core.GridGeometry(core.Grid1D(9, 0.13, 1), "dense")
    gy = core.GridGeometry(core.Grid1D(12, 0.07, 1), "dense")
    mu, nu = np.full(9, 1 / 9), np.full(12, 1 / 12)
    est = core.sliced_gw(gx, gy, mu, nu, n_proj=1, device="cpu")
    ref = core.entropic_gw(gx, gy, mu, nu, core.GWConfig(
        eps=1e-3, outer_iters=200, sinkhorn_iters=2000, tol=1e-10,
        backend="dense", eps_init=1e-1, anneal_decay=0.5), device="cpu")
    np.testing.assert_allclose(float(est.estimate), float(ref.value),
                               rtol=2e-2)
    bf = _brute_1d(np.arange(9) * 0.13, mu, np.arange(12) * 0.07, nu, 1, 1)
    np.testing.assert_allclose(float(est.estimate), bf, rtol=1e-8)
    jgx = JGridGeometry(jcore.Grid1D(9, 0.13, 1), "dense")
    jgy = JGridGeometry(jcore.Grid1D(12, 0.07, 1), "dense")
    jest = jsliced.sliced_gw(jgx, jgy, jnp.asarray(mu), jnp.asarray(nu),
                             n_proj=1)
    _assert_same_estimate(est, jest)


def test_self_distance_and_symmetry():
    """tests/test_sliced.py:140: ~0 against itself, symmetric, positive
    between different scales; the reference's estimates on its bank."""
    pts, other = _cloud(15, 3), _cloud(11, 4, scale=2.0)
    g, h = _pc(pts), _pc(other)
    self_est = core.sliced_gw(g, g, n_proj=8, directions=_bank(3, 8),
                              device="cpu")
    assert abs(float(self_est.estimate)) < 1e-8
    ab = core.sliced_gw(g, h, n_proj=16, directions=_bank(3, 16),
                        device="cpu")
    ba = core.sliced_gw(h, g, n_proj=16, directions=_bank(3, 16),
                        device="cpu")
    np.testing.assert_allclose(float(ab.estimate), float(ba.estimate),
                               rtol=1e-6)
    assert float(ab.estimate) > 1e-2
    _assert_same_estimate(ab, jsliced.sliced_gw(_jpc(pts), _jpc(other),
                                                n_proj=16))


# ---------------------------------------------------------------------------
# invariance: rotated / re-indexed copies
# ---------------------------------------------------------------------------

def test_rotated_permuted_copy_scores_zero():
    """tests/test_sliced.py:157 (its plan-cache digests belong to the
    serving slice): a rotated, re-indexed copy scores ~0, and the two
    copies' profiles against a third geometry coincide
    (`profile_distance` < 1e-6); the reference's profiles."""
    pts = _cloud(18, 5)
    q, _ = np.linalg.qr(np.random.default_rng(6).normal(size=(3, 3)))
    rot = (pts @ q.T)[np.random.default_rng(7).permutation(18)]
    third = _cloud(14, 8, scale=1.5)
    bank = _bank(3, 16)
    est = core.sliced_gw(_pc(pts), _pc(rot), n_proj=16, directions=bank,
                         device="cpu")
    assert abs(float(est.estimate)) < 1e-8
    pa = core.sliced_gw(_pc(pts), _pc(third), n_proj=16, directions=bank,
                        device="cpu")
    pb = core.sliced_gw(_pc(rot), _pc(third), n_proj=16, directions=bank,
                        device="cpu")
    assert core.profile_distance(pa.profile, pb.profile) < 1e-6
    _assert_same_estimate(pa, jsliced.sliced_gw(_jpc(pts), _jpc(third),
                                                n_proj=16))
    assert core.profile_distance(pa.profile, pa.profile) == 0.0
    assert core.profile_distance(pa.profile, np.asarray(pb.profile)) == \
        jsliced.profile_distance(np.asarray(pa.profile),
                                 np.asarray(pb.profile))


def test_variance_shrinks_with_n_proj():
    """tests/test_sliced.py:177: over 12 banks, 64 directions spread the
    estimate less than 4; each estimate the reference's on its bank."""
    ga, gb = _cloud(16, 10), _cloud(16, 11, scale=1.4)

    def spread(n_proj):
        ests = []
        for k in range(12):
            est = core.sliced_gw(_pc(ga), _pc(gb), n_proj=n_proj,
                                 directions=_bank(3, n_proj, k),
                                 device="cpu")
            jest = jsliced.sliced_gw(_jpc(ga), _jpc(gb), n_proj=n_proj,
                                     key=jax.random.PRNGKey(k))
            _assert_same_estimate(est, jest)
            ests.append(float(est.estimate))
        return np.std(ests)

    assert spread(64) < spread(4)


def test_canonical_frame_matches_reference_and_ignores_eigvec_signs(
        monkeypatch):
    """`_canonicalize` equals the reference's (1e-12), and its third-moment
    sign fix makes the eigensolver's choice of signs harmless: negating
    every eigenvector changes no bit of the frame (cuSOLVER and LAPACK may
    choose them otherwise)."""
    r = np.random.default_rng(3)
    emb = r.normal(size=(40, 3)) * np.array([1.0, 2.0, 3.0])
    w = r.random(40) + 0.1
    w[-5:] = 0.0
    got = sliced._canonicalize(torch.tensor(emb), torch.tensor(w))
    want = np.asarray(jsliced._canonicalize(jnp.asarray(emb),
                                            jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        sliced._canonical_keys(torch.tensor(emb), torch.tensor(w)).numpy(),
        np.asarray(jsliced._canonical_keys(jnp.asarray(emb),
                                           jnp.asarray(w))),
        rtol=0, atol=1e-12)
    eigh = torch.linalg.eigh

    def flipped(mat):
        vals, vecs = eigh(mat)
        return vals, -vecs

    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    again = sliced._canonicalize(torch.tensor(emb), torch.tensor(w))
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the plan surface and the warm start
# ---------------------------------------------------------------------------

def _plan_case():
    m, n = 13, 17
    r = np.random.default_rng(12)
    mu, nu = r.random(m) + 0.3, r.random(n) + 0.3
    return _cloud(m, 13), _cloud(n, 14), mu / mu.sum(), nu / nu.sum()


def test_sliced_plan_exactly_feasible():
    """tests/test_sliced.py:196: the monotone plan is exactly feasible
    (1e-12) and non-negative; equal to the reference's plan (atol 1e-15)
    and estimate."""
    a, b, mu, nu = _plan_case()
    est = core.sliced_plan(_pc(a), _pc(b), mu, nu, n_proj=8,
                           directions=_bank(3, 8), device="cpu")
    plan = est.plan.numpy()
    assert plan.shape == (13, 17)
    np.testing.assert_allclose(plan.sum(1), mu, atol=1e-12)
    np.testing.assert_allclose(plan.sum(0), nu, atol=1e-12)
    assert (plan >= 0).all()
    jest = jsliced.sliced_plan(_jpc(a), _jpc(b), jnp.asarray(mu),
                               jnp.asarray(nu), n_proj=8)
    np.testing.assert_allclose(plan, np.asarray(jest.plan), rtol=0,
                               atol=1e-15)
    _assert_same_estimate(est, jest)


def test_sliced_plan_zero_mass_atoms():
    """Zero-mass atoms: the plan stays feasible (1e-12), its zero-mass rows
    and columns hold no more than the cumulative sums' rounding (1e-15;
    the reference's plan has the same entries there), and it equals the
    reference's."""
    a, b, mu, nu = _plan_case()
    mu[[2, 7]] = 0.0
    nu[[0, 16]] = 0.0
    mu, nu = mu / mu.sum(), nu / nu.sum()
    est = core.sliced_plan(_pc(a), _pc(b), mu, nu, n_proj=8,
                           directions=_bank(3, 8), device="cpu")
    np.testing.assert_allclose(est.plan.sum(1).numpy(), mu, atol=1e-12)
    np.testing.assert_allclose(est.plan.sum(0).numpy(), nu, atol=1e-12)
    assert float(est.plan[[2, 7]].abs().max()) <= 1e-15
    assert float(est.plan[:, [0, 16]].abs().max()) <= 1e-15
    jest = jsliced.sliced_plan(_jpc(a), _jpc(b), jnp.asarray(mu),
                               jnp.asarray(nu), n_proj=8)
    np.testing.assert_allclose(est.plan.numpy(), np.asarray(jest.plan),
                               rtol=0, atol=1e-15)


def test_from_sliced_warm_start_matches_reference():
    """`FullCoupling.from_sliced` is the reference's (the plan, 0/−inf
    potentials), and a full-plan solve warm-started from it takes the
    reference's counts to the reference's plan (1e-12)."""
    a, b, mu, nu = _plan_case()
    mu[3] = 0.0
    mu = mu / mu.sum()
    est = core.sliced_plan(_pc(a), _pc(b), mu, nu, n_proj=8,
                           directions=_bank(3, 8), device="cpu")
    jest = jsliced.sliced_plan(_jpc(a), _jpc(b), jnp.asarray(mu),
                               jnp.asarray(nu), n_proj=8)
    mu_t, nu_t = torch.tensor(mu), torch.tensor(nu)
    coup = core.FullCoupling.from_sliced(est.plan, mu_t, nu_t)
    jcoup = jcore.FullCoupling.from_sliced(jest.plan, jnp.asarray(mu),
                                           jnp.asarray(nu))
    np.testing.assert_array_equal(coup.f.numpy(), np.asarray(jcoup.f))
    np.testing.assert_array_equal(coup.g.numpy(), np.asarray(jcoup.g))
    fields = dict(eps=5e-2, outer_iters=30, sinkhorn_iters=200, tol=1e-8)
    op = core.GradientOperator(_pc(a), _pc(b))
    c1, _, _ = op.constant_term(mu_t, nu_t)
    out, info = core.gw_plan_solve(op, c1, mu_t, nu_t,
                                   core.GWConfig(**fields), state0=coup)
    jop = jcore.GradientOperator(_jpc(a), _jpc(b))
    jc1, _, _ = jop.constant_term(jnp.asarray(mu), jnp.asarray(nu))
    jout, jinfo = jcore.gw_plan_solve(jop, jc1, jnp.asarray(mu),
                                      jnp.asarray(nu),
                                      jcore.GWConfig(**fields), state0=jcoup)
    assert (info.outer_iters, info.inner_iters) == \
        (int(jinfo.outer_iters), int(jinfo.inner_iters))
    assert float(np.linalg.norm(out.plan.numpy() - np.asarray(jout.plan))) \
        < 1e-12


# ---------------------------------------------------------------------------
# the grid method and its binning
# ---------------------------------------------------------------------------

def test_resample_1d_matches_reference_bits():
    """The binning in a fixed order: every direction's bin masses equal
    the reference's scatter-add bit for bit (both sum a bin's atoms in
    index order), its spacing within 1 ulp (the reference's compiler may
    divide by the constant grid_n − 1 as a multiplication), with zero-mass
    atoms out of the range."""
    x = np.random.default_rng(0).normal(size=(5, 300))
    w = np.random.default_rng(1).random(300)
    w[:7] = 0.0
    x[0, :7] = 50.0        # zero-mass outliers must not stretch the grid
    h, mass = sliced._resample_1d(torch.tensor(x), torch.tensor(w), 32)
    for c in range(5):
        jh, jm = jsliced._resample_1d(jnp.asarray(x[c]), jnp.asarray(w), 32)
        np.testing.assert_allclose(float(h[c]), float(jh), rtol=2.3e-16,
                                   atol=0)
        np.testing.assert_array_equal(mass[c].numpy(), np.asarray(jm))
    again = sliced._resample_1d(torch.tensor(x), torch.tensor(w), 32)
    assert torch.equal(again[1], mass)


def test_grid_method_agrees_with_sorted():
    """tests/test_sliced.py:208: the grid method (resampling + entropic
    bias) lies within 10 % of the sorted estimate with correlated profiles
    (> 0.9); both the reference's (the grid's 6 lanes of entropic_gw_batch
    included, rtol 1e-10)."""
    a, b = _cloud(24, 20, d=2), _cloud(20, 21, d=2, scale=1.3)
    bank = _bank(2, 6)
    sorted_est = core.sliced_gw(_pc(a), _pc(b), n_proj=6, directions=bank,
                                device="cpu")
    grid_est = core.sliced_gw(_pc(a), _pc(b), n_proj=6, method="grid",
                              grid_n=64, directions=bank, device="cpu")
    np.testing.assert_allclose(float(grid_est.estimate),
                               float(sorted_est.estimate), rtol=0.1)
    c = np.corrcoef(sorted_est.profile.numpy(), grid_est.profile.numpy())
    assert c[0, 1] > 0.9
    _assert_same_estimate(sorted_est, jsliced.sliced_gw(_jpc(a), _jpc(b),
                                                        n_proj=6))
    _assert_same_estimate(grid_est, jsliced.sliced_gw(
        _jpc(a), _jpc(b), n_proj=6, method="grid", grid_n=64))


# ---------------------------------------------------------------------------
# the entry points' contract
# ---------------------------------------------------------------------------

def test_supported_and_embedding_contract():
    """tests/test_sliced.py:222: grids and point clouds slice, dense costs
    do not (ValueError naming the missing embedding), and an unknown method
    is refused; the embeddings are the reference's."""
    grid = core.GridGeometry(core.Grid1D(8, 0.1, 2), "dense")
    assert core.sliced_supported(grid)
    assert core.sliced_supported(core.Grid2D(3, 0.5, 1))
    assert core.sliced_supported(_pc(_cloud(5, 0)))
    dense = core.DenseGeometry(torch.tensor(
        np.random.default_rng(0).random((4, 4))))
    assert not core.sliced_supported(dense)
    assert not core.sliced_supported("not a geometry")
    assert jsliced.sliced_supported(JDense(jnp.asarray(dense.cost.numpy()))) \
        is False
    with pytest.raises(ValueError, match="no coordinate embedding"):
        core.sliced_embedding(dense)
    with pytest.raises(ValueError, match="unknown sliced method"):
        core.sliced_gw(_pc(_cloud(5, 0)), _pc(_cloud(5, 1)), method="bogus",
                       device="cpu")
    for geom, jgeom in ((grid, JGridGeometry(jcore.Grid1D(8, 0.1, 2),
                                             "dense")),
                        (core.GridGeometry(core.Grid2D(3, 0.5, 1)),
                         JGridGeometry(jcore.Grid2D(3, 0.5, 1)))):
        emb, p = core.sliced_embedding(geom, device="cpu")
        jemb, jp = jsliced.sliced_embedding(jgeom)
        assert p == jp
        np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))


def test_default_bank_is_a_seeded_cpu_draw():
    """Without ``directions`` the bank is torch.randn of a CPU generator
    seeded with ``seed``, in float64: passing that draw gives the same
    bits, another seed another profile, and a bank of the wrong shape is
    refused."""
    a, b = _pc(_cloud(30, 1)), _pc(_cloud(25, 2, scale=1.2))
    default = core.sliced_gw(a, b, n_proj=5, device="cpu")
    gen = torch.Generator().manual_seed(0)
    bank = torch.randn((3, 5), generator=gen, dtype=torch.float64)
    given = core.sliced_gw(a, b, n_proj=5, directions=bank, device="cpu")
    assert torch.equal(default.profile, given.profile)
    other = core.sliced_gw(a, b, n_proj=5, seed=1, device="cpu")
    assert not torch.equal(other.profile, default.profile)
    with pytest.raises(ValueError, match="direction bank"):
        core.sliced_gw(a, b, n_proj=5, directions=bank[:, :4], device="cpu")
