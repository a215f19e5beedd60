"""The hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA card with ``nvcc`` (the kernels build at first use) and
carry the ``cuda`` marker; without a card they skip.  The file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (GWConfig, Grid1D, LowRankGeometry, entropic_gw)
from repro_torch.kernels import fgc_scan, lr_step, ops, sinkhorn_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


# Half-step tolerance: the kernel's online (max, sumexp) associates the sum
# differently from the plain two-pass logsumexp, a few ulps of the result.
_HALF_TOL = {torch.float32: dict(rtol=2e-6, atol=2e-6),
             torch.float64: dict(rtol=1e-13, atol=1e-14)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(1, 5), (37, 53), (300, 257), (1000, 1300)])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_matches_plain(dev, dtype, m, n, kind):
    gen = _gen(m * n)
    cost = torch.rand((1, m, n), generator=gen, device=dev, dtype=dtype)
    vlen, wlen = (n, m) if kind == "row" else (m, n)
    vec = torch.randn((1, vlen), generator=gen, device=dev, dtype=dtype)
    logw = torch.full((1, wlen), -math.log(wlen), device=dev, dtype=dtype)
    eps = torch.full((1,), 2e-3, device=dev, dtype=dtype)
    cuda = getattr(sinkhorn_step, f"{kind}_update_cuda")
    plain = getattr(sinkhorn_step, f"{kind}_update_plain")
    got = cuda(cost, vec, logw, eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain(cost, vec, logw, eps),
                               **_HALF_TOL[dtype])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_zero_mass(dev, kind):
    """−inf potentials over a leading block wider than a warp's stride and
    −inf log-mass rows: −inf out, never NaN."""
    gen = _gen(3)
    m, n = 160, 200
    cost = torch.rand((1, m, n), generator=gen, device=dev,
                      dtype=torch.float64)
    vlen, wlen = (n, m) if kind == "row" else (m, n)
    vec = torch.randn((1, vlen), generator=gen, device=dev,
                      dtype=torch.float64)
    vec[:, :130] = -math.inf
    logw = torch.full((1, wlen), -math.log(wlen), device=dev,
                      dtype=torch.float64)
    logw[:, ::7] = -math.inf
    eps = torch.full((1,), 0.01, device=dev, dtype=torch.float64)
    got = getattr(sinkhorn_step, f"{kind}_update_cuda")(cost, vec, logw, eps)
    want = getattr(sinkhorn_step, f"{kind}_update_plain")(cost, vec, logw,
                                                          eps)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isneginf(got), torch.isneginf(logw))
    torch.testing.assert_close(got, want, **_HALF_TOL[torch.float64])


def test_half_step_lanes_and_bf16(dev):
    """Four lanes with four ε, and a bfloat16 cost under float32 duals."""
    gen = _gen(4)
    b, m, n = 4, 120, 90
    cost = torch.rand((b, m, n), generator=gen, device=dev)
    g = torch.randn((b, n), generator=gen, device=dev)
    log_mu = torch.full((b, m), -math.log(m), device=dev)
    eps = torch.tensor([0.05, 0.01, 0.004, 0.002], device=dev)
    for c in (cost, cost.to(torch.bfloat16)):
        got = ops.sinkhorn_row_update_batched(c, g, log_mu, eps)
        want = sinkhorn_step.row_update_plain(c, g, log_mu, eps)
        torch.testing.assert_close(got, want, **_HALF_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(1, 1), (3, 7), (200, 130), (513, 1)])
@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["l", "dtilde"])
def test_fgc_matches_plain(dev, dtype, n, b, p, kind):
    x = torch.randn((n, b), generator=_gen(n + b), device=dev, dtype=dtype)
    got = getattr(fgc_scan, f"apply_{kind}_cuda")(x, p)
    want = getattr(fgc_scan, f"apply_{kind}_plain")(x, p)
    scale = getattr(fgc_scan, f"apply_{kind}_plain")(x.abs().double(), p)
    # twice the recursive-sum bound (p+2)·N·u·(D|x|)
    u = torch.finfo(dtype).eps / 2
    assert ((got - want).abs().double()
            <= 2 * (p + 2) * n * u * scale).all()


def test_wrappers_count_launches(dev):
    ops.reset_launch_counts()
    x = torch.randn((64, 3), device=dev, dtype=torch.float64)
    ops.fgc_apply_l(x, 1)
    ops.fgc_apply_dtilde(x, 2)
    cost = torch.rand((8, 9), device=dev, dtype=torch.float64)
    ops.sinkhorn_row_update(cost, torch.zeros(9, device=dev,
                                              dtype=torch.float64),
                            torch.zeros(8, device=dev, dtype=torch.float64),
                            0.1)
    assert ops.LAUNCHES == {"sinkhorn_row_update": 1,
                            "sinkhorn_col_update": 0,
                            "fgc_apply_dtilde": 1, "fgc_apply_l": 1,
                            "lr_dykstra_half": 0, "lr_gram_chain": 0,
                            "lr_grad_combine": 0}


def test_wrappers_refuse_bad_input(dev):
    x = torch.randn((64, 3), device=dev)
    with pytest.raises(ValueError):
        ops.fgc_apply_l(x.T, 1)                     # not contiguous
    with pytest.raises(ValueError):
        ops.fgc_apply_l(x, 9)                       # p outside 0..8
    with pytest.raises(TypeError):
        ops.sinkhorn_row_update(torch.rand((4, 5), device=dev),
                                torch.zeros(5, device=dev,
                                            dtype=torch.float64),
                                torch.zeros(4, device=dev,
                                            dtype=torch.float64), 0.1)


@pytest.mark.parametrize("k", [1, 2])
def test_entropic_gw_kernels_match_plain(dev, k):
    """The whole slice on the card: kernels against the plain path, f64,
    fixed and annealed; counts must be equal."""
    n = 50
    grid = Grid1D(n, 1 / (n - 1), k)
    rng = np.random.default_rng(k)
    mu = rng.random(n) + 0.05
    nu = rng.random(n) + 0.05
    mu, nu = mu / mu.sum(), nu / nu.sum()
    for extra in ({}, dict(tol=1e-7, eps_init=5e-2, outer_iters=40)):
        base = dict(dict(eps=2e-3, outer_iters=10, sinkhorn_iters=200),
                    **extra)
        rk = entropic_gw(grid, grid, mu, nu,
                         GWConfig(backend="kernel", **base))
        rp = entropic_gw(grid, grid, mu, nu,
                         GWConfig(backend="cumsum", sinkhorn_backend="torch",
                                  **base))
        assert rk.info.outer_iters == rp.info.outer_iters
        assert rk.info.inner_iters == rp.info.inner_iters
        assert float(torch.linalg.norm(rk.plan - rp.plan)) < 1e-12
        assert abs(float(rk.value - rp.value)) < 1e-12


# ---------------------------------------------------------------------------
# factored-plan kernels (B5–B7)
# ---------------------------------------------------------------------------

def _u(dtype):
    return torch.finfo(dtype).eps / 2


def _lk(gen, lanes, n, r, dtype, zero_rows=()):
    lk = torch.randn((lanes, n, r), generator=gen, device="cuda",
                     dtype=dtype)
    logw = torch.full((lanes, n), -math.log(n), device="cuda", dtype=dtype)
    for i in zero_rows:
        lk[:, i] = -math.inf
        logw[:, i] = -math.inf
    return lk, logw


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,r", [(1, 1), (45, 6), (300, 16), (257, 64),
                                 (100_003, 16)])
def test_dykstra_half_matches_plain(dev, dtype, n, r):
    gen = _gen(n + r)
    lk, logw = _lk(gen, 2, n, r, dtype, zero_rows=range(0, n, 7))
    gcol = torch.randn((2, r), generator=gen, device=dev, dtype=dtype)
    f, col = lr_step.dykstra_half_cuda(lk, gcol, logw)
    torch.cuda.synchronize()
    wf, wcol = lr_step.dykstra_half_plain(lk, gcol, logw)
    assert torch.equal(torch.isneginf(f), torch.isneginf(wf))
    assert not torch.isnan(f).any() and not torch.isnan(col).any()
    u = _u(dtype)
    fin = torch.isfinite(wf)
    # the r-lane sum (and then the N-row sum) in another order: each
    # version's log-sum is within (terms)·u of the exact one, plus the
    # roundings of m + log s and log w − lse at the scale of the operands
    sf = torch.maximum(torch.maximum(logw.abs(), wf.abs()),
                       torch.ones_like(wf))[fin]
    assert ((f - wf).abs()[fin] <= (2 * r + 4) * u * sf).all()
    _assert_col(col, wcol, n, r, u, lk, gcol, logw)


def _assert_tied(got, want, want64, what):
    """The f32 rule: the kernel within 4× the plain f32 version's own
    distance from the plain version run in f64 on the same inputs, or 4
    ulps of the largest output where the plain f32 happens to be closer
    (a bound linear in N passes anything in f32 at these sizes)."""
    ek = float((got.double() - want64).abs().max())
    ep = float((want.double() - want64).abs().max())
    lim = max(4 * ep, 4 * _u(got.dtype) * float(want64.abs().max()))
    assert ek <= lim, f"{what}: {ek:.3e} from the f64 plain > {lim:.3e}"


def _assert_col(col, wcol, n, r, u, lk, gcol, logw):
    """Column LSEs: the same −inf columns (all rows zero-mass), and finite
    ones within the N-row sum's bound (f64) or by `_assert_tied` (f32)."""
    assert torch.equal(torch.isneginf(col), torch.isneginf(wcol))
    fin = torch.isfinite(wcol)
    if gcol.dtype == torch.float32:
        if not fin.any():
            return
        wcol64 = lr_step.dykstra_half_plain(lk, gcol.double(),
                                            logw.double())[1]
        _assert_tied(col[fin], wcol[fin], wcol64[fin], "col")
        return
    scol = torch.maximum(wcol.abs(), torch.ones_like(wcol))[fin]
    assert ((col - wcol).abs()[fin] <= (2 * (n + r) + 4) * u * scol).all()


def test_dykstra_half_bf16_lk(dev):
    """bf16 lk under f32 duals: both versions widen lk exactly, so the f32
    bars of the test above hold."""
    gen = _gen(5)
    n, r = 1000, 16
    lk, logw = _lk(gen, 1, n, r, torch.float32, zero_rows=(0, 999))
    gcol = torch.randn((1, r), generator=gen, device=dev)
    lk16 = lk.to(torch.bfloat16)
    f, col = lr_step.dykstra_half_cuda(lk16, gcol, logw)
    wf, wcol = lr_step.dykstra_half_plain(lk16, gcol, logw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(f), torch.isneginf(wf))
    u = _u(torch.float32)
    fin = torch.isfinite(wf)
    sf = torch.maximum(torch.maximum(logw.abs(), wf.abs()),
                       torch.ones_like(wf))[fin]
    assert ((f - wf).abs()[fin] <= (2 * r + 4) * u * sf).all()
    _assert_col(col, wcol, n, r, u, lk16, gcol, logw)


def _factors(gen, lanes, n, c, r, dtype):
    a = torch.randn((lanes, n, c), generator=gen, device="cuda", dtype=dtype)
    b = torch.randn((lanes, n, c), generator=gen, device="cuda", dtype=dtype)
    q = torch.rand((lanes, n, r), generator=gen, device="cuda", dtype=dtype)
    w = torch.rand((lanes, n), generator=gen, device="cuda", dtype=dtype)
    return a, b, q, w


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,r", [(1, 5, 1), (45, 5, 6), (300, 12, 16),
                                   (257, 5, 64), (100_003, 5, 16)])
def test_gram_chain_matches_plain(dev, dtype, n, c, r):
    a, b, q, w = _factors(_gen(n * c + r), 2, n, c, r, dtype)
    got = lr_step.gram_chain_cuda(a, b, q, w)
    torch.cuda.synchronize()
    want = lr_step.gram_chain_plain(a, b, q, w)
    if dtype == torch.float32:
        want64 = lr_step.gram_chain_plain(a.double(), b.double(), q.double(),
                                          w.double())
        for name, x, y, z in zip(("bq", "gram", "sq", "tq"), got, want,
                                 want64):
            _assert_tied(x, y, z, name)
        return
    scale = lr_step.gram_chain_plain(a.abs(), b.abs(), q.abs(), w.abs())
    u = _u(dtype)
    # dot products over N rows (and c for the Gram) in another order: twice
    # the recursive-sum bound of each
    for name, x, y, s in zip(("bq", "gram", "sq", "tq"), got, want, scale):
        assert ((x - y).abs() <= 4 * (n + c) * u * s).all(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,r", [(1, 5, 1), (45, 5, 6), (300, 12, 16),
                                   (257, 5, 64), (100_003, 5, 16)])
def test_grad_combine_matches_plain(dev, dtype, n, c, r):
    gen = _gen(n + 7 * c + r)
    a, _, _, d2 = _factors(gen, 2, n, c, r, dtype)
    wm = torch.randn((2, c, r), generator=gen, device=dev, dtype=dtype)
    s, t, iq = (torch.randn((2, r), generator=gen, device=dev, dtype=dtype)
                for _ in range(3))
    got = lr_step.grad_combine_cuda(a, wm, d2, s, t, iq)
    torch.cuda.synchronize()
    want = lr_step.grad_combine_plain(a, wm, d2, s, t, iq)
    scale = (2 * (d2.abs()[:, :, None] * s.abs()[:, None, :]
                  + t.abs()[:, None, :])
             + 4 * a.abs() @ wm.abs()) * iq.abs()[:, None, :]
    # only the c-long dot is summed otherwise; the tail rounds alike
    assert ((got - want).abs() <= 2 * (c + 3) * _u(dtype) * scale).all()


def test_lowrank_wrappers_count_and_refuse(dev):
    ops.reset_launch_counts()
    lk = torch.randn((10, 4), device=dev, dtype=torch.float64)
    z4 = torch.zeros(4, device=dev, dtype=torch.float64)
    ops.lr_dykstra_half(lk, z4, torch.zeros(10, device=dev,
                                            dtype=torch.float64))
    a = torch.randn((10, 3), device=dev, dtype=torch.float64)
    ops.lr_gram_chain(a, a, lk, torch.zeros(10, device=dev,
                                            dtype=torch.float64))
    ops.lr_grad_combine(a, torch.zeros((3, 4), device=dev,
                                       dtype=torch.float64),
                        torch.zeros(10, device=dev, dtype=torch.float64),
                        z4, z4, z4)
    assert (ops.LAUNCHES["lr_dykstra_half"], ops.LAUNCHES["lr_gram_chain"],
            ops.LAUNCHES["lr_grad_combine"]) == (1, 1, 1)
    with pytest.raises(TypeError):
        ops.lr_dykstra_half(lk.float(), z4, z4.new_zeros(10))
    with pytest.raises(ValueError):
        lr_step.grad_combine_cuda(a[None], torch.zeros((1, 3, 4), device=dev,
                                                       dtype=torch.float64),
                                  z4.new_zeros((1, 10)), z4[None],
                                  z4[None], z4[None, :3])


def test_lowrank_gw_kernels_match_plain(dev):
    """A factored solve on the card: kernels against the plain path, f64,
    equal counts and launches as the code implies."""
    rng = np.random.default_rng(6)
    pts = [torch.tensor(rng.normal(size=(n, 3)), device=dev)
           for n in (300, 400)]
    gx, gy = (LowRankGeometry(*_sq_factors(p)) for p in pts)
    mu = torch.full((300,), 1 / 300, device=dev, dtype=torch.float64)
    nu = torch.full((400,), 1 / 400, device=dev, dtype=torch.float64)
    base = dict(eps=5e-2, outer_iters=15, sinkhorn_iters=50, tol=1e-6,
                eps_init=0.5, anneal_decay=0.7, plan="lowrank", plan_rank=8)
    ops.reset_launch_counts()
    rk = entropic_gw(gx, gy, mu, nu, GWConfig(lowrank_backend="auto", **base))
    counts = dict(ops.LAUNCHES)
    rp = entropic_gw(gx, gy, mu, nu, GWConfig(lowrank_backend="torch",
                                              **base))
    assert rk.info.outer_iters == rp.info.outer_iters
    assert rk.info.inner_iters == rp.info.inner_iters
    assert counts["lr_dykstra_half"] == 2 * rk.info.inner_iters
    assert counts["lr_gram_chain"] == 2 * rk.info.outer_iters + 2
    assert counts["lr_grad_combine"] == 2 * rk.info.outer_iters
    assert abs(float(rk.value - rp.value)) <= 1e-8 * abs(float(rp.value))
    for name in "qrg":
        torch.testing.assert_close(getattr(rk.coupling, name),
                                   getattr(rp.coupling, name), rtol=1e-8,
                                   atol=1e-12)


def test_lowrank_auto_rank_kernels_match_plain(dev):
    """plan_rank="auto" where the rank grows (the reference's own case:
    two 2-D clusters of 15 points a side): restarts, widened factors and
    accumulated counts equal between the kernels and the plain path."""
    rng = np.random.default_rng(11)

    def clustered(centers):
        return torch.tensor(np.concatenate(
            [np.asarray(c, float) + 0.3 * rng.normal(size=(15, 2))
             for c in centers]), device=dev)

    gx = LowRankGeometry(*_sq_factors(clustered([[0.0, 0.0], [8.0, 0.0]])))
    gy = LowRankGeometry(*_sq_factors(clustered([[0.0, 0.0], [0.0, 9.0]])))
    mu = torch.full((30,), 1 / 30, device=dev, dtype=torch.float64)
    base = dict(eps=5e-2, outer_iters=60, tol=1e-6, eps_init=0.3,
                anneal_decay=0.7, sinkhorn_iters=200, plan="lowrank",
                plan_rank="auto", plan_rank_max=32, lr_gamma=30.0)
    rk = entropic_gw(gx, gy, mu, mu, GWConfig(lowrank_backend="auto",
                                              **base))
    rp = entropic_gw(gx, gy, mu, mu, GWConfig(lowrank_backend="torch",
                                              **base))
    assert rk.coupling.rank == rp.coupling.rank > 8
    assert rk.info.outer_iters == rp.info.outer_iters
    assert rk.info.inner_iters == rp.info.inner_iters
    assert abs(float(rk.value - rp.value)) <= 1e-8 * abs(float(rp.value))


def _sq_factors(p):
    p = p - p.mean(0, keepdim=True)
    sq = (p ** 2).sum(1, keepdim=True)
    one = torch.ones_like(sq)
    return torch.cat([sq, one, -2 * p], 1), torch.cat([one, sq, p], 1)
