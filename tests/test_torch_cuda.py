"""The hand-written CUDA kernels against their plain PyTorch versions, and
the implicit gradients of solves whose forward runs them.

These need an NVIDIA card with ``nvcc`` (the kernels build at first use) and
carry the ``cuda`` marker; without a card they skip.  The file imports
neither JAX nor the reference package, so it runs where only PyTorch is
installed:

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from repro_torch.core import (GWConfig, Grid1D, LowRankGeometry,
                              PointCloudGeometry, entropic_gw)
from repro_torch.core import fgc as core_fgc
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


# Half-step tolerance: the kernels sum the exponentials a register tile at a
# time (a pairwise tree, the running sum rescaled once per tile) and merge
# the partials of warps, lanes and row splits in a fixed tree, where the
# plain version takes one two-pass logsumexp: another association of the
# same sum, a few ulps of the result.
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


_HALF_DTYPES = {"f32": (torch.float32, torch.float32),
                "f64": (torch.float64, torch.float64),
                "bf16-C": (torch.float32, torch.bfloat16)}


def _half_inputs(gen, kind, lanes, m, n, dt, cdt, eps):
    cost = torch.rand((lanes, m, n), generator=gen, device="cuda",
                      dtype=dt).to(cdt)
    vlen, wlen = (n, m) if kind == "row" else (m, n)
    vec = torch.randn((lanes, vlen), generator=gen, device="cuda", dtype=dt)
    logw = torch.full((lanes, wlen), -math.log(wlen), device="cuda",
                      dtype=dt)
    e = torch.as_tensor(eps, device="cuda", dtype=dt).expand(lanes)
    return cost, vec, logw, e.contiguous()


def _half_pair(kind, cost, vec, logw, eps):
    got = getattr(sinkhorn_step, f"{kind}_update_cuda")(cost, vec, logw, eps)
    torch.cuda.synchronize()
    return got, getattr(sinkhorn_step, f"{kind}_update_plain")(cost, vec,
                                                               logw, eps)


@pytest.mark.parametrize("tag", list(_HALF_DTYPES))
@pytest.mark.parametrize("n", [1, 3, 7, 4097, 8191])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_unaligned_rows(dev, tag, n, kind):
    """Rows that are not 16-byte aligned (odd N; N below one 16-byte
    vector) take the scalar-load instantiation."""
    dt, cdt = _HALF_DTYPES[tag]
    got, want = _half_pair(kind, *_half_inputs(_gen(n), kind, 1, 37, n, dt,
                                               cdt, 2e-3))
    torch.testing.assert_close(got, want, **_HALF_TOL[dt])


@pytest.mark.parametrize("tag", list(_HALF_DTYPES))
@pytest.mark.parametrize("m", [1, 7, 4099])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_ragged_rows(dev, tag, m, kind):
    """M not a multiple of a row block's rows nor of a split's rows, and
    M = 1 and 7, below any split count the grid would ask for."""
    dt, cdt = _HALF_DTYPES[tag]
    got, want = _half_pair(kind, *_half_inputs(_gen(m), kind, 1, m, 256, dt,
                                               cdt, 2e-3))
    torch.testing.assert_close(got, want, **_HALF_TOL[dt])


@pytest.mark.parametrize("tag", list(_HALF_DTYPES))
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_three_lanes_ragged(dev, tag, kind):
    """Three lanes, three ε, at a shape ragged in both axes."""
    dt, cdt = _HALF_DTYPES[tag]
    got, want = _half_pair(kind, *_half_inputs(_gen(33), kind, 3, 301, 1029,
                                               dt, cdt, [0.05, 0.01, 2e-3]))
    torch.testing.assert_close(got, want, **_HALF_TOL[dt])


@pytest.mark.parametrize("which", ["duals", "mass"])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_all_neg_inf(dev, which, kind):
    """An all −inf dual vector gives lse = −inf (so +inf out), an all −inf
    log-mass vector −inf out; never NaN, as the plain version."""
    cost, vec, logw, eps = _half_inputs(_gen(9), kind, 1, 300, 520,
                                        torch.float64, torch.float64, 0.01)
    (vec if which == "duals" else logw).fill_(-math.inf)
    got, want = _half_pair(kind, cost, vec, logw, eps)
    assert not torch.isnan(got).any()
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isinf(got).all()


@pytest.mark.parametrize("tag", list(_HALF_DTYPES))
@pytest.mark.parametrize("m,n", [(1000, 1300), (2048, 2048)])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_bitwise_repeatable(dev, tag, m, n, kind):
    """Two launches on the same inputs give the same bits: every merge runs
    in a fixed order and nothing is atomic."""
    dt, cdt = _HALF_DTYPES[tag]
    args = _half_inputs(_gen(m + n), kind, 2, m, n, dt, cdt, [0.01, 2e-3])
    fn = getattr(sinkhorn_step, f"{kind}_update_cuda")
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("tag", list(_HALF_DTYPES))
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_alignment_changes_no_bit(dev, tag, kind):
    """A cost whose storage starts one element past a 16-byte boundary runs
    the scalar-load instantiation; it sums in the same tiles and order as
    the vector loads of an aligned copy, so the bits agree."""
    dt, cdt = _HALF_DTYPES[tag]
    cost, vec, logw, eps = _half_inputs(_gen(21), kind, 2, 300, 1024, dt,
                                        cdt, 2e-3)
    flat = torch.empty(cost.numel() + 1, device="cuda", dtype=cdt)
    shifted = flat[1:].view(cost.shape)
    shifted.copy_(cost)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    fn = getattr(sinkhorn_step, f"{kind}_update_cuda")
    got = fn(shifted, vec, logw, eps)
    want = fn(cost, vec, logw, eps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# The three FGC applies: B3's D̃, and B4's L and Lᵀ (reverse=True).
_FGC = {"dtilde": (fgc_scan.apply_dtilde_cuda, fgc_scan.apply_dtilde_plain),
        "l": (fgc_scan.apply_l_cuda, fgc_scan.apply_l_plain),
        "lt": (lambda x, p: fgc_scan.apply_l_cuda(x, p, reverse=True),
               lambda x, p: fgc_scan.apply_l_plain(x, p, reverse=True))}


def _fgc_within_bar(kind, x, p, got, plain_device=None):
    """|kernel − plain| within twice the recursive-sum bound (p+2)·N·u·(M|x|)
    of each, M the applied matrix (D̃, L or Lᵀ); the plain recursion runs
    on `plain_device` (default x's)."""
    plain = _FGC[kind][1]
    xp = x if plain_device is None else x.to(plain_device)
    want = plain(xp, p).to(got.device)
    scale = plain(xp.abs().double(), p).to(got.device)
    u = torch.finfo(x.dtype).eps / 2
    n = x.shape[0]
    return bool(((got - want).abs().double()
                 <= 2 * (p + 2) * n * u * scale).all())


# (255, 9000) and (257, 9000) straddle a segment boundary of the scan's plan
# on a 132-SM card (tests/test_torch_kernels.py holds that); (8192, 1) and
# (8192, 16) are the squared-distance and D_X Q applies of the factored
# gradient on a grid, (64, 4099) a short N of several segments.
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(1, 1), (3, 7), (200, 130), (513, 1),
                                 (255, 9000), (257, 9000), (8192, 1),
                                 (8192, 16), (64, 4099)])
@pytest.mark.parametrize("p", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["l", "lt", "dtilde"])
def test_fgc_matches_plain(dev, dtype, n, b, p, kind):
    x = torch.randn((n, b), generator=_gen(n + b), device=dev, dtype=dtype)
    got = _FGC[kind][0](x, p)
    assert _fgc_within_bar(kind, x, p, got)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("kind", ["dtilde", "l", "lt"])
def test_fgc_many_segments(dev, p, kind):
    """300 000 rows of one f64 column: over a thousand segments, so each
    carry lane folds its segments in more than one batch (the plain
    recursion runs on the host: 300 000 rows of small ops)."""
    n, dtype = 300_000, torch.float64
    plan = fgc_scan.dtilde_plan(n, 1, 8, torch.cuda.get_device_properties(
        dev).multi_processor_count, streams=1 if kind != "dtilde" else 2)
    assert plan.lane_segs > 4
    x = torch.randn((n, 1), generator=_gen(7), device=dev, dtype=dtype)
    got = _FGC[kind][0](x, p)
    assert _fgc_within_bar(kind, x, p, got, plain_device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(8192, 1), (8192, 16), (64, 4099),
                                 (1000, 130), (257, 9000)])
@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("kind", ["dtilde", "l", "lt"])
def test_fgc_bitwise_repeatable(dev, dtype, n, b, p, kind):
    """The scan sums in a fixed order without float atomics: two launches
    on the same input give the same bits."""
    x = torch.randn((n, b), generator=_gen(n * b), device=dev, dtype=dtype)
    first = _FGC[kind][0](x, p)
    second = _FGC[kind][0](x, p)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,b", [(8192, 1), (8192, 16), (301, 129),
                                 (64, 4099)])
@pytest.mark.parametrize("kind", ["dtilde", "l", "lt"])
def test_fgc_alignment_changes_no_bit(dev, dtype, n, b, kind):
    """An x one element off a 16-byte boundary gives the bits of an aligned
    copy: every element is loaded on its own, in the same order of sums."""
    x = torch.randn((n, b), generator=_gen(n + 3 * b), device=dev,
                    dtype=dtype)
    flat = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = _FGC[kind][0](shifted, 2)
    want = _FGC[kind][0](x, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    # Lᵀ on the kernel route: one B4 launch (its reversed scan), no other
    ops.reset_launch_counts()
    core_fgc.apply_LT(x, backend="kernel")
    assert ops.LAUNCHES == {**dict.fromkeys(ops.LAUNCHES, 0),
                            "fgc_apply_l": 1}


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
                                 (100_003, 16), (100_000, 8), (100_000, 32),
                                 (8192, 16)])
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


def test_dykstra_half_bf16_lk_f64_duals(dev):
    """bf16 lk under f64 duals: both versions widen lk exactly, so the f64
    bars of `test_dykstra_half_matches_plain` hold."""
    gen = _gen(6)
    n, r = 1000, 16
    lk, logw = _lk(gen, 2, n, r, torch.float64, zero_rows=(0, 999))
    gcol = torch.randn((2, r), generator=gen, device=dev,
                       dtype=torch.float64)
    lk16 = lk.to(torch.bfloat16)
    f, col = lr_step.dykstra_half_cuda(lk16, gcol, logw)
    wf, wcol = lr_step.dykstra_half_plain(lk16, gcol, logw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(f), torch.isneginf(wf))
    u = _u(torch.float64)
    fin = torch.isfinite(wf)
    sf = torch.maximum(torch.maximum(logw.abs(), wf.abs()),
                       torch.ones_like(wf))[fin]
    assert ((f - wf).abs()[fin] <= (2 * r + 4) * u * sf).all()
    _assert_col(col, wcol, n, r, u, lk16, gcol, logw)


def test_dykstra_half_unaligned_lane(dev):
    """Two lanes of an odd N at r = 5 in f32: the second lane starts 20·N
    bytes in, off a 16-byte boundary, so the launch takes the scalar-load
    instantiation; it holds the bars of the aligned kernels."""
    gen = _gen(7)
    n, r = 1001, 5
    lk, logw = _lk(gen, 2, n, r, torch.float32, zero_rows=(3, 500))
    assert (n * r * lk.element_size()) % 16 != 0
    gcol = torch.randn((2, r), generator=gen, device=dev)
    f, col = lr_step.dykstra_half_cuda(lk, gcol, logw)
    wf, wcol = lr_step.dykstra_half_plain(lk, gcol, logw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(f), torch.isneginf(wf))
    u = _u(torch.float32)
    fin = torch.isfinite(wf)
    sf = torch.maximum(torch.maximum(logw.abs(), wf.abs()),
                       torch.ones_like(wf))[fin]
    assert ((f - wf).abs()[fin] <= (2 * r + 4) * u * sf).all()
    _assert_col(col, wcol, n, r, u, lk, gcol, logw)


@pytest.mark.parametrize("r", [5, 16, 64, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dykstra_half_alignment_changes_no_bit(dev, r, dtype):
    """lk whose storage starts one element past a 16-byte boundary runs the
    scalar-load instantiation of the same kernel (tier or general); it
    sums in the same tiles and order as an aligned copy, so the bits
    agree."""
    gen = _gen(8 + r)
    lk, logw = _lk(gen, 1, 20_011, r, dtype, zero_rows=(0, 7))
    gcol = torch.randn((1, r), generator=gen, device=dev, dtype=dtype)
    flat = torch.empty(lk.numel() + 1, device="cuda", dtype=dtype)
    shifted = flat[1:].view(lk.shape)
    shifted.copy_(lk)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    got = lr_step.dykstra_half_cuda(shifted, gcol, logw)
    want = lr_step.dykstra_half_cuda(lk, gcol, logw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n,r,lk_dtype,dtype", [
    (1_000_000, 16, torch.float64, torch.float64),
    (100_000, 32, torch.float32, torch.float32),
    (8192, 16, torch.bfloat16, torch.float32),
    (30_001, 300, torch.float64, torch.float64)])
def test_dykstra_half_bitwise_repeatable(dev, n, r, lk_dtype, dtype):
    """Two launches on the same inputs give the same bits: the blocks'
    partials merge in block order after an integer ticket, never by float
    atomics."""
    gen = _gen(n + r)
    lk, logw = _lk(gen, 2, n, r, dtype, zero_rows=(1,))
    lk = lk.to(lk_dtype)
    gcol = torch.randn((2, r), generator=gen, device=dev, dtype=dtype)
    first = lr_step.dykstra_half_cuda(lk, gcol, logw)
    second = lr_step.dykstra_half_cuda(lk, gcol, logw)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _factors(gen, lanes, n, c, r, dtype):
    a = torch.randn((lanes, n, c), generator=gen, device="cuda", dtype=dtype)
    b = torch.randn((lanes, n, c), generator=gen, device="cuda", dtype=dtype)
    q = torch.rand((lanes, n, r), generator=gen, device="cuda", dtype=dtype)
    w = torch.rand((lanes, n), generator=gen, device="cuda", dtype=dtype)
    return a, b, q, w


# B6/B7 shapes: tiny N (fewer rows than the plan's blocks), the scalar
# B7 ranks 1 and 6, c > 8 (B7's W past its registers), r = 64, a ragged N,
# and Run D's 10⁵ rows at r = 8, 16, 32
_LR_SHAPES = [(1, 5, 1), (45, 5, 6), (300, 12, 16), (257, 5, 64),
              (100_003, 5, 16), (100_000, 5, 8), (100_000, 5, 16),
              (100_000, 5, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,r", _LR_SHAPES)
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
@pytest.mark.parametrize("n,c,r", _LR_SHAPES)
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


def _shifted_cloud_factors(gen, n, dtype):
    """The exact squared-Euclidean factors [|x|², 1, −2x] and [1, |x|², x]
    of 3-D Gaussian points shifted by +5 (not centred): the entries of A
    and B are large and the Gram's c-long dot cancels."""
    x = torch.randn((1, n, 3), generator=gen, device="cuda",
                    dtype=torch.float64) + 5.0
    sq = (x ** 2).sum(-1, keepdim=True)
    one = torch.ones_like(sq)
    return (torch.cat([sq, one, -2 * x], -1).to(dtype),
            torch.cat([one, sq, x], -1).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_chain_shifted_cloud(dev, dtype):
    """Run C's law of factors, shifted off the origin, at Run C's N and
    rank: the one-pass association (AᵀQ)ᵀ(BᵀQ) holds the bars of
    `test_gram_chain_matches_plain` where it differs most from the plain
    version's Qᵀ(A·BᵀQ)."""
    gen = _gen(21)
    n, r = 1_000_000, 16
    a, b = _shifted_cloud_factors(gen, n, dtype)
    q = torch.rand((1, n, r), generator=gen, device=dev, dtype=dtype) / n
    w = torch.rand((1, n), generator=gen, device=dev, dtype=dtype)
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
    c = a.shape[2]
    for name, x, y, s in zip(("bq", "gram", "sq", "tq"), got, want, scale):
        assert ((x - y).abs() <= 4 * (n + c) * _u(dtype) * s).all(), name


@pytest.mark.parametrize("n,c,r", [(1_000_000, 5, 16), (100_000, 5, 32),
                                   (300, 12, 16), (45, 5, 6), (1, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_chain_bitwise_repeatable(dev, n, c, r, dtype):
    """Two launches on the same two lanes give the same bits: each lane's
    block partials merge in a fixed pairwise order after an integer
    ticket, never by float atomics."""
    a, b, q, w = _factors(_gen(n + c + r), 2, n, c, r, dtype)
    first = lr_step.gram_chain_cuda(a, b, q, w)
    second = lr_step.gram_chain_cuda(a, b, q, w)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _offset_copy(x):
    """x's values in storage that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    shifted = flat[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    return shifted


@pytest.mark.parametrize("n,c,r", [(100_003, 5, 16), (300, 12, 16),
                                   (45, 5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_chain_alignment_changes_no_bit(dev, n, c, r, dtype):
    """A, B, Q and w in storage off a 16-byte boundary are staged at
    another phase (single-value copies at the ends, 16-byte copies over
    the body); the staged rows and the order of sums are the same, so the
    bits agree with aligned copies."""
    a, b, q, w = _factors(_gen(3 * n + r), 2, n, c, r, dtype)
    got = lr_step.gram_chain_cuda(*(_offset_copy(x) for x in (a, b, q, w)))
    want = lr_step.gram_chain_cuda(a, b, q, w)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n,c,r", [(1_000_000, 5, 16), (100_003, 5, 6),
                                   (300, 12, 16), (45, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grad_combine_bitwise_repeatable(dev, n, c, r, dtype):
    """Two launches on the same two lanes, and A off a 16-byte boundary,
    give the same bits (the vector and the scalar instantiation)."""
    gen = _gen(n + 5 * c + r)
    a, _, _, d2 = _factors(gen, 2, n, c, r, dtype)
    wm = torch.randn((2, c, r), generator=gen, device=dev, dtype=dtype)
    s, t, iq = (torch.randn((2, r), generator=gen, device=dev, dtype=dtype)
                for _ in range(3))
    first = lr_step.grad_combine_cuda(a, wm, d2, s, t, iq)
    second = lr_step.grad_combine_cuda(a, wm, d2, s, t, iq)
    shifted = lr_step.grad_combine_cuda(_offset_copy(a), wm, d2, s, t, iq)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, shifted)


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


def test_lowrank_zero_mass_kernels_match_plain(dev):
    """Zero-mass atoms on both sides of a factored solve on point clouds:
    B5–B7 against the plain path, equal counts and launches as the code
    implies, the zero rows kept at 0."""
    rng = np.random.default_rng(13)
    pts = [torch.tensor(rng.normal(size=(n, 3)), device=dev)
           for n in (300, 400)]
    mu = torch.full((300,), 1.0, device=dev, dtype=torch.float64)
    nu = torch.full((400,), 1.0, device=dev, dtype=torch.float64)
    mu[-7:] = 0.0
    nu[:11] = 0.0
    nu[200] = 0.0
    mu, nu = mu / mu.sum(), nu / nu.sum()
    base = dict(eps=5e-2, outer_iters=15, sinkhorn_iters=50, tol=1e-6,
                eps_init=0.5, anneal_decay=0.7, plan="lowrank", plan_rank=8)
    gx, gy = (PointCloudGeometry(p) for p in pts)
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
    assert float(rk.coupling.q[-7:].abs().max()) == 0.0
    assert float(rk.coupling.r[:11].abs().max()) == 0.0


def test_lowrank_grid_cost_rank_kernels_match_plain(dev):
    """`cost_rank` on grids (M ≠ N; the grids keep their FGC apply): the
    kernel route (B3 and B5; no B6/B7 on grids) against the plain path,
    equal counts and launches as the code implies."""
    n, m = 400, 300
    rng = np.random.default_rng(14)
    mu = torch.tensor(rng.random(n) + 0.1, device=dev)
    nu = torch.tensor(rng.random(m) + 0.1, device=dev)
    mu, nu = mu / mu.sum(), nu / nu.sum()
    gx, gy = Grid1D(n, 1 / (n - 1), 1), Grid1D(m, 1 / (m - 1), 1)
    base = dict(eps=5e-2, outer_iters=10, sinkhorn_iters=50, tol=1e-6,
                eps_init=0.5, anneal_decay=0.7, plan="lowrank", plan_rank=8,
                cost_rank=3)
    ops.reset_launch_counts()
    rk = entropic_gw(gx, gy, mu, nu, GWConfig(backend="kernel",
                                              lowrank_backend="auto", **base))
    counts = dict(ops.LAUNCHES)
    rp = entropic_gw(gx, gy, mu, nu, GWConfig(backend="cumsum",
                                              lowrank_backend="torch",
                                              **base))
    assert rk.info.outer_iters == rp.info.outer_iters
    assert rk.info.inner_iters == rp.info.inner_iters
    assert counts["lr_dykstra_half"] == 2 * rk.info.inner_iters
    assert counts["lr_gram_chain"] == counts["lr_grad_combine"] == 0
    assert counts["fgc_apply_dtilde"] > 0
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


# ---------------------------------------------------------------------------
# lanes: a lane's bits do not depend on the batch it rides in
# ---------------------------------------------------------------------------

_LANE_EPS = (5e-2, 2e-2, 8e-3, 2e-3, 1e-3)


def _ragged_mask(n, lanes, dev):
    """Lane b keeps its first n − 37·b rows; the last lane has none (a
    zero-mass lane)."""
    keep = [n - 37 * b for b in range(lanes - 1)] + [0]
    return torch.arange(n, device=dev)[None, :] < \
        torch.tensor(keep, device=dev)[:, None]


def _lanes_alone(fn, args):
    """fn on each lane of its lane-leading args alone."""
    lanes = args[0].shape[0]
    outs = [fn(*(a[b:b + 1] for a in args)) for b in range(lanes)]
    return [o if isinstance(o, tuple) else (o,) for o in outs]


def _bits(t):
    """A float tensor's bit patterns (NaN payloads included)."""
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _assert_lanes_alone(batched, alone):
    batched = batched if isinstance(batched, tuple) else (batched,)
    for b, single in enumerate(alone):
        for x, y in zip(batched, single):
            assert torch.equal(_bits(x[b]), _bits(y[0])), f"lane {b}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_lanes_take_their_own_bits(dev, dtype, kind):
    """Five lanes in one launch equal five one-lane launches bit for bit:
    ragged rows and columns (−inf duals and log-mass past each lane's
    size), a zero-mass lane and one ε a lane."""
    lanes, m, n = 5, 700, 900
    gen = _gen(41)
    cost = torch.rand((lanes, m, n), generator=gen, device=dev, dtype=dtype)
    vlen, wlen = (n, m) if kind == "row" else (m, n)
    vec = torch.randn((lanes, vlen), generator=gen, device=dev, dtype=dtype)
    vec = torch.where(_ragged_mask(vlen, lanes, dev), vec, -math.inf)
    logw = torch.where(_ragged_mask(wlen, lanes, dev), -math.log(wlen),
                       -math.inf).to(dtype)
    eps = torch.tensor(_LANE_EPS, device=dev, dtype=dtype)
    fn = getattr(ops, f"sinkhorn_{kind}_update_batched")
    args = (cost, vec, logw, eps)
    _assert_lanes_alone(fn(*args), _lanes_alone(fn, args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,cols", [(700, 300), (8192, 1), (300_000, 1),
                                    (64, 4099)])
def test_fgc_dtilde_lanes_take_their_own_bits(dev, dtype, n, cols):
    """B3 with five lanes folded into its columns equals each lane's own
    call bit for bit (a zero lane included)."""
    lanes = 5
    x = torch.randn((n, lanes * cols), generator=_gen(42), device=dev,
                    dtype=dtype)
    x[:, -cols:] = 0.0
    for p in (1, 2):
        got = ops.fgc_apply_dtilde(x, p, lanes=lanes)
        for b in range(lanes):
            own = ops.fgc_apply_dtilde(
                x[:, b * cols:(b + 1) * cols].contiguous(), p)
            assert torch.equal(_bits(got[:, b * cols:(b + 1) * cols]),
                               _bits(own))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,r", [(100_003, 16), (300, 5), (8192, 64)])
def test_dykstra_half_lanes_take_their_own_bits(dev, dtype, n, r):
    lanes = 5
    lk = torch.randn((lanes, n, r), generator=_gen(43), device=dev,
                     dtype=dtype)
    live = _ragged_mask(n, lanes, dev)
    lk = torch.where(live[:, :, None], lk, -math.inf)
    gcol = torch.randn((lanes, r), generator=_gen(44), device=dev,
                       dtype=dtype)
    logw = torch.where(live, -math.log(n), -math.inf).to(dtype)
    args = (lk, gcol, logw)
    _assert_lanes_alone(ops.lr_dykstra_half_batched(*args),
                        _lanes_alone(ops.lr_dykstra_half_batched, args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,c,r", [(100_003, 5, 16), (300, 12, 16),
                                   (1000, 5, 6)])
def test_lowrank_gradient_lanes_take_their_own_bits(dev, dtype, n, c, r):
    """B6 and B7 with five lanes (zero factor rows past each lane's size, a
    zero lane) equal five one-lane launches bit for bit."""
    lanes, gen = 5, _gen(45)
    z = _ragged_mask(n, lanes, dev).to(dtype)
    a, b = (torch.randn((lanes, n, c), generator=gen, device=dev,
                        dtype=dtype) * z[:, :, None] for _ in range(2))
    q = torch.rand((lanes, n, r), generator=gen, device=dev,
                   dtype=dtype) * z[:, :, None] / n
    w = torch.rand((lanes, n), generator=gen, device=dev, dtype=dtype) * z
    args = (a, b, q, w)
    _assert_lanes_alone(ops.lr_gram_chain_batched(*args),
                        _lanes_alone(ops.lr_gram_chain_batched, args))
    wm = torch.randn((lanes, c, r), generator=gen, device=dev, dtype=dtype)
    s_, t_, iq = (torch.randn((lanes, r), generator=gen, device=dev,
                              dtype=dtype) for _ in range(3))
    args = (a, wm, w, s_, t_, iq)
    _assert_lanes_alone(ops.lr_grad_combine_batched(*args),
                        _lanes_alone(ops.lr_grad_combine_batched, args))


def _dtilde_plan_one_problem(n, cols, itemsize, sms, blocks_per_sm,
                             state_blocks_per_sm, streams):
    """The scan's plan for one problem as it is written without the lane
    argument: what `fgc_scan.dtilde_plan(lanes=1)` must still return."""
    pow2 = fgc_scan._pow2_at_least
    tc = min(fgc_scan.DTILDE_COL_TILE, pow2(cols))
    tiles = -(-cols // tc)
    want = fgc_scan.DTILDE_MIN_BLOCKS_PER_SM * sms
    for chunk in fgc_scan.DTILDE_CHUNKS[itemsize]:
        groups = min(fgc_scan.DTILDE_MAX_GROUPS, fgc_scan.DTILDE_THREADS // tc)
        while groups > 1 and groups // 2 * chunk >= n:
            groups //= 2
        while groups > 1 and tiles * -(-n // (groups * chunk)) < want:
            groups //= 2
        if tiles * -(-n // (groups * chunk)) >= want:
            break
    seg_rows = groups * chunk
    segments = -(-n // seg_rows)
    lanes = min(fgc_scan.DTILDE_CARRY_THREADS,
                pow2(-(-segments // fgc_scan.DTILDE_LANE_SEGS)))
    lane_segs = pow2(-(-segments // lanes))
    carry_cols = min(fgc_scan.DTILDE_CARRY_THREADS // lanes, pow2(cols))
    items = tiles * segments
    return fgc_scan.DtildePlan(chunk, seg_rows, tc, segments, groups,
                               carry_cols, lanes, lane_segs,
                               min(items, state_blocks_per_sm * sms),
                               min(items, blocks_per_sm * sms), streams)


# Runs A–E's applies: A's 8192² and its C1 column, B's unfolded axes, E's
# (8192, 16) factor apply
@pytest.mark.parametrize("n,cols", [(8192, 8192), (8192, 1), (64, 262144),
                                    (64, 1), (8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("streams", [2, 1])
def test_dtilde_plan_one_lane_is_unchanged(dev, n, cols, dtype, streams):
    """At one lane the launch plan on this card, its occupancy included,
    equals the one-problem plan field by field."""
    size = torch.empty((), dtype=dtype).element_size()
    tag = fgc_scan._DTYPE_TAG[dtype]
    got = fgc_scan._launch_plan(tag, n, cols, size, 1, streams, 1, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = getattr(fgc_scan._library(), f"fgc_scan_residency_{tag}")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    resident = (ctypes.c_int * 2)()
    first = fgc_scan.dtilde_plan(n, cols, size, sms, streams=streams)
    assert fn(1, streams, first.col_tile, first.groups, first.chunk,
              resident) == 0
    assert got == _dtilde_plan_one_problem(n, cols, size, sms, resident[1],
                                           resident[0], streams)


# ---------------------------------------------------------------------------
# batches on the card
# ---------------------------------------------------------------------------

def _measures_np(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def test_dense_batch_matches_solo_counts(dev):
    """Ragged Grid1D lanes on the kernels, per-lane ε: each lane's counts
    equal its solo solve's, its plan and value within f64 rounding."""
    from repro_torch.core import SolveControls, entropic_gw_batch
    probs = [(Grid1D(m, 1 / (m - 1), 1), Grid1D(n, 1 / (n - 1), 1),
              _measures_np(m, 2 * i), _measures_np(n, 2 * i + 1))
             for i, (m, n) in enumerate([(300, 260), (220, 300), (180, 200),
                                         (256, 256)])]
    cfg = GWConfig(eps=2e-3, eps_init=5e-2, tol=1e-6, outer_iters=30,
                   sinkhorn_iters=300, backend="kernel")
    ctls = [SolveControls.make(e, 1e-6, 5e-2, device=dev)
            for e in (5e-2, 2e-2, 8e-3, 2e-3)]
    ops.reset_launch_counts()
    out = entropic_gw_batch(probs, cfg, pad_to=(320, 320), controls=ctls)
    assert ops.LAUNCHES["sinkhorn_row_update"] < \
        sum(r.info.inner_iters for r in out)
    for r, p, c in zip(out, probs, ctls):
        solo = entropic_gw(*p, cfg, controls=c)
        assert (r.info.outer_iters, r.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)
        assert float((r.plan - solo.plan).abs().sum()) <= 1e-6
        assert abs(float(r.value - solo.value)) <= 1e-8 * abs(float(solo.value))


def test_factored_batch_matches_solo_counts(dev):
    from repro_torch.core import entropic_gw_batch
    rng = np.random.default_rng(46)
    probs = []
    for m, n in ((300, 380), (350, 300), (400, 400)):
        probs.append((PointCloudGeometry(torch.tensor(rng.normal(size=(m, 3)),
                                                      device=dev)),
                      PointCloudGeometry(torch.tensor(rng.normal(size=(n, 3)),
                                                      device=dev)),
                      np.ones(m) / m, np.ones(n) / n))
    cfg = GWConfig(eps=5e-2, outer_iters=15, sinkhorn_iters=50, tol=1e-6,
                   eps_init=0.5, anneal_decay=0.7, plan="lowrank",
                   plan_rank=8)
    ops.reset_launch_counts()
    out = entropic_gw_batch(probs, cfg, pad_to=(400, 400))
    steps = max(r.info.outer_iters for r in out)
    assert ops.LAUNCHES["lr_grad_combine"] == 2 * steps
    for r, p in zip(out, probs):
        solo = entropic_gw(*p, cfg)
        assert (r.info.outer_iters, r.info.inner_iters) == \
            (solo.info.outer_iters, solo.info.inner_iters)
        assert float(r.coupling.delta(solo.coupling)) <= 1e-6
        assert abs(float(r.value - solo.value)) <= 1e-8 * abs(float(solo.value))


def test_factored_batch_lanes_take_their_own_bits(dev):
    """A factored lane of a wide batch has the bits and counts of its lane
    alone at the same padding, at 10⁵ points a side, where PyTorch's sums
    over the rows and the small cuBLAS products of the gradient split
    their work by the batch's width (`geometry.per_lane`): the serving
    engine refills and repacks factored buckets."""
    from repro_torch.core import SolveControls, entropic_gw_batch
    rng = np.random.default_rng(47)
    probs = []
    for m, n in ((99_000, 100_000), (98_500, 99_500), (100_000, 98_800),
                 (99_700, 99_900)):
        probs.append(tuple(
            PointCloudGeometry(torch.tensor(rng.normal(size=(k, 3)),
                                            device=dev)) for k in (m, n))
            + (torch.full((m,), 1.0 / m, dtype=torch.float64, device=dev),
               torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)))
    cfg = GWConfig(eps=5e-2, outer_iters=12, sinkhorn_iters=50, tol=1e-6,
                   plan="lowrank", plan_rank=16)
    ctls = [SolveControls.make(5e-2, 1e-6, e0, 0.7, device=dev)
            for e0 in (0.5, 5e-2, 0.2, 0.1)]
    pad = (100_000, 100_000)
    wide = entropic_gw_batch(probs, cfg, pad_to=pad, controls=ctls)
    for res, p, c in zip(wide, probs, ctls):
        (alone,) = entropic_gw_batch([p], cfg, pad_to=pad, controls=[c])
        for x, y in zip((res.coupling.q, res.coupling.r, res.coupling.g),
                        (alone.coupling.q, alone.coupling.r,
                         alone.coupling.g)):
            assert torch.equal(x, y)
        assert (res.info.outer_iters, res.info.inner_iters) == \
            (alone.info.outer_iters, alone.info.inner_iters)


def test_controls_build_nothing(dev):
    """ε, tol and the schedule are run-time tensors: a solve with other
    values of them leaves the build directory as it was."""
    from repro_torch.kernels import build
    n = 200
    grid = Grid1D(n, 1 / (n - 1), 1)
    mu, nu = _measures_np(n, 1), _measures_np(n, 2)
    entropic_gw(grid, grid, mu, nu, GWConfig(backend="kernel", eps=2e-3))
    before = sorted(p.name for p in build.build_dir().iterdir())
    for knobs in (dict(eps=8e-3), dict(eps=2e-3, tol=1e-6, eps_init=5e-2),
                  dict(eps=5e-3, tol=1e-5, eps_init=0.1, anneal_decay=0.7,
                       inner_loosen=0.0)):
        entropic_gw(grid, grid, mu, nu, GWConfig(backend="kernel", **knobs))
    assert sorted(p.name for p in build.build_dir().iterdir()) == before


# ---------------------------------------------------------------------------
# reverse mode: the implicit backward pass behind a kernel forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_implicit_grad_through_kernels_matches_torch(dev, plan):
    """The gradient of a solve whose forward ran the kernels (B1/B2, or
    B5–B7 on factor pairs) equals the one whose forward ran the plain
    route: the backward is the same plain one-step map, at states that
    differ by rounding (f64, rtol 1e-8)."""
    m, n = 300, 260
    mu, nu = _measures_np(m, 3), _measures_np(n, 4)
    # 1-D clouds, whose exact factors (rank 3) make the factored solve
    # run B6/B7; it converges at step 18 (on random 3-D clouds it does not
    # converge, and an unconverged state's gradient is no yardstick)
    px = (np.arange(m) / (m - 1))[:, None]
    py = (np.arange(n) / (n - 1))[:, None]
    grads = []
    for route in ("auto", "torch"):
        ops.reset_launch_counts()
        mu_t = torch.tensor(mu, device=dev, requires_grad=True)
        if plan == "full":
            h = torch.tensor(1 / (m - 1), dtype=torch.float64, device=dev,
                             requires_grad=True)
            gx, gy, wrt = Grid1D(m, h, 1), Grid1D(n, 1 / (n - 1), 1), h
            cfg = GWConfig(eps=5e-2, tol=1e-10, outer_iters=60,
                           sinkhorn_iters=1000, sinkhorn_backend=route)
        else:
            pts = torch.tensor(px, device=dev, requires_grad=True)
            gx, wrt = PointCloudGeometry(pts), pts
            gy = PointCloudGeometry(torch.tensor(py, device=dev))
            cfg = GWConfig(eps=5e-2, tol=1e-10, outer_iters=100,
                           sinkhorn_iters=400, plan="lowrank", plan_rank=6,
                           lr_gamma=5.0, lowrank_backend=route)
        res = entropic_gw(gx, gy, mu_t, nu, cfg)
        assert res.info.converged
        launched = sum(ops.LAUNCHES.values())
        assert (launched > 0) == (route == "auto")
        grads.append(torch.autograd.grad(res.value, (wrt, mu_t)))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-12)


# The reference's own spread on the case below, its lowrank_backend
# "pallas" (interpret mode) against "xla" under jax.grad, max |Δ| over
# max |gradient|: 2.07e-9 in the points and 3.30e-9 in μ (CPU, float64;
# `tests/reference_spreads.py grad_3d`; the port's own spread on the card
# by `tools/grad_spread_3d.py`).
# The solve stops at its outer cap unconverged, where the gradient
# amplifies rounding, so that spread is the bar of kernels against plain.
_GRAD_3D_SPREAD = (2.07e-9, 3.30e-9)


def test_implicit_grad_through_kernels_3d_clouds_within_reference_spread(
        dev):
    """The factored solve's gradient on random 3-D clouds (which stop
    unconverged at 100 outer steps): kernels (B5–B7) forward against the
    plain forward, held to the reference's own pallas-against-xla spread
    on the same inputs."""
    m, n = 300, 260
    mu, nu = _measures_np(m, 3), _measures_np(n, 4)
    px = np.random.default_rng(5).normal(size=(m, 3))
    py = np.random.default_rng(6).normal(size=(n, 3))
    grads = []
    for route in ("auto", "torch"):
        pts = torch.tensor(px, device=dev, requires_grad=True)
        mu_t = torch.tensor(mu, device=dev, requires_grad=True)
        res = entropic_gw(PointCloudGeometry(pts),
                          PointCloudGeometry(torch.tensor(py, device=dev)),
                          mu_t, nu, GWConfig(
                              eps=5e-2, tol=1e-10, outer_iters=100,
                              sinkhorn_iters=400, plan="lowrank",
                              plan_rank=6, lr_gamma=5.0,
                              lowrank_backend=route))
        assert (res.info.outer_iters, res.info.converged) == (100, False)
        grads.append(torch.autograd.grad(res.value, (pts, mu_t)))
    for (a, b), bar in zip(zip(*grads), _GRAD_3D_SPREAD):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max() / b.abs().max()) <= bar


def test_ragged_batch_with_zero_mass_backpropagates_without_nan(dev):
    """Five ragged FGW lanes on the kernels, padded, one with zero-mass
    atoms of its own: finite gradients everywhere, exact zeros on the
    zero-mass rows of its feature cost."""
    from repro_torch.core import FGWConfig, entropic_gw_batch
    rng = np.random.default_rng(48)
    sizes = [(120, 150), (150, 100), (90, 90), (140, 130), (100, 110)]
    probs, feats = [], []
    for i, (m, n) in enumerate(sizes):
        mu = _measures_np(m, 10 + i)
        if i == 2:
            mu[-20:] = 0.0
            mu /= mu.sum()
        probs.append((Grid1D(m, 1 / (m - 1), 1), Grid1D(n, 1 / (n - 1), 1),
                      torch.tensor(mu, device=dev, requires_grad=True),
                      _measures_np(n, 20 + i)))
        feats.append(torch.tensor(rng.random((m, n)), device=dev,
                                  requires_grad=True))
    cfg = FGWConfig(eps=5e-2, tol=1e-8, outer_iters=30, sinkhorn_iters=300,
                    theta=0.5)
    out = entropic_gw_batch(probs, cfg, pad_to=(160, 160), features=feats)
    wrt = feats + [p[2] for p in probs]
    grads = torch.autograd.grad(sum(r.value for r in out), wrt)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[2][-20:].abs().max()) == 0.0
    assert float(grads[2][:-20].abs().max()) > 0.0


def test_kernel_fgc_backend_refuses_grad(dev):
    """The FGC scan kernels have no backward (as the reference's Pallas
    scan has no transpose): asking for a gradient through them raises."""
    h = torch.tensor(1 / 99, dtype=torch.float64, device=dev,
                     requires_grad=True)
    mu = _measures_np(100, 5)
    with pytest.raises(NotImplementedError, match="FGC kernel"):
        entropic_gw(Grid1D(100, h, 1), Grid1D(100, 1 / 99, 1), mu, mu,
                    GWConfig(backend="kernel", outer_iters=2))


# ---------------------------------------------------------------------------
# the GW variants and sliced GW on the card
# ---------------------------------------------------------------------------

def test_ugw_kernel_fgc_matches_plain(dev):
    """An adaptive unbalanced solve at a few hundred points: the FGC
    kernel (B3) route against the plain cumsum route, equal counts, plan
    and value to rounding (f64)."""
    from repro_torch.core import UGWConfig, entropic_ugw
    n = 300
    g = Grid1D(n, 1 / (n - 1), 1)
    mu, nu = _measures_np(n, 61), _measures_np(n, 62)
    out = []
    for backend in ("kernel", "cumsum"):
        ops.reset_launch_counts()
        out.append(entropic_ugw(g, g, mu, nu, UGWConfig(
            eps=1e-2, rho=1.0, tol=1e-7, eps_init=1e-1, outer_iters=30,
            sinkhorn_iters=300, backend=backend)))
        assert (ops.LAUNCHES["fgc_apply_dtilde"] ==
                4 * out[-1].info.outer_iters + 4) == (backend == "kernel")
    k, p = out
    assert k.info.converged
    assert (k.info.outer_iters, k.info.inner_iters) == \
        (p.info.outer_iters, p.info.inner_iters)
    torch.testing.assert_close(k.plan, p.plan, rtol=1e-9, atol=1e-15)
    torch.testing.assert_close(k.value, p.value, rtol=1e-10, atol=0)


def test_coot_kernels_match_plain(dev):
    """COOT with both half-steps on B1/B2 (and B3 through
    bilinear_product on grid sides) against the plain route: equal counts,
    plans and value to rounding (f64)."""
    from repro_torch.core.coot import COOTConfig, entropic_coot
    rng = np.random.default_rng(63)
    x, y = rng.random((300, 40)), rng.random((260, 24))
    marg = [np.full(k, 1.0 / k) for k in (300, 260, 40, 24)]
    n = 200
    g = Grid1D(n, 1 / (n - 1), 1)
    dmat = g.dist_matrix(device="cuda")
    gmarg = [_measures_np(n, 64 + i) for i in range(4)]
    for args, grids in (((x, y, *marg), {}),
                        ((dmat, dmat, *gmarg), dict(grid_x=g, grid_y=g))):
        out = []
        for sk, fgc in (("auto", "kernel"), ("torch", "cumsum")):
            ops.reset_launch_counts()
            out.append(entropic_coot(*args, COOTConfig(
                outer_iters=5, sinkhorn_iters=80, sinkhorn_backend=sk,
                backend=fgc), return_info=True, **grids))
            launched = ops.LAUNCHES["sinkhorn_row_update"]
            assert launched == (out[-1][3].inner_iters if sk == "auto"
                                else 0)
        (ks, kv, kval, ki), (ps, pv, pval, pi) = out
        assert (ki.outer_iters, ki.inner_iters) == \
            (pi.outer_iters, pi.inner_iters)
        torch.testing.assert_close(ks, ps, rtol=1e-9, atol=1e-15)
        torch.testing.assert_close(kv, pv, rtol=1e-9, atol=1e-15)
        torch.testing.assert_close(kval, pval, rtol=1e-10, atol=0)


def test_barycenter_kernels_match_plain(dev):
    """The barycenter's plan solves on B1/B2 and B3 against the plain
    route (Run M's controls at a few hundred points): D̄ within 1e-8
    normwise, plans within 1e-6 in L1, feasible within 1e-4."""
    from repro_torch.core import BarycenterConfig, gw_barycenter
    sizes = (150, 200, 250)
    grids = [Grid1D(s, 1 / (s - 1), 1) for s in sizes]
    nus = [torch.tensor(_measures_np(s, 70 + i), device=dev)
           for i, s in enumerate(sizes)]
    mu_bar = torch.full((220,), 1 / 220, dtype=torch.float64, device=dev)
    out = []
    for sk, fgc in (("auto", "kernel"), ("torch", "cumsum")):
        out.append(gw_barycenter(grids, nus, (0.5, 0.3, 0.2), mu_bar,
                                 BarycenterConfig(
                                     eps=5e-3, outer_iters=3, gw_iters=5,
                                     sinkhorn_iters=100, tol=1e-6,
                                     eps_init=5e-2, sinkhorn_backend=sk,
                                     backend=fgc)))
    (dk, pk), (dp, pp) = out
    assert float((dk - dp).abs().max() / dp.abs().max()) <= 1e-8
    for a, b, nu in zip(pk, pp, nus):
        assert float((a - b).abs().sum()) <= 1e-6
        assert float((a.sum(0) - nu).abs().max()) <= 1e-4
        assert float((a.sum(1) - mu_bar).abs().max()) <= 1e-4


def _box(n, seed, scale=1.0):
    r = np.random.default_rng(seed)
    pts = (r.random((n, 3)) - 0.5) * np.array([1.0, 2.0, 3.0]) * scale
    w = np.exp(0.5 * (pts / (np.array([1.0, 2.0, 3.0]) * scale)).sum(1))
    return pts, w / w.sum()


def _sliced_on(dev, pts, ws, **kw):
    from repro_torch.core import sliced_gw
    g = [PointCloudGeometry(torch.tensor(p, device=dev)) for p in pts]
    return sliced_gw(*g, *(torch.tensor(w, device=dev) for w in ws),
                     device=dev, **kw)


def test_resample_and_grid_method_equal_bits_over_two_calls(dev):
    """The grid method bins in a fixed order (no float atomics): the
    binning and a whole sliced_gw(method="grid") give the same bits on two
    calls."""
    from repro_torch.core import sliced
    (a, wa), (b, wb) = _box(20_000, 71), _box(15_000, 72, 1.3)
    x = torch.tensor((a @ np.random.default_rng(73).normal(size=(3, 8))).T
                     .copy(), device=dev)
    w = torch.tensor(wa, device=dev)
    h1, m1 = sliced._resample_1d(x, w, 512)
    h2, m2 = sliced._resample_1d(x, w, 512)
    assert torch.equal(h1, h2) and torch.equal(m1, m2)
    first, second = (_sliced_on(dev, (a, b), (wa, wb), n_proj=4,
                                method="grid", grid_n=128,
                                grid_backend="kernel") for _ in range(2))
    assert torch.isfinite(first.profile).all()
    assert torch.equal(first.profile, second.profile)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sorted_sliced_matches_cpu_run(dev, dtype):
    """The sorted estimate on the card against the port's own CPU run on
    the same inputs and the same (default, CPU-drawn) bank: f64 within
    1e-9 relative, profile included; f32 within 1e-4."""
    (a, wa), (b, wb) = _box(50_000, 74), _box(40_000, 75, 1.3)
    pts = [p.astype(np.float64 if dtype == torch.float64 else np.float32)
           for p in (a, b)]
    ws = [w.astype(pts[0].dtype) for w in (wa, wb)]
    card = _sliced_on(dev, pts, ws, n_proj=32)
    cpu = _sliced_on("cpu", pts, ws, n_proj=32)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    torch.testing.assert_close(card.profile.cpu(), cpu.profile, rtol=tol,
                               atol=0)
    torch.testing.assert_close(card.estimate.cpu(), cpu.estimate, rtol=tol,
                               atol=0)


# ---------------------------------------------------------------------------
# serving: the GW engine's schedulers on the kernels
# ---------------------------------------------------------------------------

def _serve_grids(sizes, seed0):
    return [(Grid1D(s, 1 / (s - 1), 1), Grid1D(s, 1 / (s - 1), 1),
             _measures_np(s, seed0 + 2 * i), _measures_np(s, seed0 + 2 * i + 1))
            for i, s in enumerate(sizes)]


def _serve_same_bits(a, b):
    for x, y in ((a.plan, b.plan), (a.f, b.f), (a.g, b.g)):
        assert torch.equal(x, y)
    assert (a.info.outer_iters, a.info.inner_iters) == \
        (b.info.outer_iters, b.info.inner_iters)
    assert abs(float(a.value - b.value)) <= 1e-12 * abs(float(b.value))


def test_serving_continuous_equals_barrier_on_kernels(dev):
    """The counterpart of tests/test_sinkhorn_backend.py:264: continuous
    slot scheduling returns the barrier's bits with the kernels (B1/B2,
    and B3 on the FGC kernel backend) doing every sweep; against the
    unbatched solve the lanes match to f64 rounding with equal counts."""
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    solver = GWConfig(eps=1e-2, outer_iters=10, sinkhorn_iters=60, tol=1e-6,
                      sinkhorn_backend="kernel", backend="kernel")
    probs = _serve_grids((30, 40, 36, 25), 47)
    outs = {}
    for sched in ("continuous", "barrier"):
        eng = GWEngine(GWServeConfig(solver=solver, max_batch=4,
                                     size_bucket=64, scheduler=sched,
                                     segment_iters=3))
        rids = [eng.submit(*p) for p in probs]
        ops.reset_launch_counts()
        res = eng.flush()
        assert ops.LAUNCHES["sinkhorn_row_update"] > 0
        assert ops.LAUNCHES["fgc_apply_dtilde"] > 0
        assert sorted(res) == sorted(rids)
        outs[sched] = [res[r] for r in rids]
    for c, b in zip(outs["continuous"], outs["barrier"]):
        _serve_same_bits(c, b)
    for c, p in zip(outs["continuous"], probs):
        one = entropic_gw(*p, solver)
        assert (c.info.outer_iters, c.info.inner_iters) == \
            (one.info.outer_iters, one.info.inner_iters)
        torch.testing.assert_close(c.plan, one.plan, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("route", ["kernel", "torch"])
def test_serve_config_backend_override_reaches_kernels(dev, route):
    """``GWServeConfig.sinkhorn_backend`` / ``lowrank_backend`` override the
    solver's: "kernel" launches B1/B2 (and B5–B7 on a factored bucket),
    "torch" launches none of them."""
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    solver = GWConfig(eps=1e-2, outer_iters=4, sinkhorn_iters=40, tol=1e-5,
                      sinkhorn_backend="auto", lowrank_backend="auto",
                      plan_rank=8)
    eng = GWEngine(GWServeConfig(solver=solver, max_batch=4, size_bucket=32,
                                 sinkhorn_backend=route,
                                 lowrank_backend=route, lowrank_above=300))
    for p in _serve_grids((20, 25), 61):
        eng.submit(*p)
    rng = np.random.default_rng(62)
    for n in (320, 350):
        cloud = PointCloudGeometry(torch.tensor(rng.normal(size=(n, 3)),
                                                device=dev))
        eng.submit(cloud, cloud, np.ones(n) / n, np.ones(n) / n)
    ops.reset_launch_counts()
    assert len(eng.flush()) == 4
    moved = {k: v for k, v in ops.LAUNCHES.items() if v}
    if route == "kernel":
        assert {"sinkhorn_row_update", "sinkhorn_col_update",
                "lr_dykstra_half", "lr_gram_chain",
                "lr_grad_combine"} <= set(moved)
    else:
        assert moved == {}


def test_pipeline_two_buckets_equal_continuous_on_kernels(dev):
    """Two buckets (a grid bucket on B1–B3, a factored one on B5–B7) in
    flight at once, each on a worker thread and a stream of its own:
    every result the continuous scheduler's bits, the launches counted
    from both threads, and both buckets' segments in flight together.
    Each bucket has more requests than its four slots (five grids padded
    to 256 points, six clouds to 2624), so both refill (one grid refill,
    two factored ones) while the other bucket's segment runs."""
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    solver = GWConfig(eps=2e-2, outer_iters=12, sinkhorn_iters=80, tol=1e-6,
                      eps_init=5e-2, backend="kernel", plan_rank=8)
    rng = np.random.default_rng(63)
    probs = _serve_grids((200, 240, 230, 256, 220), 64)
    # six ragged clouds of one size bucket (2561–2624 points, padded to
    # 2624): a factored bucket of four slots
    for n in (2570, 2624, 2600, 2581, 2612, 2590):
        cloud = PointCloudGeometry(torch.tensor(rng.normal(size=(n, 3)),
                                                device=dev))
        probs.append((cloud, cloud, np.ones(n) / n, np.ones(n) / n))
    outs, launches = {}, {}
    for sched in ("continuous", "pipeline"):
        eng = GWEngine(GWServeConfig(solver=solver, max_batch=4,
                                     size_bucket=64, scheduler=sched,
                                     segment_iters=3, lowrank_above=2000,
                                     max_inflight_buckets=2))
        rids = [eng.submit(*p) for p in probs]
        ops.reset_launch_counts()
        res = eng.flush()
        launches[sched] = dict(ops.LAUNCHES)
        outs[sched] = [res[r] for r in rids]
        assert eng.stats["refills"] == 3
        if sched == "pipeline":
            assert max(eng.stats["dispatch_depth"]) >= 2
    assert launches["pipeline"] == launches["continuous"]
    for c, p in zip(outs["continuous"], outs["pipeline"]):
        if c.plan is not None:
            _serve_same_bits(c, p)
        else:
            for x, y in ((c.coupling.q, p.coupling.q),
                         (c.coupling.r, p.coupling.r),
                         (c.coupling.g, p.coupling.g)):
                assert torch.equal(x, y)
            assert (c.info.outer_iters, c.info.inner_iters) == \
                (p.info.outer_iters, p.info.inner_iters)


def test_serving_stream_keeps_the_slot_width_menu_and_builds_nothing(
        dev, monkeypatch):
    """The counterpart of tests/test_sinkhorn_backend.py:304: a mixed-ε
    stream through the kernels uses ≤ log2(max_batch)+1 slot widths a
    bucket and, once the kernels are built, builds nothing."""
    from repro_torch.kernels import build
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    solver = GWConfig(eps=1e-2, outer_iters=6, sinkhorn_iters=40, tol=1e-5,
                      backend="kernel")
    eng = GWEngine(GWServeConfig(solver=solver, max_batch=4, size_bucket=32,
                                 segment_iters=3))
    eng.submit(*_serve_grids((20,), 60)[0])
    eng.flush()                            # the kernels are built by now
    widths = set()
    real = engine_mod._segment_stacked

    def rec(gx, gy, mus, *rest):
        widths.add(mus.shape[0])
        return real(gx, gy, mus, *rest)

    def no_build():
        raise AssertionError("a kernel was built during the stream")

    monkeypatch.setattr(engine_mod, "_segment_stacked", rec)
    monkeypatch.setattr(build, "build_all", no_build)
    for i, (s, eps) in enumerate([(20, 1e-2), (25, 5e-2), (30, 2e-2),
                                  (28, 1e-2)]):
        eng.submit(*_serve_grids((s,), 61 + 2 * i)[0], eps=eps)
    assert len(eng.flush()) == 4
    assert widths <= {1, 2, 4}


@pytest.mark.parametrize("cols", [1, 3, 300])
def test_dense_and_factored_applies_take_their_own_bits(dev, cols):
    """A dense or factored apply gives a lane the bits it has alone, at any
    batch width: the serving engine's lanes change width as it refills
    and repacks."""
    from repro_torch.core.geometry import DenseStack, LowRankStack
    gen = _gen(cols)
    n = 300
    cost = torch.rand((4, n, n), generator=gen, device=dev,
                      dtype=torch.float64)
    a = torch.rand((4, n, 5), generator=gen, device=dev, dtype=torch.float64)
    b = torch.rand((4, n, 5), generator=gen, device=dev, dtype=torch.float64)
    x = torch.rand((4, n, cols), generator=gen, device=dev,
                   dtype=torch.float64)
    for stack in (DenseStack(cost), LowRankStack(a, b)):
        wide = stack.apply_dist(x, 1, 2)
        for k in range(4):
            one = type(stack)(*(t[k:k + 1] for t in (
                (cost,) if isinstance(stack, DenseStack) else (a, b))))
            assert torch.equal(wide[k], one.apply_dist(x[k:k + 1], 1, 2)[0])


@pytest.mark.parametrize("lanes,n", [(32, 512), (4, 8192)])
def test_wide_applies_take_their_own_bits_at_the_main_paths_shapes(
        dev, lanes, n):
    """The applies whose outputs are wide stay one batched product
    (`geometry._lanes_mm`); a lane keeps the bits it has alone at the main
    path's shapes: sliced GW's grid method (32 dense 512-point lanes
    applied to their plans) and the refine tier's full-plan clouds (4
    factored 8192-point lanes applied to their plans), and at the plan's
    squared-distance column."""
    from repro_torch.core.geometry import DenseStack, LowRankStack
    gen = _gen(n)
    cost = torch.rand((lanes, n, n), generator=gen, device=dev,
                      dtype=torch.float64)
    a = torch.rand((lanes, n, 5), generator=gen, device=dev,
                   dtype=torch.float64)
    b = torch.rand((lanes, n, 5), generator=gen, device=dev,
                   dtype=torch.float64)
    for cols in (n, 1):
        x = torch.rand((lanes, n, cols), generator=gen, device=dev,
                       dtype=torch.float64)
        for stack, parts in ((DenseStack(cost), (cost,)),
                             (LowRankStack(a, b), (a, b))):
            wide = stack.apply_dist(x, 1, 2)
            for k in (0, lanes - 1):
                one = type(stack)(*(t[k:k + 1] for t in parts))
                assert torch.equal(wide[k],
                                   one.apply_dist(x[k:k + 1], 1, 2)[0])


# ---------------------------------------------------------------------------
# the LM substrate: every smoke architecture on the card
# ---------------------------------------------------------------------------

# f32 logits, card against CPU and prefill/decode against forward: the same
# arithmetic summed in other orders (cuBLAS against the CPU's BLAS, a padded
# cache against the chunked forward); xLSTM's sLSTM recurrence amplifies a
# one-ulp change ~10× (tests/test_torch_models.py).  TF32 is off.
_LM_F32 = dict(atol=1e-5, rtol=1e-5)
_LM_XLSTM_F32 = dict(atol=5e-5, rtol=1e-4)


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _lm_smoke(arch):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    cpu = torch.Generator().manual_seed(3)
    model = lm.init_params(cfg, cpu, "cpu")
    b, s = 2, 40
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=cpu)}
    else:
        batch = {"embeddings": torch.randn((b, s, cfg.d_model),
                                           generator=cpu) * 0.1}
    return cfg, model, batch


@pytest.mark.parametrize("arch", ["smollm-360m", "phi3-mini-3.8b",
                                  "starcoder2-15b", "olmo-1b", "qwen2-vl-72b",
                                  "deepseek-v2-lite-16b", "mixtral-8x22b",
                                  "xlstm-350m", "musicgen-medium",
                                  "zamba2-7b"])
def test_lm_smoke_on_the_card(dev, no_tf32, arch):
    """The forward on the card against the CPU on the same weights, and a
    prefill of 37 tokens plus 3 decode steps (past the smoke windows: the
    ring buffer) against the card's forward."""
    from repro_torch.models import lm
    cfg, model, batch = _lm_smoke(arch)
    bar = _LM_XLSTM_F32 if arch == "xlstm-350m" else _LM_F32
    with torch.inference_mode():
        want, _ = lm.forward(model, batch, cfg)
        model = model.to(dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        full, aux = lm.forward(model, batch, cfg)
        torch.testing.assert_close(full.cpu(), want, **bar)
        assert torch.isfinite(aux)
        caches = lm.cache_init(cfg, 2, 44, torch.float32, dev)
        pre = {k: v[:, :37] for k, v in batch.items()}
        lg, caches = lm.prefill(model, pre, cfg, caches)
        torch.testing.assert_close(lg, full[:, 36], **bar)
        for t in range(37, 40):
            lg, caches = lm.decode_step(
                model, {k: v[:, t:t + 1] for k, v in batch.items()}, caches,
                cfg)
            torch.testing.assert_close(lg, full[:, t], **bar)


# The train step's FGW term solves in f32 and its implicit gradient's
# Neumann series amplifies rounding: two f32 evaluations of the step's
# gradient sit up to 1.4e-3 of a parameter's largest gradient from the f64
# one (tests/train_spreads.py), so the card and the CPU are held to 3e-3,
# the CPU tests' bar against the reference (tests/_torch_train.py).
_TRAIN_GW_F32 = 3e-3


def _train_smoke(dev_, gw_weight, backend="auto"):
    import dataclasses
    from repro_torch import configs
    from repro_torch.core.losses import AlignConfig
    from repro_torch.train import loop, optimizer
    cfg = dataclasses.replace(configs.get_smoke("smollm-360m"),
                              dtype="float32")
    tcfg = loop.TrainConfig(
        microbatches=2, remat=True, gw_align_weight=gw_weight,
        gw_align=AlignConfig(theta=0.5, outer_iters=2, sinkhorn_iters=20,
                             sinkhorn_backend=backend),
        optimizer=optimizer.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=10))
    state = loop.init_state(cfg, tcfg, torch.Generator().manual_seed(5),
                            "cpu")
    if dev_.type == "cuda":
        state.model.to(dev_)
        state.opt = optimizer.init(state.params(), tcfg.optimizer)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (4, 24))
    batch = {"tokens": toks, "labels": toks,
             "teacher_h": rng.normal(size=(4, 24, cfg.d_model)).astype(
                 np.float32)}
    return cfg, tcfg, state, batch


def test_train_step_on_the_card_with_the_fgw_kernels(dev, no_tf32):
    """A smoke train step with the FGW distillation term (2 microbatches,
    remat) on the card against the same step on the CPU: the scalars and
    the moments within the FGW bar, B1/B2 launched once an inner update
    of each microbatch's batched solve (2 × 2 outer × 20 updates), and
    against the same step on the plain route."""
    from repro_torch.train import loop
    out = {}
    for where, backend in (("cpu", "auto"), ("card", "auto"),
                           ("card plain", "torch")):
        d = torch.device("cpu") if where == "cpu" else dev
        cfg, tcfg, state, batch = _train_smoke(d, 0.5, backend)
        ops.reset_launch_counts()
        metrics = loop.train_step(state, batch, cfg, tcfg)
        torch.cuda.synchronize()
        out[where] = (metrics, state, dict(ops.LAUNCHES))
    n = 2 * 2 * 20
    assert out["card"][2] == dict(ops.LAUNCHES, sinkhorn_row_update=n,
                                  sinkhorn_col_update=n, fgc_apply_dtilde=0,
                                  fgc_apply_l=0, lr_dykstra_half=0,
                                  lr_gram_chain=0, lr_grad_combine=0)
    assert sum(out["card plain"][2].values()) == 0
    want_m, want_s, _ = out["cpu"]
    for key in ("card", "card plain"):
        m, s, _ = out[key]
        assert m.keys() == want_m.keys() and "gw_align" in m
        for k in m:
            torch.testing.assert_close(m[k].cpu(), want_m[k],
                                       rtol=_TRAIN_GW_F32, atol=0)
        for k, v in want_s.opt.m.items():
            got = s.opt.m[k].cpu()
            assert float((got - v).abs().max()) <= \
                _TRAIN_GW_F32 * float(v.abs().max()), (key, k)
        assert s.step == 1 and s.opt.step == 1


def test_checkpoint_from_the_card_restores_on_the_cpu(dev, tmp_path):
    """A train state saved from the card (and a bf16 leaf) restores on the
    CPU and back on the card with the same bits."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import loop
    cfg, tcfg, state, batch = _train_smoke(dev, 0.0)
    loop.train_step(state, batch, cfg, tcfg)
    tree = loop.state_tree(state)
    tree["bf16"] = torch.randn(7, device=dev).bfloat16()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, tree)
    mgr.wait()
    like = {"params": {k: torch.empty_like(v, device="meta")
                       for k, v in tree["params"].items()},
            "opt": {"m": {k: torch.zeros_like(v, device="cpu")
                          for k, v in state.opt.m.items()},
                    "v": {k: torch.zeros_like(v, device="cpu")
                          for k, v in state.opt.v.items()}, "step": 0},
            "step": 0, "bf16": torch.zeros(7, dtype=torch.bfloat16)}
    on_cpu = mgr.restore(like, device="cpu")
    back = mgr.restore(like, device=dev)
    for k, p in tree["params"].items():
        assert on_cpu["params"][k].device.type == "cpu"
        assert torch.equal(on_cpu["params"][k], p.detach().cpu())
        assert back["params"][k].device == p.device
        assert torch.equal(back["params"][k], p.detach())
    for k, v in state.opt.m.items():
        assert torch.equal(on_cpu["opt"]["m"][k], v.cpu())
    assert on_cpu["bf16"].dtype == torch.bfloat16
    assert torch.equal(on_cpu["bf16"], tree["bf16"].cpu())
    assert on_cpu["step"] == on_cpu["opt"]["step"] == 1


# ---------------------------------------------------------------------------
# the sharded path: DTensor on a DeviceMesh over NCCL
# ---------------------------------------------------------------------------

# the sharded step against one card's: f32 sums in other orders (NCCL's
# reductions, the shards' matmuls), chip_smoke.py's Q_F32_BAR
_SHARDED_F32 = 1e-4


def _four_cards():
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs 4 cards for the (2, 2) and (4, 1) meshes; "
                    f"{n} here")


def _one_card_step(dev_, gw_weight):
    from repro_torch.train import loop
    cfg, tcfg, state, batch = _train_smoke(dev_, gw_weight)
    metrics = loop.train_step(state, batch, cfg, tcfg)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach().cpu().numpy() for k, p in state.params().items()},
            {k: v.cpu().numpy() for k, v in state.opt.m.items()},
            {k: v.cpu().numpy() for k, v in state.opt.v.items()})


@pytest.mark.parametrize("gw_weight", [0.0, 0.5])
def test_sharded_step_on_four_cards(dev, no_tf32, tmp_path, gw_weight):
    """4 NCCL ranks (tests/_torch_dist.py): the smoke step on (2, 2)
    ("2d") and (4, 1) ("dp"), with the FGW term on B1/B2 where its weight
    is set, against one card's step from the same state."""
    _four_cards()
    from _torch_dist import Ranks, check_state
    cfg, tcfg, _, batch = _train_smoke(dev, gw_weight)
    cases = [{"kind": "step", "name": f"{s}/{m}", "cfg": cfg, "tcfg": tcfg,
              "seed": 5, "batch": batch, "strategy": s, "mesh": m}
             for s, m in (("2d", (2, 2)), ("dp", (4, 1)))]
    ranks = Ranks(tmp_path, cases, device="cuda")
    want = _one_card_step(dev, gw_weight)
    bar = _TRAIN_GW_F32 if gw_weight else _SHARDED_F32
    for c in cases:
        got = ranks.case(c["name"])
        check_state(got, *want, bar)
        assert not any(got["layout"][k] for k in ("placements", "block",
                                                  "zero"))


def test_elastic_restore_on_four_cards(dev, no_tf32, tmp_path):
    """Saved on (2, 2), restored on (4, 1) and (1, 4): every leaf the
    saved state's bits; one step on (4, 1) within the sharded bar of one
    card's step from the same state."""
    _four_cards()
    from _torch_dist import Ranks, check_state
    cfg, tcfg, state, batch = _train_smoke(dev, 0.0)
    ranks = Ranks(tmp_path, [{"kind": "elastic", "name": "elastic",
                              "cfg": cfg, "tcfg": tcfg, "seed": 5,
                              "batch": batch, "dir": str(tmp_path / "c")}],
                  device="cuda")
    got = ranks.case("elastic")
    for mesh in ("4x1", "1x4"):
        for k, p in state.params().items():
            np.testing.assert_array_equal(got[mesh]["params"][k],
                                          p.detach().cpu().numpy())
        assert got[mesh]["laid"]
    check_state(got["4x1"]["after"], *_one_card_step(dev, 0.0),
                _SHARDED_F32)


@pytest.fixture
def one_rank(dev):
    """A world of one NCCL rank on this card, and its (1, 1) mesh."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch import mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield mesh.local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


def test_sharded_step_on_a_one_by_one_mesh(dev, no_tf32, one_rank,
                                            tmp_path):
    """One card as a (1, 1) mesh: the step with the FGW term on B1/B2
    against the unsharded step, and a checkpoint saved on the mesh
    restored without one, bit for bit."""
    from _torch_dist import check_state
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import loop
    cfg, tcfg, state, batch = _train_smoke(dev, 0.5)
    loop.shard_state(state, one_rank)
    ops.reset_launch_counts()
    metrics = loop.train_step(state, batch, cfg, tcfg)
    assert ops.LAUNCHES["sinkhorn_row_update"] == 2 * 2 * 20
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {k: p.full_tensor().detach().cpu().numpy()
                      for k, p in state.params().items()},
           "m": {k: v.full_tensor().cpu().numpy()
                 for k, v in state.opt.m.items()},
           "v": {k: v.full_tensor().cpu().numpy()
                 for k, v in state.opt.v.items()}}
    check_state(got, *_one_card_step(dev, 0.5), _TRAIN_GW_F32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, loop.state_tree(state))
    plain = loop.init_state(cfg, tcfg, torch.Generator().manual_seed(1),
                            dev)
    tree = mgr.restore(loop.state_tree(plain))
    for k, v in got["params"].items():
        assert type(tree["params"][k]) is torch.Tensor
        np.testing.assert_array_equal(tree["params"][k].cpu().numpy(), v)


# ---------------------------------------------------------------------------
# the production dry run on the card (chip_smoke.py's Run S(a))
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,mesh", [
    ("smollm-360m", "all", "single"),
    ("deepseek-v2-lite-16b", "train_4k", "multi")])
def test_dry_run_on_the_card(dev, tmp_path, arch, shape, mesh):
    """Run S(a)'s cells through the dry run's CLI, in a process of their
    own (its fake group shares no process with another group): no error
    and no share out of memory, smollm's long_500k skipped, each argument
    bytes the specs' reckoning (`specs.argument_bytes`),
    each peak at least its arguments, the collective kinds of "2d"."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cuda", "--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
         str(out), "--no-flops"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    recs = json.loads(out.read_text())
    assert not any("error" in r for r in recs)
    ran = [r for r in recs if "skipped" not in r]
    assert len(ran) == (3 if shape == "all" else 1)
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import specs
    for r in ran:
        assert "oom" not in r, r["oom"]
        mem = r["memory_per_device"]
        assert mem["argument_bytes"] == specs.argument_bytes(
            configs.get(r["arch"]), SHAPES[r["shape"]],
            [int(n) for n in r["mesh"].split("x")], r["strategy"])
        assert mem["total_bytes"] >= mem["argument_bytes"]
        kinds = set(r["collectives"]["counts"])
        assert kinds and kinds <= {"all-reduce", "all-gather",
                                   "reduce-scatter", "all-to-all"}
        assert r["hbm_bytes"] == torch.cuda.get_device_properties(
            0).total_memory
