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

from repro_torch.core import GWConfig, Grid1D, entropic_gw
from repro_torch.kernels import fgc_scan, ops, sinkhorn_step

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
                            "fgc_apply_dtilde": 1, "fgc_apply_l": 1}


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
