"""The port's kernel modules on the CPU: the plain versions of B1–B4 against
the reference's Pallas kernels (interpret mode), and the wrappers' CPU
dispatch.  Inputs are made with numpy from a seed and handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sinkhorn_step as jsk
from repro_torch.kernels import fgc_scan, ops, sinkhorn_step

RNG = np.random.default_rng(11)

# Half-step tolerance: the reference's own bar for the fused kernel against
# the XLA expression (tests/test_kernels.py) — ≤1 ulp-level: the kernel
# associates the +inf-padded tile sums differently.
_TOL = {np.float32: dict(rtol=2e-6, atol=2e-6),
        np.float64: dict(rtol=1e-14, atol=1e-15)}


def _half_inputs(m, n, dtype, lanes=None):
    shape = (m, n) if lanes is None else (lanes, m, n)
    cost = RNG.random(shape).astype(dtype)
    vshape = shape[:-2] + (n,)
    g = RNG.normal(size=vshape).astype(dtype)
    f = RNG.normal(size=shape[:-2] + (m,)).astype(dtype)
    log_mu = np.log(np.full(shape[:-2] + (m,), 1.0 / m)).astype(dtype)
    log_nu = np.log(np.full(vshape, 1.0 / n)).astype(dtype)
    return cost, g, f, log_mu, log_nu


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(1, 5), (37, 53), (100, 130), (200, 140)])
@pytest.mark.parametrize("eps", [0.05, 0.002])
def test_half_steps_match_pallas(dtype, m, n, eps):
    cost, g, f, log_mu, log_nu = _half_inputs(m, n, dtype)
    want_f = jsk.sinkhorn_row_update_pallas(
        jnp.asarray(cost), jnp.asarray(g), jnp.asarray(log_mu),
        dtype(eps), interpret=True)
    want_g = jsk.sinkhorn_col_update_pallas(
        jnp.asarray(cost), jnp.asarray(f), jnp.asarray(log_nu),
        dtype(eps), interpret=True)
    got_f = ops.sinkhorn_row_update(_t(cost), _t(g), _t(log_mu), eps)
    got_g = ops.sinkhorn_col_update(_t(cost), _t(f), _t(log_nu), eps)
    assert got_f.dtype == got_g.dtype == torch.from_numpy(cost).dtype
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               **_TOL[dtype])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               **_TOL[dtype])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_zero_mass_leading_tile(kind):
    """An all-masked leading reduction tile (−inf potentials on the first
    130 > 128 atoms) and −inf log-mass outputs: −inf out, never NaN, equal
    to the reference kernel."""
    m, n, eps = 40, 160, 0.01
    cost = RNG.random((m, n)) if kind == "row" else RNG.random((n, m))
    vec = np.where(np.arange(n) < 130, -np.inf, RNG.normal(size=n))
    logw = np.log(np.full(m, 1.0 / m))
    logw[[0, 7, 29]] = -np.inf
    if kind == "row":
        want = jsk.sinkhorn_row_update_pallas(
            jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw), eps,
            interpret=True)
        got = ops.sinkhorn_row_update(_t(cost), _t(vec), _t(logw), eps)
    else:
        want = jsk.sinkhorn_col_update_pallas(
            jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw), eps,
            interpret=True)
        got = ops.sinkhorn_col_update(_t(cost), _t(vec), _t(logw), eps)
    assert not torch.isnan(got).any()
    np.testing.assert_array_equal(torch.isneginf(got).numpy(),
                                  np.isneginf(logw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float64])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_lanes_per_lane_eps(kind):
    """(B, M, N) lanes with one ε per lane against the reference's batched
    wrappers."""
    cost, g, f, log_mu, log_nu = _half_inputs(40, 56, np.float64, lanes=3)
    epss = np.array([0.05, 0.01, 0.002])
    vec, logw = (g, log_mu) if kind == "row" else (f, log_nu)
    ref = getattr(jsk, f"sinkhorn_{kind}_update_pallas_batched")
    want = ref(jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw),
               jnp.asarray(epss), interpret=True)
    got = getattr(ops, f"sinkhorn_{kind}_update_batched")(
        _t(cost), _t(vec), _t(logw), _t(epss))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float64])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_bf16_cost(kind):
    """cost_dtype="bf16": C rounded to bfloat16, duals and accumulation in
    f32 — the same rounding on both sides (f32 → bf16 is one rounding)."""
    cost, g, f, log_mu, log_nu = _half_inputs(64, 72, np.float32)
    vec, logw = (g, log_mu) if kind == "row" else (f, log_nu)
    ref = getattr(jsk, f"sinkhorn_{kind}_update_pallas")
    want = ref(jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw),
               np.float32(0.01), interpret=True, cost_dtype="bf16")
    got = getattr(ops, f"sinkhorn_{kind}_update")(
        _t(cost), _t(vec), _t(logw), 0.01, cost_dtype="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float32])


@pytest.mark.parametrize("n", [3, 64, 200, 257])
@pytest.mark.parametrize("b", [1, 7, 130])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_fgc_plain_matches_pallas(n, b, p):
    """B3/B4 plain recursions against the reference kernels (interpret
    mode); f64 rounding of two O(N^p) recursions → relative 1e-10."""
    x = RNG.normal(size=(n, b))
    want_l = jops.fgc_apply_l(jnp.asarray(x), p)
    want_d = jops.fgc_apply_dtilde(jnp.asarray(x), p)
    got_l = ops.fgc_apply_l(_t(x), p)
    got_d = ops.fgc_apply_dtilde(_t(x), p)
    scale = float(n) ** p
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-10, atol=1e-12 * scale)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-10, atol=1e-12 * scale)


def test_fgc_plain_f32_keeps_dtype():
    x = RNG.normal(size=(100, 40)).astype(np.float32)
    got = ops.fgc_apply_dtilde(_t(x), 2)
    want = jops.fgc_apply_dtilde(jnp.asarray(x), 2)
    assert got.dtype == torch.float32
    # f32 recursion over 100 rows: relative 1e-4 of the |D̃||x| scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * 100 ** 2)


def test_cpu_wrappers_run_plain_and_count_nothing():
    ops.reset_launch_counts()
    x = _t(RNG.normal(size=(20, 3)))
    torch.testing.assert_close(ops.fgc_apply_l(x, 2),
                               fgc_scan.apply_l_plain(x, 2))
    cost, g, _, log_mu, _ = _half_inputs(5, 6, np.float64)
    ops.sinkhorn_row_update(_t(cost), _t(g), _t(log_mu), 0.1)
    assert set(ops.LAUNCHES.values()) == {0}


def test_cuda_entry_points_refuse_cpu_tensors():
    x = _t(RNG.normal(size=(20, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        fgc_scan.apply_l_cuda(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fgc_scan.apply_dtilde_cuda(x, 1)
    cost, g, f, log_mu, _ = _half_inputs(5, 6, np.float64, lanes=1)
    eps = torch.full((1,), 0.1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_step.row_update_cuda(_t(cost), _t(g), _t(log_mu), eps)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_step.col_update_cuda(_t(cost), _t(f), _t(log_mu), eps)


@pytest.mark.parametrize("name,device,want", [
    ("auto", "cpu", "torch"), ("auto", "cuda", "kernel"),
    ("torch", "cpu", "torch"), ("torch", "cuda", "torch"),
    ("kernel", "cuda", "kernel")])
def test_resolve_sinkhorn_backend(name, device, want):
    assert ops.resolve_sinkhorn_backend(name, device) == want


def test_resolve_sinkhorn_backend_refuses():
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_sinkhorn_backend("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown"):
        ops.resolve_sinkhorn_backend("pallas", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_lowrank_backend("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown lowrank backend"):
        ops.resolve_lowrank_backend("xla", "cpu")
