"""The port's factored-plan kernel module and geometries on the CPU: the
plain versions of B5–B7 against the reference's Pallas kernels (interpret
mode), the wrappers' CPU dispatch and backend knob, and the low-rank and
point-cloud geometries.  Inputs are made with numpy from a seed and handed
to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.kernels import lr_step as jlr
from repro_torch.core import geometry as geo
from repro_torch.kernels import lr_step, ops

RNG = np.random.default_rng(12)

# B5's tolerance: the reference's own ≤1-ulp-level bar for a fused kernel
# against its XLA twin (tests/test_torch_kernels.py): the row and column
# LSEs associate their sums otherwise.
_TOL = {np.float32: dict(rtol=2e-6, atol=2e-6),
        np.float64: dict(rtol=1e-14, atol=1e-15)}
SHAPES = [(1, 1), (45, 6), (300, 16), (257, 64)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dykstra_inputs(n, r, dtype, zero_rows=()):
    lk = RNG.normal(size=(n, r)).astype(dtype)
    gcol = RNG.normal(size=r).astype(dtype)
    logw = np.full(n, -np.log(n), dtype)
    lk[list(zero_rows)] = -np.inf
    logw[list(zero_rows)] = -np.inf
    return lk, gcol, logw


def _dykstra_both(lk, gcol, logw, cost_dtype="f32"):
    wf, wcol = jlr.lr_dykstra_half_pallas(
        jnp.asarray(lk), jnp.asarray(gcol), jnp.asarray(logw),
        interpret=True, cost_dtype=cost_dtype)
    f, col = lr_step.dykstra_half_plain(
        ops.cast_cost(_t(lk)[None], cost_dtype), _t(gcol)[None],
        _t(logw)[None])
    return (f[0].numpy(), col[0].numpy()), (np.asarray(wf), np.asarray(wcol))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,r", SHAPES)
def test_dykstra_half_plain_matches_pallas(dtype, n, r):
    (f, col), (wf, wcol) = _dykstra_both(*_dykstra_inputs(n, r, dtype))
    assert f.dtype == col.dtype == dtype
    np.testing.assert_allclose(f, wf, **_TOL[dtype])
    np.testing.assert_allclose(col, wcol, **_TOL[dtype])


def test_dykstra_half_zero_mass_rows():
    """Zero-mass rows (log w = −inf and −inf kernel rows): −inf out, never
    NaN, and the column LSE ignores them, as the reference's kernel."""
    n, r = 300, 16
    zero = [0, 7, 128, 129, 299]
    (f, col), (wf, wcol) = _dykstra_both(
        *_dykstra_inputs(n, r, np.float64, zero))
    assert not np.isnan(f).any() and not np.isnan(col).any()
    np.testing.assert_array_equal(np.isneginf(f), np.isin(np.arange(n), zero))
    np.testing.assert_allclose(f, wf, **_TOL[np.float64])
    np.testing.assert_allclose(col, wcol, **_TOL[np.float64])
    # an all-zero-mass problem: every output is −inf
    (f, col), _ = _dykstra_both(*_dykstra_inputs(3, 4, np.float64,
                                                 range(3)))
    assert np.isneginf(f).all() and np.isneginf(col).all()


def test_dykstra_half_bf16_lk():
    """cost_dtype="bf16": both read lk rounded to bfloat16 and sum in the
    duals' dtype, so the f32 bar holds."""
    (f, col), (wf, wcol) = _dykstra_both(
        *_dykstra_inputs(300, 16, np.float32, (5,)), cost_dtype="bf16")
    np.testing.assert_allclose(f, wf, **_TOL[np.float32])
    np.testing.assert_allclose(col, wcol, **_TOL[np.float32])


def _gram_inputs(n, c, r, dtype):
    return (RNG.normal(size=(n, c)).astype(dtype),
            RNG.normal(size=(n, c)).astype(dtype),
            RNG.random((n, r)).astype(dtype), RNG.random(n).astype(dtype))


def _within_sum_bound(got, want, scale, terms, dtype):
    """Both versions are within terms·u·scale of the exact sum (a dot of
    ``terms`` products in any order); their difference twice that."""
    u = np.finfo(dtype).eps / 2
    assert (np.abs(got - want) <= 2 * terms * u * scale).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,r", SHAPES)
@pytest.mark.parametrize("c", [5, 12])
def test_gram_chain_plain_matches_pallas(dtype, n, r, c):
    a, b, q, w = _gram_inputs(n, c, r, dtype)
    want = jlr.lr_gram_chain_pallas(*(jnp.asarray(x) for x in (a, b, q, w)),
                                    interpret=True)
    got = ops.lr_gram_chain(*(_t(x) for x in (a, b, q, w)))
    scale = lr_step.gram_chain_plain(*(_t(np.abs(x))[None]
                                       for x in (a, b, q, w)))
    for x, y, s in zip(got, want, scale):
        assert x.dtype == torch.from_numpy(a).dtype
        # the Gram sums N products of (A·bq), itself a c-long dot of an
        # N-long one
        _within_sum_bound(x.numpy(), np.asarray(y), s[0].numpy(), n + c,
                          dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,r", SHAPES)
@pytest.mark.parametrize("c", [5, 12])
def test_grad_combine_plain_matches_pallas(dtype, n, r, c):
    a = RNG.normal(size=(n, c)).astype(dtype)
    wm = RNG.normal(size=(c, r)).astype(dtype)
    d2 = RNG.random(n).astype(dtype)
    s, t, iq = (RNG.normal(size=r).astype(dtype) for _ in range(3))
    want = jlr.lr_grad_combine_pallas(
        *(jnp.asarray(x) for x in (a, wm, d2, s, t, iq)), interpret=True)
    got = ops.lr_grad_combine(*(_t(x) for x in (a, wm, d2, s, t, iq)))
    scale = (2 * (np.abs(d2)[:, None] * np.abs(s)[None] + np.abs(t)[None])
             + 4 * np.abs(a) @ np.abs(wm)) * np.abs(iq)[None]
    # only the c-long dot is summed otherwise; the tail rounds alike
    _within_sum_bound(got.numpy(), np.asarray(want), scale, c + 3, dtype)


def test_cpu_wrappers_run_plain_and_count_nothing():
    ops.reset_launch_counts()
    lk, gcol, logw = (_t(x) for x in _dykstra_inputs(45, 6, np.float64))
    f, col = ops.lr_dykstra_half(lk, gcol, logw)
    wf, wcol = lr_step.dykstra_half_plain(lk[None], gcol[None], logw[None])
    assert torch.equal(f, wf[0]) and torch.equal(col, wcol[0])
    a, b, q, w = (_t(x) for x in _gram_inputs(45, 5, 6, np.float64))
    for x, y in zip(ops.lr_gram_chain(a, b, q, w),
                    lr_step.gram_chain_plain(a[None], b[None], q[None],
                                             w[None])):
        assert torch.equal(x, y[0])
    wm, s = torch.ones((5, 6), dtype=torch.float64), torch.ones(6).double()
    assert torch.equal(ops.lr_grad_combine(a, wm, w, s, s, s),
                       lr_step.grad_combine_plain(a[None], wm[None], w[None],
                                                  s[None], s[None],
                                                  s[None])[0])
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_resolve_lowrank_backend():
    assert ops.resolve_lowrank_backend("auto", "cpu") == "torch"
    assert ops.resolve_lowrank_backend("torch", "cpu") == "torch"
    assert ops.resolve_lowrank_backend("auto", "cuda") == "kernel"
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_lowrank_backend("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown lowrank backend"):
        ops.resolve_lowrank_backend("pallas", "cpu")


# ---------------------------------------------------------------------------
# the geometries the factored plan runs on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("power", [1, 2])
@pytest.mark.parametrize("axis", [0, 1])
def test_low_rank_apply_dist_matches_reference(power, axis):
    n, r = 40, 5
    a, b = RNG.normal(size=(n, r)), RNG.normal(size=(n, r))
    x = RNG.normal(size=(n, 7) if axis == 0 else (7, n))
    want = jgeo.LowRankGeometry(jnp.asarray(a), jnp.asarray(b)).apply_dist(
        jnp.asarray(x), axis=axis, power_mult=power)
    tg = geo.LowRankGeometry(_t(a), _t(b))
    got = tg.apply_dist(_t(x), axis=axis, power_mult=power)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    assert tg.cost_rank == r and tg.for_factored_plan() is tg
    # f64 factors under an f32 operand promote, never downcast
    assert tg.apply_dist(_t(x.astype(np.float32)), axis, power).dtype \
        == torch.float64
    np.testing.assert_allclose(tg.dist_matrix(power).numpy(),
                               np.asarray(jgeo.LowRankGeometry(
                                   jnp.asarray(a), jnp.asarray(b))
                                   .dist_matrix(power)), rtol=1e-12)


def test_point_cloud_to_low_rank_matches_reference():
    pts = RNG.normal(size=(30, 3)) + 5.0
    jpc = jgeo.PointCloudGeometry(jnp.asarray(pts))
    tpc = geo.PointCloudGeometry(_t(pts))
    # the exact centred sqeuclidean factors (rank d+2)
    lr, jlr_ = tpc.to_low_rank(), jpc.to_low_rank()
    assert lr.rank == 5 and tpc.for_factored_plan().rank == 5
    np.testing.assert_allclose(lr.a.numpy(), np.asarray(jlr_.a), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(lr.b.numpy(), np.asarray(jlr_.b), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(tpc.dist_matrix().numpy(),
                               np.asarray(jpc.dist_matrix()), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(lr.dist_matrix().numpy(),
                               np.asarray(jpc.dist_matrix()), atol=1e-11)
    # the truncated SVD at a given r (euclidean): the same factorization up
    # to the sign of each singular pair
    jeu = jgeo.PointCloudGeometry(jnp.asarray(pts), "euclidean")
    teu = geo.PointCloudGeometry(_t(pts), "euclidean")
    got, want = teu.to_low_rank(4), jeu.to_low_rank(4)
    sign = np.sign((got.a.numpy() * np.asarray(want.a)).sum(0))
    np.testing.assert_allclose(got.a.numpy() * sign, np.asarray(want.a),
                               atol=1e-10)
    np.testing.assert_allclose(got.b.numpy() * sign, np.asarray(want.b),
                               atol=1e-10)
    with pytest.raises(ValueError, match="explicit r"):
        teu.to_low_rank()
    assert isinstance(teu.materialize(), geo.DenseGeometry)
