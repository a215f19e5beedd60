"""The port's grids, geometry and gradient operator against the reference,
on numpy inputs made from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GradientOperator as JOp
from repro.core import grids as jgrids
from repro_torch.core import (DenseGeometry, GradientOperator, GridGeometry,
                              as_geometry, grids)

RNG = np.random.default_rng(5)
BACKENDS = {"scan": "scan", "cumsum": "cumsum", "kernel": "pallas",
            "dense": "dense"}
# f64 parity: the same O(k²) sums in another order (rtol), plus an atol
# for entries that cancel to ~0
TOL = dict(rtol=1e-10, atol=1e-12)


def _grids(kind, n, k):
    h = 1 / (n - 1)
    return (getattr(grids, kind)(n, h, k), getattr(jgrids, kind)(n, h, k))


@pytest.mark.parametrize("kind,n", [("Grid1D", 23), ("Grid2D", 5)])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("power_mult", [0, 1, 2])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_apply_dist_matches_reference(kind, n, k, power_mult, backend):
    tg, jg = _grids(kind, n, k)
    x = RNG.random((tg.size, 3))
    for axis in (0, 1):
        xa = x if axis == 0 else x.T.copy()
        want = jg.apply_dist(jnp.asarray(xa), axis=axis,
                             power_mult=power_mult,
                             backend=BACKENDS[backend])
        got = tg.apply_dist(torch.from_numpy(xa), axis=axis,
                            power_mult=power_mult, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,n", [("Grid1D", 9), ("Grid2D", 4)])
def test_dist_matrix_and_products(kind, n):
    tg, jg = _grids(kind, n, 1)
    np.testing.assert_array_equal(tg.dist_matrix(2).numpy(),
                                  np.asarray(jg.dist_matrix(2)))
    gamma = RNG.random((tg.size, tg.size))
    want = jgrids.gw_product(jg, jg, jnp.asarray(gamma))
    got = grids.gw_product(tg, tg, torch.from_numpy(gamma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        grids.gw_product_dense(tg, tg, torch.from_numpy(gamma)).numpy(),
        np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,n,m", [("Grid1D", 17, 12), ("Grid2D", 4, 3)])
@pytest.mark.parametrize("backend", ["cumsum", "kernel"])
def test_gradient_operator_matches_reference(kind, n, m, backend):
    tx, jx = _grids(kind, n, 1)
    ty, jy = _grids(kind, m, 2)
    mu = RNG.random(tx.size) + 0.1
    nu = RNG.random(ty.size) + 0.1
    gamma = RNG.random((tx.size, ty.size))
    top = GradientOperator(tx, ty, backend)
    jop = JOp(jx, jy, BACKENDS[backend])
    c1, dx2, dy2 = top.constant_term(torch.from_numpy(mu),
                                     torch.from_numpy(nu))
    jc1, jdx2, jdy2 = jop.constant_term(jnp.asarray(mu), jnp.asarray(nu))
    for a, b in ((c1, jc1), (dx2, jdx2), (dy2, jdy2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    g = torch.from_numpy(gamma)
    np.testing.assert_allclose(top.grad(g, c1).numpy(),
                               np.asarray(jop.grad(jnp.asarray(gamma), jc1)),
                               **TOL)
    np.testing.assert_allclose(float(top.energy(g)),
                               float(jop.energy(jnp.asarray(gamma))),
                               rtol=1e-12)


def test_geometry_adapter_and_dense_geometry():
    g = grids.Grid1D(8, 0.5, 1)
    geom = as_geometry(g, "kernel")
    assert isinstance(geom, GridGeometry) and geom.size == 8
    assert geom.spec == ("grid", "Grid1D", 8, 1, "kernel")
    assert as_geometry(geom) is geom
    with pytest.raises(ValueError, match="unknown grid backend"):
        as_geometry(g, "pallas")
    with pytest.raises(TypeError):
        as_geometry("not a geometry")
    dense = DenseGeometry(g.dist_matrix())
    x = torch.from_numpy(RNG.random((8, 2)))
    for pm in (0, 1, 2):
        torch.testing.assert_close(dense.apply_dist(x, 0, pm),
                                   geom.apply_dist(x, 0, pm),
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        DenseGeometry(torch.zeros((3, 4)))
