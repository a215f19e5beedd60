"""The port's FGC primitives (``repro_torch.core.fgc``) against the
reference's backends of the same name, on numpy inputs made from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fgc as jfgc
from repro_torch.core import fgc

RNG = np.random.default_rng(3)

# port name → reference name
BACKENDS = {"scan": "scan", "cumsum": "cumsum", "blocked": "blocked",
            "dense": "dense", "kernel": "pallas"}


def _close(got, want, n, p):
    # f64, two O(N^p)-magnitude computations of the same sums
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-12 * max(n, 2) ** p)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("p", [0, 1, 2, 3])
@pytest.mark.parametrize("shape,axis", [((33,), 0), ((40, 5), 0),
                                        ((6, 37), 1), ((4, 9, 3), 1)])
def test_apply_abs_power_matches_reference(backend, p, shape, axis):
    x = RNG.normal(size=shape)
    want = jfgc.apply_abs_power(jnp.asarray(x), axis=axis, power=p,
                                backend=BACKENDS[backend])
    got = fgc.apply_abs_power(torch.from_numpy(x), axis=axis, power=p,
                              backend=backend)
    _close(got, want, shape[axis], p)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("p", [0, 1, 3])
@pytest.mark.parametrize("which", ["apply_L", "apply_LT"])
@pytest.mark.parametrize("shape,axis", [((45, 6), 0), ((33,), 0),
                                        ((6, 37), 1), ((4, 9, 3), 1)])
def test_apply_L_LT_match_reference(backend, p, which, shape, axis):
    """Every axis and rank: under ``kernel`` apply_LT takes the L kernel's
    reversed scan (its plain version here), the reference the flip
    expression."""
    x = RNG.normal(size=shape)
    want = getattr(jfgc, which)(jnp.asarray(x), axis=axis, power=p,
                                backend=BACKENDS[backend])
    got = getattr(fgc, which)(torch.from_numpy(x), axis=axis, power=p,
                              backend=backend)
    _close(got, want, shape[axis], p)


def test_cumsum_f32_centred_index():
    """f32 accuracy of the closed form rests on the centred index t = i −
    N/2: against the f64 dense oracle the f32 cumsum stays at f32 level."""
    n, p = 512, 2
    x = RNG.random((n, 4))
    exact = fgc.apply_abs_power(torch.from_numpy(x), power=p,
                                backend="dense")
    got = fgc.apply_abs_power(torch.from_numpy(x.astype(np.float32)),
                              power=p, backend="cumsum")
    want = jfgc.apply_abs_power(jnp.asarray(x, jnp.float32), power=p,
                                backend="cumsum")
    assert got.dtype == torch.float32
    rel = float(((got.double() - exact).abs() / exact.abs()).max())
    rel_ref = float(np.max(np.abs(np.asarray(want, np.float64)
                                  - exact.numpy()) / np.abs(exact.numpy())))
    assert rel < 1e-4 and rel <= 4 * rel_ref + 1e-6


def test_pascal_toeplitz_flops():
    np.testing.assert_array_equal(fgc.pascal_matrix(4).numpy(),
                                  np.asarray(jfgc.pascal_matrix(4)))
    np.testing.assert_array_equal(fgc.lower_toeplitz(7, 2).numpy(),
                                  np.asarray(jfgc.lower_toeplitz(7, 2)))
    assert fgc.flops_estimate(100, 3) == jfgc.flops_estimate(100, 3)


def test_unknown_backend_and_negative_power():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="unknown FGC backend"):
        fgc.apply_abs_power(x, backend="pallas")
    with pytest.raises(ValueError):
        fgc.apply_abs_power(x, power=-1)
