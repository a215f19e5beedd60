"""The port's Sinkhorn solvers and mirror-descent loop: schedules and
solves against the reference, and the port's own exact invariances."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sinkhorn as jsk
from repro.core.solver import SolveControls as JControls
from repro_torch.core import sinkhorn as sk
from repro_torch.core.solver import SolveControls

RNG = np.random.default_rng(9)


def _problem(m, n, seed=0):
    r = np.random.default_rng(seed)
    cost = r.random((m, n))
    mu = r.random(m) + 0.1
    nu = r.random(n) + 0.1
    return cost, mu / mu.sum(), nu / nu.sum()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("knobs", [
    dict(eps=2e-3), dict(eps=4e-3, tol=1e-6, eps_init=5e-2),
    dict(eps=1e-2, tol=1e-5, eps_init=0.3, anneal_decay=0.7,
         inner_loosen=0.5)])
def test_controls_schedules_match_reference(knobs):
    """ε_t, anneal_done and the inner tolerance: f64 scalar arithmetic, the
    reference's own expressions (pow may differ by an ulp: rtol 1e-15)."""
    tc = SolveControls.make(**knobs)
    jc = JControls.make(**knobs)
    for t in range(12):
        jt = jnp.asarray(t, jnp.int32)
        np.testing.assert_allclose(float(tc.eps_at(t)),
                                   float(jc.eps_at(jt)), rtol=1e-15)
        np.testing.assert_allclose(float(tc.inner_tol_at(t)),
                                   float(jc.inner_tol_at(jt)), rtol=1e-15)
        assert bool(tc.anneal_done(t)) == bool(jc.anneal_done(jt))


@pytest.mark.parametrize("mode", ["log", "kernel"])
@pytest.mark.parametrize("tol", [0.0, 1e-9])
def test_solve_adaptive_matches_reference(mode, tol):
    cost, mu, nu = _problem(30, 41)
    eps = 0.05 if mode == "kernel" else 0.01
    f0 = RNG.normal(size=30) * 0.01
    g0 = RNG.normal(size=41) * 0.01
    want = jsk.solve_adaptive(jnp.asarray(cost), jnp.asarray(mu),
                              jnp.asarray(nu), eps, 300, 25, tol, mode,
                              jnp.asarray(f0), jnp.asarray(g0))
    got = sk.solve_adaptive(*_t(cost, mu, nu), eps, 300, 25, tol, mode,
                            *_t(f0, g0))
    assert got[4] == int(want[4])
    for a, b in zip(got[:3], want[:3]):
        # f64; potentials ε·log of O(1) scalings: 1e-12 absolute
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_chunked_tol0_is_bitwise_the_fixed_loop():
    cost, mu, nu = _problem(25, 33, seed=1)
    c, m, n = _t(cost, mu, nu)
    plan, f, g, _ = sk.sinkhorn_log(c, m, n, 0.01, 137)
    plan2, f2, g2, _, used = sk.sinkhorn_log_chunked(c, m, n, 0.01, 137, 25,
                                                     0.0)
    assert used == 137
    assert torch.equal(plan, plan2) and torch.equal(f, f2) and \
        torch.equal(g, g2)
    ka, kb = sk.sinkhorn_kernel(c, m, n, 0.05, 60)[1], \
        sk.sinkhorn_kernel_chunked(c, m, n, 0.05, 60, 25, 0.0)[1]
    assert torch.equal(ka, kb)


def test_zero_mass_potentials_and_safe_logsumexp():
    mu = torch.tensor([0.5, 0.0, 0.5], dtype=torch.float64)
    f, g = sk.zero_mass_potentials(mu, mu)
    assert torch.equal(torch.isneginf(f), mu == 0)
    z = torch.tensor([[-np.inf, -np.inf], [0.0, 1.0]], dtype=torch.float64)
    want = jsk.safe_logsumexp(jnp.asarray(z.numpy()), axis=1)
    np.testing.assert_allclose(sk.safe_logsumexp(z, 1).numpy(),
                               np.asarray(want), rtol=1e-15)
    np.testing.assert_array_equal(sk._safe_log(mu).numpy(),
                                  np.asarray(jsk._safe_log(jnp.asarray(
                                      mu.numpy()))))


def test_solve_kernel_mode_warm_start_matches_reference():
    cost, mu, nu = _problem(20, 24, seed=2)
    f0 = RNG.normal(size=20) * 0.01
    cfg = sk.SinkhornConfig(eps=0.05, iters=40, mode="kernel")
    jcfg = jsk.SinkhornConfig(**dataclasses.asdict(cfg) | {"backend": "xla"})
    got = sk.solve(*_t(cost, mu, nu), cfg, f0=torch.from_numpy(f0))
    want = jsk.solve(jnp.asarray(cost), jnp.asarray(mu), jnp.asarray(nu),
                     jcfg, f0=jnp.asarray(f0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
