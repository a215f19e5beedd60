"""The slice as a whole: the port's ``entropic_gw`` against the reference's
on 1D and 2D grids, in fixed and in adaptive-with-annealing mode; the
port's segmented solves; carrying a solve across from the reference."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import convert
from repro_torch import core

FIXED = dict(eps=2e-3, outer_iters=10, sinkhorn_iters=200)
ANNEALED = dict(eps=2e-3, outer_iters=40, sinkhorn_iters=300, tol=1e-6,
                eps_init=5e-2)
# the reference's own FGC-vs-dense bar on the plan (tests/test_gw_solvers.py)
PLAN_TOL = 1e-12


def _measures(n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def _case(kind, n, k):
    h = 1 / (n - 1)
    size = n if kind == "Grid1D" else n * n
    return (getattr(core, kind)(n, h, k), getattr(jcore, kind)(n, h, k),
            _measures(size, 0), _measures(size, 1))


def _assert_same_solve(rt, rj):
    it, ij = rt.info, rj.info
    assert it.outer_iters == int(ij.outer_iters)
    assert it.inner_iters == int(ij.inner_iters)
    assert it.converged == bool(ij.converged)
    assert float(np.linalg.norm(rt.plan.numpy() - np.asarray(rj.plan))) \
        < PLAN_TOL
    assert abs(float(rt.value) - float(rj.value)) < PLAN_TOL
    # potentials are O(C) ≈ O(1): 1e-11 absolute over ≤ 400 steps of f64
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(rt.g.numpy(), np.asarray(rj.g), rtol=0,
                               atol=1e-11)
    np.testing.assert_allclose(float(rt.marginal_err),
                               float(rj.marginal_err), rtol=1e-6,
                               atol=1e-15)
    np.testing.assert_allclose(it.err_trace.numpy(),
                               np.asarray(ij.err_trace), rtol=1e-6,
                               atol=1e-15)


@pytest.mark.parametrize("kind,n,k", [("Grid1D", 50, 1), ("Grid1D", 50, 2),
                                      ("Grid2D", 6, 1)])
@pytest.mark.parametrize("mode", ["fixed", "annealed"])
@pytest.mark.parametrize("backend", ["cumsum", "pallas"])
def test_entropic_gw_matches_reference(kind, n, k, mode, backend):
    tg, jg, mu, nu = _case(kind, n, k)
    jcfg = jcore.GWConfig(backend=backend,
                          **(FIXED if mode == "fixed" else ANNEALED))
    rj = jcore.entropic_gw(jg, jg, jnp.asarray(mu), jnp.asarray(nu), jcfg)
    rt = core.entropic_gw(tg, tg, mu, nu,
                          convert.gw_config(dataclasses.asdict(jcfg)),
                          device="cpu")
    _assert_same_solve(rt, rj)


def test_segmented_is_bitwise_one_shot():
    tg, _, mu, nu = _case("Grid1D", 30, 1)
    cfg = core.GWConfig(**ANNEALED)
    m, n = torch.from_numpy(mu), torch.from_numpy(nu)
    op = core.GradientOperator(tg, tg, cfg.backend)
    c1, _, _ = op.constant_term(m, n)
    ctl = core.SolveControls.from_config(cfg)
    one, info = core.gw_plan_solve(op, c1, m, n, cfg, ctl)
    carry = core.init_carry(core.full_init(m, n), cfg.outer_iters)
    while carry.t < cfg.outer_iters and not carry.done:
        carry = core.gw_plan_segment(op, c1, m, n, cfg, ctl, carry, 3)
    assert carry.t == info.outer_iters and carry.inner == info.inner_iters
    assert torch.equal(carry.state.plan, one.plan)
    assert torch.equal(carry.state.f, one.f)
    torch.testing.assert_close(carry.trace, info.err_trace, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("k_segments", [1, 2])
def test_resume_reference_carry_in_port(k_segments):
    """Run k segments in the reference, carry the state across, finish in
    the port: the result equals the reference's uninterrupted solve."""
    tg, jg, mu, nu = _case("Grid1D", 40, 1)
    jcfg = jcore.GWConfig(**ANNEALED)
    jm, jn = jnp.asarray(mu), jnp.asarray(nu)
    jop = jcore.GradientOperator(jg, jg, jcfg.backend)
    jc1, _, _ = jop.constant_term(jm, jn)
    jctl = jcore.SolveControls.from_config(jcfg)
    whole, jinfo = jcore.gw_plan_solve(jop, jc1, jm, jn, jcfg, jctl)
    carry = jcore.init_carry(jcore.full_init(jm, jn), jcfg.outer_iters)
    for _ in range(k_segments):
        carry = jcore.gw_plan_segment(jop, jc1, jm, jn, jcfg, jctl, carry, 2)
    s = carry.state
    tcarry = convert.mirror_carry(
        np.asarray(s.plan), np.asarray(s.f), np.asarray(s.g), carry.t,
        carry.stage, carry.inner, carry.err, carry.done,
        np.asarray(carry.trace), device="cpu")
    cfg = convert.gw_config(dataclasses.asdict(jcfg))
    ctl = convert.solve_controls(*(float(v) for v in
                                   jax_controls_leaves(jctl)), device="cpu")
    m, n = torch.from_numpy(mu), torch.from_numpy(nu)
    op = core.GradientOperator(tg, tg, cfg.backend)
    c1, _, _ = op.constant_term(m, n)
    tcarry = core.gw_plan_segment(op, c1, m, n, cfg, ctl, tcarry)
    assert tcarry.t == int(jinfo.outer_iters)
    assert tcarry.inner == int(jinfo.inner_iters)
    assert float(np.linalg.norm(tcarry.state.plan.numpy()
                                - np.asarray(whole.plan))) < PLAN_TOL


def jax_controls_leaves(ctl):
    return (ctl.eps, ctl.tol, ctl.eps_init, ctl.anneal_decay,
            ctl.inner_loosen, ctl.lr_gamma)


def test_float32_keeps_dtype_and_agrees():
    """f32 measures stay f32 end to end; the solve agrees with the f64
    reference to f32 accuracy of the plan (1e-4 relative L1)."""
    tg, jg, mu, nu = _case("Grid1D", 40, 1)
    rt = core.entropic_gw(tg, tg, mu.astype(np.float32),
                          nu.astype(np.float32), core.GWConfig(**FIXED),
                          device="cpu")
    rj = jcore.entropic_gw(jg, jg, jnp.asarray(mu), jnp.asarray(nu),
                           jcore.GWConfig(**FIXED))
    assert rt.plan.dtype == rt.f.dtype == rt.value.dtype == torch.float32
    l1 = np.abs(rt.plan.numpy().astype(np.float64)
                - np.asarray(rj.plan)).sum()
    assert l1 < 1e-4


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tg, _, mu, nu = _case("Grid1D", 10, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        core.entropic_gw(tg, tg, mu, nu)


def test_unported_surfaces_raise():
    """The factored plan is ported (tests/test_torch_lowrank.py): what it
    refuses is a dense-plan warm start, and its kernels on the CPU."""
    tg, _, mu, nu = _case("Grid1D", 10, 1)
    with pytest.raises(ValueError, match="gamma0"):
        core.entropic_gw(tg, tg, mu, nu, core.GWConfig(plan="lowrank"),
                         gamma0=np.outer(mu, nu), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        core.entropic_gw(tg, tg, mu, nu,
                         core.GWConfig(plan="lowrank",
                                       lowrank_backend="kernel"),
                         device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        core.entropic_gw(tg, tg, mu, nu,
                         core.GWConfig(sinkhorn_backend="kernel"),
                         device="cpu")


def test_convert_maps_reference_names():
    jcfg = jcore.GWConfig(backend="pallas", sinkhorn_backend="xla",
                          plan_rank=8)
    cfg = convert.gw_config(dataclasses.asdict(jcfg))
    assert cfg.backend == "kernel" and cfg.sinkhorn_backend == "torch"
    g = convert.grid2d(6, 0.2, 1)
    assert g == core.Grid2D(6, 0.2, 1)
    coup = convert.full_coupling(np.eye(3), np.zeros(3), np.zeros(3),
                                 device="cpu")
    assert coup.plan.dtype == torch.float64
