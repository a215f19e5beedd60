"""Reverse mode: the port's implicit gradients (``core.solver.
fixed_point_value``) against the reference's ``jax.grad``, and against the
reference's own bars (tests/test_implicit_grad.py): central finite
differences, unrolled autograd, exact-zero cotangents on zero-mass atoms,
ragged batch lanes equal to their solo solves, and no (M, N) tensor in a
factored backward.  Also the one-step maps and the safe logsumexp they
use, against ``jax.vjp``.  Inputs are made with numpy from a seed and
handed to both packages; the port runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro import core as jcore
from repro.core import sinkhorn as jsk
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, core
from repro_torch.core import sinkhorn as sk

# the reference's problem (tests/test_implicit_grad.py:45-56)
M, N = 13, 17
_r = np.random.default_rng(5)
_u = _r.random(M) + 0.05
MU = _u / _u.sum()
_v = _r.random(N) + 0.05
NU = _v / _v.sum()
H0 = 1.0 / (M - 1)
HY = 1.0 / (N - 1)
EPS = 5e-2
# the port's gradient against jax.grad's: both run the same f64 arithmetic
# (the observed spread is ≤ 1e-14 relative)
GRAD_RTOL = 1e-8


def _configs(plan, grad_mode="implicit"):
    kw = dict(eps=EPS, tol=1e-10, outer_iters=60, sinkhorn_iters=400,
              sinkhorn_chunk=25, grad_mode=grad_mode)
    if plan == "lowrank":
        kw.update(plan="lowrank", plan_rank=6, lr_gamma=5.0,
                  lowrank_backend="xla")
    else:
        kw.update(sinkhorn_backend="xla")
    jcfg = jcore.GWConfig(**kw)
    return convert.gw_config(dataclasses.asdict(jcfg)), jcfg


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _port_value(h, cfg, mu=MU, nu=NU, controls=None):
    return core.entropic_gw(core.Grid1D(M, h, 1), core.Grid1D(N, HY, 1), mu,
                            nu, cfg, controls=controls, device="cpu")


def _reference_grads(plan, grad_mode):
    """jax.grad of the reference's value in (h, μ, ν, controls.eps)."""
    _, jcfg = _configs(plan, grad_mode)

    def value(h, mu, nu, ctl):
        return jcore.entropic_gw(jcore.Grid1D(M, h, 1),
                                 jcore.Grid1D(N, HY, 1), mu, nu, jcfg,
                                 controls=ctl).value

    gh, gmu, gnu, gctl = jax.jit(jax.grad(value, argnums=(0, 1, 2, 3)))(
        H0, jnp.asarray(MU), jnp.asarray(NU),
        jcore.SolveControls.from_config(jcfg))
    return (float(gh), np.asarray(gmu), np.asarray(gnu), float(gctl.eps))


@pytest.mark.parametrize("grad_mode", ["implicit", "envelope"])
@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_grad_matches_reference(plan, grad_mode):
    cfg, _ = _configs(plan, grad_mode)
    h, mu, nu = _t(H0, True), _t(MU, True), _t(NU, True)
    eps = _t(EPS, True)
    ctl = dataclasses.replace(core.SolveControls.from_config(cfg), eps=eps)
    res = _port_value(h, cfg, mu, nu, ctl)
    assert res.info.converged
    got = torch.autograd.grad(res.value, (h, mu, nu, eps))
    want = _reference_grads(plan, grad_mode)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=1e-14)
    assert float(got[0]) != 0.0


@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_grad_matches_finite_differences(plan):
    """At a converged solve the gradient in h matches central finite
    differences at the reference's bar (f64, rtol 1e-6)."""
    cfg, _ = _configs(plan)
    h = _t(H0, True)
    res = _port_value(h, cfg)
    assert res.info.converged
    (g,) = torch.autograd.grad(res.value, h)
    d = 1e-5
    fd = (float(_port_value(H0 + d, cfg).value)
          - float(_port_value(H0 - d, cfg).value)) / (2 * d)
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)


def test_grad_matches_unrolled_autograd():
    """Autograd through 40 outer steps of 200 dual-update pairs each (every
    iterate kept) agrees with the implicit gradient, which keeps none
    (the reference's bar, rtol 1e-7)."""
    mu, nu = _t(MU), _t(NU)

    def unrolled(h):
        op = core.GradientOperator(core.Grid1D(M, h, 1),
                                   core.Grid1D(N, HY, 1), "cumsum")
        c1, dx2mu, dy2nu = op.constant_term(mu, nu)
        plan = mu[:, None] * nu[None, :]
        f, g = torch.zeros_like(mu)[None], torch.zeros_like(nu)[None]
        for _ in range(40):
            cost = op.grad(plan, c1)
            f, g = sk.sinkhorn_step_diff(cost[None], mu[None], nu[None], EPS,
                                         f, g, pairs=200)
            plan = torch.exp((f[0][:, None] + g[0][None, :] - cost) / EPS)
        return op.energy(plan, dx2mu, dy2nu)

    h = _t(H0, True)
    (gu,) = torch.autograd.grad(unrolled(h), h)
    h = _t(H0, True)
    (gi,) = torch.autograd.grad(_port_value(h, _configs("full")[0]).value,
                                h)
    np.testing.assert_allclose(float(gi), float(gu), rtol=1e-7)


def test_zero_mass_padding_gets_exact_zero_cotangent():
    """Zero-mass (padded) atoms give EXACTLY zero gradient, not merely a
    small one: a batch sums lane gradients, so a leak would reach live
    lanes."""
    pad = 4
    mu_pad = np.concatenate([MU, np.zeros(pad)])
    feat = _t(np.random.default_rng(6).random((M + pad, N)), True)
    cfg = core.FGWConfig(eps=EPS, tol=1e-8, outer_iters=40,
                         sinkhorn_iters=400, sinkhorn_chunk=25, theta=0.5)
    value = core.entropic_fgw(core.Grid1D(M + pad, H0, 1),
                              core.Grid1D(N, HY, 1), feat, mu_pad, NU, cfg,
                              device="cpu").value
    (g,) = torch.autograd.grad(value, feat)
    assert float(g[M:].abs().max()) == 0.0
    assert float(g[:M].abs().max()) > 0.0


def test_ragged_batch_grads_match_solo():
    """Each lane of a padded ragged batch gets its solo solve's gradient
    (the batch loss is the 2-lane mean); the Neumann series stops per
    lane, as the reference's vmapped loop masks it."""
    r = np.random.default_rng(9)
    d = 8
    hs = [_t(r.normal(size=(12, d)), True), _t(r.normal(size=(9, d)), True)]
    ht = [_t(r.normal(size=(16, d))), _t(r.normal(size=(13, d)))]
    cfg = core.AlignConfig(theta=0.5, eps=EPS, outer_iters=4,
                           sinkhorn_iters=60)
    g0, g1 = torch.autograd.grad(
        core.fgw_alignment_loss_batch(hs, ht, cfg, device="cpu"), hs)
    for g, h_s, h_t in zip((g0, g1), hs, ht):
        (solo,) = torch.autograd.grad(
            core.fgw_alignment_loss(h_s, h_t, cfg, device="cpu"), h_s)
        np.testing.assert_allclose(g.numpy(), solo.numpy() / 2, rtol=0,
                                   atol=1e-12)


class _OutputShapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
        return out


def test_lowrank_value_and_grad_build_no_dense_tensor():
    """No tensor that holds both M and N in its shape, in the factored
    solve or its backward: reverse mode stays O((M+N)·r)."""
    cfg, _ = _configs("lowrank")
    h = _t(H0, True)
    with _OutputShapes() as rec:
        torch.autograd.grad(_port_value(h, cfg).value, h)
    assert (1, M, 6) in rec.shapes      # the recorder saw the factors
    assert [s for s in rec.shapes if M in s and N in s] == []


def test_plan_cotangent_matches_reference():
    """A loss that reads the returned plan (besides the value) gets the
    reference's gradient: the state's cotangent enters the fixed point
    (one code path for either plan's state; the dense plan's reference
    compiles in a third of the factored one's time)."""
    cfg, jcfg = _configs("full")
    w = np.random.default_rng(7).random((M, N))

    def jloss(h, mu):
        res = jcore.entropic_gw(jcore.Grid1D(M, h, 1),
                                jcore.Grid1D(N, HY, 1), mu, jnp.asarray(NU),
                                jcfg)
        return res.value + 3.0 * (res.plan * w).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(H0, jnp.asarray(MU))
    h, mu = _t(H0, True), _t(MU, True)
    res = _port_value(h, cfg, mu)
    got = torch.autograd.grad(res.value + 3.0 * (res.plan * _t(w)).sum(),
                              (h, mu))
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt),
                                   rtol=GRAD_RTOL, atol=1e-14)


@pytest.mark.parametrize("plan", ["full", "lowrank"])
def test_forward_bits_do_not_depend_on_requires_grad(plan):
    """The solve behind the autograd Function is the plain solve: value,
    plan and counts bit-equal with and without inputs that require
    grad."""
    cfg, _ = _configs(plan)
    free = _port_value(_t(H0), cfg, _t(MU))
    tracked = _port_value(_t(H0, True), cfg, _t(MU, True))
    assert tracked.value.requires_grad and not free.value.requires_grad
    assert torch.equal(free.value, tracked.value.detach())
    for a, b in zip(core.solver.fields_of(free.coupling),
                    core.solver.fields_of(tracked.coupling)):
        assert torch.equal(a, b.detach())
    fi, ti = free.info, tracked.info
    assert (fi.outer_iters, fi.inner_iters, fi.converged) == \
        (ti.outer_iters, ti.inner_iters, ti.converged)
    np.testing.assert_array_equal(fi.err_trace.numpy(),
                                  ti.err_trace.numpy())
    assert not ti.err_trace.requires_grad


@pytest.mark.parametrize("case", ["kernel_fgc", "segmented", "auto_rank"])
def test_what_cannot_be_differentiated_says_so(case):
    """The FGC kernel backend (the reference's Pallas scan has no
    transpose), segmented solves and rank restarts raise a clear error
    when an input requires grad."""
    h = _t(H0, True)
    grids = (core.Grid1D(M, h, 1), core.Grid1D(N, HY, 1))
    if case == "kernel_fgc":
        with pytest.raises(NotImplementedError, match="FGC kernel"):
            core.entropic_gw(*grids, MU, NU, core.GWConfig(
                backend="kernel", outer_iters=2), device="cpu")
    elif case == "segmented":
        with pytest.raises(ValueError, match="not differentiable"):
            core.entropic_gw_batch([grids + (MU, NU)],
                                   core.GWConfig(outer_iters=2),
                                   max_outer_segment=1, device="cpu")
    else:
        with pytest.raises(ValueError, match="not differentiable"):
            core.entropic_gw(*grids, MU, NU, core.GWConfig(
                plan="lowrank", plan_rank="auto", outer_iters=2),
                device="cpu")


# ---------------------------------------------------------------------------
# the one-step maps and the safe logsumexp, against jax.vjp
# ---------------------------------------------------------------------------

def test_plan_delta_matches_reference():
    rng = np.random.default_rng(14)
    new, old = rng.random((2, M, N)), rng.random((2, M, N))
    want = float(jcore.solver.plan_delta((jnp.asarray(new[0]),),
                                         (jnp.asarray(old[0]),)))
    got = core.plan_delta((_t(new),), (_t(old),))
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-14)
    np.testing.assert_allclose(float(core.plan_delta((_t(new[1]),),
                                                     (_t(old[1]),))),
                               float(got[1]), rtol=1e-14)


def _assert_close(got, want, rtol=1e-12):
    got = got.detach().numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-14)


def test_safe_logsumexp_value_and_vjp_match_reference():
    """The max shift is detached as the reference's stop_gradient: values
    are the masked max-shifted LSE's, bit for bit, and the VJP is the
    reference's, exact zero on an all-(−inf) slice."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=(5, 7))
    z[1, :3] = -np.inf
    z[3] = -np.inf
    ct = rng.normal(size=5)
    zt = _t(z, True)
    out = sk.safe_logsumexp(zt, 1)
    m = torch.amax(zt, 1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(zt > -torch.inf, torch.exp(
        torch.where(zt > -torch.inf, zt, torch.zeros_like(zt)) - m), 0.0)
    s = e.sum(1)
    plain = torch.where(s > 0, torch.log(torch.where(s > 0, s, 1.0))
                        + m[:, 0], -torch.inf)
    assert torch.equal(out, plain)
    (g,) = torch.autograd.grad(out, zt, _t(ct))
    want_out, vjp = jax.vjp(lambda a: jsk.safe_logsumexp(a, axis=1),
                            jnp.asarray(z))
    np.testing.assert_array_equal(np.isinf(out.detach().numpy()),
                                  np.isinf(np.asarray(want_out)))
    _assert_close(g, vjp(jnp.asarray(ct))[0])
    assert float(g[3].abs().max()) == 0.0


def _zero_mass(n, dead, seed):
    w = np.random.default_rng(seed).random(n) + 0.1
    w[dead:] = 0.0
    return w / w.sum()


def test_sinkhorn_step_diff_matches_reference():
    """Values and VJPs of two differentiable dual-update pairs, with
    zero-mass atoms on both sides: −inf potentials there, no NaN."""
    rng = np.random.default_rng(12)
    m, n = 9, 11
    cost = rng.random((m, n))
    mu, nu = _zero_mass(m, 7, 1), _zero_mass(n, 8, 2)
    f = np.where(mu > 0, rng.normal(size=m) * 0.1, -np.inf)
    g = np.where(nu > 0, rng.normal(size=n) * 0.1, -np.inf)
    cts = (np.where(mu > 0, rng.normal(size=m), 0.0),
           np.where(nu > 0, rng.normal(size=n), 0.0))
    args = (cost, mu, nu, f, g)
    want, vjp = jax.vjp(lambda c, a, b, f0, g0: jsk.sinkhorn_step_diff(
        c, a, b, 0.1, f0, g0, 2), *map(jnp.asarray, args))
    ts = [_t(a, True) for a in args]
    got = sk.sinkhorn_step_diff(*(t[None] for t in ts[:3]), 0.1,
                                *(t[None] for t in ts[3:]), 2)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x[0].detach().numpy(), np.asarray(w),
                                   rtol=1e-12)
    # f is not read: the first pair starts from g
    grads = torch.autograd.grad([x[0] for x in got], ts,
                                [_t(c) for c in cts], allow_unused=True,
                                materialize_grads=True)
    for gt, gw in zip(grads, vjp(tuple(map(jnp.asarray, cts)))):
        _assert_close(gt, gw)


def test_lr_mirror_step_diff_matches_reference():
    """Values and VJPs of the differentiable factored step (prox kernels,
    5 Dykstra sweeps on the safe LSE), with zero-mass rows: their factor
    rows stay exact zeros, no NaN."""
    rng = np.random.default_rng(13)
    m, n, rank = 10, 12, 4
    mu, nu = _zero_mass(m, 8, 3), _zero_mass(n, 9, 4)
    coup = jcore.lowrank_init(jnp.asarray(mu), jnp.asarray(nu), rank)
    grads = [rng.normal(size=s) for s in ((m, rank), (n, rank), (rank,))]
    args = (np.asarray(coup.q), np.asarray(coup.r), np.asarray(coup.g),
            *grads)
    cts = [rng.normal(size=s) for s in ((m, rank), (n, rank), (rank,))]

    def jstep(*a):
        return jsk.lr_mirror_step_diff(*a, jnp.asarray(mu), jnp.asarray(nu),
                                       0.05, 5.0, 5, 1e-10)

    want, vjp = jax.vjp(jax.jit(jstep), *map(jnp.asarray, args))
    ts = [_t(a, True) for a in args]
    got = sk.lr_mirror_step_diff(*(t[None] for t in ts), _t(mu)[None],
                                 _t(nu)[None], 0.05, 5.0, 5, 1e-10)
    for x, w in zip(got, want):
        np.testing.assert_allclose(x[0].detach().numpy(), np.asarray(w),
                                   rtol=1e-11, atol=1e-15)
    assert float(got[0][0, 8:].detach().abs().max()) == 0.0
    grads_t = torch.autograd.grad([x[0] for x in got], ts,
                                  [_t(c) for c in cts])
    for gt, gw in zip(grads_t, vjp(tuple(map(jnp.asarray, cts)))):
        _assert_close(gt, gw, rtol=1e-10)
