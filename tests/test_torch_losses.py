"""The FGW alignment losses: the port's ``core.losses`` against the
reference's (tests/test_losses_serve.py:21-66), values and gradients to the
hidden states, in both gradient modes.  Inputs are made with numpy from a
seed and handed to both packages; the port runs on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, core
from repro_torch.core import losses

RNG_SEED = 21
# the port's f64 losses against the reference's: one arithmetic, the same
# iteration counts (observed spread ≤ 1e-13 relative)
RTOL = 1e-8


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64,
                        requires_grad=grad)


def _configs(**kw):
    jcfg = jlosses.AlignConfig(**kw)
    cfg = convert.align_config(dataclasses.asdict(jcfg))
    assert isinstance(cfg, core.AlignConfig)
    return cfg, jcfg


def test_alignment_identical_sequences_near_diagonal():
    """Aligning a sequence with itself puts the plan's mass on the
    diagonal (> 90 % of the rows' argmax), as the reference's."""
    h = _normal(RNG_SEED, (20, 8))
    cfg = core.FGWConfig(theta=0.5, eps=5e-3, outer_iters=8,
                         sinkhorn_iters=200)
    g = core.Grid1D(20, 1 / 19, 1)
    c = losses._feature_cost(_t(h), _t(h))
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jlosses._feature_cost(jnp.asarray(h),
                                                    jnp.asarray(h))),
        rtol=1e-12, atol=1e-12)
    res = core.entropic_fgw(g, g, c, np.full(20, 1 / 20), np.full(20, 1 / 20),
                            cfg, device="cpu")
    plan = res.plan.numpy()
    assert (np.argmax(plan, axis=1) == np.arange(20)).mean() > 0.9


@pytest.mark.parametrize("grad_mode", ["implicit", "envelope"])
def test_alignment_loss_value_and_grad_match_reference(grad_mode):
    h1, h2 = _normal(22, (16, 8)), _normal(23, (20, 8))
    cfg, jcfg = _configs(outer_iters=3, sinkhorn_iters=30,
                         grad_mode=grad_mode)
    val, grad = jax.jit(jax.value_and_grad(
        lambda h: jlosses.fgw_alignment_loss(h, jnp.asarray(h2), jcfg)))(
        jnp.asarray(h1))
    h = _t(h1, True)
    loss = losses.fgw_alignment_loss(h, _t(h2), cfg, device="cpu")
    (g,) = torch.autograd.grad(loss, h)
    assert np.isfinite(g.numpy()).all() and float(g.norm()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=RTOL,
                               atol=1e-13)


def test_alignment_cross_dim_pure_gw():
    """θ = 1 (pure GW) aligns sequences of different feature dims."""
    h1, h2 = _normal(24, (12, 8)), _normal(25, (15, 32))
    cfg, jcfg = _configs(theta=1.0, outer_iters=3, sinkhorn_iters=30)
    val = losses.fgw_alignment_loss(_t(h1), _t(h2), cfg, device="cpu")
    assert np.isfinite(float(val))
    want = jax.jit(lambda a, b: jlosses.fgw_alignment_loss(a, b, jcfg))(
        jnp.asarray(h1), jnp.asarray(h2))
    np.testing.assert_allclose(float(val), float(want), rtol=RTOL)


def test_patch_alignment_2d_value_and_grad_match_reference():
    h1, h2 = _normal(26, (16, 8)), _normal(27, (16, 8))   # 4×4 patch grids
    cfg, jcfg = _configs(outer_iters=3, sinkhorn_iters=30)
    val, grad = jax.jit(jax.value_and_grad(
        lambda h: jlosses.fgw_patch_alignment_loss(h, jnp.asarray(h2), 4,
                                                   jcfg)))(jnp.asarray(h1))
    h = _t(h1, True)
    loss = losses.fgw_patch_alignment_loss(h, _t(h2), 4, cfg, device="cpu")
    (g,) = torch.autograd.grad(loss, h)
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad), rtol=RTOL,
                               atol=1e-13)
    with pytest.raises(ValueError, match="4²"):
        losses.fgw_patch_alignment_loss(h[:15], _t(h2), 4, cfg,
                                        device="cpu")


def test_batch_loss_value_and_grads_match_reference():
    """The trainer's loss: one batched solve over ragged pairs, its value
    and the gradient to every lane's student states against the
    reference's."""
    srcs = [_normal(30 + b, (s, 8)) for b, s in enumerate((12, 9, 14))]
    tgts = [_normal(40 + b, (t, 8)) for b, t in enumerate((16, 13, 10))]
    cfg, jcfg = _configs(outer_iters=3, sinkhorn_iters=30)
    val, grads = jax.jit(jax.value_and_grad(
        lambda hs: jlosses.fgw_alignment_loss_batch(
            hs, [jnp.asarray(t) for t in tgts], jcfg)))(
        [jnp.asarray(s) for s in srcs])
    hs = [_t(s, True) for s in srcs]
    loss = losses.fgw_alignment_loss_batch(hs, [_t(t) for t in tgts], cfg,
                                           device="cpu")
    got = torch.autograd.grad(loss, hs)
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=RTOL)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-13)
