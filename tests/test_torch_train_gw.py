"""The train step's FGW distillation term against the reference's
(tests/test_gw_distill.py), and the port's own microbatch, remat, gather
and overfitting cases (tests/test_models.py:80-126), on the CPU at smoke
widths.  Inputs, configs and bars: tests/_torch_train.py.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from _torch_train import (CPU, F32, GW_F32, GW_F64_RTOL, GW_TCFG, STEP_TCFG,
                          _batch, _check_step, _f32, _port_state, _port_tcfg,
                          _rel, _run)
from repro import configs as ref_configs
from repro.core import losses as ref_losses
from repro.models import lm as ref_lm
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_optim
from repro_torch import configs, convert
from repro_torch.models import lm
from repro_torch.train import loop, optimizer as optim


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_with_gw_alignment_matches_reference(remat):
    """tests/test_gw_distill.py:15: musicgen's smoke config with the FGW
    distillation term (θ = 0.5, 2 outer × 20 Sinkhorn steps): the term's
    value and its gradient (in m) against the reference's; the term moves
    the parameters."""
    tcfg = dataclasses.replace(GW_TCFG, remat=remat)
    cfg = ref_configs.get_smoke("musicgen-medium")
    batch = _batch(cfg, 2, 16, ("gw",), teacher=True)
    new, metrics, port, port_metrics, pcfg = _run("musicgen-medium", tcfg,
                                                  batch)
    assert "gw_align" in port_metrics
    assert np.isfinite(float(port_metrics["gw_align"]))
    _check_step(new, metrics, port, port_metrics, GW_F32)
    # without the term (and the same state) the parameters differ
    tcfg0 = dataclasses.replace(tcfg, gw_align_weight=0.0)
    _, _, port0, m0, _ = _run("musicgen-medium", tcfg0, batch)
    assert "gw_align" not in m0
    with torch.no_grad():
        d = optim.global_norm({k: a - b for (k, a), b in zip(
            port.params().items(), port0.params().values())})
    assert float(d) > 0


def test_train_step_gw_alignment_loss_decreases():
    """tests/test_gw_distill.py:38's two steps on one batch: the loss and
    the FGW term fall.  Its ``plan="lowrank"`` is carried and, like the
    reference's ``_fgw_config``, not forwarded: both solve on the full
    plan (ROADMAP §C).  Each step's scalars against the reference's."""
    tcfg = dataclasses.replace(GW_TCFG, gw_align=ref_losses.AlignConfig(
        theta=0.5, outer_iters=2, sinkhorn_iters=15, plan="lowrank",
        plan_rank=4, lowrank_backend="pallas"))
    ref_cfg = _f32(ref_configs.get_smoke("musicgen-medium"))
    batch = _batch(ref_cfg, 2, 12, ("gw2",), teacher=True)
    state = ref_loop.init_state(jax.random.PRNGKey(0), ref_cfg, tcfg)
    pcfg = convert.model_config(dataclasses.asdict(ref_cfg))
    port = convert.train_state(jax.tree.map(np.asarray, state), pcfg, CPU)
    step = jax.jit(lambda s, b: ref_loop.train_step(s, b, ref_cfg, tcfg))
    ptcfg = _port_tcfg(tcfg)
    got = []
    for _ in range(2):
        state, want = step(state, batch)
        m = loop.train_step(port, batch, pcfg, ptcfg)
        for k in ("loss", "gw_align", "grad_norm"):
            assert _rel(m[k], want[k]) <= GW_F32, k
        got.append(m)
    assert float(got[1]["loss"]) < float(got[0]["loss"])
    assert float(got[1]["gw_align"]) < float(got[0]["gw_align"])


def test_gw_alignment_term_in_f64_matches_reference():
    """The term the step adds, in f64: the FGW loss between the student's
    hidden states (the port's forward of the step's state) and the
    teacher's, and its gradient to the student's, against the
    reference's at rtol 1e-8."""
    cfg = _f32(ref_configs.get_smoke("musicgen-medium"))
    batch = _batch(cfg, 2, 16, ("gw",), teacher=True)
    state, pcfg = _port_state("musicgen-medium", GW_TCFG)
    with torch.no_grad():
        _, _, hidden = lm.forward(state.model, loop.to_device(batch, CPU),
                                  pcfg, return_hidden=True)
    h = hidden.double().numpy()
    t = batch["teacher_h"].astype(np.float64)
    acfg = GW_TCFG.gw_align
    want, want_grad = jax.jit(jax.value_and_grad(
        lambda x: ref_losses.fgw_alignment_loss_batch(x, t, acfg)))(h)
    x = torch.tensor(h, requires_grad=True)
    got = loop.gw_losses.fgw_alignment_loss_batch(
        x, torch.tensor(t), _port_tcfg(GW_TCFG).gw_align, device=CPU)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=GW_F64_RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=GW_F64_RTOL, atol=1e-13)


def test_microbatch_equivalence():
    """tests/test_models.py:99: 1 against 2 microbatches, the updates
    within 2e-5 of the parameters' norm."""
    cfg = configs.get_smoke("olmo-1b")
    batch = _batch(cfg, 4, 16, ("mb",))
    outs = []
    for nmb in (1, 2):
        tcfg = dataclasses.replace(STEP_TCFG, microbatches=nmb)
        state, pcfg = _port_state("olmo-1b", tcfg)
        loop.train_step(state, batch, pcfg, _port_tcfg(tcfg))
        outs.append(state.params())
    with torch.no_grad():
        diff = optim.global_norm({k: outs[0][k] - outs[1][k]
                                  for k in outs[0]})
        assert float(diff / optim.global_norm(outs[0])) < 2e-5


def _grads(model, batch, cfg, **kw):
    model.zero_grad(set_to_none=True)
    loss, _ = lm.loss_fn(model, loop.to_device(batch, CPU), cfg, **kw)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in
                           model.named_parameters()}


def test_remat_gradients_equal_bits():
    """tests/test_models.py:117: remat recomputes the same f32 arithmetic
    on the CPU, so the loss and every gradient are the same bits."""
    state, cfg = _port_state("phi3-mini-3.8b", STEP_TCFG)
    batch = _batch(configs.get_smoke("phi3-mini-3.8b"), 2, 16, ("remat",))
    l1, g1 = _grads(state.model, batch, cfg, remat=False)
    l2, g2 = _grads(state.model, batch, cfg, remat=True)
    assert torch.equal(l1, l2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k


@functools.lru_cache(maxsize=None)
def _olmo_gather():
    cfg = _f32(ref_configs.get_smoke("olmo-1b"))
    params = ref_lm.init_params(jax.random.PRNGKey(0), cfg)
    batch = {"tokens": np.arange(32, dtype=np.int32).reshape(2, 16) % 250,
             "labels": np.ones((2, 16), np.int32)}
    want = {g: float(jax.jit(lambda p, b, g=g: ref_lm.loss_fn(
        p, b, cfg, gather_params=g)[0])(params, batch)) for g in (False,
                                                                  True)}
    model = convert.lm_model(jax.tree.map(np.asarray, params),
                             convert.model_config(dataclasses.asdict(cfg)),
                             CPU)
    return cfg, model, batch, want


def test_gather_params_within_bf16_of_no_gather():
    """tests/test_gw_distill.py:77: the gather casts the slots' parameters
    to bf16, so the loss moves by less than 5e-2."""
    cfg, model, batch, _ = _olmo_gather()
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    b = loop.to_device(batch, CPU)
    with torch.no_grad():
        l1, _ = lm.loss_fn(model, b, pcfg, gather_params=False)
        l2, _ = lm.loss_fn(model, b, pcfg, gather_params=True)
    assert abs(float(l1 - l2)) < 5e-2
    assert float(l1) != float(l2)


def test_gather_params_matches_reference_gathered_loss():
    """Both round the same f32 parameters to bf16 (to nearest, ties to
    even), so the gathered losses agree at F32, far inside 5e-2; the
    gradient flows through the cast."""
    cfg, model, batch, want = _olmo_gather()
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    b = loop.to_device(batch, CPU)
    for g in (False, True):
        loss, _ = lm.loss_fn(model, b, pcfg, gather_params=g)
        np.testing.assert_allclose(float(loss.detach()), want[g], rtol=F32)
    model.zero_grad(set_to_none=True)
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_loss_decreases_on_tiny_model():
    """tests/test_models.py:80: 25 steps overfitting one batch take ce
    below 0.8 of its first value."""
    tcfg = ref_loop.TrainConfig(
        microbatches=1, remat=False,
        optimizer=ref_optim.OptimizerConfig(lr=5e-3, warmup_steps=2,
                                            total_steps=40))
    state, cfg = _port_state("smollm-360m", tcfg)
    batch = _batch(configs.get_smoke("smollm-360m"), 4, 32, ("overfit",))
    ptcfg = _port_tcfg(tcfg)
    ces = [float(loop.train_step(state, batch, cfg, ptcfg)["ce"])
           for _ in range(25)]
    assert ces[-1] < 0.8 * ces[0], ces


def test_train_step_rejects_a_ragged_microbatch_split():
    state, cfg = _port_state("olmo-1b", STEP_TCFG)
    with pytest.raises(ValueError):
        loop.train_step(state, _batch(cfg, 3, 8, ("odd",)), cfg,
                        _port_tcfg(STEP_TCFG))
