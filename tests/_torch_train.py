"""Shared inputs, configs and checks of the train-step tests
(tests/test_torch_train_step.py, tests/test_torch_train_gw.py) and of
tests/train_spreads.py; not collected by pytest.

Bars.  The step's scalars (loss, ce, aux, gw_align, grad_norm) and the new
moments m and v, each relative to its largest entry, within the LM parity
tests' logit bars: ``F32`` (1e-5) for every architecture but xLSTM
(``XLSTM_F32``, its sLSTM recurrence turns an ulp into ~1e-5;
tests/test_torch_models.py); the MoE bar there is an atol scaled to the
layer's outputs, which for these scalars and moments is F32.  v, a square
of the gradient, at twice the bar.  The new parameters are held to the
same bar wherever the gradient is not within that bar of zero: AdamW's
first step moves a parameter by lr·g/(|g| + eps), ≈ ±lr whatever |g| is,
so where two f32 gradients a rounding apart straddle zero the two steps
differ by 2·lr (seen: 3.4e-2 of an xLSTM gate's largest entry at lr
1e-3).  The FGW term solves in f32 on both sides (the step casts the
hidden states to f32), where the implicit gradient carries more rounding:
``GW_F32``.  The term itself is also held in f64 (the loss and its
gradient to the step's hidden states) at the alignment losses' rtol 1e-8
(tests/test_torch_losses.py).
"""
import dataclasses
import zlib

import jax
import numpy as np
import torch

from repro import configs as ref_configs
from repro.core import losses as ref_losses
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_optim
from repro_torch import convert
from repro_torch.train import loop, optimizer as optim

F32 = 1e-5
XLSTM_F32 = 1e-4
# the FGW step's f32 gradient: each f32 evaluation (the reference's and
# the port's) sits 1.3e-4–1.4e-3 of a parameter's largest gradient from
# the f64 gradient of the same step (tests/train_spreads.py fgw_f32, five
# draws; the worst draw's worst parameter 1.41e-3 for the reference and
# 1.32e-3 for the port); two such errors add, so 3e-3
GW_F32 = 3e-3
# the term in f64 against the reference's, the alignment losses' bar
# (tests/test_torch_losses.py)
GW_F64_RTOL = 1e-8
CPU = torch.device("cpu")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _batch(cfg, b, s, key, teacher=False):
    rng = _rng(*key)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = ({"tokens": toks, "labels": toks} if cfg.input_mode == "tokens"
           else {"embeddings": (rng.normal(size=(b, s, cfg.d_model)) * 0.1
                                ).astype(np.float32), "labels": toks})
    if teacher:
        out["teacher_h"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
    return out


def _port_tcfg(tcfg):
    """The port's TrainConfig of a reference one."""
    fields = {f.name: getattr(tcfg, f.name)
              for f in dataclasses.fields(tcfg)}
    fields["gw_align"] = convert.align_config(dataclasses.asdict(
        tcfg.gw_align))
    fields["optimizer"] = optim.OptimizerConfig(**dataclasses.asdict(
        tcfg.optimizer))
    return loop.TrainConfig(**fields)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _run(arch, tcfg, batch, seed=0):
    """The reference's step and the port's from one state: (ref new state
    as numpy, ref metrics, port state, port metrics, port config)."""
    cfg = _f32(ref_configs.get_smoke(arch))
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    state = ref_loop.init_state(jax.random.PRNGKey(seed), cfg, tcfg)
    port = convert.train_state(jax.tree.map(np.asarray, state), pcfg, CPU)
    new, metrics = jax.jit(lambda s, b: ref_loop.train_step(
        s, b, cfg, tcfg))(state, batch)
    port_metrics = loop.train_step(port, batch, pcfg, _port_tcfg(tcfg))
    return (jax.tree.map(np.asarray, new), metrics, port, port_metrics,
            pcfg)


def _check_step(new, metrics, port, port_metrics, bar, lr=1e-3):
    assert port_metrics.keys() == metrics.keys()
    for k in metrics:
        d = _rel(port_metrics[k], metrics[k])
        assert d <= bar, (k, float(port_metrics[k]), float(metrics[k]))
    assert port.step == int(new["step"]) == 1
    assert port.opt.step == int(new["opt"]["step"]) == 1
    m = convert.lm_params(new["opt"]["m"], CPU)
    v = convert.lm_params(new["opt"]["v"], CPU)
    want = convert.lm_params(new["params"], CPU)
    got = port.params()
    eps = optim.OptimizerConfig().eps
    for k in want:
        assert _rel(port.opt.m[k], m[k]) <= bar, ("m", k)
        assert _rel(port.opt.v[k], v[k]) <= 2 * bar, ("v", k)
        # one step's m is (1 − b1)·g: where g is neither within the bar
        # of zero nor near eps, the step's lr·g/(|g| + eps) is within
        # lr·bar, and the new parameter within bar·(lr + |p|)
        mk = np.abs(m[k].numpy())
        away = mk > max(bar * mk.max(), 0.1 * 1e3 * eps)
        w = want[k].numpy()[away]
        d = np.abs(got[k].detach().numpy()[away] - w)
        assert (d <= bar * (lr + np.abs(w))).all(), ("params", k)


STEP_TCFG = ref_loop.TrainConfig(
    microbatches=2, remat=False,
    optimizer=ref_optim.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=10))


GW_TCFG = ref_loop.TrainConfig(
    microbatches=1, remat=False, gw_align_weight=0.5,
    gw_align=ref_losses.AlignConfig(theta=0.5, outer_iters=2,
                                    sinkhorn_iters=20),
    optimizer=ref_optim.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=10))


def _port_state(arch, tcfg, seed=0):
    cfg = _f32(ref_configs.get_smoke(arch))
    pcfg = convert.model_config(dataclasses.asdict(cfg))
    state = ref_loop.init_state(jax.random.PRNGKey(seed), cfg, tcfg)
    return convert.train_state(jax.tree.map(np.asarray, state), pcfg,
                               CPU), pcfg
