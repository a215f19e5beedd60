"""The train step: microbatched gradient accumulation, remat, mixed
precision, the optional FGW alignment (distillation) term, metrics.

Reference: ``repro/train/loop.py``.  A `TrainState` holds the model (its
parameters), the AdamW state and the step count; `train_step` updates it
in place, where the reference's jitted step takes its state donated and
returns a new one.  The microbatches run in the reference's order: each
one's gradient, divided by the microbatch count, is added into f32
buffers, its loss into an f32 total, and the step's metrics other than
``loss``, ``grad_norm`` and ``lr`` are the last microbatch's.

With ``gw_align_weight > 0`` and ``teacher_h`` in the batch, the loss gains
``gw_align_weight ×`` the mean FGW alignment loss between the student's
final hidden states (from a second forward, as the reference runs it) and
the teacher's, both in f32, through
`repro_torch.core.losses.fgw_alignment_loss_batch`: one batched solve on
the Sinkhorn half-step kernels (B1/B2) when ``gw_align.sinkhorn_backend``
is "auto" on the card, and one implicit backward pass (plain PyTorch).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import losses as gw_losses
from repro_torch.core.gw import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.train import optimizer as optim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # grad-accumulation steps per update
    remat: bool = True
    gather_params: bool = False    # ZeRO-3 in-loop param gather (bf16 wire)
    gw_align_weight: float = 0.0   # > 0 enables the FGW alignment loss
    # θ < 1: the feature (linear) term carries the student's gradient; θ = 1
    # (pure GW) is feature-free and gives a zero gradient.
    gw_align: gw_losses.AlignConfig = gw_losses.AlignConfig(
        theta=0.5, outer_iters=3, sinkhorn_iters=30)
    optimizer: optim.OptimizerConfig = optim.OptimizerConfig()


@dataclasses.dataclass
class TrainState:
    model: lm.LM
    opt: optim.AdamWState
    step: int = 0

    def params(self) -> dict:
        """Name → parameter, the names of ``model.named_parameters()``."""
        return dict(self.model.named_parameters())


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               generator: torch.Generator, device=None) -> TrainState:
    """A randomly initialised model (drawn from ``generator``) on
    ``device`` (the CUDA device by default) and zero AdamW moments."""
    model = lm.init_params(cfg, generator, resolve_device(device))
    return TrainState(model, optim.init(dict(model.named_parameters()),
                                        tcfg.optimizer), 0)


def state_tree(state: TrainState) -> dict:
    """The checkpoint's view of a state: {"params": name → parameter,
    "opt": {"m", "v"[, "ef"], "step"}, "step"}, leaves the state's own
    tensors and ints (`repro_torch.checkpoint.manager`)."""
    opt = {"m": state.opt.m, "v": state.opt.v, "step": state.opt.step}
    if state.opt.ef is not None:
        opt["ef"] = state.opt.ef
    return {"params": state.params(), "opt": opt, "step": state.step}


@torch.no_grad()
def load_state_tree(state: TrainState, tree: dict) -> TrainState:
    """Copy a restored `state_tree` into ``state`` in place."""
    for k, p in state.params().items():
        p.copy_(tree["params"][k])
    opt = tree["opt"]
    state.opt = optim.AdamWState(m=opt["m"], v=opt["v"], step=opt["step"],
                                 ef=opt.get("ef"))
    state.step = tree["step"]
    return state


def _microbatch_loss(model: lm.LM, mb: dict, cfg: ModelConfig,
                     tcfg: TrainConfig):
    loss, metrics = lm.loss_fn(model, mb, cfg, remat=tcfg.remat,
                               gather_params=tcfg.gather_params)
    if tcfg.gw_align_weight > 0.0 and "teacher_h" in mb:
        _, _, hidden = lm.forward(model, mb, cfg, remat=tcfg.remat,
                                  return_hidden=True)
        gw = gw_losses.fgw_alignment_loss_batch(
            hidden.float(), mb["teacher_h"].float(), tcfg.gw_align,
            device=hidden.device)
        loss = loss + tcfg.gw_align_weight * gw
        metrics = {**metrics, "gw_align": gw}
    return loss, metrics


def to_device(batch: dict, device) -> dict:
    """A batch's numpy arrays (or tensors) as tensors on ``device``; token
    ids and labels as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def train_step(state: TrainState, batch: dict, cfg: ModelConfig,
               tcfg: TrainConfig) -> dict:
    """One optimizer update over ``tcfg.microbatches`` accumulation steps,
    in place on ``state``.  ``batch`` leaves (global_batch, ...), numpy
    arrays or tensors, moved to the model's device and split into
    (microbatches, global_batch / microbatches, ...).  Returns the metrics
    (0-d tensors): loss, grad_norm, lr, and the last microbatch's ce, aux
    (and gw_align)."""
    nmb = tcfg.microbatches
    model = state.model
    params = state.params()
    batch = to_device(batch, next(iter(params.values())).device)
    n = next(iter(batch.values())).shape[0]
    if n % nmb:
        raise ValueError(f"a batch of {n} in {nmb} microbatches")
    gacc = None
    lacc = torch.zeros((), dtype=torch.float32)
    metrics = {}
    for i in range(nmb):
        mb = {k: v[i * (n // nmb):(i + 1) * (n // nmb)]
              for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        loss, metrics = _microbatch_loss(model, mb, cfg, tcfg)
        loss.backward()
        with torch.no_grad():
            grads = {k: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).float()
                     for k, p in params.items()}
            if nmb == 1:    # 0 + g / 1 is g, bit for bit
                gacc = grads
            elif gacc is None:
                gacc = {k: g / nmb for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    gacc[k].add_(g / nmb)
            lacc = lacc.to(loss.device) + loss.detach() / nmb
    model.zero_grad(set_to_none=True)
    opt_metrics = optim.apply_updates(params, gacc, state.opt,
                                      tcfg.optimizer)
    state.step += 1
    return {"loss": lacc, **opt_metrics,
            **{k: v.detach() for k, v in metrics.items()}}
