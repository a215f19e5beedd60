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

On a mesh.  `shard_state` lays a state out on a ``DeviceMesh`` (the
reference's ``in_shardings``): parameters by
`repro_torch.distributed.sharding.param_specs`, the moments by
`zero_specs` (ZeRO-1).  `train_step` on such a state splits each
microbatch over the mesh's data axes by `batch_specs` and runs the same
step on ``DTensor``s: the gradients' reductions come from their
``Partial`` placements, and a moment sharded over ``data`` is updated in
its own layout (`repro_torch.train.optimizer.apply_updates`).  The FGW
term's kernels take local tensors: each rank solves the lanes of its data
shard (`_fgw_term`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import losses as gw_losses
from repro_torch.core.gw import resolve_device
from repro_torch.distributed import sharding
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


def shard_state(state: TrainState, mesh, strategy: str = "2d",
                fill=None) -> TrainState:
    """Lay ``state`` out on ``mesh`` (a ``DeviceMesh``) in place: each
    parameter becomes a ``DTensor`` by `sharding.param_specs`, AdamW's
    ``m`` and ``v`` by `sharding.zero_specs` (ZeRO-1: a ``data`` shard
    more), the int8 error feedback as its parameter.  Every rank takes rank
    0's values.  A state on the ``meta`` device (`init_state` there) has
    none: each rank makes only its own shards, the parameters by ``fill``
    (`sharding.local_shard`) and the moments and error feedback as
    zeros, as `init_state` makes them."""
    shape = sharding.mesh_shape(mesh)
    shapes = {k: tuple(p.shape) for k, p in state.params().items()}
    pspecs = sharding.param_specs(shapes, shape, strategy)
    zspecs = sharding.zero_specs(shapes, pspecs, shape)
    sharding.distribute_module(state.model, mesh, pspecs, fill=fill)
    opt = state.opt

    def dist(tree, specs):
        return {k: sharding.distribute(t, mesh, specs[k],
                                       fill=sharding.zeros)
                for k, t in tree.items()}
    state.opt = optim.AdamWState(
        m=dist(opt.m, zspecs), v=dist(opt.v, zspecs), step=opt.step,
        ef=None if opt.ef is None else dist(opt.ef, pspecs))
    return state


def _fgw_term(hidden, teacher, cfg: gw_losses.AlignConfig):
    """The mean FGW alignment loss over the batch's lanes.  On a mesh the
    B1/B2 kernels take no ``DTensor``: the hidden states are laid out as
    the teacher's (this rank's data shard, replicated on ``model``), each
    rank solves its own lanes, and its lane mean, scaled by its share of
    the lanes, is a ``Partial`` term of the batch mean over the data
    axes (each lane's loss is its solo solve's; only the mean's summation
    order changes)."""
    if not isinstance(hidden, DTensor):
        return gw_losses.fgw_alignment_loss_batch(hidden, teacher, cfg,
                                                  device=hidden.device)
    mesh = teacher.device_mesh
    h = hidden.redistribute(mesh, teacher.placements).to_local()
    t = teacher.to_local()
    local = gw_losses.fgw_alignment_loss_batch(h, t, cfg, device=h.device)
    local = local * (h.shape[0] / hidden.shape[0])
    # a Partial's gradient comes back whole on each rank (from_local's
    # backward keeps a replicated gradient), as each term's weight is 1
    return DTensor.from_local(
        local, mesh, [Partial() if isinstance(p, Shard) else Replicate()
                      for p in teacher.placements], run_check=False)


def _microbatch_loss(model: lm.LM, mb: dict, cfg: ModelConfig,
                     tcfg: TrainConfig):
    loss, metrics = lm.loss_fn(model, mb, cfg, remat=tcfg.remat,
                               gather_params=tcfg.gather_params)
    if tcfg.gw_align_weight > 0.0 and "teacher_h" in mb:
        _, _, hidden = lm.forward(model, mb, cfg, remat=tcfg.remat,
                                  return_hidden=True)
        gw = _fgw_term(hidden.float(), mb["teacher_h"].float(),
                       tcfg.gw_align)
        loss = loss + tcfg.gw_align_weight * gw
        metrics = {**metrics, "gw_align": gw}
    return loss, metrics


def _full(x):
    """A metric as a plain 0-d tensor, the same on every rank."""
    return x.full_tensor() if isinstance(x, DTensor) else x


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
    (microbatches, global_batch / microbatches, ...) (or, laid out already
    on the mesh, split on each rank's rows: `_microbatch`).  Returns the
    metrics (0-d tensors): loss, grad_norm, lr, and the last microbatch's
    ce, aux (and gw_align)."""
    nmb = tcfg.microbatches
    model = state.model
    params = state.params()
    mesh = sharding.mesh_of(model)
    batch = to_device(batch, next(iter(params.values())).device)
    n = next(iter(batch.values())).shape[0]
    if n % nmb:
        raise ValueError(f"a batch of {n} in {nmb} microbatches")
    gacc = None
    lacc = torch.zeros((), dtype=torch.float32)
    metrics = {}
    with sharding.on_mesh(mesh):
        for i in range(nmb):
            mb = _microbatch(batch, i, nmb, mesh)
            model.zero_grad(set_to_none=True)
            loss, metrics = _microbatch_loss(model, mb, cfg, tcfg)
            if isinstance(loss, DTensor):   # reduce a Partial loss first
                loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
            loss.backward()
            with torch.no_grad():
                grads = {k: _grad_of(p) for k, p in params.items()}
                if nmb == 1:    # 0 + g / 1 is g, bit for bit
                    gacc = grads
                elif gacc is None:
                    gacc = {k: g / nmb for k, g in grads.items()}
                else:
                    for k, g in grads.items():
                        gacc[k].add_(g / nmb)
                lacc = _full(lacc.to(loss.device) + loss.detach() / nmb)
        model.zero_grad(set_to_none=True)
        opt_metrics = optim.apply_updates(params, gacc, state.opt,
                                          tcfg.optimizer)
    state.step += 1
    return {"loss": lacc, **{k: _full(v) for k, v in opt_metrics.items()},
            **{k: _full(v.detach()) for k, v in metrics.items()}}


def _microbatch(batch: dict, i: int, nmb: int, mesh) -> dict:
    """Microbatch ``i`` of ``nmb``: rows of the whole batch, split over
    the mesh by `sharding.batch_specs`.  A batch already laid out
    (``DTensor``s, as `repro_torch.launch.dryrun` makes it, whose whole
    never exists) is split on each rank's own rows instead: microbatch
    ``i`` is rows ``i``/``nmb`` of every rank's shard."""
    n = next(iter(batch.values())).shape[0]
    if not isinstance(next(iter(batch.values())), DTensor):
        mb = {k: v[i * (n // nmb):(i + 1) * (n // nmb)]
              for k, v in batch.items()}
        return mb if mesh is None else sharding.distribute_batch(mb, mesh)
    out = {}
    for k, v in batch.items():
        local = v.to_local()
        if local.shape[0] % nmb:
            raise ValueError(f"a local batch of {local.shape[0]} rows in "
                             f"{nmb} microbatches")
        m = local.shape[0] // nmb
        shape = (n // nmb,) + tuple(v.shape[1:])
        out[k] = DTensor.from_local(
            local[i * m:(i + 1) * m], v.device_mesh, v.placements,
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    return out


def _grad_of(p) -> torch.Tensor:
    """A parameter's gradient in f32 (zeros where it has none), laid out
    as the parameter: a ``Partial`` gradient is reduced here (an
    all-reduce, or a reduce-scatter onto a sharded parameter)."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g.float()
