"""AdamW, the LR schedule, global-norm clipping and optional int8
error-feedback gradient compression, as plain functions over a model's
named parameters.

Reference: ``repro/train/optimizer.py``.  The moments (and the error
feedback) are f32 tensors on the parameters' device, keyed by parameter
name; `apply_updates` writes the parameters and the moments in place,
where the reference returns new trees.

The reference's leaves.  The reference stacks each ``scanned`` template
slot's leaves over the repeats (a norm's scale is (repeats, d)); the port
holds one tensor a repeat (``stack.scanned.slot<i>.<r>.…``).  Two rules
read the reference's leaf: weight decay applies where the reference's
leaf has rank ≥ 2 (so every scanned norm scale, bias and gate vector
decays, while ``ln_f.scale`` and a prologue's or shared slot's vectors do
not), and the int8 round trip takes one scale over the whole reference
leaf, i.e. over all repeats of a slot parameter.  `reference_leaf` is the
one map from a port parameter to its reference leaf that both rules (and
`repro_torch.launch.flops.param_counts`) use.

f32 arithmetic.  The schedule, the bias corrections ``b ** step`` and the
clip scale are evaluated in f32 on the host, as the reference evaluates
them in f32, and enter the update as 0-d f32 tensors on the parameters'
device; every division is a true division.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    compress_grads: bool = False   # int8 error-feedback (inter-pod wire cut)


@dataclasses.dataclass
class AdamWState:
    """The moments ``m`` and ``v`` (and the error feedback ``ef`` when
    gradients are compressed), f32, by parameter name; ``step`` the count
    of updates applied."""
    m: dict
    v: dict
    step: int = 0
    ef: Optional[dict] = None


def reference_leaf(name: str, ndim: int) -> tuple[str, int]:
    """(the reference's leaf name, its rank) of the port parameter
    ``name`` of rank ``ndim``: a scanned slot's repeat index is dropped
    and its rank is one more (the stacked repeat axis)."""
    parts = name.split(".")
    if parts[:2] == ["stack", "scanned"]:
        return ".".join(parts[:3] + parts[4:]), ndim + 1
    return name, ndim


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; an f32 0-d
    tensor on the host, evaluated in f32 as the reference does."""
    step = _f32(step)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init(params: dict, cfg: OptimizerConfig) -> AdamWState:
    """Zero f32 moments for each named parameter, on its device."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return AdamWState(m=zeros(), v=zeros(), step=0,
                      ef=zeros() if cfg.compress_grads else None)


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖x‖²) over the tensors (a dict's values or an iterable), in f32."""
    if isinstance(tensors, dict):
        tensors = tensors.values()
    sq = [torch.sum(torch.square(x.float())) for x in tensors]
    return torch.sqrt(torch.stack(sq).sum())


def clip_scale(norm, max_norm: float):
    """min(1, max_norm / max(norm, 1e-9)) in f32, a true division (a Python
    scalar over a tensor is a reciprocal and a product in PyTorch: two
    roundings)."""
    return torch.clamp_max(torch.div(
        torch.tensor(max_norm, dtype=torch.float32, device=norm.device),
        torch.clamp_min(norm, 1e-9)), 1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(the gradients scaled to a global norm ≤ ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return {k: g * scale for k, g in grads.items()}, norm


def quantize_int8(x, amax=None):
    """Symmetric per-tensor int8 quantization: (q, scale).  ``amax``: the
    largest |x| to scale by (by default x's own), so that the tensors of
    one reference leaf share a scale."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.div(torch.clamp_min(amax, 1e-12),
                      torch.tensor(127.0, device=amax.device))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads: dict, ef: dict, groups=None):
    """The int8 error-feedback round trip, what survives the quantized
    wire: g' = deq(quant(g + ef)), ef' = g + ef − g'.  ``groups`` lists
    tuples of names that share one scale (one reference leaf, `leaf_groups`);
    by default each tensor is its own."""
    if groups is None:
        groups = [(k,) for k in grads]
    g_new, ef_new = {}, {}
    for names in groups:
        gf = {k: grads[k].float() + ef[k] for k in names}
        amax = torch.stack([torch.max(torch.abs(x)) for x in gf.values()]
                           ).max()
        for k, x in gf.items():
            q, scale = quantize_int8(x, amax)
            deq = q.float() * scale
            g_new[k], ef_new[k] = deq, x - deq
    return g_new, ef_new


def leaf_groups(params: dict) -> list[tuple]:
    """The parameter names grouped by their reference leaf, in order."""
    groups: dict[str, list] = {}
    for k, p in params.items():
        groups.setdefault(reference_leaf(k, p.ndim)[0], []).append(k)
    return [tuple(v) for v in groups.values()]


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: AdamWState,
                  cfg: OptimizerConfig) -> dict:
    """One AdamW step, in place: ``params`` (name → parameter) and the
    moments of ``state`` are updated and ``state.step`` advanced.  Returns
    the metrics {"grad_norm", "lr"} (f32 0-d tensors; the norm on the
    parameters' device, before clipping)."""
    step = state.step + 1
    grads = {k: g.float() for k, g in grads.items()}
    if cfg.compress_grads:
        grads, state.ef = compress_decompress(grads, state.ef,
                                              leaf_groups(params))
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)
    lr = lr_schedule(cfg, step)
    dev = gnorm.device
    # 0-d device tensors, not Python scalars: CUDA divides by a CPU scalar
    # as a product with its reciprocal, one more rounding
    b1c = (1 - cfg.b1 ** _f32(step)).to(dev)
    b2c = (1 - cfg.b2 ** _f32(step)).to(dev)
    lr_ = lr.to(dev)
    # each parameter's update with at most three temporaries of its size,
    # the in-place forms rounding as the expressions they replace:
    # m = b1·m + (1 − b1)·g, v = b2·v + ((1 − b2)·g)·g,
    # delta = (m / b1c) / (√(v / b2c) + eps) [+ wd·p], p = p − lr·delta
    for k, p in params.items():
        g, m, v = grads[k] * scale, state.m[k], state.v[k]
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        g.mul_(1 - cfg.b2).mul_(grads[k] * scale)
        v.mul_(cfg.b2).add_(g)
        del g
        t = (v / b2c).sqrt_().add_(cfg.eps)
        delta = (m / b1c).div_(t)
        del t
        pf = p.float()
        if reference_leaf(k, p.ndim)[1] >= 2:  # decoupled decay, matrices
            delta.add_(cfg.weight_decay * pf)
        delta.mul_(lr_)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(pf - delta)
    state.step = step
    return {"grad_norm": gnorm, "lr": lr}
