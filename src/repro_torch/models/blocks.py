"""Layer-stack machinery: layer kinds, the stack (prologue + template ×
repeats), shared slots and per-occurrence caches.

Reference: ``repro/models/blocks.py``.  The reference stacks a template
slot's parameters over repeats and runs the stack as one ``lax.scan``;
here each repeat's layer is a module of its own
(``scanned["slot<i>"][r]``), run by a host loop in the reference's order.
A slot listed in ``cfg.shared_slots`` is one module (``shared["slot<i>"]``)
used at every repeat (Zamba2's attention); its caches stay per occurrence.

A stack's cache is ``{"prologue": [layer cache, …], "body": [{"slot<i>":
layer cache, …} for each repeat]}``.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import attention, mlp, ssm
from repro_torch.models.common import ModelConfig, apply_norm, norm_params

ATTENTION_KINDS = ("attn_mlp", "attn_moe", "mla_mlp", "mla_moe",
                   "shared_attn")
MIXERS = {"mlstm": ssm.MLSTM, "slstm": ssm.SLSTM, "mamba": ssm.Mamba2}
#: the reference's ``gather_dtype``: the wire dtype of the in-loop gather
GATHER_DTYPE = torch.bfloat16


def gathered(p):
    """A slot parameter on the in-loop gather's wire: cast to
    `GATHER_DTYPE` and, a ``DTensor``, redistributed to all-``Replicate``
    (the reference's ``with_sharding_constraint(a.astype(bf16), P())``),
    one bf16 all-gather per mesh dim it is sharded on."""
    p = p.to(GATHER_DTYPE)
    if isinstance(p, DTensor):
        return p.redistribute(p.device_mesh,
                              [Replicate()] * p.device_mesh.ndim)
    return p


class Layer(torch.nn.Module):
    """One layer of a kind: pre-norm attention + MLP or MoE, or a pre-norm
    recurrent mixer; residual around each."""

    def __init__(self, kind: str, cfg: ModelConfig,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.kind = kind
        self.ln1 = norm_params(cfg, cfg.d_model, device)
        if kind in ATTENTION_KINDS:
            attn = attention.MLA if kind.startswith("mla") else attention.GQA
            self.attn = attn(cfg, generator, device)
            self.ln2 = norm_params(cfg, cfg.d_model, device)
            if kind.endswith("moe"):
                self.moe = mlp.MoE(cfg, generator, device)
            else:
                self.mlp = mlp.MLP(cfg, generator, device)
        elif kind in MIXERS:
            self.mix = MIXERS[kind](cfg, generator, device)
        else:
            raise ValueError(f"unknown layer kind {kind}")

    def forward(self, x, positions, cfg: ModelConfig, cache=None,
                q_offset: int = 0):
        """Returns (x, new_cache, aux_loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = apply_norm(self.ln1, x, cfg)
        if self.kind in ATTENTION_KINDS:
            a, new_cache = self.attn(h, positions, cfg, cache=cache,
                                     q_offset=q_offset)
            x = x + a
            h = apply_norm(self.ln2, x, cfg)
            if hasattr(self, "moe"):
                m, aux = self.moe(h, cfg)
            else:
                m = self.mlp(h, cfg)
            return x + m, new_cache, aux
        m, new_cache = self.mix(h, cfg, cache=cache)
        return x + m, new_cache, aux


def layer_cache_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype, device=None):
    if kind in ("attn_mlp", "attn_moe", "shared_attn"):
        return attention.gqa_cache_init(cfg, batch, max_len, dtype, device)
    if kind in ("mla_mlp", "mla_moe"):
        return attention.mla_cache_init(cfg, batch, max_len, dtype, device)
    if kind == "mlstm":
        return ssm.mlstm_cache_init(cfg, batch, dtype, device)
    if kind == "slstm":
        return ssm.slstm_cache_init(cfg, batch, dtype, device)
    if kind == "mamba":
        return ssm.mamba2_cache_init(cfg, batch, dtype, device)
    raise ValueError(kind)


class Stack(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.prologue = torch.nn.ModuleList(
            Layer(kind, cfg, generator, device) for kind in cfg.prologue)
        self.scanned = torch.nn.ModuleDict()
        self.shared = torch.nn.ModuleDict()
        for si, kind in enumerate(cfg.block_template):
            if si in cfg.shared_slots:
                self.shared[f"slot{si}"] = Layer(kind, cfg, generator, device)
            else:
                self.scanned[f"slot{si}"] = torch.nn.ModuleList(
                    Layer(kind, cfg, generator, device)
                    for _ in range(cfg.repeats))

    def layer(self, si: int, rep: int) -> Layer:
        """Template slot ``si``'s layer at repeat ``rep``."""
        key = f"slot{si}"
        return self.shared[key] if key in self.shared else \
            self.scanned[key][rep]

    def forward(self, x, positions, cfg: ModelConfig, caches=None,
                q_offset: int = 0, remat: bool = False,
                gather_params: bool = False):
        """Returns (x, new_caches, aux_sum).

        ``remat``: each template period runs under
        ``torch.utils.checkpoint`` (nothing saved, recomputed in the
        backward pass), the reference's ``jax.checkpoint(body,
        nothing_saveable)`` over its scan body.  ``gather_params``: a
        non-shared slot's parameters are cast to `GATHER_DTYPE` inside
        the period and, on a mesh, all-gathered in it (`gathered`), the
        reference's ZeRO-3 gather on its bf16 wire; on one device that is
        the cast alone, a change in the math."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_pro = []
        for li, layer in enumerate(self.prologue):
            c = caches["prologue"][li] if caches else None
            x, nc, aux = layer(x, positions, cfg, cache=c, q_offset=q_offset)
            new_pro.append(nc)
            aux_total = aux_total + aux
        new_body = []
        for rep in range(cfg.repeats):
            def period(h, aux_acc, rep=rep):
                step = {}
                for si in range(len(cfg.block_template)):
                    c = caches["body"][rep][f"slot{si}"] if caches else None
                    layer = self.layer(si, rep)
                    args = (h, positions, cfg)
                    kw = {"cache": c, "q_offset": q_offset}
                    if gather_params and si not in cfg.shared_slots:
                        h, nc, aux = torch.func.functional_call(
                            layer, {n: gathered(p) for n, p in
                                    layer.named_parameters()}, args, kw)
                    else:
                        h, nc, aux = layer(*args, **kw)
                    step[f"slot{si}"] = nc
                    aux_acc = aux_acc + aux
                return h, aux_acc, step
            if remat and caches is None:
                x, aux_total = torch.utils.checkpoint.checkpoint(
                    lambda h, a, period=period: period(h, a)[:2], x,
                    aux_total, use_reentrant=False)
            else:
                x, aux_total, step = period(x, aux_total)
                new_body.append(step)
        new_caches = ({"prologue": new_pro, "body": new_body}
                      if caches else None)
        return x, new_caches, aux_total


def stack_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device=None):
    return {"prologue": [layer_cache_init(kind, cfg, batch, max_len, dtype,
                                          device) for kind in cfg.prologue],
            "body": [{f"slot{si}": layer_cache_init(kind, cfg, batch, max_len,
                                                    dtype, device)
                      for si, kind in enumerate(cfg.block_template)}
                     for _ in range(cfg.repeats)]}
