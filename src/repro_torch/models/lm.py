"""The language model: embeddings → block stack → head, and its entry
points (forward / loss / prefill / decode_step).

Reference: ``repro/models/lm.py``.  Input modes: ``tokens`` — (B,S) ids;
``embeddings`` — (B,S,d_model) precomputed frontend embeddings (the vlm
and audio stub frontends).  M-RoPE configs also take ``positions`` of shape
(B,S,3) = (t,h,w).  The entry points take the model (an `LM`, holding the
parameters) and the config, as the reference takes its parameter tree and
the config, so one set of f32 parameters serves any compute dtype.  Every
apply casts the f32 parameters to the compute dtype, the reference's
semantics.

On a mesh (parameters laid out as ``DTensor``s by
`repro_torch.distributed.sharding.distribute_module`, batches and caches
by its specs) the entry points run on ``DTensor``s, each under
`repro_torch.distributed.sharding.on_mesh`.  Two places take another
route than one device's: the embedding gather is ``F.embedding`` (a
vocab-sharded table is looked up where it lies, each rank masking the
ids outside its rows and the results summed), and the loss's log-sum-exp
and gold logit reduce over the sharded vocab (`_lse_gold`), so the (B, S,
V) logits are never gathered.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.core.gw import resolve_device
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import mesh_of, on_mesh, pin
from repro_torch.models import blocks, common
from repro_torch.models.common import ModelConfig, apply_norm, norm_params


class LM(torch.nn.Module):
    """``embed`` (V,d) or ``in_proj`` (d,d), ``stack``, ``ln_f``, and
    ``head`` (d,V) unless the head is tied to the embedding.  On the CUDA
    device unless ``device`` says otherwise (raising without a card)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        pd = cfg.param_dtype
        d = cfg.d_model
        if cfg.input_mode == "tokens":
            self.embed = common.dense_init(generator, (cfg.vocab_size, d),
                                           pd, device, scale=0.02)
        else:
            self.in_proj = common.dense_init(generator, (d, d), pd, device)
        self.stack = blocks.Stack(cfg, generator, device)
        self.ln_f = norm_params(cfg, d, device)
        if not (cfg.tie_embeddings and cfg.input_mode == "tokens"):
            self.head = common.dense_init(generator, (d, cfg.vocab_size), pd,
                                          device, scale=0.02)

    def forward(self, batch, cfg: ModelConfig, return_hidden: bool = False):
        return forward(self, batch, cfg, return_hidden=return_hidden)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """A randomly initialised `LM` on ``device``, drawn from
    ``generator`` (the reference's std for each weight)."""
    return LM(cfg, generator, device)


def _embed(model: LM, batch, cfg: ModelConfig):
    dt = cfg.compute_dtype
    if cfg.input_mode == "tokens":
        if isinstance(model.embed, DTensor):
            # each rank's rows, the others masked to 0: summed right away
            # (an all-reduce of (B, S, d)), once, as its mask is one-shot;
            # pinned, so that a Partial gradient is reduced before it
            # reaches the masked lookup's backward
            x = torch.nn.functional.embedding(batch["tokens"], _vocab_only(
                model.embed))
            return pin(x.redistribute(x.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in x.placements])).to(dt)
        # gather, then cast: the rows of embed.to(dt), bit for bit
        return model.embed[batch["tokens"]].to(dt)
    return torch.einsum("bsd,de->bse", batch["embeddings"].to(dt),
                        model.in_proj.to(dt))


def _vocab_only(embed: DTensor) -> DTensor:
    """The embedding table with its vocab dim the only one sharded: a
    ``d_model`` shard (an FSDP layout) is gathered first, as a masked
    lookup takes the vocab dim alone."""
    pl = [p if p == Shard(0) else Replicate() for p in embed.placements]
    return embed if pl == list(embed.placements) else embed.redistribute(
        embed.device_mesh, pl)


def _head(model: LM, x, cfg: ModelConfig):
    if cfg.tie_embeddings and cfg.input_mode == "tokens":
        w = model.embed.to(cfg.compute_dtype).T
    else:
        w = model.head.to(cfg.compute_dtype)
    return torch.einsum("bsd,dv->bsv", x, w)


def _default_positions(batch, cfg: ModelConfig, seq_len: int,
                       batch_size: int, device):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(seq_len, device=device)[None, :].expand(batch_size,
                                                               seq_len)
    if cfg.m_rope:  # text-like default: t = h = w = the linear position
        pos = pos[..., None].expand(batch_size, seq_len, 3)
    return pos


def forward(model: LM, batch, cfg: ModelConfig, return_hidden: bool = False,
            remat: bool = False, gather_params: bool = False):
    """→ (logits (B,S,V) f32, aux_loss[, hidden (B,S,d)]).  ``remat`` and
    ``gather_params`` as in `repro_torch.models.blocks.Stack.forward`."""
    with on_mesh(mesh_of(model)):
        return _forward(model, batch, cfg, return_hidden, remat,
                        gather_params)


def _forward(model, batch, cfg, return_hidden, remat, gather_params):
    x = _embed(model, batch, cfg)
    b, s = x.shape[:2]
    positions = _default_positions(batch, cfg, s, b, x.device)
    x, _, aux = model.stack(x, positions, cfg, remat=remat,
                            gather_params=gather_params)
    x = apply_norm(model.ln_f, x, cfg)
    logits = _head(model, x, cfg).float()
    if return_hidden:
        return logits, aux, x
    return logits, aux


def loss_fn(model: LM, batch, cfg: ModelConfig, aux_weight: float = 0.01,
            z_weight: float = 1e-4, remat: bool = False,
            gather_params: bool = False):
    """Next-token cross-entropy (+ MoE aux + z-loss); positions with a
    label < 0 are masked.  The gold logit is a one-hot contraction, as in
    the reference."""
    with on_mesh(mesh_of(model)):
        logits, aux = _forward(model, batch, cfg, False, remat,
                               gather_params)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        labels = torch.clamp_min(labels, 0)
        lse, gold = _lse_gold(logits, labels, cfg.vocab_size)
        nll = (lse - gold) * mask
        denom = torch.clamp_min(mask.sum(), 1.0)
        ce = nll.sum() / denom
        z = ((lse * mask) ** 2).sum() / denom
        return ce + aux_weight * aux + z_weight * z, {"ce": ce, "aux": aux}


def _lse_gold(logits, labels, vocab: int):
    """(log-sum-exp over the vocab, the gold logit), each (B,S).  On a
    ``DTensor`` the vocab stays where it lies: the log-sum-exp is
    ``torch.logsumexp``'s own decomposition (max, sum of exp, log) with
    each reduction over the sharded vocab a ``Partial`` that DTensor
    all-reduces at (B,S), and the one-hot is built from a vocab ``arange``
    sharded as the logits' vocab dim, so its contraction with the logits
    (one nonzero term: the gold logit, exactly) is local too."""
    if not isinstance(logits, DTensor):
        onehot = torch.nn.functional.one_hot(labels, vocab).to(logits.dtype)
        return (torch.logsumexp(logits, dim=-1),
                torch.einsum("bsv,bsv->bs", logits, onehot))
    m = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    ids = distribute_tensor(
        torch.arange(vocab, device=logits.to_local().device),
        logits.device_mesh, [Shard(0) if p == Shard(2) else Replicate()
                             for p in logits.placements],
        src_data_rank=None)
    onehot = (labels[..., None] == ids).to(logits.dtype)
    # pinned: their gradients come back laid out as they are (the batch
    # split, the vocab whole), so the (B,S,V) gradient lies as the logits
    # do, with no all-to-all before the head's backward
    return pin(lse), pin(torch.einsum("bsv,bsv->bs", logits, onehot))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device=None, mesh=None):
    """Zeroed caches on ``device`` (the CUDA device by default); with
    ``mesh`` (a ``DeviceMesh``), ``DTensor``s laid out by
    `repro_torch.distributed.sharding.cache_specs` over its data axes, of
    which each rank makes only its own shard's zeros on the mesh's device
    (the whole caches are laid out on ``meta``)."""
    if mesh is not None:
        device = "meta"
    caches = blocks.stack_cache_init(cfg, batch, max_len, dtype,
                                     resolve_device(device))
    if mesh is None:
        return caches
    shape = sharding.mesh_shape(mesh)
    specs = sharding.cache_specs(caches, shape,
                                 sharding.data_axes_of(shape))

    def walk(c, s):
        if isinstance(c, dict):
            return {k: (c[k] if k == "length" else walk(c[k], s[k]))
                    for k in c}
        if isinstance(c, (list, tuple)):
            return type(c)(walk(a, b) for a, b in zip(c, s))
        return sharding.local_shard(c, mesh, s, sharding.zeros)
    return walk(caches, specs)


def prefill(model: LM, batch, cfg: ModelConfig, caches):
    """A full-sequence forward that fills ``caches`` (in place); returns
    (last token's logits (B,V) f32, caches)."""
    with on_mesh(mesh_of(model)):
        return _prefill(model, batch, cfg, caches)


def _prefill(model, batch, cfg, caches):
    x = _embed(model, batch, cfg)
    b, s = x.shape[:2]
    positions = _default_positions(batch, cfg, s, b, x.device)
    x, caches, _ = model.stack(x, positions, cfg, caches=caches)
    x = apply_norm(model.ln_f, x, cfg)
    return _head(model, x[:, -1:], cfg)[:, 0].float(), caches


def decode_step(model: LM, token_batch, caches, cfg: ModelConfig,
                position: Optional[torch.Tensor] = None):
    """One decode step.  token_batch: {"tokens": (B,1)} or {"embeddings":
    (B,1,d)}; position: (B,1) or (B,1,3), by default the first cache's
    length (0 for a stack with no attention cache)."""
    with on_mesh(mesh_of(model)):
        return _decode_step(model, token_batch, caches, cfg, position)


def _decode_step(model, token_batch, caches, cfg, position):
    x = _embed(model, token_batch, cfg)
    b = x.shape[0]
    if position is None:
        position = torch.full((b, 1), first_length(caches, cfg),
                              dtype=torch.long, device=x.device)
        if cfg.m_rope:
            position = position[..., None].expand(b, 1, 3)
    x, caches, _ = model.stack(x, position, cfg, caches=caches)
    x = apply_norm(model.ln_f, x, cfg)
    return _head(model, x, cfg)[:, 0].float(), caches


def first_length(caches, cfg: ModelConfig) -> int:
    for c in caches["prologue"]:
        if "length" in c:
            return c["length"]
    for si in range(len(cfg.block_template)):
        c = caches["body"][0][f"slot{si}"] if caches["body"] else None
        if c is not None and "length" in c:
            return c["length"]
    return 0
