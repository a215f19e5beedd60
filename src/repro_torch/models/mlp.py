"""Feed-forward layers: SwiGLU MLP and capacity-based top-k MoE (GShard-style
grouped dispatch).

Reference: ``repro/models/mlp.py``.  The MoE keeps the reference's
arithmetic: groups of the largest size ≤ ``moe_group_size`` that divides
the token count, a capacity of ``max(1, int(g·topk/e·cf))`` in Python
floats, the top-k experts in the order of ``lax.top_k`` (a stable
descending sort: on ties the lower index first), queue positions from a
cumsum over (token, k) in token-major order, tokens over capacity dropped,
and the one-hot dispatch and combine contractions, so its sums are the
reference's.  The reference's vmap over groups is a leading group axis.
On a mesh each rank routes the groups it holds (`MoE.forward`), and
where a rank holds only part of a group the tokens are first laid out
over the data axes alone.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.nn.functional import silu

from repro_torch.distributed.sharding import pin
from repro_torch.models import common
from repro_torch.models.common import ModelConfig


class MLP(torch.nn.Module):
    """Dense SwiGLU: ``w_gate``/``w_up`` (d,ff), ``w_down`` (ff,d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None, d_ff: int | None = None):
        super().__init__()
        pd = cfg.param_dtype
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = common.dense_init(generator, (d, ff), pd, device)
        self.w_up = common.dense_init(generator, (d, ff), pd, device)
        self.w_down = common.dense_init(generator, (ff, d), pd, device)

    def forward(self, x, cfg: ModelConfig):
        dt = cfg.compute_dtype
        g = torch.einsum("bsd,df->bsf", x, self.w_gate.to(dt))
        u = torch.einsum("bsd,df->bsf", x, self.w_up.to(dt))
        return torch.einsum("bsf,fd->bsd", silu(g) * u, self.w_down.to(dt))


def group_size(tokens: int, requested: int) -> int:
    """The largest group size ≤ ``requested`` that divides ``tokens``."""
    g = min(requested, tokens)
    while tokens % g:
        g -= 1
    return g


def top_k_stable(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first on ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(torch.nn.Module):
    """Top-k routed experts (``router`` (d,e), experts (e,d,ff) and
    (e,ff,d)) with optional shared experts (an `MLP` of width
    moe_d_ff · num_shared_experts)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
        self.router = common.dense_init(generator, (d, e), pd, device)
        self.w_gate = common.dense_init(generator, (e, d, ff), pd, device)
        self.w_up = common.dense_init(generator, (e, d, ff), pd, device)
        self.w_down = common.dense_init(generator, (e, ff, d), pd, device)
        self.shared = (MLP(cfg, generator, device,
                           d_ff=ff * cfg.num_shared_experts)
                       if cfg.num_shared_experts else None)

    def forward(self, x, cfg: ModelConfig):
        """x: (B,S,d) → (out (B,S,d), aux load-balance loss, f32)."""
        dt = cfg.compute_dtype
        b, s, d = x.shape
        e, topk = cfg.num_experts, cfg.num_experts_per_tok
        t = b * s
        g = group_size(t, cfg.moe_group_size)
        n_groups = t // g
        cap = max(1, int(g * topk / e * cfg.moe_capacity_factor))

        split = (isinstance(x, DTensor) and n_groups > 1
                 and _part_groups(x, g))
        if split:
            # a rank holding part of a group (the tokens split over more
            # ranks than there are groups): the token dims laid out over
            # the data axes alone first (an all-gather of (B_local, S, d)
            # over the others), as DTensor cannot split the groups so;
            # the output goes back in that layout too
            x = x.redistribute(x.device_mesh, _over_data(x))
        xt = pin(x.reshape(n_groups, g, d))
        logits = torch.einsum("ngd,de->nge", xt, self.router.to(dt))
        probs = torch.softmax(logits.float(), dim=-1)
        if isinstance(probs, DTensor):
            # the routing reads whole groups (a top-k, a cumsum over the
            # group's (token, k) queue): each rank routes the groups it
            # holds, on the (n, g, e) probabilities with only the group
            # dim split (any other split gathered), and its results
            # enter the dispatch again as DTensors in that layout
            mesh = probs.device_mesh
            lay = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                   for p in probs.placements]
            local = probs.redistribute(mesh, lay).to_local(
                grad_placements=lay)
            disp, comb, first = (DTensor.from_local(t, mesh, lay,
                                                    run_check=False)
                                 for t in _route(local, e, topk, cap, dt))
        else:
            disp, comb, first = _route(probs, e, topk, cap, dt)
        # auxiliary load-balance loss (Switch): e·Σ_e f_e·P_e
        aux = e * (first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        xin = torch.einsum("ngec,ngd->necd", disp.to(dt), xt)   # (n,e,cap,d)
        hg = torch.einsum("necd,edf->necf", xin, self.w_gate.to(dt))
        hu = torch.einsum("necd,edf->necf", xin, self.w_up.to(dt))
        ho = torch.einsum("necf,efd->necd", silu(hg) * hu,
                          self.w_down.to(dt))
        if isinstance(ho, DTensor):
            # every expert's output on each rank before the combine, whose
            # einsum flattens (e, cap): DTensor cannot with e split
            ho = ho.redistribute(ho.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                for p in ho.placements])
        out = torch.einsum("ngec,necd->ngd", comb.to(dt), ho)
        if split:   # and its gradient back in that layout before the view
            out = out.redistribute(xt.device_mesh, xt.placements)
            out = pin(pin(out).reshape(b, s, d))
        else:
            out = pin(out).reshape(b, s, d)
        if self.shared is not None:
            out = out + self.shared(x, cfg)
        return out, aux


def _part_groups(x: DTensor, g: int) -> bool:
    """Whether a rank's local tokens of ``x`` (B, S, d) are not whole
    groups of ``g``."""
    b, s = x.to_local().shape[:2]
    return (b * s) % g != 0


def _over_data(x: DTensor) -> list:
    """``x``'s placements with every mesh dim but the data axes
    (``pod``, ``data``) replicated."""
    return [p if name in ("pod", "data") else Replicate()
            for p, name in zip(x.placements, x.device_mesh.mesh_dim_names)]


def _route(probs, e: int, topk: int, cap: int, dt):
    """The top-k routing of (n, g, e) probabilities, each group alone:
    (dispatch, combine (n, g, e, cap), the one-hot (n, g, e) of each
    token's first expert)."""
    top_p, top_e = top_k_stable(probs, topk)                    # (n,g,topk)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    pg = top_p.to(dt)
    n_groups, g = probs.shape[:2]

    # position of each (token, k) within its expert's queue
    onehot = torch.nn.functional.one_hot(top_e, e).float()      # (n,g,k,e)
    flat = onehot.reshape(n_groups, g * topk, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(n_groups, g, topk, e)
    pos = (pos * onehot).sum(-1)                                # (n,g,k)
    keep = (pos < cap).float()
    caphot = (pos[..., None] == torch.arange(
        cap, device=probs.device, dtype=pos.dtype)).float()     # (n,g,k,cap)
    disp = torch.einsum("ngke,ngkc->ngec", onehot * keep[..., None], caphot)
    comb = torch.einsum("ngke,ngkc->ngec",
                        onehot * (keep * pg)[..., None], caphot)
    return disp, comb, torch.nn.functional.one_hot(top_e[..., 0], e).float()
