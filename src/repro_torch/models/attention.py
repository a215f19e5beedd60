"""Attention layers: GQA with chunked (flash-style) softmax, sliding-window
masking, M-RoPE, and DeepSeek-style MLA with a compressed-latent KV cache.

Reference: ``repro/models/attention.py``.  `chunked_attention` is the
reference's flash recurrence (running max and denominator over KV chunks)
in plain PyTorch: a host loop over q chunks and, inside it, over only the
KV chunks a q chunk can see.  The masked logit is the finite ``NEG_INF``,
so a row fully masked in an early chunk is wiped by a later chunk's
correction instead of turning into NaN.  GQA stays grouped: K/V are never
repeated over a group's heads.  Scores and the probability-value products
are f32 products of the compute-dtype operands (the reference's
``preferred_element_type=float32``): the operands are cast up, so a bf16
model's scores are f32 sums of exact bf16 products.

A layer's cache is a dict of preallocated buffers and a host ``length``:
decode writes one slot in place (a ring buffer at ``length % cache_len``
for a window-clamped cache) and returns the dict with ``length + 1``.

On a mesh the attention cores (`chunked_attention`, `decode_attention`,
MLA decode's latent attention) run on each rank's batch shard
(`repro_torch.distributed.sharding.batch_local`): their heads, and a
cache's sequence shards, are gathered first.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import batch_local, pin
from repro_torch.models import common
from repro_torch.models.common import ModelConfig, apply_m_rope, apply_rope

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked causal attention (flash recurrence)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024):
    """q: (B,Sq,H,hd)  k: (B,Sk,KV,hd)  v: (B,Sk,KV,hdv) → (B,Sq,H,hdv).

    ``q_offset``: absolute position of q[0].  A q chunk visits only the
    KV chunks ``lo:hi`` that its causal and window masks leave visible,
    the reference's pruning, so the masked tiles that enter the running
    sums are the reference's."""
    b, sq, h, hd = q.shape
    _, sk, kv, _ = k.shape
    hdv = v.shape[-1]
    rep = h // kv
    scale = hd ** -0.5
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    n_q = math.ceil(sq / qc)
    n_k = math.ceil(sk / kc)
    dev = q.device
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, n_q * qc - sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, n_k * kc - sk))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n_k * kc - sk))
    qg = q.reshape(b, n_q * qc, kv, rep, hd).float()
    kg = k.reshape(b, n_k, kc, kv, hd).float()
    vg = v.reshape(b, n_k, kc, kv, hdv).float()
    ar_q = torch.arange(qc, device=dev)
    ar_k = torch.arange(kc, device=dev)

    outs = []
    for qi in range(n_q):
        qblk = qg[:, qi * qc:(qi + 1) * qc]              # (B,qc,KV,rep,hd)
        q_pos = q_offset + qi * qc + ar_q
        hi = n_k if not causal else min(
            n_k, math.ceil((q_offset + (qi + 1) * qc) / kc))
        lo = 0 if window is None else max(
            0, (q_offset + qi * qc - window) // kc)
        hi = max(hi, lo + 1)
        m = torch.full((b, kv, rep, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kv, rep, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kv, rep, qc, hdv), dtype=torch.float32,
                          device=dev)
        for kci in range(lo, hi):
            k_pos = kci * kc + ar_k
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk, kg[:, kci]) * scale
            mask = (k_pos < sk)[None, :].expand(qc, kc)
            if causal:
                mask = mask & (q_pos[:, None] >= k_pos[None, :])
            if window is not None:
                mask = mask & (q_pos[:, None] - k_pos[None, :] <= window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, vg[:, kci])
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)  # (B,KV,rep,qc,hdv)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, qc, h, hdv)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def decode_attention(q, k_cache, v_cache, n_valid: int):
    """Single-token decode: q (B,1,H,hd), caches (B,Smax,KV,hd).

    ``n_valid``: the number of valid cache slots (in a ring buffer slot
    order is not position order; the softmax does not care)."""
    b, _, h, hd = q.shape
    _, smax, kv, _ = k_cache.shape
    rep = h // kv
    qg = q.reshape(b, 1, kv, rep, hd).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache.float()) * hd ** -0.5
    mask = torch.arange(smax, device=q.device) < n_valid
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bgrqd", p, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def _rope_qk(q, k, positions, cfg: ModelConfig):
    if cfg.m_rope:
        pairs = q.shape[-1] // 2
        sections = (pairs - 2 * (pairs // 3), pairs // 3, pairs // 3)
        return (apply_m_rope(q, positions, cfg.rope_theta, sections),
                apply_m_rope(k, positions, cfg.rope_theta, sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def write_slot(buf, value, slot: int):
    """Write ``value`` (B,1,…) at ``slot`` of ``buf`` (B,S,…) in place, the
    start clamped to S − 1 as ``lax.dynamic_update_slice`` clamps it."""
    write_rows(buf, value, min(max(slot, 0), buf.shape[1] - 1))


def write_rows(buf, value, start: int):
    """``buf[:, start:start + n] = value`` (``value`` (B,n,…)) in place.
    On a ``DTensor`` cache whose dim 1 (the sequence, `cache_specs`'s
    longest dim) is sharded, a slice of it is not a local view, so each
    rank writes the rows of the range that it holds into its shard:
    ``value`` is first laid out as ``buf`` with dim 1 replicated (an
    all-gather of the new rows where they are sharded otherwise)."""
    n = value.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, start:start + n] = value.to(buf.dtype)
        return
    mesh = buf.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh,
                                   [Replicate()] * mesh.ndim)
    seq = [i for i, p in enumerate(buf.placements) if p == Shard(1)]
    value = value.to(buf.dtype).redistribute(
        mesh, [Replicate() if i in seq else p
               for i, p in enumerate(buf.placements)]).to_local()
    local = buf.to_local()
    k = 0
    for i in seq:
        k = k * mesh.size(i) + mesh.get_local_rank(i)
    lo = k * local.shape[1]
    a, b = max(start, lo), min(start + n, lo + local.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = value[:, a - start:b - start]


def _roll(x, shift: int):
    """``torch.roll(x, shift, 1)``; on a ``DTensor`` on each rank's batch
    shard (torch 2.11's ``DTensor`` has no rule for ``roll``)."""
    if not shift:
        return x
    return batch_local(torch.roll, x, shift, 1)


class GQA(torch.nn.Module):
    """Grouped-query attention: ``wq`` (d,H,hd), ``wk``/``wv`` (d,KV,hd),
    ``wo`` (H·hd,d)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
        self.wq = common.dense_init(generator, (d, h, hd), pd, device)
        self.wk = common.dense_init(generator, (d, kv, hd), pd, device)
        self.wv = common.dense_init(generator, (d, kv, hd), pd, device)
        self.wo = common.dense_init(generator, (h * hd, d), pd, device)

    def forward(self, x, positions, cfg: ModelConfig, *, cache=None,
                q_offset: int = 0):
        """x: (B,S,d).  ``cache``: None (no cache), or a layer cache that
        a prefill (S > 1) fills or a decode (S = 1) extends.  Returns
        (out, new_cache)."""
        dt = cfg.compute_dtype
        b, s, _ = x.shape
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        q, k = _rope_qk(q, k, positions, cfg)

        if cache is None:
            out = batch_local(chunked_attention, q, k, v, causal=True,
                              window=cfg.sliding_window, q_offset=q_offset)
            new_cache = None
        elif s == 1:  # decode: a ring buffer when the cache is window-clamped
            length = cache["length"]
            cache_len = cache["k"].shape[1]
            write_slot(cache["k"], k, length % cache_len)
            write_slot(cache["v"], v, length % cache_len)
            out = batch_local(decode_attention, q, cache["k"].to(dt),
                              cache["v"].to(dt),
                              n_valid=min(length + 1, cache_len))
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "length": length + 1}
        else:  # prefill: keep the last cache_len positions at their ring
               # slots, so that later decode writes line up
            out = batch_local(chunked_attention, q, k, v, causal=True,
                              window=cfg.sliding_window)
            kbuf, vbuf = cache["k"], cache["v"]
            cache_len = kbuf.shape[1]
            if s >= cache_len:
                shift = s % cache_len   # position p lands at slot p % len
                write_rows(kbuf, _roll(k[:, -cache_len:], shift), 0)
                write_rows(vbuf, _roll(v[:, -cache_len:], shift), 0)
            else:
                write_rows(kbuf, k, 0)
                write_rows(vbuf, v, 0)
            new_cache = {"k": kbuf, "v": vbuf, "length": s}
        out = pin(out.reshape(b, s, -1))
        return torch.einsum("bsk,kd->bsd", out, self.wo.to(dt)), new_cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window + 1)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    dtype = common.torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed KV latent + decoupled RoPE
# ---------------------------------------------------------------------------

class MLA(torch.nn.Module):
    """Multi-head latent attention.  The cache holds the r-dim latent and
    the RoPE key only; decode absorbs ``w_uk`` and ``w_uv`` into the
    query and the output."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d, h = cfg.d_model, cfg.num_heads
        r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
        self.wq = common.dense_init(generator, (d, h, dn + dr), pd, device)
        self.w_dkv = common.dense_init(generator, (d, r), pd, device)
        self.kv_norm = torch.nn.ParameterDict(
            {"scale": common.const_param(1.0, (r,), cfg, device)})
        self.w_uk = common.dense_init(generator, (r, h, dn), pd, device)
        self.w_uv = common.dense_init(generator, (r, h, dv), pd, device)
        self.w_kr = common.dense_init(generator, (d, dr), pd, device)
        self.wo = common.dense_init(generator, (h * dv, d), pd, device)

    def forward(self, x, positions, cfg: ModelConfig, *, cache=None,
                q_offset: int = 0):
        dt = cfg.compute_dtype
        b, s, _ = x.shape
        h = cfg.num_heads
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim

        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        c_kv = torch.einsum("bsd,dr->bsr", x, self.w_dkv.to(dt))
        c_kv = common.rms(self.kv_norm["scale"], c_kv)  # always RMS
        k_rope = torch.einsum("bsd,dk->bsk", x, self.w_kr.to(dt))
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0]

        if cache is None or s > 1:
            # train/prefill: expand the latent to per-head K/V
            k_nope = torch.einsum("bsr,rhk->bshk", c_kv, self.w_uk.to(dt))
            v = torch.einsum("bsr,rhk->bshk", c_kv, self.w_uv.to(dt))
            k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(
                b, s, h, dr)], -1)
            q_full = torch.cat([q_nope, q_rope], -1)
            out = batch_local(chunked_attention, q_full, k_full, v,
                              causal=True, q_offset=q_offset)
            new_cache = None
            if cache is not None:  # prefill
                ck, kr = cache["c_kv"], cache["k_rope"]
                if s > ck.shape[1]:
                    raise ValueError(f"prefill of {s} tokens into a cache "
                                     f"of {ck.shape[1]}")
                write_rows(ck, c_kv, 0)
                write_rows(kr, k_rope, 0)
                new_cache = {"c_kv": ck, "k_rope": kr, "length": s}
        else:
            # decode with weight absorption: q_nopeᵀW_uk c + q_rope·k_rope
            length = cache["length"]
            ck, kr = cache["c_kv"], cache["k_rope"]
            write_slot(ck, c_kv, length)
            write_slot(kr, k_rope, length)
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, self.w_uk.to(dt))
            o_lat = batch_local(_mla_latent_attention, q_lat, q_rope,
                                ck.to(dt), kr.to(dt), length=length,
                                scale=(dn + dr) ** -0.5)
            out = torch.einsum("bshr,rhk->bshk", o_lat, self.w_uv.to(dt))
            new_cache = {"c_kv": ck, "k_rope": kr, "length": length + 1}
        out = pin(out.reshape(b, s, -1))
        return torch.einsum("bsk,kd->bsd", out, self.wo.to(dt)), new_cache


def _mla_latent_attention(q_lat, q_rope, ck, kr, *, length: int,
                          scale: float):
    """MLA decode's attention over the latent cache ``ck`` and the RoPE
    keys ``kr`` (positions ≤ ``length``), in the latent space."""
    dt = q_lat.dtype
    s_lat = torch.einsum("bshr,btr->bhst", q_lat, ck)
    s_rope = torch.einsum("bshk,btk->bhst", q_rope, kr)
    scores = (s_lat + s_rope) * scale
    mask = torch.arange(ck.shape[1], device=ck.device) <= length
    scores = torch.where(mask, scores, NEG_INF)
    acc_t = torch.promote_types(dt, torch.float32)
    p = torch.softmax(scores.to(acc_t), -1).to(dt)
    return torch.einsum("bhst,btr->bshr", p, ck)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None):
    dtype = common.torch_dtype(dtype)
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                  dtype=dtype, device=device),
            "length": 0}
