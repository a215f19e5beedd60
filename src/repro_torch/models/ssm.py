"""Recurrent sequence-mixing layers: mLSTM + sLSTM (xLSTM) and Mamba2 (SSD).

Reference: ``repro/models/ssm.py``.  mLSTM and Mamba2 are gated linear
attention, S_t = exp(f_t)·S_{t−1} + k_t v_tᵀ read out as y_t = q_tᵀ S_t,
on one chunk-parallel core (`gla_chunked`: a masked (C×C) product inside a
chunk, a host loop carrying the f32 (dk×dv) state across chunks).  The
xLSTM normalizer n_t rides as a ones column appended to v.  sLSTM is a true
time recurrence: a host loop over the sequence.  Mamba2's causal
convolution sums its taps in order, as the reference does (not
``conv1d``), and its softplus is ``logaddexp(x, 0)`` with no threshold.
On a mesh the scans, the recurrence and the convolution run on each
rank's batch shard (`repro_torch.distributed.sharding.batch_local`).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.nn.functional import silu

from repro_torch.distributed.sharding import batch_local
from repro_torch.models import common
from repro_torch.models.common import ModelConfig


def softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) with no linear threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: −softplus(−x)."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# chunk-parallel gated linear attention (shared by mLSTM / Mamba2)
# ---------------------------------------------------------------------------

def gla_chunked(q, k, v, log_f, *, chunk: int = 128, state0=None):
    """q,k: (B,S,H,dk)  v: (B,S,H,dv)  log_f: (B,S,H) ≤ 0.

    Returns (y (B,S,H,dv) in v's dtype, final state (B,H,dk,dv) f32).
    S_t = e^{f_t} S_{t−1} + k_t v_tᵀ, y_t = q_tᵀ S_t (inclusive of t); a
    sequence that is not a multiple of the chunk is padded with log f = 0.
    """
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    pad = -s % c
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                   for t in (q, k, v))
        log_f = torch.nn.functional.pad(log_f, (0, 0, 0, pad))
    n = (s + pad) // c
    if state0 is None:
        state0 = torch.zeros((b, h, dk, dv), dtype=torch.float32,
                             device=q.device)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    state = state0
    ys = []
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        qb, kb, vb, fb = q[:, sl], k[:, sl], v[:, sl], log_f[:, sl]
        bsum = torch.cumsum(fb, dim=1)                 # (b,c,h) inclusive
        total = bsum[:, -1]                            # (b,h)
        # intra-chunk: A_ts = (q_t·k_s)·e^{b_t−b_s}, s ≤ t
        scores = torch.einsum("bthd,bshd->bhts", qb.float(), kb.float())
        bt = bsum.transpose(1, 2)                      # (b,h,c)
        decay = bt[:, :, :, None] - bt[:, :, None, :]  # (b,h,t,s)
        a = torch.where(tri, scores * torch.exp(decay), 0.0)
        y_intra = torch.einsum("bhts,bshd->bthd", a, vb.float())
        # inter-chunk: y_t += e^{b_t}·q_tᵀ S0
        qs = qb.float() * torch.exp(bsum)[..., None]
        y_inter = torch.einsum("bthd,bhdv->bthv", qs, state)
        # state update: S' = e^{B}S0 + Σ_s e^{B−b_s} k_s v_sᵀ
        kd = kb.float() * torch.exp(total[:, None] - bsum)[..., None]
        state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bshd,bshv->bhdv", kd, vb.float()))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(v.dtype), state


def gla_decode_step(S, q, k, v, log_f):
    """One-token recurrent step. q,k (B,1,H,dk) v (B,1,H,dv) log_f (B,1,H)."""
    f = torch.exp(log_f[:, 0].float())[..., None, None]
    S_new = f * S + torch.einsum("bhd,bhv->bhdv", k[:, 0].float(),
                                 v[:, 0].float())
    y = torch.einsum("bhd,bhdv->bhv", q[:, 0].float(), S_new)
    return S_new, y[:, None].to(v.dtype)


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM)
# ---------------------------------------------------------------------------

class MLSTM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        h = cfg.num_heads
        self.w_up = common.dense_init(generator, (d, 2 * d_in), pd, device)
        self.wq = common.dense_init(generator, (d_in, d_in), pd, device)
        self.wk = common.dense_init(generator, (d_in, d_in), pd, device)
        self.wv = common.dense_init(generator, (d_in, d_in), pd, device)
        self.w_igate = common.dense_init(generator, (d_in, h), pd, device,
                                         scale=1e-2)
        self.w_fgate = common.dense_init(generator, (d_in, h), pd, device,
                                         scale=1e-2)
        self.b_fgate = common.const_param(3.0, (h,), cfg, device)  # remember
        self.w_down = common.dense_init(generator, (d_in, d), pd, device)

    def _qkvf(self, xi, cfg: ModelConfig):
        dt = cfg.compute_dtype
        b, s, d_in = xi.shape
        h = cfg.num_heads
        dh = d_in // h
        q = torch.einsum("bsd,de->bse", xi, self.wq.to(dt))
        k = torch.einsum("bsd,de->bse", xi, self.wk.to(dt)) * dh ** -0.5
        v = torch.einsum("bsd,de->bse", xi, self.wv.to(dt))
        q, k, v = (t.reshape(b, s, h, dh) for t in (q, k, v))
        ig = torch.einsum("bsd,dh->bsh", xi, self.w_igate.to(dt))
        fg = (torch.einsum("bsd,dh->bsh", xi, self.w_fgate.to(dt))
              + self.b_fgate.to(dt))
        log_f = log_sigmoid(fg.float())
        i_gate = torch.exp(torch.clamp_max(ig.float(), 10.0))  # capped exp
        # input gate folded into k; a ones column on v for the normalizer
        k = k.float() * i_gate[..., None]
        v_aug = torch.cat([v.float(), torch.ones_like(v[..., :1],
                                                      dtype=torch.float32)],
                          -1)
        return q, k.to(dt), v_aug.to(dt), log_f.to(dt)

    def forward(self, x, cfg: ModelConfig, *, cache=None):
        dt = cfg.compute_dtype
        b, s, d = x.shape
        d_in = cfg.ssm_expand * d
        up = torch.einsum("bsd,de->bse", x, self.w_up.to(dt))
        xi, z = up[..., :d_in], up[..., d_in:]
        q, k, v_aug, log_f = self._qkvf(xi, cfg)
        if cache is None:
            y, _ = batch_local(gla_chunked, q, k, v_aug, log_f)
            new_cache = None
        elif s == 1:
            S_new, y = batch_local(gla_decode_step, cache["state"], q, k,
                                   v_aug, log_f)
            new_cache = {"state": S_new}
        else:  # prefill: chunked, keep the final state
            y, S = batch_local(gla_chunked, q, k, v_aug, log_f)
            new_cache = {"state": S}
        num, den = y[..., :-1], y[..., -1:]
        hblk = (num / torch.clamp_min(den.abs(), 1.0)).to(dt)
        hblk = hblk.reshape(b, s, d_in) * silu(z)
        return torch.einsum("bse,ed->bsd", hblk, self.w_down.to(dt)), \
            new_cache


def mlstm_cache_init(cfg: ModelConfig, batch: int, dtype, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    dh = d_in // cfg.num_heads
    return {"state": torch.zeros((batch, cfg.num_heads, dh, dh + 1),
                                 dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, a host loop over time
# ---------------------------------------------------------------------------

class SLSTM(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d, h = cfg.d_model, cfg.num_heads
        dh = d // h
        self.w_gates = common.dense_init(generator, (d, 4 * d), pd, device)
        self.r_gates = common.dense_init(generator, (h, dh, 4 * dh), pd,
                                         device)
        self.b_gates = common.const_param(0.0, (4 * d,), cfg, device)
        self.w_out = common.dense_init(generator, (d, d), pd, device)

    def forward(self, x, cfg: ModelConfig, *, cache=None):
        """The cache is the carry (c, n, h, m), each (B,H,dh) f32."""
        dt = cfg.compute_dtype
        b, s, d = x.shape
        h = cfg.num_heads
        dh = d // h
        wx = (torch.einsum("bsd,de->bse", x, self.w_gates.to(dt))
              + self.b_gates.to(dt))
        if isinstance(wx, DTensor):
            # its gates dim whole before the split into heads (a 16-wide
            # shard of 4·d cannot split into 4 heads), as batch_local
            # gathers it next anyway
            wx = wx.redistribute(wx.device_mesh, [
                Replicate() if p == Shard(2) else p for p in wx.placements])
        wx = wx.reshape(b, s, h, 4 * dh)
        carry = cache["carry"] if cache is not None else (None,) * 4
        y, *carry = batch_local(_slstm_scan, wx, *carry,
                                whole=(self.r_gates.float(),))
        out = torch.einsum("bsd,de->bse", y.to(dt), self.w_out.to(dt))
        new_cache = {"carry": tuple(carry)} if cache is not None else None
        return out, new_cache


def _slstm_scan(wx, c_, n_, h_, m_, r):
    """sLSTM's recurrence over time: wx (B,S,H,4dh) the input gates, the
    carry (c, n, h, m) (each (B,H,dh) f32, or None: zeros), r (H,dh,4dh)
    f32.  Returns (y (B,S,H·dh) f32, c, n, h, m)."""
    b, s, h, dh4 = wx.shape
    if c_ is None:
        z = torch.zeros((b, h, dh4 // 4), dtype=torch.float32,
                        device=wx.device)
        c_, n_, h_, m_ = z, z, z, z
    hs = []
    for t in range(s):
        g = wx[:, t].float() + torch.einsum("bhd,hde->bhe", h_, r)
        it, ft, zt, ot = g.chunk(4, dim=-1)
        lf = log_sigmoid(ft)
        m_new = torch.maximum(lf + m_, it)
        i = torch.exp(it - m_new)
        f = torch.exp(lf + m_ - m_new)
        c_ = f * c_ + i * torch.tanh(zt)
        n_ = f * n_ + i
        h_ = torch.sigmoid(ot) * c_ / torch.clamp_min(n_, 1e-6)
        m_ = m_new
        hs.append(h_)
    return torch.stack(hs, dim=1).reshape(b, s, -1), c_, n_, h_, m_


def slstm_cache_init(cfg: ModelConfig, batch: int, dtype, device=None):
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    return {"carry": tuple(torch.zeros(shape, dtype=torch.float32,
                                       device=device) for _ in range(4))}


# ---------------------------------------------------------------------------
# Mamba2 (SSD) block
# ---------------------------------------------------------------------------

MAMBA_HEAD_DIM = 64   # Mamba2's default head dim; nh = d_in // 64


def causal_conv(x, w, b, cache=None):
    """x: (B,S,C); w: (W,C) depthwise; the W taps summed in order.
    Returns (y, the last W − 1 inputs)."""
    width = w.shape[0]
    if cache is None:
        xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    return y, (xp[:, -(width - 1):] if width > 1 else None)


class Mamba2(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device=None):
        super().__init__()
        pd = cfg.param_dtype
        d = cfg.d_model
        d_in = cfg.ssm_expand * d
        st = cfg.ssm_state
        nh = d_in // MAMBA_HEAD_DIM
        conv_dim = d_in + 2 * st
        self.w_in = common.dense_init(generator, (d, 2 * d_in + 2 * st + nh),
                                      pd, device)
        self.conv_w = common.dense_init(generator, (cfg.conv_width, conv_dim),
                                        pd, device, scale=0.5)
        self.conv_b = common.const_param(0.0, (conv_dim,), cfg, device)
        self.a_log = common.const_param(0.0, (nh,), cfg, device)  # A=−e^a
        self.dt_bias = common.const_param(0.0, (nh,), cfg, device)
        self.d_skip = common.const_param(1.0, (nh,), cfg, device)
        self.out_norm = torch.nn.ParameterDict(
            {"scale": common.const_param(1.0, (d_in,), cfg, device)})
        self.w_out = common.dense_init(generator, (d_in, d), pd, device)

    def forward(self, x, cfg: ModelConfig, *, cache=None):
        dt_ = cfg.compute_dtype
        b, s, d = x.shape
        d_in = cfg.ssm_expand * d
        st = cfg.ssm_state
        nh = d_in // MAMBA_HEAD_DIM
        proj = torch.einsum("bsd,de->bse", x, self.w_in.to(dt_))
        z, xbc_dt = proj[..., :d_in], proj[..., d_in:]
        xbc, dt_raw = xbc_dt[..., :d_in + 2 * st], xbc_dt[..., d_in + 2 * st:]
        xbc, new_conv = batch_local(
            lambda x_, c_, w_, b_: causal_conv(x_, w_, b_, c_), xbc,
            cache["conv"] if cache else None,
            whole=(self.conv_w.to(dt_), self.conv_b.to(dt_)))
        xbc = silu(xbc)
        xs, b_in, c_in = (xbc[..., :d_in], xbc[..., d_in:d_in + st],
                          xbc[..., d_in + st:])
        dt_act = softplus(dt_raw.float() + self.dt_bias.float())
        a = -torch.exp(self.a_log.float())
        log_f = (dt_act * a).to(dt_)                        # (b,s,nh) ≤ 0
        xh = xs.reshape(b, s, nh, MAMBA_HEAD_DIM)
        v = xh * dt_act[..., None].to(dt_)
        k = b_in[:, :, None, :].expand(b, s, nh, st)
        q = c_in[:, :, None, :].expand(b, s, nh, st)
        if cache is None:
            y, _ = batch_local(gla_chunked, q, k, v, log_f)
            new_cache = None
        elif s == 1:
            S_new, y = batch_local(gla_decode_step, cache["state"], q, k, v,
                                   log_f)
            new_cache = {"state": S_new, "conv": new_conv}
        else:
            y, S = batch_local(gla_chunked, q, k, v, log_f)
            new_cache = {"state": S, "conv": new_conv}
        y = y + xh * self.d_skip.to(dt_)[None, None, :, None]
        y = y.reshape(b, s, d_in) * silu(z)
        y = common.rms(self.out_norm["scale"], y)
        return torch.einsum("bse,ed->bsd", y, self.w_out.to(dt_)), new_cache


def mamba2_cache_init(cfg: ModelConfig, batch: int, dtype, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // MAMBA_HEAD_DIM
    return {"state": torch.zeros((batch, nh, cfg.ssm_state, MAMBA_HEAD_DIM),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1,
                                 d_in + 2 * cfg.ssm_state),
                                dtype=common.torch_dtype(dtype),
                                device=device)}
