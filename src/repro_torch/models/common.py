"""Shared model machinery: config, norms, RoPE variants, init.

Reference: ``repro/models/common.py``.  The config holds the same fields
and properties (``compute_dtype`` is a `torch.dtype`); norms always run in
f32 and cast back; RoPE rotates the two halves of the head dimension, with
f32 frequencies and angles.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name) -> torch.dtype:
    """The `torch.dtype` of a dtype name ("bfloat16") or of a dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[str(name)]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    # layer-stack structure: prologue + template × repeats
    block_template: tuple = ("attn_mlp",)
    prologue: tuple = ()
    shared_slots: tuple = ()       # template slots whose params are shared
    # attention
    rope_theta: float = 1e4
    m_rope: bool = False           # qwen2-vl 3-section multimodal RoPE
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm | layernorm_nonparam
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # MLA (deepseek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    conv_width: int = 4
    # i/o
    input_mode: str = "tokens"     # tokens | embeddings (vlm/audio stubs)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def repeats(self) -> int:
        body = self.num_layers - len(self.prologue)
        if body % len(self.block_template):
            raise ValueError(f"{self.name}: {body} layers not divisible by "
                             f"template {self.block_template}")
        return body // len(self.block_template)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def sub_quadratic(self) -> bool:
        """True if every layer kind avoids O(S²) state at decode."""
        kinds = set(self.prologue) | set(self.block_template)
        quad = {"attn_mlp", "attn_moe", "mla_mlp", "mla_moe"}
        return not (kinds & quad) or self.sliding_window is not None


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_params(cfg: ModelConfig, dim: int, device=None) -> torch.nn.ParameterDict:
    """The norm's parameters: ``scale`` (and ``bias`` for layernorm), none
    for olmo's non-parametric layernorm."""
    pd = torch_dtype(cfg.param_dtype)
    if cfg.norm == "rmsnorm":
        return torch.nn.ParameterDict(
            {"scale": torch.nn.Parameter(torch.ones(dim, dtype=pd,
                                                    device=device))})
    if cfg.norm == "layernorm":
        return torch.nn.ParameterDict({
            "scale": torch.nn.Parameter(torch.ones(dim, dtype=pd,
                                                   device=device)),
            "bias": torch.nn.Parameter(torch.zeros(dim, dtype=pd,
                                                   device=device))})
    return torch.nn.ParameterDict()


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-5):
    if cfg.norm == "rmsnorm":
        return rms(params["scale"], x, eps)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        xf = xf * params["scale"].float() + params["bias"].float()
    return xf.to(x.dtype)


def rms(scale, x, eps: float = 1e-5):
    """RMS norm in f32 with ``scale``, cast back to ``x``'s dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x, angles):
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_m_rope(x, positions_thw, theta: float, sections=(16, 24, 24)):
    """Qwen2-VL multimodal RoPE: positions (..., S, 3) = (t, h, w) ids; the
    frequency pairs are split into 3 sections (pair counts summing to
    hd//2), each rotated by its own id."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"sections {sections} do not sum to {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])
    pos = positions_thw.float()[..., sec]                    # (...,S,pairs)
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype, device=None,
               scale: float | None = None) -> torch.nn.Parameter:
    """Normal weights of std ``scale``, or shape[0]^-½ (the reference's
    rule, also for (e, d, ff) experts).  Drawn on the generator's device,
    then moved to ``device``; on the ``meta`` device nothing is drawn (a
    model whose parameters are loaded next, `repro_torch.convert`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.nn.Parameter(torch.empty(shape, device="meta",
                                              dtype=torch_dtype(dtype)))
    fan_in = shape[0] if len(shape) >= 1 else 1
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=generator.device)
    return torch.nn.Parameter((w * std).to(device=device,
                                              dtype=torch_dtype(dtype)))


def const_param(value: float, shape, cfg: ModelConfig, device=None):
    return torch.nn.Parameter(torch.full(shape, value,
                                         dtype=torch_dtype(cfg.param_dtype),
                                         device=device))
