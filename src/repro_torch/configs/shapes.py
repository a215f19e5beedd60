"""Assigned input shapes (LM family): every arch × shape cell of the
dry-run matrix. ``decode_*`` / ``long_*`` lower ``decode_step`` (one new
token against a seq_len KV cache), ``prefill_*`` lowers ``prefill``,
``train_*`` lowers ``train_step``."""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Skip rules from the assignment: long_500k needs sub-quadratic
    attention (run for SSM/hybrid/SWA archs, skip for pure full-attention).
    All assigned archs are decoder-only, so decode shapes always apply."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: long_500k skipped per "
                       "assignment (noted in DESIGN.md §long_500k)")
    return True, ""
