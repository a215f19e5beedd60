"""Architecture registry: ``--arch <id>`` lookup for the 10 assigned archs.

Ported from ``repro.configs`` with the same numbers.  Each module exposes
``config()`` (the exact assigned hyperparameters) and ``smoke()`` (a
reduced same-family config for CPU tests)."""
from __future__ import annotations

from repro_torch.configs import (deepseek_v2_lite_16b, mixtral_8x22b,
                                 musicgen_medium, olmo_1b, phi3_mini_3p8b,
                                 qwen2_vl_72b, smollm_360m, starcoder2_15b,
                                 xlstm_350m, zamba2_7b)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable

_MODULES = {
    "smollm-360m": smollm_360m,
    "phi3-mini-3.8b": phi3_mini_3p8b,
    "starcoder2-15b": starcoder2_15b,
    "olmo-1b": olmo_1b,
    "qwen2-vl-72b": qwen2_vl_72b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "xlstm-350m": xlstm_350m,
    "musicgen-medium": musicgen_medium,
    "zamba2-7b": zamba2_7b,
}

ARCHS = tuple(_MODULES)


def get(name: str):
    """Full config for ``--arch <name>``."""
    return _MODULES[name].config()


def get_smoke(name: str):
    return _MODULES[name].smoke()


__all__ = ["ARCHS", "get", "get_smoke", "SHAPES", "ShapeSpec", "applicable"]
