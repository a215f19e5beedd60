"""Published peaks of the card, by device name.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit.  A card set below it runs slower under load; every run
prints the card's ``power.limit`` beside its numbers (`run.card_line`).
"""
from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {
        "float64": 34e12,      # vector units; the f64 tensor cores are 67
        "float32": 67e12,      # outside the tensor cores
        "tf32": 495e12,
        "bfloat16": 989e12,
    },
}

#: device-name fragment -> peaks; the first match wins
TABLE = (("H100", H100_SXM),)


def for_device(name: str) -> dict | None:
    """The peaks of the card called ``name``, or None for a card the table
    does not hold (a share of its peak is then not reported)."""
    for frag, peaks in TABLE:
        if frag in name:
            return peaks
    return None


def least_seconds(flops: float, nbytes: float, peaks: dict,
                  dtype: str = "float32") -> float:
    """The least time the card needs for this work: the larger of the
    operations over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / peaks["flops_per_s"][dtype],
               nbytes / peaks["hbm_bytes_per_s"])
