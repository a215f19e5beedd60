"""What the drivers share: the device, the inputs drawn from the seed, and
the solver settings a cell runs, read from its configuration and mix."""
from __future__ import annotations

import dataclasses
import random

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class Cell:
    """One cell as the harness resolved it: its name, its configuration
    file's contents, its mix's and its limits."""

    name: str
    config: dict
    traffic: dict
    limits: dict

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config["dtype"]]

    def solver(self) -> dict:
        """The solver settings: the configuration's, then the mix's
        overrides (caps and tolerances a mix serves under)."""
        return {**self.config["solver"], **self.traffic.get("solver", {})}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    """The most bytes the caching allocator held for tensors since the last
    reset (0 on the CPU, which has no such counter)."""
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def marginals(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """Positive measures along the last axis of ``shape``: uniform draws
    plus 0.05, normalised (every point keeps mass)."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device) + 0.05
    return u / u.sum(dim=-1, keepdim=True)


def rng(seed: int, salt: str) -> random.Random:
    """A host generator for choices drawn from the seed (which solve or
    request is checked), apart from the inputs' generator."""
    return random.Random(f"{salt}:{seed}")


def grid(kind: str, n: int, k: int):
    """The program's grid of ``kind`` with n points a side, spacing
    1/(n − 1)."""
    from repro_torch.core import Grid1D, Grid2D
    cls = {"Grid1D": Grid1D, "Grid2D": Grid2D}[kind]
    return cls(n, 1.0 / (n - 1), k)


def size_of(kind: str, n: int) -> int:
    return n if kind == "Grid1D" else n * n
