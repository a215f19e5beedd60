"""Geometry interface: one gradient engine over grid (FGC) and dense costs.

Reference: ``repro/core/geometry.py`` (the ``Geometry`` base,
``GridGeometry``, ``DenseGeometry`` and ``as_geometry``; the point-cloud and
low-rank geometries belong to the batching slice and are not ported yet).

What every GW solver needs from a metric space is "apply my (elementwise
powered) distance matrix to a batch of vectors fast":

  size                  number of support points N
  spec                  hashable identity (class, shape, static params)
  apply_dist(x, axis, power_mult)
                        y = D^{⊙power_mult} ·_axis x  (power_mult=2 gives the
                        squared-distance apply of the C1 term), contracting
                        against D's second index along every axis
  dist_matrix(power_mult, dtype, device)
                        the dense matrix (oracle / dense fallback)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.grids import Grid1D, Grid2D


def _matrix_apply(mat, x, axis):
    """y = mat ·_axis x for a dense (N, N) matrix."""
    axis = axis % x.dim()
    y = torch.tensordot(mat, torch.movedim(x, axis, 0), dims=1)
    return torch.movedim(y, 0, axis)


def _ones_apply(x, axis):
    """D^{⊙0} = J (all-ones): matches fgc.apply_abs_power's 0^0 := 1."""
    return x.sum(dim=axis, keepdim=True) * torch.ones_like(x)


def _powered(d, power_mult: int):
    """D^{⊙p} for a materialized matrix (p=0 → J, p=1 → D unchanged)."""
    if power_mult == 0:
        return torch.ones_like(d)
    return d if power_mult == 1 else d ** power_mult


class Geometry:
    """Interface base — see the module docstring."""

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def spec(self) -> tuple:
        raise NotImplementedError

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1):
        """Default: the dense fallback through dist_matrix."""
        if power_mult == 0:
            return _ones_apply(x, axis % x.dim())
        return _matrix_apply(self.dist_matrix(power_mult, x.dtype, x.device),
                             x, axis)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        raise NotImplementedError

    def materialize(self) -> "Geometry":
        """An equivalent geometry whose apply builds no matrix per call."""
        return self


#: FGC implementations a raw grid may be adapted with ("dense" is the
#: explicit-matrix oracle).
GRID_BACKENDS = ("scan", "cumsum", "blocked", "kernel", "dense")


def as_geometry(obj, backend: str = "cumsum") -> Geometry:
    """Grid1D/Grid2D become GridGeometry with the given FGC backend;
    Geometry instances pass through unchanged."""
    if isinstance(obj, Geometry):
        return obj
    if isinstance(obj, (Grid1D, Grid2D)):
        if backend not in GRID_BACKENDS:
            raise ValueError(f"unknown grid backend {backend!r}: expected "
                             f"one of {GRID_BACKENDS}")
        return GridGeometry(obj, backend)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a Geometry")


@dataclasses.dataclass(frozen=True)
class GridGeometry(Geometry):
    """Uniform-grid metric (the paper's structure): FGC applies in O(k²N).

    ``backend`` selects the FGC implementation (scan|cumsum|blocked|kernel)
    or the dense oracle ("dense" multiplies by the explicit matrix).
    """

    grid: Grid1D | Grid2D
    backend: str = "cumsum"

    @property
    def size(self) -> int:
        return self.grid.size

    @property
    def spec(self) -> tuple:
        g = self.grid
        return ("grid", type(g).__name__, g.n, g.k, self.backend)

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1):
        if self.backend == "dense":
            return Geometry.apply_dist(self, x, axis, power_mult)
        return self.grid.apply_dist(x, axis=axis, power_mult=power_mult,
                                    backend=self.backend)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        return self.grid.dist_matrix(power_mult, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class DenseGeometry(Geometry):
    """An explicit (N, N) cost matrix."""

    cost: torch.Tensor

    def __post_init__(self):
        if self.cost.dim() != 2 or self.cost.shape[0] != self.cost.shape[1]:
            raise ValueError("cost must be square (N, N)")

    @property
    def size(self) -> int:
        return self.cost.shape[0]

    @property
    def spec(self) -> tuple:
        return ("dense", self.size)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        d = self.cost.to(dtype=dtype, device=device)
        return _powered(d, power_mult)
