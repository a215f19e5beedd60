"""Geometry interface: one gradient engine over grid (FGC), low-rank,
point-cloud and dense costs.

Reference: ``repro/core/geometry.py`` (the ``Geometry`` base,
``GridGeometry``, ``LowRankGeometry``, ``PointCloudGeometry``,
``DenseGeometry`` and ``as_geometry``; zero-mass padding, ``pad_to``,
belongs to the batching slice and is not ported yet).

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
  cost_rank             rank of a factored cost, or None (unfactored)
  for_factored_plan(cost_rank)
                        the geometry a factored-plan solve holds: one whose
                        apply on (N, r) factor batches builds no (N, N)
                        matrix (point clouds convert to their factors)
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

    @property
    def cost_rank(self):
        """Rank of the factored cost, or None when the apply is unfactored
        (dense or grid-structured)."""
        return None

    def for_factored_plan(self, cost_rank: int | None = None) -> "Geometry":
        """The geometry a factored-plan solve should hold.  Grids, low-rank
        factors and dense matrices already are that and return themselves;
        point clouds convert to their factored cost.  ``cost_rank`` is the
        explicit factorization rank (None keeps exact factorizations
        exact)."""
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


def _khatri_rao_power(m, p: int):
    """Row-wise Kronecker p-th power: out[i] = m[i] ⊗ ... ⊗ m[i] (p times),
    so (A Bᵀ)^{⊙p} = Ap Bpᵀ, a rank-r^p factorization."""
    n = m.shape[0]
    out = m
    for _ in range(p - 1):
        out = (out[:, :, None] * m[:, None, :]).reshape(n, -1)
    return out


@dataclasses.dataclass(frozen=True)
class LowRankGeometry(Geometry):
    """Factored cost D = A Bᵀ (A, B: (N, r)): O(N·r) applies.
    ``power_mult=p`` uses the Khatri-Rao power factors (rank r^p).  D should
    be symmetric for the GW gradient formulas; the factors need not be
    equal."""

    a: torch.Tensor
    b: torch.Tensor

    def __post_init__(self):
        if self.a.dim() != 2 or self.a.shape != self.b.shape:
            raise ValueError(
                f"factors must be matching (N, r): {tuple(self.a.shape)} vs "
                f"{tuple(self.b.shape)}")

    @property
    def size(self) -> int:
        return self.a.shape[0]

    @property
    def rank(self) -> int:
        return self.a.shape[1]

    @property
    def cost_rank(self):
        return self.rank

    @property
    def spec(self) -> tuple:
        return ("lowrank", self.size, self.rank)

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1):
        if power_mult == 0:
            return _ones_apply(x, axis % x.dim())
        # promote instead of casting the factors to x's dtype: f64 factors
        # under an f32 operand keep their precision (the reference's rule)
        dt = torch.promote_types(self.a.dtype, x.dtype)
        ap = _khatri_rao_power(self.a, power_mult).to(dt)
        bp = _khatri_rao_power(self.b, power_mult).to(dt)
        axis = axis % x.dim()
        x2 = torch.movedim(x, axis, 0).to(dt)
        y2 = torch.tensordot(ap, torch.tensordot(bp.T, x2, dims=1), dims=1)
        return torch.movedim(y2, 0, axis)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        d = (self.a @ self.b.T).to(dtype=dtype, device=device)
        return _powered(d, power_mult)


@dataclasses.dataclass(frozen=True)
class PointCloudGeometry(Geometry):
    """Raw points (N, d) with the pairwise metric sqeuclidean|euclidean.
    The apply is dense O(N²); `to_low_rank` trades it for the O(N·r)
    factored apply (exact at rank d+2 for squared Euclidean, truncated SVD
    otherwise)."""

    points: torch.Tensor
    metric: str = "sqeuclidean"

    def __post_init__(self):
        if self.metric not in ("sqeuclidean", "euclidean"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.points.dim() != 2:
            raise ValueError("points must be (N, d)")

    @property
    def size(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def spec(self) -> tuple:
        return ("pointcloud", self.size, self.dim, self.metric)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        pts = self.points.to(dtype=dtype, device=device)
        sq = (pts ** 2).sum(dim=1)
        d = (sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)).clamp_min(0.0)
        if self.metric == "euclidean":
            d = torch.sqrt(d)
        return _powered(d, power_mult)

    def materialize(self) -> "DenseGeometry":
        # solvers apply the cost inside loops: build the matrix once
        return DenseGeometry(self.dist_matrix(dtype=self.points.dtype,
                                              device=self.points.device))

    def for_factored_plan(self, cost_rank: int | None = None):
        """A factored-plan solve must not materialize the (N, N) matrix it
        exists to avoid: convert to the factored cost (`to_low_rank`)."""
        return self.to_low_rank(cost_rank)

    def to_low_rank(self, r: int | None = None) -> LowRankGeometry:
        """Factor D ≈ A Bᵀ.  Squared Euclidean with ``r=None`` uses the
        exact rank-(d+2) identity
            ‖x_i−x_j‖² = [‖x_i‖², 1, −2x_i] · [1, ‖x_j‖², x_j]ᵀ
        on centred points; otherwise a truncated SVD of the dense matrix,
        taken in float64 and rounded to the points' dtype (rank r
        required)."""
        if self.metric == "sqeuclidean" and r is None:
            # ‖x−y‖² is translation-invariant, and small ‖x‖² keeps the f32
            # cancellation in sq_i + sq_j − 2⟨x_i, x_j⟩ small
            pts = self.points - self.points.mean(dim=0, keepdim=True)
            sq = (pts ** 2).sum(dim=1, keepdim=True)
            one = torch.ones_like(sq)
            return LowRankGeometry(torch.cat([sq, one, -2.0 * pts], dim=1),
                                   torch.cat([one, sq, pts], dim=1))
        if r is None:
            raise ValueError("euclidean to_low_rank requires an explicit r")
        u, s, vt = torch.linalg.svd(
            self.dist_matrix(device=self.points.device), full_matrices=False)
        root = torch.sqrt(s[:r])
        dt = self.points.dtype
        return LowRankGeometry((u[:, :r] * root[None, :]).to(dt),
                               (vt[:r].T * root[None, :]).to(dt))


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
