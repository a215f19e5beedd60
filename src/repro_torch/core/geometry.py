"""Geometry interface: one gradient engine over grid (FGC), low-rank,
point-cloud and dense costs.

Reference: ``repro/core/geometry.py`` (the ``Geometry`` base,
``GridGeometry``, ``LowRankGeometry``, ``PointCloudGeometry``,
``DenseGeometry`` and ``as_geometry``, with the batch's zero-mass padding:
``pad_to``, ``paddable``, ``spec_unsized`` and ``batch_key``).

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
  pad_to(n)             the same geometry embedded in n points; the extra
                        points carry zero mass downstream (exact)
  batch_key()           spec minus the size a batch may pad: problems with
                        one batch_key a side can share a batch

A batch holds each side as a `StackedGeometry` (`stack`): B geometries of
one class, size and static params with their data lane-leading (h per
lane for grids, factors (B, N, c), points (B, N, d), costs (B, N, N)),
whose ``apply_dist`` takes a lane-leading (B, ...) x and contracts each
lane with its own geometry, in one call for all lanes.  The reference
stacks pytrees leaf-wise under ``vmap``; this is that stack held by hand.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.grids import Grid1D, Grid2D, apply_dist_lanes


def per_lane(fn, *xs):
    """``fn`` over lane-leading tensors, with each lane's result the bits
    that ``fn`` gives that lane as a batch of one.

    On a CUDA device ``fn`` runs once a lane, on the lane's one-lane
    slices: PyTorch's reductions over a long axis and cuBLAS's products
    with a thin output split their work by the whole batch's size, so on
    an H100 a sum over 10⁵ rows, a (B, 5, 16)·(B, 16, 16) product, an
    einsum over the lanes or a matrix-column product rounds a lane
    otherwise at 16 lanes than alone.  The serving engine's lanes change
    width as it refills and repacks, and each must keep its bits.

    On the CPU, one call for the batch: its reductions and products are
    lane-invariant already, and they round as the reference's batched
    ones do.  One call a lane there moves a factor entry of
    tests/test_torch_serve_continuous.py::
    test_lowrank_stream_continuous_equals_barrier 1.5e-10 relative off
    the reference's, past that test's rtol of 1e-10."""
    lanes = xs[0].shape[0]
    if not xs[0].is_cuda or lanes == 1:
        return fn(*xs)
    return torch.cat([fn(*(x[i:i + 1] for x in xs)) for i in range(lanes)])


def lane_l1(t):
    """Each lane's L1 mass, over every axis but the lane's."""
    return t.abs().sum(dim=tuple(range(1, t.dim())))


#: an output with at most this many rows or columns is thin (`_lanes_mm`)
_THIN = 32


def _lanes_mm(a, b):
    """a_b @ b_b for each lane, with bits that do not depend on how many
    lanes share the call: a product with a thin output (at most ``_THIN``
    rows or columns) runs through `per_lane`.  Wider products stay one
    batched product: they keep a lane's bits at any batch count (held on
    the card by tests/test_torch_cuda.py at the main path's shapes), and
    one product a lane cost Run N(c)'s 32-lane dense grid method about a
    third more (tools/lane_products_ab.py)."""
    if min(a.shape[-2], b.shape[-1]) <= _THIN:
        return per_lane(torch.matmul, a, b)
    return a @ b


def _matrix_apply(mat, x, axis):
    """y_b = mat_b ·_axis x_b for (B, N, N) matrices and a lane-leading x."""
    axis = axis % x.dim()
    x2 = torch.movedim(x, axis, 1)
    shape = x2.shape
    y = _lanes_mm(mat, x2.reshape(shape[0], shape[1], -1))
    return torch.movedim(y.reshape(shape), 1, axis)


def _ones_apply(x, axis):
    """D^{⊙0} = J (all-ones): matches fgc.apply_abs_power's 0^0 := 1."""
    return x.sum(dim=axis, keepdim=True) * torch.ones_like(x)


def _khatri_rao_power(m, p: int):
    """Row-wise Kronecker p-th power of each lane of a (B, N, c) factor:
    out[b, i] = m[b, i] ⊗ ... ⊗ m[b, i] (p times), so (A Bᵀ)^{⊙p} =
    Ap Bpᵀ, a rank-c^p factorization."""
    lanes, n = m.shape[:2]
    out = m
    for _ in range(p - 1):
        out = (out[:, :, :, None] * m[:, :, None, :]).reshape(lanes, n, -1)
    return out


def _pad_rows(t, n: int):
    """``t`` with zero rows appended up to ``n`` rows."""
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[0]))


def _powered(d, power_mult: int):
    """D^{⊙p} for a materialized matrix (p=0 → J, p=1 → D unchanged)."""
    if power_mult == 0:
        return torch.ones_like(d)
    return d if power_mult == 1 else d ** power_mult


class Geometry:
    """Interface base — see the module docstring."""

    #: zero-mass padding to a larger size is exact for this geometry
    paddable: bool = True

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def spec(self) -> tuple:
        raise NotImplementedError

    def spec_unsized(self) -> tuple:
        raise NotImplementedError

    def batch_key(self) -> tuple:
        """`spec` minus the size a batch may pad: problems sharing a
        batch_key a side can share a batch."""
        return self.spec if not self.paddable else self.spec_unsized()

    def pad_to(self, n: int) -> "Geometry":
        """This geometry embedded in ``n`` points; the extra points carry
        zero mass downstream, which the solvers treat exactly."""
        raise NotImplementedError

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1):
        """The apply of this geometry's stack of one (`stack`): each
        geometry's apply has one home, its stacked form's."""
        return stack([self]).apply_dist(x[None], axis % x.dim() + 1,
                                        power_mult)[0]

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
    Geometry (and StackedGeometry) instances pass through unchanged."""
    if isinstance(obj, (Geometry, StackedGeometry)):
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

    def spec_unsized(self) -> tuple:
        g = self.grid
        return ("grid", type(g).__name__, g.k, self.backend)

    @property
    def paddable(self) -> bool:
        # Grid2D's Kronecker unfolding owns the grid axis: zero-padding the
        # flattened axis is not expressible, so 2D batches are equal-sized
        return isinstance(self.grid, Grid1D)

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        return self.grid.dist_matrix(power_mult, dtype=dtype, device=device)

    def pad_to(self, n: int) -> "GridGeometry":
        g = self.grid
        if n == g.size:
            return self
        if not isinstance(g, Grid1D):
            raise ValueError("Grid2D geometries cannot be padded")
        return GridGeometry(Grid1D(n, g.h, g.k), self.backend)


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

    def spec_unsized(self) -> tuple:
        return ("lowrank", self.rank)

    def pad_to(self, n: int) -> "LowRankGeometry":
        if n == self.size:
            return self
        return LowRankGeometry(_pad_rows(self.a, n), _pad_rows(self.b, n))

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

    def spec_unsized(self) -> tuple:
        return ("pointcloud", self.dim, self.metric)

    def pad_to(self, n: int) -> "PointCloudGeometry":
        if n == self.size:
            return self
        return PointCloudGeometry(_pad_rows(self.points, n), self.metric)

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

    def spec_unsized(self) -> tuple:
        return ("dense",)

    def pad_to(self, n: int) -> "DenseGeometry":
        if n == self.size:
            return self
        p = n - self.size
        return DenseGeometry(torch.nn.functional.pad(self.cost, (0, p, 0, p)))

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        d = self.cost.to(dtype=dtype, device=device)
        return _powered(d, power_mult)


# ---------------------------------------------------------------------------
# stacked (lane-leading) geometries: what a batch solve holds
# ---------------------------------------------------------------------------

class StackedGeometry:
    """B geometries of one class, one size and one set of static params,
    their data lane-leading.  ``apply_dist(x, axis, power_mult)`` takes a
    lane-leading (B, ...) x, ``axis`` ≥ 1, and contracts lane b with
    geometry b; ``dist_matrix`` is (B, N, N); ``lane(b)`` is geometry b
    alone."""

    @property
    def lanes(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def cost_rank(self):
        return None

    def lane(self, b: int) -> Geometry:
        raise NotImplementedError

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        return torch.stack([self.lane(b).dist_matrix(power_mult, dtype,
                                                     device)
                            for b in range(self.lanes)])

    def apply_dist(self, x, axis: int = 1, power_mult: int = 1):
        """Default: the dense fallback through dist_matrix."""
        if power_mult == 0:
            return _ones_apply(x, axis % x.dim())
        return _matrix_apply(
            self.dist_matrix(power_mult, x.dtype, x.device), x, axis)

    def materialize(self) -> "StackedGeometry":
        return self


@dataclasses.dataclass(frozen=True)
class GridStack(StackedGeometry):
    """Uniform grids of one class, n and k, one spacing h a lane: one FGC
    apply serves every lane (`grids.apply_dist_lanes`)."""

    grids: tuple
    backend: str = "cumsum"

    @property
    def lanes(self) -> int:
        return len(self.grids)

    @property
    def size(self) -> int:
        return self.grids[0].size

    def lane(self, b: int) -> GridGeometry:
        return GridGeometry(self.grids[b], self.backend)

    def apply_dist(self, x, axis: int = 1, power_mult: int = 1):
        if self.backend == "dense":
            return StackedGeometry.apply_dist(self, x, axis, power_mult)
        return apply_dist_lanes(self.grids, x, axis, power_mult,
                                self.backend)


@dataclasses.dataclass(frozen=True)
class LowRankStack(StackedGeometry):
    """Factored costs D_b = A_b B_bᵀ, factors (B, N, c)."""

    a: torch.Tensor
    b: torch.Tensor

    @property
    def lanes(self) -> int:
        return self.a.shape[0]

    @property
    def size(self) -> int:
        return self.a.shape[1]

    @property
    def cost_rank(self):
        return self.a.shape[2]

    def lane(self, b: int) -> LowRankGeometry:
        return LowRankGeometry(self.a[b], self.b[b])

    def apply_dist(self, x, axis: int = 1, power_mult: int = 1):
        if power_mult == 0:
            return _ones_apply(x, axis % x.dim())
        # promote instead of casting the factors to x's dtype: f64 factors
        # under an f32 operand keep their precision (the reference's rule)
        dt = torch.promote_types(self.a.dtype, x.dtype)
        ap = _khatri_rao_power(self.a, power_mult).to(dt)
        bp = _khatri_rao_power(self.b, power_mult).to(dt)
        axis = axis % x.dim()
        x2 = torch.movedim(x, axis, 1).to(dt)
        shape = x2.shape
        x3 = x2.reshape(shape[0], shape[1], -1)
        y = _lanes_mm(ap, _lanes_mm(bp.transpose(1, 2), x3))
        return torch.movedim(y.reshape(shape), 1, axis)


@dataclasses.dataclass(frozen=True)
class PointCloudStack(StackedGeometry):
    """Point clouds (B, N, d) of one metric; the solvers hold their
    materialized costs."""

    points: torch.Tensor
    metric: str = "sqeuclidean"

    @property
    def lanes(self) -> int:
        return self.points.shape[0]

    @property
    def size(self) -> int:
        return self.points.shape[1]

    def lane(self, b: int) -> PointCloudGeometry:
        return PointCloudGeometry(self.points[b], self.metric)

    def materialize(self) -> "DenseStack":
        return DenseStack(self.dist_matrix(dtype=self.points.dtype,
                                           device=self.points.device))


@dataclasses.dataclass(frozen=True)
class DenseStack(StackedGeometry):
    """Explicit costs (B, N, N)."""

    cost: torch.Tensor

    @property
    def lanes(self) -> int:
        return self.cost.shape[0]

    @property
    def size(self) -> int:
        return self.cost.shape[1]

    def lane(self, b: int) -> DenseGeometry:
        return DenseGeometry(self.cost[b])

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        return _powered(self.cost.to(dtype=dtype, device=device),
                        power_mult)


def stack_lanes(ts):
    """Tensors of one shape stacked lane-leading; one tensor becomes a view
    with a lane axis of one, no copy (a 10⁶-point factor is 40 MB)."""
    return ts[0][None] if len(ts) == 1 else torch.stack(ts)


def stack(geoms) -> StackedGeometry:
    """Equal-sized geometries of one batch_key, stacked lane-leading (their
    data keeps its own dtype)."""
    g0 = geoms[0]
    if len({g.batch_key() for g in geoms}) != 1 or \
            len({g.size for g in geoms}) != 1:
        raise ValueError("stack takes equal-sized geometries of one "
                         "batch_key")
    if isinstance(g0, GridGeometry):
        return GridStack(tuple(g.grid for g in geoms), g0.backend)
    if isinstance(g0, LowRankGeometry):
        return LowRankStack(stack_lanes([g.a for g in geoms]),
                            stack_lanes([g.b for g in geoms]))
    if isinstance(g0, PointCloudGeometry):
        return PointCloudStack(stack_lanes([g.points for g in geoms]),
                               g0.metric)
    if isinstance(g0, DenseGeometry):
        return DenseStack(stack_lanes([g.cost for g in geoms]))
    raise TypeError(f"cannot stack {type(g0).__name__}")
