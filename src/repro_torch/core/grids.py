"""Uniform-grid geometries for FGC-GW.

Reference: ``repro/core/grids.py``.  Distance matrices on uniform grids
factor as ``D = h^k * D_tilde`` (1D, paper eq. 2.2) or the Kronecker-binomial
form ``D_hat`` (2D, eq. 3.10).  What the solvers need from a grid is

  * ``apply_dist(x, axis, power_mult, backend)`` — multiply by
    ``D^{⊙power_mult}`` along one tensor axis in O(k²·size), and
  * ``dist_matrix(power_mult, dtype, device)`` — the dense matrix (oracle).

``power_mult=2`` gives the elementwise-squared distances of the constant
term C1: (h^k |i-j|^k)² = h^{2k} |i-j|^{2k}.

The spacing ``h`` is a Python float, or a 0-d tensor when a gradient with
respect to it is wanted (`repro_torch.core.solver.fixed_point_value`):
h^p is then a tensor op, and a float's h^p stays a host float.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import fgc


@dataclasses.dataclass(frozen=True)
class Grid1D:
    """Uniform 1D grid of ``n`` points with spacing ``h`` (a float or a 0-d
    tensor); metric |x-x'|^k."""

    n: int
    h: float | torch.Tensor = 1.0
    k: int = 1

    @property
    def size(self) -> int:
        return self.n

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        p = self.k * power_mult
        idx = torch.arange(self.n, dtype=dtype, device=device)
        d = torch.abs(idx[:, None] - idx[None, :]) ** p
        return (self.h ** p) * d

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1,
                   backend: str = "cumsum"):
        """y = D^{⊙power_mult} ·_axis x  in O(k² n · batch)."""
        p = self.k * power_mult
        return (self.h ** p) * self.apply_unscaled(x, axis, power_mult,
                                                   backend)

    def apply_unscaled(self, x, axis: int = 0, power_mult: int = 1,
                       backend: str = "cumsum", lanes: int = 1):
        """D̃^{⊙power_mult} ·_axis x, the apply without its h^p; ``lanes``
        problems may sit side by side on x's leading axis."""
        return fgc.apply_abs_power(x, axis=axis, power=self.k * power_mult,
                                   backend=backend, lanes=lanes)


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Uniform n×n 2D grid, spacing ``h`` both ways; metric (|Δa|+|Δb|)^k.

    Flattening is row-major: index = a * n + b (paper's vec(), eq. 3.12).
    """

    n: int
    h: float | torch.Tensor = 1.0
    k: int = 1

    @property
    def size(self) -> int:
        return self.n * self.n

    def dist_matrix(self, power_mult: int = 1, dtype=torch.float64,
                    device=None):
        p = self.k * power_mult
        idx = torch.arange(self.n, dtype=dtype, device=device)
        d1 = torch.abs(idx[:, None] - idx[None, :])
        man = d1[:, None, :, None] + d1[None, :, None, :]  # (a,b,a',b')
        d = (man ** p).reshape(self.size, self.size)
        return (self.h ** p) * d

    def apply_dist(self, x, axis: int = 0, power_mult: int = 1,
                   backend: str = "cumsum"):
        """y = D̂^{⊙power_mult} ·_axis x  in O(k² n² · batch).

        ``x``'s ``axis`` has length n²; it is unfolded to two grid axes and
        the Kronecker-binomial expansion (paper eq. 3.12) is applied:
          D̂^{⊙P} = Σ_r C(P,r) D1^{⊙r} ⊗ D1^{⊙(P-r)}      (P = k·power_mult)
        """
        p = self.k * power_mult
        return (self.h ** p) * self.apply_unscaled(x, axis, power_mult,
                                                   backend)

    def apply_unscaled(self, x, axis: int = 0, power_mult: int = 1,
                       backend: str = "cumsum", lanes: int = 1):
        """The apply without its h^p; ``lanes`` problems may sit side by
        side on x's leading axis."""
        p = self.k * power_mult
        n = self.n
        axis = axis % x.dim()
        shape = tuple(x.shape)
        if shape[axis] != n * n:
            raise ValueError(f"axis {axis} of {shape} is not {n}²")
        unfolded = x.reshape(shape[:axis] + (n, n) + shape[axis + 1:])
        ax_a, ax_b = axis, axis + 1
        out = torch.zeros_like(unfolded)
        for r in range(p + 1):
            coeff = math.comb(p, r)
            term = fgc.apply_abs_power(unfolded, axis=ax_a, power=r,
                                       backend=backend, lanes=lanes)
            term = fgc.apply_abs_power(term, axis=ax_b, power=p - r,
                                       backend=backend, lanes=lanes)
            out = out + coeff * term
        return out.reshape(shape)


Grid = Grid1D | Grid2D


def apply_dist_lanes(grids, x, axis: int, power_mult: int = 1,
                     backend: str = "cumsum"):
    """y = D_b^{⊙power_mult} ·_axis x_b for the lanes b of a lane-leading x
    (``axis`` ≥ 1), one grid a lane; the grids share their class, n and k,
    and may differ in h.  One apply serves every lane (the kernel backend
    launches once, each lane with its own plan); a float h_b^p is taken on
    the host, as `Grid1D.apply_dist` takes it, a tensor h_b's in float64
    on its device, and only then is each rounded to x's dtype."""
    g0 = grids[0]
    if axis % x.dim() == 0:
        raise ValueError("axis 0 of a lane-leading x is the lane axis")
    p = g0.k * power_mult
    y = g0.apply_unscaled(x, axis, power_mult, backend, lanes=len(grids))
    if any(torch.is_tensor(g.h) for g in grids):
        scale = torch.stack([torch.as_tensor(g.h, dtype=torch.float64,
                                             device=y.device) ** p
                             for g in grids]).to(y.dtype)
    else:
        scale = torch.tensor([g.h ** p for g in grids], dtype=y.dtype,
                             device=y.device)
    return scale.reshape((-1,) + (1,) * (y.dim() - 1)) * y


def gw_product(grid_x: Grid, grid_y: Grid, gamma, backend: str = "cumsum"):
    """The paper's bottleneck term D_X Γ D_Y in O(k²·M·N).

    ``gamma``: (M, N) with M = grid_x.size, N = grid_y.size.
    """
    y = grid_x.apply_dist(gamma, axis=0, backend=backend)   # D_X Γ
    return grid_y.apply_dist(y, axis=1, backend=backend)     # (D_X Γ) D_Y


def gw_product_dense(grid_x: Grid, grid_y: Grid, gamma):
    """O(M²N + MN²) dense reference (the original entropic-GW product)."""
    dx = grid_x.dist_matrix(dtype=gamma.dtype, device=gamma.device)
    dy = grid_y.dist_matrix(dtype=gamma.dtype, device=gamma.device)
    return dx @ gamma @ dy
