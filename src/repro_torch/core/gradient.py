"""GW gradient operators: dense plan and factored plan.

Reference: ``repro/core/gradient.py`` (``GradientOperator``,
``LowRankGradientOperator`` and COOT's ``bilinear_product``).  A
mirror-descent cost is built from three pieces (paper §2-3):

  product(Γ)        the bottleneck term D_X Γ D_Y — O(k²MN) via FGC,
  constant_term     C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ),
  energy(Γ)         E(Γ) = Σ (d^X_ij − d^Y_pq)² γ_ip γ_jq via the three-term
                    expansion.

`bilinear_product` is the COOT generalization, X π Yᵀ, where either side
may be an unstructured data matrix.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Union

import torch

from repro_torch.core.geometry import (Geometry, LowRankStack,
                                       StackedGeometry, as_geometry,
                                       per_lane, stack)
from repro_torch.core.grids import Grid
from repro_torch.kernels import ops as kops

GeometryLike = Union[Geometry, Grid, StackedGeometry]


def bilinear_product(x, pi, y, grid_x: GeometryLike | None,
                     grid_y: GeometryLike | None, backend: str = "cumsum"):
    """X π Yᵀ with the structured fast apply on any geometry-backed side.

    ``x``/``y`` are dense data matrices, used only where the side's
    geometry is None (COOT's general case); a Grid or Geometry on a side
    switches that factor to its structured apply (on a grid with
    ``backend="kernel"``, the FGC kernel B3).  ``pi`` is one problem's
    (d, e) plan or lane-leading (B, d, e) plans; the data matrices are
    shared by the lanes.
    """
    if grid_x is not None:
        left = as_geometry(grid_x, backend).apply_dist(pi, axis=-2)  # X π
    else:
        left = x @ pi
    if grid_y is not None:
        return as_geometry(grid_y, backend).apply_dist(left, axis=-1)
    return left @ y.T


def _set_sides(op, gx, gy):
    """Hold both sides and their stacked forms: one problem's geometries
    are run as stacks of one, a batch's are stacked already."""
    solo = not isinstance(gx, StackedGeometry)
    if solo == isinstance(gy, StackedGeometry):
        raise ValueError("one side is a batch's stacked geometry and the "
                         "other one problem's")
    object.__setattr__(op, "geom_x", gx)
    object.__setattr__(op, "geom_y", gy)
    object.__setattr__(op, "_sx", stack([gx]) if solo else gx)
    object.__setattr__(op, "_sy", stack([gy]) if solo else gy)
    object.__setattr__(op, "_solo", solo)


class _LaneIO:
    """Shared by both operators: the pieces are lane-leading; an operator
    built on one problem's geometries takes and returns one problem's
    tensors."""

    @property
    def lanes(self) -> int | None:
        """A batch's lane count, None for one problem's operator."""
        return None if self._solo else self._sx.lanes

    def on_lanes(self):
        """This operator on lane-leading tensors: one problem's as a batch
        of one (its geometries' stacks of one), a batch's itself."""
        return dataclasses.replace(self, geom_x=self._sx, geom_y=self._sy) \
            if self._solo else self

    def _in(self, *ts):
        return tuple(t[None] if self._solo else t for t in ts)

    def _out(self, t):
        return t[0] if self._solo else t


@dataclasses.dataclass(frozen=True)
class GradientOperator(_LaneIO):
    """GW gradient pieces for a fixed geometry pair: one problem's
    geometries, or two `StackedGeometry` sides of a batch (every tensor then
    lane-leading, plans (B, M, N)).  ``backend`` selects the FGC
    implementation when a raw grid is passed; Geometry arguments carry
    their own."""

    geom_x: GeometryLike
    geom_y: GeometryLike
    backend: str = "cumsum"

    def __post_init__(self):
        _set_sides(self, *(as_geometry(g, self.backend).materialize()
                           for g in (self.geom_x, self.geom_y)))

    def _product(self, gamma):
        left = self._sx.apply_dist(gamma, axis=1)        # D_X Γ
        return self._sy.apply_dist(left, axis=2)         # (D_X Γ) D_Y

    def product(self, gamma):
        """D_X Γ D_Y — the paper's bottleneck term."""
        return self._out(self._product(*self._in(gamma)))

    def apply_sq_x(self, vec):
        """(D_X ∘ D_X) v: the same structure with power_mult=2."""
        return self._out(self._sx.apply_dist(*self._in(vec), axis=1,
                                             power_mult=2))

    def apply_sq_y(self, vec):
        return self._out(self._sy.apply_dist(*self._in(vec), axis=1,
                                             power_mult=2))

    def constant_term(self, mu, nu):
        """C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ).

        Returns (C1, (D_X∘D_X)μ, (D_Y∘D_Y)ν); the two vectors are reusable
        by energy() when Γ has the exact marginals (μ, ν).
        """
        dx2 = self.apply_sq_x(mu)
        dy2 = self.apply_sq_y(nu)
        return 2.0 * (dx2[..., :, None] + dy2[..., None, :]), dx2, dy2

    def grad(self, gamma, c1):
        """∇E(Γ) = C1 − 4·D_X Γ D_Y (paper eq. 2.4)."""
        return c1 - 4.0 * self.product(gamma)

    def energy(self, gamma, dx2_mu=None, dy2_nu=None):
        """E(Γ) via the three-term expansion (one value a lane).
        ``dx2_mu``/``dy2_nu``: optional (D∘D)-applies at Γ's marginals
        (valid when Γ is feasible for them)."""
        mu_g = gamma.sum(dim=-1)
        nu_g = gamma.sum(dim=-2)
        if dx2_mu is None:
            dx2_mu = self.apply_sq_x(mu_g)
        if dy2_nu is None:
            dy2_nu = self.apply_sq_y(nu_g)
        cross = (gamma * self.product(gamma)).sum(dim=(-2, -1))
        return ((mu_g * dx2_mu).sum(dim=-1) + (nu_g * dy2_nu).sum(dim=-1)
                - 2.0 * cross)


def _col_sums(t):
    """Each lane's sums over its rows (factor column sums, energies)."""
    return t.sum(dim=1)


#: diag(A diag(iq) B) and Σ_{k,l} iq_k A_kl iq_l B_lk, over lanes
_DIAG_AB = functools.partial(torch.einsum, "bkl,bl,blk->bk")
_CROSS_AB = functools.partial(torch.einsum, "bkl,bk,bl,blk->b")


@dataclasses.dataclass(frozen=True)
class LowRankGradientOperator(_LaneIO):
    """GW gradient pieces for a FACTORED plan P = Q diag(1/g) Rᵀ.

    The plan never exists: every quantity routes through the factors and
    the rank-r Gram matrices

        U = D_X Q,  V = D_Y R,   A = Qᵀ U,  B = Rᵀ V     (both (r, r)),

    so a gradient costs O((M+N)·r·c) with c the cost-apply width (k² for
    grids, the cost rank for factored costs).  Point clouds are converted
    to their factored cost (`Geometry.for_factored_plan`), never
    materialized.  As `GradientOperator`, it takes one problem's
    geometries or two stacked sides of a batch (factors then (B, N, r));
    on a batch its sums over the rows and its small products run through
    `geometry.per_lane`, so a lane's bits do not depend on the batch's
    width.

    Gradients at the feasible point (iq = 1/g, dx2 = (D_X∘D_X)μ,
    dy2 = (D_Y∘D_Y)ν, sQ/sR the factor column sums, tQ = Qᵀdx2,
    tR = Rᵀdy2):

        ∇_Q = iq ⊙ (2(dx2 sRᵀ + 1 tRᵀ) − 4·D_X (Q diag(iq)) B)
        ∇_R = iq ⊙ (2(dy2 sQᵀ + 1 tQᵀ) − 4·D_Y (R diag(iq)) A)
        ∇_g = −iq² ⊙ (2(tQ⊙sR + sQ⊙tR) − 4·diag(A diag(iq) B))

    ``lowrank_backend`` ("auto"|"kernel"|"torch") selects the fused route
    when it resolves to ``"kernel"`` and both geometries are factor pairs:
    the Gram chain (B6) and the gradient assembly (B7) then run as CUDA
    kernels, one launch a call for all lanes.  Grids keep their FGC apply
    whatever the knob.  The fused route reassociates Bᵀ(Q diag(iq))·B as
    (BᵀQ)diag(iq)·B, as the reference's does.
    """

    geom_x: GeometryLike
    geom_y: GeometryLike
    backend: str = "cumsum"
    cost_rank: int | None = None
    lowrank_backend: str = "torch"

    def __post_init__(self):
        _set_sides(self, *(
            g if isinstance(g, StackedGeometry) else
            as_geometry(g, self.backend).for_factored_plan(self.cost_rank)
            for g in (self.geom_x, self.geom_y)))

    def _factor_pairs(self) -> bool:
        return (isinstance(self._sx, LowRankStack)
                and isinstance(self._sy, LowRankStack))

    def _use_fused(self) -> bool:
        return self._factor_pairs() and kops.resolve_lowrank_backend(
            self.lowrank_backend, self._sx.a.device) == "kernel"

    def constant_term(self, mu, nu):
        """The two squared-distance apply vectors (dx2, dy2); the dense
        path's (M, N) C1 is never formed."""
        mu, nu = self._in(mu, nu)
        return (self._out(self._sx.apply_dist(mu, axis=1, power_mult=2)),
                self._out(self._sy.apply_dist(nu, axis=1, power_mult=2)))

    def _grams(self, q, r):
        u = self._sx.apply_dist(q, axis=1)                 # D_X Q   (M, r)
        v = self._sy.apply_dist(r, axis=1)                 # D_Y R   (N, r)
        return (per_lane(torch.matmul, q.transpose(1, 2), u),  # A (r, r)
                per_lane(torch.matmul, r.transpose(1, 2), v))  # B (r, r)

    @staticmethod
    def _fused_chain(geom, fac, w):
        """One call of the Gram-chain kernel for all lanes: (BᵀQ, QᵀDQ, Qᵀ1,
        Qᵀw), in the wider of the factors' and the operand's dtypes."""
        dt = torch.promote_types(geom.a.dtype, fac.dtype)
        # the sums come back as views of one (B, 2c + 2, r) block: B7 takes
        # its (B, r) operands contiguous
        return tuple(o.contiguous() for o in kops.lr_gram_chain_batched(
            *(t.to(dt).contiguous() for t in (geom.a, geom.b, fac, w))))

    def grads(self, coupling, dx2, dy2, g_floor: float = 1e-10):
        """(∇_Q, ∇_R, ∇_g) of the GW energy at the current factors."""
        q, r, g, dx2, dy2 = self._in(coupling.q, coupling.r, coupling.g,
                                     dx2, dy2)
        iq = 1.0 / torch.clamp_min(g, g_floor)
        iq3 = iq[:, None, :]
        if self._use_fused():
            bq_x, a, sq, tq = self._fused_chain(self._sx, q, dx2)
            bq_y, b, sr, tr = self._fused_chain(self._sy, r, dy2)
            # Bᵀ(Q diag(iq))·Gram = (BᵀQ)diag(iq)·Gram: the (c, r) seeds of
            # the quad term cost O(c·r²), no pass over the factors
            wq = per_lane(torch.matmul, bq_x * iq3, b)
            wr = per_lane(torch.matmul, bq_y * iq3, a)
            dt = wq.dtype
            gq = kops.lr_grad_combine_batched(
                self._sx.a.to(dt).contiguous(), wq, dx2.to(dt).contiguous(),
                sr, tr, iq.to(dt))
            gr = kops.lr_grad_combine_batched(
                self._sy.a.to(dt).contiguous(), wr, dy2.to(dt).contiguous(),
                sq, tq, iq.to(dt))
        else:
            a, b = self._grams(q, r)
            sq, sr = per_lane(_col_sums, q), per_lane(_col_sums, r)
            tq = per_lane(torch.matmul, dx2[:, None, :], q)[:, 0]
            tr = per_lane(torch.matmul, dy2[:, None, :], r)[:, 0]
            gq = (2.0 * (dx2[:, :, None] * sr[:, None, :] + tr[:, None, :])
                  - 4.0 * self._sx.apply_dist(
                      per_lane(torch.matmul, q * iq3, b), axis=1)) * iq3
            gr = (2.0 * (dy2[:, :, None] * sq[:, None, :] + tq[:, None, :])
                  - 4.0 * self._sy.apply_dist(
                      per_lane(torch.matmul, r * iq3, a), axis=1)) * iq3
        diag_ab = per_lane(_DIAG_AB, a, iq, b)
        gg = -(iq ** 2) * (2.0 * (tq * sr + sq * tr) - 4.0 * diag_ab)
        return self._out(gq), self._out(gr), self._out(gg)

    def energy(self, coupling, g_floor: float = 1e-10):
        """E(P) at the factored plan's OWN marginals (one value a lane),
        via ⟨P, D_X P D_Y⟩ = Σ_{k,l} iq_k A_kl iq_l B_lk."""
        q, r, g = self._in(coupling.q, coupling.r, coupling.g)
        iq = 1.0 / torch.clamp_min(g, g_floor)
        if self._use_fused():
            _, a, sq, _ = self._fused_chain(self._sx, q,
                                            torch.zeros_like(q[:, :, 0]))
            _, b, sr, _ = self._fused_chain(self._sy, r,
                                            torch.zeros_like(r[:, :, 0]))
        else:
            a, b = self._grams(q, r)
            sq, sr = per_lane(_col_sums, q), per_lane(_col_sums, r)
        m1 = per_lane(torch.matmul, q, (iq * sr)[:, :, None])[:, :, 0]
        m2 = per_lane(torch.matmul, r, (iq * sq)[:, :, None])[:, :, 0]
        cross = per_lane(_CROSS_AB, a, iq, iq, b)
        return self._out(
            per_lane(_col_sums,
                     m1 * self._sx.apply_dist(m1, axis=1, power_mult=2))
            + per_lane(_col_sums,
                       m2 * self._sy.apply_dist(m2, axis=1, power_mult=2))
            - 2.0 * cross)
