"""GW gradient operators: dense plan and factored plan.

Reference: ``repro/core/gradient.py`` (``GradientOperator`` and
``LowRankGradientOperator``; COOT's ``bilinear_product`` belongs to a later
slice).  A mirror-descent cost is built from three pieces (paper §2-3):

  product(Γ)        the bottleneck term D_X Γ D_Y — O(k²MN) via FGC,
  constant_term     C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ),
  energy(Γ)         E(Γ) = Σ (d^X_ij − d^Y_pq)² γ_ip γ_jq via the three-term
                    expansion.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.core.geometry import Geometry, LowRankGeometry, as_geometry
from repro_torch.core.grids import Grid
from repro_torch.kernels import ops as kops

GeometryLike = Union[Geometry, Grid]


@dataclasses.dataclass(frozen=True)
class GradientOperator:
    """GW gradient pieces for a fixed geometry pair.  ``backend`` selects the
    FGC implementation when a raw grid is passed; Geometry arguments carry
    their own."""

    geom_x: GeometryLike
    geom_y: GeometryLike
    backend: str = "cumsum"

    def __post_init__(self):
        object.__setattr__(self, "geom_x",
                           as_geometry(self.geom_x, self.backend)
                           .materialize())
        object.__setattr__(self, "geom_y",
                           as_geometry(self.geom_y, self.backend)
                           .materialize())

    def product(self, gamma):
        """D_X Γ D_Y — the paper's bottleneck term."""
        left = self.geom_x.apply_dist(gamma, axis=0)       # D_X Γ
        return self.geom_y.apply_dist(left, axis=1)        # (D_X Γ) D_Y

    def apply_sq_x(self, vec):
        """(D_X ∘ D_X) v: the same structure with power_mult=2."""
        return self.geom_x.apply_dist(vec, axis=0, power_mult=2)

    def apply_sq_y(self, vec):
        return self.geom_y.apply_dist(vec, axis=0, power_mult=2)

    def constant_term(self, mu, nu):
        """C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ).

        Returns (C1, (D_X∘D_X)μ, (D_Y∘D_Y)ν); the two vectors are reusable
        by energy() when Γ has the exact marginals (μ, ν).
        """
        dx2 = self.apply_sq_x(mu)
        dy2 = self.apply_sq_y(nu)
        return 2.0 * (dx2[:, None] + dy2[None, :]), dx2, dy2

    def grad(self, gamma, c1):
        """∇E(Γ) = C1 − 4·D_X Γ D_Y (paper eq. 2.4)."""
        return c1 - 4.0 * self.product(gamma)

    def energy(self, gamma, dx2_mu=None, dy2_nu=None):
        """E(Γ) via the three-term expansion.  ``dx2_mu``/``dy2_nu``:
        optional (D∘D)-applies at Γ's marginals (valid when Γ is feasible
        for them)."""
        mu_g = gamma.sum(dim=1)
        nu_g = gamma.sum(dim=0)
        if dx2_mu is None:
            dx2_mu = self.apply_sq_x(mu_g)
        if dy2_nu is None:
            dy2_nu = self.apply_sq_y(nu_g)
        cross = (gamma * self.product(gamma)).sum()
        return mu_g @ dx2_mu + nu_g @ dy2_nu - 2.0 * cross


@dataclasses.dataclass(frozen=True)
class LowRankGradientOperator:
    """GW gradient pieces for a FACTORED plan P = Q diag(1/g) Rᵀ.

    The plan never exists: every quantity routes through the factors and
    the rank-r Gram matrices

        U = D_X Q,  V = D_Y R,   A = Qᵀ U,  B = Rᵀ V     (both (r, r)),

    so a gradient costs O((M+N)·r·c) with c the cost-apply width (k² for
    grids, the cost rank for factored costs).  Point clouds are converted
    to their factored cost (`Geometry.for_factored_plan`), never
    materialized.

    Gradients at the feasible point (iq = 1/g, dx2 = (D_X∘D_X)μ,
    dy2 = (D_Y∘D_Y)ν, sQ/sR the factor column sums, tQ = Qᵀdx2,
    tR = Rᵀdy2):

        ∇_Q = iq ⊙ (2(dx2 sRᵀ + 1 tRᵀ) − 4·D_X (Q diag(iq)) B)
        ∇_R = iq ⊙ (2(dy2 sQᵀ + 1 tQᵀ) − 4·D_Y (R diag(iq)) A)
        ∇_g = −iq² ⊙ (2(tQ⊙sR + sQ⊙tR) − 4·diag(A diag(iq) B))

    ``lowrank_backend`` ("auto"|"kernel"|"torch") selects the fused route
    when it resolves to ``"kernel"`` and both geometries are factor pairs:
    the Gram chain (B6) and the gradient assembly (B7) then run as CUDA
    kernels.  Grids keep their FGC apply whatever the knob.  The fused
    route reassociates Bᵀ(Q diag(iq))·B as (BᵀQ)diag(iq)·B, as the
    reference's does.
    """

    geom_x: GeometryLike
    geom_y: GeometryLike
    backend: str = "cumsum"
    cost_rank: int | None = None
    lowrank_backend: str = "torch"

    def __post_init__(self):
        object.__setattr__(self, "geom_x",
                           as_geometry(self.geom_x, self.backend)
                           .for_factored_plan(self.cost_rank))
        object.__setattr__(self, "geom_y",
                           as_geometry(self.geom_y, self.backend)
                           .for_factored_plan(self.cost_rank))

    def _use_fused(self) -> bool:
        return (isinstance(self.geom_x, LowRankGeometry)
                and isinstance(self.geom_y, LowRankGeometry)
                and kops.resolve_lowrank_backend(
                    self.lowrank_backend, self.geom_x.a.device) == "kernel")

    def constant_term(self, mu, nu):
        """The two squared-distance apply vectors (dx2, dy2); the dense
        path's (M, N) C1 is never formed."""
        return (self.geom_x.apply_dist(mu, axis=0, power_mult=2),
                self.geom_y.apply_dist(nu, axis=0, power_mult=2))

    def _grams(self, coupling):
        u = self.geom_x.apply_dist(coupling.q, axis=0)     # D_X Q   (M, r)
        v = self.geom_y.apply_dist(coupling.r, axis=0)     # D_Y R   (N, r)
        return coupling.q.T @ u, coupling.r.T @ v          # A, B    (r, r)

    def _fused_chain(self, geom, fac, w):
        """One call of the Gram-chain kernel: (BᵀQ, QᵀDQ, Qᵀ1, Qᵀw), in the
        wider of the factors' and the operand's dtypes."""
        dt = torch.promote_types(geom.a.dtype, fac.dtype)
        return kops.lr_gram_chain(*(t.to(dt).contiguous()
                                    for t in (geom.a, geom.b, fac, w)))

    def grads(self, coupling, dx2, dy2, g_floor: float = 1e-10):
        """(∇_Q, ∇_R, ∇_g) of the GW energy at the current factors."""
        q, r, g = coupling.q, coupling.r, coupling.g
        iq = 1.0 / torch.clamp_min(g, g_floor)
        if self._use_fused():
            bq_x, a, sq, tq = self._fused_chain(self.geom_x, q, dx2)
            bq_y, b, sr, tr = self._fused_chain(self.geom_y, r, dy2)
            # Bᵀ(Q diag(iq))·Gram = (BᵀQ)diag(iq)·Gram: the (c, r) seeds of
            # the quad term cost O(c·r²), no pass over the factors
            wq = (bq_x * iq[None, :]) @ b
            wr = (bq_y * iq[None, :]) @ a
            dt = wq.dtype
            gq = kops.lr_grad_combine(self.geom_x.a.to(dt).contiguous(), wq,
                                      dx2.to(dt).contiguous(), sr, tr,
                                      iq.to(dt))
            gr = kops.lr_grad_combine(self.geom_y.a.to(dt).contiguous(), wr,
                                      dy2.to(dt).contiguous(), sq, tq,
                                      iq.to(dt))
        else:
            a, b = self._grams(coupling)
            sq, sr = q.sum(dim=0), r.sum(dim=0)
            tq, tr = q.T @ dx2, r.T @ dy2
            gq = (2.0 * (dx2[:, None] * sr[None, :] + tr[None, :])
                  - 4.0 * self.geom_x.apply_dist((q * iq[None, :]) @ b,
                                                 axis=0)
                  ) * iq[None, :]
            gr = (2.0 * (dy2[:, None] * sq[None, :] + tq[None, :])
                  - 4.0 * self.geom_y.apply_dist((r * iq[None, :]) @ a,
                                                 axis=0)
                  ) * iq[None, :]
        diag_ab = torch.einsum("kl,l,lk->k", a, iq, b)
        gg = -(iq ** 2) * (2.0 * (tq * sr + sq * tr) - 4.0 * diag_ab)
        return gq, gr, gg

    def energy(self, coupling, g_floor: float = 1e-10):
        """E(P) at the factored plan's OWN marginals, via
        ⟨P, D_X P D_Y⟩ = Σ_{k,l} iq_k A_kl iq_l B_lk."""
        q, r, g = coupling.q, coupling.r, coupling.g
        iq = 1.0 / torch.clamp_min(g, g_floor)
        if self._use_fused():
            _, a, sq, _ = self._fused_chain(self.geom_x, q,
                                            torch.zeros_like(q[:, 0]))
            _, b, sr, _ = self._fused_chain(self.geom_y, r,
                                            torch.zeros_like(r[:, 0]))
        else:
            a, b = self._grams(coupling)
            sq, sr = q.sum(dim=0), r.sum(dim=0)
        m1 = q @ (iq * sr)
        m2 = r @ (iq * sq)
        cross = torch.einsum("kl,k,l,lk->", a, iq, iq, b)
        return (m1 @ self.geom_x.apply_dist(m1, axis=0, power_mult=2)
                + m2 @ self.geom_y.apply_dist(m2, axis=0, power_mult=2)
                - 2.0 * cross)
