"""GW gradient operator (dense plan).

Reference: ``repro/core/gradient.py`` (``GradientOperator``; the factored
plan's operator belongs to a later slice).  A mirror-descent cost is built
from three pieces (paper §2-3):

  product(Γ)        the bottleneck term D_X Γ D_Y — O(k²MN) via FGC,
  constant_term     C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ),
  energy(Γ)         E(Γ) = Σ (d^X_ij − d^Y_pq)² γ_ip γ_jq via the three-term
                    expansion.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core.geometry import Geometry, as_geometry
from repro_torch.core.grids import Grid

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
