"""Plan representations: the `Coupling` interface behind a GW solve.

Reference: ``repro/core/coupling.py`` (``Coupling``, ``FullCoupling``,
``LowRankCoupling``, ``coupling_delta``, ``full_init`` and ``lowrank_init``
with its rank-2 and k-means seeds; zero-mass padding of a coupling,
``pad_to``, belongs to the batching slice).

``FullCoupling`` is the dense plan Γ (M, N) plus the log-domain Sinkhorn
potentials (f, g) warm-started across outer steps — the paper's setting.
``LowRankCoupling`` is the factored plan P = Q diag(1/g) Rᵀ of Scetbon et
al. (2021): O((M+N)·r) state, no (M, N) array.  ``coupling_delta`` is the
outer loop's movement metric: the L1 change of the plan or its factors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import geometry as geo
from repro_torch.core import sinkhorn as sk
from repro_torch.core.grids import Grid1D


class Coupling:
    """Interface: what the solver stack needs from a plan representation."""

    def delta(self, other: "Coupling"):
        """L1-style movement between two iterates (the outer loop's delta_fn)."""
        raise NotImplementedError

    def dense(self):
        """The explicit (M, N) plan."""
        raise NotImplementedError

    def marginals(self):
        """(P 1_N, Pᵀ 1_M)."""
        raise NotImplementedError


@dataclasses.dataclass
class FullCoupling(Coupling):
    """Dense plan + warm-started log-domain Sinkhorn potentials."""

    plan: torch.Tensor       # (M, N)
    f: torch.Tensor          # (M,) row potential (−inf on zero-mass atoms)
    g: torch.Tensor          # (N,) column potential

    def delta(self, other: "FullCoupling"):
        return (self.plan - other.plan).abs().sum()

    def dense(self):
        return self.plan

    def marginals(self):
        return self.plan.sum(dim=1), self.plan.sum(dim=0)


@dataclasses.dataclass
class LowRankCoupling(Coupling):
    """Factored plan P = Q diag(1/g) Rᵀ.

    ``q``: (M, r) with Q 1_r = μ, Qᵀ 1_M = g;  ``r``: (N, r) with
    R 1_r = ν, Rᵀ 1_N = g;  ``g``: (r,) inner weights, kept ≥ the solver's
    floor.  Zero-mass atoms have exactly-zero factor rows.
    """

    q: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor

    @property
    def rank(self) -> int:
        return self.g.shape[-1]

    def delta(self, other: "LowRankCoupling"):
        return ((self.q - other.q).abs().sum()
                + (self.r - other.r).abs().sum()
                + (self.g - other.g).abs().sum())

    def slice_to(self, m: int, n: int) -> "LowRankCoupling":
        return LowRankCoupling(self.q[:m], self.r[:n], self.g)

    def dense(self):
        return (self.q / self.g[None, :]) @ self.r.T

    def marginals(self):
        iq = 1.0 / self.g
        row = self.q @ (iq * self.r.sum(dim=0))
        col = self.r @ (iq * self.q.sum(dim=0))
        return row, col

    def pad_rank(self, new_rank: int, mu, nu,
                 blend: float = 0.05) -> "LowRankCoupling":
        """Warm start for rank growth (``plan_rank="auto"``): widen the
        factors to ``new_rank`` columns while staying feasible,

            Q' = [(1−w)·Q | μ (w/k) 1ᵀ],   g' = [(1−w)·g | (w/k) 1]

        (same for R'/ν), so Q'1 = μ and Q'ᵀ1 = g' exactly, and zero-mass
        rows stay zero.  No growth requested returns ``self``."""
        k = new_rank - self.rank
        if k <= 0:
            return self
        w = torch.as_tensor(blend, dtype=self.g.dtype, device=self.g.device)

        def widen(fac, marg):
            fresh = marg[:, None] * torch.full((1, k), 1.0, dtype=fac.dtype,
                                               device=fac.device) * (w / k)
            return torch.cat([(1.0 - w) * fac, fresh], dim=1)

        gn = torch.cat([(1.0 - w) * self.g,
                        torch.full((k,), 1.0, dtype=self.g.dtype,
                                   device=self.g.device) * (w / k)])
        return LowRankCoupling(widen(self.q, mu), widen(self.r, nu), gn)


def coupling_delta(new: Coupling, old: Coupling):
    """The outer loop's delta_fn for coupling-valued solver states."""
    return new.delta(old)


def full_init(mu, nu, gamma0=None, f0=None, g0=None) -> FullCoupling:
    """Cold start for the dense representation: product-coupling plan,
    zero-mass-aware potentials."""
    f, g = sk.zero_mass_potentials(mu, nu)
    return FullCoupling(mu[:, None] * nu[None, :] if gamma0 is None
                        else gamma0,
                        f if f0 is None else f0, g if g0 is None else g0)


def _rank2_factor(w, rank: int, lam):
    """One side of the deterministic rank-2 init: a coupling between ``w``
    and the uniform inner measure g₀ = 1/r,

        F = λ·a₁ ĝᵀ + (w − λ·a₁)(g₀ − λ·ĝ)ᵀ / (1 − λ),

    with a₁ ∝ arange·(w>0) and ĝ ∝ arange (both normalized).  F 1_r = w and
    Fᵀ 1 = g₀ exactly, every entry is ≥ 0 for λ ≤ min(min₊ w, 1/r)/2, and
    zero-mass rows are exactly 0."""
    n = w.shape[0]
    ft, dev = w.dtype, w.device
    a1 = torch.arange(1, n + 1, dtype=ft, device=dev) * (w > 0)
    a1 = a1 / a1.sum()
    g1 = torch.arange(1, rank + 1, dtype=ft, device=dev)
    g1 = g1 / g1.sum()
    g0 = torch.full((rank,), 1.0 / rank, dtype=ft, device=dev)
    return (lam * a1[:, None] * g1[None, :]
            + (w - lam * a1)[:, None] * (g0 - lam * g1)[None, :] / (1.0 - lam))


def _embedding(geom, ft, device):
    """Coordinates to cluster for the k-means seeding: the points (point
    clouds), the cost-factor rows (low-rank costs) or the 1-D grid
    positions.  Dense matrices and 2-D grids have none."""
    if isinstance(geom, geo.PointCloudGeometry):
        return geom.points.to(ft)
    if isinstance(geom, geo.LowRankGeometry):
        return geom.a.to(ft)
    if isinstance(geom, geo.GridGeometry) and isinstance(geom.grid, Grid1D):
        g = geom.grid
        return (torch.arange(g.n, dtype=ft, device=device) * g.h)[:, None]
    raise ValueError(
        f"lowrank_init='kmeans' needs a coordinate embedding; "
        f"{type(geom).__name__} has none — use lowrank_init='rank2'")


def _sq_dists(x, c):
    return ((x ** 2).sum(dim=1)[:, None] - 2.0 * x @ c.T
            + (c ** 2).sum(dim=1)[None, :])


def _kmeans_centers(x, w, k: int, iters: int = 10):
    """Mass-weighted Lloyd iterations from mass-quantile seeds; zero-mass
    atoms carry zero weight everywhere.  Ties go to the lowest index, as
    ``jnp.searchsorted`` (side "left") and ``jnp.argmin`` break them."""
    cum = torch.cumsum(w, dim=0)
    targets = (torch.arange(k, dtype=x.dtype, device=x.device) + 0.5) / k \
        * cum[-1]
    idx = torch.searchsorted(cum, targets).clamp_max(x.shape[0] - 1)
    centers = x[idx]
    ks = torch.arange(k, device=x.device)
    for _ in range(iters):
        hard = torch.argmin(_sq_dists(x, centers), dim=1)
        onehot = (hard[:, None] == ks[None, :]) * w[:, None]
        mass = onehot.sum(dim=0)
        new = (onehot.T @ x) / torch.clamp_min(mass, 1e-30)[:, None]
        centers = torch.where(mass[:, None] > 0, new, centers)
    return centers


def _kmeans_factor(w, centers, x, mix=1e-2):
    """One factor from soft cluster assignments: rows softmax(−d²/τ) (τ the
    mass-weighted mean nearest-centre distance) blended with a little
    uniform mass, scaled by ``w``: row sums are exactly ``w`` and zero-mass
    rows exactly zero."""
    k = centers.shape[0]
    d2 = _sq_dists(x, centers)
    tau = w @ d2.amin(dim=1)
    tau = torch.where(tau > 0, tau, torch.ones_like(tau))
    soft = torch.softmax(-d2 / tau, dim=1)
    soft = (1.0 - mix) * soft + mix / k
    return w[:, None] * soft


def lowrank_init(mu, nu, rank: int, *, method: str = "rank2",
                 geom_x=None, geom_y=None) -> LowRankCoupling:
    """Feasible factored cold start.

    ``method="rank2"``: the deterministic rank-2 blend, Q ∈ Π(μ, g₀),
    R ∈ Π(ν, g₀) with uniform g₀ = 1/r, positive on every mass-carrying atom
    and exactly zero on zero-mass atoms.  ``method="kmeans"``: each side's
    factor from mass-weighted k-means over its geometry's coordinate
    embedding (``geom_x``/``geom_y`` required); the inner weights average
    the two sides' cluster masses."""
    ft = mu.dtype
    if method == "kmeans":
        if geom_x is None or geom_y is None:
            raise ValueError(
                "lowrank_init='kmeans' seeds from the geometries — pass "
                "geom_x/geom_y (or use the solver entry points, which do)")
        xx = _embedding(geom_x, ft, mu.device)
        xy = _embedding(geom_y, ft, nu.device)
        q = _kmeans_factor(mu, _kmeans_centers(xx, mu, rank), xx)
        r = _kmeans_factor(nu, _kmeans_centers(xy, nu, rank), xy)
        return LowRankCoupling(q, r, 0.5 * (q.sum(dim=0) + r.sum(dim=0)))
    if method != "rank2":
        raise ValueError(f"unknown lowrank_init method {method!r}")
    inf = torch.tensor(torch.inf, dtype=ft, device=mu.device)
    min_mu = torch.where(mu > 0, mu, inf).min()
    min_nu = torch.where(nu > 0, nu, inf).min()
    lam = torch.minimum(torch.minimum(min_mu, min_nu),
                        torch.tensor(1.0 / rank, dtype=ft,
                                     device=mu.device)) / 2.0
    return LowRankCoupling(_rank2_factor(mu, rank, lam),
                           _rank2_factor(nu, rank, lam),
                           torch.full((rank,), 1.0 / rank, dtype=ft,
                                      device=mu.device))
