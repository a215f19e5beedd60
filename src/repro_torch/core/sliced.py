"""Sliced Gromov-Wasserstein: O(N log N) estimates from 1D projections.

Reference: ``repro/core/sliced.py`` (``SlicedEstimate``,
``sliced_supported``, ``sliced_embedding``, ``_canonicalize``,
``_canonical_keys``, the closed-form 1D solve ``_self_term`` /
``_nw_moments`` / ``_cross_from_moments`` / ``_gw1d``, ``_directions``,
the sorted and plan cores ``_sliced_core`` and ``_sliced_plan_core`` (over
embedded inputs, which a serving bucket pads), ``sliced_gw``,
``sliced_plan``, ``_resample_1d``, ``_sliced_grid`` and
``profile_distance``).

Vayer et al. (*Sliced Gromov-Wasserstein*): the 1D GW problem is solved by
a monotone rearrangement — sort both supports and couple them in the same
or in opposite orders.  Projecting two point sets onto many directions and
averaging the per-direction 1D GW costs gives an O(n_proj · N log N)
estimate of the GW discrepancy.

``method="sorted"`` (default) is the closed form: after sorting, the
north-west-corner coupling between the sorted marginals is built
implicitly from the merged quantile breakpoints (O(M+N) segments), and
with inner metrics |x−x'|^p the GW energy of a co-monotone coupling
collapses to the joint moments S_{a,b} = Σ_k w_k x_k^a y_k^b:

    Σ_{kl} w_k w_l (x_l−x_k)^{p_x} (y_l−y_k)^{p_y}
      = Σ_{a,b} C(p_x,a) C(p_y,b) (−1)^{p_x+p_y−a−b} S_{a,b} S_{p_x−a,p_y−b}

Both orientations are evaluated and the smaller energy wins, per
direction.  All directions run at once: batched stable sorts,
``searchsorted`` and moment sums over a (n_proj, ·) layout, as the
reference's ``vmap``.

``method="grid"`` resamples each projection onto a uniform
``grid_n``-point grid and solves the per-direction 1D problems as entropic
GW over `Grid1D` geometries in one `repro_torch.core.gw.entropic_gw_batch`
call, one lane a direction (on a CUDA device the half-step kernels B1/B2,
and B3 under ``grid_backend="kernel"``).  The binning sums each bin's mass
in a fixed order (a stable sort by bin, then a segmented sum), so two
calls on the card give the same bits: a scatter-add would add in the order
its float atomics land.

Rotation / re-indexing invariance: each side's embedding is canonicalized
first — mass-weighted centering, rotation onto the principal axes of its
mass-weighted covariance (descending eigenvalues), each axis' sign fixed
by the mass-weighted third moment.  The sign fix also makes the
eigensolver's arbitrary eigenvector signs harmless (LAPACK and cuSOLVER
may choose them differently).

The direction bank: the reference draws it with ``jax.random.normal(key,
(d_max, n_proj))``, whose bits PyTorch cannot reproduce.  Here
``directions=`` takes an explicit (d_max, n_proj) bank
(`repro_torch.convert.direction_bank` carries the reference's across);
without one, the bank is drawn from a ``torch.Generator`` seeded with
``seed`` on the CPU, in float64, and then moved to the device, so a card
run and a CPU run see the same bank.  1-dimensional embeddings do not
depend on the directions.

Entry points run on the CUDA device unless given ``device`` (e.g.
``device="cpu"``); with no card and no ``device`` they raise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import gw
from repro_torch.core.geometry import (GridGeometry, LowRankGeometry,
                                       PointCloudGeometry, as_geometry)
from repro_torch.core.grids import Grid1D

#: the grid method's solve: the reference's `_sliced_grid` config
GRID_SOLVE = dict(eps=3e-4, outer_iters=100, sinkhorn_iters=1000, tol=1e-8,
                  eps_init=2e-1, anneal_decay=0.5)


@dataclasses.dataclass
class SlicedEstimate:
    """The fast-tier answer: ``estimate`` is the mean per-direction 1D GW
    cost; ``profile`` the (n_proj,) per-direction values (the cache /
    calibration signature); ``plan`` the best direction's monotone
    coupling as a dense (M, N) plan, only set by :func:`sliced_plan`."""

    estimate: torch.Tensor
    profile: torch.Tensor
    plan: torch.Tensor | None = None


def sliced_supported(geom) -> bool:
    """Does this geometry expose a coordinate embedding to slice?"""
    try:
        geom = as_geometry(geom)
    except (ValueError, TypeError):
        return False
    return isinstance(geom, (GridGeometry, PointCloudGeometry,
                             LowRankGeometry))


def sliced_embedding(geom, device=None):
    """``(embedding (N, d), metric power p)`` such that the geometry's cost
    between points i, j is |e_i − e_j|^p — exact for 1D grids and point
    clouds, heuristic for 2D grids (Manhattan vs Euclidean) and low-rank
    factors (rows as coordinates, power 2).  A grid's positions are built
    in float64 on ``device`` (default the card); a point cloud's or
    factors' tensors are used where they lie.  Raises ValueError for
    geometries with no coordinate structure (dense matrices)."""
    if isinstance(geom, GridGeometry):
        g = geom.grid
        idx = torch.arange(g.n, dtype=torch.float64,
                           device=gw.resolve_device(device)) * g.h
        if isinstance(g, Grid1D):
            return idx[:, None], g.k
        aa, bb = torch.meshgrid(idx, idx, indexing="ij")
        return torch.stack([aa.reshape(-1), bb.reshape(-1)], dim=1), g.k
    if isinstance(geom, PointCloudGeometry):
        return geom.points, 2 if geom.metric == "sqeuclidean" else 1
    if isinstance(geom, LowRankGeometry):
        # the k-means factor seeding's convention: nearby factor rows ⇔
        # similar cost profiles; power 2 matches the dominant
        # sqeuclidean-factorization case
        return geom.a, 2
    raise ValueError(
        f"{type(geom).__name__} has no coordinate embedding to slice — "
        "sliced GW needs grid positions, points, or cost factors")


def _canonicalize(emb, w):
    """Mass-weighted canonical frame: center at the weighted mean, rotate
    onto the principal axes of the weighted covariance (descending
    eigenvalues), fix each axis' sign by its weighted third moment.
    Zero-mass (padding) atoms influence nothing."""
    ft = torch.promote_types(emb.dtype, w.dtype)
    x = emb.to(ft)
    w = w.to(ft)
    w = w / torch.clamp_min(w.sum(), 1e-30)
    x = x - (w @ x)[None, :]
    cov = (x * w[:, None]).T @ x
    _, vecs = torch.linalg.eigh(cov)           # ascending eigenvalues
    y = x @ vecs.flip(-1)                      # principal axis first
    skew = w @ (y ** 3)
    return torch.where((skew < 0)[None, :], -y, y)


def _canonical_keys(emb, w):
    """Each atom's coordinate along the FIRST canonical axis: the sort key
    whose rank order a re-indexed copy preserves (canonicalization is
    permutation-equivariant), which the serving cache uses to re-index a
    profile-matched cached plan onto a new request's atom order."""
    return _canonicalize(emb, w)[:, 0]


def _self_term(x, w, p: int):
    """Σ_ij |x_i − x_j|^{2p} w_i w_j for each row of (P, N) supports, by
    the binomial expansion in the plain moments m_a = Σ w x^a."""
    m = [(w * x ** a).sum(dim=-1) for a in range(2 * p + 1)]
    return sum(math.comb(2 * p, a) * (-1.0) ** a * m[a] * m[2 * p - a]
               for a in range(2 * p + 1))


def _nw_segments(wx, wy):
    """The north-west-corner (monotone) coupling between sorted marginals
    (rows of (P, M) and (P, N) weights) as its merged quantile segments:
    widths w and the atoms (i, j) each segment couples, (P, M+N) each.
    Zero-mass atoms give zero-width segments."""
    cx = torch.cumsum(wx, dim=-1)
    cy = torch.cumsum(wy, dim=-1)
    t = torch.sort(torch.cat([cx, cy], dim=-1), dim=-1).values
    w = torch.diff(t, dim=-1, prepend=torch.zeros_like(t[..., :1]))
    mid = (t - 0.5 * w).contiguous()
    i = torch.searchsorted(cx, mid).clamp(0, cx.shape[-1] - 1)
    j = torch.searchsorted(cy, mid).clamp(0, cy.shape[-1] - 1)
    return w, i, j


def _nw_moments(xs, wx, ys, wy, px: int, py: int):
    """Joint moments S_{a,b} = Σ_k w_k x_{i_k}^a y_{j_k}^b of the monotone
    coupling between SORTED rows, from its O(M+N) segments (the coupling
    itself is never built)."""
    w, i, j = _nw_segments(wx, wy)
    xv, yv = xs.gather(-1, i), ys.gather(-1, j)
    return [[(w * xv ** a * yv ** b).sum(dim=-1) for b in range(py + 1)]
            for a in range(px + 1)]


def _cross_from_moments(s, px: int, py: int):
    """Σ_{kl} w_k w_l (x_l−x_k)^{p_x} (y_l−y_k)^{p_y} from the joint
    moments: Σ |Δx|^{p_x} |Δy|^{p_y} under a co-monotone coupling."""
    return sum(math.comb(px, a) * math.comb(py, b)
               * (-1.0) ** (px + py - a - b) * s[a][b] * s[px - a][py - b]
               for a in range(px + 1) for b in range(py + 1))


def _gw1d(x, wx, y, wy, px: int, py: int):
    """Closed-form 1D GW cost of each direction: rows of the (P, M) and
    (P, N) projections against the shared weights (M,), (N,).  Sort,
    evaluate the monotone coupling's energy in both orientations, keep the
    smaller.  Returns ``(values, use_dec)``, (P,) each: ``use_dec`` says
    the anti-monotone orientation won (the plan builder needs it)."""
    ft = torch.promote_types(torch.promote_types(x.dtype, y.dtype),
                             torch.promote_types(wx.dtype, wy.dtype))
    x, y, wx, wy = x.to(ft), y.to(ft), wx.to(ft), wy.to(ft)
    # center each side (translation-invariant; tames the high moments)
    x = x - (wx * x).sum(dim=-1, keepdim=True) / torch.clamp_min(wx.sum(),
                                                                 1e-30)
    y = y - (wy * y).sum(dim=-1, keepdim=True) / torch.clamp_min(wy.sum(),
                                                                 1e-30)
    # stable, as jnp.argsort: ties order the segments and the reversal
    ox = torch.argsort(x, dim=-1, stable=True)
    oy = torch.argsort(y, dim=-1, stable=True)
    xs, wxs = x.gather(-1, ox), wx[ox]
    ys, wys = y.gather(-1, oy), wy[oy]
    const = _self_term(xs, wxs, px) + _self_term(ys, wys, py)
    s_inc = _nw_moments(xs, wxs, ys, wys, px, py)
    s_dec = _nw_moments(xs, wxs, ys.flip(-1), wys.flip(-1), px, py)
    e_inc = const - 2.0 * _cross_from_moments(s_inc, px, py)
    e_dec = const - 2.0 * _cross_from_moments(s_dec, px, py)
    return torch.minimum(e_inc, e_dec), e_dec < e_inc


def _bank(directions, seed: int, d_max: int, n_proj: int, ft, device):
    """The (d_max, n_proj) direction bank in ``ft`` on ``device``: the given
    one, or one drawn from a CPU generator seeded with ``seed``."""
    if directions is None:
        gen = torch.Generator().manual_seed(int(seed))
        directions = torch.randn((d_max, n_proj), generator=gen,
                                 dtype=torch.float64)
    bank = directions if torch.is_tensor(directions) else \
        torch.tensor(np.asarray(directions))
    if tuple(bank.shape) != (d_max, n_proj):
        raise ValueError(f"direction bank of shape {tuple(bank.shape)}: "
                         f"expected (d_max, n_proj) = ({d_max}, {n_proj})")
    return bank.to(device=device, dtype=ft)


def _directions(bank, dx: int, dy: int):
    """Each side's directions from one shared bank: its leading d rows,
    re-normalized, so equal dimensions see identical directions and a
    lower-dimensional side sees their projection into its subspace."""
    def side(d):
        v = bank[:d]
        return v / torch.clamp_min(torch.linalg.norm(v, dim=0, keepdim=True),
                                   1e-30)
    return side(dx), side(dy)


def _projections(ex, ey, mu, nu, directions, seed, n_proj: int):
    """Both sides canonicalized and projected: (P, M) and (P, N)."""
    ft = torch.promote_types(torch.promote_types(ex.dtype, ey.dtype),
                             torch.promote_types(mu.dtype, nu.dtype))
    cx = _canonicalize(ex, mu)
    cy = _canonicalize(ey, nu)
    dx, dy = cx.shape[1], cy.shape[1]
    bank = _bank(directions, seed, max(dx, dy), n_proj, ft, cx.device)
    dirs_x, dirs_y = _directions(bank, dx, dy)
    return (cx @ dirs_x).T.contiguous(), (cy @ dirs_y).T.contiguous()


def _sliced_core(ex, ey, mu, nu, directions, seed, px: int, py: int,
                 n_proj: int):
    """(estimate, profile) of the sorted method over embedded inputs: the
    serving tier's fast answer.  The inputs may carry zero-mass padding
    atoms (a serving bucket's), which no mass-weighted moment sees."""
    xp, yp = _projections(ex, ey, mu, nu, directions, seed, n_proj)
    vals, _ = _gw1d(xp, mu, yp, nu, px, py)
    return vals.mean(), vals


def _sliced_plan_core(ex, ey, mu, nu, directions, seed, px: int, py: int,
                      n_proj: int):
    """(estimate, profile, plan): `_sliced_core` and the best direction's
    monotone coupling as a dense (M, N) plan, exactly feasible (zero-mass
    rows and columns zero): the refine tier's warm-start seed."""
    xp, yp = _projections(ex, ey, mu, nu, directions, seed, n_proj)
    vals, decs = _gw1d(xp, mu, yp, nu, px, py)
    best = torch.argmin(vals)
    x, y = xp[best], yp[best]
    ox = torch.argsort(x, stable=True)
    oy = torch.argsort(y, stable=True)
    oy = torch.where(decs[best], oy.flip(0), oy)
    w, i, j = _nw_segments(mu[ox][None], nu[oy][None])
    plan = torch.zeros((mu.shape[0], nu.shape[0]), dtype=xp.dtype,
                       device=xp.device)
    # each (i, j) receives at most one segment of nonzero width (the
    # others are zero-width and add +0), so the accumulation order cannot
    # change a bit
    plan.index_put_((ox[i[0]], oy[j[0]]), w[0].to(plan.dtype),
                    accumulate=True)
    return vals.mean(), vals, plan


def _prepare(gx, gy, mu, nu, device):
    dev = gw.resolve_device(device)
    gx, gy = as_geometry(gx), as_geometry(gy)
    ex, px = sliced_embedding(gx, dev)
    ey, py = sliced_embedding(gy, dev)
    mu = torch.full((gx.size,), 1.0 / gx.size, dtype=torch.float64,
                    device=dev) if mu is None else gw.as_tensor(mu, dev)
    nu = torch.full((gy.size,), 1.0 / gy.size, dtype=torch.float64,
                    device=dev) if nu is None else gw.as_tensor(nu, dev)
    return ex, ey, mu, nu, px, py


def sliced_gw(gx, gy, mu=None, nu=None, *, n_proj: int = 32, seed: int = 0,
              directions=None, method: str = "sorted", grid_n: int = 64,
              grid_backend: str = "dense", sinkhorn_backend: str = "auto",
              device=None) -> SlicedEstimate:
    """O(n_proj · N log N) sliced-GW estimate between two geometries.

    ``gx``/``gy``: any Geometry (or raw Grid) with a coordinate embedding
    (see `sliced_embedding`); ``mu``/``nu`` default to uniform (float64).
    ``directions`` is an explicit (d_max, n_proj) bank (d_max the larger
    embedding dimension); without it the bank is drawn from a CPU
    generator seeded with ``seed`` (the reference's ``key``), so profiles
    stay comparable across requests and devices.

    ``method="sorted"`` is the closed-form path; ``method="grid"``
    resamples each projection onto a uniform ``grid_n``-point grid and
    solves the 1D problems as entropic GW over `Grid1D`, one
    `entropic_gw_batch` lane a direction — the entropically biased
    validation twin.  ``grid_backend`` is those grids' FGC backend
    ("dense", the default, or "scan" | "cumsum" | "blocked" | "kernel")
    and ``sinkhorn_backend`` their Sinkhorn's ("auto" | "kernel" |
    "torch").
    """
    ex, ey, mu, nu, px, py = _prepare(gx, gy, mu, nu, device)
    if method == "sorted":
        return SlicedEstimate(*_sliced_core(ex, ey, mu, nu, directions, seed,
                                            px, py, n_proj))
    if method != "grid":
        raise ValueError(
            f"unknown sliced method {method!r}: expected 'sorted' or "
            "'grid'")
    return _sliced_grid(ex, ey, mu, nu, directions, seed, px, py, n_proj,
                        grid_n, grid_backend, sinkhorn_backend)


def sliced_plan(gx, gy, mu=None, nu=None, *, n_proj: int = 32,
                seed: int = 0, directions=None,
                device=None) -> SlicedEstimate:
    """Like :func:`sliced_gw` (sorted method) but also returns the best
    direction's monotone coupling as a dense (M, N) ``plan`` — the
    warm-start seed `repro_torch.core.coupling.FullCoupling.from_sliced`
    wraps.  The plan is exactly feasible (marginals μ, ν; zero-mass rows
    zero)."""
    ex, ey, mu, nu, px, py = _prepare(gx, gy, mu, nu, device)
    return SlicedEstimate(*_sliced_plan_core(ex, ey, mu, nu, directions,
                                             seed, px, py, n_proj))


def _resample_1d(x, w, grid_n: int):
    """Bin weighted 1D supports (rows of (P, N) against the shared weights
    (N,)) onto uniform ``grid_n``-point grids over their mass-carrying
    ranges: returns the (P,) spacings h and the (P, grid_n) binned masses.
    Zero-mass atoms are left out of the range, so padding never stretches
    a grid.  Each bin sums its atoms in index order (a stable sort by bin,
    then a segmented sum), the same order on every call and device."""
    inf = torch.tensor(torch.inf, dtype=x.dtype, device=x.device)
    live = (w > 0)[None, :]
    lo = torch.where(live, x, inf).amin(dim=-1)
    hi = torch.where(live, x, -inf).amax(dim=-1)
    h = torch.clamp_min((hi - lo) / (grid_n - 1), 1e-12)
    idx = torch.round((x - lo[:, None]) / h[:, None]).to(torch.int64)
    idx = idx.clamp(0, grid_n - 1)
    order = torch.argsort(idx, dim=-1, stable=True)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    counts = torch.bincount((idx + rows * grid_n).reshape(-1),
                            minlength=x.shape[0] * grid_n)
    mass = torch.segment_reduce(w.to(x.dtype)[order], "sum",
                                lengths=counts.reshape(-1, grid_n), axis=1)
    return h, mass


def _sliced_grid(ex, ey, mu, nu, directions, seed, px: int, py: int,
                 n_proj: int, grid_n: int, backend: str = "dense",
                 sinkhorn_backend: str = "auto") -> SlicedEstimate:
    """The Grid1D/FGC path: one entropic 1D GW solve per direction, all
    directions as the lanes of one `entropic_gw_batch` (each lane's
    spacing a 0-d tensor h).

    Each direction's pair of cost matrices is normalized to unit scale
    before the solve: with c = max over sides of (range)^power, spacings
    shrink by c^(1/p) per side, which divides both cost matrices by c and
    the GW energy by c²; the solve then runs at an ε meaningful against
    O(1) costs, and the value is rescaled by c²."""
    xp, yp = _projections(ex, ey, mu, nu, directions, seed, n_proj)
    cfg = gw.GWConfig(backend=backend, sinkhorn_backend=sinkhorn_backend,
                      **GRID_SOLVE)
    span = grid_n - 1
    hx, mx = _resample_1d(xp, mu, grid_n)
    hy, my = _resample_1d(yp, nu, grid_n)
    cmax = torch.clamp_min(torch.maximum((hx * span) ** px,
                                         (hy * span) ** py), 1e-30)
    hx = hx / cmax ** (1.0 / px)
    hy = hy / cmax ** (1.0 / py)
    mx = mx / mx.sum(dim=-1, keepdim=True)
    my = my / my.sum(dim=-1, keepdim=True)
    probs = [(GridGeometry(Grid1D(grid_n, hx[c], px), backend),
              GridGeometry(Grid1D(grid_n, hy[c], py), backend), mx[c], my[c])
             for c in range(n_proj)]
    results = gw.entropic_gw_batch(probs, cfg, device=xp.device)
    prof = torch.stack([r.value for r in results]) * cmax ** 2
    return SlicedEstimate(prof.mean(), prof)


def profile_distance(p, q) -> float:
    """Normalized distance between two sliced profiles (same n_proj and
    bank): ‖p − q‖ / (‖p‖ + ‖q‖) ∈ [0, 1] — 0 for identical geometry
    signatures, ~1 for unrelated ones.  The plan cache's second-stage
    nearness test."""
    def host(v):
        v = v.detach().cpu().numpy() if torch.is_tensor(v) else v
        return np.asarray(v, np.float64)
    p, q = host(p), host(q)
    return float(np.linalg.norm(p - q)
                 / (np.linalg.norm(p) + np.linalg.norm(q) + 1e-30))
