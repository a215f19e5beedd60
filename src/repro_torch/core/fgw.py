"""Entropic Fused Gromov-Wasserstein (paper Remark 2.2) with FGC gradients.

Reference: ``repro/core/fgw.py`` (``FGWConfig``, ``fgw_energy``,
``fgw_full_value``, ``fgw_step_fn``, ``fgw_lr_step_fn``, ``fgw_lr_value``
and ``entropic_fgw``; its ``_entropic_fgw_lowrank`` is
`repro_torch.core.gw._entropic_lowrank_auto` with a feature cost).

Objective: (1−θ)·Σ c²_ip γ_ip + θ·E(Γ); gradient C2 − 4θ·D_X Γ D_Y with
C2 = (1−θ)·C⊙C + 2θ·((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ).

The step closures and value assemblies are module-level so the one-shot,
batched and segmented solves of `repro_torch.core.gw` run the same
expressions; like GW's, the closures run on lanes.  The full-plan step's
Sinkhorn runs the half-step kernels (B1/B2) and its ``op.product`` the
configured FGC backend; the factored step's ``fsq @ r`` is a plain product
(the reference computes it outside any Pallas kernel too).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sinkhorn as sk
from repro_torch.core.coupling import FullCoupling, LowRankCoupling
from repro_torch.core.gradient import GradientOperator
from repro_torch.core.gw import GWConfig, GWResult, _on_lanes, _solve_one
from repro_torch.core.solver import SolveControls


@dataclasses.dataclass(frozen=True)
class FGWConfig(GWConfig):
    theta: float = 0.5         # paper §4.1/§4.3 use θ=0.5; §4.4.1 θ=0.1


def fgw_energy(grid_x, grid_y, feature_cost, gamma, theta,
               backend: str = "cumsum"):
    lin = (feature_cost ** 2 * gamma).sum(dim=(-2, -1))
    quad = GradientOperator(grid_x, grid_y, backend).energy(gamma)
    return (1.0 - theta) * lin + theta * quad


def fgw_full_value(op: GradientOperator, feature_cost, gamma, theta):
    """FGW objective at a dense plan (one value a lane), on a prepared
    operator."""
    lin = (feature_cost ** 2 * gamma).sum(dim=(-2, -1))
    return (1.0 - theta) * lin + theta * op.energy(gamma)


def fgw_step_fn(op: GradientOperator, c2, theta, mu, nu, cfg: FGWConfig):
    """The full-plan FGW step closure over lanes: `gw.gw_step_fn` with the
    blended constant term ``c2 = (1−θ)·C⊙C + θ·c1`` and the quadratic
    gradient scaled by θ."""
    op, c2, mu, nu = _on_lanes(op, c2, mu, nu)

    def step(state, eps, inner_tol):
        grad = c2 - 4.0 * theta * op.product(state.plan)
        gamma, f, g, err, used = sk.solve_adaptive(
            grad, mu, nu, eps, cfg.sinkhorn_iters, cfg.sinkhorn_chunk,
            inner_tol, cfg.sinkhorn_mode, state.f, state.g,
            backend=cfg.sinkhorn_backend, cost_dtype=cfg.cost_dtype)
        return FullCoupling(gamma, f, g), err, used

    return step


def fgw_lr_grads(op, state, dx2, dy2, fsq, theta, g_floor: float):
    """The factored FGW gradients over lanes: θ times the LR-GW gradients
    of ``op`` plus (1−θ) times the linear feature term's through
    P = Q diag(1/g) Rᵀ,

        ∂⟨C², P⟩/∂Q = C² R diag(1/g),  ∂/∂R = C²ᵀ Q diag(1/g),
        ∂/∂g = −(1/g²) ⊙ diag(Qᵀ C² R),

    with ``fsq`` = C² (B, M, N)."""
    gq, gr, gg = op.grads(state, dx2, dy2, g_floor)
    iq = 1.0 / torch.clamp_min(state.g, g_floor)
    fr = fsq @ state.r                       # (B, M, r)
    fq = fsq.transpose(-1, -2) @ state.q     # (B, N, r)
    lin_diag = (state.q * fr).sum(dim=-2)    # diag(Qᵀ C² R)
    iq3 = iq[..., None, :]
    return (theta * gq + (1.0 - theta) * fr * iq3,
            theta * gr + (1.0 - theta) * fq * iq3,
            theta * gg - (1.0 - theta) * iq ** 2 * lin_diag)


def fgw_lr_step_fn(op, dx2, dy2, fsq, theta, mu, nu, cfg: FGWConfig,
                   lr_gamma):
    """The factored-plan FGW step closure over lanes: `fgw_lr_grads`, then
    the prox kernels and the Dykstra projection of `sinkhorn.lr_mirror_step`.
    ``fsq`` is the squared feature cost (the solve's one (M, N) build);
    each step pays one O(MNr) product against the factors, but the plan
    and the solver state stay factored."""
    op, dx2, dy2, fsq, mu, nu = _on_lanes(op, dx2, dy2, fsq, mu, nu)

    def step(state, eps, inner_tol):
        gq, gr, gg = fgw_lr_grads(op, state, dx2, dy2, fsq, theta,
                                  cfg.g_floor)
        q, r, g, err, used = sk.lr_mirror_step(
            state.q, state.r, state.g, gq, gr, gg, mu, nu, eps, lr_gamma,
            cfg.sinkhorn_iters, cfg.sinkhorn_chunk, inner_tol, cfg.g_floor,
            cfg.lowrank_backend, cost_dtype=cfg.cost_dtype)
        return LowRankCoupling(q, r, g), err, used

    return step


def fgw_lr_value(op, fsq, coup, theta, g_floor: float):
    """FGW objective at a factored plan (one value a lane, or one problem's
    with one problem's operator): the linear term contracted through the
    factors, never building P, plus the factored GW energy."""
    iq = 1.0 / torch.clamp_min(coup.g, g_floor)
    lin = ((coup.q * (fsq @ coup.r)).sum(dim=-2) * iq).sum(dim=-1)
    return (1.0 - theta) * lin + theta * op.energy(coup, g_floor)


def entropic_fgw(grid_x, grid_y, feature_cost, mu, nu,
                 cfg: FGWConfig = FGWConfig(), gamma0=None,
                 controls: SolveControls | None = None,
                 device=None) -> GWResult:
    """``feature_cost``: the (M, N) linear-term cost C (the paper's c_ip).
    ``grid_x``/``grid_y``: Grids or any Geometry.

    ``cfg.plan="lowrank"`` runs the factored mirror descent: C² is built
    once a solve and each step pays one O(MNr) product against the factors,
    but the plan and the solver state stay factored.  Reverse-mode
    differentiable in the geometries, measures, feature cost and controls,
    as `repro_torch.core.entropic_gw` (the feature cost's gradient is
    (M, N)).  Runs on the card unless ``device`` says otherwise."""
    return _solve_one(grid_x, grid_y, mu, nu, cfg, gamma0, controls, device,
                      feature_cost)
