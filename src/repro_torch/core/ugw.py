"""Entropic Unbalanced Gromov-Wasserstein (paper Remark 2.3; Séjourné et al.).

Reference: ``repro/core/ugw.py`` (``UGWConfig``, ``_kl``, ``local_cost`` and
``entropic_ugw``).

Alternating scheme: at each outer step linearize around Γ̂ —
    cost  = ½∇E(Γ̂) + g(Γ̂)
          = [D_X²(Γ̂1)]_i + [D_Y²(Γ̂ᵀ1)]_p − 2[D_X Γ̂ D_Y]_ip
            + ρ·KL(Γ̂1|μ) + ρ·KL(Γ̂ᵀ1|ν) + ε·KL(Γ̂|μ⊗ν)      (scalar offsets)
then solve an *unbalanced* entropic OT with mass-scaled parameters
(ε_t, ρ_t) = m(Γ̂)·(ε, ρ) and rescale the result so the total mass obeys the
quadratic-mass optimality condition  Γ ← Γ·√(m(Γ̂)/m(Γ)).  The scalar
offsets change the unbalanced plan's mass, so they are kept.

The O(M²N+MN²) bottleneck is the same D_X Γ D_Y term as GW's, so FGC
applies verbatim (on a grid with ``backend="kernel"``, the FGC kernel B3);
the unbalanced dual update is plain PyTorch, as the reference's is plain
XLA.  The outer loop is the shared lane-leading mirror-descent loop
(`repro_torch.core.solver.mirror_descent`) on a batch of one, its state a
`FullCoupling` (Γ, f, g).  Unbalanced plans satisfy no exact marginal, so
the per-step residual in `ConvergenceInfo` / `GWResult.errs` is the inner
solver's fixed-point drift (L∞ potential change over its last chunk), and
early stopping triggers on plan movement + drift ≤ tol.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sinkhorn as sk
from repro_torch.core.coupling import FullCoupling, coupling_delta
from repro_torch.core.gradient import GeometryLike, GradientOperator
from repro_torch.core.gw import (GWResult, _on_lanes, as_tensor,
                                 resolve_device)
from repro_torch.core.solver import (SolveControls, mirror_descent,
                                     resolve_controls)


@dataclasses.dataclass(frozen=True)
class UGWConfig:
    eps: float = 1e-2
    rho: float = 1.0           # marginal-KL strength (ρ → ∞ recovers GW)
    outer_iters: int = 10
    sinkhorn_iters: int = 200
    #: FGC gradient backend: "scan" | "cumsum" | "blocked" | "dense" |
    #: "kernel" (the reference's "pallas")
    backend: str = "cumsum"
    tol: float = 0.0           # early-stop tolerance (0 → fixed-iteration)
    eps_init: float | None = None   # ε-annealing start (None/≤eps → off)
    anneal_decay: float = 0.5
    sinkhorn_chunk: int = 25


def rel_entr(a, b):
    """Elementwise relative entropy, as ``scipy.special.rel_entr``:
    a·log a − a·log b where a, b > 0; 0 where a = 0 ≤ b; +inf otherwise.
    (``torch.special.xlogy(a, a / b)`` is NaN at a = b = 0.)"""
    pos = (a > 0) & (b > 0)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    sa = torch.where(pos, a, one)
    sb = torch.where(pos, b, one)
    val = sa * torch.log(sa) - sa * torch.log(sb)
    zero_a = (a == 0) & (b >= 0)
    return torch.where(pos, val, torch.where(
        zero_a, torch.zeros_like(val), torch.full_like(val, torch.inf)))


def _kl(a, b, dims):
    """KL(a|b) = Σ rel_entr(a, b) − Σa + Σb over ``dims`` (one value a
    lane)."""
    return rel_entr(a, b).sum(dim=dims) - a.sum(dim=dims) + b.sum(dim=dims)


def local_cost(op: GradientOperator, gamma, mu, nu, eps, rho):
    """The linearized UGW cost at Γ̂ over lanes (``op`` on lanes, Γ̂
    (B, M, N), ε a (B,) tensor or a scalar, ρ a float)."""
    mu_g = gamma.sum(dim=-1)
    nu_g = gamma.sum(dim=-2)
    a = op.apply_sq_x(mu_g)
    b = op.apply_sq_y(nu_g)
    cost = a[..., :, None] + b[..., None, :] - 2.0 * op.product(gamma)
    k_mu = _kl(mu_g, mu, -1)[..., None, None]
    k_nu = _kl(nu_g, nu, -1)[..., None, None]
    cost = cost + rho * k_mu + rho * k_nu
    k_plan = _kl(gamma, mu[..., :, None] * nu[..., None, :], (-2, -1))
    eps = torch.as_tensor(eps, dtype=gamma.dtype, device=gamma.device)
    return cost + (eps * k_plan)[..., None, None]


def ugw_step_fn(op: GradientOperator, mu, nu, cfg: UGWConfig):
    """The UGW mirror-descent step closure over lanes (state: a
    lane-leading `FullCoupling`; ε and the inner tolerance (B,))."""
    op, mu, nu = _on_lanes(op, mu, nu)

    def step(state, eps, inner_tol):
        gamma = state.plan
        mass = gamma.sum(dim=(-2, -1))
        eps = eps.to(gamma.dtype)
        cost = local_cost(op, gamma, mu, nu, eps, cfg.rho)
        rho_t = cfg.rho * mass
        new, f, g, drift, used = sk.sinkhorn_unbalanced_log_chunked(
            cost, mu, nu, eps * mass, rho_t, rho_t, cfg.sinkhorn_iters,
            cfg.sinkhorn_chunk, inner_tol, state.f, state.g)
        scale = torch.sqrt(mass / torch.clamp_min(new.sum(dim=(-2, -1)),
                                                  1e-300))
        return FullCoupling(new * scale[:, None, None], f, g), drift, used

    return step


def entropic_ugw(grid_x: GeometryLike, grid_y: GeometryLike, mu, nu,
                 cfg: UGWConfig = UGWConfig(), gamma0=None,
                 controls: SolveControls | None = None,
                 device=None) -> GWResult:
    """Entropic UGW divergence and plan.  ``grid_x``/``grid_y``: Grids
    (adapted with ``cfg.backend``) or any Geometry, holding their tensors
    on the solve's device.  Runs on the card unless ``device`` says
    otherwise; the measures keep their float dtype."""
    dev = resolve_device(device)
    mu, nu = as_tensor(mu, dev), as_tensor(nu, dev)
    ctl = resolve_controls(cfg, controls, dev)
    # one materialized operator for the solve: point-cloud costs are built
    # once, not once an outer step
    op = GradientOperator(grid_x, grid_y, cfg.backend)
    gamma = mu[:, None] * nu[None, :] if gamma0 is None else \
        as_tensor(gamma0, dev)
    state, info = mirror_descent(
        ugw_step_fn(op, mu, nu, cfg),
        FullCoupling(gamma, torch.zeros_like(mu), torch.zeros_like(nu)),
        coupling_delta, ctl, cfg.outer_iters)
    # the UGW divergence at the returned plan: the GW energy plus the
    # marginal and mass penalties, by the quadratic-KL identity
    # KL⊗(α⊗α|β⊗β) = 2 m(α)·KL(α|β) + (m(α) − m(β))²
    gamma = state.plan
    mu_g, nu_g = gamma.sum(dim=1), gamma.sum(dim=0)
    m = gamma.sum()
    val = (op.energy(gamma)
           + cfg.rho * (2 * m * _kl(mu_g, mu, -1) + (m - mu.sum()) ** 2)
           + cfg.rho * (2 * m * _kl(nu_g, nu, -1) + (m - nu.sum()) ** 2))
    return GWResult(plan=gamma, value=val, marginal_err=info.marginal_err,
                    f=state.f, g=state.g, errs=info.err_trace, info=info,
                    coupling=state)
