"""Entropic Co-Optimal Transport (Titouan et al. 2020), named in the
paper's conclusion as an FGC-amenable variant.

Reference: ``repro/core/coot.py`` (``COOTConfig`` and ``entropic_coot``).

COOT couples two datasets X (n×d), Y (m×e) with TWO plans — samples π_s
(n×m) and features π_v (d×e) — minimizing
    Σ_{i,k,j,l} (X_ij − Y_kl)² π_s[i,k] π_v[j,l]
by block-coordinate descent: each half-step is an entropic OT whose cost is

    M_s = (X∘X) w_v 1ᵀ + 1 (w'_v ᵀ(Y∘Y))ᵀ − 2 X π_v Yᵀ      (samples)
    M_v = (X∘X)ᵀ w_s 1ᵀ + 1 (w'_s ᵀ(Y∘Y)) − 2 Xᵀ π_s Y      (features)

The bilinear terms X π_v Yᵀ are the COOT analogue of the paper's
D_X Γ D_Y.  When X and Y are themselves uniform-grid distance matrices
(the GW specialization: X = D_X, Y = D_Y), ``grid_x``/``grid_y`` switch
those products to the FGC apply (`repro_torch.core.gradient.
bilinear_product`; on ``backend="kernel"`` the FGC kernel B3).  Both
half-steps' Sinkhorn solves run the half-step kernels (B1/B2) under
``sinkhorn_backend="auto"`` on a CUDA device.

The BCD outer loop is the shared lane-leading mirror-descent loop
(`repro_torch.core.solver.mirror_descent`) on a batch of one: one outer
step runs both half-steps; early stopping (``cfg.tol>0``) triggers when
BOTH plans stop moving and both inner residuals pass; ε-annealing scales
``eps_samples`` and ``eps_features`` by the same geometric ramp.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sinkhorn as sk
from repro_torch.core.coupling import Coupling
from repro_torch.core.gradient import GeometryLike, bilinear_product
from repro_torch.core.gw import as_tensor, resolve_device
from repro_torch.core.solver import mirror_descent, resolve_controls


@dataclasses.dataclass(frozen=True)
class COOTConfig:
    eps_samples: float = 1e-2
    eps_features: float = 1e-2
    outer_iters: int = 10
    sinkhorn_iters: int = 100
    #: FGC backend, used only on grid-structured sides: "scan" | "cumsum" |
    #: "blocked" | "dense" | "kernel" (the reference's "pallas")
    backend: str = "cumsum"
    tol: float = 0.0              # early-stop tolerance (0 → fixed-iteration)
    eps_init: float | None = None  # annealing start for eps_samples;
    #                                eps_features ramps by the same ratio
    anneal_decay: float = 0.5
    sinkhorn_chunk: int = 25
    #: log-mode dual-update backend: "auto" (CUDA kernels on a CUDA device,
    #: plain PyTorch on the CPU) | "kernel" | "torch" (the reference's
    #: "auto" | "pallas" | "xla")
    sinkhorn_backend: str = "auto"

    @property
    def eps(self) -> float:
        """The ε the annealing schedule targets (for SolveControls):
        eps_samples; eps_features ramps by the same ratio."""
        return self.eps_samples


@dataclasses.dataclass
class COOTState(Coupling):
    """The BCD state: both plans and both half-steps' warm-started
    potentials (lane-leading in the outer loop)."""

    pi_s: torch.Tensor    # (n, m) samples plan
    pi_v: torch.Tensor    # (d, e) features plan
    f_s: torch.Tensor
    g_s: torch.Tensor
    f_v: torch.Tensor
    g_v: torch.Tensor

    def delta(self, other: "COOTState"):
        """Both plans must stop moving: their L1 movements summed."""
        return ((self.pi_s - other.pi_s).abs().sum(dim=(-2, -1))
                + (self.pi_v - other.pi_v).abs().sum(dim=(-2, -1)))


def _rows_apply(mat, v):
    """mat @ v for one (k, l) matrix and lane-leading (B, l) vectors."""
    return v @ mat.T


def coot_step_fn(x, y, mu_s, nu_s, mu_v, nu_v, cfg: COOTConfig,
                 eps_target, grid_x=None, grid_y=None):
    """The BCD step closure over lanes (state: a lane-leading `COOTState`;
    ε_s and the inner tolerance (B,); the data matrices shared).
    ``eps_target`` is the controls' ε: the features' ε follows the
    samples' ramp, ε_v = eps_features·(ε_s / eps_target)."""
    x2, y2 = x * x, y * y
    mu_s, nu_s, mu_v, nu_v = (t[None] for t in (mu_s, nu_s, mu_v, nu_v))

    def solve(cost, mu, nu, eps, inner_tol, f, g):
        return sk.solve_adaptive(cost, mu, nu, eps, cfg.sinkhorn_iters,
                                 cfg.sinkhorn_chunk, inner_tol, "log", f, g,
                                 backend=cfg.sinkhorn_backend)

    def step(state, eps_s, inner_tol):
        eps_v = cfg.eps_features * (eps_s / eps_target)
        # samples half-step
        a = _rows_apply(x2, state.pi_v.sum(dim=-1))
        b = _rows_apply(y2, state.pi_v.sum(dim=-2))
        m_s = (a[:, :, None] + b[:, None, :]
               - 2.0 * bilinear_product(x, state.pi_v, y, grid_x, grid_y,
                                        cfg.backend))
        pi_s, f_s, g_s, err_s, used_s = solve(m_s, mu_s, nu_s, eps_s,
                                              inner_tol, state.f_s,
                                              state.g_s)
        # features half-step
        c = _rows_apply(x2.T, pi_s.sum(dim=-1))
        d = _rows_apply(y2.T, pi_s.sum(dim=-2))
        m_v = (c[:, :, None] + d[:, None, :]
               - 2.0 * (x.T @ pi_s @ y))
        pi_v, f_v, g_v, err_v, used_v = solve(m_v, mu_v, nu_v, eps_v,
                                              inner_tol, state.f_v,
                                              state.g_v)
        # gate on the worse of the two residuals: each half-step drives its
        # own residual to ≤ tol, so their sum could wedge just above tol
        return (COOTState(pi_s, pi_v, f_s, g_s, f_v, g_v),
                torch.maximum(err_s, err_v),
                [us + uv for us, uv in zip(used_s, used_v)])

    return step


def entropic_coot(x, y, mu_s, nu_s, mu_v, nu_v,
                  cfg: COOTConfig = COOTConfig(),
                  grid_x: GeometryLike | None = None,
                  grid_y: GeometryLike | None = None,
                  return_info: bool = False, device=None):
    """Returns (pi_samples, pi_features, value), plus a `ConvergenceInfo`
    when ``return_info=True``.

    mu_s/nu_s: sample marginals (n,), (m,); mu_v/nu_v: feature marginals.
    ``grid_x``/``grid_y``: pass the grids (or any structured Geometry) when
    X/Y are themselves structured distance matrices (e.g. |i−j|^k on a
    uniform grid, or a low-rank factorization) to switch those products to
    the fast apply (GW specialization).  Runs on the card unless ``device``
    says otherwise; the data keep their float dtype.
    """
    dev = resolve_device(device)
    x, y, mu_s, nu_s, mu_v, nu_v = (as_tensor(t, dev) for t in
                                    (x, y, mu_s, nu_s, mu_v, nu_v))
    ctl = resolve_controls(cfg, None, dev)
    state0 = COOTState(mu_s[:, None] * nu_s[None, :],
                       mu_v[:, None] * nu_v[None, :],
                       torch.zeros_like(mu_s), torch.zeros_like(nu_s),
                       torch.zeros_like(mu_v), torch.zeros_like(nu_v))
    state, info = mirror_descent(
        coot_step_fn(x, y, mu_s, nu_s, mu_v, nu_v, cfg, ctl.eps, grid_x,
                     grid_y),
        state0, COOTState.delta, ctl, cfg.outer_iters)
    pi_s, pi_v = state.pi_s, state.pi_v
    # the final objective
    a = (x * x) @ pi_v.sum(dim=1)
    b = (y * y) @ pi_v.sum(dim=0)
    cross = (pi_s * bilinear_product(x, pi_v, y, grid_x, grid_y,
                                     cfg.backend)).sum()
    value = pi_s.sum(dim=1) @ a + pi_s.sum(dim=0) @ b - 2.0 * cross
    if return_info:
        return pi_s, pi_v, value, info
    return pi_s, pi_v, value
