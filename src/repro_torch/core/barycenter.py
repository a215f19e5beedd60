"""Fixed-support entropic GW barycenter (Peyré et al. 2016; the paper's
conclusion: FGC "can be used to accelerate ... fixed support GW
barycenter").

Reference: ``repro/core/barycenter.py`` (``BarycenterConfig`` and
``gw_barycenter``).

Given S input measures with structured geometries (grids, low-rank, point
clouds — any `repro_torch.core.geometry.Geometry`) and barycenter weights
λ_s, alternate:
  1. for each s, one after another: solve entropic GW between the current
     barycenter matrix D̄ and geometry s.  The D̄ side is a `DenseGeometry`,
     so the plan solve is `repro_torch.core.gw.gw_plan_solve`, the same
     convergence-controlled mirror descent as every solver (its product
     D̄ Γ_s D_s gets the structured apply on the s side, B3 for a grid on
     ``backend="kernel"``, and its Sinkhorn the half-step kernels B1/B2,
     while the D̄ side stays a dense matmul).  With ``cfg.tol>0`` each plan
     solve early-stops; plan states AND potentials warm-start across
     barycenter updates.
  2. D̄ ← (1/μ̄μ̄ᵀ) Σ_s λ_s Γ_s D_s Γ_sᵀ, with D_s Γ_sᵀ via the fast apply and
     the rest dense (`torch.matmul`, as the reference's XLA products).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.coupling import full_init
from repro_torch.core.geometry import DenseGeometry, as_geometry
from repro_torch.core.gradient import GradientOperator
from repro_torch.core.gw import (GWConfig, as_tensor, gw_plan_solve,
                                 resolve_device)


@dataclasses.dataclass(frozen=True)
class BarycenterConfig:
    eps: float = 5e-3
    outer_iters: int = 5        # barycenter updates
    gw_iters: int = 5           # mirror-descent cap per plan solve
    sinkhorn_iters: int = 100
    #: FGC backend for raw grids: "scan" | "cumsum" | "blocked" | "dense" |
    #: "kernel" (the reference's "pallas")
    backend: str = "cumsum"
    tol: float = 0.0            # early-stop tolerance for the plan solves
    eps_init: float | None = None   # ε-annealing start (None/≤eps → off)
    anneal_decay: float = 0.5
    sinkhorn_chunk: int = 25
    #: log-mode dual-update backend of the plan solves: "auto" (CUDA
    #: kernels on a CUDA device, plain PyTorch on the CPU) | "kernel" |
    #: "torch" (the reference's "auto" | "pallas" | "xla")
    sinkhorn_backend: str = "auto"

    def gw_config(self) -> GWConfig:
        """The inner plan-solve config this barycenter cfg induces."""
        return GWConfig(eps=self.eps, outer_iters=self.gw_iters,
                        sinkhorn_iters=self.sinkhorn_iters,
                        backend=self.backend, tol=self.tol,
                        eps_init=self.eps_init,
                        anneal_decay=self.anneal_decay,
                        sinkhorn_chunk=self.sinkhorn_chunk,
                        sinkhorn_backend=self.sinkhorn_backend)


def gw_barycenter(grids: Sequence, measures: Sequence, weights:
                  Sequence[float], mu_bar,
                  cfg: BarycenterConfig = BarycenterConfig(), dbar0=None,
                  device=None):
    """Returns (D̄, plans).  ``mu_bar``: barycenter weights (fixed support).

    ``grids``: per-input geometries — raw Grid1D/Grid2D (adapted with
    ``cfg.backend``) or any Geometry holding its tensors on the solve's
    device.  Runs on the card unless ``device`` says otherwise; the
    measures keep their float dtype.
    """
    dev = resolve_device(device)
    mu_bar = as_tensor(mu_bar, dev)
    measures = [as_tensor(nu, dev) for nu in measures]
    geoms = [as_geometry(g, cfg.backend).materialize() for g in grids]
    m = mu_bar.shape[0]
    ft = mu_bar.dtype
    lam = torch.as_tensor(weights, dtype=ft, device=dev)
    lam = lam / lam.sum()
    if dbar0 is None:
        # a uniform-grid prior of the barycenter's size
        idx = torch.arange(m, dtype=ft, device=dev)
        dbar = (idx[:, None] - idx[None, :]).abs() / max(m - 1, 1)
    else:
        dbar = as_tensor(dbar0, dev)

    gw_cfg = cfg.gw_config()
    # ε-annealing is for the COLD first sweep only: later sweeps warm-start
    # from near-converged plans, and re-running the ramp would walk them
    # away from the fixed point
    warm_cfg = dataclasses.replace(gw_cfg, eps_init=None)
    states = [full_init(mu_bar, nu) for nu in measures]

    for sweep in range(cfg.outer_iters):
        solve_cfg = gw_cfg if sweep == 0 else warm_cfg
        new_states = []
        acc = torch.zeros_like(dbar)
        for geom_s, nu_s, lam_s, state in zip(geoms, measures, lam, states):
            op = GradientOperator(DenseGeometry(dbar), geom_s, cfg.backend)
            c1, _, _ = op.constant_term(mu_bar, nu_s)
            coup, _ = gw_plan_solve(op, c1, mu_bar, nu_s, solve_cfg,
                                    state0=state)
            new_states.append(coup)
            # Γ_s D_s via the structured apply, then dense Γ_s D_s Γ_sᵀ
            gds = geom_s.apply_dist(coup.plan, axis=1)
            acc = acc + lam_s * (gds @ coup.plan.T)
        dbar = acc / (mu_bar[:, None] * mu_bar[None, :])
        states = new_states

    return dbar, [s.plan for s in states]
