"""Entropic Gromov-Wasserstein by mirror descent (paper §2.1) with the FGC
fast gradient (paper §3) — forward, dense plan.

Reference: ``repro/core/gw.py`` (``GWConfig``, ``GWResult``, ``gw_energy``,
``gw_step_fn``, ``gw_init_state``, ``gw_plan_solve``, ``gw_plan_segment``
and ``entropic_gw`` with ``plan="full"``; batching, the factored plan and
reverse-mode differentiation belong to later slices).

Each outer iteration:
    Π   = ∇E(Γ) = C1 − 4·D_X Γ D_Y          (FGC: O(k²MN); dense: O(M²N+MN²))
    Γ   ← Sinkhorn(Π, μ, ν, ε)               (τ = ε, Remark 2.1)
with warm-started log-domain potentials carried across iterations, driven
by `repro_torch.core.solver.mirror_descent`.

Entry points run on the CUDA device unless the caller passes ``device``
(e.g. ``device="cpu"`` for the plain PyTorch path); with no card and no
``device`` they raise.  Measures may be numpy arrays or tensors; the
caller's float32/float64 dtype is kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sinkhorn as sk
from repro_torch.core.coupling import (Coupling, FullCoupling,
                                       coupling_delta, full_init)
from repro_torch.core.geometry import as_geometry
from repro_torch.core.gradient import GradientOperator
from repro_torch.core.solver import (ConvergenceInfo, MirrorCarry,
                                     SolveControls, mirror_descent,
                                     mirror_descent_segment,
                                     resolve_controls)


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when None (raising when there is
    none: the port never moves to the CPU by itself)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "none is available: pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda")


def as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or (copied) array-like, keeping
    its float dtype."""
    t = x.to(device) if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.array(x), device=device)
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64 data, got {t.dtype}")
    return t


@dataclasses.dataclass(frozen=True)
class GWConfig:
    eps: float = 2e-3          # paper §4.1 uses 0.002 (1D) / 0.004 (2D)
    outer_iters: int = 10      # cap; exact count when tol=0 (paper §4.1: 10)
    sinkhorn_iters: int = 200  # inner cap per outer step
    #: FGC gradient backend: "scan" | "cumsum" | "blocked" | "dense" |
    #: "kernel" (the reference's "pallas")
    backend: str = "cumsum"
    sinkhorn_mode: str = "log"
    #: log-mode dual-update backend: "auto" (CUDA kernels on a CUDA device,
    #: plain PyTorch on the CPU) | "kernel" | "torch" (the reference's
    #: "auto" | "pallas" | "xla")
    sinkhorn_backend: str = "auto"
    tol: float = 0.0           # early-stop tolerance (0 → fixed-iteration)
    eps_init: float | None = None   # ε-annealing start (None/≤eps → off)
    anneal_decay: float = 0.5  # geometric ε decay per outer step
    sinkhorn_chunk: int = 25   # inner iterations between residual checks
    inner_loosen: float = 1.0  # inner-tol ε-scaling strength (0 → flat tol)
    #: cost element type the Sinkhorn kernels read ("f32" | "bf16"); the
    #: plain path ignores it
    cost_dtype: str = "f32"
    #: plan representation: "full" (dense plan + potentials); "lowrank" is
    #: not ported yet
    plan: str = "full"

    def __post_init__(self):
        if self.plan not in ("full", "lowrank"):
            raise ValueError(
                f"unknown plan {self.plan!r}: expected 'full' or 'lowrank'")
        if self.cost_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown cost_dtype {self.cost_dtype!r}: "
                             "expected 'f32' or 'bf16'")


@dataclasses.dataclass
class GWResult:
    plan: torch.Tensor
    value: torch.Tensor        # E(Γ): the (squared) GW discrepancy
    marginal_err: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    #: per-outer-step marginal-error trace (outer_iters,), NaN past the stop
    errs: torch.Tensor | None = None
    info: ConvergenceInfo | None = None
    coupling: Coupling | None = None


def _not_ported_lowrank():
    return NotImplementedError("plan='lowrank' is not ported yet")


def gw_energy(grid_x, grid_y, gamma, backend: str = "cumsum",
              dx2_mu=None, dy2_nu=None):
    """E(Γ) = Σ (d^X_ij − d^Y_pq)² γ_ip γ_jq, via the three-term expansion."""
    return GradientOperator(grid_x, grid_y, backend).energy(
        gamma, dx2_mu, dy2_nu)


def gw_step_fn(op: GradientOperator, c1, mu, nu, cfg: GWConfig):
    """The full-plan mirror-descent step closure (state: `FullCoupling`)."""

    def step(state, eps, inner_tol):
        gamma, f, g, err, used = sk.solve_adaptive(
            op.grad(state.plan, c1), mu, nu, eps, cfg.sinkhorn_iters,
            cfg.sinkhorn_chunk, inner_tol, cfg.sinkhorn_mode, state.f,
            state.g, backend=cfg.sinkhorn_backend,
            cost_dtype=cfg.cost_dtype)
        return FullCoupling(gamma, f, g), err, used

    return step


def gw_init_state(mu, nu, gamma0=None, cfg: GWConfig | None = None):
    """The standard cold start: product-coupling plan with zero-mass-aware
    potentials."""
    if cfg is not None and cfg.plan == "lowrank":
        raise _not_ported_lowrank()
    return full_init(mu, nu, gamma0)


def gw_plan_solve(op: GradientOperator, c1, mu, nu, cfg: GWConfig,
                  controls: SolveControls | None = None, state0=None):
    """Convergence-controlled full-plan GW mirror descent on a prepared
    operator.  Returns ``(FullCoupling, ConvergenceInfo)``."""
    ctl = resolve_controls(cfg, controls, mu.device)
    if state0 is None:
        state0 = full_init(mu, nu)
    return mirror_descent(gw_step_fn(op, c1, mu, nu, cfg), state0,
                          coupling_delta, ctl, cfg.outer_iters)


def gw_plan_segment(op: GradientOperator, c1, mu, nu, cfg: GWConfig,
                    controls: SolveControls, carry: MirrorCarry,
                    segment: int | None = None) -> MirrorCarry:
    """Advance a full-plan solve by at most ``segment`` outer steps; the
    same step body as `gw_plan_solve`, so segments are bit-identical to an
    uninterrupted solve."""
    return mirror_descent_segment(gw_step_fn(op, c1, mu, nu, cfg),
                                  coupling_delta, controls, cfg.outer_iters,
                                  carry, segment)


def entropic_gw(grid_x, grid_y, mu, nu, cfg: GWConfig = GWConfig(),
                gamma0=None, controls: SolveControls | None = None,
                device=None) -> GWResult:
    """Entropic GW distance + plan.

    ``grid_x``/``grid_y``: Geometry instances, or raw Grid1D/Grid2D
    (adapted with ``cfg.backend``).  ``controls`` overrides the cfg's value
    knobs.  The value is E(Γ) with the squared-distance applies taken at
    (μ, ν), the same expression as the reference's forward value.
    """
    if cfg.plan == "lowrank":
        raise _not_ported_lowrank()
    dev = resolve_device(device)
    mu, nu = as_tensor(mu, dev), as_tensor(nu, dev)
    ctl = resolve_controls(cfg, controls, dev)
    op = GradientOperator(as_geometry(grid_x, cfg.backend),
                          as_geometry(grid_y, cfg.backend), cfg.backend)
    c1, dx2_mu, dy2_nu = op.constant_term(mu, nu)
    state0 = None if gamma0 is None else full_init(mu, nu,
                                                   as_tensor(gamma0, dev))
    coup, info = gw_plan_solve(op, c1, mu, nu, cfg, ctl, state0)
    value = op.energy(coup.plan, dx2_mu, dy2_nu)
    return GWResult(plan=coup.plan, value=value,
                    marginal_err=info.marginal_err, f=coup.f, g=coup.g,
                    errs=info.err_trace, info=info, coupling=coup)
