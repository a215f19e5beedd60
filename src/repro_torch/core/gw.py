"""Entropic Gromov-Wasserstein by mirror descent (paper §2.1) with the FGC
fast gradient (paper §3) — forward, dense or factored plan.

Reference: ``repro/core/gw.py`` (``GWConfig``, ``GWResult``, ``gw_energy``,
``gw_step_fn``, ``gw_lr_step_fn``, ``gw_init_state``, ``gw_plan_solve``,
``gw_plan_segment``, ``lowrank_descent`` and ``entropic_gw`` with
``plan="full"`` and ``plan="lowrank"``; batching, FGW's factored step and
reverse-mode differentiation belong to later slices).

Each outer iteration with the dense plan (``plan="full"``):
    Π   = ∇E(Γ) = C1 − 4·D_X Γ D_Y          (FGC: O(k²MN); dense: O(M²N+MN²))
    Γ   ← Sinkhorn(Π, μ, ν, ε)               (τ = ε, Remark 2.1)
with warm-started log-domain potentials carried across iterations.  With
the factored plan (``plan="lowrank"``) the state is P = Q diag(1/g) Rᵀ
(Scetbon et al. 2021): the gradients come from the factors' Gram chain and
a Dykstra projection replaces Sinkhorn, so no (M, N) array exists and
point clouds run as their factored costs.  Both are driven by
`repro_torch.core.solver.mirror_descent`.

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
                                       LowRankCoupling, coupling_delta,
                                       full_init, lowrank_init)
from repro_torch.core.geometry import as_geometry
from repro_torch.core.gradient import GradientOperator, LowRankGradientOperator
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
    #: plan representation: "full" (dense plan + potentials) or "lowrank"
    #: (factored P = Q diag(1/g) Rᵀ: O((M+N)r) state, no (M, N) array)
    plan: str = "full"
    #: factored-plan rank r, or "auto": start at rank 8 and double (up to
    #: ``plan_rank_max``) while the residual trace stalls unconverged
    plan_rank: int | str = 16
    plan_rank_max: int = 64
    #: explicit cost-factorization rank for point-cloud conversions (None
    #: keeps exact factorizations, rank d+2 for sqeuclidean clouds)
    cost_rank: int | None = None
    #: factored-plan kernels: "auto" (CUDA kernels on a CUDA device, plain
    #: PyTorch on the CPU) | "kernel" | "torch" (the reference's "auto" |
    #: "pallas" | "xla")
    lowrank_backend: str = "auto"
    #: factor seeding: "rank2" (deterministic feasible blend) or "kmeans"
    lowrank_init: str = "rank2"
    lr_gamma: float = 30.0     # factored-plan mirror step size γ
    g_floor: float = 1e-10     # floor on the inner weights g

    def __post_init__(self):
        if self.plan not in ("full", "lowrank"):
            raise ValueError(
                f"unknown plan {self.plan!r}: expected 'full' or 'lowrank'")
        if self.cost_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown cost_dtype {self.cost_dtype!r}: "
                             "expected 'f32' or 'bf16'")
        if isinstance(self.plan_rank, str) and self.plan_rank != "auto":
            raise ValueError(
                f"plan_rank={self.plan_rank!r}: expected an int or 'auto'")
        if self.lowrank_backend not in ("auto", "kernel", "torch"):
            raise ValueError(
                f"unknown lowrank backend {self.lowrank_backend!r}: "
                "expected 'auto', 'kernel', or 'torch'")
        if self.lowrank_init not in ("rank2", "kmeans"):
            raise ValueError(
                f"unknown lowrank init {self.lowrank_init!r}: expected "
                "'rank2' or 'kmeans'")


@dataclasses.dataclass
class GWResult:
    #: dense plan Γ — None for factored-plan solves (use ``coupling``; its
    #: ``dense()`` builds the plan on demand for small problems)
    plan: torch.Tensor | None
    value: torch.Tensor        # E(Γ): the (squared) GW discrepancy
    marginal_err: torch.Tensor
    f: torch.Tensor | None
    g: torch.Tensor | None
    #: per-outer-step marginal-error trace (outer_iters,), NaN past the stop
    errs: torch.Tensor | None = None
    info: ConvergenceInfo | None = None
    #: the plan representation: FullCoupling, or the LowRankCoupling factors
    coupling: Coupling | None = None


def _result_of(coupling: Coupling, value, info: ConvergenceInfo) -> GWResult:
    """A GWResult from either plan representation: plan/f/g are the full
    coupling's, and None for factored plans."""
    dense = isinstance(coupling, FullCoupling)
    return GWResult(plan=coupling.plan if dense else None, value=value,
                    marginal_err=info.marginal_err,
                    f=coupling.f if dense else None,
                    g=coupling.g if dense else None,
                    errs=info.err_trace, info=info, coupling=coupling)


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


def gw_lr_step_fn(op: LowRankGradientOperator, dx2, dy2, mu, nu,
                  cfg: GWConfig, lr_gamma):
    """The factored-plan step closure (state: `LowRankCoupling`): the LR-GW
    gradients at the current factors, the KL-prox kernels and a Dykstra
    projection (`sinkhorn.lr_mirror_step`).  Dykstra sweeps take the
    Sinkhorn iterations' caps (``sinkhorn_iters``/``sinkhorn_chunk``) and
    their place in `ConvergenceInfo`; err is the L1 row-marginal gap."""

    def step(state, eps, inner_tol):
        gq, gr, gg = op.grads(state, dx2, dy2, cfg.g_floor)
        q, r, g, err, used = sk.lr_mirror_step(
            state.q, state.r, state.g, gq, gr, gg, mu, nu, eps, lr_gamma,
            cfg.sinkhorn_iters, cfg.sinkhorn_chunk, inner_tol, cfg.g_floor,
            cfg.lowrank_backend, cost_dtype=cfg.cost_dtype)
        return LowRankCoupling(q, r, g), err, used

    return step


def _static_rank(cfg: GWConfig) -> int:
    if isinstance(cfg.plan_rank, str):
        raise ValueError(
            "plan_rank='auto' adapts the rank with host-level restarts in "
            "the one-shot entropic_gw only; a fixed state needs one static "
            "plan_rank")
    return cfg.plan_rank


def gw_init_state(mu, nu, gamma0=None, cfg: GWConfig | None = None,
                  geom_x=None, geom_y=None):
    """The standard cold start as a `Coupling`: the product plan with
    zero-mass-aware potentials, or (``cfg.plan="lowrank"``) the feasible
    rank-r factors (``cfg.lowrank_init`` seeds; the geometries are read by
    the k-means seeding only)."""
    if cfg is not None and cfg.plan == "lowrank":
        return lowrank_init(mu, nu, _static_rank(cfg),
                            method=cfg.lowrank_init, geom_x=geom_x,
                            geom_y=geom_y)
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
    (adapted with ``cfg.backend``); a geometry holding tensors must hold
    them on the solve's device.  ``controls`` overrides the cfg's value
    knobs.  The value is E(Γ) with the squared-distance applies taken at
    (μ, ν), the same expression as the reference's forward value.

    With ``cfg.plan="lowrank"`` the solve runs on the factored plan
    (``result.coupling`` is a `LowRankCoupling`; plan/f/g are None) and the
    value is the factored energy at the plan's own marginals;
    ``plan_rank="auto"`` grows the rank by restarts (`lowrank_descent`).
    ``gamma0`` is a dense-plan warm start and is rejected there.
    """
    dev = resolve_device(device)
    mu, nu = as_tensor(mu, dev), as_tensor(nu, dev)
    ctl = resolve_controls(cfg, controls, dev)
    if cfg.plan == "lowrank":
        if gamma0 is not None:
            raise ValueError(
                "gamma0 is a dense-plan warm start; the factored path "
                "starts from its own feasible factors")
        return _entropic_gw_lowrank(grid_x, grid_y, mu, nu, cfg, ctl)
    op = GradientOperator(as_geometry(grid_x, cfg.backend),
                          as_geometry(grid_y, cfg.backend), cfg.backend)
    c1, dx2_mu, dy2_nu = op.constant_term(mu, nu)
    state0 = None if gamma0 is None else full_init(mu, nu,
                                                   as_tensor(gamma0, dev))
    coup, info = gw_plan_solve(op, c1, mu, nu, cfg, ctl, state0)
    return _result_of(coup, op.energy(coup.plan, dx2_mu, dy2_nu), info)


_AUTO_RANK_START = 8        # plan_rank="auto" first attempt
_AUTO_RANK_BLEND = 0.05     # mass blended into the fresh columns on growth
_AUTO_RANK_WINDOW = 3       # stall lookback (outer steps)
_AUTO_RANK_RATIO = 0.9      # residual must shrink below ratio×lookback


def _residual_stalled(info: ConvergenceInfo) -> bool:
    """True when the last outer step's residual recovered less than
    (1 − ratio) relative to ``window`` steps earlier: the current rank's
    polytope, not the iteration count, is what binds."""
    trace = info.err_trace.cpu().numpy()
    trace = trace[np.isfinite(trace)]
    if trace.size <= _AUTO_RANK_WINDOW:
        return False
    return bool(trace[-1] > _AUTO_RANK_RATIO
                * trace[-1 - _AUTO_RANK_WINDOW])


def lowrank_descent(step, mu, nu, cfg: GWConfig, ctl: SolveControls,
                    geom_x=None, geom_y=None):
    """Factored-plan mirror descent: `mirror_descent` from `lowrank_init`
    at a static ``plan_rank``, or, under ``plan_rank="auto"``, a restart
    loop that starts at rank 8 and doubles (up to ``plan_rank_max``)
    whenever the solve neither converged nor still makes residual progress.
    Each restart warm starts from the previous factors widened by
    `LowRankCoupling.pad_rank`.  The returned `ConvergenceInfo` accumulates
    the outer/inner counts over the restarts; its trace is the last
    attempt's."""
    if not isinstance(cfg.plan_rank, str):
        state0 = lowrank_init(mu, nu, cfg.plan_rank,
                              method=cfg.lowrank_init, geom_x=geom_x,
                              geom_y=geom_y)
        return mirror_descent(step, state0, coupling_delta, ctl,
                              cfg.outer_iters)
    rank = min(_AUTO_RANK_START, cfg.plan_rank_max)
    state = lowrank_init(mu, nu, rank, method=cfg.lowrank_init,
                         geom_x=geom_x, geom_y=geom_y)
    outer = inner = 0
    while True:
        coup, info = mirror_descent(step, state, coupling_delta, ctl,
                                    cfg.outer_iters)
        outer += info.outer_iters
        inner += info.inner_iters
        if (info.converged or rank >= cfg.plan_rank_max
                or not _residual_stalled(info)):
            break
        rank = min(2 * rank, cfg.plan_rank_max)
        state = coup.pad_rank(rank, mu, nu, _AUTO_RANK_BLEND)
    return coup, dataclasses.replace(info, outer_iters=outer,
                                     inner_iters=inner)


def _entropic_gw_lowrank(grid_x, grid_y, mu, nu, cfg: GWConfig,
                         ctl: SolveControls) -> GWResult:
    """Factored-plan entropic GW, static rank or ``"auto"``: the factors
    are seeded from the converted geometries (the operator's factored
    pair), and the value is the operator's energy at the final factors."""
    op = LowRankGradientOperator(grid_x, grid_y, cfg.backend, cfg.cost_rank,
                                 cfg.lowrank_backend)
    dx2, dy2 = op.constant_term(mu, nu)
    step = gw_lr_step_fn(op, dx2, dy2, mu, nu, cfg, ctl.lr_gamma)
    coup, info = lowrank_descent(step, mu, nu, cfg, ctl, op.geom_x,
                                 op.geom_y)
    return _result_of(coup, op.energy(coup, cfg.g_floor), info)
