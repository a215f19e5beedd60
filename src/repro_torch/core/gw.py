"""Entropic Gromov-Wasserstein by mirror descent (paper §2.1) with the FGC
fast gradient (paper §3), dense or factored plan, reverse-mode
differentiable.

Reference: ``repro/core/gw.py`` (``GWConfig`` with ``static_key``,
``GWResult``, ``gw_energy``, ``gw_step_fn``, ``gw_lr_step_fn``,
``gw_init_state``, ``gw_plan_solve``, ``gw_plan_segment``,
``lowrank_descent``, the implicit functions ``_implicit_*`` and
``implicit_spec``, ``entropic_gw`` with ``plan="full"`` and
``plan="lowrank"``, and the batch surface ``entropic_gw_batch`` with
``stack_problems``, ``stack_controls``, FGW feature costs
(``_stack_features``) and its segmented resume).

Each outer iteration with the dense plan (``plan="full"``):
    Π   = ∇E(Γ) = C1 − 4·D_X Γ D_Y          (FGC: O(k²MN); dense: O(M²N+MN²))
    Γ   ← Sinkhorn(Π, μ, ν, ε)               (τ = ε, Remark 2.1)
with warm-started log-domain potentials carried across iterations.  With
the factored plan (``plan="lowrank"``) the state is P = Q diag(1/g) Rᵀ
(Scetbon et al. 2021): the gradients come from the factors' Gram chain and
a Dykstra projection replaces Sinkhorn, so no (M, N) array exists and
point clouds run as their factored costs.  Both are driven by
`repro_torch.core.solver.mirror_descent_segment`.

Reverse mode: `entropic_gw` and the one-shot `entropic_gw_batch` run
through `repro_torch.core.solver.fixed_point_value`, one call for all lanes
of a stack, so their values and plans are differentiable in the
geometries' tensors (a grid's ``h`` given as a 0-d tensor, factors,
points, costs), the measures, the feature costs and the controls.  The
backward pass is rebuilt from the converged state (`implicit_spec`); the
forward runs any backend, kernels included, except that a grid on the FGC
kernel backend cannot be differentiated (as in the reference, whose Pallas
scan has no transpose).  Segmented solves and ``plan_rank="auto"`` are
not differentiable and say so.

`entropic_gw_batch` solves many problems as one set of lane-leading
tensors: each side's geometries are padded to one size with zero-mass
points (exact: padded potentials are −inf, padded factor rows 0) and
stacked (`repro_torch.core.geometry.stack`), every kernel launches once
for all lanes, and each lane carries its own controls, stops on its own
counts and resumes bit for bit from ``resume_state``.  `entropic_gw` is a
batch of one on the same code path; only the rank restarts of
``plan_rank="auto"`` (`lowrank_descent`) run one problem at a time.

Entry points run on the CUDA device unless the caller passes ``device``
(e.g. ``device="cpu"`` for the plain PyTorch path); with no card and no
``device`` they raise.  Measures may be numpy arrays or tensors; the
caller's float32/float64 dtype is kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import functools
from typing import Sequence

from repro_torch.core import sinkhorn as sk
from repro_torch.core.coupling import (Coupling, FullCoupling,
                                       LowRankCoupling, coupling_delta,
                                       full_init, lowrank_init)
from repro_torch.core.geometry import (Geometry, as_geometry, stack,
                                       stack_lanes)
from repro_torch.core.gradient import GradientOperator, LowRankGradientOperator
from repro_torch.core.solver import (ConvergenceInfo, ImplicitSpec,
                                     MirrorCarry, SolveControls, fields_of,
                                     fixed_point_value, info_of, init_carry,
                                     mirror_descent, mirror_descent_segment,
                                     resolve_controls, tensor_leaves)


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
    #: reverse-mode gradient: "implicit" (the envelope term plus the
    #: Neumann fixed-point correction of `solver.fixed_point_value`) or
    #: "envelope" (the Danskin term only: exact as tol → 0, cheaper)
    grad_mode: str = "implicit"
    #: the backward's one-step map: dual-update pairs per T̃ (full plan)
    #: and Dykstra sweeps per T̃ (factored plan, whose projection re-walks
    #: its duals from zero)
    implicit_inner_steps: int = 1
    implicit_lr_sweeps: int = 25
    #: the Neumann series' cap and per-lane stop on its latest term's L1
    implicit_solve_iters: int = 60
    implicit_solve_tol: float = 1e-10
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

    def static_key(self) -> "GWConfig":
        """This cfg with the value knobs zeroed: the structural identity a
        serving cache keys on.  eps/tol/eps_init/anneal_decay/inner_loosen/
        lr_gamma reach the solver as `SolveControls`, so two configs that
        differ only in them run the same program; ``plan``, ``plan_rank``,
        ``cost_rank``, ``g_floor``, the caps and the backends survive."""
        return dataclasses.replace(self, eps=0.0, tol=0.0, eps_init=None,
                                   anneal_decay=0.0, inner_loosen=0.0,
                                   lr_gamma=0.0)

    def __post_init__(self):
        if self.plan not in ("full", "lowrank"):
            raise ValueError(
                f"unknown plan {self.plan!r}: expected 'full' or 'lowrank'")
        if self.grad_mode not in ("implicit", "envelope"):
            raise ValueError(
                f"unknown grad_mode {self.grad_mode!r}: expected "
                "'implicit' or 'envelope'")
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


def _on_lanes(op, *ts):
    """An operator built on one problem's geometries, and its tensors, as a
    batch of one (the step closures run on lanes); a batch's pass
    through."""
    if op.lanes is None:
        ts = tuple(t[None] for t in ts)
    return (op.on_lanes(),) + ts


def gw_step_fn(op: GradientOperator, c1, mu, nu, cfg: GWConfig):
    """The full-plan mirror-descent step closure over lanes (state: a
    lane-leading `FullCoupling`; ε and the inner tolerance (B,))."""
    op, c1, mu, nu = _on_lanes(op, c1, mu, nu)

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
    their place in `ConvergenceInfo`; err is the L1 row-marginal gap.  As
    `gw_step_fn`, it runs on lanes."""
    op, dx2, dy2, mu, nu = _on_lanes(op, dx2, dy2, mu, nu)

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
    operator (one problem's, or a batch's with lane-leading tensors).
    Returns ``(FullCoupling, ConvergenceInfo)``."""
    ctl = resolve_controls(cfg, controls, mu.device)
    if state0 is None:
        state0 = full_init(mu, nu)
    return mirror_descent(gw_step_fn(op, c1, mu, nu, cfg), state0,
                          coupling_delta, ctl, cfg.outer_iters,
                          op.lanes)


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

    The solve is `entropic_gw_batch`'s on a batch of one, unpadded, and is
    reverse-mode differentiable (see the module docstring); at
    ``plan_rank="auto"`` it is not.
    """
    return _solve_one(grid_x, grid_y, mu, nu, cfg, gamma0, controls, device)


def _requires_grad(*trees) -> bool:
    """Does a tensor of these trees (tuples, dataclasses) require grad,
    with grad mode on?"""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensor_leaves(trees))


def _solve_one(grid_x, grid_y, mu, nu, cfg: GWConfig, gamma0, controls,
               device, feature_cost=None) -> GWResult:
    """`entropic_gw` and, with ``feature_cost``, `fgw.entropic_fgw`."""
    dev = resolve_device(device)
    if cfg.plan == "lowrank":
        if gamma0 is not None:
            raise ValueError(
                "gamma0 is a dense-plan warm start; the factored path "
                "starts from its own feasible factors")
        if isinstance(cfg.plan_rank, str):
            if _requires_grad(grid_x, grid_y, mu, nu, feature_cost,
                              controls):
                raise ValueError(
                    "plan_rank='auto' restarts on the host's reading of "
                    "the residuals and is not differentiable: give a "
                    "static plan_rank to differentiate")
            return _entropic_lowrank_auto(
                grid_x, grid_y, as_tensor(mu, dev), as_tensor(nu, dev), cfg,
                resolve_controls(cfg, controls, dev),
                None if feature_cost is None else as_tensor(feature_cost,
                                                            dev))
    ops, gxs, gys = stack_problems(
        [(grid_x, grid_y, mu, nu)], cfg,
        controls=None if controls is None else [controls], device=dev,
        features=None if feature_cost is None else [feature_cost])
    state0 = None if gamma0 is None else full_init(
        ops[2], ops[3], as_tensor(gamma0, dev)[None].to(ops[2].dtype))
    return _solve_stacked(ops, state0, cfg, gxs, gys, 1)[0]


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


def _entropic_lowrank_auto(grid_x, grid_y, mu, nu, cfg: GWConfig,
                           ctl: SolveControls, feature_cost=None) -> GWResult:
    """Factored-plan entropic GW (FGW with ``feature_cost``) at
    ``plan_rank="auto"``: the factors are seeded from the converted
    geometries (the operator's factored pair), and the value is the
    objective at the final factors."""
    op = LowRankGradientOperator(grid_x, grid_y, cfg.backend, cfg.cost_rank,
                                 cfg.lowrank_backend)
    fsq = None if feature_cost is None else feature_cost ** 2
    coup, info = lowrank_descent(_lr_step(op, mu, nu, fsq, cfg, ctl.lr_gamma),
                                 mu, nu, cfg, ctl, op.geom_x, op.geom_y)
    return _result_of(coup, _lr_value(op, coup, fsq, cfg), info)


def _lr_step(op, mu, nu, fsq, cfg: GWConfig, lr_gamma):
    """The factored step closure of GW, or of FGW with the squared feature
    cost ``fsq`` (the solve's one (M, N) build)."""
    from repro_torch.core import fgw
    dx2, dy2 = op.constant_term(mu, nu)
    if fsq is None:
        return gw_lr_step_fn(op, dx2, dy2, mu, nu, cfg, lr_gamma)
    return fgw.fgw_lr_step_fn(op, dx2, dy2, fsq, cfg.theta, mu, nu, cfg,
                              lr_gamma)


def _lr_value(op, coup, fsq, cfg: GWConfig):
    """The GW energy of a factored plan, or its FGW objective."""
    from repro_torch.core import fgw
    if fsq is None:
        return op.energy(coup, cfg.g_floor)
    return fgw.fgw_lr_value(op, fsq, coup, cfg.theta, cfg.g_floor)


# ---------------------------------------------------------------------------
# batched solving: many problems as one set of lane-leading tensors
# ---------------------------------------------------------------------------

def _init_stacked(geoms_x, geoms_y, mus, nus, cfg: GWConfig,
                  state0: Coupling | None = None) -> MirrorCarry:
    """Fresh carries for a batch: the cold coupling start of every lane
    (product plan or rank-r factors, per ``cfg.plan``; the stacked
    geometries feed the k-means seeding), or the lane-leading ``state0``,
    with traces sized to the cfg's outer cap."""
    if state0 is None:
        state0 = gw_init_state(mus, nus, cfg=cfg, geom_x=geoms_x,
                               geom_y=geoms_y)
    return init_carry(state0, cfg.outer_iters, mus.device, mus.shape[0])


def _init_lane(geom_x, geom_y, mu, nu, cfg: GWConfig) -> MirrorCarry:
    """One problem's fresh carry (geometries as `stack_problems` converts
    them), the carry a freed slot of a batch takes."""
    return init_carry(gw_init_state(mu, nu, cfg=cfg, geom_x=geom_x,
                                    geom_y=geom_y), cfg.outer_iters,
                      mu.device)


def _segment_stacked(geoms_x, geoms_y, mus, nus, feats,
                     controls: SolveControls, carry: MirrorCarry,
                     cfg: GWConfig, segment: int | None = None):
    """Advance every lane of a batch's carry by ≤ ``segment`` outer steps
    and return (carry, values): ``values`` is each lane's GW energy (FGW
    objective, when ``feats`` holds the stacked feature costs) at its
    current plan.  One-shot and segmented solves both run this body, and
    the constant term is recomputed on each call from (geometry, μ, ν), so
    a solve cut into segments equals an uninterrupted one bit for bit."""
    from repro_torch.core import fgw
    if cfg.plan == "lowrank":
        op = LowRankGradientOperator(geoms_x, geoms_y, cfg.backend,
                                     cfg.cost_rank, cfg.lowrank_backend)
        fsq = None if feats is None else feats ** 2
        carry = mirror_descent_segment(
            _lr_step(op, mus, nus, fsq, cfg, controls.lr_gamma),
            coupling_delta, controls, cfg.outer_iters, carry, segment)
        return carry, _lr_value(op, carry.state, fsq, cfg)
    op = GradientOperator(geoms_x, geoms_y, cfg.backend)
    c1, dx2_mu, dy2_nu = op.constant_term(mus, nus)
    if feats is None:
        carry = gw_plan_segment(op, c1, mus, nus, cfg, controls, carry,
                                segment)
        return carry, op.energy(carry.state.plan, dx2_mu, dy2_nu)
    c2 = (1.0 - cfg.theta) * feats ** 2 + cfg.theta * c1
    carry = mirror_descent_segment(
        fgw.fgw_step_fn(op, c2, cfg.theta, mus, nus, cfg), coupling_delta,
        controls, cfg.outer_iters, carry, segment)
    return carry, fgw.fgw_full_value(op, feats, carry.state.plan, cfg.theta)


# ---------------------------------------------------------------------------
# the implicit-differentiation spec: a stack's inputs are
# (geoms_x, geoms_y, mus, nus, feats, state0), lane-leading
# ---------------------------------------------------------------------------

def _implicit_solve(cfg: GWConfig, inputs, controls):
    """`ImplicitSpec.solve`: the forward solve of every lane, any backend,
    and its value (`_segment_stacked` from a cold or given start)."""
    gx, gy, mus, nus, feats, state0 = inputs
    carry, values = _segment_stacked(
        gx, gy, mus, nus, feats, controls,
        _init_stacked(gx, gy, mus, nus, cfg, state0), cfg)
    return carry.state, info_of(carry), values


def _implicit_step(cfg: GWConfig, state, inputs, controls):
    """`ImplicitSpec.step`: ONE differentiable mirror step T̃ at the
    converged state, plain PyTorch, at the target ε.

    Full plan: the linearized cost at the plan, ``implicit_inner_steps``
    warm-started dual-update pairs, the plan reassembled.  Factored plan:
    the LR gradients (plain route), the prox kernels and
    ``implicit_lr_sweeps`` Dykstra sweeps, everything (N, r)-sized for GW;
    T̃ is the DOUBLE mirror step: the factored solver converges to a
    period-2 orbit in factor space (the plan is fixed, but Dykstra's
    zero-dual restart flips (Q, R, g) between two gauge representatives),
    so only T̃² has a fixed point to linearize."""
    from repro_torch.core import fgw
    gx, gy, mus, nus, feats, _ = inputs
    eps = controls.eps
    if cfg.plan == "lowrank":
        op = LowRankGradientOperator(gx, gy, cfg.backend, cfg.cost_rank,
                                     "torch")
        dx2, dy2 = op.constant_term(mus, nus)
        fsq = None if feats is None else feats ** 2

        def half(st):
            if fsq is None:
                grads = op.grads(st, dx2, dy2, cfg.g_floor)
            else:
                grads = fgw.fgw_lr_grads(op, st, dx2, dy2, fsq, cfg.theta,
                                         cfg.g_floor)
            return LowRankCoupling(*sk.lr_mirror_step_diff(
                st.q, st.r, st.g, *grads, mus, nus, eps, controls.lr_gamma,
                cfg.implicit_lr_sweeps, cfg.g_floor))

        return half(half(state))
    op = GradientOperator(gx, gy, cfg.backend)
    c1, _, _ = op.constant_term(mus, nus)
    if feats is None:
        cost = op.grad(state.plan, c1)
    else:
        th = cfg.theta
        cost = ((1.0 - th) * feats ** 2 + th * c1
                - 4.0 * th * op.product(state.plan))
    f, g = sk.sinkhorn_step_diff(cost, mus, nus, eps, state.f, state.g,
                                 cfg.implicit_inner_steps)
    e3 = sk._as_eps(eps, mus)[:, None, None]
    return FullCoupling(torch.exp((f[:, :, None] + g[:, None, :] - cost)
                                  / e3), f, g)


def _implicit_value_bwd(cfg: GWConfig, state, inputs, controls):
    """`ImplicitSpec.value_bwd`: the objective at the plan's OWN marginals
    (E(Γ) depends on μ, ν only through the constraint, which the implicit
    term owns), on the plain factored route."""
    from repro_torch.core import fgw
    gx, gy, _, _, feats, _ = inputs
    if cfg.plan == "lowrank":
        return _lr_value(LowRankGradientOperator(
            gx, gy, cfg.backend, cfg.cost_rank, "torch"), state,
            None if feats is None else feats ** 2, cfg)
    op = GradientOperator(gx, gy, cfg.backend)
    if feats is None:
        return op.energy(state.plan)
    return fgw.fgw_full_value(op, feats, state.plan, cfg.theta)


def implicit_spec(cfg: GWConfig) -> ImplicitSpec:
    """The `ImplicitSpec` of a GW/FGW config."""
    return ImplicitSpec(solve=functools.partial(_implicit_solve, cfg),
                        step=functools.partial(_implicit_step, cfg),
                        value_bwd=functools.partial(_implicit_value_bwd,
                                                    cfg),
                        grad_mode=cfg.grad_mode,
                        solve_iters=cfg.implicit_solve_iters,
                        solve_tol=cfg.implicit_solve_tol)


def _solve_stacked(ops, state0, cfg: GWConfig, gxs, gys,
                   k: int) -> list[GWResult]:
    """A stack's one-shot solve: one `fixed_point_value` call for every
    lane, then the first ``k`` lanes sliced back to their sizes."""
    inputs = ops[:5] + (state0,)
    if _requires_grad(inputs, ops[5]) and any(
            getattr(g, "backend", None) == "kernel" for g in ops[:2]):
        raise NotImplementedError(
            "cannot differentiate through the FGC kernel backend (a grid "
            "on backend='kernel'): its scan has no backward, as the "
            "reference's Pallas scan has none (jax.grad raises "
            "AssertionError there).  Solve with backend='cumsum'; the "
            "Sinkhorn and factored-plan kernels differentiate")
    value, state, info = fixed_point_value(implicit_spec(cfg), inputs,
                                           ops[5])
    return _unpack_results(info, state, value, gxs, gys, k)


def _pad_to(vec, size: int):
    return vec if size == vec.shape[0] else \
        torch.nn.functional.pad(vec, (0, size - vec.shape[0]))


def _stack_side(geoms: Sequence[Geometry], measures, pad: int | None):
    """Validate one side of a batch, pad every geometry to the bucket size,
    and stack (geometries lane-leading, measures zero-padded)."""
    for g, m in zip(geoms, measures):
        if m.shape[0] != g.size:
            raise ValueError(
                f"measure length {m.shape[0]} != geometry size {g.size} — "
                "bucket padding would silently absorb the mismatch")
    keys = {g.batch_key() for g in geoms}
    if len(keys) != 1:
        raise ValueError(
            "batch requires compatible geometries per side (one class and "
            f"one set of static params); got keys {sorted(map(str, keys))}")
    sizes = [g.size for g in geoms]
    if not geoms[0].paddable:
        if len(set(sizes)) != 1 or (pad is not None and pad != sizes[0]):
            raise ValueError(
                f"{type(geoms[0]).__name__} batches must be equal-sized")
        n = sizes[0]
    else:
        n = max(sizes) if pad is None else pad
        if n < max(sizes):
            raise ValueError(f"pad_to={pad} < largest problem {max(sizes)}")
    # each geometry keeps its data's dtype: forcing the measures' dtype
    # would downcast f64 geometry data under f32 measures
    dt = functools.reduce(torch.promote_types, [m.dtype for m in measures])
    return (stack([g.pad_to(n) for g in geoms]),
            stack_lanes([_pad_to(m.to(dt), n) for m in measures]))


def stack_controls(controls, cfg: GWConfig, n: int,
                   device=None) -> SolveControls:
    """Per-lane SolveControls for a batch of ``n`` problems, (n,) float64
    tensors on ``device``.  ``controls`` may be None (every lane gets the
    cfg's knobs), one SolveControls (shared), or a sequence of exactly
    ``n`` per-problem SolveControls — a short list is an error, not a
    silent replication."""
    if controls is None:
        ctls = [SolveControls.from_config(cfg, device)] * n
    elif isinstance(controls, SolveControls):
        ctls = [controls] * n
    else:
        ctls = list(controls)
        if len(ctls) != n:
            raise ValueError(
                f"{len(ctls)} controls for {n} problems — per-problem "
                "controls must match the (padded) problem list exactly")
    return SolveControls(*(
        torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                     device=device).reshape(())
                     for v in vals])
        for vals in zip(*(fields_of(c) for c in ctls))))


def _unpack_results(info: ConvergenceInfo, coupling: Coupling, values,
                    gxs, gys, k: int) -> list[GWResult]:
    """Slice per-lane results back to their true (unpadded) sizes."""
    return [_result_of(coupling.lane(i).slice_to(gxs[i].size, gys[i].size),
                       values[i], info.lane(i)) for i in range(k)]


def _stack_features(features, problems, gxs, gys, m: int, n: int, device):
    """Stack per-problem FGW feature costs on ``device``, zero-padded to
    the bucket shape: padded rows and columns meet zero-mass atoms, whose
    plan (factor) entries are exactly 0.  None (a GW batch) passes
    through; a mixed batch is an error."""
    if features is None or all(f is None for f in features):
        return None
    if any(f is None for f in features):
        raise ValueError(
            "mixed GW/FGW batches are not supported: features must be all "
            "None or all arrays (serve them as separate buckets)")
    if len(features) != len(problems):
        raise ValueError(
            f"{len(features)} features for {len(problems)} problems")
    feats = []
    for f, gx, gy in zip(features, gxs, gys):
        f = as_tensor(f, device)
        if tuple(f.shape) != (gx.size, gy.size):
            raise ValueError(
                f"feature cost shape {tuple(f.shape)} != problem sizes "
                f"({gx.size}, {gy.size})")
        feats.append(torch.nn.functional.pad(
            f, (0, n - f.shape[1], 0, m - f.shape[0])))
    return stack_lanes(feats)


def stack_problems(problems: Sequence[tuple], cfg: GWConfig,
                   pad_to: tuple[int, int] | None = None, controls=None,
                   device=None, features=None):
    """Pad + stack a problem list into the batch's operands
    ``(geoms_x, geoms_y, mus, nus, feats, controls)``, plus the adapted
    per-problem geometries (for slicing results back).  Measures and
    feature costs are moved to ``device`` (default: the card); ``feats`` is
    None for a GW batch (see `_stack_features`)."""
    dev = resolve_device(device)
    gxs = [as_geometry(p[0], cfg.backend) for p in problems]
    gys = [as_geometry(p[1], cfg.backend) for p in problems]
    if cfg.plan == "lowrank":
        _static_rank(cfg)   # "auto" cannot ride a fixed-shape lane
        # convert BEFORE padding: a padded point cloud would factor its
        # origin-sitting padding atoms into nonzero rows, while padding the
        # factors appends exact zero rows
        gxs = [g.for_factored_plan(cfg.cost_rank) for g in gxs]
        gys = [g.for_factored_plan(cfg.cost_rank) for g in gys]
    geoms_x, mus = _stack_side(gxs, [as_tensor(p[2], dev) for p in problems],
                               pad_to and pad_to[0])
    geoms_y, nus = _stack_side(gys, [as_tensor(p[3], dev) for p in problems],
                               pad_to and pad_to[1])
    feats = _stack_features(features, problems, gxs, gys, mus.shape[1],
                            nus.shape[1], dev)
    ctls = stack_controls(controls, cfg, len(problems), dev)
    return (geoms_x, geoms_y, mus, nus, feats, ctls), gxs, gys


def entropic_gw_batch(problems: Sequence[tuple], cfg: GWConfig = GWConfig(),
                      pad_to: tuple[int, int] | None = None,
                      num_results: int | None = None, controls=None,
                      resume_state: MirrorCarry | None = None,
                      max_outer_segment: int | None = None, features=None,
                      device=None):
    """Solve a batch of GW problems ``[(geom_x, geom_y, mu, nu), ...]`` as
    one set of lane-leading tensors.  Geometries may be raw Grids (adapted
    with ``cfg.backend``) or any Geometry — low-rank, point-cloud, dense;
    their tensors must lie on the solve's device (``device``, default the
    card).

    Ragged sizes are padded to the max (or to ``pad_to=(M, N)``) with
    zero-mass points, which the solvers treat exactly, so each result
    matches the solo solve of its problem, `ConvergenceInfo` included:
    with ``tol>0`` each lane stops on its own counts.  Per side, geometries
    must share their static params (grid class and ``k``, low-rank rank,
    point dimension and metric) but may differ in data (spacing ``h``,
    factors, points) and, where the geometry is paddable, in size.  Grid2D
    problems must be equal-sized.  With ``cfg.plan="lowrank"`` point
    clouds convert to their factors before padding, and ``plan_rank``
    must be an int.

    Returns per-problem GWResults sliced back to their true sizes;
    ``num_results`` unpacks only the first so many.  ``controls`` gives
    every problem its own knobs (see `stack_controls`).

    ``features`` optionally gives every problem an FGW feature-cost matrix
    of shape ``(geom_x.size, geom_y.size)``; ``cfg`` must then be an
    `repro_torch.core.fgw.FGWConfig` (its ``theta`` weights the feature
    term).  All-None and all-array are the two supported shapes.

    Segmented mode: with ``max_outer_segment=k`` every lane advances at
    most ``k`` outer steps and the call returns ``(results,
    resume_state)``; passing ``resume_state`` back with the same problems
    continues the solve, bit for bit as an uninterrupted one.
    ``resume_state`` alone runs the remaining steps to completion.  A
    segmented solve is not differentiable; a one-shot one is, all lanes
    through one `fixed_point_value` call, each lane's gradient its solo
    solve's.
    """
    segmented = (resume_state is not None) or (max_outer_segment is not None)
    if not problems:
        return ([], None) if segmented else []
    if (features is not None and any(f is not None for f in features)
            and not hasattr(cfg, "theta")):
        raise ValueError(
            "features given but cfg has no feature weight: pass an "
            "FGWConfig (with theta) instead of a GWConfig")
    ops, gxs, gys = stack_problems(problems, cfg, pad_to, controls, device,
                                   features)
    k = len(problems) if num_results is None else num_results
    if not segmented:
        return _solve_stacked(ops, None, cfg, gxs, gys, k)
    if _requires_grad(ops):
        raise ValueError(
            "segmented solves (max_outer_segment, resume_state) are not "
            "differentiable: solve in one call to differentiate")
    carry = resume_state if resume_state is not None \
        else _init_stacked(*ops[:4], cfg)
    carry, values = _segment_stacked(*ops, carry, cfg, max_outer_segment)
    return _unpack_results(info_of(carry), carry.state, values, gxs, gys,
                           k), carry
