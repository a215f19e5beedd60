"""Sinkhorn solvers for the entropic-OT subproblem of each mirror-descent
step.

Reference: ``repro/core/sinkhorn.py`` (balanced log and kernel modes, the
unbalanced log mode of UGW, the factored plan's log-domain Dykstra
projection and mirror step, and the differentiable one-step maps
`sinkhorn_step_diff` and `lr_mirror_step_diff`).

Conventions: plan γ_ip = exp((f_i + g_p − C_ip)/ε); marginals Σ_p γ = μ,
Σ_i γ = ν.  Log mode is the default (the paper's ε = 0.002 underflows the
kernel exp(−C/ε)); kernel mode is the paper-literal matvec iteration.

The ``*_chunked`` variants stop early: a host loop runs ``chunk`` updates,
then evaluates the residual and synchronises once on it — once per chunk,
never once per iteration.  ``tol=0`` performs exactly ``iters`` updates,
bit-identical to the fixed loop, because both run the same step closure
from one ``_*_pieces`` function.

Log-mode dual updates have a backend knob (resolved by
`repro_torch.kernels.ops.resolve_sinkhorn_backend`): ``"kernel"`` runs each
half-step through the hand-written CUDA kernels (one pass over C per
half-step, ε read from device memory), ``"torch"`` the plain PyTorch
expressions, ``"auto"`` the kernels on a CUDA device and the plain
expressions on the CPU.

Reverse-mode differentiation never runs these loops backwards: the
implicit surface (`repro_torch.core.solver.fixed_point_value`) linearizes
ONE differentiable application of the dual update at the converged state.
`sinkhorn_step_diff` (full plan) and `lr_mirror_step_diff` (factored plan)
are those one-step maps: plain PyTorch ops, with zero-mass-safe logs and
logsumexps so padded atoms get exact-zero cotangents instead of NaN.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.geometry import _lanes_mm, lane_l1, per_lane
from repro_torch.kernels import lr_step, sinkhorn_step
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class SinkhornConfig:
    eps: float = 1e-2
    iters: int = 100
    mode: str = "log"  # "log" | "kernel"
    #: log-mode dual-update backend: "auto" | "kernel" | "torch"
    backend: str = "auto"


def _safe_log(w):
    """log with −inf at zero mass AND a zero (not NaN) gradient there: the
    inner where keeps log(0) out of the graph."""
    return torch.where(w > 0, torch.log(torch.where(w > 0, w,
                                                    torch.ones_like(w))),
                       torch.full_like(w, -torch.inf))


def safe_logsumexp(z, dim=-1):
    """logsumexp whose gradient is exact-zero on all-(−inf) slices (the
    standard one's is 0/0 = NaN there, and a NaN survives a zero
    cotangent).  The max shift is detached, as the reference's
    ``stop_gradient``; dead (−inf) entries are masked before
    exponentiating.  Values match the standard implementation, −inf on
    all −inf slices."""
    m = torch.amax(z, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    live = z > -torch.inf
    e = torch.where(live, torch.exp(torch.where(live, z,
                                                torch.zeros_like(z)) - m),
                    torch.zeros_like(z))
    s = e.sum(dim=dim)
    out = torch.log(torch.where(s > 0, s, torch.ones_like(s))) + m.squeeze(dim)
    return torch.where(s > 0, out, torch.full_like(out, -torch.inf))


def zero_mass_potentials(mu, nu):
    """Initial (f, g) with −inf on zero-mass atoms — their exact value at
    the Sinkhorn fixed point."""
    f = torch.where(mu > 0, torch.zeros_like(mu),
                    torch.full_like(mu, -torch.inf))
    g = torch.where(nu > 0, torch.zeros_like(nu),
                    torch.full_like(nu, -torch.inf))
    return f, g


def _as_eps(eps, like):
    """ε (a float, a 0-d or a (B,) tensor) as the (B,) tensor of ``like``'s
    dtype and device the lanes of ``like`` (B, ·) read: a scalar is every
    lane's."""
    return kops._lane_eps(eps, like.shape[0], like)


def _as_tol(tol, like):
    """A tolerance as the (B,) float64 tensor the lanes compare against."""
    tol = torch.as_tensor(tol, dtype=torch.float64, device=like.device)
    return tol.expand(like.shape[0]) if tol.dim() == 0 else tol


def _lift(solo: bool, *ts):
    """One problem's tensors with a lane axis of one (None stays None)."""
    return tuple(t if t is None or not solo else t[None] for t in ts)


def _drop(solo: bool, *ts):
    return tuple(t[0] if solo else t for t in ts)


def _select(live, new, old):
    """``new`` on the lanes where the (B,) mask ``live`` holds, ``old``
    elsewhere, for a tuple of lane-leading tensors."""
    return tuple(torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)),
                             n, o) for n, o in zip(new, old))


# ---------------------------------------------------------------------------
# per-mode pieces: ONE home for each dual update + plan assembly, used by
# both the fixed loops and the chunked early-stopping loops.  Every piece
# takes B lanes: cost (B, M, N), measures (B, ·), ε (B,); a single problem
# is one lane.
# ---------------------------------------------------------------------------

def _log_pieces(cost, mu, nu, eps, backend: str = "torch",
                cost_dtype: str = "f32"):
    """step((f,g))->(f,g) and plan_err((f,g))->(plan, (B,) L1 row-marginal
    gaps).

    ``backend`` selects the dual update: the plain expressions below, or the
    CUDA half-step kernels, one launch a half-step for all lanes.
    ``cost_dtype="bf16"`` makes the kernels read C as bfloat16 (cast once
    per solve; the plain expressions, the plan and the residual ignore it).
    """
    # one ε dtype for every entry point (the reference's rule): the fixed
    # and the chunked loops must feed the update the same ε, or tol=0
    # "chunked == fixed" stops being bit-identical
    eps = _as_eps(eps, mu)
    log_mu = torch.log(mu)
    log_nu = torch.log(nu)

    if kops.resolve_sinkhorn_backend(backend, mu.device) == "kernel":
        cost_k = kops.cast_cost(cost.contiguous(), cost_dtype)

        def step(carry):
            _f, g = carry
            fn = kops.sinkhorn_row_update_batched(cost_k, g, log_mu, eps)
            gn = kops.sinkhorn_col_update_batched(cost_k, fn, log_nu, eps)
            return fn, gn
    else:
        # the kernels' plain versions
        def step(carry):
            _f, g = carry
            fn = sinkhorn_step.row_update_plain(cost, g, log_mu, eps)
            gn = sinkhorn_step.col_update_plain(cost, fn, log_nu, eps)
            return fn, gn

    e3 = eps[:, None, None]

    def plan_err(carry):
        f, g = carry
        plan = torch.exp((f[:, :, None] + g[:, None, :] - cost) / e3)
        return plan, (plan.sum(dim=2) - mu).abs().sum(dim=1)

    return step, plan_err


def _matvec(mat, v):
    """mat_b v_b for each lane, lane-count-invariant
    (`geometry._lanes_mm`)."""
    return _lanes_mm(mat, v[:, :, None])[:, :, 0]


def _kernel_pieces(cost, mu, nu, eps):
    """Kernel-domain pieces, stabilized by a dual shift: subtracting row/col
    minima from C changes the scalings a, b but not the plan.  The matrix
    products are batched over the lanes."""
    e3 = _as_eps(eps, mu)[:, None, None]
    rmin = cost.amin(dim=2, keepdim=True)
    cmin = (cost - rmin).amin(dim=1, keepdim=True)
    K = torch.exp(-(cost - rmin - cmin) / e3)
    Kt = K.transpose(1, 2)

    def step(a):
        return mu / _matvec(K, nu / _matvec(Kt, a))

    def plan_err(a):
        b = nu / _matvec(Kt, a)
        plan = a[:, :, None] * K * b[:, None, :]
        return plan, b, (plan.sum(dim=2) - mu).abs().sum(dim=1)

    return step, plan_err


def _unbalanced_pieces(cost, mu, nu, eps, rho_x, rho_y):
    """Unbalanced log-domain pieces over lanes: step((f,g))->(f,g) and
    plan_of((f,g)).  The KL penalties damp each dual update by
    t = ρ/(ρ + ε); ε, ρ_x and ρ_y are scalars or (B,).  Plain PyTorch: the
    reference computes this update outside any Pallas kernel too."""
    eps = _as_eps(eps, mu)
    rho_x = _as_eps(rho_x, mu)
    rho_y = _as_eps(rho_y, mu)
    tx = (rho_x / (rho_x + eps))[:, None]
    ty = (rho_y / (rho_y + eps))[:, None]
    e2 = eps[:, None]
    e3 = e2[:, :, None]
    log_mu = torch.log(mu)
    log_nu = torch.log(nu)

    def step(carry):
        _f, g = carry
        lse_r = sinkhorn_step._lse((g[:, None, :] - cost) / e3
                                   + log_nu[:, None, :], 2)
        fn = -tx * e2 * lse_r
        lse_c = sinkhorn_step._lse((fn[:, :, None] - cost) / e3
                                   + log_mu[:, :, None], 1)
        return fn, -ty * e2 * lse_c

    def plan_of(carry):
        f, g = carry
        return torch.exp((f[:, :, None] + g[:, None, :] - cost) / e3
                         + log_mu[:, :, None] + log_nu[:, None, :])

    return step, plan_of


def _chunked_loop(carry0, step_fn, residual_fn, iters: int, chunk: int, tol):
    """The chunked early-stopping scaffold over lanes: sweeps of ``chunk``
    updates (the last one cut at the global ``iters`` cap), each followed
    by the (B,) ``residual_fn(new_carry, old_carry)`` and ONE host read of
    which lanes are still over their own (B,) ``tol``.  A lane at or under
    its tol is frozen from then on: the chunks still update every lane, and
    a select keeps the old carry on the frozen ones, as the reference's
    vmapped while_loop does.  ``tol=0`` performs exactly ``iters`` updates.
    Returns (carry, iters_used per lane)."""
    lanes = tol.shape[0]
    live = [True] * lanes
    used = [0] * lanes
    carry, it = carry0, 0
    while it < iters and any(live):
        old = carry
        mask = None if all(live) else torch.tensor(live, device=tol.device)
        n = min(chunk, iters - it)
        for _ in range(n):
            carry = step_fn(carry) if mask is None else \
                _select(mask, step_fn(carry), carry)
        it += n
        over = (residual_fn(carry, old) > tol).tolist()
        for b in range(lanes):
            if live[b]:
                used[b], live[b] = it, over[b]
    return carry, used


# ---------------------------------------------------------------------------
# solvers: each takes one problem (cost (M, N)) or B lanes (cost (B, M, N),
# ε and tol scalars or (B,)); the lanes' iteration counts come back as a
# list
# ---------------------------------------------------------------------------

def sinkhorn_log(cost, mu, nu, eps, iters: int, f0=None, g0=None,
                 backend: str = "torch"):
    """Log-domain Sinkhorn.  Returns (plan, f, g, err) — err = L1 row-marginal
    gap."""
    solo = cost.dim() == 2
    cost, mu, nu, f0, g0 = _lift(solo, cost, mu, nu, f0, g0)
    step, plan_err = _log_pieces(cost, mu, nu, eps, backend)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    for _ in range(iters):
        carry = step(carry)
    plan, err = plan_err(carry)
    return _drop(solo, plan, carry[0], carry[1], err)


def sinkhorn_log_chunked(cost, mu, nu, eps, iters: int, chunk: int, tol,
                         f0=None, g0=None, backend: str = "torch",
                         cost_dtype: str = "f32"):
    """Log-domain Sinkhorn with chunked early stopping.

    Returns (plan, f, g, err, iters_used).  ``tol=0`` runs exactly ``iters``
    updates, so it reproduces :func:`sinkhorn_log` bit-for-bit; ``tol>0``
    stops each lane at the first chunk whose L1 row-marginal gap is ≤ its
    tol.
    """
    solo = cost.dim() == 2
    cost, mu, nu, f0, g0 = _lift(solo, cost, mu, nu, f0, g0)
    step, plan_err = _log_pieces(cost, mu, nu, eps, backend, cost_dtype)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    carry, used = _chunked_loop(carry, step,
                                lambda new, _old: plan_err(new)[1],
                                iters, chunk, _as_tol(tol, mu))
    plan, err = plan_err(carry)
    return _drop(solo, plan, carry[0], carry[1], err) + \
        (used[0] if solo else used,)


def sinkhorn_kernel(cost, mu, nu, eps, iters: int, a0=None):
    """Kernel-domain Sinkhorn (paper-literal matvec iteration)."""
    solo = cost.dim() == 2
    cost, mu, nu, a0 = _lift(solo, cost, mu, nu, a0)
    step, plan_err = _kernel_pieces(cost, mu, nu, eps)
    a = torch.ones_like(mu) if a0 is None else a0
    for _ in range(iters):
        a = step(a)
    plan, b, err = plan_err(a)
    return _drop(solo, plan, a, b, err)


def sinkhorn_kernel_chunked(cost, mu, nu, eps, iters: int, chunk: int, tol,
                            a0=None):
    """Kernel-domain counterpart of :func:`sinkhorn_log_chunked`.
    Returns (plan, a, b, err, iters_used)."""
    solo = cost.dim() == 2
    cost, mu, nu, a0 = _lift(solo, cost, mu, nu, a0)
    step, plan_err = _kernel_pieces(cost, mu, nu, eps)
    a = torch.ones_like(mu) if a0 is None else a0
    (a,), used = _chunked_loop((a,), lambda c: (step(c[0]),),
                               lambda new, _old: plan_err(new[0])[2],
                               iters, chunk, _as_tol(tol, mu))
    plan, b, err = plan_err(a)
    return _drop(solo, plan, a, b, err) + (used[0] if solo else used,)


def sinkhorn_unbalanced_log(cost, mu, nu, eps, rho_x, rho_y, iters: int,
                            f0=None, g0=None):
    """Unbalanced log-domain Sinkhorn: KL marginal penalties rho_x/rho_y.

    Solves min_γ ⟨C,γ⟩ + rho_x KL(γ1|μ) + rho_y KL(γᵀ1|ν) + ε KL(γ|μ⊗ν),
    plan γ = exp((f⊕g − C)/ε)·(μ⊗ν).  Takes one problem or B lanes.
    Returns (plan, f, g)."""
    solo = cost.dim() == 2
    cost, mu, nu, f0, g0 = _lift(solo, cost, mu, nu, f0, g0)
    step, plan_of = _unbalanced_pieces(cost, mu, nu, eps, rho_x, rho_y)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    for _ in range(iters):
        carry = step(carry)
    return _drop(solo, plan_of(carry), *carry)


def sinkhorn_unbalanced_log_chunked(cost, mu, nu, eps, rho_x, rho_y,
                                    iters: int, chunk: int, tol, f0=None,
                                    g0=None):
    """Unbalanced log-domain Sinkhorn with chunked early stopping.

    Returns (plan, f, g, drift, iters_used).  Unbalanced plans satisfy no
    exact marginal, so each lane's residual is its fixed-point drift: the
    L∞ change of f plus that of g across its last chunk (a chunk cut at
    the cap counts what it ran; a lane stopped early keeps the drift it
    stopped on).  ``tol=0`` runs exactly ``iters`` updates, as
    :func:`sinkhorn_unbalanced_log`."""
    solo = cost.dim() == 2
    cost, mu, nu, f0, g0 = _lift(solo, cost, mu, nu, f0, g0)
    step, plan_of = _unbalanced_pieces(cost, mu, nu, eps, rho_x, rho_y)
    tol = _as_tol(tol, mu)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    # `_chunked_loop` freezes a lane once its drift is ≤ tol; its later
    # drifts are 0, so each lane's drift is kept from its last live check
    last = torch.full(tol.shape, torch.inf, dtype=mu.dtype, device=mu.device)

    def residual(new, old):
        nonlocal last
        drift = ((new[0] - old[0]).abs().amax(dim=1)
                 + (new[1] - old[1]).abs().amax(dim=1))
        last = torch.where(last > tol, drift, last)
        return drift

    carry, used = _chunked_loop(carry, step, residual, iters, chunk, tol)
    return _drop(solo, plan_of(carry), carry[0], carry[1], last) + \
        (used[0] if solo else used,)


def _warm_scalings(f0, eps):
    """Potentials → kernel scalings a0 = exp((f0 − shift)/ε), each lane
    shifted by its largest finite potential (scalings are defined up to a
    scalar); −inf (zero-mass) entries map to 0.  ``f0`` is (B, M), ε
    (B,)."""
    if f0 is None:
        return None
    shift = torch.amax(torch.where(torch.isfinite(f0), f0,
                                   torch.full_like(f0, -torch.inf)),
                       dim=-1, keepdim=True)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    return torch.exp((f0 - shift) / eps[:, None])


def solve(cost, mu, nu, cfg: SinkhornConfig, f0=None, g0=None):
    if cfg.mode == "log":
        return sinkhorn_log(cost, mu, nu, cfg.eps, cfg.iters, f0, g0,
                            cfg.backend)
    solo = cost.dim() == 2
    cost, mu, nu, f0 = _lift(solo, cost, mu, nu, f0)
    plan, a, b, err = sinkhorn_kernel(
        cost, mu, nu, cfg.eps, cfg.iters,
        _warm_scalings(f0, _as_eps(cfg.eps, mu)))
    # scalings → potentials, so a warm start is mode-agnostic
    return _drop(solo, plan, cfg.eps * torch.log(a), cfg.eps * torch.log(b),
                 err)


def solve_adaptive(cost, mu, nu, eps, iters: int, chunk: int, tol,
                   mode: str = "log", f0=None, g0=None,
                   backend: str = "torch", cost_dtype: str = "f32"):
    """Mode dispatch for the convergence-controlled outer loop.  Returns
    (plan, f, g, err, iters_used) with warm-startable potentials in either
    mode; ``backend`` applies to log mode (kernel mode is plain PyTorch,
    its matrix products batched over the lanes)."""
    if mode == "log":
        return sinkhorn_log_chunked(cost, mu, nu, eps, iters, chunk, tol,
                                    f0, g0, backend, cost_dtype)
    solo = cost.dim() == 2
    cost, mu, nu, f0 = _lift(solo, cost, mu, nu, f0)
    eps = _as_eps(eps, mu)
    plan, a, b, err, used = sinkhorn_kernel_chunked(
        cost, mu, nu, eps, iters, chunk, tol, _warm_scalings(f0, eps))
    e2 = eps[:, None]
    return _drop(solo, plan, e2 * torch.log(a), e2 * torch.log(b), err) + \
        (used[0] if solo else used,)


# ---------------------------------------------------------------------------
# low-rank coupling subproblem (Scetbon et al. 2021): one mirror step on the
# (Q, R, g) factors, solved by log-domain Dykstra iterations
# ---------------------------------------------------------------------------

def _lr_dykstra_pieces(lk_q, lk_r, lk_g, mu, nu, log_floor,
                       backend: str = "torch", cost_dtype: str = "f32",
                       lse=sinkhorn_step._lse):
    """state0, sweep, residual for the log-domain Dykstra projection, over
    lanes: lk (B, N, r), lk_g (B, r), measures (B, ·).

    ``backend`` (resolved by `repro_torch.kernels.ops.
    resolve_lowrank_backend`) selects block 1 of the sweep: ``"kernel"``
    runs each factor side as ONE call of the B5 kernel for all lanes (the
    row duals and the column LSE at those duals in one pass over the
    (N, r) log-kernels, read as bfloat16 under ``cost_dtype="bf16"``);
    ``"torch"`` runs the same function as the kernel's plain version, the
    reference's XLA expressions.  The (r,)-sized dual algebra and the
    residual are plain PyTorch under either backend.

    ``lse`` is the logsumexp of the plain sweep: the forward solvers keep
    the kernel's plain version's, the differentiable one-step map passes
    `safe_logsumexp` (a padded atom's log-kernel row is all −inf, whose
    standard-logsumexp gradient is NaN).
    """
    ft = mu.dtype
    log_mu = _safe_log(mu)
    log_nu = _safe_log(nu)
    zr = torch.zeros(lk_g.shape, dtype=ft, device=mu.device)
    state0 = (torch.zeros_like(mu), torch.zeros_like(nu), zr, zr,
              lk_g.to(ft), zr, zr, zr, zr)

    if kops.resolve_lowrank_backend(backend, mu.device) == "kernel":
        # cast once per projection, not once per sweep
        lkq_k = kops.cast_cost(lk_q.contiguous(), cost_dtype)
        lkr_k = kops.cast_cost(lk_r.contiguous(), cost_dtype)

        def block1(g1, g2):
            f1, cq = kops.lr_dykstra_half_batched(lkq_k, g1, log_mu,
                                                  cost_dtype)
            f2, cr = kops.lr_dykstra_half_batched(lkr_k, g2, log_nu,
                                                  cost_dtype)
            return f1, f2, cq, cr
    else:
        def block1(g1, g2):
            f1, cq = lr_step.dykstra_half_plain(lk_q, g1, log_mu, lse)
            f2, cr = lr_step.dykstra_half_plain(lk_r, g2, log_nu, lse)
            return f1, f2, cq, cr

    def sweep(s):
        _f1, _f2, g1, g2, h, w_gi, w_gp, w_q, w_r = s
        # block 1: exact row scalings (zero-mass rows pinned to −inf) and
        # the floored g
        f1, f2, cq, cr = block1(g1, g2)
        hp = h + w_gi
        h = torch.maximum(hp, log_floor)
        w_gi = hp - h
        # block 2: couple the column marginals of Q and R to g
        gq = g1 + cq
        gr = g2 + cr
        hn = ((h + w_gp) + (gq + w_q) + (gr + w_r)) / 3.0
        g1 = g1 + (hn - gq)
        g2 = g2 + (hn - gr)
        w_q = (gq + w_q) - hn
        w_r = (gr + w_r) - hn
        w_gp = (h + w_gp) - hn
        return f1, f2, g1, g2, hn, w_gi, w_gp, w_q, w_r

    def residual(s, _old):
        f1, f2, g1, g2 = s[0], s[1], s[2], s[3]
        row_q = torch.exp(f1 + sinkhorn_step._lse(g1[:, None, :] + lk_q, 2))
        row_r = torch.exp(f2 + sinkhorn_step._lse(g2[:, None, :] + lk_r, 2))
        # one sum a lane: the residual decides when a lane stops
        return per_lane(lane_l1, row_q - mu) + per_lane(lane_l1, row_r - nu)

    return state0, sweep, residual


def lr_dykstra_log(lk_q, lk_r, lk_g, mu, nu, iters: int, chunk: int, tol,
                   log_floor, backend: str = "torch",
                   cost_dtype: str = "f32"):
    """Log-domain Dykstra projection onto the low-rank coupling polytope

        {Q 1_r = μ} ∩ {R 1_r = ν} ∩ {g ≥ floor}          (block 1)
        ∩ {Qᵀ 1_M = g} ∩ {Rᵀ 1_N = g}                     (block 2)

    (Scetbon–Cuturi 2021 LR-Sinkhorn, Algorithm 2, in log space).  The
    iterate is held as duals: log Q = lk_q ⊕ f1 ⊕ g1, log R = lk_r ⊕ f2 ⊕ g2,
    log g = h; the g-floor and block 2's coupled pieces carry Dykstra
    corrections, and block 2's joint projection is the geometric mean of
    its three pieces.  Zero-mass atoms stay exactly 0 throughout.

    Runs on `_chunked_loop`: ``tol=0`` performs exactly ``iters`` sweeps;
    ``tol>0`` stops each lane at the first post-chunk check whose summed
    L1 row-marginal gap (Q vs μ plus R vs ν) is ≤ its tol.  Takes one
    problem (lk_q (M, r)) or B lanes (lk_q (B, M, r)).  Returns
    (q, r, g, err, iters_used).
    """
    solo = lk_q.dim() == 2
    lk_q, lk_r, lk_g, mu, nu = _lift(solo, lk_q, lk_r, lk_g, mu, nu)
    state0, sweep, residual = _lr_dykstra_pieces(lk_q, lk_r, lk_g, mu, nu,
                                                 log_floor, backend,
                                                 cost_dtype)
    s, used = _chunked_loop(state0, sweep, residual, iters, chunk,
                            _as_tol(tol, mu))
    f1, f2, g1, g2, h = s[0], s[1], s[2], s[3], s[4]
    q = torch.exp(lk_q + f1[:, :, None] + g1[:, None, :])
    r = torch.exp(lk_r + f2[:, :, None] + g2[:, None, :])
    return _drop(solo, q, r, torch.exp(h), residual(s, None)) + \
        (used[0] if solo else used,)


def _lr_prox_kernels(q, r, g, grad_q, grad_r, grad_g, mu, nu, eps, gamma):
    """The KL-prox kernels of one factored mirror step, over lanes (factors
    (B, N, r), ε and γ (B,)):

        log K = (1 − γ'ε)·log X − γ'·∇_X F,    γ' = γ / ‖∇F‖∞,

    with each lane's ∞-norm over its mass-carrying rows only and zero-mass
    rows pinned to −inf.  ε and γ enter here, folded into the kernels the
    Dykstra sweep reads."""
    ft = mu.dtype
    eps = _as_eps(eps, mu)
    gamma = _as_eps(gamma, mu)
    zero = torch.zeros((), dtype=ft, device=mu.device)
    gq_m = torch.where((mu > 0)[:, :, None], grad_q, zero)
    gr_m = torch.where((nu > 0)[:, :, None], grad_r, zero)
    norm = torch.maximum(gq_m.abs().amax(dim=(1, 2)),
                         torch.maximum(gr_m.abs().amax(dim=(1, 2)),
                                       grad_g.abs().amax(dim=1)))
    gamma_eff = gamma / torch.clamp_min(norm, torch.finfo(ft).tiny)
    # 1 − γ'ε < 0 would flip the prox into ascent on the entropy term;
    # clamping to [0, 1] degrades gracefully to the pure-gradient kernel
    coef = torch.clamp(1.0 - gamma_eff * eps, 0.0, 1.0)
    neg_inf = torch.full((), -torch.inf, dtype=ft, device=mu.device)
    one = torch.ones((), dtype=ft, device=mu.device)
    c3, ge3 = coef[:, None, None], gamma_eff[:, None, None]
    lk_q = torch.where(q > 0, c3 * torch.log(torch.where(q > 0, q, one))
                       - ge3 * gq_m, neg_inf)
    lk_r = torch.where(r > 0, c3 * torch.log(torch.where(r > 0, r, one))
                       - ge3 * gr_m, neg_inf)
    lk_g = coef[:, None] * _safe_log(g) - gamma_eff[:, None] * grad_g
    return lk_q, lk_r, lk_g


def lr_mirror_step(q, r, g, grad_q, grad_r, grad_g, mu, nu, eps, gamma,
                   iters: int, chunk: int, tol, g_floor: float,
                   backend: str = "torch", cost_dtype: str = "f32"):
    """One mirror-descent step on the factored plan (Q, R, g): the KL-prox
    kernels of `_lr_prox_kernels` projected back onto the coupling polytope
    by `lr_dykstra_log`.  Takes one problem or B lanes (factors (B, N, r),
    ε, γ and tol scalars or (B,)).  Returns (q, r, g, err, iters_used) with
    err the post-projection L1 row-marginal gap."""
    solo = q.dim() == 2
    q, r, g, grad_q, grad_r, grad_g, mu, nu = _lift(
        solo, q, r, g, grad_q, grad_r, grad_g, mu, nu)
    lk_q, lk_r, lk_g = _lr_prox_kernels(q, r, g, grad_q, grad_r, grad_g,
                                        mu, nu, eps, gamma)
    log_floor = torch.log(torch.tensor(g_floor, dtype=mu.dtype,
                                       device=mu.device))
    out = lr_dykstra_log(lk_q, lk_r, lk_g, mu, nu, iters, chunk, tol,
                         log_floor, backend, cost_dtype)
    return _drop(solo, *out[:4]) + (out[4][0] if solo else out[4],)


def lr_mirror_step_diff(q, r, g, grad_q, grad_r, grad_g, mu, nu, eps, gamma,
                        sweeps: int, g_floor: float):
    """One DIFFERENTIABLE factored mirror step over lanes: the prox kernels
    of `lr_mirror_step` projected by a fixed number of plain Dykstra
    ``sweeps`` from zero duals, every logsumexp the zero-mass-safe one.

    The factored plan's T̃ for the implicit surface: not idempotent at the
    solution (Dykstra re-walks its corrections from scratch), but its fixed
    points are the solver's, which is all the implicit function theorem
    needs.  Everything is (N, r)-sized.  Returns (q, r, g)."""
    lk_q, lk_r, lk_g = _lr_prox_kernels(q, r, g, grad_q, grad_r, grad_g,
                                        mu, nu, eps, gamma)
    log_floor = torch.log(torch.tensor(g_floor, dtype=mu.dtype,
                                       device=mu.device))
    s, sweep, _ = _lr_dykstra_pieces(lk_q, lk_r, lk_g, mu, nu, log_floor,
                                     "torch", lse=safe_logsumexp)
    for _ in range(sweeps):
        s = sweep(s)
    f1, f2, g1, g2, h = s[0], s[1], s[2], s[3], s[4]
    return (torch.exp(lk_q + f1[:, :, None] + g1[:, None, :]),
            torch.exp(lk_r + f2[:, :, None] + g2[:, None, :]), torch.exp(h))


def sinkhorn_step_diff(cost, mu, nu, eps, f, g, pairs: int = 1):
    """``pairs`` DIFFERENTIABLE log-domain dual-update pairs over lanes
    (cost (B, M, N), ε (B,)), warm-started at (f, g): the full plan's T̃
    for the implicit surface.  At converged potentials one pair is
    (approximately) idempotent.  Zero-mass atoms pin to −inf with
    exact-zero gradients.  Returns (f, g)."""
    e2 = _as_eps(eps, mu)[:, None]
    e3 = e2[:, :, None]
    log_mu, log_nu = _safe_log(mu), _safe_log(nu)
    zero_mu, zero_nu = mu <= 0, nu <= 0
    neg_inf = torch.full((), -torch.inf, dtype=mu.dtype, device=mu.device)
    for _ in range(pairs):
        gm = torch.where(zero_nu, neg_inf, g)
        f = torch.where(zero_mu, neg_inf, e2 * (log_mu - safe_logsumexp(
            (gm[:, None, :] - cost) / e3, dim=2)))
        g = torch.where(zero_nu, neg_inf, e2 * (log_nu - safe_logsumexp(
            (f[:, :, None] - cost) / e3, dim=1)))
    return f, g
