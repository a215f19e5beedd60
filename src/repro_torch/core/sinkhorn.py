"""Balanced Sinkhorn solvers for the entropic-OT subproblem of each
mirror-descent step.

Reference: ``repro/core/sinkhorn.py`` (balanced log and kernel modes, and
the factored plan's log-domain Dykstra projection and mirror step; the
unbalanced and differentiable one-step maps belong to later slices).

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
"""
from __future__ import annotations

import dataclasses

import torch

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
    """log with −inf at zero mass."""
    return torch.where(w > 0, torch.log(torch.where(w > 0, w,
                                                    torch.ones_like(w))),
                       torch.full_like(w, -torch.inf))


def safe_logsumexp(z, dim=-1):
    """logsumexp that masks dead (−inf) entries before exponentiating;
    values match the standard implementation, −inf on all −inf slices."""
    m = torch.amax(z, dim=dim, keepdim=True)
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
    return torch.as_tensor(eps, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# per-mode pieces: ONE home for each dual update + plan assembly, used by
# both the fixed loops and the chunked early-stopping loops
# ---------------------------------------------------------------------------

def _log_pieces(cost, mu, nu, eps, backend: str = "torch",
                cost_dtype: str = "f32"):
    """step((f,g))->(f,g) and plan_err((f,g))->(plan, L1 row-marginal gap).

    ``backend`` selects the dual update: the plain expressions below, or the
    CUDA half-step kernels.  ``cost_dtype="bf16"`` makes the kernels read C
    as bfloat16 (cast once per solve; the plain expressions, the plan and
    the residual ignore it).
    """
    # one ε dtype for every entry point (the reference's rule): the fixed
    # and the chunked loops must feed the update the same ε, or tol=0
    # "chunked == fixed" stops being bit-identical
    eps = _as_eps(eps, mu)
    log_mu = torch.log(mu)
    log_nu = torch.log(nu)

    if kops.resolve_sinkhorn_backend(backend, mu.device) == "kernel":
        cost_k = kops.cast_cost(cost.contiguous(), cost_dtype)
        eps_k = eps.reshape(1)

        def step(carry):
            _f, g = carry
            fn = kops.sinkhorn_row_update(cost_k, g, log_mu, eps_k)
            gn = kops.sinkhorn_col_update(cost_k, fn, log_nu, eps_k)
            return fn, gn
    else:
        # the kernels' plain versions, on one lane
        c1, e1 = cost[None], eps.reshape(1)

        def step(carry):
            _f, g = carry
            fn = sinkhorn_step.row_update_plain(c1, g[None], log_mu[None],
                                                e1)[0]
            gn = sinkhorn_step.col_update_plain(c1, fn[None], log_nu[None],
                                                e1)[0]
            return fn, gn

    def plan_err(carry):
        f, g = carry
        plan = torch.exp((f[:, None] + g[None, :] - cost) / eps)
        return plan, (plan.sum(dim=1) - mu).abs().sum()

    return step, plan_err


def _kernel_pieces(cost, mu, nu, eps):
    """Kernel-domain pieces, stabilized by a dual shift: subtracting row/col
    minima from C changes the scalings a, b but not the plan."""
    rmin = cost.amin(dim=1, keepdim=True)
    cmin = (cost - rmin).amin(dim=0, keepdim=True)
    K = torch.exp(-(cost - rmin - cmin) / eps)

    def step(a):
        return mu / (K @ (nu / (K.T @ a)))

    def plan_err(a):
        b = nu / (K.T @ a)
        plan = a[:, None] * K * b[None, :]
        return plan, b, (plan.sum(dim=1) - mu).abs().sum()

    return step, plan_err


def _chunked_loop(carry0, step_fn, residual_fn, iters: int, chunk: int, tol):
    """The chunked early-stopping scaffold: sweeps of ``chunk`` updates
    (the last one cut at the global ``iters`` cap), each followed by
    ``residual_fn(new_carry, old_carry)`` and one host sync on
    ``residual > tol``.  ``tol=0`` performs exactly ``iters`` updates.
    Returns (carry, iters_used, last_residual)."""
    carry, it, err = carry0, 0, None
    while it < iters and (err is None or bool(err > tol)):
        old = carry
        for _ in range(min(chunk, iters - it)):
            carry = step_fn(carry)
        it += min(chunk, iters - it)
        err = residual_fn(carry, old)
    return carry, it, err


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def sinkhorn_log(cost, mu, nu, eps, iters: int, f0=None, g0=None,
                 backend: str = "torch"):
    """Log-domain Sinkhorn.  Returns (plan, f, g, err) — err = L1 row-marginal
    gap."""
    step, plan_err = _log_pieces(cost, mu, nu, eps, backend)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    for _ in range(iters):
        carry = step(carry)
    plan, err = plan_err(carry)
    return plan, carry[0], carry[1], err


def sinkhorn_log_chunked(cost, mu, nu, eps, iters: int, chunk: int, tol,
                         f0=None, g0=None, backend: str = "torch",
                         cost_dtype: str = "f32"):
    """Log-domain Sinkhorn with chunked early stopping.

    Returns (plan, f, g, err, iters_used).  ``tol=0`` runs exactly ``iters``
    updates, so it reproduces :func:`sinkhorn_log` bit-for-bit; ``tol>0``
    stops at the first chunk whose L1 row-marginal gap is ≤ tol.
    """
    eps = _as_eps(eps, mu)
    step, plan_err = _log_pieces(cost, mu, nu, eps, backend, cost_dtype)
    carry = (torch.zeros_like(mu) if f0 is None else f0,
             torch.zeros_like(nu) if g0 is None else g0)
    carry, it, _ = _chunked_loop(carry, step,
                                 lambda new, _old: plan_err(new)[1],
                                 iters, chunk, tol)
    plan, err = plan_err(carry)
    return plan, carry[0], carry[1], err, it


def sinkhorn_kernel(cost, mu, nu, eps, iters: int, a0=None):
    """Kernel-domain Sinkhorn (paper-literal matvec iteration)."""
    step, plan_err = _kernel_pieces(cost, mu, nu, eps)
    a = torch.ones_like(mu) if a0 is None else a0
    for _ in range(iters):
        a = step(a)
    plan, b, err = plan_err(a)
    return plan, a, b, err


def sinkhorn_kernel_chunked(cost, mu, nu, eps, iters: int, chunk: int, tol,
                            a0=None):
    """Kernel-domain counterpart of :func:`sinkhorn_log_chunked`.
    Returns (plan, a, b, err, iters_used)."""
    eps = _as_eps(eps, mu)
    step, plan_err = _kernel_pieces(cost, mu, nu, eps)
    a = torch.ones_like(mu) if a0 is None else a0
    a, it, _ = _chunked_loop(a, step, lambda new, _old: plan_err(new)[2],
                             iters, chunk, tol)
    plan, b, err = plan_err(a)
    return plan, a, b, err, it


def _warm_scalings(f0, eps):
    """Potentials → kernel scalings a0 = exp((f0 − shift)/ε), shifted by the
    largest finite potential (scalings are defined up to a scalar); −inf
    (zero-mass) entries map to 0."""
    if f0 is None:
        return None
    shift = torch.amax(torch.where(torch.isfinite(f0), f0,
                                   torch.full_like(f0, -torch.inf)))
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    return torch.exp((f0 - shift) / eps)


def solve(cost, mu, nu, cfg: SinkhornConfig, f0=None, g0=None):
    if cfg.mode == "log":
        return sinkhorn_log(cost, mu, nu, cfg.eps, cfg.iters, f0, g0,
                            cfg.backend)
    plan, a, b, err = sinkhorn_kernel(cost, mu, nu, cfg.eps, cfg.iters,
                                      _warm_scalings(f0, cfg.eps))
    # scalings → potentials, so a warm start is mode-agnostic
    return plan, cfg.eps * torch.log(a), cfg.eps * torch.log(b), err


def solve_adaptive(cost, mu, nu, eps, iters: int, chunk: int, tol,
                   mode: str = "log", f0=None, g0=None,
                   backend: str = "torch", cost_dtype: str = "f32"):
    """Mode dispatch for the convergence-controlled outer loop.  Returns
    (plan, f, g, err, iters_used) with warm-startable potentials in either
    mode; ``backend`` applies to log mode (kernel mode is plain PyTorch)."""
    eps = _as_eps(eps, mu)
    if mode == "log":
        return sinkhorn_log_chunked(cost, mu, nu, eps, iters, chunk, tol,
                                    f0, g0, backend, cost_dtype)
    a0 = _warm_scalings(f0, eps)
    plan, a, b, err, used = sinkhorn_kernel_chunked(
        cost, mu, nu, eps, iters, chunk, tol, a0)
    return plan, eps * torch.log(a), eps * torch.log(b), err, used


# ---------------------------------------------------------------------------
# low-rank coupling subproblem (Scetbon et al. 2021): one mirror step on the
# (Q, R, g) factors, solved by log-domain Dykstra iterations
# ---------------------------------------------------------------------------

def _lr_dykstra_pieces(lk_q, lk_r, lk_g, mu, nu, log_floor,
                       backend: str = "torch", cost_dtype: str = "f32"):
    """state0, sweep, residual for the log-domain Dykstra projection.

    ``backend`` (resolved by `repro_torch.kernels.ops.
    resolve_lowrank_backend`) selects block 1 of the sweep: ``"kernel"``
    runs each factor side as ONE call of the B5 kernel (the row duals and
    the column LSE at those duals in one pass over the (N, r) log-kernel,
    read as bfloat16 under ``cost_dtype="bf16"``); ``"torch"`` runs the same
    function as the kernel's plain version, the reference's XLA
    expressions.  The (r,)-sized dual algebra and the residual are plain
    PyTorch under either backend.
    """
    ft = mu.dtype
    log_mu = _safe_log(mu)
    log_nu = _safe_log(nu)
    rank = lk_g.shape[-1]
    zr = torch.zeros((rank,), dtype=ft, device=mu.device)
    state0 = (torch.zeros_like(mu), torch.zeros_like(nu), zr, zr,
              lk_g.to(ft), zr, zr, zr, zr)

    if kops.resolve_lowrank_backend(backend, mu.device) == "kernel":
        # cast once per projection, not once per sweep
        lkq_k = kops.cast_cost(lk_q.contiguous(), cost_dtype)
        lkr_k = kops.cast_cost(lk_r.contiguous(), cost_dtype)

        def block1(g1, g2):
            f1, cq = kops.lr_dykstra_half(lkq_k, g1, log_mu, cost_dtype)
            f2, cr = kops.lr_dykstra_half(lkr_k, g2, log_nu, cost_dtype)
            return f1, f2, cq, cr
    else:
        def block1(g1, g2):
            f1, cq = lr_step.dykstra_half_plain(lk_q[None], g1[None],
                                                log_mu[None])
            f2, cr = lr_step.dykstra_half_plain(lk_r[None], g2[None],
                                                log_nu[None])
            return f1[0], f2[0], cq[0], cr[0]

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
        row_q = torch.exp(f1 + sinkhorn_step._lse(g1[None, :] + lk_q, 1))
        row_r = torch.exp(f2 + sinkhorn_step._lse(g2[None, :] + lk_r, 1))
        return (row_q - mu).abs().sum() + (row_r - nu).abs().sum()

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
    ``tol>0`` stops at the first post-chunk check whose summed L1
    row-marginal gap (Q vs μ plus R vs ν) is ≤ tol.  Returns
    (q, r, g, err, iters_used).
    """
    state0, sweep, residual = _lr_dykstra_pieces(lk_q, lk_r, lk_g, mu, nu,
                                                 log_floor, backend,
                                                 cost_dtype)
    s, it, _ = _chunked_loop(state0, sweep, residual, iters, chunk, tol)
    f1, f2, g1, g2, h = s[0], s[1], s[2], s[3], s[4]
    q = torch.exp(lk_q + f1[:, None] + g1[None, :])
    r = torch.exp(lk_r + f2[:, None] + g2[None, :])
    return q, r, torch.exp(h), residual(s, None), it


def _lr_prox_kernels(q, r, g, grad_q, grad_r, grad_g, mu, nu, eps, gamma):
    """The KL-prox kernels of one factored mirror step:

        log K = (1 − γ'ε)·log X − γ'·∇_X F,    γ' = γ / ‖∇F‖∞,

    with the ∞-norm over mass-carrying rows only and zero-mass rows pinned
    to −inf.  ε and γ enter here, folded into the kernels the Dykstra sweep
    reads."""
    ft = mu.dtype
    eps = torch.as_tensor(eps, dtype=ft, device=mu.device)
    gamma = torch.as_tensor(gamma, dtype=ft, device=mu.device)
    zero = torch.zeros((), dtype=ft, device=mu.device)
    gq_m = torch.where((mu > 0)[:, None], grad_q, zero)
    gr_m = torch.where((nu > 0)[:, None], grad_r, zero)
    norm = torch.maximum(gq_m.abs().max(),
                         torch.maximum(gr_m.abs().max(), grad_g.abs().max()))
    gamma_eff = gamma / torch.clamp_min(norm, torch.finfo(ft).tiny)
    # 1 − γ'ε < 0 would flip the prox into ascent on the entropy term;
    # clamping to [0, 1] degrades gracefully to the pure-gradient kernel
    coef = torch.clamp(1.0 - gamma_eff * eps, 0.0, 1.0)
    neg_inf = torch.full((), -torch.inf, dtype=ft, device=mu.device)
    one = torch.ones((), dtype=ft, device=mu.device)
    lk_q = torch.where(q > 0, coef * torch.log(torch.where(q > 0, q, one))
                       - gamma_eff * gq_m, neg_inf)
    lk_r = torch.where(r > 0, coef * torch.log(torch.where(r > 0, r, one))
                       - gamma_eff * gr_m, neg_inf)
    lk_g = coef * _safe_log(g) - gamma_eff * grad_g
    return lk_q, lk_r, lk_g


def lr_mirror_step(q, r, g, grad_q, grad_r, grad_g, mu, nu, eps, gamma,
                   iters: int, chunk: int, tol, g_floor: float,
                   backend: str = "torch", cost_dtype: str = "f32"):
    """One mirror-descent step on the factored plan (Q, R, g): the KL-prox
    kernels of `_lr_prox_kernels` projected back onto the coupling polytope
    by `lr_dykstra_log`.  Returns (q, r, g, err, iters_used) with err the
    post-projection L1 row-marginal gap."""
    lk_q, lk_r, lk_g = _lr_prox_kernels(q, r, g, grad_q, grad_r, grad_g,
                                        mu, nu, eps, gamma)
    log_floor = torch.log(torch.tensor(g_floor, dtype=mu.dtype,
                                       device=mu.device))
    return lr_dykstra_log(lk_q, lk_r, lk_g, mu, nu, iters, chunk, tol,
                          log_floor, backend, cost_dtype)
