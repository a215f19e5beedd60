"""Balanced Sinkhorn solvers for the entropic-OT subproblem of each
mirror-descent step.

Reference: ``repro/core/sinkhorn.py`` (balanced log and kernel modes; the
unbalanced, low-rank and differentiable one-step maps belong to later
slices).

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

from repro_torch.kernels import ops as kops
from repro_torch.kernels import sinkhorn_step


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
