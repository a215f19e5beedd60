"""Entropic Gromov-Wasserstein on uniform grids, written plainly.

Paper (arXiv:2404.08970) §2.1: mirror descent on the GW energy
E(Γ) = Σ (d^X_ij − d^Y_pq)² Γ_ip Γ_jq with the entropic step τ = ε, each
step an entropic OT problem with the cost

    C = ∇E(Γ) = C1 − 4·D_X Γ D_Y,   C1 = 2((D_X∘D_X)μ 1ᵀ + 1((D_Y∘D_Y)ν)ᵀ),

solved by Sinkhorn from the previous step's potentials.  Here every
distance matrix is dense and D_X Γ D_Y is two dense matrix products taken
in blocks of rows: none of the fast gradient (§3), no kernel, no batching.

The schedule is the one the solved problems state, step by step:

* the plan starts at μνᵀ, the potentials at 0;
* outer step t runs at ε_t = max(ε, ε_init·decay^s), s the step's stage;
  its Sinkhorn stops after a chunk of ``chunk`` iterations (at most
  ``iters`` in all) once the L1 gap of the plan's row sums to μ is at or
  under tol·(1 + loosen·(ε_t/ε − 1));
* with tol > 0, the solve stops after a step at the target ε whose plan
  moved by at most tol in L1 and whose gap is at most tol; a step still
  annealing whose gap exceeds its tolerance holds its stage (at most
  outer/2 holds in all);
* log mode: f = ε(log μ − LSE_p((g_p − C_ip)/ε)), then g likewise over i,
  and Γ = exp((f ⊕ g − C)/ε);
* kernel mode: K = exp(−(C − r − c)/ε) with r the row minima of C and c
  the column minima of C − r, scalings a from the potentials shifted by
  their maximum, a ← μ / K(ν / Kᵀa), Γ = a K b with b = ν / Kᵀa, and the
  potentials ε·log a, ε·log b;
* the value is Σ_i (Γ1)_i (D_X∘D_X μ)_i + Σ_p (Γᵀ1)_p (D_Y∘D_Y ν)_p
  − 2⟨Γ, D_X Γ D_Y⟩.

``precision`` sets the arithmetic: "float64" (the reference), "float32",
"tf32" (float32 with TF32 matrix products) or "bfloat16".  Only the
lower-precision control runs the last three.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "tf32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class Problem:
    """One GW problem between two uniform grids: ``kind`` "Grid1D" (n
    points) or "Grid2D" (n×n points, row-major), spacing h = 1/(n−1),
    metric |·|^k (Manhattan on 2-D grids), measures ``mu`` and ``nu``."""

    kind_x: str
    n_x: int
    kind_y: str
    n_y: int
    k: int
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Settings:
    eps: float
    outer_iters: int
    sinkhorn_iters: int
    mode: str = "log"
    tol: float = 0.0
    eps_init: float | None = None
    anneal_decay: float = 0.5
    chunk: int = 25
    inner_loosen: float = 1.0


@dataclasses.dataclass
class Solution:
    plan: torch.Tensor
    value: float
    outer_iters: int
    inner_iters: int


def distance(kind: str, n: int, k: int, power: int, dtype, device):
    """The dense matrix of d^(k·power) on a grid with spacing 1/(n−1)."""
    h = 1.0 / (n - 1)
    p = k * power
    idx = torch.arange(n, dtype=torch.float64, device=device)
    d1 = (idx[:, None] - idx[None, :]).abs()
    if kind == "Grid1D":
        d = d1
    elif kind == "Grid2D":
        d = (d1[:, None, :, None] + d1[None, :, None, :]).reshape(n * n,
                                                                 n * n)
    else:
        raise ValueError(f"unknown grid kind {kind!r}")
    return ((h ** p) * d ** p).to(dtype)


def product(dx, gamma, dy, block: int = 2048):
    """D_X Γ D_Y by dense products, ``block`` rows at a time."""
    out = torch.empty_like(gamma)
    for r in range(0, gamma.shape[0], block):
        out[r:r + block] = (dx[r:r + block] @ gamma) @ dy
    return out


def _log_sinkhorn(cost, log_mu, log_nu, eps, f, g):
    neg = -cost / eps

    def step(fg):
        _, gg = fg
        fn = eps * (log_mu - torch.logsumexp(neg + gg[None, :] / eps, dim=1))
        gn = eps * (log_nu - torch.logsumexp(neg + fn[:, None] / eps, dim=0))
        return fn, gn

    def plan_of(fg):
        fn, gn = fg
        return torch.exp(neg + (fn[:, None] + gn[None, :]) / eps)

    return (f, g), step, plan_of, lambda fg: fg


def _kernel_sinkhorn(cost, mu, nu, eps, f):
    r = cost.amin(dim=1, keepdim=True)
    c = (cost - r).amin(dim=0, keepdim=True)
    kmat = torch.exp(-(cost - r - c) / eps)
    finite = torch.isfinite(f)
    shift = f[finite].max() if bool(finite.any()) else f.new_zeros(())
    a0 = torch.exp((f - shift) / eps)

    def col(a):
        return nu / (kmat.T @ a)

    def step(a):
        return mu / (kmat @ col(a))

    def plan_of(a):
        return a[:, None] * kmat * col(a)[None, :]

    def potentials(a):
        return eps * torch.log(a), eps * torch.log(col(a))

    return a0, step, plan_of, potentials


def sinkhorn(cost, mu, nu, eps, iters, chunk, tol, f, g, mode):
    """Chunked Sinkhorn from the potentials (f, g): returns the plan, the
    new potentials, the L1 row-sum gap and the iterations run."""
    log_mu, log_nu = torch.log(mu), torch.log(nu)
    if mode == "log":
        carry, step, plan_of, pots = _log_sinkhorn(cost, log_mu, log_nu,
                                                   eps, f, g)
    elif mode == "kernel":
        carry, step, plan_of, pots = _kernel_sinkhorn(cost, mu, nu, eps, f)
    else:
        raise ValueError(f"unknown Sinkhorn mode {mode!r}")
    done = 0
    while done < iters:
        for _ in range(min(chunk, iters - done)):
            carry = step(carry)
        done = min(done + chunk, iters)
        gap = float((plan_of(carry).sum(dim=1) - mu).abs().sum())
        if not gap > tol:
            break
    plan = plan_of(carry)
    f, g = pots(carry)
    return plan, f, g, float((plan.sum(dim=1) - mu).abs().sum()), done


@contextlib.contextmanager
def _matmul_precision(precision: str):
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def solve(problem: Problem, s: Settings, precision: str = "float64",
          device=None) -> Solution:
    """The solve of ``problem`` under the schedule ``s`` (module
    docstring)."""
    dt = DTYPES[precision]
    dev = problem.mu.device if device is None else torch.device(device)
    with _matmul_precision(precision):
        mu = problem.mu.to(dev, dt)
        nu = problem.nu.to(dev, dt)
        dx = distance(problem.kind_x, problem.n_x, problem.k, 1, dt, dev)
        same = (problem.kind_x, problem.n_x) == (problem.kind_y,
                                                problem.n_y)
        dy = dx if same else distance(problem.kind_y, problem.n_y,
                                      problem.k, 1, dt, dev)
        dx2 = product_sq(problem.kind_x, problem.n_x, problem.k, mu)
        dy2 = product_sq(problem.kind_y, problem.n_y, problem.k, nu)
        c1 = 2.0 * (dx2[:, None] + dy2[None, :])
        plan = mu[:, None] * nu[None, :]
        f = torch.zeros_like(mu)
        g = torch.zeros_like(nu)
        eps_init = s.eps if s.eps_init is None else max(s.eps_init, s.eps)
        dwell_cap = max(s.outer_iters // 2, 1)
        t = stage = inner = 0
        while t < s.outer_iters:
            ramp = eps_init * s.anneal_decay ** stage
            eps_t = max(s.eps, ramp)
            itol = s.tol * (1.0 + s.inner_loosen * (eps_t / s.eps - 1.0))
            cost = c1 - 4.0 * product(dx, plan, dy)
            new, f, g, gap, used = sinkhorn(cost, mu, nu, eps_t,
                                            s.sinkhorn_iters, s.chunk, itol,
                                            f, g, s.mode)
            del cost
            conv = hold = False
            if s.tol > 0.0:
                moved = float((new - plan).abs().sum())
                annealed = ramp <= s.eps
                conv = annealed and moved <= s.tol and gap <= s.tol
                hold = (not annealed and gap > itol
                        and (t - stage) < dwell_cap)
            plan = new
            stage += 0 if hold else 1
            t += 1
            inner += used
            if conv:
                break
        return Solution(plan, _energy(plan, dx, dy, dx2, dy2), t, inner)


def _energy(plan, dx, dy, dx2, dy2) -> float:
    cross = (plan * product(dx, plan, dy)).sum()
    return float((plan.sum(dim=1) * dx2).sum() + (plan.sum(dim=0) * dy2).sum()
                 - 2.0 * cross)


def energy(problem: Problem, plan) -> float:
    """The value of a given plan, in float64: Σ_i (Γ1)_i (D_X∘D_X μ)_i +
    Σ_p (Γᵀ1)_p (D_Y∘D_Y ν)_p − 2⟨Γ, D_X Γ D_Y⟩, the expression `solve`
    returns for its own plan."""
    dt, dev = torch.float64, problem.mu.device
    mu, nu = problem.mu.to(dev, dt), problem.nu.to(dev, dt)
    dx = distance(problem.kind_x, problem.n_x, problem.k, 1, dt, dev)
    dy = distance(problem.kind_y, problem.n_y, problem.k, 1, dt, dev)
    return _energy(plan.to(dev, dt), dx, dy,
                   product_sq(problem.kind_x, problem.n_x, problem.k, mu),
                   product_sq(problem.kind_y, problem.n_y, problem.k, nu))


def product_sq(kind: str, n: int, k: int, w, block: int = 2048):
    """(D∘D) w with the dense squared-distance matrix, ``block`` rows at a
    time."""
    out = torch.empty_like(w)
    size = w.shape[0]
    full = distance(kind, n, k, 2, w.dtype, w.device)
    for r in range(0, size, block):
        out[r:r + block] = full[r:r + block] @ w
    return out
