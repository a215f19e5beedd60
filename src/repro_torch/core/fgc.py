"""Fast Gradient Computation (FGC) primitives — the paper's §3.

Reference: ``repro/core/fgc.py``.  Everything reduces to applying, along one
tensor axis of length N,

    (L x)_i  = Σ_{j<i} (i-j)^p x_j          L strictly-lower Toeplitz
    (Lᵀ x)_i = Σ_{j>i} (j-i)^p x_j          = flip(L(flip(x)))
    (D̃ x)   = L x + Lᵀ x                    D̃[i,j] = |i-j|^p (0 diag, p≥1)

in O(p²·N) element-wise work instead of the dense O(N²) matvec.

Backends
--------
``scan``     the paper's (p+1)-moment recursion (eq. 3.9), a Python loop over
             the grid axis: the plain versions of the FGC kernels.
``cumsum``   binomial expansion (i-j)^p = Σ_s C(p,s) i^{p-s} (-j)^s: p+1
             exclusive cumulative sums, with centred indices t = i − N/2
             (f32 accuracy depends on it).  The fused D̃ reuses each moment
             cumsum for both triangles.  The default.
``blocked``  blocked recursion: three batched matmuls and a scan over blocks.
``dense``    explicit Toeplitz matmul (oracle).
``kernel``   the hand-written CUDA kernels (`repro_torch.kernels.ops`); on a
             CPU tensor the same wrappers compute their plain versions.  The
             reference calls this backend ``"pallas"``.

Every backend works on the target axis moved to the front and the rest
flattened (`_to_front`); an apply along axis 1 therefore runs on a
transposed contiguous copy under ``kernel``.  ``apply_LT`` is the
reference's flip expression flip(L(flip x)) on every backend but
``kernel``, where the L kernel runs its scan over the rows bottom up
(``reverse=True``): no flipped copy, and on a CPU tensor the plain
version of that same identity.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.kernels import fgc_scan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fgc_scan import pascal_matrix

BACKENDS = ("scan", "cumsum", "blocked", "dense", "kernel")

__all__ = ["BACKENDS", "pascal_matrix", "lower_toeplitz", "apply_L",
           "apply_LT", "apply_abs_power", "flops_estimate"]


def lower_toeplitz(n: int, p: int, dtype=torch.float64, device=None):
    """Dense L with L[i,j] = (i-j)^p for i>j, else 0."""
    idx = torch.arange(n, dtype=dtype, device=device)
    diff = idx[:, None] - idx[None, :]
    return torch.where(diff > 0, diff ** p, torch.zeros((), dtype=dtype,
                                                        device=device))


def _to_front(x, axis):
    axis = axis % x.dim()
    x2 = torch.movedim(x, axis, 0)
    shape = x2.shape
    return x2.reshape(shape[0], -1), shape, axis


def _from_front(y, shape, axis):
    return torch.movedim(y.reshape(shape), 0, axis)


def _centred_index(x2):
    n = x2.shape[0]
    return (torch.arange(n, dtype=x2.dtype, device=x2.device)
            - torch.tensor(n // 2, dtype=x2.dtype, device=x2.device))


def _exclusive(cs):
    return torch.cat([torch.zeros_like(cs[:1]), cs[:-1]], dim=0)


# ---------------------------------------------------------------------------
# L-apply backends (operate on (N, B) arrays along axis 0)
# ---------------------------------------------------------------------------

def _apply_L_cumsum(x2, p: int):
    """Binomial-expanded closed form via p+1 exclusive cumsums."""
    t = _centred_index(x2)
    y = torch.zeros_like(x2)
    for s in range(p + 1):
        c = math.comb(p, s) * ((-1.0) ** s)
        ms = (t ** s)[:, None] * x2                       # t_j^s x_j
        excl = _exclusive(torch.cumsum(ms, dim=0))
        y = y + c * (t ** (p - s))[:, None] * excl
    return y


def _apply_L_dense(x2, p: int):
    return lower_toeplitz(x2.shape[0], p, x2.dtype, x2.device) @ x2


def _apply_L_blocked(x2, p: int, block: int = 16):
    """Blocked recursion: intra-block Toeplitz matmuls, block moments, a
    scan of N/R steps over the (p+1)-moment state, and its extrapolation."""
    n, b = x2.shape
    r = min(block, n)
    pad = -n % r
    xp = torch.nn.functional.pad(x2, (0, 0, 0, pad))
    nb = xp.shape[0] // r
    dt, dev = x2.dtype, x2.device
    i = torch.arange(r, dtype=dt, device=dev)
    diff = i[:, None] - i[None, :]
    l_r = torch.where(diff > 0, diff ** p, torch.zeros((), dtype=dt,
                                                       device=dev))
    v = torch.stack([math.comb(p, s) * i ** (p - s) for s in range(p + 1)],
                    1)
    p_r = torch.tensor([[math.comb(rr, s) * float(r) ** (rr - s) if s <= rr
                         else 0.0 for s in range(p + 1)]
                        for rr in range(p + 1)], dtype=dt, device=dev)
    t = torch.stack([(r - i) ** rr for rr in range(p + 1)], 0)
    xb = xp.reshape(nb, r, b)
    intra = torch.einsum("rs,nsb->nrb", l_r, xb)
    moments = torch.einsum("ps,nsb->npb", t, xb)
    a = torch.zeros((p + 1, b), dtype=dt, device=dev)
    starts = []
    for blk in range(nb):
        starts.append(a)                  # the state at the block's start
        a = p_r @ a + moments[blk]
    y = intra + torch.einsum("rp,npb->nrb", v, torch.stack(starts))
    return y.reshape(nb * r, b)[:n]


def _apply_L_kernel(x2, p: int, reverse: bool = False):
    return kops.fgc_apply_l(x2.contiguous(), p, reverse)


_L_BACKENDS = {
    "scan": fgc_scan.apply_l_plain,
    "cumsum": _apply_L_cumsum,
    "blocked": _apply_L_blocked,
    "dense": _apply_L_dense,
    "kernel": _apply_L_kernel,
}


# ---------------------------------------------------------------------------
# fused D̃-apply backends: y = (L + Lᵀ) x in one sweep
# ---------------------------------------------------------------------------

def _apply_D_cumsum(x2, p: int):
    """Shared-moment closed form: each cumsum Σ_j t_j^s x_j serves both
    triangles — prefix (exclusive) for L, suffix = total − inclusive for
    Lᵀ.

    L term s:  C(p,s)·(−1)^s     · t^{p−s} · Σ_{j<i} t_j^s x_j
    Lᵀ term s: C(p,s)·(−1)^{p−s} · t^{p−s} · Σ_{j>i} t_j^s x_j
    """
    t = _centred_index(x2)
    y = torch.zeros_like(x2)
    for s in range(p + 1):
        ms = (t ** s)[:, None] * x2
        cs = torch.cumsum(ms, dim=0)
        excl_lo = _exclusive(cs)
        excl_hi = cs[-1][None, :] - cs
        w = math.comb(p, s) * (t ** (p - s))[:, None]
        y = y + w * (((-1.0) ** s) * excl_lo
                     + ((-1.0) ** (p - s)) * excl_hi)
    return y


def _apply_D_dense(x2, p: int):
    lo = lower_toeplitz(x2.shape[0], p, x2.dtype, x2.device)
    return (lo + lo.T) @ x2


def _apply_D_kernel(x2, p: int, lanes: int = 1):
    return kops.fgc_apply_dtilde(x2.contiguous(), p, lanes)


def _apply_D_two_pass(x2, p: int, backend: str):
    """For backends without a fused form (blocked)."""
    fn = _L_BACKENDS[backend]
    return fn(x2, p) + torch.flip(fn(torch.flip(x2, (0,)), p), (0,))


_D_BACKENDS = {
    "scan": fgc_scan.apply_dtilde_plain,
    "cumsum": _apply_D_cumsum,
    "blocked": partial(_apply_D_two_pass, backend="blocked"),
    "dense": _apply_D_dense,
    "kernel": _apply_D_kernel,
}


def _backend(table, backend):
    if backend not in table:
        raise ValueError(f"unknown FGC backend {backend!r}: expected one "
                         f"of {BACKENDS}")
    return table[backend]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def apply_L(x, axis: int = 0, power: int = 1, backend: str = "cumsum"):
    """y = L x along ``axis`` with L[i,j] = (i-j)^power, i>j."""
    if power < 0:
        raise ValueError("power must be >= 0")
    fn = _backend(_L_BACKENDS, backend)
    x2, shape, axis = _to_front(x, axis)
    return _from_front(fn(x2, power), shape, axis)


def apply_LT(x, axis: int = 0, power: int = 1, backend: str = "cumsum"):
    """y = Lᵀ x along ``axis`` — reversal identity (paper §3)."""
    fn = _backend(_L_BACKENDS, backend)
    x2, shape, axis = _to_front(x, axis)
    if backend == "kernel":
        y2 = _apply_L_kernel(x2, power, reverse=True)
    else:
        y2 = torch.flip(fn(torch.flip(x2, (0,)), power), (0,))
    return _from_front(y2, shape, axis)


def apply_abs_power(x, axis: int = 0, power: int = 1,
                    backend: str = "cumsum", lanes: int = 1):
    """y = D̃ x with D̃[i,j] = |i-j|^power (diagonal: 0^0 := 1 for power=0).

    power=0 is the all-ones matrix J (paper §3.1 Kronecker expansion term).
    ``lanes`` > 1 says that x's leading axis holds that many problems side
    by side (``axis`` is then another axis): every backend sums each column
    on its own, so lanes change no bit of the plain backends, and the
    kernel backend launches once for all lanes with the plan of one.
    """
    if power < 0:
        raise ValueError("power must be >= 0")
    if power == 0:
        return x.sum(dim=axis, keepdim=True) * torch.ones_like(x)
    fn = _backend(_D_BACKENDS, backend)
    x2, shape, axis = _to_front(x, axis)
    if backend == "kernel":
        return _from_front(_apply_D_kernel(x2, power, lanes), shape, axis)
    return _from_front(fn(x2, power), shape, axis)


def flops_estimate(n: int, p: int) -> int:
    """Paper §3 cost: (N-1)·p(p+1)/2 muls + (N-1)(p+2)(p+1)/2 adds per
    L-apply."""
    return (n - 1) * (p * (p + 1) // 2 + (p + 2) * (p + 1) // 2)
