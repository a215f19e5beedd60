"""Public wrappers of the hand-written kernels, with their launch counters.

Reference: ``repro/kernels/ops.py``.  Each wrapper launches its CUDA kernel
when its tensor lies on a CUDA device (and raises if the kernel refuses
it), and computes the kernel's plain PyTorch version when the tensor lies on
the CPU.  Nothing falls back from a CUDA tensor to the plain version.

``LAUNCHES`` counts the kernel launches of each wrapper (plain versions are
not counted); ``reset_launch_counts`` sets them to 0.  The counts are
taken under a lock: the serving engine's pipeline launches from several
threads at once, and an unguarded ``+= 1`` can lose a count.

The reference's ``_tpu_f32_inputs`` is not ported: it exists because Pallas
on a TPU has no f64, and Hopper has f64, so every wrapper keeps the
caller's dtype.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import fgc_scan, lr_step, sinkhorn_step

LAUNCHES = {"sinkhorn_row_update": 0, "sinkhorn_col_update": 0,
            "fgc_apply_dtilde": 0, "fgc_apply_l": 0,
            "lr_dykstra_half": 0, "lr_gram_chain": 0, "lr_grad_combine": 0}


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """One launch of ``name``'s kernel, counted under the lock."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _resolve(family: str, backend: str, device) -> str:
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "kernel" if on_cuda else "torch"
    if backend == "kernel":
        if not on_cuda:
            raise ValueError(
                f"{family}_backend='kernel' needs CUDA tensors: the CUDA "
                "kernels cannot run on the CPU (use 'auto' or 'torch')")
        return backend
    if backend == "torch":
        return backend
    raise ValueError(f"unknown {family} backend {backend!r}: expected "
                     "'auto', 'kernel', or 'torch'")


def resolve_sinkhorn_backend(backend: str = "auto",
                             device: torch.device | str = "cpu") -> str:
    """The log-mode dual-update knob for tensors on ``device``: ``"auto"``
    picks the CUDA kernels on a CUDA device and the plain PyTorch version
    on the CPU; ``"kernel"`` forces the kernels (and raises on the CPU);
    ``"torch"`` forces the plain version.  The reference's ``"pallas"`` and
    ``"xla"`` are ``"kernel"`` and ``"torch"`` here (see
    `repro_torch.convert`)."""
    return _resolve("sinkhorn", backend, device)


def resolve_lowrank_backend(backend: str = "auto",
                            device: torch.device | str = "cpu") -> str:
    """The factored-plan twin of `resolve_sinkhorn_backend`: ``"kernel"``
    runs the Dykstra half-sweep (B5) and, on factor-pair geometries, the
    Gram chain (B6) and gradient assembly (B7) as CUDA kernels; ``"torch"``
    the plain PyTorch expressions; ``"auto"`` the kernels on a CUDA device
    and the plain expressions on the CPU."""
    return _resolve("lowrank", backend, device)


def _lane_eps(eps, lanes: int, like):
    """ε as the (B,) device tensor the kernels read: a scalar is shared by
    every lane."""
    eps = torch.as_tensor(eps, dtype=like.dtype, device=like.device)
    return eps.expand(lanes).contiguous() if eps.dim() == 0 else eps


def cast_cost(cost, cost_dtype: str):
    """``cost_dtype="bf16"`` streams C as bfloat16 (the duals and the
    accumulation keep their own dtype)."""
    if cost_dtype == "f32":
        return cost
    if cost_dtype == "bf16":
        return cost.to(torch.bfloat16)
    raise ValueError(f"unknown cost_dtype {cost_dtype!r}: expected 'f32' "
                     "or 'bf16'")


def sinkhorn_row_update_batched(cost, g, log_mu, eps,
                                cost_dtype: str = "f32"):
    """Row half-step over (B, M, N) lanes; ``eps`` is a scalar or (B,)."""
    cost = cast_cost(cost, cost_dtype)
    eps = _lane_eps(eps, cost.shape[0], g)
    if cost.is_cuda:
        out = sinkhorn_step.row_update_cuda(cost, g, log_mu, eps)
        count_launch("sinkhorn_row_update")
        return out
    return sinkhorn_step.row_update_plain(cost, g, log_mu, eps)


def sinkhorn_col_update_batched(cost, f, log_nu, eps,
                                cost_dtype: str = "f32"):
    """Column half-step over (B, M, N) lanes; see the row twin."""
    cost = cast_cost(cost, cost_dtype)
    eps = _lane_eps(eps, cost.shape[0], f)
    if cost.is_cuda:
        out = sinkhorn_step.col_update_cuda(cost, f, log_nu, eps)
        count_launch("sinkhorn_col_update")
        return out
    return sinkhorn_step.col_update_plain(cost, f, log_nu, eps)


def sinkhorn_row_update(cost, g, log_mu, eps, cost_dtype: str = "f32"):
    """f = ε(log μ − LSE_p((g_p − C_ip)/ε)) for one (M, N) cost."""
    return sinkhorn_row_update_batched(cost[None], g[None], log_mu[None],
                                       eps, cost_dtype)[0]


def sinkhorn_col_update(cost, f, log_nu, eps, cost_dtype: str = "f32"):
    """g = ε(log ν − LSE_i((f_i − C_ip)/ε)) for one (M, N) cost."""
    return sinkhorn_col_update_batched(cost[None], f[None], log_nu[None],
                                       eps, cost_dtype)[0]


def fgc_apply_l(x, p: int = 1, reverse: bool = False):
    """y = L x along axis 0 of an (N, B) array; y = Lᵀ x with
    ``reverse``."""
    if x.is_cuda:
        y = fgc_scan.apply_l_cuda(x, p, reverse)
        count_launch("fgc_apply_l")
        return y
    return fgc_scan.apply_l_plain(x, p, reverse)


def fgc_apply_dtilde(x, p: int = 1, lanes: int = 1):
    """y = (L + Lᵀ) x along axis 0 of an (N, B) array: the fused D̃ apply.
    ``lanes`` problems side by side in the columns (B/lanes each) run in one
    launch, each lane with the plan of its own call."""
    if x.is_cuda:
        y = fgc_scan.apply_dtilde_cuda(x, p, lanes)
        count_launch("fgc_apply_dtilde")
        return y
    return fgc_scan.apply_dtilde_plain(x, p)


def lr_dykstra_half_batched(lk, gcol, logw, cost_dtype: str = "f32"):
    """One factor side of a Dykstra sweep over (B, N, r) lanes:
    (f, col) = (log w − LSE_lanes(gcol ⊕ lk), LSE_rows(f ⊕ lk))."""
    lk = cast_cost(lk, cost_dtype)
    if lk.is_cuda:
        out = lr_step.dykstra_half_cuda(lk, gcol, logw)
        count_launch("lr_dykstra_half")
        return out
    return lr_step.dykstra_half_plain(lk, gcol, logw)


def lr_dykstra_half(lk, gcol, logw, cost_dtype: str = "f32"):
    """The fused half-sweep for one (N, r) log-kernel; returns (f, col)."""
    f, col = lr_dykstra_half_batched(lk[None], gcol[None], logw[None],
                                     cost_dtype)
    return f[0], col[0]


def lr_gram_chain_batched(a_fac, b_fac, q, w):
    """(BᵀQ, Qᵀ(A·BᵀQ), Qᵀ1, Qᵀw) over (B, N, ·) lanes."""
    if q.is_cuda:
        out = lr_step.gram_chain_cuda(a_fac, b_fac, q, w)
        count_launch("lr_gram_chain")
        return out
    return lr_step.gram_chain_plain(a_fac, b_fac, q, w)


def lr_gram_chain(a_fac, b_fac, q, w):
    """The factor Gram chain for D = A·Bᵀ and one (N, r) factor Q."""
    return tuple(o[0] for o in lr_gram_chain_batched(
        a_fac[None], b_fac[None], q[None], w[None]))


def lr_grad_combine_batched(a_fac, w_small, d2, s_other, t_other, iq):
    """(2(d2·sᵀ + 1·tᵀ) − 4·A·W)·diag(iq) over (B, N, ·) lanes."""
    if a_fac.is_cuda:
        out = lr_step.grad_combine_cuda(a_fac, w_small, d2, s_other,
                                        t_other, iq)
        count_launch("lr_grad_combine")
        return out
    return lr_step.grad_combine_plain(a_fac, w_small, d2, s_other, t_other,
                                      iq)


def lr_grad_combine(a_fac, w_small, d2, s_other, t_other, iq):
    """The factored gradient assembly for one (N, c) factor."""
    return lr_grad_combine_batched(a_fac[None], w_small[None], d2[None],
                                   s_other[None], t_other[None], iq[None])[0]
