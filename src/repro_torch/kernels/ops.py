"""Public wrappers of the hand-written kernels, with their launch counters.

Reference: ``repro/kernels/ops.py``.  Each wrapper launches its CUDA kernel
when its tensor lies on a CUDA device (and raises if the kernel refuses
it), and computes the kernel's plain PyTorch version when the tensor lies on
the CPU.  Nothing falls back from a CUDA tensor to the plain version.

``LAUNCHES`` counts the kernel launches of each wrapper (plain versions are
not counted); ``reset_launch_counts`` sets them to 0.

The reference's ``_tpu_f32_inputs`` is not ported: it exists because Pallas
on a TPU has no f64, and Hopper has f64, so every wrapper keeps the
caller's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fgc_scan, sinkhorn_step

LAUNCHES = {"sinkhorn_row_update": 0, "sinkhorn_col_update": 0,
            "fgc_apply_dtilde": 0, "fgc_apply_l": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_sinkhorn_backend(backend: str = "auto",
                             device: torch.device | str = "cpu") -> str:
    """The log-mode dual-update knob for tensors on ``device``: ``"auto"``
    picks the CUDA kernels on a CUDA device and the plain PyTorch version
    on the CPU; ``"kernel"`` forces the kernels (and raises on the CPU);
    ``"torch"`` forces the plain version.  The reference's ``"pallas"`` and
    ``"xla"`` are ``"kernel"`` and ``"torch"`` here (see
    `repro_torch.convert`)."""
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "kernel" if on_cuda else "torch"
    if backend == "kernel":
        if not on_cuda:
            raise ValueError(
                "sinkhorn_backend='kernel' needs CUDA tensors: the CUDA "
                "kernels cannot run on the CPU (use 'auto' or 'torch')")
        return backend
    if backend == "torch":
        return backend
    raise ValueError(f"unknown sinkhorn backend {backend!r}: expected "
                     "'auto', 'kernel', or 'torch'")


def resolve_lowrank_backend(backend: str = "auto", device="cpu") -> str:
    raise NotImplementedError(
        "the factored-plan (low-rank) kernels are not ported yet")


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
        LAUNCHES["sinkhorn_row_update"] += 1
        return out
    return sinkhorn_step.row_update_plain(cost, g, log_mu, eps)


def sinkhorn_col_update_batched(cost, f, log_nu, eps,
                                cost_dtype: str = "f32"):
    """Column half-step over (B, M, N) lanes; see the row twin."""
    cost = cast_cost(cost, cost_dtype)
    eps = _lane_eps(eps, cost.shape[0], f)
    if cost.is_cuda:
        out = sinkhorn_step.col_update_cuda(cost, f, log_nu, eps)
        LAUNCHES["sinkhorn_col_update"] += 1
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


def fgc_apply_l(x, p: int = 1):
    """y = L x along axis 0 of an (N, B) array."""
    if x.is_cuda:
        y = fgc_scan.apply_l_cuda(x, p)
        LAUNCHES["fgc_apply_l"] += 1
        return y
    return fgc_scan.apply_l_plain(x, p)


def fgc_apply_dtilde(x, p: int = 1):
    """y = (L + Lᵀ) x along axis 0 of an (N, B) array: the fused D̃ apply."""
    if x.is_cuda:
        y = fgc_scan.apply_dtilde_cuda(x, p)
        LAUNCHES["fgc_apply_dtilde"] += 1
        return y
    return fgc_scan.apply_dtilde_plain(x, p)
