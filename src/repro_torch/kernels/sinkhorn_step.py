"""Log-domain Sinkhorn half-steps: the CUDA kernels and their plain versions.

Reference: ``repro/kernels/sinkhorn_step.py``.  Replaces

* ``sinkhorn_row_update_pallas`` (``:170``, batched ``:227``; body
  ``_row_kernel`` ``:90``):  f = ε(log μ − LSE_p((g_p − C_ip)/ε));
* ``sinkhorn_col_update_pallas`` (``:202``, batched ``:238``; body
  ``_col_kernel`` ``:113``):  g = ε(log ν − LSE_i((f_i − C_ip)/ε)),
  reading the same row-major C (no Cᵀ copy).

Every function here takes B lanes: cost (B, M, N), vectors (B, ·) and one ε
per lane, (B,).  The single-problem path calls them with B = 1.  The CUDA
source is ``csrc/sinkhorn_step.cu``; its note says how the sequential
reduction axis of the TPU kernels became a loop inside one block.  What
bounds a half-step on the card is the bytes of C, read once.

The plain versions are the same function in PyTorch ops: the max-shifted
logsumexp of ``jax.scipy.special.logsumexp`` (the shift is 0 where the max is
not finite, so an all −inf slice gives −inf, never NaN).  They are the CPU
path and the yardstick of the kernels' arithmetic on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16"}
MAX_LANES = 65535          # gridDim.y


def _lse(z, dim):
    m = torch.amax(z, dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(z - m).sum(dim=dim)) + m.squeeze(dim)


def row_update_plain(cost, g, log_mu, eps):
    """f = ε(log μ − LSE_p((g_p − C_ip)/ε)) over (B, M, N) lanes."""
    e = eps[:, None]
    z = (g[:, None, :] - cost.to(g.dtype)) / e[:, :, None]
    return e * (log_mu - _lse(z, 2))


def col_update_plain(cost, f, log_nu, eps):
    """g = ε(log ν − LSE_i((f_i − C_ip)/ε)) over (B, M, N) lanes."""
    e = eps[:, None]
    z = (f[:, :, None] - cost.to(f.dtype)) / e[:, :, None]
    return e * (log_nu - _lse(z, 1))


def _check(cost, vec, logw, eps, vec_len, out_len):
    if not cost.is_cuda:
        raise ValueError("the Sinkhorn kernels take CUDA tensors")
    if cost.dim() != 3:
        raise ValueError(f"cost must be (B, M, N), got {tuple(cost.shape)}")
    lanes, m, n = cost.shape
    if lanes < 1 or m < 1 or n < 1 or lanes > MAX_LANES:
        raise ValueError(f"unsupported cost shape {tuple(cost.shape)}")
    dt = vec.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"duals must be float32 or float64, got {dt}")
    if cost.dtype not in (dt, torch.bfloat16):
        raise TypeError(f"cost dtype {cost.dtype} does not go with {dt} "
                        "duals (same dtype, or bfloat16)")
    want = {"vec": (lanes, vec_len), "logw": (lanes, out_len),
            "eps": (lanes,)}
    for name, t in (("vec", vec), ("logw", logw), ("eps", eps)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != dt or t.device != cost.device:
            raise TypeError(f"{name} must be {dt} on {cost.device}")
    for t in (cost, vec, logw, eps):
        if not t.is_contiguous():
            raise ValueError("the Sinkhorn kernels take contiguous tensors")


@functools.cache
def _entry(name: str):
    from repro_torch.kernels import build

    fn = getattr(build.library("sinkhorn_step"), name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(kind, cost, vec, logw, eps, out_len):
    lanes, m, n = cost.shape
    out = torch.empty((lanes, out_len), dtype=vec.dtype, device=cost.device)
    name = f"sinkhorn_{kind}_{_DTYPE_TAG[cost.dtype]}_{_DTYPE_TAG[vec.dtype]}"
    fn = _entry(name)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cost.data_ptr(), vec.data_ptr(), logw.data_ptr(),
                eps.data_ptr(), out.data_ptr(), lanes, m, n, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def row_update_cuda(cost, g, log_mu, eps):
    """Launch the row kernel: (B, M, N) cost, g (B, N), log μ (B, M), ε (B,)
    → f (B, M)."""
    lanes, m, n = cost.shape
    _check(cost, g, log_mu, eps, n, m)
    return _launch("row", cost, g, log_mu, eps, m)


def col_update_cuda(cost, f, log_nu, eps):
    """Launch the column kernel: (B, M, N) cost, f (B, M), log ν (B, N),
    ε (B,) → g (B, N)."""
    lanes, m, n = cost.shape
    _check(cost, f, log_nu, eps, m, n)
    return _launch("col", cost, f, log_nu, eps, n)
