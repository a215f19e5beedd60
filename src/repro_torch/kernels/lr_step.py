"""Factored-plan (low-rank coupling) kernels: the CUDA kernels and their
plain versions.

Reference: ``repro/kernels/lr_step.py``.  Replaces

* ``lr_dykstra_half_pallas`` (``:112``, batched ``:154``; body
  ``_dykstra_half_kernel`` ``:81``): one factor side of a Dykstra sweep,
  f = log w − LSE_lanes(gcol ⊕ lk) (−inf on zero-mass rows) and
  col = LSE_rows(f ⊕ lk) at the new f;
* ``lr_gram_chain_pallas`` (``:215``, batched ``:263``; body
  ``_gram_chain_kernel`` ``:179``): for D = A·Bᵀ and a factor Q,
  bq = BᵀQ, gram = Qᵀ(A·bq), sq = Qᵀ1, tq = Qᵀw;
* ``lr_grad_combine_pallas`` (``:285``, batched ``:327``; body
  ``_grad_combine_kernel`` ``:275``):
  out = (2(d2·sᵀ + 1·tᵀ) − 4·A·W)·diag(iq).

Every function here takes B lanes: (B, N, ·) factors and (B, ·) vectors.
The single-problem path calls them with B = 1.  The CUDA source is
``csrc/lr_step.cu``; its note says how the sequential grid axes of the TPU
kernels became per-block partials merged in a fixed order.  What bounds
each on the card is bytes: lk (B5), the factors read in two passes (B6),
the factor and the (N, r) output (B7).

The plain versions are the same functions in PyTorch ops, with the kernels'
association (B6: BᵀQ first; B7: the quad term A·W against the (c, r) seed).
They are the CPU path and the yardstick of the kernels' arithmetic on the
card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.sinkhorn_step import MAX_LANES, _lse

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16"}
#: rows a block of the Dykstra kernel takes, and of each Gram-chain pass
DYKSTRA_ROWS = 256
GRAM_ROWS = 1024
#: the kernels' limits: r and c up to this many columns, and B7's
#: (c + 3)·r values of shared memory within 48 KiB
MAX_COLS = 1024
SMEM_BYTES = 48 * 1024


def dykstra_half_plain(lk, gcol, logw):
    """f = log w − LSE_lanes(gcol ⊕ lk), −inf where log w = −inf, and
    col = LSE_rows(f ⊕ lk), over (B, N, r) lanes; lk may be bfloat16 (it is
    widened to the duals' dtype)."""
    lk = lk.to(gcol.dtype)
    lse = _lse(gcol[:, None, :] + lk, 2)
    f = torch.where(logw > -torch.inf, logw - lse,
                    torch.full_like(logw, -torch.inf))
    return f, _lse(f[:, :, None] + lk, 1)


def gram_chain_plain(a, b, q, w):
    """(bq, gram, sq, tq) = (BᵀQ, Qᵀ(A·BᵀQ), Qᵀ1, Qᵀw) over (B, N, ·)
    lanes."""
    bq = b.transpose(1, 2) @ q
    gram = q.transpose(1, 2) @ (a @ bq)
    return bq, gram, q.sum(dim=1), (w[:, None, :] @ q)[:, 0]


def grad_combine_plain(a, w_small, d2, s, t, iq):
    """(2(d2·sᵀ + 1·tᵀ) − 4·A·W)·diag(iq) over (B, N, ·) lanes."""
    quad = a @ w_small
    return (2.0 * (d2[:, :, None] * s[:, None, :] + t[:, None, :])
            - 4.0 * quad) * iq[:, None, :]


@functools.cache
def _entry(name: str, n_ptr: int, n_int: int):
    from repro_torch.kernels import build

    fn = getattr(build.library("lr_step"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(name, n_int, device, ptrs, ints):
    fn = _entry(name, len(ptrs), n_int)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[t.data_ptr() for t in ptrs], *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check(named, shapes, dtype, device):
    """Every tensor CUDA, contiguous, on one device, of its shape and of
    ``dtype`` (the first may also be bfloat16 where ``named[0]`` says so)."""
    for (name, t), shape in zip(named, shapes):
        if not t.is_cuda or t.device != device:
            raise TypeError(f"{name} must be a CUDA tensor on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype and not (name == "lk" and
                                     t.dtype == torch.bfloat16):
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _dims(x, what):
    if x.dim() != 3:
        raise ValueError(f"{what} must be (B, N, ·), got {tuple(x.shape)}")
    lanes, n, k = x.shape
    if not (1 <= lanes <= MAX_LANES and n >= 1 and 1 <= k <= MAX_COLS):
        raise ValueError(f"unsupported {what} shape {tuple(x.shape)}")
    return lanes, n, k


def _float_dtype(t):
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"expected float32 or float64, got {t.dtype}")
    return t.dtype


def dykstra_half_cuda(lk, gcol, logw):
    """Launch B5: lk (B, N, r) (the duals' dtype or bfloat16), gcol (B, r),
    log w (B, N) → (f (B, N), col (B, r))."""
    lanes, n, r = _dims(lk, "lk")
    dt = _float_dtype(gcol)
    _check((("lk", lk), ("gcol", gcol), ("logw", logw)),
           ((lanes, n, r), (lanes, r), (lanes, n)), dt, lk.device)
    nblk = -(-n // DYKSTRA_ROWS)
    f = torch.empty((lanes, n), dtype=dt, device=lk.device)
    col = torch.empty((lanes, r), dtype=dt, device=lk.device)
    part = torch.empty((2, lanes, r, nblk), dtype=dt, device=lk.device)
    _call(f"lr_dykstra_half_{_DTYPE_TAG[lk.dtype]}_{_DTYPE_TAG[dt]}", 4,
          lk.device, (lk, gcol, logw, f, col, part[0], part[1]),
          (lanes, n, r, DYKSTRA_ROWS))
    return f, col


def gram_chain_cuda(a, b, q, w):
    """Launch B6 (both passes, one C entry point): A, B (B, N, c), Q (B, N,
    r), w (B, N) → (bq (B, c, r), gram (B, r, r), sq (B, r), tq (B, r))."""
    lanes, n, c = _dims(a, "A")
    _, _, r = _dims(q, "Q")
    dt = _float_dtype(q)
    _check((("A", a), ("B", b), ("Q", q), ("w", w)),
           ((lanes, n, c), (lanes, n, c), (lanes, n, r), (lanes, n)), dt,
           q.device)
    nblk = -(-n // GRAM_ROWS)
    ext = torch.empty((lanes, c + 2, r), dtype=dt, device=q.device)
    gram = torch.empty((lanes, r, r), dtype=dt, device=q.device)
    part1 = torch.empty((lanes, (c + 2) * r, nblk), dtype=dt,
                        device=q.device)
    part2 = torch.empty((lanes, r * r, nblk), dtype=dt, device=q.device)
    _call(f"lr_gram_chain_{_DTYPE_TAG[dt]}", 5, q.device,
          (a, b, q, w, ext, gram, part1, part2), (lanes, n, c, r, GRAM_ROWS))
    return ext[:, :c], gram, ext[:, c], ext[:, c + 1]


def grad_combine_cuda(a, w_small, d2, s, t, iq):
    """Launch B7: A (B, N, c), W (B, c, r), d2 (B, N), s, t, iq (B, r) →
    (B, N, r)."""
    lanes, n, c = _dims(a, "A")
    r = iq.shape[-1]
    dt = _float_dtype(iq)
    _check((("A", a), ("W", w_small), ("d2", d2), ("s", s), ("t", t),
            ("iq", iq)),
           ((lanes, n, c), (lanes, c, r), (lanes, n), (lanes, r), (lanes, r),
            (lanes, r)), dt, a.device)
    if (c + 3) * r * iq.element_size() > SMEM_BYTES:
        raise ValueError(f"c={c}, r={r}: W, s, t and iq exceed the "
                         f"kernel's {SMEM_BYTES} bytes of shared memory")
    out = torch.empty((lanes, n, r), dtype=dt, device=a.device)
    _call(f"lr_grad_combine_{_DTYPE_TAG[dt]}", 4, a.device,
          (a, w_small, d2, s, t, iq, out), (lanes, n, c, r))
    return out
