"""Log-domain Sinkhorn half-steps: the CUDA kernels and their plain versions.

Reference: ``repro/kernels/sinkhorn_step.py``.  Replaces

* ``sinkhorn_row_update_pallas`` (``:170``, batched ``:227``; body
  ``_row_kernel`` ``:90``):  f = ε(log μ − LSE_p((g_p − C_ip)/ε));
* ``sinkhorn_col_update_pallas`` (``:202``, batched ``:238``; body
  ``_col_kernel`` ``:113``):  g = ε(log ν − LSE_i((f_i − C_ip)/ε)),
  reading the same row-major C (no Cᵀ copy).

Every function here takes B lanes: cost (B, M, N), vectors (B, ·) and one ε
per lane, (B,).  The single-problem path calls them with B = 1.  The CUDA
source is ``csrc/sinkhorn_step.cu``.  Both kernels take the reference's
online (max, sumexp) a register tile at a time, with C copied ahead into
shared memory by 16-byte asynchronous copies: the row kernel gives each row
one warp and shares each segment of g among a block's rows; the column
kernel splits M over blocks (`col_split`), writes one partial a column and
block to scratch, and a second launch merges the splits in a fixed order.
What bounds a half-step on the card is the issue of one IEEE division and
one ``exp`` an element, just above the bytes of C in f32 and well above
them in f64.

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
MAX_LANES = 65535          # gridDim.y (B1, B2's merge) and gridDim.z (B2)
#: the column kernel's geometry (``csrc/sinkhorn_step.cu``): a thread takes
#: 16 bytes of C a row, a block's 8 warps step over 64 rows at most (8 tiles
#: of up to 8 rows), and the grid aims at COL_BLOCKS_PER_SM blocks an SM (at
#: least two full waves at the main path's 4096² and 8192²)
SPLIT_ROWS = 64
COL_BLOCKS_PER_SM = 8
MAX_SPLITS = 65535         # gridDim.y


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


def col_split(lanes, m, n, cost_bytes, sms):
    """The column kernel's split of M over blocks: (splits, split_rows).

    A block covers 32 threads × (16 / cost_bytes) columns and all rows of
    one split.  The split count aims at COL_BLOCKS_PER_SM·sms blocks over
    one lane's column tiles, whatever the lane count: the lanes only
    multiply the grid's lane axis, so a lane's splits, and the order in
    which `col_finish` merges them, are those of the same lane alone.  A
    split is a multiple of SPLIT_ROWS rows (whole steps of the block's
    warps in every dtype), and none is empty."""
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{lanes} lanes: the grid takes 1 to {MAX_LANES}")
    cols = 32 * (16 // cost_bytes)
    tiles = -(-n // cols)
    want = max(1, -(-COL_BLOCKS_PER_SM * sms // tiles))
    split_rows = -(-(-(-m // want)) // SPLIT_ROWS) * SPLIT_ROWS
    splits = -(-m // split_rows)
    if splits > MAX_SPLITS:
        raise ValueError(f"{m} rows need {splits} splits > {MAX_SPLITS}")
    return splits, split_rows


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
def _entry(name: str, n_ptr: int, n_int: int):
    from repro_torch.kernels import build

    fn = getattr(build.library("sinkhorn_step"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(kind, cost, vec, logw, eps, out_len):
    lanes, m, n = cost.shape
    out = torch.empty((lanes, out_len), dtype=vec.dtype, device=cost.device)
    name = f"sinkhorn_{kind}_{_DTYPE_TAG[cost.dtype]}_{_DTYPE_TAG[vec.dtype]}"
    ptrs = [cost, vec, logw, eps, out]
    ints = [lanes, m, n]
    with torch.cuda.device(cost.device):
        if kind == "col":
            splits, split_rows = col_split(lanes, m, n, cost.element_size(),
                                           _sms(cost.device))
            part = torch.empty((2, lanes, splits, n), dtype=vec.dtype,
                               device=cost.device)
            ptrs += [part[0], part[1]]
            ints += [splits, split_rows]
        fn = _entry(name, len(ptrs), len(ints))
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(t.data_ptr() for t in ptrs), *ints, stream)
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
