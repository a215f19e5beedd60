"""FGC moment recursion: the CUDA kernels and their plain versions.

Reference: ``repro/kernels/fgc_scan.py``.  Replaces

* ``fgc_apply_l_pallas`` (``:166``; body ``_fgc_kernel`` ``:50``):
  y = L x with L[i,j] = (i−j)^p for i > j;
* ``fgc_apply_dtilde_pallas`` (``:127``; body ``_dtilde_kernel`` ``:68``,
  constants ``_block_constants`` ``:37``): y = (L + Lᵀ) x, D̃[i,j] = |i−j|^p;

along axis 0 of an (N, B) array.  Both run the paper's (p+1)-moment
recursion (eq. 3.9), a_{i+1} = P a_i + x_i·1 and y_i = a_i[p] with P the
Pascal matrix; Lᵀ is the same recursion from the last row up.  The state is
kept in float64 for float32 inputs too: the recursion's rounding error
grows with N, and Hopper has f64 (the reference's TPU kernel does not).  The CUDA
source is ``csrc/fgc_scan.cu`` (one thread per column, the state in
registers; see its note).  What bounds it on the card is the bytes of x read
plus y written.

The plain versions run the same recursion in PyTorch ops, one row at a time
(a Python loop over N): they are the CPU path, the ``"scan"`` backend of
``repro_torch.core.fgc``, and the yardstick of the kernels' arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

MAX_POWER = 8                 # the kernel's template range, 0..8
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}


def pascal_matrix(p: int, dtype=torch.float32, device=None):
    """(p+1)×(p+1) lower-triangular binomial matrix P[r,s] = C(r,s)."""
    m = [[math.comb(r, s) if s <= r else 0 for s in range(p + 1)]
         for r in range(p + 1)]
    return torch.tensor(m, dtype=dtype, device=device)


def _recursion(xs, p: int):
    """y_i = a_i[p], a_{i+1} = P a_i + x_i over the rows of (N, B) xs, with
    the state in float64 (as the kernel keeps it); returns float64."""
    xs = xs.double()
    n, b = xs.shape
    pasc = pascal_matrix(p, xs.dtype, xs.device)
    a = xs.new_zeros((p + 1, b))
    ys = torch.empty_like(xs)
    for i in range(n):
        ys[i] = a[p]
        a = pasc @ a + xs[i]
    return ys


def apply_l_plain(x, p: int = 1):
    """y = L x along axis 0 of (N, B) x."""
    return _recursion(x, p).to(x.dtype)


def apply_dtilde_plain(x, p: int = 1):
    """y = (L + Lᵀ) x along axis 0 of (N, B) x: the forward and the mirrored
    stream side by side in one recursion; Lx is rounded to x's dtype before
    Lᵀx is added, as the kernel stores it."""
    b = x.shape[1]
    ys = _recursion(torch.cat([x, torch.flip(x, (0,))], dim=1), p)
    lo = ys[:, :b].to(x.dtype)
    return (lo.double() + torch.flip(ys[:, b:], (0,))).to(x.dtype)


@functools.cache
def _entry(name: str):
    from repro_torch.kernels import build

    fn = getattr(build.library("fgc_scan"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(kind: str, x, p: int):
    if not x.is_cuda:
        raise ValueError("the FGC kernels take CUDA tensors")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be a non-empty (N, B) array, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_TAG:
        raise TypeError(f"x must be float32 or float64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the FGC kernels take a contiguous x")
    if not 0 <= p <= MAX_POWER:
        raise ValueError(f"the FGC kernels take 0 <= p <= {MAX_POWER}, "
                         f"got {p}")
    n, b = x.shape
    y = torch.empty_like(x)
    name = f"fgc_apply_{kind}_{_DTYPE_TAG[x.dtype]}"
    fn = _entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), n, b, p, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return y


def apply_l_cuda(x, p: int = 1):
    """Launch the L kernel on a contiguous CUDA (N, B) x."""
    return _launch("l", x, p)


def apply_dtilde_cuda(x, p: int = 1):
    """Launch the fused D̃ kernel on a contiguous CUDA (N, B) x."""
    return _launch("dtilde", x, p)
