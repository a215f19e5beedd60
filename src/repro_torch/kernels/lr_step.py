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
each on the card is bytes: lk (B5, against the issue of two ``exp`` an
element), A, B, Q and w read once (B6: one pass and one launch, the chain
taken as (AᵀQ)ᵀ(BᵀQ), XᵀQ over X = [B | A | 1 | w]), A and d2 read and
the (N, r) output written (B7, 16 bytes a thread).  B5's, B6's and B7's
grids come from `dykstra_plan`, `gram_plan` and `combine_plan`, pure
functions of the shape and the card's SM count and occupancy, so the CPU
tests hold them.

The plain versions are the reference's expressions and association (B6:
BᵀQ first, then Qᵀ(A·bq); B7: the quad term A·W against the (c, r) seed).
They are the CPU path and the yardstick of the kernels' arithmetic on the
card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.sinkhorn_step import MAX_LANES, _lse

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16"}
#: B5's geometry (``csrc/lr_step.cu``): ranks in DYKSTRA_TIERS take the
#: tier kernel, whose tile is DYKSTRA_TILE_VECS 16-byte vectors of lk a
#: thread (a lane holds one vector of a row, two in f64);
#: every other rank takes the general kernel, whose tile is at most
#: DYKSTRA_STAGE_BYTES of lk and DYKSTRA_MAX_TILE_ROWS rows.  The grid is
#: one wave of the blocks an SM holds, and at least
#: DYKSTRA_MIN_BLOCKS_PER_SM of them wherever N has the rows.
DYKSTRA_THREADS = 256
DYKSTRA_TIERS = (8, 16, 32, 64)
DYKSTRA_TILE_VECS = 4
DYKSTRA_STAGE_BYTES = 32 * 1024
DYKSTRA_MAX_TILE_ROWS = 1024
DYKSTRA_MIN_BLOCKS_PER_SM = 2
MAX_ROWS = 2 ** 31 - 1     # N is an int in the kernels
#: the kernels' limit: r and c up to this many columns
MAX_COLS = 1024
#: B6's geometry (``csrc/lr_step.cu``): the (2c + 2, r) sums XᵀQ in
#: GRAM_TILE register tiles, one a thread and a pass; the threads of a pass
#: in row groups; a ring of GRAM_STAGES tiles of rows, each about
#: GRAM_STAGE_BYTES and at most GRAM_MAX_CHAIN rows a group (one FMA
#: chain); GRAM_THREADS threads a block.  The grid is one wave of the
#: blocks an SM holds, at least GRAM_MIN_BLOCKS_PER_SM of them wherever N
#: has the rows, and no more than GRAM_MERGE_VALUES / ((2c + 2)·r) a lane
#: (the merge's scratch); the merge takes at most GRAM_MAX_BLOCKS partials,
#: in groups of GRAM_GROUP blocks (a ticket each, and one a lane).
GRAM_THREADS = 256
GRAM_TILE = (4, 4)
GRAM_STAGES = 3
GRAM_STAGE_BYTES = 32 * 1024
GRAM_MAX_CHAIN = 64
GRAM_MIN_BLOCKS_PER_SM = 2
GRAM_MERGE_VALUES = 2 ** 22
GRAM_GROUP = 16
GRAM_MAX_BLOCKS = 2 ** 16
#: B7's geometry: a thread takes 16 bytes of a row's outputs (4 f32, 2
#: f64; one value where r is not a multiple of that), COMBINE_THREADS a
#: block; a tile of about COMBINE_STAGE_BYTES of A and d2 a stage; one wave
#: of the blocks an SM holds, walking the tiles.
COMBINE_THREADS = 256
COMBINE_STAGE_BYTES = 8 * 1024


def dykstra_half_plain(lk, gcol, logw, lse=_lse):
    """f = log w − LSE_lanes(gcol ⊕ lk), −inf where log w = −inf, and
    col = LSE_rows(f ⊕ lk), over (B, N, r) lanes; lk may be bfloat16 (it is
    widened to the duals' dtype).  ``lse(z, dim)`` is the logsumexp."""
    lk = lk.to(gcol.dtype)
    f = torch.where(logw > -torch.inf, logw - lse(gcol[:, None, :] + lk, 2),
                    torch.full_like(logw, -torch.inf))
    return f, lse(f[:, :, None] + lk, 1)


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


class DykstraPlan(NamedTuple):
    """B5's launch: `blocks` blocks a lane, each a run of whole `unit`-row
    pieces (a 16-byte multiple of lk), as even as the pieces allow, so a
    block takes at most block_rows rows, a tile of tile_rows at a time."""
    tile_rows: int
    unit: int
    block_rows: int
    tiles_per_block: int
    blocks: int


def dykstra_block_rows(plan, n, blk):
    """The rows [a, b) that block `blk` of the plan takes (the kernels'
    `BlockRows`)."""
    units = -(-n // plan.unit)
    return (min(units * blk // plan.blocks * plan.unit, n),
            min(units * (blk + 1) // plan.blocks * plan.unit, n))


def dykstra_tile_rows(r, itemsize):
    """Rows of one B5 tile for rank r and lk of `itemsize` bytes: the tier
    kernel's DYKSTRA_TILE_VECS vectors a thread, or the general kernel's
    stage, a whole number of 16-byte vectors."""
    if r in DYKSTRA_TIERS:
        return DYKSTRA_TILE_VECS * DYKSTRA_THREADS * 16 // (r * itemsize)
    unit = _row_unit(r, itemsize)
    rows = min(DYKSTRA_MAX_TILE_ROWS, DYKSTRA_STAGE_BYTES // (r * itemsize))
    return max(unit, rows - rows % unit)


def _row_unit(r, itemsize):
    """The fewest rows whose bytes are a whole number of 16-byte vectors."""
    return 16 // math.gcd(r * itemsize, 16)


def dykstra_plan(lanes, n, r, itemsize, sms,
                 blocks_per_sm=DYKSTRA_MIN_BLOCKS_PER_SM):
    """B5's grid for `lanes` lanes of an (N, r) lk of `itemsize` bytes on a
    card of `sms` SMs that holds `blocks_per_sm` of its blocks: one lane's
    wave of blocks_per_sm·sms blocks (at least DYKSTRA_MIN_BLOCKS_PER_SM
    an SM, fewer only where N has fewer row units), none empty.  The lanes
    multiply the grid's lane axis and nothing else, so a lane's blocks and
    merge order, and so its bits, are those of the same lane alone; a
    batch of lanes runs in lanes waves."""
    if not (1 <= lanes <= MAX_LANES and 1 <= n <= MAX_ROWS
            and 1 <= r <= MAX_COLS):
        raise ValueError(f"B5 cannot take {lanes} lanes of ({n}, {r})")
    if itemsize not in (2, 4, 8):
        raise ValueError(f"B5 takes lk of 2, 4 or 8 bytes, not {itemsize}")
    unit = _row_unit(r, itemsize)
    tile_rows = dykstra_tile_rows(r, itemsize)
    per_sm = max(DYKSTRA_MIN_BLOCKS_PER_SM, blocks_per_sm)
    units = -(-n // unit)
    blocks = min(units, per_sm * sms)
    block_rows = -(-units // blocks) * unit
    return DykstraPlan(tile_rows, unit, block_rows,
                       -(-block_rows // tile_rows), blocks)


def dykstra_smem_bytes(r, itemsize, dual_bytes):
    """Shared memory of a B5 block (aligned rows), as the kernels lay it
    out: the tier kernel's two stages of vectors and log w and its warps'
    column partials, or the general kernel's two tiles, gcol, the tile's f
    and the threads' column partials; then the final merge's partials."""
    tile_rows = dykstra_tile_rows(r, itemsize)
    merge = 2 * DYKSTRA_THREADS * dual_bytes + 16
    if r in DYKSTRA_TIERS:
        return (2 * (DYKSTRA_TILE_VECS * DYKSTRA_THREADS * 16
                     + tile_rows * dual_bytes)
                + 2 * (DYKSTRA_THREADS // 32) * r * dual_bytes + merge)
    stage = -(-tile_rows * r * itemsize // 16) * 16
    return (2 * stage + (r + tile_rows + 2 * DYKSTRA_THREADS) * dual_bytes
            + merge)


class GramShape(NamedTuple):
    """B6's output tiling for (c, r): `k` = 2c + 2 rows of sums, `tiles`
    register tiles, `per_pass` of them a pass (one a thread), `groups` row
    groups of per_pass threads, `passes` passes over a block's rows."""
    k: int
    tiles: int
    per_pass: int
    groups: int
    passes: int


def gram_shape(c, r):
    """B6's tiling of the (2c + 2, r) sums (the kernels' `GramShape`)."""
    k = 2 * c + 2
    tiles = -(-k // GRAM_TILE[0]) * -(-r // GRAM_TILE[1])
    per_pass = min(tiles, GRAM_THREADS)
    return GramShape(k, tiles, per_pass, GRAM_THREADS // per_pass,
                     -(-tiles // per_pass))


def gram_tile_rows(c, r, itemsize):
    """Rows of one B6 stage: about GRAM_STAGE_BYTES of A, B, Q and w, at
    most GRAM_MAX_CHAIN rows for each row group, at least one row."""
    rows = GRAM_STAGE_BYTES // ((2 * c + r + 1) * itemsize)
    return max(1, min(GRAM_MAX_CHAIN * gram_shape(c, r).groups, rows))


def _span_cap(n, itemsize):
    """Values of a span of n staged at any 16-byte phase (`span_cap`)."""
    v = 16 // itemsize
    return (n + 2 * (v - 1)) // v * v


def gram_smem_bytes(c, r, itemsize, tile_rows):
    """Shared memory of a B6 block, as the kernel lays it out: a 16-byte
    slot for the constant 1, then GRAM_STAGES stages of the spans of B, A,
    Q and w (each at any 16-byte phase), which after the rows hold the row
    groups' sums for their fold."""
    stage = (2 * _span_cap(tile_rows * c, itemsize)
             + _span_cap(tile_rows * r, itemsize)
             + _span_cap(tile_rows, itemsize))
    gs = gram_shape(c, r)
    fold = gs.groups * gs.per_pass * GRAM_TILE[0] * GRAM_TILE[1]
    return 16 + max(GRAM_STAGES * stage, fold) * itemsize


class GramPlan(NamedTuple):
    """B6's launch: `blocks` blocks a lane, each a run of whole rows, a
    stage of `tile_rows` rows at a time."""
    tile_rows: int
    blocks: int


def gram_block_rows(plan, n, blk):
    """The rows [a, b) that block `blk` of the plan takes (the kernel's
    row_a, row_b)."""
    return n * blk // plan.blocks, n * (blk + 1) // plan.blocks


def gram_plan(lanes, n, c, r, itemsize, sms,
              blocks_per_sm=GRAM_MIN_BLOCKS_PER_SM):
    """B6's grid for `lanes` lanes of (N, c) factors and an (N, r) Q of
    `itemsize` bytes on a card of `sms` SMs that holds `blocks_per_sm` of
    its blocks: one lane's wave of blocks_per_sm·sms blocks (at least
    GRAM_MIN_BLOCKS_PER_SM an SM, fewer only where N has fewer rows or the
    merge's scratch would pass GRAM_MERGE_VALUES a lane), none empty.  As
    in `dykstra_plan`, the lanes multiply the grid's lane axis only, so a
    lane's partials and their merge are those of the same lane alone."""
    if not (1 <= lanes <= MAX_LANES and 1 <= n <= MAX_ROWS
            and 1 <= c <= MAX_COLS and 1 <= r <= MAX_COLS):
        raise ValueError(f"B6 cannot take {lanes} lanes of ({n}, {c}) "
                         f"factors at rank {r}")
    if itemsize not in (4, 8):
        raise ValueError(f"B6 takes 4 or 8 bytes a value, not {itemsize}")
    per_sm = max(GRAM_MIN_BLOCKS_PER_SM, blocks_per_sm)
    blocks = min(n, per_sm * sms, GRAM_MAX_BLOCKS,
                 max(1, GRAM_MERGE_VALUES // ((2 * c + 2) * r)))
    return GramPlan(gram_tile_rows(c, r, itemsize), blocks)


class CombinePlan(NamedTuple):
    """B7's launch: `vec` outputs a thread (16 bytes, or 1), `per_row`
    threads a row, `rows_per_block` rows a block at a time, a stage of
    `tile_rows` rows, `blocks` blocks a lane walking the tiles."""
    vec: int
    per_row: int
    rows_per_block: int
    tile_rows: int
    blocks: int


def combine_vec(r, itemsize):
    """Outputs a B7 thread stores at once: 16 bytes where a row is a whole
    number of them, else one value."""
    v = 16 // itemsize
    return v if r % v == 0 else 1


def combine_plan(lanes, n, c, r, itemsize, sms, blocks_per_sm):
    """B7's grid (the kernel's `CombineShape`): one wave of
    blocks_per_sm·sms blocks over all lanes, no more than the tiles."""
    if not (1 <= lanes <= MAX_LANES and 1 <= n <= MAX_ROWS
            and 1 <= c <= MAX_COLS and 1 <= r <= MAX_COLS):
        raise ValueError(f"B7 cannot take {lanes} lanes of ({n}, {c}) "
                         f"factors at rank {r}")
    if itemsize not in (4, 8):
        raise ValueError(f"B7 takes 4 or 8 bytes a value, not {itemsize}")
    vec = combine_vec(r, itemsize)
    per_row = min(r // vec, COMBINE_THREADS)
    rows = COMBINE_THREADS // per_row
    fit = COMBINE_STAGE_BYTES // ((c + 1) * itemsize)
    tile_rows = rows if fit < rows else fit // rows * rows
    blocks = min(-(-n // tile_rows),
                 max(1, max(1, blocks_per_sm) * sms // lanes))
    return CombinePlan(vec, per_row, rows, tile_rows, blocks)


def _library():
    from repro_torch.kernels import build

    return build.library("lr_step")


@functools.cache
def _entry(name: str, n_ptr: int, n_int: int):
    fn = getattr(_library(), name)
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


def _residency(name, *args):
    """Resident blocks an SM of a kernel, asked of the runtime."""
    fn = getattr(_library(), name)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    resident = ctypes.c_int(0)
    rc = fn(*args, ctypes.byref(resident))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return resident.value


@functools.cache
def _launch_plan(tag, lanes, n, r, itemsize, device):
    """B5's plan on `device`, one wave of the blocks its SMs hold (the
    kernel's occupancy, asked of the runtime once a shape)."""
    with torch.cuda.device(device):
        resident = _residency(f"lr_dykstra_residency_{tag}", r,
                              dykstra_tile_rows(r, itemsize))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dykstra_plan(lanes, n, r, itemsize, sms, resident)


#: B5's and B6's integer tickets by (device, stream): zero between
#: launches (the last block to take one resets it); B5 takes one a lane,
#: B6 one a lane and one a group of GRAM_GROUP blocks
_TICKETS: dict = {}


def _tickets(dev, count):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    ticket = _TICKETS.get(key)
    if ticket is None or ticket.numel() < count:
        ticket = _TICKETS[key] = torch.zeros(count, dtype=torch.int32,
                                             device=dev)
    return ticket


def dykstra_half_cuda(lk, gcol, logw):
    """Launch B5: lk (B, N, r) (the duals' dtype or bfloat16), gcol (B, r),
    log w (B, N) → (f (B, N), col (B, r))."""
    lanes, n, r = _dims(lk, "lk")
    dt = _float_dtype(gcol)
    dev = lk.device
    _check((("lk", lk), ("gcol", gcol), ("logw", logw)),
           ((lanes, n, r), (lanes, r), (lanes, n)), dt, dev)
    tag = f"{_DTYPE_TAG[lk.dtype]}_{_DTYPE_TAG[dt]}"
    plan = _launch_plan(tag, lanes, n, r, lk.element_size(), dev)
    f = torch.empty((lanes, n), dtype=dt, device=dev)
    col = torch.empty((lanes, r), dtype=dt, device=dev)
    part = torch.empty((2, lanes, plan.blocks, r), dtype=dt, device=dev)
    _call(f"lr_dykstra_half_{tag}", 6, dev,
          (lk, gcol, logw, f, col, part[0], part[1], _tickets(dev, lanes)),
          (lanes, n, r, plan.unit, plan.blocks, plan.tile_rows))
    return f, col


@functools.cache
def _gram_launch_plan(tag, lanes, n, c, r, itemsize, device):
    """B6's plan on `device`, one wave of the blocks its SMs hold."""
    with torch.cuda.device(device):
        resident = _residency(f"lr_gram_residency_{tag}", c, r,
                              gram_tile_rows(c, r, itemsize))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gram_plan(lanes, n, c, r, itemsize, sms, resident)


@functools.cache
def _combine_launch_plan(tag, lanes, n, c, r, itemsize, device):
    """B7's plan on `device`, one wave of the blocks its SMs hold."""
    with torch.cuda.device(device):
        resident = _residency(f"lr_grad_combine_residency_{tag}", c, r)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return combine_plan(lanes, n, c, r, itemsize, sms, resident)


def gram_chain_cuda(a, b, q, w):
    """Launch B6 (one launch: one pass over the rows, the lane's partials
    merged by its last block): A, B (B, N, c), Q (B, N, r), w (B, N) →
    (bq (B, c, r), gram (B, r, r), sq (B, r), tq (B, r))."""
    lanes, n, c = _dims(a, "A")
    _, _, r = _dims(q, "Q")
    dt = _float_dtype(q)
    dev = q.device
    _check((("A", a), ("B", b), ("Q", q), ("w", w)),
           ((lanes, n, c), (lanes, n, c), (lanes, n, r), (lanes, n)), dt,
           dev)
    tag = _DTYPE_TAG[dt]
    plan = _gram_launch_plan(tag, lanes, n, c, r, q.element_size(), dev)
    k = 2 * c + 2
    sums = torch.empty((lanes, k, r), dtype=dt, device=dev)
    gram = torch.empty((lanes, r, r), dtype=dt, device=dev)
    part = torch.empty((lanes, plan.blocks, k * r), dtype=dt, device=dev)
    tickets = _tickets(dev, lanes * (1 + -(-plan.blocks // GRAM_GROUP)))
    _call(f"lr_gram_chain_{tag}", 6, dev,
          (a, b, q, w, part, tickets, sums, gram),
          (lanes, n, c, r, plan.tile_rows, plan.blocks))
    return sums[:, :c], gram, sums[:, 2 * c], sums[:, 2 * c + 1]


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
    tag = _DTYPE_TAG[dt]
    plan = _combine_launch_plan(tag, lanes, n, c, r, iq.element_size(),
                                a.device)
    out = torch.empty((lanes, n, r), dtype=dt, device=a.device)
    _call(f"lr_grad_combine_{tag}", 5, a.device,
          (a, w_small, d2, s, t, iq, out), (lanes, n, c, r, plan.blocks))
    return out
