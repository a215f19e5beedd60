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
grows with N, and Hopper has f64 (the reference's TPU kernel does not).  The
CUDA source is ``csrc/fgc_scan.cu``.  Both kernels are one segmented scan:
the rows are cut into power-of-two segments, each segment's states are
composed from zero and carried across segments in a fixed order (a state
shifted past S rows is P_S[r,s] = C(r,s)·S^{r−s}, the reference's block
shift), and x is read twice and y written once (three CUDA launches: the
segments' states, the carry, the apply; only the apply with a single
segment).  D̃ takes two streams, the forward and the mirrored; L takes the
forward stream alone, and Lᵀ the same stream over x's rows bottom up (the
kernel's row map: no flipped copy).  What bounds both on the card is the
bytes of x read plus y written.  The grid comes from `dtilde_plan`, a pure
function of the shape, the dtype, the stream count and the card's SM count
(and its occupancy, asked of the runtime), so the CPU tests hold it.

The plain versions run the same recursion in PyTorch ops, one row at a time
(a Python loop over N): they are the CPU path, the ``"scan"`` backend of
``repro_torch.core.fgc``, and the yardstick of the kernels' arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

MAX_POWER = 8                 # the kernel's template range, 0..8
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
#: The scan's geometry (``csrc/fgc_scan.cu``, B3 and B4): a thread takes
#: `chunk` rows of one column (the first of DTILDE_CHUNKS, by dtype, that
#: leaves at least DTILDE_MIN_BLOCKS_PER_SM items an SM, else the last),
#: staged in a ring of DTILDE_SLOTS tiles in shared memory; a block holds a
#: tile of up to DTILDE_COL_TILE columns × `groups` chunks (at most
#: DTILDE_MAX_GROUPS, and DTILDE_THREADS threads), one segment of
#: groups·chunk rows.  The carry gives each column's `lanes` threads
#: DTILDE_LANE_SEGS segments each, or more when the lanes run out, in blocks
#: of at most DTILDE_CARRY_THREADS threads.  D̃ (B3) runs two streams, L and
#: Lᵀ (B4) one.
DTILDE_CHUNKS = {4: (32, 16), 8: (16,)}
DTILDE_SLOTS = 3
DTILDE_THREADS = 256
DTILDE_MAX_GROUPS = 16
DTILDE_COL_TILE = 32
DTILDE_MIN_BLOCKS_PER_SM = 2
DTILDE_LANE_SEGS = 4
DTILDE_CARRY_THREADS = 256
MAX_ROWS = 2 ** 31 - 1        # N and B are ints in the kernels
MAX_BLOCKS = 2 ** 31 - 1      # a grid's x extent


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


def apply_l_plain(x, p: int = 1, reverse: bool = False):
    """y = L x along axis 0 of (N, B) x; with ``reverse``, y = Lᵀ x =
    flip(L flip(x)), the reference's reversal identity."""
    if reverse:
        return torch.flip(_recursion(torch.flip(x, (0,)), p),
                          (0,)).to(x.dtype)
    return _recursion(x, p).to(x.dtype)


def apply_dtilde_plain(x, p: int = 1):
    """y = (L + Lᵀ) x along axis 0 of (N, B) x: the forward and the mirrored
    stream side by side in one recursion; Lx is rounded to x's dtype before
    Lᵀx is added, as the kernel stores it."""
    b = x.shape[1]
    ys = _recursion(torch.cat([x, torch.flip(x, (0,))], dim=1), p)
    lo = ys[:, :b].to(x.dtype)
    return (lo.double() + torch.flip(ys[:, b:], (0,))).to(x.dtype)


class DtildePlan(NamedTuple):
    """The scan's launch (B3 with two streams, B4 with one): `segments`
    segments of seg_rows = groups·chunk rows; an item is one segment of a
    tile of col_tile columns, for a block of col_tile·groups threads, and
    state_blocks (pass 1) and `blocks` (pass 2) blocks walk the items; the
    carry launch gives each block carry_cols columns × lanes threads, each
    lane lane_segs consecutive segments, each segment `streams` states a
    column."""
    chunk: int
    seg_rows: int
    col_tile: int
    segments: int
    groups: int
    carry_cols: int
    lanes: int
    lane_segs: int
    state_blocks: int
    blocks: int
    streams: int


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def dtilde_plan(n: int, cols: int, itemsize: int, sms: int,
                blocks_per_sm: int = DTILDE_MIN_BLOCKS_PER_SM,
                state_blocks_per_sm: int | None = None,
                streams: int = 2, lanes: int = 1) -> DtildePlan:
    """The scan's grid, for B3 (``streams=2``) or B4 (``streams=1``), for
    an (N, lanes·cols) x of `itemsize` bytes, `lanes` problems of `cols`
    columns each side by side, on a card of `sms` SMs that holds
    `blocks_per_sm` blocks of pass 2 and `state_blocks_per_sm` (default the
    same) of pass 1; the stream count enters the grid only through those
    (the runtime's occupancy of each stream count's kernels).  A tile is a
    lane's width up to DTILDE_COL_TILE columns (a power of two); a block
    starts at DTILDE_THREADS threads or DTILDE_MAX_GROUPS groups, has its
    groups halved while half of them would still hold N (a short N is one
    segment, no carry), then while one lane has fewer than
    DTILDE_MIN_BLOCKS_PER_SM items an SM; the chunk is the first of the
    dtype's DTILDE_CHUNKS that gets there.  So the chunk, the segments and
    the carry's lanes, which fix a column's order of sums, are one lane's,
    whatever `lanes` is: the other lanes only add tiles.  Each pass's grid
    is one wave: blocks_per_sm·sms blocks, or one an item where there are
    fewer."""
    if not (1 <= n <= MAX_ROWS and 1 <= cols and lanes >= 1
            and lanes * cols <= MAX_ROWS):
        raise ValueError(f"the scan cannot take an x of ({n}, {cols}) "
                         f"in {lanes} lane(s)")
    if itemsize not in DTILDE_CHUNKS:
        raise ValueError(f"the scan takes x of 4 or 8 bytes, not {itemsize}")
    if streams not in (1, 2):
        raise ValueError(f"the scan runs 1 or 2 streams, not {streams}")
    if state_blocks_per_sm is None:
        state_blocks_per_sm = blocks_per_sm
    if sms < 1 or min(blocks_per_sm, state_blocks_per_sm) < 1:
        raise ValueError(f"a card has at least one SM and one block an SM, "
                         f"not {sms} and {blocks_per_sm}")
    tc = min(DTILDE_COL_TILE, _pow2_at_least(cols))
    tiles = -(-cols // tc)
    want = DTILDE_MIN_BLOCKS_PER_SM * sms
    for chunk in DTILDE_CHUNKS[itemsize]:
        groups = min(DTILDE_MAX_GROUPS, DTILDE_THREADS // tc)
        while groups > 1 and groups // 2 * chunk >= n:
            groups //= 2
        while groups > 1 and tiles * -(-n // (groups * chunk)) < want:
            groups //= 2
        if tiles * -(-n // (groups * chunk)) >= want:
            break
    seg_rows = groups * chunk
    segments = -(-n // seg_rows)
    width = lanes * cols
    tiles = -(-width // tc)
    if tiles * segments > MAX_BLOCKS:
        raise ValueError(f"({n}, {width}) needs {tiles * segments} blocks")
    carry_lanes = min(DTILDE_CARRY_THREADS,
                      _pow2_at_least(-(-segments // DTILDE_LANE_SEGS)))
    lane_segs = _pow2_at_least(-(-segments // carry_lanes))
    carry_cols = min(DTILDE_CARRY_THREADS // carry_lanes,
                     _pow2_at_least(width))
    items = tiles * segments
    return DtildePlan(chunk, seg_rows, tc, segments, groups, carry_cols,
                      carry_lanes, lane_segs,
                      min(items, state_blocks_per_sm * sms),
                      min(items, blocks_per_sm * sms), streams)


def dtilde_smem_bytes(p: int, itemsize: int, chunk: int,
                      col_tile: int = DTILDE_COL_TILE,
                      groups: int = DTILDE_THREADS // DTILDE_COL_TILE,
                      apply: bool = True, streams: int = 2) -> int:
    """Shared memory of a scan pass block (the kernels' `pass_smem`):
    `streams` (p+1)-moment states a thread for the groups' fold, and
    DTILDE_SLOTS slots of the tile (`chunk` elements a thread) and, in the
    apply pass, of its carries (`streams` states a column); the default is
    B3's largest block.  The carry block's scan states are fewer."""
    return col_tile * (streams * (p + 1) * 8
                       * (groups + (DTILDE_SLOTS if apply else 0))
                       + DTILDE_SLOTS * chunk * itemsize * groups)


def _library():
    from repro_torch.kernels import build

    return build.library("fgc_scan")


@functools.cache
def _entry(tag: str):
    fn = getattr(_library(), f"fgc_scan_{tag}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launch_plan(tag, n, cols, itemsize, p, streams, lanes, device):
    """The scan's plan on `device` for `streams` streams and `lanes` lanes
    of `cols` columns, one wave of the blocks its SMs hold (both passes'
    occupancy, asked of the runtime once a shape; the call also lets the
    passes take their shared memory)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = dtilde_plan(n, cols, itemsize, sms, streams=streams, lanes=lanes)
    fn = getattr(_library(), f"fgc_scan_residency_{tag}")
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    resident = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        rc = fn(p, streams, plan.col_tile, plan.groups, plan.chunk, resident)
    if rc != 0 or min(resident) < 1:
        raise RuntimeError(f"fgc_scan_residency_{tag}: CUDA error {rc}, "
                           f"{list(resident)} blocks an SM")
    return dtilde_plan(n, cols, itemsize, sms, resident[1], resident[0],
                       streams, lanes)


def _launch(x, p: int, streams: int, reverse: bool = False, lanes: int = 1):
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
    if lanes < 1 or b % lanes:
        raise ValueError(f"{b} columns do not split into {lanes} lanes")
    y = torch.empty_like(x)
    tag = _DTYPE_TAG[x.dtype]
    fn = _entry(tag)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        plan = _launch_plan(tag, n, b // lanes, x.element_size(), p,
                            streams, lanes, x.device)
        # `streams` (p+1)-moment states a column and segment
        carry = torch.empty(
            (plan.segments * plan.streams * (p + 1) * b if plan.segments > 1
             else 0,), dtype=torch.float64, device=x.device)
        rc = fn(x.data_ptr(), y.data_ptr(), carry.data_ptr(), n, b, p,
                int(reverse), plan.streams, plan.chunk, plan.col_tile,
                plan.groups, plan.segments, plan.carry_cols, plan.lanes,
                plan.lane_segs, plan.state_blocks, plan.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"fgc_scan_{tag} ({streams} stream(s)) launch "
                           f"failed: CUDA error {rc}")
    return y


def apply_l_cuda(x, p: int = 1, reverse: bool = False):
    """Launch the L kernel (B4) on a contiguous CUDA (N, B) x: y = L x, or
    y = Lᵀ x with ``reverse`` (the same scan over x's rows bottom up, no
    flipped copy).  One call, up to three CUDA launches (states, carry,
    apply; only the apply with a single segment), with carry scratch from
    ``torch.empty``."""
    return _launch(x, p, 1, reverse)


def apply_dtilde_cuda(x, p: int = 1, lanes: int = 1):
    """Launch the fused D̃ kernel (B3) on a contiguous CUDA (N, B) x: the
    same scan with two streams, up to three CUDA launches.  ``lanes``
    problems side by side in x's columns (B/lanes each) take the plan of
    one, so each lane's bits are those of its own call."""
    return _launch(x, p, 2, lanes=lanes)
