"""The port's kernel modules on the CPU: the plain versions of B1–B4 against
the reference's Pallas kernels (interpret mode), and the wrappers' CPU
dispatch.  Inputs are made with numpy from a seed and handed to both."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import sinkhorn_step as jsk
from repro_torch.kernels import build, fgc_scan, lr_step, ops, sinkhorn_step

RNG = np.random.default_rng(11)

# Half-step tolerance: the reference's own bar for the fused kernel against
# the XLA expression (tests/test_kernels.py) — ≤1 ulp-level: the kernel
# associates the +inf-padded tile sums differently.
_TOL = {np.float32: dict(rtol=2e-6, atol=2e-6),
        np.float64: dict(rtol=1e-14, atol=1e-15)}


def _half_inputs(m, n, dtype, lanes=None):
    shape = (m, n) if lanes is None else (lanes, m, n)
    cost = RNG.random(shape).astype(dtype)
    vshape = shape[:-2] + (n,)
    g = RNG.normal(size=vshape).astype(dtype)
    f = RNG.normal(size=shape[:-2] + (m,)).astype(dtype)
    log_mu = np.log(np.full(shape[:-2] + (m,), 1.0 / m)).astype(dtype)
    log_nu = np.log(np.full(vshape, 1.0 / n)).astype(dtype)
    return cost, g, f, log_mu, log_nu


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n", [(1, 5), (37, 53), (100, 130), (200, 140)])
@pytest.mark.parametrize("eps", [0.05, 0.002])
def test_half_steps_match_pallas(dtype, m, n, eps):
    cost, g, f, log_mu, log_nu = _half_inputs(m, n, dtype)
    want_f = jsk.sinkhorn_row_update_pallas(
        jnp.asarray(cost), jnp.asarray(g), jnp.asarray(log_mu),
        dtype(eps), interpret=True)
    want_g = jsk.sinkhorn_col_update_pallas(
        jnp.asarray(cost), jnp.asarray(f), jnp.asarray(log_nu),
        dtype(eps), interpret=True)
    got_f = ops.sinkhorn_row_update(_t(cost), _t(g), _t(log_mu), eps)
    got_g = ops.sinkhorn_col_update(_t(cost), _t(f), _t(log_nu), eps)
    assert got_f.dtype == got_g.dtype == torch.from_numpy(cost).dtype
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               **_TOL[dtype])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               **_TOL[dtype])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_zero_mass_leading_tile(kind):
    """An all-masked leading reduction tile (−inf potentials on the first
    130 > 128 atoms) and −inf log-mass outputs: −inf out, never NaN, equal
    to the reference kernel."""
    m, n, eps = 40, 160, 0.01
    cost = RNG.random((m, n)) if kind == "row" else RNG.random((n, m))
    vec = np.where(np.arange(n) < 130, -np.inf, RNG.normal(size=n))
    logw = np.log(np.full(m, 1.0 / m))
    logw[[0, 7, 29]] = -np.inf
    if kind == "row":
        want = jsk.sinkhorn_row_update_pallas(
            jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw), eps,
            interpret=True)
        got = ops.sinkhorn_row_update(_t(cost), _t(vec), _t(logw), eps)
    else:
        want = jsk.sinkhorn_col_update_pallas(
            jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw), eps,
            interpret=True)
        got = ops.sinkhorn_col_update(_t(cost), _t(vec), _t(logw), eps)
    assert not torch.isnan(got).any()
    np.testing.assert_array_equal(torch.isneginf(got).numpy(),
                                  np.isneginf(logw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float64])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_lanes_per_lane_eps(kind):
    """(B, M, N) lanes with one ε per lane against the reference's batched
    wrappers."""
    cost, g, f, log_mu, log_nu = _half_inputs(40, 56, np.float64, lanes=3)
    epss = np.array([0.05, 0.01, 0.002])
    vec, logw = (g, log_mu) if kind == "row" else (f, log_nu)
    ref = getattr(jsk, f"sinkhorn_{kind}_update_pallas_batched")
    want = ref(jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw),
               jnp.asarray(epss), interpret=True)
    got = getattr(ops, f"sinkhorn_{kind}_update_batched")(
        _t(cost), _t(vec), _t(logw), _t(epss))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float64])


@pytest.mark.parametrize("kind", ["row", "col"])
def test_half_step_bf16_cost(kind):
    """cost_dtype="bf16": C rounded to bfloat16, duals and accumulation in
    f32 — the same rounding on both sides (f32 → bf16 is one rounding)."""
    cost, g, f, log_mu, log_nu = _half_inputs(64, 72, np.float32)
    vec, logw = (g, log_mu) if kind == "row" else (f, log_nu)
    ref = getattr(jsk, f"sinkhorn_{kind}_update_pallas")
    want = ref(jnp.asarray(cost), jnp.asarray(vec), jnp.asarray(logw),
               np.float32(0.01), interpret=True, cost_dtype="bf16")
    got = getattr(ops, f"sinkhorn_{kind}_update")(
        _t(cost), _t(vec), _t(logw), 0.01, cost_dtype="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_TOL[np.float32])


@pytest.mark.parametrize("n", [3, 64, 200, 257])
@pytest.mark.parametrize("b", [1, 7, 130])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_fgc_plain_matches_pallas(n, b, p):
    """B3/B4 plain recursions against the reference kernels (interpret
    mode); f64 rounding of two O(N^p) recursions → relative 1e-10."""
    x = RNG.normal(size=(n, b))
    want_l = jops.fgc_apply_l(jnp.asarray(x), p)
    want_d = jops.fgc_apply_dtilde(jnp.asarray(x), p)
    got_l = ops.fgc_apply_l(_t(x), p)
    got_d = ops.fgc_apply_dtilde(_t(x), p)
    scale = float(n) ** p
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               rtol=1e-10, atol=1e-12 * scale)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               rtol=1e-10, atol=1e-12 * scale)


def test_fgc_plain_f32_keeps_dtype():
    x = RNG.normal(size=(100, 40)).astype(np.float32)
    got = ops.fgc_apply_dtilde(_t(x), 2)
    want = jops.fgc_apply_dtilde(jnp.asarray(x), 2)
    assert got.dtype == torch.float32
    # f32 recursion over 100 rows: relative 1e-4 of the |D̃||x| scale
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * 100 ** 2)


def test_cpu_wrappers_run_plain_and_count_nothing():
    ops.reset_launch_counts()
    x = _t(RNG.normal(size=(20, 3)))
    torch.testing.assert_close(ops.fgc_apply_l(x, 2),
                               fgc_scan.apply_l_plain(x, 2))
    torch.testing.assert_close(ops.fgc_apply_l(x, 2, reverse=True),
                               fgc_scan.apply_l_plain(x, 2, reverse=True))
    cost, g, _, log_mu, _ = _half_inputs(5, 6, np.float64)
    ops.sinkhorn_row_update(_t(cost), _t(g), _t(log_mu), 0.1)
    assert set(ops.LAUNCHES.values()) == {0}


def test_cuda_entry_points_refuse_cpu_tensors():
    x = _t(RNG.normal(size=(20, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        fgc_scan.apply_l_cuda(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fgc_scan.apply_l_cuda(x, 1, reverse=True)
    with pytest.raises(ValueError, match="CUDA"):
        fgc_scan.apply_dtilde_cuda(x, 1)
    cost, g, f, log_mu, _ = _half_inputs(5, 6, np.float64, lanes=1)
    eps = torch.full((1,), 0.1, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_step.row_update_cuda(_t(cost), _t(g), _t(log_mu), eps)
    with pytest.raises(ValueError, match="CUDA"):
        sinkhorn_step.col_update_cuda(_t(cost), _t(f), _t(log_mu), eps)


@pytest.mark.parametrize("name,device,want", [
    ("auto", "cpu", "torch"), ("auto", "cuda", "kernel"),
    ("torch", "cpu", "torch"), ("torch", "cuda", "torch"),
    ("kernel", "cuda", "kernel")])
def test_resolve_sinkhorn_backend(name, device, want):
    assert ops.resolve_sinkhorn_backend(name, device) == want


def test_resolve_sinkhorn_backend_refuses():
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_sinkhorn_backend("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown"):
        ops.resolve_sinkhorn_backend("pallas", "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        ops.resolve_lowrank_backend("kernel", "cpu")
    with pytest.raises(ValueError, match="unknown lowrank backend"):
        ops.resolve_lowrank_backend("xla", "cpu")


@pytest.mark.parametrize("lanes,m,n,cost_bytes", [
    (1, 8192, 8192, 4), (1, 8192, 8192, 8), (1, 8192, 8192, 2),
    (1, 4096, 4096, 8), (1, 1, 5, 4), (1, 7, 8191, 2), (2, 300, 1029, 2),
    (3, 4099, 257, 4), (4, 1024, 1536, 8), (65535, 3, 2, 8)])
def test_col_split_covers_rows(lanes, m, n, cost_bytes):
    """The column kernel's split: whole SPLIT_ROWS steps, every row in
    exactly one split, no empty split, within the grid's limit."""
    splits, rows = sinkhorn_step.col_split(lanes, m, n, cost_bytes, 132)
    assert rows % sinkhorn_step.SPLIT_ROWS == 0
    assert (splits - 1) * rows < m <= splits * rows
    assert 1 <= splits <= min(m, sinkhorn_step.MAX_SPLITS)


@pytest.mark.parametrize("m,cost_bytes", [
    (8192, 4), (8192, 8), (8192, 2), (4096, 8)])
def test_col_split_fills_the_card(m, cost_bytes):
    """At the main path's square shapes (Runs A and B) the grid holds two
    full waves of a 132-SM card at the three resident blocks an SM that
    the kernel's registers allow, each split at least 256 rows."""
    splits, rows = sinkhorn_step.col_split(1, m, m, cost_bytes, 132)
    tiles = -(-m // (32 * (16 // cost_bytes)))
    assert tiles * splits >= 2 * 3 * 132
    assert rows >= 256


def test_col_split_refuses_too_many_splits():
    with pytest.raises(ValueError, match="splits"):
        sinkhorn_step.col_split(1, 10 ** 8, 1, 8, 10 ** 6)


_DK_SHAPES = [(1, 1, 1, 4), (1, 5, 5, 4), (2, 1001, 5, 4), (1, 8192, 16, 8),
              (1, 8192, 8, 2), (3, 100_003, 16, 4), (1, 10 ** 6, 16, 8),
              (1, 10 ** 6, 64, 2), (4, 999_983, 300, 8), (2, 70, 1024, 8),
              (1, 257, 1023, 2), (65535, 3, 2, 8), (7, 100_000, 32, 4)]


@pytest.mark.parametrize("lanes,n,r,itemsize", _DK_SHAPES)
def test_dykstra_plan_covers_rows(lanes, n, r, itemsize):
    """B5's plan: every row of a lane in exactly one block, no block empty,
    each block's and each tile's first row on a 16-byte boundary of lk,
    and a block's rows within its tiles."""
    plan = lr_step.dykstra_plan(lanes, n, r, itemsize, 132)
    spans = [lr_step.dykstra_block_rows(plan, n, k)
             for k in range(plan.blocks)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(b > a for a, b in spans)
    assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    assert all((a * r * itemsize) % 16 == 0 for a, _ in spans)
    assert max(b - a for a, b in spans) <= plan.block_rows
    assert (plan.tile_rows * r * itemsize) % 16 == 0
    assert plan.tiles_per_block * plan.tile_rows >= plan.block_rows
    assert (plan.tiles_per_block - 1) * plan.tile_rows < plan.block_rows
    assert 1 <= plan.blocks <= n


@pytest.mark.parametrize("n", [8192, 100_000, 10 ** 6])
@pytest.mark.parametrize("r", [8, 16, 32, 64])
@pytest.mark.parametrize("itemsize", [2, 4, 8])
def test_dykstra_plan_fills_the_card(n, r, itemsize):
    """At Runs C, D and E's N and the ranks of Run D and phase 2, the grid
    puts at least two blocks on each of a 132-SM card's SMs, and with a
    residency of 3 it is one wave of three an SM."""
    plan = lr_step.dykstra_plan(1, n, r, itemsize, 132)
    assert plan.blocks == 2 * 132
    plan3 = lr_step.dykstra_plan(1, n, r, itemsize, 132, blocks_per_sm=3)
    assert plan3.blocks == 3 * 132


@pytest.mark.parametrize("lanes", [2, 3, 64])
def test_dykstra_plan_spreads_lanes(lanes):
    """Several lanes: each lane takes one lane's plan (its blocks and so its
    order of sums), the lanes only multiply the grid."""
    plan = lr_step.dykstra_plan(lanes, 10 ** 5, 16, 8, 132)
    assert plan == lr_step.dykstra_plan(1, 10 ** 5, 16, 8, 132)
    assert plan.blocks * lanes >= 2 * 132


@pytest.mark.parametrize("r", [1, 5, 8, 16, 32, 64, 100, 256, 257, 1023,
                               1024])
@pytest.mark.parametrize("itemsize,dual_bytes", [(4, 4), (8, 8), (2, 4),
                                                 (2, 8)])
def test_dykstra_smem_within_the_limit(r, itemsize, dual_bytes):
    """A B5 block's shared memory stays within what an H100 block can opt
    in to (227 KB), with room for two blocks an SM."""
    smem = lr_step.dykstra_smem_bytes(r, itemsize, dual_bytes)
    assert smem * 2 <= 232_448
    rows = lr_step.dykstra_tile_rows(r, itemsize)
    if r in lr_step.DYKSTRA_TIERS:
        assert rows * r * itemsize == \
            lr_step.DYKSTRA_TILE_VECS * lr_step.DYKSTRA_THREADS * 16
    else:
        assert rows * r * itemsize <= lr_step.DYKSTRA_STAGE_BYTES
        assert rows <= lr_step.DYKSTRA_MAX_TILE_ROWS


@pytest.mark.parametrize("lanes,n,r,itemsize,what", [
    (0, 10, 4, 8, "lanes"), (1, 0, 4, 8, "lanes"), (1, 10, 0, 8, "lanes"),
    (1, 10, 1025, 8, "lanes"), (65536, 10, 4, 8, "lanes"),
    (1, 2 ** 31, 4, 8, "lanes"), (1, 10, 4, 3, "bytes")])
def test_dykstra_plan_refuses(lanes, n, r, itemsize, what):
    with pytest.raises(ValueError, match=what):
        lr_step.dykstra_plan(lanes, n, r, itemsize, 132)


# B6/B7 shapes: Runs C and D, the tests' small and ragged ones, several
# lanes, and the contract's corners (c, r up to 1024, N up to 2³¹ − 1)
_GR_SHAPES = [(1, 1, 5, 1, 4), (2, 45, 5, 6, 8), (2, 300, 12, 16, 4),
              (1, 10 ** 6, 5, 16, 4), (1, 10 ** 6, 5, 16, 8),
              (1, 10 ** 5, 5, 8, 8), (1, 10 ** 5, 5, 32, 8),
              (2, 100_003, 5, 64, 8), (3, 999_983, 5, 16, 4),
              (1, 70, 1024, 1024, 8), (4, 257, 1, 1023, 4),
              (65535, 3, 5, 16, 8), (1, 2 ** 31 - 1, 1, 1, 4)]


@pytest.mark.parametrize("lanes,n,c,r,itemsize", _GR_SHAPES)
def test_gram_plan_covers_rows(lanes, n, c, r, itemsize):
    """B6's plan: every row of a lane in exactly one block's run, no block
    empty, and at most GRAM_MAX_CHAIN rows of a stage for each row group
    (one FMA chain)."""
    plan = lr_step.gram_plan(lanes, n, c, r, itemsize, 132)
    assert 1 <= plan.blocks <= min(n, lr_step.GRAM_MAX_BLOCKS)
    blocks = sorted({0, 1, plan.blocks // 2, plan.blocks - 2,
                     plan.blocks - 1} & set(range(plan.blocks)))
    spans = [lr_step.gram_block_rows(plan, n, k) for k in blocks]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(b > a for a, b in spans)
    if plan.blocks <= 4096:
        every = [lr_step.gram_block_rows(plan, n, k)
                 for k in range(plan.blocks)]
        assert all(x[1] == y[0] for x, y in zip(every, every[1:]))
        assert all(b > a for a, b in every)
    gs = lr_step.gram_shape(c, r)
    assert 1 <= plan.tile_rows <= lr_step.GRAM_MAX_CHAIN * gs.groups
    assert plan.blocks * (2 * c + 2) * r <= max(lr_step.GRAM_MERGE_VALUES,
                                                (2 * c + 2) * r)


@pytest.mark.parametrize("c,r", [(1, 1), (5, 1), (5, 6), (5, 8), (5, 16),
                                 (12, 16), (5, 64), (100, 3), (1024, 1024)])
def test_gram_shape_covers_the_outputs(c, r):
    """B6's register tiles cover the (2c + 2, r) sums once: the passes'
    tiles, one a thread, and the row groups fit the block's threads, and
    a pass of more than one group leaves fewer idle threads than a tile's
    worth of groups."""
    gs = lr_step.gram_shape(c, r)
    kt, jt = lr_step.GRAM_TILE
    assert gs.k == 2 * c + 2
    assert gs.tiles * kt * jt >= gs.k * r
    assert (gs.tiles - 1) // -(-r // jt) * kt < gs.k
    assert gs.per_pass * gs.passes >= gs.tiles
    assert gs.per_pass * (gs.passes - 1) < gs.tiles
    assert gs.per_pass * gs.groups <= lr_step.GRAM_THREADS
    assert lr_step.GRAM_THREADS - gs.per_pass * gs.groups < gs.per_pass


@pytest.mark.parametrize("n,r", [(10 ** 6, 16), (10 ** 5, 8), (10 ** 5, 16),
                                 (10 ** 5, 32), (10 ** 6, 64)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_gram_plan_fills_the_card(n, r, itemsize):
    """At Runs C and D's shapes one lane's grid is one wave of two blocks
    on each of a 132-SM card's SMs, or of three where three fit."""
    assert lr_step.gram_plan(1, n, 5, r, itemsize, 132).blocks == 2 * 132
    assert lr_step.gram_plan(1, n, 5, r, itemsize, 132,
                             blocks_per_sm=3).blocks == 3 * 132


@pytest.mark.parametrize("lanes", [2, 3, 5, 64, 500])
def test_gram_plan_spreads_lanes(lanes):
    """Several lanes: each lane takes one lane's plan, a wave of two blocks
    an SM, whatever the lane count (so a lane's partials and their merge
    are those of the lane alone); the lanes only multiply the grid."""
    plan = lr_step.gram_plan(lanes, 10 ** 5, 5, 16, 8, 132)
    assert plan == lr_step.gram_plan(1, 10 ** 5, 5, 16, 8, 132)
    assert plan.blocks == 2 * 132


@pytest.mark.parametrize("c,r", [(1, 1), (5, 1), (5, 6), (5, 16), (5, 32),
                                 (5, 64), (12, 16), (5, 300), (300, 5),
                                 (1024, 1), (1, 1024), (1024, 1024)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_gram_smem_within_the_limit(c, r, itemsize):
    """A B6 block's shared memory stays within what an H100 block can opt
    in to (227 KB), room for two blocks an SM wherever a stage holds
    whole GRAM_STAGE_BYTES of rows; a stage is at least one row."""
    rows = lr_step.gram_tile_rows(c, r, itemsize)
    smem = lr_step.gram_smem_bytes(c, r, itemsize, rows)
    assert smem <= 232_448
    row_bytes = (2 * c + r + 1) * itemsize
    if row_bytes <= lr_step.GRAM_STAGE_BYTES:
        assert 2 * smem <= 232_448
        assert rows * row_bytes <= lr_step.GRAM_STAGE_BYTES
    assert rows >= 1


@pytest.mark.parametrize("lanes,n,c,r,itemsize,what", [
    (0, 10, 5, 4, 8, "lanes"), (1, 0, 5, 4, 8, "lanes"),
    (1, 10, 0, 4, 8, "lanes"), (1, 10, 5, 0, 8, "lanes"),
    (1, 10, 1025, 4, 8, "lanes"), (1, 10, 5, 1025, 8, "lanes"),
    (65536, 10, 5, 4, 8, "lanes"), (1, 2 ** 31, 5, 4, 8, "lanes"),
    (1, 10, 5, 4, 2, "bytes")])
def test_gram_plan_refuses(lanes, n, c, r, itemsize, what):
    with pytest.raises(ValueError, match=what):
        lr_step.gram_plan(lanes, n, c, r, itemsize, 132)


@pytest.mark.parametrize("r,itemsize,vec", [(16, 4, 4), (16, 8, 2),
                                            (8, 8, 2), (32, 8, 2),
                                            (6, 4, 1), (6, 8, 2), (1, 4, 1),
                                            (1, 8, 1), (1024, 4, 4),
                                            (1023, 8, 1)])
@pytest.mark.parametrize("c", [1, 5, 12, 1024])
def test_combine_plan_covers_rows(r, itemsize, vec, c):
    """B7's plan: 16-byte stores where a row holds whole ones, one value
    else; the threads of a row cover its slices (walking them where a row
    has more than a block's threads); a tile is whole steps of the block's
    rows within COMBINE_STAGE_BYTES (one step at least); the grid is one
    wave and no block is without a tile."""
    for n in (1, 45, 100_003, 10 ** 6):
        plan = lr_step.combine_plan(1, n, c, r, itemsize, 132, 8)
        assert plan.vec == vec == lr_step.combine_vec(r, itemsize)
        assert plan.per_row == min(r // vec, lr_step.COMBINE_THREADS)
        assert plan.rows_per_block * plan.per_row <= \
            lr_step.COMBINE_THREADS < (plan.rows_per_block + 1) * \
            plan.per_row
        assert plan.tile_rows % plan.rows_per_block == 0
        assert plan.tile_rows == plan.rows_per_block or \
            plan.tile_rows * (c + 1) * itemsize <= \
            lr_step.COMBINE_STAGE_BYTES
        assert 1 <= plan.blocks <= 8 * 132
        assert (plan.blocks - 1) * plan.tile_rows < n
        if n >= 8 * 132 * plan.tile_rows:
            assert plan.blocks == 8 * 132


def test_combine_plan_spreads_lanes_and_refuses():
    plan = lr_step.combine_plan(3, 10 ** 6, 5, 16, 4, 132, 8)
    assert plan.blocks * 3 <= 8 * 132 < (plan.blocks + 1) * 3
    for bad in ((0, 10, 5, 4, 8), (1, 0, 5, 4, 8), (1, 10, 5, 0, 8),
                (1, 10, 5, 1025, 8), (1, 10, 0, 4, 8), (1, 10, 1025, 4, 8),
                (1, 10, 5, 4, 2)):
        with pytest.raises(ValueError):
            lr_step.combine_plan(*bad, 132, 8)


# B3's five target shapes (Runs A, B and E; the squared-distance applies)
_DT_TARGETS = [(8192, 8192), (64, 262144), (8192, 16), (8192, 1)]
_DT_SHAPES = _DT_TARGETS + [(1, 1), (15, 3), (17, 1), (255, 9000),
                            (257, 9000), (64, 4099), (1000, 130),
                            (100_003, 7), (2 ** 31 - 1, 1), (3, 2 ** 20)]


def _dt_valid(plan, n, cols, streams):
    tiles = -(-cols // plan.col_tile)
    return (plan.streams == streams
            and plan.seg_rows == plan.groups * plan.chunk
            and (plan.segments - 1) * plan.seg_rows < n
            <= plan.segments * plan.seg_rows
            and (tiles - 1) * plan.col_tile < cols <= tiles * plan.col_tile
            and plan.col_tile * plan.groups <= fgc_scan.DTILDE_THREADS
            and plan.groups <= fgc_scan.DTILDE_MAX_GROUPS
            and plan.carry_cols * plan.lanes <= fgc_scan.DTILDE_CARRY_THREADS
            and plan.segments <= plan.lanes * plan.lane_segs
            and (plan.lane_segs == 1
                 or plan.lanes * (plan.lane_segs // 2) < plan.segments)
            and all(v & (v - 1) == 0 for v in (
                plan.seg_rows, plan.col_tile, plan.groups, plan.carry_cols,
                plan.lanes, plan.lane_segs))
            and tiles * plan.segments <= fgc_scan.MAX_BLOCKS
            and 1 <= plan.blocks <= tiles * plan.segments
            and 1 <= plan.state_blocks <= tiles * plan.segments)


# The scan's plan is shared by B3 (two streams) and B4 (one): each plan test
# runs at both stream counts.
_STREAMS = pytest.mark.parametrize("streams", [2, 1])


@pytest.mark.parametrize("n,cols", _DT_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("sms", [1, 132])
@_STREAMS
def test_dtilde_plan_covers_rows(n, cols, itemsize, sms, streams):
    """The scan's plan: the segments cover the N rows and the tiles the B
    columns, each once (none empty); power-of-two segments, tiles, groups
    and lanes within a block's 256 threads and 16 groups; the carry's lanes
    cover the segments, each lane as few as the lanes allow."""
    plan = fgc_scan.dtilde_plan(n, cols, itemsize, sms, streams=streams)
    assert _dt_valid(plan, n, cols, streams)


@pytest.mark.parametrize("n,cols", _DT_TARGETS)
@pytest.mark.parametrize("itemsize", [4, 8])
@_STREAMS
def test_dtilde_plan_fills_the_card(n, cols, itemsize, streams):
    """At the target shapes the grid holds at least two blocks on each of a
    132-SM card's SMs, and one wave of what the card holds where the items
    allow; Run B's 64 rows are one segment (no carry)."""
    plan = fgc_scan.dtilde_plan(n, cols, itemsize, 132, streams=streams)
    assert -(-cols // plan.col_tile) * plan.segments >= 2 * 132
    assert plan.blocks == plan.state_blocks == 2 * 132
    items = -(-cols // plan.col_tile) * plan.segments
    plan = fgc_scan.dtilde_plan(n, cols, itemsize, 132, 3, 4, streams)
    assert (plan.blocks, plan.state_blocks) == (min(items, 3 * 132),
                                                min(items, 4 * 132))
    if n == 64:
        assert plan.segments == 1


@pytest.mark.parametrize("itemsize", [4, 8])
@_STREAMS
def test_dtilde_plan_boundary_shapes(itemsize, streams):
    """The cuda tests' (255, 9000) and (257, 9000) straddle a segment
    boundary (row 256) on a 132-SM card; (64, 4099) has several segments."""
    below, above = (fgc_scan.dtilde_plan(n, 9000, itemsize, 132,
                                         streams=streams)
                    for n in (255, 257))
    assert below.seg_rows == above.seg_rows and 256 % above.seg_rows == 0
    assert above.segments == 256 // above.seg_rows + 1 == below.segments + 1
    assert fgc_scan.dtilde_plan(64, 4099, itemsize, 132,
                                streams=streams).segments > 1


@pytest.mark.parametrize("p", range(fgc_scan.MAX_POWER + 1))
@pytest.mark.parametrize("itemsize", [4, 8])
@_STREAMS
def test_dtilde_smem_within_the_limit(p, itemsize, streams):
    """A scan pass block's shared memory stays within what an H100 block
    can opt in to (227 KB) at every chunk of the dtype, and at p <= 2 with
    16-row chunks within half of it (two blocks an SM); B3's largest block
    is the largest of any plan, a one-stream block's no larger than the
    same block's with two streams."""
    for chunk in fgc_scan.DTILDE_CHUNKS[itemsize]:
        big = fgc_scan.dtilde_smem_bytes(p, itemsize, chunk)
        assert big <= 232_448
        if p <= 2 and chunk == 16:
            assert 2 * big <= 232_448
        for tc in (1, 2, 4, 8, 16, 32):
            for groups in (1, 2, 4, 8, 16):
                if tc * groups <= fgc_scan.DTILDE_THREADS:
                    for apply in (False, True):
                        got = fgc_scan.dtilde_smem_bytes(
                            p, itemsize, chunk, tc, groups, apply, streams)
                        assert got <= fgc_scan.dtilde_smem_bytes(
                            p, itemsize, chunk, tc, groups, apply) <= big


@pytest.mark.parametrize("n,cols,itemsize,sms,what", [
    (0, 4, 8, 132, "cannot take"), (4, 0, 8, 132, "cannot take"),
    (2 ** 31, 1, 8, 132, "cannot take"), (4, 4, 2, 132, "bytes"),
    (4, 4, 8, 0, "SM"), (2 ** 31 - 1, 2 ** 31 - 1, 4, 132, "blocks")])
@_STREAMS
def test_dtilde_plan_refuses(n, cols, itemsize, sms, what, streams):
    with pytest.raises(ValueError, match=what):
        fgc_scan.dtilde_plan(n, cols, itemsize, sms, streams=streams)


@pytest.mark.parametrize("streams", [0, 3])
def test_dtilde_plan_refuses_stream_counts(streams):
    with pytest.raises(ValueError, match="streams"):
        fgc_scan.dtilde_plan(64, 4, 8, 132, streams=streams)


# the fields that fix a column's order of sums: chunk, segments, groups and
# the carry's lanes (the other fields only place the work on the card)
_PER_COLUMN = ("chunk", "seg_rows", "col_tile", "segments", "groups",
               "lanes", "lane_segs", "streams")


@pytest.mark.parametrize("n,cols", _DT_TARGETS + [(2048, 2048), (2048, 1),
                                                  (100_003, 7), (64, 4099),
                                                  (1, 1), (257, 9000)])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("lanes", [2, 5, 16])
@_STREAMS
def test_dtilde_plan_lanes_keep_one_lanes_sums(n, cols, itemsize, lanes,
                                               streams):
    """Lanes side by side in x's columns take one lane's plan: every field
    that fixes a column's order of sums is the (N, cols) plan's, the grid
    covers all lanes' columns, and lanes=1 is the default plan."""
    one = fgc_scan.dtilde_plan(n, cols, itemsize, 132, streams=streams)
    assert fgc_scan.dtilde_plan(n, cols, itemsize, 132, streams=streams,
                                lanes=1) == one
    many = fgc_scan.dtilde_plan(n, cols, itemsize, 132, streams=streams,
                                lanes=lanes)
    assert all(getattr(many, f) == getattr(one, f) for f in _PER_COLUMN)
    assert _dt_valid(many, n, lanes * cols, streams)


@pytest.mark.parametrize("lanes", [2, 16, 65535])
@pytest.mark.parametrize("m,n,cost_bytes", [(2048, 2048, 8), (8192, 8192, 4),
                                            (4096, 4096, 8), (300, 1029, 2)])
def test_col_split_is_one_lanes(lanes, m, n, cost_bytes):
    """The column kernel splits each lane's rows as it splits one lane's,
    so col_finish merges a lane's splits in the same order in any batch."""
    assert sinkhorn_step.col_split(lanes, m, n, cost_bytes, 132) == \
        sinkhorn_step.col_split(1, m, n, cost_bytes, 132)
    with pytest.raises(ValueError, match="lanes"):
        sinkhorn_step.col_split(0, m, n, cost_bytes, 132)


def _shift(p, rows):
    """P_rows[r, s] = C(r, s)·rows^(r−s): a state shifted past `rows`
    rows."""
    return torch.tensor([[math.comb(r, s) * float(rows) ** (r - s)
                          if s <= r else 0.0 for s in range(p + 1)]
                         for r in range(p + 1)], dtype=torch.float64)


def _group_scan(f, m, shift_of):
    """The kernels' Hillis-Steele scans over dim 0 of (G, ·, p+1, B)
    states: f inclusive from the first group, m from the last; at distance
    d the partner is shifted by shift_of(d)."""
    g, d = f.shape[0], 1
    while d < g:
        sh = shift_of(d)
        f, m = f.clone(), m.clone()
        f[d:] = torch.einsum("rs,g...sb->g...rb", sh, f[:-d].clone()) + f[d:]
        m[:-d] = torch.einsum("rs,g...sb->g...rb", sh, m[d:].clone()) + \
            m[:-d]
        d *= 2
    return f, m


def _segmented_dtilde(x, p, plan):
    """B3's algebra in plain f64 PyTorch: chunk states, the in-block scans,
    the carry lanes, then the two streams from each chunk's start states."""
    n, b = x.shape
    ch, g, k = plan.chunk, plan.groups, plan.segments
    pasc = fgc_scan.pascal_matrix(p, torch.float64)
    xs = torch.zeros((k * plan.seg_rows, b), dtype=torch.float64)
    xs[:n] = x.double()
    xs = xs.reshape(k, g, ch, b).permute(1, 0, 2, 3)     # (G, K, CHUNK, B)

    def absorb(a, row):
        return torch.einsum("rs,...sb->...rb", pasc, a) + row[..., None, :]

    f = m = torch.zeros((g, k, p + 1, b), dtype=torch.float64)
    for j in range(ch):
        f = absorb(f, xs[:, :, j])
        m = absorb(m, xs[:, :, ch - 1 - j])
    # pass 1: each segment's totals
    fi, mi = _group_scan(f, m, lambda d: _shift(p, d * ch))
    tot_f, tot_m = fi[-1], mi[0]                          # (K, p+1, B)
    # carry: lanes of lane_segs segments, zero states past the end
    lanes, q = plan.lanes, plan.lane_segs
    pad = torch.zeros((lanes * q - k, p + 1, b), dtype=torch.float64)
    a_ = torch.cat([tot_f, pad]).reshape(lanes, q, p + 1, b)
    b_ = torch.cat([tot_m, pad]).reshape(lanes, q, p + 1, b)
    ps = _shift(p, plan.seg_rows)
    u = w = torch.zeros((lanes, p + 1, b), dtype=torch.float64)
    for j in range(q):
        u = torch.einsum("rs,lsb->lrb", ps, u) + a_[:, j]
        w = torch.einsum("rs,lsb->lrb", ps, w) + b_[:, q - 1 - j]
    ui, wi = _group_scan(u, w, lambda d: _shift(p, d * plan.seg_rows * q))
    zero = torch.zeros((1, p + 1, b), dtype=torch.float64)
    e, ew = torch.cat([zero, ui[:-1]]), torch.cat([wi[1:], zero])
    cf, cm = torch.empty_like(a_), torch.empty_like(b_)
    for j in range(q):
        cf[:, j] = e
        e = torch.einsum("rs,lsb->lrb", ps, e) + a_[:, j]
        cm[:, q - 1 - j] = ew
        ew = torch.einsum("rs,lsb->lrb", ps, ew) + b_[:, q - 1 - j]
    cf = cf.reshape(-1, p + 1, b)[:k]
    cm = cm.reshape(-1, p + 1, b)[:k]
    # pass 2: seed the first and last groups, scan, take the neighbours'
    pr = _shift(p, ch)
    f, m = f.clone(), m.clone()
    f[0] = torch.einsum("rs,ksb->krb", pr, cf) + f[0]
    m[-1] = torch.einsum("rs,ksb->krb", pr, cm) + m[-1]
    fi, mi = _group_scan(f, m, lambda d: _shift(p, d * ch))
    a = torch.cat([cf[None], fi[:-1]])
    bm = torch.cat([mi[1:], cm[None]])
    lo = torch.empty((g, k, ch, b), dtype=torch.float64)
    hi = torch.empty_like(lo)
    for j in range(ch):
        hi[:, :, ch - 1 - j] = bm[:, :, p]
        bm = absorb(bm, xs[:, :, ch - 1 - j])
        lo[:, :, j] = a[:, :, p]
        a = absorb(a, xs[:, :, j])
    y = (lo.to(x.dtype).double() + hi).permute(1, 0, 2, 3)
    return y.reshape(-1, b)[:n].to(x.dtype)


def _segmented_l(x, p, plan, reverse):
    """B4's algebra in plain f64 PyTorch: the forward stream of
    `_segmented_dtilde` alone (chunk states, the in-block scan, the carry
    lanes, the stream from each chunk's start state), over x's rows bottom
    up for Lᵀ (the kernel's row map)."""
    n, b = x.shape
    ch, g, k = plan.chunk, plan.groups, plan.segments
    pasc = fgc_scan.pascal_matrix(p, torch.float64)
    xs = torch.zeros((k * plan.seg_rows, b), dtype=torch.float64)
    xs[:n] = torch.flip(x, (0,)) if reverse else x
    xs = xs.reshape(k, g, ch, b).permute(1, 0, 2, 3)     # (G, K, CHUNK, B)

    def absorb(a, row):
        return torch.einsum("rs,...sb->...rb", pasc, a) + row[..., None, :]

    f = torch.zeros((g, k, p + 1, b), dtype=torch.float64)
    for j in range(ch):
        f = absorb(f, xs[:, :, j])
    # pass 1: each segment's total
    tot = _group_scan(f, f, lambda d: _shift(p, d * ch))[0][-1]
    # carry: lanes of lane_segs segments, zero states past the end
    lanes, q = plan.lanes, plan.lane_segs
    pad = torch.zeros((lanes * q - k, p + 1, b), dtype=torch.float64)
    a_ = torch.cat([tot, pad]).reshape(lanes, q, p + 1, b)
    ps = _shift(p, plan.seg_rows)
    u = torch.zeros((lanes, p + 1, b), dtype=torch.float64)
    for j in range(q):
        u = torch.einsum("rs,lsb->lrb", ps, u) + a_[:, j]
    ui = _group_scan(u, u, lambda d: _shift(p, d * plan.seg_rows * q))[0]
    e = torch.cat([torch.zeros((1, p + 1, b), dtype=torch.float64),
                   ui[:-1]])
    cf = torch.empty_like(a_)
    for j in range(q):
        cf[:, j] = e
        e = torch.einsum("rs,lsb->lrb", ps, e) + a_[:, j]
    cf = cf.reshape(-1, p + 1, b)[:k]
    # pass 2: seed the first group, scan, take the neighbour's
    f = f.clone()
    f[0] = torch.einsum("rs,ksb->krb", _shift(p, ch), cf) + f[0]
    fi = _group_scan(f, f, lambda d: _shift(p, d * ch))[0]
    a = torch.cat([cf[None], fi[:-1]])
    lo = torch.empty((g, k, ch, b), dtype=torch.float64)
    for j in range(ch):
        lo[:, :, j] = a[:, :, p]
        a = absorb(a, xs[:, :, j])
    y = lo.permute(1, 0, 2, 3).reshape(-1, b)[:n]
    return (torch.flip(y, (0,)) if reverse else y).to(x.dtype)


_ALGEBRA_SHAPES = pytest.mark.parametrize("n,b,sms", [
    (1, 1, 1), (17, 1, 1), (48, 2, 4), (257, 3, 4), (300, 3, 4),
    (511, 1, 64), (513, 5, 8), (700, 1, 1), (2000, 40, 1), (1000, 1, 132)])


@_ALGEBRA_SHAPES
@pytest.mark.parametrize("p", range(fgc_scan.MAX_POWER + 1))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_dtilde_carry_algebra_matches_plain(n, b, sms, p, itemsize):
    """The segmented scan's algebra (each dtype's plan and chunk, chunk
    states, the fold over groups, carry lanes) in f64 equals the plain
    recursion within its recursive-sum bound, across segment boundaries and
    for every p.  This holds the plan and the algebra; the kernel itself is
    held on the card."""
    x = _t(RNG.normal(size=(n, b)))
    plan = fgc_scan.dtilde_plan(n, b, itemsize, sms)
    got = _segmented_dtilde(x, p, plan)
    want = fgc_scan.apply_dtilde_plain(x, p)
    scale = fgc_scan.apply_dtilde_plain(x.abs(), p)
    u = torch.finfo(torch.float64).eps / 2
    assert ((got - want).abs() <= 2 * (p + 2) * n * u * scale).all()
    if n > 64:
        assert plan.segments > 1


@_ALGEBRA_SHAPES
@pytest.mark.parametrize("p", range(fgc_scan.MAX_POWER + 1))
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("reverse", [False, True])
def test_l_carry_algebra_matches_plain(n, b, sms, p, itemsize, reverse):
    """B4's one-stream scan (its plan, the chunk states, the fold over
    groups, the carry lanes, and for Lᵀ the row map) in f64 equals the
    plain recursion within the recursive-sum bound 2(p+2)·N·u·(L|x|) (Lᵀ|x|
    for Lᵀ), for every p and both dtypes' plans.  The kernel itself is held
    on the card."""
    x = _t(np.random.default_rng(n * 1000 + b).normal(size=(n, b)))
    plan = fgc_scan.dtilde_plan(n, b, itemsize, sms, streams=1)
    got = _segmented_l(x, p, plan, reverse)
    want = fgc_scan.apply_l_plain(x, p, reverse)
    scale = fgc_scan.apply_l_plain(x.abs(), p, reverse)
    u = torch.finfo(torch.float64).eps / 2
    assert ((got - want).abs() <= 2 * (p + 2) * n * u * scale).all()
    if n > 64:
        assert plan.segments > 1


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,b", [(1, 1), (45, 6), (300, 3)])
def test_l_plain_reverse_is_the_flip_identity(dtype, n, b):
    """apply_l_plain(x, reverse=True) is flip(L flip(x)), bit for bit."""
    x = _t(np.random.default_rng(n).normal(size=(n, b)).astype(dtype))
    want = torch.flip(fgc_scan.apply_l_plain(torch.flip(x, (0,)), 2), (0,))
    got = fgc_scan.apply_l_plain(x, 2, reverse=True)
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.parametrize("mangled,want", [
    ("_ZN49_GLOBAL__N__a99148b8_16_sinkhorn_step_cu_c36063cb10row_kernelI"
     "13__nv_bfloat16dLb0EEEvPKT_PKT0_S7_S7_PS5_ii",
     "row_kernel<bf16,f64,scalar>"),
    ("_ZN49_GLOBAL__N__a99148b8_16_sinkhorn_step_cu_c36063cb10col_kernelI"
     "ffLb1EEEvPKT_PKT0_S6_PS4_S7_iii", "col_kernel<f32,f32,vector>"),
    ("_ZN44_GLOBAL__N__e5c5092b_11_fgc_scan_cu_884757f310fgc_kernelIdLi8EEEv"
     "PKT_PS1_iib", "fgc_kernel<f64,8>"),
    ("plain_c_function", "plain_c_function")])
def test_kernel_name_demangles(mangled, want):
    assert build.kernel_name(mangled) == want


def test_kernel_registers_reads_ptxas():
    entry = "ptxas info    : Compiling entry function '{}' for 'sm_90a'"
    log = "\n".join([
        entry.format("_ZN2_N10col_finishIdEEv"),
        "ptxas info    : Function properties for _ZN2_N10col_finishIdEEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 28 registers, used 0 barriers",
        entry.format("_ZN2_N10row_kernelIddLb0EEEv"),
        "ptxas info    : Function properties for "
        "_ZN2_N10row_kernelIddLb0EEEv",
        "    40 bytes stack frame, 56 bytes spill stores, "
        "56 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers, 8192 bytes smem"])
    assert build.kernel_registers(log) == [
        ("col_finish<f64>", 28, 0), ("row_kernel<f64,f64,scalar>", 80, 56)]
