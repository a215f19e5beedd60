#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every kernel from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` (seconds; registers and
   spills of each kernel).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (8192 × 8192 and 8192 × 1 for B1–B4, and Run B's 4096²
   f64 and rows that are not 16-byte aligned, 8192 × 8191, for B1/B2;
   N = 10⁶, c = 5, r = 16 for B5–B7) and dtypes, plus zero-mass rows and
   columns, an all-masked leading block of columns, four lanes with four
   different ε, r = 64 and a ragged N; B5 also at Runs D and E's shapes
   (10⁵ rows at r = 8, 16, 32; 8192 rows at r = 16) and twice on the same
   inputs, which must give the same bits; B6/B7 also at Run D's shapes, on
   the exact factors of a point cloud shifted off the origin (B6, f32 and
   f64) and twice on the same inputs; B3 also at Runs E and B's shapes
   (8192 × 16 and 64 × 262144, f64); B4 as L and as Lᵀ (its reversed
   scan), also at (8192, 16) f64 and on 300 000 rows of one f64 column;
   B3 and B4 twice on the same inputs and on an x one element off a
   16-byte boundary, which must give the same bits.  Each line prints the
   measured difference beside its tolerance and the reason for it.  Then
   lanes: B1, B2, B3, B5, B6 and B7 each launched once with 16 lanes at
   Runs F and G's shapes (B3's lanes folded into its columns), ragged with
   zero-mass padding and one ε a lane, against each lane launched alone:
   the same bits.
3. The main path through ``repro_torch.core.entropic_gw``: a small check
   of the FGC kernels against the dense oracle, Run A (``Grid1D(8192)``,
   the paper's §4.1 settings, f32 and f64), Run B (``Grid2D(64)``, f64,
   adaptive with ε-annealing), the FGC primitives ``apply_L``/``apply_LT``
   (and ``apply_LT`` once more under ``torch.profiler``: B4's scan, no
   flip or copy kernel), and the factored plan: Run C (two 10⁶-point clouds, rank 16, f64 and
   f32, then the same solves kernels and plain side by side, f32 checked
   one step at a time), Run D (``plan_rank="auto"`` on two 10⁵-point
   clouds, f64, growing the rank by restarts) and Run E
   (``Grid1D(8192)``, rank 16, f64), each against the plain path on the
   card.  The launch counts are set to 0 just before each path and read
   just after.  One more Run A f32, Run B and Run C f64 solve each runs
   under ``torch.profiler`` (CPU and CUDA): the device's busy share over it
   and the device time of its top kernels; for Run C, also B6's and B7's
   kernels by name, B6 one device launch a call.  Then batches through
   ``repro_torch.core.entropic_gw_batch``: Run F (16 ragged ``Grid1D``
   lanes of 1024–2048 points padded to 2048, f64, one ε a lane from the
   serving cycle, adaptive with annealing), each lane against its solo
   solve, against the lanes in reversed order and against a segmented
   solve (the same bits), and 4 lanes against the plain path at 3 outer
   steps; profiled once.  Run G (4 ragged 3-D Gaussian cloud lanes of
   80 000–100 000 points padded to 100 000, rank 16, f64), each lane
   against its solo solve.  Both check the launches: one a half-step (B5:
   a sweep side) for all lanes.  Then gradients through the implicit
   backward pass (``core.solver.fixed_point_value``): Run H (the gradient
   of a converged ``Grid1D(8192)`` f64 solve in h, a 0-d tensor, and in μ,
   ν; kernels forward against plain forward, and against a central finite
   difference), Run I (the trainer's FGW alignment loss,
   ``fgw_alignment_loss_batch``, on 8 ragged pairs of 1536–2048 tokens at
   d = 2048, f32, its gradient to the student's states; kernels against
   plain by Run A's rule, each lane against its solo loss, exact zeros on
   the padded feature rows) and Run J (the gradient to one 10⁵-point
   cloud of a rank-16 factored solve, under a memory budget).  Each prints
   its forward and backward walls, the Neumann terms of each lane and the
   peak device memory; no backward launches a kernel.  Then the variants,
   each against its plain route with the launches checked against the
   code's formulas: Run K (``entropic_ugw`` on ``Grid1D(8192)``, f64,
   fixed and adaptive; B3 in its cost and value, profiled over two
   steps), Run L (``entropic_coot`` on data of MNIST → USPS's shapes,
   8192 × 784 and 8192 × 256, f64 and f32, profiled once, and its GW
   specialization on ``Grid1D(4096)`` through ``bilinear_product``'s B3,
   beside the grid-less dense products), Run M (``gw_barycenter`` of four ``Grid1D``
   inputs of 2048–4096 points on a 4096-point support, annealed, adaptive)
   and Run N (sliced GW on two 10⁶-point clouds: the sorted method in f64
   and f32 against the port's own CPU run (on 8 directions) and on a
   rotated, permuted copy; ``sliced_plan`` on 8192 points and the warm start
   ``FullCoupling.from_sliced`` gives a kernels solve, beside a cold one;
   the grid method's 32 lanes of ``entropic_gw_batch`` on the dense and
   the kernel FGC backends, kernels against plain lane by lane, against
   the sorted estimate, and twice for equal bits, the binning too).  Then
   serving, through ``repro_torch.serve.engine.GWEngine``: Run O(a), a
   mixed stream of 32 ``Grid1D`` requests of 1024–2048 points (one
   full-plan bucket padded to 2048, B1–B3, ε cycling over the serving
   stream's) and 24 cloud requests of 98 305–100 352 3-D points (one
   factored bucket padded to 100 352 at rank 16, B5–B7, its 16 slots
   refilled and repacked), f64, through the barrier, continuous and
   pipeline schedulers: every id once, the three schedulers' plans,
   potentials, factors and counts the same bits, every grid result its
   solo ``entropic_gw``'s bits and every factored result its lane alone's,
   the launches those of the code's formulas over the logged segments,
   the refills those of the slot width and a repack in each bucket,
   each flush's wall and stats, and the continuous and pipeline flushes'
   busy shares under ``torch.profiler``; Run O(b), one pipeline engine with
   the plan cache and the sliced tiers: 8 exact repeats answered with no
   launch, 8 near repeats warm-started to fewer outer steps, 4 rotated
   and re-indexed copies of an 8192-point cloud request found by the
   profile stage, two sliced answers on 10⁶-point clouds equal to
   ``sliced_gw``'s bits, and 4 refine requests whose final answers are the
   bits of a one-lane batch resumed from the sliced plan; Run O(c), the
   ``python -m repro_torch.launch.serve --gw`` driver as a subprocess.
   Then LM serving, through ``repro_torch.serve.engine.Engine`` (Run P;
   random weights from a seeded generator; no kernel of B1–B7 on this
   path, which the launch counts confirm): P(a), smollm-360m at its
   published config (32 layers, d 960), batch 4, a 128-token prompt and 32
   greedy tokens in f32 and bf16: prefill and every decode step's logits
   against the card's forward, the prompt's forward against the CPU's, a
   TF32 prefill that must miss the f32 bar, bf16 against f32 within 4× the
   CPU's own bf16 distance; prefill wall, decode ms a token, tokens/s,
   peak memory, and 8 decode steps under ``torch.profiler`` (busy share,
   launches a step).  P(b), the nine other architectures at their
   published widths, depth cut to the prologue plus one template period,
   batch 2, 64-token prompts and 16 decode steps, the same checks.  P(c),
   mixtral-8x22b's ring buffer: a 4200-token prompt past its 4096-token
   window and 16 decode steps that wrap it, against the forward over 4216
   tokens; zamba2's shared slot one storage over two periods, its caches
   per occurrence.  P(d), ``python -m repro_torch.launch.serve --arch
   smollm-360m`` as a subprocess.  Then training, through
   ``repro_torch.train.loop.train_step`` (Run Q; random weights from a
   seeded generator, ``SyntheticLM`` batches): Q(a), smollm-360m at its
   published widths, 16 of its 32 layers, 8 × 256 tokens, one AdamW step
   on the card against the same step on the CPU from one state (scalars,
   moments and parameters; a TF32 step must miss the bar), bf16 against
   f32 within 4× the CPU's own distance, 2 microbatches and remat against one
   plain step (remat's peak lower), the FGW distillation term with a
   second seeded model's hidden states as the teacher's, on B1/B2
   against the plain route (launches against the code's formula, the
   parameters moved by the term), ten bf16 steps overfitting the batch
   (ce falls; step walls, tokens/s, peak memory), one bf16 step under
   ``torch.profiler`` (busy share, launches).  Q(b), the nine
   other architectures at P(b)'s widths and depths, 2 × 32 tokens: the
   card's step against the CPU's forward and backward, each moment
   within max(1e-4, 8× its one-ulp envelope).  Q(c), ``python -m
   repro_torch.launch.train --arch smollm-360m --layers 16 --steps 5
   --ckpt-every 5 --deterministic`` as subprocesses: SIGTERM after step 2 lands a
   checkpoint (the handler's: no periodic save falls before the end),
   the same command resumes from it, and the final state
   equals an uninterrupted run's bits; ``launch.serve --ckpt-dir``
   serves it.  Then the sharded path (Run R; one NCCL rank a card, at
   most 4, started by ``torch.distributed.run`` as ``chip_smoke.py
   --run-r-rank``): smollm-360m at its published widths cut to 4 layers,
   Run Q(a)'s batch with the FGW term, 3 steps on (2, 2) "2d" and (4, 1)
   "dp" (one card: a (1, 1) mesh) against one card's steps and its
   one-ulp envelope, a plain f32 step, the bf16 in-loop gather's
   all-gathers, ZeRO-1's moment bytes and peaks a rank, a checkpoint
   saved on one mesh restored on another and on one card (equal bits),
   the sharded decode against one card's ``Engine``, and each profiled
   step's collectives (``launch/collectives.py``) and NCCL share.  Then
   the production dry run (Run S, ``repro_torch.launch.dryrun`` in a
   subprocess, ``chip_smoke.py --run-s``: its fake group of 256 or 512
   ranks shares no process with Run R's NCCL ranks): S(a) smollm-360m's
   cells on the 16×16 mesh and deepseek-v2-lite-16b × train_4k on
   2×16×16 through the CLI (``--no-flops``; deepseek's in a process of
   its own beside smollm's prefill and decode), each record without
   error and within the card's memory, its argument
   bytes the specs' reckoning, its peak at least its arguments, its
   collectives of the kinds "2d" implies; S(b), with 4 cards, Run
   R(a′)'s step dry-run on a fake (2, 2) group: its collectives by kind
   and payload equal to Run R's rank 0's, its peak within `S_PEAK_BAR`
   of what that step adds on ranks 1–3.
4. Times: each kernel (CUDA events, with the card kept busy while the
   host enqueues, so they time the kernels) beside its bound and its
   plain version's time; the half-steps also at Run B's 4096² f64, B3 at
   Run B's (64, 262144); B3 and B4 (L and Lᵀ) at 8192², (8192, 16) and
   (8192, 1) in each dtype beside one ``torch.matmul`` against the dense
   D̃, L or Lᵀ (the library yardstick) and the ``cumsum`` backend, and at
   p = 2 on (8192, 1), B4 on 300 000 rows; B5–B7 in f64 at Runs C and D's
   shapes (B5 also at E's), with L2 warm and flushed; every kernel at Runs
   F and G's batched shapes beside one lane alone.
5. The ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20240413
HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # outside tensor cores
N_BIG = 8192
N_LR = 1_000_000          # the factored plan's main path: 10⁶-point clouds
C_LR, R_LR = 5, 16        # exact sqeuclidean factors of 3-D points, rank 16
N_RAGGED = 999_983        # a prime: no multiple of any block's rows
N_RUN_B = 4096            # Run B's Grid2D(64): a 4096² cost


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device and build
# ---------------------------------------------------------------------------

def device_line(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return smi[0]


def build_kernels(build) -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    say(f"build: {len(libs)} libraries from {build.CSRC.relative_to(ROOT)} "
        f"for sm_90a in {time.perf_counter() - t0:.1f} s "
        f"({build.build_dir().relative_to(ROOT)})")
    for stem in libs:
        log = build.build_dir() / f"{stem}.log"
        regs = build.kernel_registers(log.read_text() if log.is_file()
                                      else "")
        say(f"  {stem}: max {max((r for _, r, _ in regs), default='n/a')} "
            f"registers a thread, {sum(b for _, _, b in regs)} spill bytes "
            f"over all instantiations; " + ", ".join(
                f"{k} {r}" + (f" (spills {b} B)" if b else "")
                for k, r, b in regs))


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

SLEEP_CYCLES = 20_000_000   # ~10 ms of the card at 1.98 GHz


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Device time a call: the card sleeps while the host enqueues the
    reps, so the events time the kernels and not the host's issue of them
    (a B5 launch at 10⁵ rows is shorter than its wrapper's host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def ulp_of(torch, x):
    """The unit in the last place of x > 0 in x's dtype."""
    return torch.nextafter(x, torch.full_like(x, math.inf)) - x


def half_step_cases(torch):
    """(M, N, dual dtype, cost dtype, tag) of the half-steps on the main
    path: Run A's 8192² in f32, f64 and bf16 C, and Run B's 4096² f64."""
    return ((N_BIG, N_BIG, torch.float32, torch.float32, "f32"),
            (N_BIG, N_BIG, torch.float64, torch.float64, "f64"),
            (N_BIG, N_BIG, torch.float32, torch.bfloat16, "bf16-C/f32"),
            (N_RUN_B, N_RUN_B, torch.float64, torch.float64, "f64"))


def sinkhorn_case(torch, ops, sk, kind, cost, vec, logw, eps, tol_ulp,
                  label, results, why="the kernel sums the exponentials a "
                  "register tile at a time (pairwise, rescaled once a tile) "
                  "and merges lane, warp and split partials in a fixed tree: "
                  "another association than the plain two-pass logsumexp "
                  "(ROADMAP's bar)"):
    """One half-step kernel against its plain version.  Differences are
    counted in ulps of the operand scale ε·max(|log w|, |lse|) of the final
    subtraction f = ε(log w − lse): the scale its rounding is set by.  With
    several lanes the line also gives, per lane, that figure and the
    difference in units of ε·ulp(log w − lse), the rounding of the last
    operation before the multiply by ε."""
    fn = ops.sinkhorn_row_update_batched if kind == "row" else \
        ops.sinkhorn_col_update_batched
    plain = sk.row_update_plain if kind == "row" else sk.col_update_plain
    before = dict(ops.LAUNCHES)
    got = fn(cost, vec, logw, eps)
    torch.cuda.synchronize()
    check(ops.LAUNCHES == {**before, f"sinkhorn_{kind}_update":
                           before[f"sinkhorn_{kind}_update"] + 1},
          f"{label}: the wrapper did not launch its kernel")
    e = torch.as_tensor(eps, dtype=vec.dtype, device=vec.device)
    e = e.expand(cost.shape[0]).contiguous()
    want = plain(cost, vec, logw, e)
    check(not bool(torch.isnan(got).any()), f"{label}: NaN in the kernel")
    check(bool(torch.equal(torch.isneginf(got), torch.isneginf(want))),
          f"{label}: −inf pattern differs from the plain version")
    fin = torch.isfinite(want)
    check(bool(torch.equal(fin, torch.isfinite(got))),
          f"{label}: finite pattern differs")
    tiny = torch.finfo(want.dtype).tiny
    zero = torch.zeros_like(want)

    def in_ulps(d, x):       # d / ulp(x) on finite entries, 0 elsewhere
        return torch.where(fin, d / ulp_of(torch, x.abs().clamp_min(tiny)),
                           zero)

    diff = torch.where(fin, got - want, zero).abs()
    lse = torch.where(fin, logw - want / e[:, None], zero)
    per_lane = in_ulps(diff, e[:, None] * torch.maximum(logw.abs(),
                                                         lse.abs())
                       ).amax(dim=1)
    ulps = float(per_lane.max())
    out_ulps = float(in_ulps(diff, want).max())
    max_abs = float(diff.max())
    lanes = ""
    if cost.shape[0] > 1:
        units = in_ulps(diff, logw - lse) / e[:, None]
        lanes = "; per lane (ε, ulps, units of ε·ulp(log w − lse)): " + \
            ", ".join(f"({float(e[b]):g}, {float(per_lane[b]):.2f}, "
                      f"{float(units[b].max()):.2f})"
                      for b in range(cost.shape[0]))
    say(f"  {label}: max |Δ| {max_abs:.3e} = {ulps:.2f} ulp of the operand "
        f"scale ({out_ulps:.2f} ulp of the output); tolerance "
        f"{tol_ulp} ulp: {why}{lanes}")
    check(ulps <= tol_ulp, f"{label}: {ulps:.2f} ulp > {tol_ulp}")
    results[label] = max_abs
    return max_abs


def fgc_apply(ops, fs, kind):
    """(wrapper, plain version, launch counter, matrix) of an FGC apply:
    B3's D̃, B4's L, or B4's Lᵀ (its reversed scan)."""
    if kind == "dtilde":
        return ops.fgc_apply_dtilde, fs.apply_dtilde_plain, \
            "fgc_apply_dtilde", "D̃"
    rev = kind == "lt"
    return (lambda x, p: ops.fgc_apply_l(x, p, reverse=rev),
            lambda x, p: fs.apply_l_plain(x, p, reverse=rev),
            "fgc_apply_l", "Lᵀ" if rev else "L")


def fgc_case(torch, ops, fs, kind, x, p, label, results, plain_device=None,
             lanes=1):
    """One FGC kernel against its plain recursion (run on `plain_device`,
    default x's: the host for a long column, whose row-by-row loop of small
    ops is faster there).  The bound of a recursive sum of N terms: |Δy_i|
    ≤ (p+2)·N·u·(M|x|)_i for each version, M the applied matrix (D̃, L or
    Lᵀ), so the two differ by at most twice that.  ``lanes`` > 1 folds that
    many problems into B3's columns (its batched plan); the plain
    recursion is column-wise, so it is the same function."""
    fn, plain, name, mat = fgc_apply(ops, fs, kind)
    before = ops.LAUNCHES[name]
    got = fn(x, p) if lanes == 1 else fn(x, p, lanes)
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] == before + 1,
          f"{label}: the wrapper did not launch its kernel")
    xp = x if plain_device is None else x.to(plain_device)
    want = plain(xp, p).to(x.device)
    scale = plain(xp.abs().double(), p).to(x.device)
    n = x.shape[0]
    u = torch.finfo(x.dtype).eps / 2
    ratio = float(((got - want).abs().double()
                   / (n * u * scale).clamp_min(1e-300)).max())
    max_abs = float((got - want).abs().max())
    tol = 2 * (p + 2)
    say(f"  {label}: max |Δ| {max_abs:.3e}; max |Δ| / (N·u·({mat}|x|)) = "
        f"{ratio:.3f}, tolerance {tol} (twice the recursive-sum bound)")
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(ratio <= tol, f"{label}: {ratio:.3f} > {tol}")
    results[label] = max_abs
    return max_abs


def phase_kernels(torch, ops, sk, fs, gen):
    say("phase 2: kernels against their plain versions on the card")
    dev = "cuda"
    errs = {}
    eps = 2e-3
    # Run A's 8192² in each dtype, Run B's 4096² f64, and rows that are not
    # 16-byte aligned (N = 8191: the scalar-load instantiation)
    for m, n, dt, cdt, tag in half_step_cases(torch) + (
            (N_BIG, N_BIG - 1, torch.float32, torch.float32, "f32"),
            (N_BIG, N_BIG - 1, torch.float32, torch.bfloat16, "bf16-C/f32")):
        cost = torch.rand((1, m, n), generator=gen, device=dev,
                          dtype=dt).to(cdt)
        g = torch.randn((1, n), generator=gen, device=dev, dtype=dt)
        f = torch.randn((1, m), generator=gen, device=dev, dtype=dt)
        log_mu = torch.full((1, m), -math.log(m), device=dev, dtype=dt)
        log_nu = torch.full((1, n), -math.log(n), device=dev, dtype=dt)
        sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, eps, 1,
                      f"B1 row {tag} C{m}x{n}", errs)
        sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, eps, 1,
                      f"B2 col {tag} C{m}x{n}", errs)
        del cost
    # zero mass: −inf potentials on a leading block wider than any tile,
    # −inf log-mass on some output rows/columns
    dt = torch.float64
    mz, nz = 1000, 1300
    cost = torch.rand((1, mz, nz), generator=gen, device=dev, dtype=dt)
    g = torch.randn((1, nz), generator=gen, device=dev, dtype=dt)
    g[:, :300] = -math.inf
    f = torch.randn((1, mz), generator=gen, device=dev, dtype=dt)
    f[:, :300] = -math.inf
    log_mu = torch.full((1, mz), -math.log(mz), device=dev, dtype=dt)
    log_mu[:, ::7] = -math.inf
    log_nu = torch.full((1, nz), -math.log(nz), device=dev, dtype=dt)
    log_nu[:, ::5] = -math.inf
    sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, 0.01, 1,
                  "B1 row zero-mass f64", errs)
    sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, 0.01, 1,
                  "B2 col zero-mass f64", errs)
    # four lanes, four ε
    lanes = 4
    epss = torch.tensor([0.05, 0.01, 0.004, 0.002], device=dev, dtype=dt)
    cost = torch.rand((lanes, 1024, 1536), generator=gen, device=dev,
                      dtype=dt)
    g = torch.randn((lanes, 1536), generator=gen, device=dev, dtype=dt)
    f = torch.randn((lanes, 1024), generator=gen, device=dev, dtype=dt)
    log_mu = torch.full((lanes, 1024), -math.log(1024), device=dev,
                        dtype=dt)
    log_nu = torch.full((lanes, 1536), -math.log(1536), device=dev,
                        dtype=dt)
    four = ("the sum's order moves lse by one ulp, which ε = 0.05 maps to "
            "up to two of the ε-scaled operand (ROADMAP §C)")
    sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, epss, 2,
                  "B1 row 4 lanes/4 eps f64", errs, four)
    sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, epss, 2,
                  "B2 col 4 lanes/4 eps f64", errs, four)
    del cost
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for cols in (N_BIG, 1):
            x = torch.randn((N_BIG, cols), generator=gen, device=dev,
                            dtype=dt)
            for p in (1, 2):
                fgc_case(torch, ops, fs, "dtilde", x, p,
                         f"B3 dtilde {tag} x{N_BIG}x{cols} p={p}", errs)
                fgc_case(torch, ops, fs, "l", x, p,
                         f"B4 L {tag} x{N_BIG}x{cols} p={p}", errs)
                fgc_case(torch, ops, fs, "lt", x, p,
                         f"B4 LT {tag} x{N_BIG}x{cols} p={p}", errs)
    # B3 at Run E's D_X Q apply (8192, 16) and at Run B's (64, 262144), f64;
    # B4 at the first
    for rows, cols in ((N_BIG, 16), (64, 64 * N_RUN_B)):
        x = torch.randn((rows, cols), generator=gen, device=dev,
                        dtype=torch.float64)
        for p in (1, 2):
            fgc_case(torch, ops, fs, "dtilde", x, p,
                     f"B3 dtilde f64 x{rows}x{cols} p={p}", errs)
            if rows == N_BIG:
                fgc_case(torch, ops, fs, "l", x, p,
                         f"B4 L f64 x{rows}x{cols} p={p}", errs)
                fgc_case(torch, ops, fs, "lt", x, p,
                         f"B4 LT f64 x{rows}x{cols} p={p}", errs)
    # The scan sums in a fixed order: two launches on one input give equal
    # bits, and so does an x one element off a 16-byte boundary
    for rows, cols, dt in ((N_BIG, N_BIG, torch.float32),
                           (N_BIG, 16, torch.float64),
                           (N_BIG, 1, torch.float64),
                           (64, 64 * N_RUN_B, torch.float64)):
        x = torch.randn((rows, cols), generator=gen, device=dev, dtype=dt)
        shifted = torch.empty(x.numel() + 1, device=dev, dtype=dt)[1:]
        shifted = shifted.view(x.shape)
        shifted.copy_(x)
        for kind, label in (("dtilde", "B3 dtilde"), ("l", "B4 L"),
                            ("lt", "B4 LT")):
            fn = fgc_apply(ops, fs, kind)[0]
            first = fn(x, 1)
            same = torch.equal(first, fn(x, 1))
            offset = torch.equal(first, fn(shifted, 1))
            say(f"  {label} {str(dt)[6:]} x{rows}x{cols} p=1: two launches "
                f"give {'equal' if same else 'DIFFERENT'} bits; an offset "
                f"view gives {'the' if offset else 'OTHER'} bits of the "
                f"aligned x")
            check(same, f"{label} x{rows}x{cols}: two launches differ")
            check(offset, f"{label} x{rows}x{cols}: an offset view differs")
    # B4 on 300 000 rows of one column: over a thousand segments, each carry
    # lane folding its segments in more than one batch (inputs from a
    # generator of their own, so the draws above and after stay put)
    side = torch.Generator(device=dev)
    side.manual_seed(SEED + 18)
    x = torch.randn((300_000, 1), generator=side, device=dev,
                    dtype=torch.float64)
    for p in (1, 2):
        for kind, label in (("l", "B4 L"), ("lt", "B4 LT")):
            fgc_case(torch, ops, fs, kind, x, p,
                     f"{label} f64 x300000x1 p={p}", errs,
                     plain_device="cpu")
    return errs


def ulps_over(torch, diff, scale):
    """max diff / ulp(scale), 0 when empty."""
    if not diff.numel():
        return 0.0
    tiny = torch.finfo(scale.dtype).tiny
    return float((diff / ulp_of(torch, scale.clamp_min(tiny))).max())


def tied_to_f64(torch, got, want, want64, mask=None):
    """The f32 rule (Run A's): the kernel's distance from the plain version
    run in f64 on the same inputs is at most 4× the plain f32 version's
    own, or 4 ulps of the output's largest magnitude where the plain f32
    version happens to be closer.  Returns (kernel's, plain's, limit)."""
    if mask is not None:
        got, want, want64 = got[mask], want[mask], want64[mask]
    if not want64.numel():
        return 0.0, 0.0, 0.0
    ek = float((got.double() - want64).abs().max())
    ep = float((want.double() - want64).abs().max())
    u = torch.finfo(got.dtype).eps / 2
    return ek, ep, max(4 * ep, 4 * u * float(want64.abs().max()))


def dykstra_case(torch, ops, lr, lk, gcol, logw, label, results):
    """B5 against its plain version.  f64: f in ulps of max(1, |log w|,
    |f|) (lse = log w − f), tolerance 2r + 4: the r-lane sum is taken in
    another order (each version's log-sum within r·u of the exact one) and
    m + log s and log w − lse round once each; col in ulps of
    max(1, |col|), tolerance 2(N + r) + 4: the N-row sum in another order,
    at f that already differ by the row bound.  f32: both outputs by
    `tied_to_f64` (the linear bounds pass anything at N = 10⁶ in f32)."""
    before = ops.LAUNCHES["lr_dykstra_half"]
    f, col = ops.lr_dykstra_half_batched(lk, gcol, logw)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["lr_dykstra_half"] == before + 1,
          f"{label}: the wrapper did not launch its kernel")
    wf, wcol = lr.dykstra_half_plain(lk, gcol, logw)
    for got, want, what in ((f, wf, "f"), (col, wcol, "col")):
        check(not bool(torch.isnan(got).any()), f"{label}: NaN in {what}")
        check(bool(torch.equal(torch.isneginf(got), torch.isneginf(want))),
              f"{label}: −inf pattern of {what} differs")
    n, r = lk.shape[1], lk.shape[2]
    fin = torch.isfinite(wf)
    cfin = torch.isfinite(wcol)
    max_abs = max(float((f - wf).abs()[fin].max()) if fin.any() else 0.0,
                  float((col - wcol).abs()[cfin].max()) if cfin.any()
                  else 0.0)
    if gcol.dtype == torch.float32:
        w64 = lr.dykstra_half_plain(lk, gcol.double(), logw.double())
        parts = []
        for name, got, want, want64, m in (("f", f, wf, w64[0], fin),
                                           ("col", col, wcol, w64[1], cfin)):
            ek, ep, lim = tied_to_f64(torch, got, want, want64, m)
            parts.append(f"{name} {ek:.3e} (plain f32 {ep:.3e}, limit "
                         f"{lim:.3e})")
            check(ek <= lim, f"{label}: {name} {ek:.3e} from the f64 "
                  f"plain version > {lim:.3e}")
        say(f"  {label}: max |kernel − plain in f64|: {', '.join(parts)}; "
            f"the f32 rule: 4× the plain f32's own distance; max |Δ| "
            f"kernel − plain {max_abs:.3e}")
        results[label] = max_abs
        return
    one = torch.ones_like(wf)
    sf = torch.maximum(torch.maximum(logw.abs(), wf.abs()), one)[fin]
    uf = ulps_over(torch, (f - wf).abs()[fin], sf)
    uc = ulps_over(torch, (col - wcol).abs()[cfin],
                   torch.maximum(wcol.abs(), torch.ones_like(wcol))[cfin])
    tf, tc = 2 * r + 4, 2 * (n + r) + 4
    say(f"  {label}: f {uf:.2f} ulp of max(1, |log w|, |f|) (tolerance "
        f"{tf}: the {r}-lane sum in another order), col {uc:.2f} ulp of "
        f"max(1, |col|) (tolerance {tc}: the {n}-row sum in another "
        f"order); max |Δ| {max_abs:.3e}")
    check(uf <= tf and uc <= tc, f"{label}: beyond tolerance")
    results[label] = max_abs


def gram_case(torch, ops, lr, a, b, q, w, label, results):
    """B6 against its plain version.  f64: each output in ulps of the same
    function on |A|, |B|, |Q|, |w|, tolerance 4(N + c): each version's
    N-long (and c-long) dot products are within (N + c)·u of exact, in any
    order.  f32: by `tied_to_f64` (that bound passes anything at N = 10⁶
    in f32)."""
    before = ops.LAUNCHES["lr_gram_chain"]
    got = ops.lr_gram_chain_batched(a, b, q, w)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["lr_gram_chain"] == before + 1,
          f"{label}: the wrapper did not launch its kernel")
    want = lr.gram_chain_plain(a, b, q, w)
    n, c = a.shape[1], a.shape[2]
    f32 = q.dtype == torch.float32
    if f32:
        ref = lr.gram_chain_plain(a.double(), b.double(), q.double(),
                                  w.double())
    else:
        ref = lr.gram_chain_plain(a.abs(), b.abs(), q.abs(), w.abs())
    tol = 4 * (n + c)
    parts = []
    max_abs = 0.0
    for name, x, y, sc in zip(("bq", "gram", "sq", "tq"), got, want, ref):
        check(bool(torch.isfinite(x).all()), f"{label}: non-finite {name}")
        max_abs = max(max_abs, float((x - y).abs().max()))
        if f32:
            ek, ep, lim = tied_to_f64(torch, x, y, sc)
            parts.append(f"{name} {ek:.3e} (plain f32 {ep:.3e}, limit "
                         f"{lim:.3e})")
            check(ek <= lim, f"{label}: {name} {ek:.3e} from the f64 "
                  f"plain version > {lim:.3e}")
        else:
            ul = ulps_over(torch, (x - y).abs(), sc)
            parts.append(f"{name} {ul:.2f}")
            check(ul <= tol, f"{label}: {name} {ul:.2f} ulp > {tol}")
    if f32:
        say(f"  {label}: max |kernel − plain in f64|: {', '.join(parts)}; "
            f"the f32 rule: 4× the plain f32's own distance; max |Δ| "
            f"kernel − plain {max_abs:.3e}")
    else:
        say(f"  {label}: ulps of the |·| chain: {', '.join(parts)} "
            f"(tolerance {tol}: dots over N = {n} rows in another order); "
            f"max |Δ| {max_abs:.3e}")
    results[label] = max_abs


def combine_case(torch, ops, lr, a, wm, d2, s_, t_, iq, label, results):
    """B7 against its plain version, in ulps of
    (2(|d2||s| + |t|) + 4|A||W|)|iq|; tolerance 2(c + 3): only the c-long
    dot is summed otherwise, and the tail rounds alike."""
    before = ops.LAUNCHES["lr_grad_combine"]
    got = ops.lr_grad_combine_batched(a, wm, d2, s_, t_, iq)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["lr_grad_combine"] == before + 1,
          f"{label}: the wrapper did not launch its kernel")
    want = lr.grad_combine_plain(a, wm, d2, s_, t_, iq)
    scale = (2 * (d2.abs()[:, :, None] * s_.abs()[:, None, :]
                  + t_.abs()[:, None, :])
             + 4 * a.abs() @ wm.abs()) * iq.abs()[:, None, :]
    ul = ulps_over(torch, (got - want).abs(), scale)
    tol = 2 * (a.shape[2] + 3)
    max_abs = float((got - want).abs().max())
    say(f"  {label}: {ul:.2f} ulp of the operand scale (tolerance {tol}: "
        f"the {a.shape[2]}-long dot in another order); max |Δ| "
        f"{max_abs:.3e}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(ul <= tol, f"{label}: {ul:.2f} ulp > {tol}")
    results[label] = max_abs


def lr_inputs(torch, gen, n, c, r, dt):
    dev = "cuda"
    a = torch.randn((1, n, c), generator=gen, device=dev, dtype=dt)
    b = torch.randn((1, n, c), generator=gen, device=dev, dtype=dt)
    q = torch.rand((1, n, r), generator=gen, device=dev, dtype=dt) / n
    w = torch.rand((1, n), generator=gen, device=dev, dtype=dt)
    return a, b, q, w


def combine_inputs(torch, gen, c, r, dt):
    """B7's small operands: W (1, c, r), s, t, iq (1, r)."""
    wm = torch.randn((1, c, r), generator=gen, device="cuda", dtype=dt)
    s_, t_, iq = (torch.randn((1, r), generator=gen, device="cuda",
                              dtype=dt) for _ in range(3))
    return wm, s_, t_, iq


def phase_lowrank_kernels(torch, ops, lr, gen):
    say("  factored-plan kernels (B5–B7):")
    dev = "cuda"
    errs = {}
    for n, r, dt, tag in ((N_LR, R_LR, torch.float32, "f32"),
                          (N_LR, R_LR, torch.float64, "f64"),
                          (N_LR, 64, torch.float64, "f64"),
                          (N_RAGGED, R_LR, torch.float64, "f64")):
        shape = f"N{n} c{C_LR} r{r} {tag}"
        lk = torch.randn((1, n, r), generator=gen, device=dev, dtype=dt)
        gcol = torch.randn((1, r), generator=gen, device=dev, dtype=dt)
        logw = torch.full((1, n), -math.log(n), device=dev, dtype=dt)
        dykstra_case(torch, ops, lr, lk, gcol, logw, f"B5 {shape}", errs)
        if dt == torch.float32:
            dykstra_case(torch, ops, lr, lk.to(torch.bfloat16), gcol, logw,
                         f"B5 N{n} r{r} bf16-lk/f32", errs)
        del lk
        a, b, q, w = lr_inputs(torch, gen, n, C_LR, r, dt)
        gram_case(torch, ops, lr, a, b, q, w, f"B6 {shape}", errs)
        wm, s_, t_, iq = combine_inputs(torch, gen, C_LR, r, dt)
        combine_case(torch, ops, lr, a, wm, w, s_, t_, iq, f"B7 {shape}",
                     errs)
        del a, b, q, w
    # Runs D and E's shapes: 10⁵ rows at the ranks Run D grows through,
    # and Run E's 8192 rows at rank 16, in f64 (B6/B7 at D's: E is a grid)
    for n, r in ((100_000, 8), (100_000, 16), (100_000, 32), (N_BIG, 16)):
        lk = torch.randn((1, n, r), generator=gen, device=dev,
                         dtype=torch.float64)
        gcol = torch.randn((1, r), generator=gen, device=dev,
                           dtype=torch.float64)
        logw = torch.full((1, n), -math.log(n), device=dev,
                          dtype=torch.float64)
        dykstra_case(torch, ops, lr, lk, gcol, logw, f"B5 N{n} r{r} f64",
                     errs)
        if n == N_BIG:
            continue
        a, b, q, w = lr_inputs(torch, gen, n, C_LR, r, torch.float64)
        gram_case(torch, ops, lr, a, b, q, w, f"B6 N{n} c{C_LR} r{r} f64",
                  errs)
        wm, s_, t_, iq = combine_inputs(torch, gen, C_LR, r, torch.float64)
        combine_case(torch, ops, lr, a, wm, w, s_, t_, iq,
                     f"B7 N{n} c{C_LR} r{r} f64", errs)
    # B6 on the exact squared-Euclidean factors of 3-D Gaussian points
    # shifted by +5 (not centred): the Gram's c-long dot cancels, where the
    # one-pass association differs most from the plain version's
    for dt in (torch.float32, torch.float64):
        x = torch.randn((1, N_LR, 3), generator=gen, device=dev,
                        dtype=torch.float64) + 5.0
        sq = (x ** 2).sum(-1, keepdim=True)
        one = torch.ones_like(sq)
        a = torch.cat([sq, one, -2 * x], -1).to(dt)
        b = torch.cat([one, sq, x], -1).to(dt)
        q = torch.rand((1, N_LR, R_LR), generator=gen, device=dev,
                       dtype=dt) / N_LR
        w = torch.rand((1, N_LR), generator=gen, device=dev, dtype=dt)
        gram_case(torch, ops, lr, a, b, q, w, f"B6 N{N_LR} c{C_LR} r{R_LR} "
                  f"{str(dt)[6:]} shifted cloud", errs)
        del x, sq, one, a, b, q, w
    # two launches on the same inputs give the same bits (the blocks'
    # partials merge in a fixed order behind integer tickets)
    for dt in (torch.float32, torch.float64):
        lk = torch.randn((1, N_LR, R_LR), generator=gen, device=dev,
                         dtype=dt)
        gcol = torch.randn((1, R_LR), generator=gen, device=dev, dtype=dt)
        logw = torch.full((1, N_LR), -math.log(N_LR), device=dev, dtype=dt)
        a, b, q, w = lr_inputs(torch, gen, N_LR, C_LR, R_LR, dt)
        wm, s_, t_, iq = combine_inputs(torch, gen, C_LR, R_LR, dt)
        for name, fn in (
                ("B5", lambda: lr.dykstra_half_cuda(lk, gcol, logw)),
                ("B6", lambda: lr.gram_chain_cuda(a, b, q, w)),
                ("B7", lambda: (lr.grad_combine_cuda(a, wm, w, s_, t_,
                                                     iq),))):
            first, second = fn(), fn()
            torch.cuda.synchronize()
            same = all(bool(torch.equal(x, y))
                       for x, y in zip(first, second))
            say(f"  {name} N{N_LR} r{R_LR} {str(dt)[6:]}: two launches "
                f"{'give the same bits' if same else 'DIFFER'}")
            check(same, f"{name}: two launches on the same inputs differ")
        del lk, a, b, q, w
    # zero mass: −inf log-mass and −inf kernel rows, and a column whose
    # kernel entries are all −inf (its column LSE is −inf)
    n, r, dt = N_RAGGED, R_LR, torch.float64
    lk = torch.randn((1, n, r), generator=gen, device=dev, dtype=dt)
    logw = torch.full((1, n), -math.log(n), device=dev, dtype=dt)
    lk[:, ::7] = -math.inf
    logw[:, ::7] = -math.inf
    lk[:, :, 3] = -math.inf
    gcol = torch.randn((1, r), generator=gen, device=dev, dtype=dt)
    dykstra_case(torch, ops, lr, lk, gcol, logw,
                 f"B5 N{n} r{r} zero-mass rows, −inf column f64", errs)
    return errs


# ---------------------------------------------------------------------------
# phase 2, lanes: a lane's bits do not depend on the batch it rides in
# ---------------------------------------------------------------------------

LANES = 16                 # Run F's lanes, and every kernel's lane check
N_F = 2048                 # Run F's bucket: a multiple of size_bucket=64
EPS_CYCLE = (5e-2, 2e-2, 8e-3, 2e-3)   # BENCH_serve.json's eps_cycle
N_G, N_G_MIN, LANES_G = 100_000, 80_000, 4   # Run G: Run D's scale


def ragged_sizes(np, lo, hi, lanes, seed):
    """(lanes, 2) sizes in [lo, hi] from a numpy seed: Runs F and G's
    problems, each side padded to hi."""
    return np.random.default_rng(seed).integers(lo, hi + 1, size=(lanes, 2))


def same_bits(torch, label, batched, singles):
    """Every lane of a batched launch's outputs against the same lane
    launched alone: the same bits (−inf where −inf), tolerance 0."""
    worst, ok = 0.0, True
    for b, single in enumerate(singles):
        for x, y in zip(batched, single):
            if not torch.equal(x[b], y):
                ok = False
                d = (x[b] - y).abs().nan_to_num(nan=math.inf)
                worst = max(worst, float(d.max()))
    say(f"  {label}: {len(singles)} lanes in one launch against each lane "
        f"launched alone: max |Δ| {worst:.3e} (tolerance 0: the same bits; "
        f"each lane takes one lane's plan)")
    check(ok, f"{label}: a lane's bits depend on the batch")
    return worst


def phase_lane_kernels(torch, np, ops, sk, fs, lr):
    """B1, B2, B3, B5, B6, B7 launched once with LANES lanes at Runs F and
    G's shapes (B3's lanes folded into its columns) and once on each lane
    alone, for equal bits; and the batched launch against the kernel's
    plain version on the same zero-mass padded inputs, one ε a lane, at
    the bars of the phase-2 lines above.  Inputs from a generator of their
    own, so every draw of the phases before and after stays put."""
    say("  lanes: each kernel with 16 lanes against each lane alone and "
        "against its plain version")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 19)
    dev, dt = "cuda", torch.float64
    errs = {}
    lanes = range(LANES)
    sizes = ragged_sizes(np, N_F // 2, N_F, LANES, SEED + 19)
    cost = torch.rand((LANES, N_F, N_F), generator=gen, device=dev, dtype=dt)
    g = torch.randn((LANES, N_F), generator=gen, device=dev, dtype=dt)
    f = torch.randn((LANES, N_F), generator=gen, device=dev, dtype=dt)
    log_mu = torch.full((LANES, N_F), -math.log(N_F), device=dev, dtype=dt)
    log_nu = log_mu.clone()
    for b, (m, n) in enumerate(sizes):      # zero-mass padding, as Run F's
        log_mu[b, m:] = log_nu[b, n:] = -math.inf
        f[b, m:] = g[b, n:] = -math.inf
    eps = torch.tensor([EPS_CYCLE[b % 4] for b in lanes], dtype=dt,
                       device=dev)
    cycle = ("the sum's order moves lse by one ulp, which ε = 0.05 maps to "
             "up to two of the ε-scaled operand (ROADMAP §C)")
    for kind, fn, vec, logw in (
            ("B1 row", ops.sinkhorn_row_update_batched, g, log_mu),
            ("B2 col", ops.sinkhorn_col_update_batched, f, log_nu)):
        out = fn(cost, vec, logw, eps)
        errs[f"{kind} lanes"] = same_bits(
            torch, f"{kind} f64 C{LANES}x{N_F}x{N_F}", (out,),
            [(fn(cost[b:b + 1], vec[b:b + 1], logw[b:b + 1],
                 eps[b:b + 1])[0],) for b in lanes])
        sinkhorn_case(torch, ops, sk, kind.split()[1], cost, vec, logw, eps,
                      2, f"{kind} f64 C{LANES}x{N_F}x{N_F} zero-mass padded, "
                      "eps cycle, against plain", errs, cycle)
    del cost
    for cols, p in ((N_F, 1), (1, 2)):      # the plan's apply, the C1 term's
        x = torch.randn((N_F, LANES * cols), generator=gen, device=dev,
                        dtype=dt)
        out = ops.fgc_apply_dtilde(x, p, lanes=LANES)
        per = out.reshape(N_F, LANES, cols).movedim(1, 0)
        errs[f"B3 lanes {cols}"] = same_bits(
            torch, f"B3 dtilde f64 x{N_F}x({LANES}x{cols}) p={p}", (per,),
            [(ops.fgc_apply_dtilde(x[:, b * cols:(b + 1) * cols]
                                   .contiguous(), p),) for b in lanes])
        fgc_case(torch, ops, fs, "dtilde", x, p,
                 f"B3 dtilde f64 x{N_F}x({LANES}x{cols}) p={p} against "
                 "plain", errs, lanes=LANES)
    del x, out, per
    sizes = ragged_sizes(np, N_G_MIN, N_G, LANES, SEED + 20)
    rows = torch.arange(N_G, device=dev)[None, :]
    live = rows < torch.tensor(sizes[:, 0], device=dev)[:, None]
    lk = torch.randn((LANES, N_G, R_LR), generator=gen, device=dev, dtype=dt)
    lk = torch.where(live[:, :, None], lk, -math.inf)
    gcol = torch.randn((LANES, R_LR), generator=gen, device=dev, dtype=dt)
    logw = torch.where(live, -math.log(N_G), -math.inf).to(dt)
    out = ops.lr_dykstra_half_batched(lk, gcol, logw)
    errs["B5 lanes"] = same_bits(
        torch, f"B5 f64 lk{LANES}x{N_G}x{R_LR}", out,
        [tuple(o[0] for o in ops.lr_dykstra_half_batched(
            lk[b:b + 1], gcol[b:b + 1], logw[b:b + 1])) for b in lanes])
    dykstra_case(torch, ops, lr, lk, gcol, logw,
                 f"B5 f64 lk{LANES}x{N_G}x{R_LR} zero-mass padded, against "
                 "plain", errs)
    del lk, out
    z = live[:, :, None].to(dt)
    a = torch.randn((LANES, N_G, C_LR), generator=gen, device=dev,
                    dtype=dt) * z
    bf = torch.randn((LANES, N_G, C_LR), generator=gen, device=dev,
                     dtype=dt) * z
    q = torch.rand((LANES, N_G, R_LR), generator=gen, device=dev,
                   dtype=dt) * z / N_G
    w = torch.rand((LANES, N_G), generator=gen, device=dev, dtype=dt) * z[..., 0]
    out = ops.lr_gram_chain_batched(a, bf, q, w)
    errs["B6 lanes"] = same_bits(
        torch, f"B6 f64 N{N_G} c{C_LR} r{R_LR} x{LANES}", out,
        [tuple(o[0] for o in ops.lr_gram_chain_batched(
            a[b:b + 1], bf[b:b + 1], q[b:b + 1], w[b:b + 1]))
         for b in lanes])
    gram_case(torch, ops, lr, a, bf, q, w,
              f"B6 f64 N{N_G} c{C_LR} r{R_LR} x{LANES} zero rows padded, "
              "against plain", errs)
    wm = torch.randn((LANES, C_LR, R_LR), generator=gen, device=dev,
                     dtype=dt)
    s_, t_, iq = (torch.randn((LANES, R_LR), generator=gen, device=dev,
                              dtype=dt) for _ in range(3))
    out = ops.lr_grad_combine_batched(a, wm, w, s_, t_, iq)
    errs["B7 lanes"] = same_bits(
        torch, f"B7 f64 N{N_G} c{C_LR} r{R_LR} x{LANES}", (out,),
        [(ops.lr_grad_combine_batched(a[b:b + 1], wm[b:b + 1], w[b:b + 1],
                                      s_[b:b + 1], t_[b:b + 1],
                                      iq[b:b + 1])[0],) for b in lanes])
    combine_case(torch, ops, lr, a, wm, w, s_, t_, iq,
                 f"B7 f64 N{N_G} c{C_LR} r{R_LR} x{LANES} zero rows padded, "
                 "against plain", errs)
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def measures(np, n, seed):
    u = np.random.default_rng(seed).random(n) + 0.05
    return u / u.sum()


def run_path(torch, ops, label, fn):
    """Drive one path with the launch counts set to 0 just before it and
    read just after."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    say(f"  {label}: {wall:.3f} s wall, launches {counts}")
    return out, counts, wall


def compare_runs(torch, label, rk, rp, value_rtol, plan_l1_tol):
    for r in (rk, rp):
        check(bool(torch.isfinite(r.plan).all()) and
              bool(torch.isfinite(r.value)), f"{label}: non-finite result")
    rel = abs(float(rk.value) - float(rp.value)) / abs(float(rp.value))
    l1 = float((rk.plan - rp.plan).abs().sum())
    ik, ip = rk.info, rp.info
    say(f"  {label}: value {float(rk.value):.12e} (kernels) vs "
        f"{float(rp.value):.12e} (plain), relative Δ {rel:.3e} "
        f"(tolerance {value_rtol:g}); plan L1 Δ {l1:.3e} (tolerance "
        f"{plan_l1_tol:g}); outer {ik.outer_iters}/{ip.outer_iters}, inner "
        f"{ik.inner_iters}/{ip.inner_iters}, marginal err "
        f"{float(ik.marginal_err):.3e}/{float(ip.marginal_err):.3e}, "
        f"converged {ik.converged}/{ip.converged}")
    check(ik.outer_iters == ip.outer_iters and
          ik.inner_iters == ip.inner_iters,
          f"{label}: iteration counts differ")
    check(rel <= value_rtol, f"{label}: value differs by {rel:.3e}")
    check(l1 <= plan_l1_tol, f"{label}: plan differs by {l1:.3e}")


def phase_main_path(torch, np, ops, core, gen):
    say("phase 3: the main path through repro_torch.core.entropic_gw")
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # the repo's own oracle at a small size: FGC kernels == dense plans
    # (the reference's bar, tests/test_gw_solvers.py: 1e-12 in f64)
    for k in (1, 2):
        n = 50
        grid = core.Grid1D(n, 1 / (n - 1), k)
        mu = measures(np, n, 0)
        nu = measures(np, n, 1)
        base = dict(eps=2e-3, outer_iters=10, sinkhorn_iters=200)
        rk = core.entropic_gw(grid, grid, mu, nu,
                              core.GWConfig(backend="kernel", **base))
        rd = core.entropic_gw(grid, grid, mu, nu,
                              core.GWConfig(backend="dense",
                                            sinkhorn_backend="torch",
                                            **base))
        dplan = float(torch.linalg.norm(rk.plan - rd.plan))
        dval = abs(float(rk.value - rd.value))
        say(f"  oracle Grid1D({n}, k={k}) f64: kernels vs dense "
            f"‖ΔP‖_F {dplan:.3e}, |Δvalue| {dval:.3e} (tolerance 1e-12)")
        check(dplan < 1e-12 and dval < 1e-12, "kernels disagree with the "
              "dense oracle")

    n = N_BIG
    grid = core.Grid1D(n, 1 / (n - 1), 1)
    mu_np, nu_np = measures(np, n, SEED), measures(np, n, SEED + 1)
    paper = dict(eps=2e-3, outer_iters=10, sinkhorn_iters=200, tol=0.0)
    cfg_k = core.GWConfig(backend="kernel", sinkhorn_backend="auto", **paper)
    cfg_p = core.GWConfig(backend="cumsum", sinkhorn_backend="torch", **paper)
    exact = None
    for dt in ("float64", "float32"):
        mu = mu_np.astype(dt)
        nu = nu_np.astype(dt)
        rk, counts, walls[f"A {dt} kernels"] = run_path(
            torch, ops, f"Run A Grid1D({n}) {dt} kernels",
            lambda: core.entropic_gw(grid, grid, mu, nu, cfg_k))
        add(counts)
        for name in ("sinkhorn_row_update", "sinkhorn_col_update",
                     "fgc_apply_dtilde"):
            check(counts[name] > 0, f"Run A {dt}: {name} never launched")
        check(rk.plan.dtype == getattr(torch, dt), "Run A: dtype changed")
        rp, _, walls[f"A {dt} plain"] = run_path(
            torch, ops, f"Run A Grid1D({n}) {dt} plain",
            lambda: core.entropic_gw(grid, grid, mu, nu, cfg_p))
        if dt == "float64":
            # f64: the two paths differ by rounding only
            tols = (1e-8, 1e-6)
            exact = (float(rk.value), rk.plan)
        else:
            # f32: each path rounds the FGC sums and the half-steps in
            # f32; the kernels must agree with the plain path within 4× the
            # plain path's own distance from the f64 solution
            rel32 = abs(float(rp.value) - exact[0]) / abs(exact[0])
            l1_32 = float((rp.plan.double() - exact[1]).abs().sum())
            say(f"  Run A float32 plain vs float64 kernels: relative Δ "
                f"value {rel32:.3e}, plan L1 Δ {l1_32:.3e}")
            tols = (max(1e-4, 4 * rel32), max(1e-3, 4 * l1_32))
        compare_runs(torch, f"Run A {dt}", rk, rp, *tols)
        del rk, rp
        if dt == "float32":
            profile_solve(torch, f"Run A {dt}", lambda: core.entropic_gw(
                grid, grid, mu, nu, cfg_k))
    del exact

    n2 = 64
    grid2 = core.Grid2D(n2, 1 / (n2 - 1), 1)
    mu = measures(np, n2 * n2, SEED + 2)
    nu = measures(np, n2 * n2, SEED + 3)
    adaptive = dict(eps=4e-3, tol=1e-6, eps_init=5e-2, outer_iters=60,
                    sinkhorn_iters=500)
    rk, counts, walls["B float64 kernels"] = run_path(
        torch, ops, f"Run B Grid2D({n2}) float64 kernels",
        lambda: core.entropic_gw(grid2, grid2, mu, nu, core.GWConfig(
            backend="kernel", sinkhorn_backend="auto", **adaptive)))
    add(counts)
    rp, _, walls["B float64 plain"] = run_path(
        torch, ops, f"Run B Grid2D({n2}) float64 plain",
        lambda: core.entropic_gw(grid2, grid2, mu, nu, core.GWConfig(
            backend="cumsum", sinkhorn_backend="torch", **adaptive)))
    compare_runs(torch, "Run B float64", rk, rp, 1e-8, 1e-6)
    del rk, rp
    profile_solve(torch, "Run B float64", lambda: core.entropic_gw(
        grid2, grid2, mu, nu, core.GWConfig(
            backend="kernel", sinkhorn_backend="auto", **adaptive)))

    # the FGC primitives a user calls directly, at the gradient's shape
    x = torch.rand((N_BIG, N_BIG), generator=gen, device="cuda",
                   dtype=torch.float32)

    def fgc_path():
        return (core.fgc.apply_L(x, axis=0, power=1, backend="kernel"),
                core.fgc.apply_LT(x, axis=0, power=1, backend="kernel"))

    (lx, ltx), fgc_counts, _ = run_path(torch, ops,
                                        f"fgc.apply_L/apply_LT x{N_BIG}x"
                                        f"{N_BIG} f32", fgc_path)
    check(fgc_counts["fgc_apply_l"] == 2, "apply_L/apply_LT: fgc_apply_l "
          "not launched twice")
    check(bool(torch.isfinite(lx).all() and torch.isfinite(ltx).all()),
          "apply_L/apply_LT: non-finite output")
    launches["fgc_apply_l"] += fgc_counts["fgc_apply_l"]
    profile_no_copies(torch, "apply_LT kernel route", lambda: core.fgc.apply_LT(
        x, axis=0, power=1, backend="kernel"))
    return launches, walls


def profile_no_copies(torch, label, fn, calls=4):
    """`calls` more calls under torch.profiler (which loses the first few
    device activities of a window: one call is not enough): their device
    activities must hold B4's scan and no flip or copy kernel (Lᵀ as B4's
    reversed scan, not flip(L flip x)).  Not measured where the profiler
    records no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    if not names:
        say(f"  {label} profiled: not measured (the profiler recorded no "
            f"device events)")
        return
    copies = [n for n in names if "flip" in n.lower() or "copy" in n.lower()]
    kinds = {}
    for n in names:
        kinds[kernel_label(n)] = kinds.get(kernel_label(n), 0) + 1
    say(f"  {label} profiled over {calls} calls: {len(names)} device "
        f"activities ({'; '.join(f'{c}× {k}' for k, c in kinds.items())}); "
        f"flip or copy kernels: {len(copies)}")
    check(any("scan_pass" in n for n in names),
          f"{label}: B4's scan is not in the trace")
    check(not copies, f"{label}: launched {sorted(set(copies))}")


def compare_lowrank(torch, label, rk, rp, value_rtol, l1_tol):
    """Kernels against the plain path on a factored solve: equal counts and
    final rank, relative value Δ and the factors' L1 Δ (the solver's own
    movement metric) within their limits; ``l1_tol=None`` prints the L1 Δ
    and leaves its check to `lockstep`."""
    ck, cp = rk.coupling, rp.coupling
    for c in (ck, cp):
        check(all(bool(torch.isfinite(x).all()) for x in (c.q, c.r, c.g)),
              f"{label}: non-finite factors")
    check(bool(torch.isfinite(rk.value)) and bool(torch.isfinite(rp.value)),
          f"{label}: non-finite value")
    rel = abs(float(rk.value) - float(rp.value)) / abs(float(rp.value))
    check(ck.rank == cp.rank, f"{label}: final ranks differ")
    l1 = float(ck.delta(cp))
    ik, ip = rk.info, rp.info
    l1_lim = "checked step by step below" if l1_tol is None else \
        f"tolerance {l1_tol:g}"
    say(f"  {label}: value {float(rk.value):.12e} (kernels) vs "
        f"{float(rp.value):.12e} (plain), relative Δ {rel:.3e} (tolerance "
        f"{value_rtol:g}); factors L1 Δ {l1:.3e} ({l1_lim}); "
        f"rank {ck.rank}/{cp.rank}, outer {ik.outer_iters}/"
        f"{ip.outer_iters}, inner {ik.inner_iters}/{ip.inner_iters}, "
        f"marginal err {float(ik.marginal_err):.3e}/"
        f"{float(ip.marginal_err):.3e}, converged {ik.converged}/"
        f"{ip.converged}")
    check(ik.outer_iters == ip.outer_iters and
          ik.inner_iters == ip.inner_iters, f"{label}: counts differ")
    check(rel <= value_rtol, f"{label}: value differs by {rel:.3e}")
    check(l1_tol is None or l1 <= l1_tol,
          f"{label}: factors differ by {l1:.3e}")


def profile_solve(torch, label, fn, watch=()):
    """One more solve under torch.profiler (CPU and CUDA activities): the
    device's busy share over the solve's window (the union of the device
    activities' intervals over the span of all the trace's events) and the
    device time of the top kernels by name, and of every kernel whose name
    holds one of `watch`.  The profiler slows the host, so the share is a
    lower bound of the unprofiled run's.  Returns {name: (device µs,
    count)}, or None when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type.name == "CUDA"]
    if not dev:
        say(f"  {label} profiled: device busy share not measured (the "
            f"profiler recorded no device events); kernel sums by CUDA "
            f"events in phase 4")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    say(f"  {label} profiled: device busy {busy / 1e3:.3f} ms of a "
        f"{(hi - lo) / 1e3:.3f} ms window, busy share {busy / (hi - lo):.1%}"
        f" ({len(dev)} device activities)")
    rows = {}
    for e in dev:
        key = kernel_label(e.name)
        t, c = rows.get(key, (0.0, 0))
        rows[key] = (t + e.time_range.end - e.time_range.start, c + 1)
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    for i, (name, (t, c)) in enumerate(ranked):
        if i < 12 or any(w in name for w in watch):
            say(f"    {t / 1e3:9.3f} ms device, {c:5d}×, {name}")
    return rows


def kernel_label(name: str) -> str:
    """A device activity's name, cut to 90 characters; a longer PyTorch
    kernel keeps its operation's names (copy, add, exp, ...), which its
    template arguments bury past the cut."""
    if len(name) <= 90:
        return name
    ops = dict.fromkeys(re.findall(
        r"\w+_kernel_cuda|\w*Functor\w*|\w+_functor|\w+Ops?<\w+", name))
    return name[:60] + "... " + ",".join(list(ops)[:3])


def up(core, c):
    """A factored coupling in float64."""
    return core.LowRankCoupling(c.q.double(), c.r.double(), c.g.double())


def lockstep(torch, core, cfg, gx, gy, mu, label, one_step=False):
    """Run C's kernel and plain solves side by side, one outer step at a
    time through `mirror_descent_segment` (the loop `entropic_gw` runs, so
    each trajectory is the entry point's), printing the factors' L1
    distance between the two after each step.  Without ``one_step`` (f64)
    that distance must end within the f64 limit, 1e-6.

    With ``one_step`` (f32), also the check of each step on its own: from
    the plain trajectory's state before the step, one step by each route
    in f32 and one plain step in f64 on the same inputs widened, all at
    the step's ε and a fixed sweep count (inner tol 0), so that they
    differ by rounding alone.  The kernel step must lie within 4× the
    plain f32 step's distance from the f64 step (Run A's rule), and the
    kernels' energy (B6) of the final state within 4× the plain f32
    energy's distance from the f64 one."""
    ctl = core.resolve_controls(cfg, None, mu.device)

    def route(gx, gy, mu, backend):
        op = core.LowRankGradientOperator(gx, gy, cfg.backend, cfg.cost_rank,
                                          backend)
        dx2, dy2 = op.constant_term(mu, mu)
        return op, core.gw_lr_step_fn(
            op, dx2, dy2, mu, mu,
            dataclasses.replace(cfg, lowrank_backend=backend), ctl.lr_gamma)

    op_k, step_k = route(gx, gy, mu, "auto")
    op_p, step_p = route(gx, gy, mu, "torch")
    if one_step:
        op_64, step_64 = route(
            core.PointCloudGeometry(gx.points.double()),
            core.PointCloudGeometry(gy.points.double()), mu.double(),
            "torch")
    state0 = core.lowrank_init(mu, mu, cfg.plan_rank,
                               method=cfg.lowrank_init, geom_x=op_p.geom_x,
                               geom_y=op_p.geom_y)
    ck = cp = core.init_carry(state0, cfg.outer_iters, mu.device)
    apart, worst = [], 0.0

    def one(step, s, eps):       # the step closures run on lanes: one lane
        return step(type(s).stack([s]),
                    torch.tensor([eps], dtype=torch.float64,
                                 device=mu.device), 0.0)[0].lane(0)

    while cp.t < cfg.outer_iters and not (cp.done or ck.done):
        if one_step:
            eps, s = ctl.eps_at(cp.stage), cp.state
            nk, npl = one(step_k, s, eps), one(step_p, s, eps)
            n64 = one(step_64, up(core, s), eps)
            dk = float(up(core, nk).delta(n64))
            dp = float(up(core, npl).delta(n64))
            check(dk <= 4 * dp, f"{label} step {cp.t + 1}: the kernel step "
                  f"is {dk:.3e} from the f64 step, the plain f32 step "
                  f"{dp:.3e}")
            worst = max(worst, dk / dp if dp else 0.0)
            del nk, npl, n64
        ck = core.mirror_descent_segment(step_k, core.coupling_delta, ctl,
                                         cfg.outer_iters, ck, 1)
        cp = core.mirror_descent_segment(step_p, core.coupling_delta, ctl,
                                         cfg.outer_iters, cp, 1)
        apart.append(float(ck.state.delta(cp.state)))
    n = len(apart)
    marks = sorted({1, 2, 4, 8, 16, 24, 32, n} & set(range(1, n + 1)))
    rate = (apart[-1] / apart[n // 4]) ** (1 / (n - 1 - n // 4)) \
        if n > 4 and apart[n // 4] > 0 else float("nan")
    say(f"  {label} kernels vs plain, step by step: factors L1 Δ after step "
        + ", ".join(f"{k}: {apart[k - 1]:.2e}" for k in marks)
        + f"; growth ×{rate:.3f} a step from step {n // 4 + 1} on")
    if not one_step:
        check(apart[-1] <= 1e-6, f"{label}: kernels and plain parted by "
              f"{apart[-1]:.3e} after {n} steps (limit 1e-6)")
    if one_step:
        s = cp.state
        e64 = float(op_64.energy(up(core, s)))
        ek, ep = (abs(float(op.energy(s)) - e64) for op in (op_k, op_p))
        lim = max(4 * ep, 2 * torch.finfo(s.q.dtype).eps * abs(e64))
        say(f"  {label} one step at a time from the plain trajectory: the "
            f"kernel step's L1 distance from the f64 step is at most "
            f"{worst:.2f}× the plain f32 step's (limit 4, {n} steps); final "
            f"energy: kernels {ek:.3e}, plain f32 {ep:.3e} from the f64 "
            f"energy (limit {lim:.3e})")
        check(ek <= lim, f"{label}: kernel energy {ek:.3e} from f64 > "
              f"{lim:.3e}")
    return apart


def check_lr_launches(label, counts, info, factor_pairs: bool):
    """The factored solve's launches, from the code: two B5 per Dykstra
    sweep; on factor pairs two B6 and two B7 per gradient and two B6 for
    the final energy."""
    want = {"lr_dykstra_half": 2 * info.inner_iters,
            "lr_gram_chain": (2 * info.outer_iters + 2) if factor_pairs
            else 0,
            "lr_grad_combine": 2 * info.outer_iters if factor_pairs else 0}
    got = {k: counts[k] for k in want}
    say(f"  {label}: launches {got}, expected {want}")
    check(got == want, f"{label}: launch counts differ from the code's")


def cloud(torch, np, n, seed, dt):
    """n points in 3-D from a numpy seed, on the card."""
    from repro_torch import core
    pts = np.random.default_rng(seed).normal(size=(n, 3))
    return core.PointCloudGeometry(torch.tensor(pts, dtype=dt,
                                                device="cuda"))


LR_CONTROLS = dict(eps=5e-2, outer_iters=40, sinkhorn_iters=50, tol=1e-6,
                   eps_init=0.5, anneal_decay=0.7, plan="lowrank",
                   lr_gamma=30.0)     # examples/lowrank_gw.py's settings


def phase_lowrank_path(torch, np, ops, core):
    """Runs C, D, E: the factored plan through entropic_gw, kernels
    (lowrank_backend="auto") against the plain path ("torch")."""
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    exact = None
    for dt in (torch.float64, torch.float32):
        tag = str(dt).split(".")[-1]
        gx, gy = cloud(torch, np, N_LR, SEED + 4, dt), \
            cloud(torch, np, N_LR, SEED + 5, dt)
        mu = torch.full((N_LR,), 1.0 / N_LR, dtype=dt, device="cuda")
        cfg = core.GWConfig(plan_rank=R_LR, **LR_CONTROLS)
        torch.cuda.reset_peak_memory_stats()
        rk, counts, walls[f"C {tag} kernels"] = run_path(
            torch, ops, f"Run C clouds {N_LR}x3 rank {R_LR} {tag} kernels",
            lambda: core.entropic_gw(gx, gy, mu, mu, cfg))
        say(f"  Run C {tag} kernels: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        add(counts)
        check_lr_launches(f"Run C {tag}", counts, rk.info, True)
        check(rk.coupling.q.dtype == dt, "Run C: dtype changed")
        if dt == torch.float64:
            before = ops.LAUNCHES["lr_gram_chain"]
            rows = profile_solve(torch, f"Run C {tag}",
                                 lambda: core.entropic_gw(gx, gy, mu, mu, cfg),
                                 watch=("gram", "combine", "sum_blocks"))
            calls = ops.LAUNCHES["lr_gram_chain"] - before
            if rows is not None:
                b6 = {k: c for k, (_, c) in rows.items()
                      if "gram" in k or "sum_blocks" in k}
                say(f"  Run C {tag} profiled: {calls} B6 calls, device "
                    f"launches {b6}")
                check(sum(b6.values()) == calls and
                      all("gram_chain" in k for k in b6),
                      "Run C: B6 is not one device launch a call")
        rp, _, walls[f"C {tag} plain"] = run_path(
            torch, ops, f"Run C clouds {N_LR}x3 rank {R_LR} {tag} plain",
            lambda: core.entropic_gw(gx, gy, mu, mu, dataclasses.replace(
                cfg, lowrank_backend="torch")))
        if dt == torch.float64:
            tols = (1e-8, 1e-6)        # f64: rounding only
            exact = (float(rk.value), up(core, rk.coupling))
        else:
            # f32 value: within 4× the plain f32 path's own distance from
            # the f64 solution (Run A's rule).  Past the f64 solve's
            # convergence the f32 solves run on (their movement stays above
            # tol) near an unstable point, where any rounding difference
            # grows every step (see the f64 pair below): the factors are
            # held to Run A's rule one step at a time, in `lockstep`
            rel32, l1_32, rel_k, l1_k = (
                x for r in (rp, rk) for x in (
                    abs(float(r.value) - exact[0]) / abs(exact[0]),
                    float(up(core, r.coupling).delta(exact[1]))))
            say(f"  Run C float32 against the float64 solve: plain relative "
                f"Δ value {rel32:.3e}, factors L1 Δ {l1_32:.3e}; kernels "
                f"{rel_k:.3e} and {l1_k:.3e}")
            tols = (max(1e-4, 4 * rel32), None)
        compare_lowrank(torch, f"Run C {tag}", rk, rp, *tols)
        del rk, rp
        # the same solve, kernels and plain side by side: in f64 to 40
        # steps (tol 0: on past its convergence), in f32 with each step
        # checked on its own
        lockstep(torch, core, dataclasses.replace(cfg, tol=0.0) if
                 dt == torch.float64 else cfg, gx, gy, mu,
                 f"Run C {tag}", one_step=dt == torch.float32)
        del gx, gy
    del exact

    # Run D: the rank restarts.  Each attempt gets 6 outer steps, fewer
    # than the 8 the ε-annealing needs, so it ends unconverged with a flat
    # residual and `lowrank_descent` widens the factors (pad_rank), doubles
    # the rank: 8 → 16 → 32, with the counts accumulated
    n_d = 100_000
    gx, gy = cloud(torch, np, n_d, SEED + 6, torch.float64), \
        cloud(torch, np, n_d, SEED + 7, torch.float64)
    mu = torch.full((n_d,), 1.0 / n_d, dtype=torch.float64, device="cuda")
    cfg = core.GWConfig(**dict(LR_CONTROLS, outer_iters=6, plan_rank="auto",
                               plan_rank_max=32))
    rk, counts, walls["D float64 kernels"] = run_path(
        torch, ops, f"Run D clouds {n_d}x3 rank auto float64 kernels",
        lambda: core.entropic_gw(gx, gy, mu, mu, cfg))
    add(counts)
    check_lr_launches("Run D", counts, rk.info, True)
    rp, _, walls["D float64 plain"] = run_path(
        torch, ops, f"Run D clouds {n_d}x3 rank auto float64 plain",
        lambda: core.entropic_gw(gx, gy, mu, mu, dataclasses.replace(
            cfg, lowrank_backend="torch")))
    compare_lowrank(torch, "Run D float64", rk, rp, 1e-8, 1e-6)
    check(rk.coupling.rank > 8 and rk.info.outer_iters > cfg.outer_iters,
          "Run D: the rank never grew")
    del rk, rp, gx, gy

    n_e = N_BIG
    grid = core.Grid1D(n_e, 1 / (n_e - 1), 1)
    mu_e = measures(np, n_e, SEED + 8)
    nu_e = measures(np, n_e, SEED + 9)
    base = dict(LR_CONTROLS, outer_iters=10, tol=0.0, eps_init=None,
                plan_rank=R_LR)
    rk, counts, walls["E float64 kernels"] = run_path(
        torch, ops, f"Run E Grid1D({n_e}) rank {R_LR} float64 kernels",
        lambda: core.entropic_gw(grid, grid, mu_e, nu_e, core.GWConfig(
            backend="kernel", **base)))
    add(counts)
    check_lr_launches("Run E", counts, rk.info, False)
    check(counts["fgc_apply_dtilde"] > 0, "Run E: the factored gradient "
          "did not go through the FGC kernel")
    rp, _, walls["E float64 plain"] = run_path(
        torch, ops, f"Run E Grid1D({n_e}) rank {R_LR} float64 plain",
        lambda: core.entropic_gw(grid, grid, mu_e, nu_e, core.GWConfig(
            backend="cumsum", lowrank_backend="torch", **base)))
    compare_lowrank(torch, "Run E float64", rk, rp, 1e-8, 1e-6)
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, batches: Runs F and G through entropic_gw_batch
# ---------------------------------------------------------------------------

class Recorded:
    """Records what each call of ``mod.name`` returns while in use: the
    inner loops' counts of a batch (`sinkhorn._chunked_loop`), the
    Neumann terms of each lane (`solver.neumann_series`), the stacked
    feature costs of a batch (`gw._stack_features`)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.out = mod, name, []
        self.real = getattr(mod, name)

    def __enter__(self):
        def call(*args, **kw):
            out = self.real(*args, **kw)
            self.out.append(out)
            return out
        setattr(self.mod, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def run_batch(torch, ops, core, label, fn):
    """`run_path` with the batch's inner loops counted."""
    # the most any lane of a loop used: the lanes still running advance
    # together, one launch an update for all of them
    with Recorded(core.sinkhorn, "_chunked_loop") as loops:
        out, counts, wall = run_path(torch, ops, label, fn)
    return out, counts, wall, sum(max(used, default=0)
                                  for _, used in loops.out)


def compacted(core, batch, probs, ctls, outer_cap):
    """A batch solved one outer step a segment through the segmented
    surface, its finished lanes dropped from the batch (and their carries
    from the resume state) after each segment: the lanes still running
    ride on alone.  Returns (each problem's last result, segments)."""
    live, carry, out, n_seg = list(range(len(probs))), None, {}, 0
    while live:
        res, carry = batch([probs[b] for b in live], [ctls[b] for b in live],
                           resume_state=carry, max_outer_segment=1)
        n_seg += 1
        out.update(zip(live, res))
        keep = [i for i in range(len(live))
                if not carry.done[i] and carry.t[i] < outer_cap]
        if len(keep) < len(live):
            carry = core.MirrorCarry.stack([carry.lane(i) for i in keep]) \
                if keep else None
            live = [live[i] for i in keep]
    return [out[b] for b in range(len(probs))], n_seg


def lanes_equal(torch, a, b):
    """Two results of one problem with the same bits and counts."""
    ia, ib = a.info, b.info
    same = (ia.outer_iters, ia.inner_iters, ia.converged) == \
        (ib.outer_iters, ib.inner_iters, ib.converged) and \
        torch.equal(a.value, b.value)
    if a.plan is not None:
        return same and torch.equal(a.plan, b.plan) and \
            torch.equal(a.f, b.f) and torch.equal(a.g, b.g)
    return same and all(torch.equal(x, y) for x, y in zip(
        (a.coupling.q, a.coupling.r, a.coupling.g),
        (b.coupling.q, b.coupling.r, b.coupling.g)))


def check_batch_launches(label, counts, results, sweeps, segments=1,
                         factored=False):
    """A batch launches each kernel once for all lanes: B1/B2 once an
    inner update of the batch (B5 twice a Dykstra sweep), B3 twice a
    gradient plus four a segment (the C1 applies and the energy's product)
    on grids, B6 twice a gradient plus two a segment and B7 twice a
    gradient on factor pairs; the batch runs as many outer steps as its
    longest lane."""
    steps = max(r.info.outer_iters for r in results)
    if factored:
        want = {"lr_dykstra_half": 2 * sweeps,
                "lr_gram_chain": 2 * steps + 2 * segments,
                "lr_grad_combine": 2 * steps}
    else:
        want = {"sinkhorn_row_update": sweeps,
                "sinkhorn_col_update": sweeps,
                "fgc_apply_dtilde": 2 * steps + 4 * segments}
    got = {k: counts[k] for k in want}
    per_lane = sum(r.info.inner_iters for r in results)
    say(f"  {label}: launches {got}, expected {want} (the lanes' own inner "
        f"counts sum to {per_lane}: one launch a lane would be that many)")
    check(got == want, f"{label}: launch counts differ from the code's")
    check(sweeps < per_lane, f"{label}: no fewer launches than lanes' "
          "updates")


def phase_batch_path(torch, np, ops, core):
    """Run F (16 ragged Grid1D lanes at full width, per-lane ε) and Run G
    (4 ragged 10⁵-point cloud lanes, factored plan) through
    `entropic_gw_batch`, each lane against its solo solve."""
    say("phase 3, batches: entropic_gw_batch")
    start = time.perf_counter()
    # the ε schedule runs on the host: how often the card's f64 pow rounds
    # decay^t otherwise than the host's (the schedule's values before)
    off = [(d, t) for d in (0.5, 0.7) for t in range(64)
           if float(torch.tensor(d, dtype=torch.float64, device="cuda")
                    ** torch.tensor(float(t), dtype=torch.float64,
                                    device="cuda")) != d ** float(t)]
    say(f"  ε schedule: the card's f64 pow rounds {len(off)} of 128 powers "
        f"decay^t (decay 0.5, 0.7; t < 64) otherwise than the host's, e.g. "
        f"{off[:3]}; the loop evaluates the schedule on the host")
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    sizes = ragged_sizes(np, N_F // 2, N_F, LANES, SEED + 21)
    probs = [(core.Grid1D(int(m), 1 / (m - 1), 1),
              core.Grid1D(int(n), 1 / (n - 1), 1),
              measures(np, int(m), SEED + 100 + 2 * b),
              measures(np, int(n), SEED + 101 + 2 * b))
             for b, (m, n) in enumerate(sizes)]
    knobs = dict(tol=1e-5, eps_init=5e-2, anneal_decay=0.5)
    ctls = [core.SolveControls.make(EPS_CYCLE[b % 4], device="cuda", **knobs)
            for b in range(LANES)]
    cfg = core.GWConfig(eps=EPS_CYCLE[-1], outer_iters=30,
                        sinkhorn_iters=300, backend="kernel",
                        sinkhorn_backend="auto", **knobs)
    bucket = (N_F, N_F)

    def batch(ps, cs, **kw):
        return core.entropic_gw_batch(ps, cfg, pad_to=bucket, controls=cs,
                                      **kw)

    rk, counts, walls["F batch"], sweeps = run_batch(
        torch, ops, core, f"Run F {LANES} lanes Grid1D {sizes.min()}–"
        f"{sizes.max()} padded to {N_F} f64 kernels",
        lambda: batch(probs, ctls))
    add(counts)
    check_batch_launches("Run F", counts, rk, sweeps)
    outer = [r.info.outer_iters for r in rk]
    say(f"  Run F lanes: outer {outer}, inner "
        f"{[r.info.inner_iters for r in rk]}, converged "
        f"{[r.info.converged for r in rk]}")
    check(len(set(outer)) > 1, "Run F: every lane stopped at one count")
    check(all(bool(torch.isfinite(r.plan).all()) for r in rk),
          "Run F: non-finite plan")
    t0 = time.perf_counter()
    for b, (p, c) in enumerate(zip(probs, ctls)):
        solo = core.entropic_gw(*p, cfg, controls=c)
        compare_runs(torch, f"Run F lane {b} (ε {EPS_CYCLE[b % 4]:g}) vs "
                     "its solo solve", rk[b], solo, 1e-8, 1e-6)
    torch.cuda.synchronize()
    walls["F 16 solo solves"] = time.perf_counter() - t0
    rev = batch(probs[::-1], ctls[::-1])
    check(all(lanes_equal(torch, a, b) for a, b in zip(rk, rev[::-1])),
          "Run F: reversing the lanes changed a lane's bits")
    say("  Run F reversed: every lane the same bits and counts")
    seg, n_seg = None, 0
    while seg is None or any(not d and t < cfg.outer_iters
                             for t, d in zip(seg.t, seg.done)):
        res, seg = batch(probs, ctls, resume_state=seg, max_outer_segment=6)
        n_seg += 1
    check(all(lanes_equal(torch, a, b) for a, b in zip(rk, res)),
          "Run F: the segmented solve differs from the one-shot")
    say(f"  Run F segmented ({n_seg} segments of ≤ 6 outer steps): every "
        "lane the same bits and counts as the one-shot")
    del rev, res, seg
    # the masked batch runs its finished lanes until the longest stops; a
    # scheduler can instead drop them between segments (ROADMAP A12)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    packed, n_seg = compacted(core, batch, probs, ctls, cfg.outer_iters)
    torch.cuda.synchronize()
    walls["F compacted"] = time.perf_counter() - t0
    for b in range(LANES):
        compare_runs(torch, f"Run F lane {b} compacted vs masked", packed[b],
                     rk[b], 1e-8, 1e-6)
    same = all(lanes_equal(torch, a, b) for a, b in zip(rk, packed))
    say(f"  Run F compacted ({n_seg} one-step segments, finished lanes "
        f"dropped between them): {walls['F compacted']:.3f} s against "
        f"{walls['F batch']:.3f} s masked; every lane "
        f"{'the same bits' if same else 'OTHER bits'} as the masked batch")
    del packed
    profile_solve(torch, "Run F", lambda: batch(probs, ctls))
    # kernels against the plain path at a smaller depth
    small = dataclasses.replace(cfg, outer_iters=3, tol=0.0)
    ctl0 = [dataclasses.replace(c, tol=c.tol * 0) for c in ctls[:4]]
    kp = core.entropic_gw_batch(probs[:4], small, pad_to=bucket,
                                controls=ctl0)
    pp = core.entropic_gw_batch(probs[:4], dataclasses.replace(
        small, backend="cumsum", sinkhorn_backend="torch"), pad_to=bucket,
        controls=ctl0)
    for b in range(4):
        compare_runs(torch, f"Run F lane {b} kernels vs plain (tol 0, 3 "
                     "outer steps)", kp[b], pp[b], 1e-8, 1e-6)
    del rk, kp, pp

    sizes = ragged_sizes(np, N_G_MIN, N_G, LANES_G, SEED + 22)
    probs = [(cloud(torch, np, int(m), SEED + 200 + 2 * b, torch.float64),
              cloud(torch, np, int(n), SEED + 201 + 2 * b, torch.float64),
              torch.full((int(m),), 1.0 / m, dtype=torch.float64,
                         device="cuda"),
              torch.full((int(n),), 1.0 / n, dtype=torch.float64,
                         device="cuda"))
             for b, (m, n) in enumerate(sizes)]
    cfg = core.GWConfig(plan_rank=R_LR, **LR_CONTROLS)
    rk, counts, walls["G batch"], sweeps = run_batch(
        torch, ops, core, f"Run G {LANES_G} lanes clouds {sizes.min()}–"
        f"{sizes.max()} points padded to {N_G} rank {R_LR} f64 kernels",
        lambda: core.entropic_gw_batch(probs, cfg, pad_to=(N_G, N_G)))
    add(counts)
    check_batch_launches("Run G", counts, rk, sweeps, factored=True)
    t0 = time.perf_counter()
    for b, p in enumerate(probs):
        compare_lowrank(torch, f"Run G lane {b} vs its solo solve", rk[b],
                        core.entropic_gw(*p, cfg), 1e-8, 1e-6)
    torch.cuda.synchronize()
    walls["G 4 solo solves"] = time.perf_counter() - t0
    # kernels against the plain path at a smaller depth, as Run F's
    small = dataclasses.replace(cfg, outer_iters=3, tol=0.0)
    kp = core.entropic_gw_batch(probs, small, pad_to=(N_G, N_G))
    pp = core.entropic_gw_batch(probs, dataclasses.replace(
        small, lowrank_backend="torch"), pad_to=(N_G, N_G))
    for b in range(LANES_G):
        compare_lowrank(torch, f"Run G lane {b} kernels vs plain (tol 0, 3 "
                        "outer steps)", kp[b], pp[b], 1e-8, 1e-6)
    del rk, kp, pp
    say(f"  Runs F and G with their checks: {time.perf_counter() - start:.1f}"
        " s of wall in all")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, gradients: Runs H, I, J through the implicit backward pass
# ---------------------------------------------------------------------------

#: Run H: Run A's width, an ε and tol at which the solve converges (Run A's
#: ε = 2e-3 at tol 0 does not), and a Neumann cap the series reaches its
#: tol under (at ε = 2e-2 it takes ~180 terms on Grid1D(1024))
H_CONTROLS = dict(eps=2e-2, tol=1e-10, outer_iters=60, sinkhorn_iters=2000,
                  implicit_solve_iters=300)
H_FD_STEP = 1e-4                # the central difference's step, over h
#: Run I: the trainer's FGW distillation loss (src/repro/train/loop.py:32)
#: on 8 ragged sequence pairs at olmo_1b's d_model
#: (src/repro/configs/olmo_1b.py:9), float32 hidden states
LANES_I, S_I_MIN, S_I_MAX, D_I = 8, 1536, 2048, 2048
#: Run J: Run G's scale, rank 16, the smooth-regime step size γ = 5 of the
#: reference's gradient tests (tests/test_implicit_grad.py:20-26).  From the
#: rank-2 start the Gaussian clouds' solve stays at the product coupling,
#: a fixed point that is stable at γ = 5 (at Run C's γ = 30 it is not, and
#: the Neumann series diverges there), so a central difference along a
#: random direction checks the gradient
N_J = 100_000
J_CONTROLS = dict(eps=5e-2, tol=1e-8, outer_iters=60, sinkhorn_iters=100,
                  plan="lowrank", plan_rank=R_LR, lr_gamma=5.0)
J_FD_STEP = 1e-4
J_MEMORY_BUDGET = 8 * 2 ** 30   # bytes; one (10⁵)² f64 array is 80 GB


def backward_path(torch, ops, core, label, out, wrt):
    """The gradients of ``out`` to ``wrt``, on the host clock around
    synchronised work, with each lane's Neumann terms and the device's
    peak memory since the forward's reset.  The backward is plain PyTorch:
    it launches no kernel."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with Recorded(core.solver, "neumann_series") as series:
        t0 = time.perf_counter()
        grads = torch.autograd.grad(out, wrt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    say(f"  {label}: backward {wall:.3f} s wall, Neumann terms per lane "
        f"{[terms for _, terms in series.out]}, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    check(not any(ops.LAUNCHES.values()), f"{label}: the backward "
          f"launched kernels {ops.LAUNCHES}")
    check(all(bool(torch.isfinite(g).all()) for g in grads),
          f"{label}: non-finite gradient")
    return grads, wall, peak


def rel_max(torch, got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def run_h(torch, np, ops, core, add, walls):
    """Run H: the dense implicit gradient at Run A's width, in h (a 0-d
    tensor), μ and ν, kernels (B1/B2) forward against plain forward, and
    against central finite differences."""
    n = N_BIG
    h0 = 1 / (n - 1)
    mu_np, nu_np = measures(np, n, SEED + 30), measures(np, n, SEED + 31)
    cfg = core.GWConfig(backend="cumsum", sinkhorn_backend="auto",
                        **H_CONTROLS)
    say(f"  Run H controls: ε {cfg.eps:g}, tol {cfg.tol:g}, outer cap "
        f"{cfg.outer_iters}, inner cap {cfg.sinkhorn_iters}, Neumann cap "
        f"{cfg.implicit_solve_iters} at tol {cfg.implicit_solve_tol:g}")

    def solve(c, h, mu, nu):
        return core.entropic_gw(core.Grid1D(n, h, 1), core.Grid1D(n, h0, 1),
                                mu, nu, c)

    grads = {}
    for route in ("kernels", "plain"):
        c = cfg if route == "kernels" else \
            dataclasses.replace(cfg, sinkhorn_backend="torch")
        leaves = (torch.tensor(h0, dtype=torch.float64, device="cuda",
                               requires_grad=True),
                  torch.tensor(mu_np, device="cuda", requires_grad=True),
                  torch.tensor(nu_np, device="cuda", requires_grad=True))
        torch.cuda.reset_peak_memory_stats()
        res, counts, walls[f"H forward {route}"] = run_path(
            torch, ops, f"Run H Grid1D({n}) float64 {route}, h μ ν "
            "requiring grad", lambda: solve(c, *leaves))
        if route == "kernels":
            add(counts)
            for name in ("sinkhorn_row_update", "sinkhorn_col_update"):
                check(counts[name] > 0, f"Run H: {name} never launched")
            check(res.info.converged, "Run H: the solve did not converge")
            rk = res
        else:
            compare_runs(torch, "Run H float64", rk, res, 1e-8, 1e-6)
        grads[route], walls[f"H backward {route}"], _ = backward_path(
            torch, ops, core, f"Run H {route}", res.value, leaves)
        del res
    gk, gp = grads["kernels"], grads["plain"]
    apart = [rel_max(torch, a, b) for a, b in zip(gk, gp)]
    say(f"  Run H gradients, kernels forward vs plain forward: relative "
        f"max Δ in h, μ, ν {apart} (tolerance 1e-6)")
    check(max(apart) <= 1e-6, "Run H: the gradients differ")
    d = H_FD_STEP * h0
    vals = [float(solve(cfg, h0 + s * d, mu_np, nu_np).value)
            for s in (1, -1)]
    fd = (vals[0] - vals[1]) / (2 * d)
    rel = abs(fd - float(gk[0])) / abs(fd)
    say(f"  Run H d value/dh: implicit {float(gk[0]):.15e}, central "
        f"difference (step {H_FD_STEP:g} h) {fd:.15e}, relative Δ "
        f"{rel:.3e} (tolerance 1e-6)")
    check(rel <= 1e-6, "Run H: the gradient misses the finite difference")
    check(float(gk[1].abs().max()) > 0 and float(gk[2].abs().max()) > 0,
          "Run H: zero gradient in the measures")


def run_i(torch, np, ops, core, add, walls):
    """Run I: the trainer's batched FGW alignment loss and its gradient to
    the student's hidden states, kernels against plain by Run A's f32
    rule, each lane against its solo loss, padded feature rows exact
    zeros.

    A lane's gradient is its solo loss's / 8 within 1e-6 relative in f64.
    In f32 that bar is below the gradient's own accuracy: the batch pads
    each lane, and a padded reduction rounds in another order than an
    unpadded one, at a state 3 outer steps in whose Neumann series is cut
    at 60 terms (on an H100 80GB HBM3 at 700 W, f32 lanes sit 1.6e-4 to
    6.4e-4 from the solo f64 gradient, as their solo f32 gradients do; f64
    lanes 5.6e-11 at most from their solo ones).  So the f32 lanes are
    held to Run A's rule against the solo f64 gradient."""
    sizes = ragged_sizes(np, S_I_MIN, S_I_MAX, LANES_I, SEED + 40)
    rng = np.random.default_rng(SEED + 41)
    student = [rng.standard_normal((int(s), D_I), dtype=np.float32)
               for s, _ in sizes]
    teacher = [rng.standard_normal((int(t), D_I), dtype=np.float32)
               for _, t in sizes]
    cfg = core.AlignConfig(theta=0.5, outer_iters=3, sinkhorn_iters=30)
    plain = dataclasses.replace(cfg, sinkhorn_backend="torch")

    def states(dt):
        return ([torch.tensor(x, device="cuda", dtype=dt,
                              requires_grad=True) for x in student],
                [torch.tensor(x, device="cuda", dtype=dt) for x in teacher])

    out = {}
    for route, c, dt in (("kernels", cfg, torch.float32),
                         ("plain", plain, torch.float32),
                         ("kernels f64", cfg, torch.float64),
                         ("plain f64", plain, torch.float64)):
        hs, ht = states(dt)
        torch.cuda.reset_peak_memory_stats()
        with Recorded(core.gw, "_stack_features") as feats:
            loss, counts, walls[f"I forward {route}"] = run_path(
                torch, ops, f"Run I {LANES_I} pairs {sizes.min()}–"
                f"{sizes.max()} tokens, d {D_I}, {route}",
                lambda: core.fgw_alignment_loss_batch(hs, ht, c))
        if route == "kernels":
            add(counts)
            for name in ("sinkhorn_row_update", "sinkhorn_col_update"):
                check(counts[name] > 0, f"Run I: {name} never launched")
        grads, walls[f"I backward {route}"], _ = backward_path(
            torch, ops, core, f"Run I {route}", loss, hs + feats.out)
        out[route] = (loss.detach(), grads[:-1], grads[-1], hs, ht)
    (lk, gk, feat_grad, hs32, ht32), (lp, gp, *_), \
        (lk64, gk64, _, hs64, ht64), (l64, g64, *_) = (
            out[k] for k in ("kernels", "plain", "kernels f64",
                             "plain f64"))
    ev = tied_to_f64(torch, lk.reshape(1), lp.reshape(1), l64.reshape(1))
    eg = tied_to_f64(torch, torch.cat([g.flatten() for g in gk]),
                     torch.cat([g.flatten() for g in gp]),
                     torch.cat([g.flatten() for g in g64]))
    rel64 = max([abs(float(lk64) - float(l64)) / abs(float(l64))]
                + [rel_max(torch, a, b) for a, b in zip(gk64, g64)])
    say(f"  Run I loss {float(lk):.9e} (kernels) {float(lp):.9e} (plain) "
        f"{float(l64):.15e} (plain f64); distance from f64, kernels / plain "
        f"/ limit: value {ev[0]:.3e} / {ev[1]:.3e} / {ev[2]:.3e}, gradients "
        f"{eg[0]:.3e} / {eg[1]:.3e} / {eg[2]:.3e} (Run A's f32 rule); f64 "
        f"kernels vs plain: relative max Δ {rel64:.3e} (tolerance 1e-8)")
    check(ev[0] <= ev[2] and eg[0] <= eg[2],
          "Run I: kernels and plain differ beyond Run A's f32 rule")
    check(rel64 <= 1e-8, "Run I: f64 kernels and plain differ")
    m, n = feat_grad.shape[1:]
    pad_rows = [float(feat_grad[b, s:].abs().max()) if s < m else 0.0
                for b, (s, _) in enumerate(sizes)]
    pad_cols = [float(feat_grad[b, :, t:].abs().max()) if t < n else 0.0
                for b, (_, t) in enumerate(sizes)]
    live = [float(feat_grad[b, :s, :t].abs().max())
            for b, (s, t) in enumerate(sizes)]
    say(f"  Run I feature-cost gradient: largest on padded rows "
        f"{max(pad_rows)}, padded columns {max(pad_cols)}; on live entries "
        f"{min(live):.3e} at least")
    check(max(pad_rows) == 0.0 and max(pad_cols) == 0.0 and min(live) > 0,
          "Run I: padded feature rows carry gradient")
    apart64, tied32 = [], []
    for b in range(LANES_I):
        solo = [torch.autograd.grad(core.fgw_alignment_loss(
            hs[b], ht[b], cfg), hs[b])[0] / LANES_I
            for hs, ht in ((hs64, ht64), (hs32, ht32))]
        apart64.append(rel_max(torch, gk64[b], solo[0]))
        tied32.append(tied_to_f64(torch, gk[b], solo[1], solo[0]))
    say(f"  Run I lanes against their solo losses / {LANES_I}: f64 relative "
        f"max Δ {[f'{a:.2e}' for a in apart64]} (tolerance 1e-6); f32 "
        f"distance from the solo f64 gradient, lane / solo / limit "
        f"{[tuple(f'{x:.2e}' for x in t) for t in tied32]}")
    check(max(apart64) <= 1e-6, "Run I: an f64 lane's gradient is not its "
          "solo one's")
    check(all(t[0] <= t[2] for t in tied32), "Run I: an f32 lane's "
          "gradient is further from the f64 one than Run A's rule allows")


def run_j(torch, np, ops, core, add, walls):
    """Run J: the factored implicit gradient to one cloud's points at Run
    G's scale, where no dense plan can exist; kernels (B5–B7) forward
    against plain forward."""
    cfg = core.GWConfig(**J_CONTROLS)
    pts_np = np.random.default_rng(SEED + 50).normal(size=(N_J, 3))
    gy = cloud(torch, np, N_J, SEED + 51, torch.float64)
    mu = torch.full((N_J,), 1.0 / N_J, dtype=torch.float64, device="cuda")
    res, grads = {}, {}
    for route in ("kernels", "plain"):
        c = cfg if route == "kernels" else \
            dataclasses.replace(cfg, lowrank_backend="torch")
        pts = torch.tensor(pts_np, device="cuda", requires_grad=True)
        torch.cuda.reset_peak_memory_stats()
        res[route], counts, walls[f"J forward {route}"] = run_path(
            torch, ops, f"Run J clouds {N_J}x3 rank {R_LR} float64 {route}, "
            "points requiring grad",
            lambda: core.entropic_gw(core.PointCloudGeometry(pts), gy, mu,
                                     mu, c))
        if route == "kernels":
            add(counts)
            check_lr_launches("Run J", counts, res[route].info, True)
        (grads[route],), walls[f"J backward {route}"], peak = \
            backward_path(torch, ops, core, f"Run J {route}",
                          res[route].value, (pts,))
        if route == "kernels":
            say(f"  Run J peak device memory {peak / 2**30:.3f} GiB (budget "
                f"{J_MEMORY_BUDGET / 2**30:g} GiB)")
            check(peak <= J_MEMORY_BUDGET, "Run J: over its memory budget")
    compare_lowrank(torch, "Run J float64", res["kernels"], res["plain"],
                    1e-8, 1e-6)
    check(res["kernels"].info.converged, "Run J: the solve did not converge")
    apart = rel_max(torch, grads["kernels"], grads["plain"])
    say(f"  Run J gradients, kernels forward vs plain forward: relative max "
        f"Δ {apart:.3e} (tolerance 1e-6)")
    check(apart <= 1e-6, "Run J: the gradients differ")
    direction = np.random.default_rng(SEED + 52).normal(size=(N_J, 3))
    vals = [float(core.entropic_gw(core.PointCloudGeometry(torch.tensor(
        pts_np + s * J_FD_STEP * direction, device="cuda")), gy, mu, mu,
        cfg).value) for s in (1, -1)]
    fd = (vals[0] - vals[1]) / (2 * J_FD_STEP)
    implicit = float((grads["kernels"]
                      * torch.tensor(direction, device="cuda")).sum())
    rel = abs(fd - implicit) / abs(fd)
    say(f"  Run J derivative along a random direction: implicit "
        f"{implicit:.15e}, central difference (step {J_FD_STEP:g}) "
        f"{fd:.15e}, relative Δ {rel:.3e} (tolerance 1e-6)")
    check(rel <= 1e-6, "Run J: the gradient misses the finite difference")


def phase_grad_path(torch, np, ops, core):
    """Runs H, I, J: reverse mode through `fixed_point_value`."""
    say("phase 3, gradients: the implicit backward pass")
    start = time.perf_counter()
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for run in (run_h, run_i, run_j):
        run(torch, np, ops, core, add, walls)
    say(f"  Runs H, I and J with their checks: "
        f"{time.perf_counter() - start:.1f} s of wall in all")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, variants: Runs K–N through UGW, COOT, the barycenter and sliced GW
# ---------------------------------------------------------------------------

#: Run K: unbalanced GW at Run A's width (ε, ρ: the reference's UGW tests,
#: tests/test_gw_solvers.py:59, tests/test_solver.py:308), fixed and
#: adaptive with annealing
# 5 outer steps (was 10: 18.4 s of kernels and plain, the script at its
# 1200 s limit)
K_FIXED = dict(eps=1e-2, rho=1.0, outer_iters=5, sinkhorn_iters=200)
K_ADAPTIVE = dict(eps=1e-2, rho=1.0, tol=1e-7, eps_init=1e-1,
                  outer_iters=30, sinkhorn_iters=300)
#: Run L: COOT at the shapes of MNIST → USPS (28² = 784 and 16² = 256
#: pixels) on 8192 samples a side, and its GW specialization on Grid1D(4096)
N_L, D_L, E_L, N_L_GRID = 8192, 784, 256, 4096
L_CONTROLS = dict(eps_samples=1e-2, eps_features=1e-2, outer_iters=10,
                  sinkhorn_iters=100)
#: Run M: the barycenter of 4 Grid1D inputs on a 4096-point support
M_SIZES, M_SUPPORT, M_WEIGHTS = (2048, 2560, 3072, 4096), 4096, \
    (0.4, 0.3, 0.2, 0.1)
M_CONTROLS = dict(eps=5e-3, outer_iters=5, gw_iters=5, sinkhorn_iters=100,
                  tol=1e-6, eps_init=5e-2)
#: Run N: sliced GW on two 10⁶-point clouds (Run C's scale), uniform in
#: boxes of sides 1, 2, 3 (distinct principal axes) under a tilted,
#: skewed marginal (a signed third moment on every axis); the grid method
#: at the reference's `_sliced_grid` config
N_N, P_N, N_N_PLAN, P_N_GRID, GRID_N = 1_000_000, 128, 8192, 32, 512
P_N_CPU = 8           # N(a)'s directions compared with the CPU's run
                      # (16 took the CPU 12.4 s)
N_AXES = (1.0, 2.0, 3.0)
N_PLAN_SCALE = 0.125   # the plan run's clouds shrunk to O(1) costs
N_GW_CONTROLS = dict(eps=5e-3, tol=1e-6, outer_iters=60, sinkhorn_iters=500)


def box_cloud(np, n, seed, scale=1.0):
    """n points uniform in a box of sides N_AXES (× scale), and their
    tilted marginal w ∝ exp(½ Σ_a x_a / side_a): skewed along every axis."""
    r = np.random.default_rng(seed)
    axes = np.asarray(N_AXES)
    pts = (r.random((n, 3)) - 0.5) * axes * scale
    w = np.exp(0.5 * (pts / (axes * scale)).sum(axis=1))
    return pts, w / w.sum()


def coot_result(torch, pi_s, pi_v, value, info):
    """COOT's output in the shape `compare_runs` reads: both plans as one
    flat plan (so the L1 Δ is the solver's own movement metric)."""
    return types.SimpleNamespace(
        plan=torch.cat([pi_s.reshape(-1), pi_v.reshape(-1)]), value=value,
        info=info)


def run_k(torch, np, ops, core, add, walls):
    """Run K: UGW on Grid1D(8192) both sides, kernels (B3) against plain,
    fixed and adaptive, f64."""
    n = N_BIG
    grid = core.Grid1D(n, 1 / (n - 1), 1)
    mu, nu = measures(np, n, SEED + 60), measures(np, n, SEED + 61)
    for label, knobs in (("fixed", K_FIXED), ("adaptive", K_ADAPTIVE)):
        res = {}
        for route, backend in (("kernels", "kernel"), ("plain", "cumsum")):
            cfg = core.UGWConfig(backend=backend, **knobs)
            res[route], counts, walls[f"K {label} {route}"] = run_path(
                torch, ops, f"Run K UGW Grid1D({n}) float64 {label} {route}",
                lambda: core.entropic_ugw(grid, grid, mu, nu, cfg))
            r = res[route]
            say(f"  Run K {label} {route}: mass {float(r.plan.sum()):.15f}, "
                f"value {float(r.value):.15e}, drift "
                f"{float(r.marginal_err):.3e}, outer {r.info.outer_iters}, "
                f"inner {r.info.inner_iters}, converged {r.info.converged}")
            if route == "kernels":
                add(counts)
                # B3 a D̃ apply: the cost's two squared-distance applies and
                # D_X Γ D_Y's two applies a step, and as many for the value
                want = 4 * r.info.outer_iters + 4
                say(f"  Run K {label}: fgc_apply_dtilde launches "
                    f"{counts['fgc_apply_dtilde']}, expected {want}")
                check(counts["fgc_apply_dtilde"] == want,
                      f"Run K {label}: B3 launches differ from the code's")
        compare_runs(torch, f"Run K {label}", res["kernels"], res["plain"],
                     1e-8, 1e-6)
        if label == "adaptive":
            check(res["kernels"].info.converged,
                  "Run K adaptive: the solve did not converge")
        del res
    # two of the fixed solve's ten steps: the profiler's own cost grows
    # with the ~8000 device activities a step records
    profile_solve(torch, "Run K fixed kernels, 2 outer steps",
                  lambda: core.entropic_ugw(grid, grid, mu, nu,
                                            core.UGWConfig(
                                                backend="kernel",
                                                **dict(K_FIXED,
                                                       outer_iters=2))))


def run_l(torch, np, ops, core, add, walls):
    """Run L: COOT, (a) on data matrices of MNIST → USPS's shapes in f64
    and f32, (b) its GW specialization on Grid1D(4096) through
    bilinear_product's FGC apply; kernels (B1/B2, and B3 in (b)) against
    plain."""
    coot = core.coot
    rng = np.random.default_rng(SEED + 70)
    x_np = rng.random((N_L, D_L))
    y_np = rng.random((N_L, E_L))
    uni = [np.full(k, 1.0 / k) for k in (N_L, N_L, D_L, E_L)]
    kern = coot.COOTConfig(sinkhorn_backend="auto", **L_CONTROLS)
    plain = coot.COOTConfig(sinkhorn_backend="torch", **L_CONTROLS)

    def solve(cfg, dt, **kw):
        out = coot.entropic_coot(
            torch.tensor(x_np, dtype=dt, device="cuda"),
            torch.tensor(y_np, dtype=dt, device="cuda"),
            *(torch.tensor(u, dtype=dt, device="cuda") for u in uni), cfg,
            return_info=True, **kw)
        return coot_result(torch, *out)

    exact = None
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        rk, counts, walls[f"L(a) {name} kernels"] = run_path(
            torch, ops, f"Run L(a) COOT X {N_L}x{D_L}, Y {N_L}x{E_L} {name} "
            "kernels", lambda: solve(kern, dt))
        add(counts)
        want = rk.info.inner_iters
        got = (counts["sinkhorn_row_update"], counts["sinkhorn_col_update"])
        say(f"  Run L(a) {name}: B1/B2 launches {got}, expected {want} each "
            f"(one a half-step of either half's inner iterations)")
        check(got == (want, want) and counts["fgc_apply_dtilde"] == 0,
              f"Run L(a) {name}: launch counts differ from the code's")
        rp, _, walls[f"L(a) {name} plain"] = run_path(
            torch, ops, f"Run L(a) {name} plain", lambda: solve(plain, dt))
        if dt == torch.float64:
            tols = (1e-8, 1e-6)
            exact = (float(rk.value), rk.plan)
        else:
            rel32 = abs(float(rp.value) - exact[0]) / abs(exact[0])
            l1_32 = float((rp.plan.double() - exact[1]).abs().sum())
            say(f"  Run L(a) float32 plain vs float64 kernels: relative Δ "
                f"value {rel32:.3e}, plans L1 Δ {l1_32:.3e}")
            tols = (max(1e-4, 4 * rel32), max(1e-3, 4 * l1_32))
        compare_runs(torch, f"Run L(a) {name}", rk, rp, *tols)
        if dt == torch.float64:
            profile_solve(torch, "Run L(a) float64 kernels",
                          lambda: solve(kern, dt))
        del rk, rp
    del exact

    # (b): X = D_X, Y = D_Y.  Random marginals: uniform ones on two equal
    # grids leave the reflection symmetry unbroken, and rounding then
    # picks the branch (tests/reference_spreads.py coot_symmetry: routes
    # up to 3.5 apart in L1 at n = 512 on the CPU, 1.8e-14 with random
    # marginals)
    n = N_L_GRID
    grid = core.Grid1D(n, 1 / (n - 1), 1)
    dmat = grid.dist_matrix(device="cuda")
    marg = [torch.tensor(measures(np, n, SEED + 71 + i), device="cuda")
            for i in range(4)]

    def solve_b(cfg, grids=True):
        extra = dict(grid_x=grid, grid_y=grid) if grids else {}
        return coot_result(torch, *coot.entropic_coot(
            dmat, dmat, *marg, cfg, return_info=True, **extra))

    kern_b = dataclasses.replace(kern, backend="kernel")
    plain_b = dataclasses.replace(plain, backend="cumsum")
    rk, counts, walls["L(b) kernels"] = run_path(
        torch, ops, f"Run L(b) COOT on Grid1D({n}) distances float64 kernels",
        lambda: solve_b(kern_b))
    add(counts)
    # bilinear_product: one B3 apply a side, once a step and once for the
    # value
    want = {"sinkhorn_row_update": rk.info.inner_iters,
            "sinkhorn_col_update": rk.info.inner_iters,
            "fgc_apply_dtilde": 2 * rk.info.outer_iters + 2}
    got = {k: counts[k] for k in want}
    say(f"  Run L(b): launches {got}, expected {want}")
    check(got == want, "Run L(b): launch counts differ from the code's")
    rp, _, walls["L(b) plain"] = run_path(
        torch, ops, "Run L(b) float64 plain", lambda: solve_b(plain_b))
    compare_runs(torch, "Run L(b)", rk, rp, 1e-8, 1e-6)
    rd, _, walls["L(b) dense products"] = run_path(
        torch, ops, "Run L(b) float64 kernels, grid-less dense products",
        lambda: solve_b(kern, grids=False))
    say(f"  Run L(b) grid route vs dense products (no bar, the reference's "
        f"tests/test_coot.py:39 check at n = {n}): plans L1 Δ "
        f"{float((rk.plan - rd.plan).abs().sum()):.3e}, value relative Δ "
        f"{abs(float(rk.value) - float(rd.value)) / abs(float(rd.value)):.3e}"
        f", counts {rk.info.outer_iters}/{rd.info.outer_iters} outer, "
        f"{rk.info.inner_iters}/{rd.info.inner_iters} inner")


def run_m(torch, np, ops, core, add, walls):
    """Run M: the fixed-support barycenter of four Grid1D inputs, kernels
    (B1/B2, B3 on the grid sides) against plain: D̄ max relative Δ 1e-8,
    each plan L1 Δ 1e-6 and its marginals within 1e-4."""
    grids = [core.Grid1D(s, 1 / (s - 1), 1) for s in M_SIZES]
    nus = [torch.tensor(measures(np, s, SEED + 80 + i), device="cuda")
           for i, s in enumerate(M_SIZES)]
    mu_bar = torch.full((M_SUPPORT,), 1.0 / M_SUPPORT, dtype=torch.float64,
                        device="cuda")
    out = {}
    for route, fgc, sk in (("kernels", "kernel", "auto"),
                           ("plain", "cumsum", "torch")):
        cfg = core.BarycenterConfig(backend=fgc, sinkhorn_backend=sk,
                                    **M_CONTROLS)
        with Recorded(core.barycenter, "gw_plan_solve") as solves:
            out[route], counts, walls[f"M {route}"] = run_path(
                torch, ops, f"Run M barycenter of Grid1D {M_SIZES} on "
                f"{M_SUPPORT} points float64 {route}",
                lambda: core.gw_barycenter(grids, nus, M_WEIGHTS, mu_bar,
                                           cfg))
        infos = [info for _, info in solves.out]
        say(f"  Run M {route}: plan solves outer "
            f"{[i.outer_iters for i in infos]}, inner "
            f"{[i.inner_iters for i in infos]}")
        if route == "kernels":
            add(counts)
            inner = sum(i.inner_iters for i in infos)
            # B3 on the grid side: its squared apply for C1, one apply a
            # step, and Γ_s D_s for the update, each solve
            want = {"sinkhorn_row_update": inner,
                    "sinkhorn_col_update": inner,
                    "fgc_apply_dtilde": sum(2 + i.outer_iters
                                            for i in infos)}
            got = {k: counts[k] for k in want}
            say(f"  Run M: launches {got}, expected {want}")
            check(got == want, "Run M: launch counts differ from the code's")
            counts_k = [(i.outer_iters, i.inner_iters) for i in infos]
        else:
            check([(i.outer_iters, i.inner_iters) for i in infos] ==
                  counts_k, "Run M: plan-solve counts differ")
    (dk, pk), (dp, pp) = out["kernels"], out["plain"]
    check(bool(torch.isfinite(dk).all()), "Run M: non-finite D̄")
    rel = float((dk - dp).abs().max() / dp.abs().max())
    l1 = [float((a - b).abs().sum()) for a, b in zip(pk, pp)]
    marg = [max(float((p.sum(0) - nu).abs().max()),
                float((p.sum(1) - mu_bar).abs().max()))
            for p, nu in zip(pk, nus)]
    say(f"  Run M kernels vs plain: D̄ max relative Δ {rel:.3e} (tolerance "
        f"1e-8); plans L1 Δ {[f'{v:.2e}' for v in l1]} (tolerance 1e-6); "
        f"plans' marginal errors {[f'{v:.2e}' for v in marg]} (tolerance "
        f"1e-4, tests/test_solver.py:341)")
    check(rel <= 1e-8 and max(l1) <= 1e-6 and max(marg) <= 1e-4,
          "Run M: kernels and plain differ, or a plan is infeasible")


def sliced_on(torch, core, pts, w, dev, dt, directions=None, **kw):
    """sliced_gw on two clouds held on ``dev``."""
    g = [core.PointCloudGeometry(torch.tensor(p, dtype=dt, device=dev))
         for p in pts]
    ws = [torch.tensor(v, dtype=dt, device=dev) for v in w]
    return core.sliced_gw(*g, *ws, directions=directions, device=dev, **kw)


def run_n(torch, np, ops, core, add, walls):
    """Run N: sliced GW.  (a) the sorted method on two 10⁶-point clouds,
    f64 and f32, against the port's own CPU run (on P_N_CPU directions)
    and on a rotated, permuted copy; (b) sliced_plan on 8192 points and the warm start it gives a
    kernels entropic_gw; (c) the grid method, 32 lanes of
    entropic_gw_batch, kernels against plain, against (a) and twice."""
    a, wa = box_cloud(np, N_N, SEED + 90)
    b, wb = box_cloud(np, N_N, SEED + 91, scale=1.3)
    est = {}
    for dt in (torch.float64, torch.float32):
        name = str(dt).split(".")[-1]
        est[name], counts, walls[f"N(a) {name}"] = run_path(
            torch, ops, f"Run N(a) sliced_gw sorted {N_N} points n_proj "
            f"{P_N} {name}", lambda: sliced_on(torch, core, (a, b), (wa, wb),
                                              "cuda", dt, n_proj=P_N))
        check(not any(counts.values()), "Run N(a): launched a kernel")
        check(bool(torch.isfinite(est[name].profile).all()),
              f"Run N(a) {name}: non-finite profile")
    e64, e32 = est["float64"], est["float32"]
    # the card against the CPU on P_N_CPU directions: the CPU's 10⁶-point
    # run takes ~0.7 s a direction (~90 s for all 128)
    card = sliced_on(torch, core, (a, b), (wa, wb), "cuda", torch.float64,
                     n_proj=P_N_CPU)
    t0 = time.perf_counter()
    cpu = sliced_on(torch, core, (a, b), (wa, wb), "cpu", torch.float64,
                    n_proj=P_N_CPU)
    walls["N(a) float64 CPU"] = time.perf_counter() - t0
    rel_est = abs(float(card.estimate) - float(cpu.estimate)) / \
        abs(float(cpu.estimate))
    rel_prof = float(((card.profile.cpu() - cpu.profile).abs()
                      / cpu.profile.abs()).max())
    say(f"  Run N(a) float64, {P_N_CPU} directions: estimate "
        f"{float(card.estimate):.15e} (card) vs {float(cpu.estimate):.15e} "
        f"(CPU, {walls['N(a) float64 CPU']:.1f} s), relative Δ "
        f"{rel_est:.3e}, profile max relative Δ {rel_prof:.3e} (tolerance "
        "1e-9)")
    check(max(rel_est, rel_prof) <= 1e-9,
          "Run N(a): the card's estimate is not the CPU's")
    say(f"  Run N(a) float32 vs float64: estimate relative Δ "
        f"{abs(float(e32.estimate) - float(e64.estimate)) / float(e64.estimate):.3e}"
        f", profile max relative Δ "
        f"{float(((e32.profile.double() - e64.profile) / e64.profile).abs().max()):.3e}"
        " (no bar)")
    rng = np.random.default_rng(SEED + 92)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    perm = rng.permutation(N_N)
    rot = sliced_on(torch, core, (a, (a @ q.T)[perm]), (wa, wa[perm]),
                    "cuda", torch.float64, n_proj=P_N)
    ratio = abs(float(rot.estimate)) / float(e64.estimate)
    say(f"  Run N(a) rotated, permuted copy of A against A: estimate "
        f"{float(rot.estimate):.3e}, {ratio:.3e} of A against B (tolerance "
        f"1e-8)")
    check(ratio <= 1e-8, "Run N(a): a rotated copy does not score ~0")

    # (b): the plan and the warm start it gives
    pa, pb = (a[:N_N_PLAN] * N_PLAN_SCALE, b[:N_N_PLAN] * N_PLAN_SCALE)
    mu = torch.tensor(wa[:N_N_PLAN] / wa[:N_N_PLAN].sum(), device="cuda")
    nu = torch.tensor(wb[:N_N_PLAN] / wb[:N_N_PLAN].sum(), device="cuda")
    gx, gy = (core.PointCloudGeometry(torch.tensor(p, device="cuda"))
              for p in (pa, pb))
    sp, _, walls["N(b) sliced_plan"] = run_path(
        torch, ops, f"Run N(b) sliced_plan {N_N_PLAN} points n_proj {P_N}",
        lambda: core.sliced_plan(gx, gy, mu, nu, n_proj=P_N))
    err = max(float((sp.plan.sum(1) - mu).abs().max()),
              float((sp.plan.sum(0) - nu).abs().max()))
    say(f"  Run N(b) plan: marginal error {err:.3e} (tolerance 1e-12), "
        f"smallest entry {float(sp.plan.min()):.1e}, "
        f"{int((sp.plan > 0).sum())} nonzero entries")
    check(err <= 1e-12 and float(sp.plan.min()) >= 0.0,
          "Run N(b): the sliced plan is not a feasible coupling")
    cfg = core.GWConfig(**N_GW_CONTROLS)
    op = core.GradientOperator(gx, gy, cfg.backend)
    c1, _, _ = op.constant_term(mu, nu)
    starts = {}
    for name, state0 in (("cold", None), ("sliced warm start",
                                          core.FullCoupling.from_sliced(
                                              sp.plan, mu, nu))):
        (coup, info), counts, walls[f"N(b) {name}"] = run_path(
            torch, ops, f"Run N(b) entropic GW {N_N_PLAN} points, {name}, "
            "kernels", lambda: core.gw_plan_solve(op, c1, mu, nu, cfg,
                                                  state0=state0))
        add(counts)
        starts[name] = (info.outer_iters, info.inner_iters, info.converged)
        check(bool(torch.isfinite(coup.plan).all()),
              f"Run N(b) {name}: non-finite plan")
        check(counts["sinkhorn_row_update"] == info.inner_iters,
              f"Run N(b) {name}: B1 launches differ from the code's")
    say(f"  Run N(b) outer/inner/converged: cold {starts['cold']}, sliced "
        f"warm start {starts['sliced warm start']} (a record, no bar)")

    # (c): the grid method, 32 lanes of entropic_gw_batch
    grid_est = {}
    for fgc, plain_fgc in (("dense", "dense"), ("kernel", "cumsum")):
        res = {}
        for route, g_back, s_back in (("kernels", fgc, "auto"),
                                      ("plain", plain_fgc, "torch")):
            with Recorded(core.gw, "entropic_gw_batch") as batches, \
                    Recorded(core.sinkhorn, "_chunked_loop") as loops:
                est_c, counts, walls[f"N(c) {fgc} {route}"] = run_path(
                    torch, ops, f"Run N(c) sliced_gw grid n_proj {P_N_GRID} "
                    f"grid_n {GRID_N} grid_backend {g_back} sinkhorn "
                    f"{s_back}", lambda: sliced_on(
                        torch, core, (a, b), (wa, wb), "cuda", torch.float64,
                        n_proj=P_N_GRID, method="grid", grid_n=GRID_N,
                        grid_backend=g_back, sinkhorn_backend=s_back))
            lanes = batches.out[0]
            res[route] = (est_c, lanes)
            if route == "kernels":
                add(counts)
                sweeps = sum(max(used, default=0) for _, used in loops.out)
                if fgc == "kernel":
                    check_batch_launches(f"Run N(c) {fgc}", counts, lanes,
                                         sweeps)
                else:
                    check(counts["sinkhorn_row_update"] == sweeps and
                          counts["sinkhorn_col_update"] == sweeps,
                          f"Run N(c) {fgc}: B1/B2 launches differ from the "
                          "code's")
        (ek, lk), (ep, lp) = res["kernels"], res["plain"]
        for c in range(P_N_GRID):
            compare_runs(torch, f"Run N(c) {fgc} direction {c} kernels vs "
                         "plain", lk[c], lp[c], 1e-8, 1e-6)
        grid_est[fgc] = ek
        again = sliced_on(torch, core, (a, b), (wa, wb), "cuda",
                          torch.float64, n_proj=P_N_GRID, method="grid",
                          grid_n=GRID_N, grid_backend=fgc)
        check(torch.equal(again.profile, ek.profile),
              f"Run N(c) {fgc}: two calls give different bits")
        say(f"  Run N(c) {fgc}: a second call gives the same bits")
    sorted_p = sliced_on(torch, core, (a, b), (wa, wb), "cuda",
                         torch.float64, n_proj=P_N_GRID)
    for fgc, ek in grid_est.items():
        rel = abs(float(ek.estimate) - float(sorted_p.estimate)) / \
            float(sorted_p.estimate)
        corr = float(np.corrcoef(ek.profile.cpu().numpy(),
                                 sorted_p.profile.cpu().numpy())[0, 1])
        say(f"  Run N(c) {fgc}: grid estimate {float(ek.estimate):.9e} vs "
            f"sorted {float(sorted_p.estimate):.9e} on the same bank, "
            f"relative Δ {rel:.3e} (tolerance 0.1), profile correlation "
            f"{corr:.4f} (> 0.9, tests/test_sliced.py:208)")
        check(rel <= 0.1 and corr > 0.9,
              f"Run N(c) {fgc}: the grid method misses the sorted one")
    # the binning alone, twice, on the card: A's projections onto 32
    # directions, 10⁶ atoms into 512 bins
    proj = torch.tensor((a @ rng.normal(size=(3, P_N_GRID))).T.copy(),
                        device="cuda")
    w_a = torch.tensor(wa, device="cuda")
    (h1, m1), (h2, m2) = (core.sliced._resample_1d(proj, w_a, GRID_N)
                          for _ in range(2))
    check(torch.equal(m1, m2) and torch.equal(h1, h2),
          "Run N: _resample_1d gives different bits on two calls")
    say(f"  Run N: _resample_1d of {P_N_GRID} × {N_N} atoms into {GRID_N} "
        "bins, twice: the same bits")


def phase_variants_path(torch, np, ops, core):
    """Runs K, L, M, N: UGW, COOT, the barycenter and sliced GW."""
    say("phase 3, variants: UGW, COOT, the barycenter and sliced GW")
    start = time.perf_counter()
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for run in (run_k, run_l, run_m, run_n):
        t0 = time.perf_counter()
        run(torch, np, ops, core, add, walls)
        say(f"  {run.__name__[-1].upper()} with its checks: "
            f"{time.perf_counter() - t0:.1f} s")
    say(f"  Runs K, L, M and N with their checks: "
        f"{time.perf_counter() - start:.1f} s of wall in all")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, serving: Run O through repro_torch.serve.engine.GWEngine
# ---------------------------------------------------------------------------

#: Run O's engines (BENCH_serve.json's stream settings); the solver is Run
#: F's (the FGC kernel backend, annealed), its factored rank Run G's.
#: O(a)'s size_bucket is 2048, so that its 32 grid requests of 1024–2048
#: points share one bucket padded to 2048 (two slot batches of 16, with
#: refills); at 64 they would fall into about 32 buckets of one lane each.
#: O(a)'s 24 clouds are drawn within one such bucket (98 305–100 352
#: points, 49 × 2048), so that one factored bucket takes more requests
#: than its 16 slots: refills, then a repack, on B5–B7 lanes.  Their ε
#: and decay are Run G's; every sixth starts at its ε instead of Run G's
#: 0.5, so that the last slot batch holds lanes that stop early beside
#: annealed stragglers (the hardness order puts the four short ones
#: last).  O(b) pads to multiples of 64, so its 8192- and 10⁶-point
#: clouds are not padded at all.
O_SERVE = dict(max_batch=16, size_bucket=2048, tol=1e-5, segment_iters=6,
               lowrank_above=50_000)
O_GRIDS, O_CLOUDS = 32, 24
N_O_CLOUD_MIN, N_O_CLOUD = 98_305, 100_352
N_O_PLAN, N_O_SLICED = 8192, 1_000_000
O_CLOUD_KNOBS = dict(eps=5e-2, anneal_decay=0.7)   # Run G's
O_CLOUD_STARTS = (0.5,) * 5 + (5e-2,)              # eps_init, cycling
O_PLAN_KNOBS = dict(eps=1e-2, eps_init=5e-2)   # O(b)'s 8192-point clouds


def o_solver(core):
    return core.GWConfig(eps=EPS_CYCLE[-1], outer_iters=30,
                         sinkhorn_iters=300, backend="kernel",
                         sinkhorn_backend="auto", tol=1e-5, eps_init=5e-2,
                         anneal_decay=0.5, plan_rank=R_LR)


class SegmentLog:
    """Every segment a flush runs, with its plan, lanes, outer steps and
    inner sweeps, on whichever thread runs it: the engine's segments
    (`serve.engine._segment_stacked`, continuous and pipeline) and the
    barrier's one-shot batches (`core.gw._segment_stacked`).  The sweeps
    are the most any lane of an inner loop used (the lanes still running
    advance together), summed over the segment's loops."""

    def __init__(self, core):
        from repro_torch.serve import engine as engine_mod
        self.mods = ((engine_mod, "_segment_stacked"),
                     (core.gw, "_segment_stacked"),
                     (core.sinkhorn, "_chunked_loop"))
        self.real = [getattr(m, n) for m, n in self.mods]
        self.local = threading.local()
        self.lock = threading.Lock()
        self.segments = []

    def __enter__(self):
        seg_real, _, loop_real = self.real
        local = self.local

        def loop(*args, **kw):
            out = loop_real(*args, **kw)
            if getattr(local, "loops", None) is not None:
                local.loops.append(out[1])
            return out

        def seg(gx, gy, mus, nus, feats, ctls, carry, cfg, segment=None):
            local.loops = []
            t0 = carry.t
            out = seg_real(gx, gy, mus, nus, feats, ctls, carry, cfg,
                           segment)
            steps = max(a - b for a, b in zip(out[0].t, t0))
            sweeps = sum(max(u, default=0) for u in local.loops)
            local.loops = None
            with self.lock:
                self.segments.append((cfg.plan, mus.shape[0], steps, sweeps))
            return out

        for (m, n), fn in zip(self.mods, (seg, seg, loop)):
            setattr(m, n, fn)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.mods, self.real):
            setattr(m, n, fn)

    def expected(self):
        """The launches the code's formulas give for these segments: a
        full-plan grid segment launches B1 and B2 once an inner sweep and
        B3 twice an outer step plus four (the constant term and the
        energy); a factored segment B5 twice a sweep, B6 twice a step plus
        two, B7 twice a step."""
        want = {"sinkhorn_row_update": 0, "sinkhorn_col_update": 0,
                "fgc_apply_dtilde": 0, "lr_dykstra_half": 0,
                "lr_gram_chain": 0, "lr_grad_combine": 0}
        for plan, _, steps, sweeps in self.segments:
            if plan == "full":
                want["sinkhorn_row_update"] += sweeps
                want["sinkhorn_col_update"] += sweeps
                want["fgc_apply_dtilde"] += 2 * steps + 4
            else:
                want["lr_dykstra_half"] += 2 * sweeps
                want["lr_gram_chain"] += 2 * steps + 2
                want["lr_grad_combine"] += 2 * steps
        return want


def o_stream(torch, np, core):
    """Run O(a)'s requests: 32 Grid1D requests of 1024–2048 points a side
    (Run F's draw, ε cycling over EPS_CYCLE, annealed from 5e-2) and 24
    3-D Gaussian clouds of 98 305–100 352 points a side (Run G's draw, ε
    and decay, the annealing start cycling over O_CLOUD_STARTS), in
    rounds of 4 grids and 3 clouds; each (problem, knobs)."""
    sizes = ragged_sizes(np, N_F // 2, N_F, O_GRIDS, SEED + 23)
    grids = [((core.Grid1D(int(m), 1 / (m - 1), 1),
               core.Grid1D(int(n), 1 / (n - 1), 1),
               torch.tensor(measures(np, int(m), SEED + 300 + 2 * b),
                            device="cuda"),
               torch.tensor(measures(np, int(n), SEED + 301 + 2 * b),
                            device="cuda")),
              dict(eps=EPS_CYCLE[b % 4], eps_init=5e-2, anneal_decay=0.5))
             for b, (m, n) in enumerate(sizes)]
    sizes = ragged_sizes(np, N_O_CLOUD_MIN, N_O_CLOUD, O_CLOUDS, SEED + 24)
    clouds = [((cloud(torch, np, int(m), SEED + 400 + 2 * b, torch.float64),
                cloud(torch, np, int(n), SEED + 401 + 2 * b, torch.float64),
                torch.full((int(m),), 1.0 / m, dtype=torch.float64,
                           device="cuda"),
                torch.full((int(n),), 1.0 / n, dtype=torch.float64,
                           device="cuda")),
               dict(O_CLOUD_KNOBS,
                    eps_init=O_CLOUD_STARTS[b % len(O_CLOUD_STARTS)]))
              for b, (m, n) in enumerate(sizes)]
    stream = []
    while grids or clouds:
        stream += grids[:4] + clouds[:3]
        grids, clouds = grids[4:], clouds[3:]
    return stream


def o_same(torch, a, b):
    """Two results of one request with the same plan, potentials or
    factors, and counts; the values' relative difference."""
    same = (a.info.outer_iters, a.info.inner_iters, a.info.converged) == \
        (b.info.outer_iters, b.info.inner_iters, b.info.converged)
    pairs = ((a.plan, b.plan), (a.f, b.f), (a.g, b.g)) if a.plan is not None \
        else ((a.coupling.q, b.coupling.q), (a.coupling.r, b.coupling.r),
              (a.coupling.g, b.coupling.g))
    same = same and all(torch.equal(x, y) for x, y in pairs)
    rel = abs(float(a.value) - float(b.value)) / abs(float(b.value))
    return same, rel


def o_flush(torch, ops, core, label, eng):
    """One flush with the launch counts set to 0 just before it and read
    just after, its segments logged; checks the counts against the code's
    formulas and the engine's own stats."""
    with SegmentLog(core) as log:
        out, counts, wall = run_path(torch, ops, label, eng.flush)
    s = eng.stats
    want = log.expected()
    got = {k: counts[k] for k in want}
    lane_steps = sum(lanes * steps for _, lanes, steps, _ in log.segments)
    say(f"  {label}: {len(log.segments)} segments; launches {got}, from the "
        f"segments' steps and sweeps {want}")
    say(f"  {label} stats: executed/useful outer {s['executed_outer']}/"
        f"{s['useful_outer']}, inner {s['executed_inner']}/"
        f"{s['useful_inner']}, dispatches {s['dispatches']}, refills "
        f"{s['refills']}, repacks {s['repacks']}, dispatch depth "
        f"{s['dispatch_depth']}, device idle {s['device_idle_s']:.3f} s of "
        f"{s['flush_wall_s']:.3f} s")
    check(got == want, f"{label}: launch counts differ from the code's")
    check(len(log.segments) == s["dispatches"]
          and lane_steps == s["executed_outer"],
          f"{label}: the segments disagree with the engine's stats")
    if eng.cfg.scheduler != "barrier":
        # each bucket fills its slots, refills every freed one from its
        # queue and repacks its stragglers into a narrower batch
        widths = {plan: [lanes for p, lanes, _, _ in log.segments
                         if p == plan] for plan in ("full", "lowrank")}
        want_refills = sum(max(0, n - O_SERVE["max_batch"])
                           for n in (O_GRIDS, O_CLOUDS))
        say(f"  {label}: segment widths, full-plan bucket {widths['full']}, "
            f"factored bucket {widths['lowrank']}")
        check(s["refills"] == want_refills,
              f"{label}: {s['refills']} refills, not {want_refills}")
        for plan, w in widths.items():
            check(w and w[0] == O_SERVE["max_batch"] and min(w) < w[0],
                  f"{label}: the {plan} bucket was not refilled at its full "
                  "width and then repacked")
    return out, counts, wall


def run_o(torch, np, ops, core, add, walls):
    """Run O: GW serving.  (a) a mixed stream through the barrier,
    continuous and pipeline schedulers; (b) the plan cache and the sliced
    tiers on one pipeline engine; (c) the CLI driver."""
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    solver = o_solver(core)
    stream = o_stream(torch, np, core)
    outs = {}
    for sched in ("barrier", "continuous", "pipeline"):
        eng = GWEngine(GWServeConfig(solver=solver, scheduler=sched,
                                     max_inflight_buckets=2, **O_SERVE))
        rids = [eng.submit(*p, **kw) for p, kw in stream]
        out, counts, walls[f"O(a) {sched}"] = o_flush(
            torch, ops, core, f"Run O(a) {sched}: {O_GRIDS} Grid1D + "
            f"{O_CLOUDS} cloud requests", eng)
        add(counts)
        check(sorted(out) == sorted(rids) and len(out) == len(stream),
              f"Run O(a) {sched}: the returned ids are not the submitted "
              "ones, each once")
        outs[sched] = out
    worst = 0.0
    for sched in ("continuous", "pipeline"):
        for rid in outs["barrier"]:
            same, rel = o_same(torch, outs[sched][rid], outs["barrier"][rid])
            check(same, f"Run O(a): {sched} request {rid} differs from the "
                  "barrier's bits or counts")
            worst = max(worst, rel)
    say(f"  Run O(a) schedulers: every result the same plan, potentials, "
        f"factors and counts under barrier, continuous and pipeline; values "
        f"within {worst:.3e} relative (tolerance 1e-12)")
    check(worst <= 1e-12, "Run O(a): the schedulers' values differ")
    worst, lr_l1 = 0.0, 0.0
    t0 = time.perf_counter()
    for rid, (p, kw) in enumerate(stream):
        res = outs["pipeline"][rid]
        ctl = core.SolveControls.make(kw["eps"], O_SERVE["tol"],
                                      kw["eps_init"], kw["anneal_decay"],
                                      device="cuda")
        cfg = solver if res.plan is not None else \
            dataclasses.replace(solver, plan="lowrank")
        solo = core.entropic_gw(*p, cfg, controls=ctl)
        if res.plan is not None:
            same, rel = o_same(torch, res, solo)
            check(same, f"Run O(a) request {rid}: not its solo solve's bits "
                  "or counts")
            worst = max(worst, rel)
            continue
        # a factored lane: the bits of its lane alone in the bucket's
        # padding, and its unpadded solo solve at Run G's bar
        q = O_SERVE["size_bucket"]
        pad = tuple(-(-g.size // q) * q for g in p[:2])
        (alone,) = core.entropic_gw_batch([p], cfg, pad_to=pad,
                                          controls=[ctl])
        same, rel = o_same(torch, res, alone)
        check(same, f"Run O(a) request {rid}: not the bits or counts of its "
              "lane alone at the bucket's padding")
        worst = max(worst, rel)
        compare_lowrank(torch, f"Run O(a) request {rid} (factored) vs its "
                        "unpadded solo solve", res, solo, 1e-8, 1e-6)
    torch.cuda.synchronize()
    walls["O(a) solo solves"] = time.perf_counter() - t0
    say(f"  Run O(a): every grid result its solo entropic_gw's plan, "
        f"potentials and counts, every factored result its lane alone's "
        f"factors and counts; values within {worst:.3e} relative (tolerance "
        f"1e-12)")
    check(worst <= 1e-12, "Run O(a): a value differs from its solo solve's")
    for sched in ("continuous", "pipeline"):
        eng = GWEngine(GWServeConfig(solver=solver, scheduler=sched,
                                     max_inflight_buckets=2, **O_SERVE))

        def flush():
            for p, kw in stream:
                eng.submit(*p, **kw)
            return eng.flush()
        profile_solve(torch, f"Run O(a) {sched} flush", flush)
    del outs
    run_o_cache(torch, np, ops, core, add, walls, solver, stream)
    run_o_driver(torch, walls)


def o_problem(torch, core, pts_x, w_x, pts_y, w_y):
    return (core.PointCloudGeometry(torch.tensor(pts_x, device="cuda")),
            core.PointCloudGeometry(torch.tensor(pts_y, device="cuda")),
            torch.tensor(w_x, device="cuda"), torch.tensor(w_y, device="cuda"))


def run_o_cache(torch, np, ops, core, add, walls, solver, stream):
    """Run O(b): exact, near and profile hits, the sliced answer and the
    refine tier, on one pipeline engine."""
    from repro_torch.serve.engine import GWEngine, GWServeConfig
    eng = GWEngine(GWServeConfig(
        solver=solver, scheduler="pipeline", max_inflight_buckets=2,
        cache_capacity=64, cache_near_tol=1e-6, cache_profile_tol=1e-3,
        sliced_n_proj=32, **dict(O_SERVE, size_bucket=64)))
    grids = [(p, kw) for p, kw in stream if isinstance(p[0], core.Grid1D)]
    grids = grids[:8]
    rids = [eng.submit(*p, **kw) for p, kw in grids]
    cold, counts, walls["O(b) cold"] = run_path(
        torch, ops, "Run O(b) 8 grid requests cold", eng.flush)
    add(counts)
    cold = [cold[r] for r in rids]
    check(all(r.info.converged for r in cold),
          "Run O(b): a cold solve hit its cap unconverged")
    rids = [eng.submit(*p, **kw) for p, kw in grids]
    hot, counts, walls["O(b) exact repeats"] = run_path(
        torch, ops, "Run O(b) 8 exact repeats", eng.flush)
    s = eng.stats
    check(not any(counts.values()) and s["dispatches"] == 0
          and s["cache_hits"] == 8,
          "Run O(b): an exact repeat reached the device")
    check(all(hot[r] is c for r, c in zip(rids, cold)),
          "Run O(b): an exact repeat is not the first answer")
    say("  Run O(b) exact repeats: 8 cache hits, no dispatch, no kernel "
        "launch, the first answers' objects")
    rng = np.random.default_rng(SEED + 25)
    near = []
    for p, kw in grids:
        mu, nu = (v + 1e-9 * torch.tensor(rng.random(v.shape[0]),
                                          device="cuda") for v in p[2:])
        near.append(((p[0], p[1], mu / mu.sum(), nu / nu.sum()), kw))
    rids = [eng.submit(*p, **kw) for p, kw in near]
    warm, counts, walls["O(b) near repeats"] = run_path(
        torch, ops, "Run O(b) 8 near repeats (marginals moved 1e-9)",
        eng.flush)
    add(counts)
    s = eng.stats
    say(f"  Run O(b) near repeats: {s['cache_warm_starts']} warm starts "
        f"({s['cache_profile_hits']} by the profile stage, the rest by the "
        f"near digest), {s['cache_misses']} misses")
    check(s["cache_warm_starts"] == 8, "Run O(b): a near repeat solved cold")
    for r, c in zip(rids, cold):
        w = warm[r]
        l1 = float((w.plan - c.plan).abs().sum())
        rel = abs(float(w.value) - float(c.value)) / abs(float(c.value))
        say(f"    outer {w.info.outer_iters} warm vs {c.info.outer_iters} "
            f"cold, converged {w.info.converged}, plan L1 Δ {l1:.3e} "
            f"(tolerance 1e-3), value relative Δ {rel:.3e} (tolerance 1e-3)")
        check(w.info.converged and w.info.outer_iters < c.info.outer_iters
              and l1 < 1e-3 and rel <= 1e-3,
              "Run O(b): a near repeat's warm start missed")
    # rotated and re-indexed copies of an 8192-point cloud request
    a, wa = box_cloud(np, N_O_PLAN, SEED + 93, N_PLAN_SCALE)
    b, wb = box_cloud(np, N_O_PLAN, SEED + 94, 1.3 * N_PLAN_SCALE)
    rid = eng.submit(*o_problem(torch, core, a, wa, b, wb), **O_PLAN_KNOBS)
    base, counts, walls["O(b) 8192 cold"] = run_path(
        torch, ops, f"Run O(b) {N_O_PLAN}-point clouds, full plan, cold",
        eng.flush)
    add(counts)
    base = base[rid]
    copies = []
    for k in range(4):
        qa, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        qb, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        pa, pb = rng.permutation(N_O_PLAN), rng.permutation(N_O_PLAN)
        copies.append(eng.submit(*o_problem(torch, core, (a @ qa.T)[pa],
                                            wa[pa], (b @ qb.T)[pb], wb[pb]),
                                 **O_PLAN_KNOBS))
    warm, counts, walls["O(b) 8192 copies"] = run_path(
        torch, ops, f"Run O(b) 4 rotated, re-indexed copies", eng.flush)
    add(counts)
    s = eng.stats
    say(f"  Run O(b) copies: {s['cache_profile_hits']} profile hits; cold "
        f"outer {base.info.outer_iters} (converged {base.info.converged}), "
        f"warm outer {[warm[r].info.outer_iters for r in copies]}, values "
        f"{[float(warm[r].value) for r in copies]} against "
        f"{float(base.value)}")
    check(s["cache_profile_hits"] == 4 and s["cache_warm_starts"] == 4,
          "Run O(b): a rotated copy was not a profile hit")
    check(all(warm[r].info.converged for r in copies),
          "Run O(b): a realigned warm start did not converge")
    # the sliced answer on two 10⁶-point clouds
    a6, wa6 = box_cloud(np, N_O_SLICED, SEED + 90)
    b6, wb6 = box_cloud(np, N_O_SLICED, SEED + 91, scale=1.3)
    probs = [o_problem(torch, core, a6, wa6, b6, wb6),
             o_problem(torch, core, b6, wb6, a6, wa6)]
    rids = [eng.submit(*p, service="sliced") for p in probs]
    out, counts, walls["O(b) sliced"] = run_path(
        torch, ops, f"Run O(b) 2 sliced answers, {N_O_SLICED} points",
        eng.flush)
    check(not any(counts.values()) and eng.stats["dispatches"] == 2,
          "Run O(b): a sliced answer is not one call")
    for r, p in zip(rids, probs):
        ref = core.sliced_gw(*p, n_proj=32, seed=eng.cfg.sliced_seed)
        say(f"  Run O(b) sliced answer {float(out[r].value):.15e}, "
            f"sliced_gw {float(ref.estimate):.15e}")
        check(torch.equal(out[r].value, ref.estimate),
              "Run O(b): the sliced answer is not sliced_gw's bits")
    del probs, out
    # the refine tier on four 8192-point cloud pairs
    pairs = [(box_cloud(np, N_O_PLAN, SEED + 95 + 2 * k, N_PLAN_SCALE),
              box_cloud(np, N_O_PLAN, SEED + 96 + 2 * k, 1.3 * N_PLAN_SCALE))
             for k in range(4)]
    probs = [o_problem(torch, core, x, wx, y, wy)
             for (x, wx), (y, wy) in pairs]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = list(eng.serve((p, dict(O_PLAN_KNOBS, service="refine"))
                         for p in probs))
    torch.cuda.synchronize()
    walls["O(b) refine"] = time.perf_counter() - t0
    add(dict(ops.LAUNCHES))
    say(f"  Run O(b) refine: {len(got)} answers in "
        f"{walls['O(b) refine']:.3f} s, launches {dict(ops.LAUNCHES)}")
    check(len(got) == 8, "Run O(b): refine did not answer twice a request")
    first, final = {}, {}
    for r, res in got:
        (final if r in first else first)[r] = res
    check(len(first) == len(final) == 4, "Run O(b): refine answers missing")
    for r, p in zip(sorted(first), probs):
        pre, fin = first[r], final[r]
        sp = core.sliced_plan(*p, n_proj=32, seed=eng.cfg.sliced_seed)
        check(pre.info.outer_iters == 0 and torch.equal(pre.plan, sp.plan),
              "Run O(b): the preliminary is not the sliced plan")
        ctl = core.SolveControls.make(O_PLAN_KNOBS["eps"], O_SERVE["tol"],
                                      O_PLAN_KNOBS["eps_init"],
                                      solver.anneal_decay, device="cuda")
        carry = core.init_carry(core.FullCoupling.stack(
            [core.FullCoupling.from_sliced(sp.plan, p[2], p[3])]),
            solver.outer_iters, "cuda", 1)
        (alone,), _ = core.entropic_gw_batch([p], solver, controls=[ctl],
                                             resume_state=carry)
        same, rel = o_same(torch, fin, alone)
        say(f"  Run O(b) refine request {r}: outer {fin.info.outer_iters}, "
            f"converged {fin.info.converged}, value {float(fin.value):.9e} "
            f"(sliced {float(pre.value):.9e}); the resumed one-lane batch's "
            f"bits {same}, value relative Δ {rel:.3e}")
        check(same and rel <= 1e-12, "Run O(b): the refined answer is not "
              "the resumed one-lane batch's")


# the serving CLI's stream (24 requests took it 43.8 s)
O_DRIVER_REQUESTS = 8


def run_o_driver(torch, walls):
    """Run O(c): the CLI driver on the card, as a subprocess."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--gw",
           "--requests", str(O_DRIVER_REQUESTS), "--repeat-frac", "0.5",
           "--cache-capacity", "64"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    # the driver is a second process on the card: hand back the blocks
    # this process's allocator keeps cached (a pool for each stream the
    # pipeline's workers ran on)
    held = torch.cuda.memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"  Run O(c): this process's cached device memory "
        f"{held / 2**30:.3f} GiB, {torch.cuda.memory_reserved() / 2**30:.3f}"
        " GiB after handing it back")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=400)
    walls["O(c) driver"] = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    answered = [ln for ln in lines if ln.startswith("request ")]
    say(f"  Run O(c) {' '.join(cmd[1:])}: exit {proc.returncode}, "
        f"{walls['O(c) driver']:.1f} s, {len(answered)} answers; last lines:")
    for ln in lines[-3:]:
        say(f"    {ln}")
    check(proc.returncode == 0, "Run O(c): the driver failed: "
          + proc.stderr[-2000:])
    check(len(answered) == O_DRIVER_REQUESTS and any(
        ln.startswith("dispatches=")
                                      for ln in lines),
          "Run O(c): the driver did not answer every request and report")


def phase_serving_path(torch, np, ops, core):
    """Run O: the GW serving engine."""
    say("phase 3, serving: repro_torch.serve.engine.GWEngine")
    start = time.perf_counter()
    launches = {k: 0 for k in ops.LAUNCHES}
    walls = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    run_o(torch, np, ops, core, add, walls)
    say(f"  Run O with its checks: {time.perf_counter() - start:.1f} s of "
        "wall in all")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, LM serving: Run P
# ---------------------------------------------------------------------------

# 32 greedy tokens (64 took 5.9 s f32 and 7.4 s bf16)
P_A = dict(arch="smollm-360m", batch=4, prompt=128, new=32, max_len=256)
P_B = dict(batch=2, prompt=64, new=16)
# xLSTM's random-weight stack is chaotic (the reference's init draws the
# sLSTM's recurrent weights (h, dh, 4dh) at std h^-½ = 0.5): a one-ulp
# change of the weights grows to ~1e-3 of the logits by position 11
# (tests/lm_spreads.py xlstm_chaos, the port on the CPU, 8 layers at full
# width) and, on the card, to 1e-2 by position 15 and 0.2 by 19, and
# past that no two f32 evaluations agree; so its prompt is cut to 4 tokens
# (positions 3–19 are compared).
P_B_PROMPT = {"xlstm-350m": 4}
# P(b)'s f32 bar at each position: P_F32_BAR, or P_ENVELOPE × the distance
# by which moving every weight one ulp (seeded directions) moves that
# position's logits, measured on the card in the same run, where that is
# larger.  Reordered f32 sums stayed within 2.5× that envelope at every
# position of the chaotic xLSTM (a 4-thread against a 1-thread CPU
# forward, and decode against forward; two seeds; tests/lm_spreads.py
# xlstm_chaos); for the other stacks the envelope stays near 1e-6 and
# P_F32_BAR holds.
P_ENVELOPE = 8.0
P_C = dict(arch="mixtral-8x22b", prompt=4200, new=16)
P_PREFIX = 16          # the CPU's bf16-against-f32 prefix, tokens a row
P_PROFILE_STEPS = 8
# f32 logits, as max |Δ| over the largest |logit| of the f32 reference:
# the same f32 arithmetic summed in other orders (cuBLAS against the CPU's
# BLAS, a padded cache against the chunked forward) differs by a few ulp
# (u = 6e-8) a product, compounded over ≤ 32 layers; TF32 rounds every
# product's operands to 10 bits (u = 4.9e-4), which moves the logits by
# ~1e-3 of their scale: the TF32 control must land outside.
P_F32_BAR = 1e-4
# bf16 logits against the same weights' f32 logits: 4× the CPU's own
# bf16-against-f32 distance.  P(a) (a dense stack, whose distance does not
# grow along the sequence): the maximum, against the CPU's on a
# P_PREFIX-token prefix of the prompt.  P(b): the median over positions of
# each position's maximum, against the CPU's forward at the same positions
# of the same sequence.  The same positions, because a recurrence carries
# bf16's rounding forward, so the distance grows along the sequence; the
# median, because a MoE sends a token to another expert wherever bf16
# reorders two close router probabilities, and with experts drawn at std
# e^-½ that moves the token's logits by O(1) (smoke deepseek, the
# reference on the CPU over four seeds: bf16 from f32 at 17 positions, the
# maximum 0.04–0.18, the median 0.016–0.020; tests/lm_spreads.py
# mla_bf16); such flips set the maximum, not the median.  The card's
# kernels round otherwise (cuBLAS bf16 products accumulate in f32 and
# round their output, as the CPU's do): its distance is of the CPU's
# order, not its value.
P_BF16_FACTOR = 4.0


def p_rel(torch, got, want) -> float:
    """max |got − want| over max |want|."""
    want = want.float()
    return float((got.float().to(want.device) - want).abs().max()
                 / want.abs().max())


def p_median(torch, got, want) -> float:
    """The median over positions of max_v |got − want|, over max |want|."""
    want = want.float()
    per = (got.float().to(want.device) - want).abs().amax(-1)
    return float(per.flatten().median() / want.abs().max())


def p_positions(torch, got, want, scale):
    """(B, S) of max_v |got − want| over ``scale``."""
    return ((got.float().to(want.device) - want.float()).abs().amax(-1)
            / scale)


def p_envelope(torch, lm, model, cfg, seq, full):
    """(B, S): how far moving every weight one ulp up or down (seeded
    directions) moves each position's f32 logits from ``full``."""
    params = list(model.parameters())
    saved = [p.detach().clone() for p in params]
    gen = torch.Generator(device=params[0].device)
    gen.manual_seed(SEED)
    with torch.no_grad():
        try:
            for p in params:
                up = torch.randint(0, 2, p.shape, generator=gen,
                                   device=p.device).bool()
                p.copy_(torch.nextafter(p, torch.where(
                    up, math.inf, -math.inf).to(p.dtype)))
            moved, _ = lm.forward(model, seq, cfg)
        finally:
            for p, s in zip(params, saved):
                p.copy_(s)
    return p_positions(torch, moved, full, full.abs().max())


def p_within(torch, dist, env):
    """The largest ratio of a position's distance to its bar
    max(P_F32_BAR, P_ENVELOPE × envelope); ≤ 1 passes."""
    bar = torch.clamp_min(P_ENVELOPE * env, P_F32_BAR)
    return float((dist / bar).max())


def p_config(cfg, layers=None):
    """``cfg`` with its depth cut to ``layers`` (by default the prologue
    plus one period of the template) and, for a MoE, a capacity factor of
    ⌈e/k⌉, so that no group drops a token: prefill, decode and the forward
    group B·S, B and B·S' tokens, and at the published 1.25 a group that
    overflows in one of them drops tokens the others keep (the reference's
    semantics), so a decode could not equal its forward."""
    if layers is None:
        layers = len(cfg.prologue) + len(cfg.block_template)
    cfg = dataclasses.replace(cfg, num_layers=layers)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(
            math.ceil(cfg.num_experts / cfg.num_experts_per_tok)))
    return cfg


def p_inputs(torch, np, cfg, batch, length, seed, dev):
    """Random token ids, or frontend embeddings (std 0.1); M-RoPE positions
    over a 2 × 4 × 8 (t, h, w) patch grid for the first 64 positions, then
    text positions max + 1, max + 2, ... on all three axes."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": torch.tensor(rng.integers(
            0, cfg.vocab_size, (batch, length)), device=dev)}
    out = {"embeddings": torch.tensor(
        rng.normal(size=(batch, length, cfg.d_model)) * 0.1,
        dtype=torch.float32, device=dev)}
    if cfg.m_rope:
        i = np.arange(length)
        grid = np.stack([i // 32, (i // 8) % 4, i % 8], -1)
        text = 8 + (i - 64)[:, None].repeat(3, 1)
        thw = np.where((i < 64)[:, None], grid, text)
        out["positions"] = torch.tensor(np.broadcast_to(
            thw, (batch, length, 3)).copy(), device=dev)
    return out


def p_part(inputs, lo, hi):
    return {k: v[:, lo:hi] for k, v in inputs.items()}


def p_drive(torch, lm, model, cfg, inputs, n_prompt, max_len):
    """Prefill the first ``n_prompt`` positions, then decode the rest one at
    a time on the given inputs (teacher-forced); the logits of the
    prefill and of each decode step, (B, S − n_prompt + 1, V)."""
    b, s = next(iter(inputs.values())).shape[:2]
    dev = next(model.parameters()).device
    caches = lm.cache_init(cfg, b, max_len, torch.float32, dev)
    lg, caches = lm.prefill(model, p_part(inputs, 0, n_prompt), cfg, caches)
    out = [lg]
    for t in range(n_prompt, s):
        step = p_part(inputs, t, t + 1)
        pos = step.pop("positions", None)
        lg, caches = lm.decode_step(model, step, caches, cfg, position=pos)
        out.append(lg)
    return torch.stack(out, 1)


def p_cpu_copy(torch, lm, model, cfg):
    """The same weights in a model on the CPU."""
    cpu = lm.LM(cfg, None, device="meta")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                        strict=True, assign=True)
    return cpu


def p_bf16_bar(torch, lm, cpu_model, cfg, seq, lo=0, dist=p_rel):
    """P_BF16_FACTOR × the CPU's bf16-against-f32 distance ``dist`` of the
    forward over ``seq`` at positions ``lo:``; also the CPU's f32
    logits."""
    seq = {k: v.cpu() for k, v in seq.items()}
    f32, _ = lm.forward(cpu_model, seq, cfg)
    bf16, _ = lm.forward(cpu_model, seq, dataclasses.replace(
        cfg, dtype="bfloat16"))
    d = dist(torch, bf16[:, lo:], f32[:, lo:])
    return d, P_BF16_FACTOR * d, f32


def p_check(label, value, bar, why):
    say(f"  {label}: {value:.3e} (bar {bar:.1e}: {why})")
    check(value <= bar, f"{label}: {value:.3e} over its bar {bar:.1e}")


def p_seq(torch, inputs, tokens):
    """The prompt followed by the generated tokens."""
    gen = torch.as_tensor(tokens, device=inputs["tokens"].device)
    return {"tokens": torch.cat([inputs["tokens"], gen], 1)}


def run_p_a(torch, np, lm, configs, Engine, ServeConfig, walls):
    """P(a): smollm-360m at its published config through the Engine."""
    a = P_A
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get(a["arch"]), dtype="float32")
    cfg_bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = lm.init_params(cfg, gen, dev)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"  Run P(a) {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}; "
        f"{n_params} parameters, {n_params * 4 / 2**30:.3f} GiB in f32; "
        f"batch {a['batch']}, prompt {a['prompt']}, max_len {a['max_len']}, "
        f"{a['new']} greedy tokens")
    inputs = p_inputs(torch, np, cfg, a["batch"], a["prompt"], SEED, dev)
    prompts = inputs["tokens"].cpu().numpy()
    scfg = ServeConfig(max_len=a["max_len"], batch_size=a["batch"])
    runs = {}
    for c in (cfg, cfg_bf16):
        eng = Engine(model, c, scfg)
        eng.generate(prompts, 2)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate(prompts, 0)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        tokens, logits = eng.generate(prompts, a["new"], return_logits=True)
        torch.cuda.synchronize()
        t_all = time.perf_counter() - t0
        runs[c.dtype] = (tokens, logits)
        walls[f"P(a) {c.dtype} generate"] = t_all
        say(f"  Run P(a) {c.dtype}: prefill wall {t_pre * 1e3:.3f} ms "
            f"(generate of 0 tokens), generate of {a['new']} tokens "
            f"{t_all:.3f} s: decode {(t_all - t_pre) / a['new'] * 1e3:.3f} "
            f"ms a token, {a['batch'] * a['new'] / t_all:.1f} tokens/s")
    tokens, logits = runs["float32"]
    seq = p_seq(torch, inputs, tokens)
    with torch.inference_mode():
        full, _ = lm.forward(model, seq, cfg)
        p_check("Run P(a) f32 prefill and decode against forward on the card",
                p_rel(torch, logits, full[:, a["prompt"] - 1:]), P_F32_BAR,
                "f32 sums in other orders")
        prompt_fwd, _ = lm.forward(model, inputs, cfg)
        cpu_model = p_cpu_copy(torch, lm, model, cfg)
        t0 = time.perf_counter()
        cpu_fwd, _ = lm.forward(cpu_model, {"tokens": inputs["tokens"].cpu()},
                                cfg)
        walls["P(a) CPU forward"] = time.perf_counter() - t0
        p_check("Run P(a) f32 prompt forward, card against CPU",
                p_rel(torch, prompt_fwd, cpu_fwd), P_F32_BAR,
                "cuBLAS against the CPU's BLAS")
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32, _ = lm.prefill(model, inputs, cfg, lm.cache_init(
                cfg, a["batch"], a["max_len"], torch.float32, dev))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        d_tf32 = p_rel(torch, tf32, full[:, a["prompt"] - 1])
        say(f"  Run P(a) TF32 control: the f32 prefill with TF32 on, "
            f"{d_tf32:.3e} from the forward (must exceed the f32 bar "
            f"{P_F32_BAR:.1e})")
        check(d_tf32 > P_F32_BAR, "Run P(a): a TF32 prefill passes the f32 "
              "bar, which then cannot tell f32 from TF32")
        d_cpu, bar, _ = p_bf16_bar(torch, lm, cpu_model, cfg,
                                   p_part(inputs, 0, P_PREFIX))
        del cpu_model
        bf16 = p_drive(torch, lm, model, cfg_bf16, seq, a["prompt"],
                       a["max_len"])
        check(bool(torch.isfinite(bf16).all()), "Run P(a): bf16 logits "
              "not finite")
        p_check("Run P(a) bf16 prefill and decode (on the f32 run's tokens) "
                "against f32", p_rel(torch, bf16, logits), bar,
                f"{P_BF16_FACTOR:g}× the CPU's bf16-against-f32 distance "
                f"{d_cpu:.3e} on a {P_PREFIX}-token prefix")
        agree = int((runs["bfloat16"][0] == tokens).sum())
        say(f"  Run P(a) greedy tokens: bf16 equals f32 on {agree} of "
            f"{tokens.size}")
        # profile 8 decode steps after a prefill
        caches = lm.cache_init(cfg, a["batch"], a["max_len"], torch.float32,
                               dev)
        lg, caches = lm.prefill(model, inputs, cfg, caches)
        tok = lg.argmax(-1)

        def steps():
            nonlocal caches, tok
            for _ in range(P_PROFILE_STEPS):
                lg, caches = lm.decode_step(model, {"tokens": tok[:, None]},
                                            caches, cfg)
                tok = lg.argmax(-1)
        steps()
        rows = profile_solve(torch, f"Run P(a) f32, {P_PROFILE_STEPS} decode "
                             "steps", steps)
        if rows is not None:
            kernels = sum(c for n, (_, c) in rows.items()
                          if not n.startswith(("Memcpy", "Memset")))
            say(f"  Run P(a): {kernels / P_PROFILE_STEPS:.1f} kernel launches "
                f"a decode step ({kernels} over {P_PROFILE_STEPS}; "
                f"{cfg.num_layers} layers)")
    say(f"  Run P(a): peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del model, runs, logits, full
    gc.collect()
    torch.cuda.empty_cache()


def run_p_b(torch, np, lm, configs, Engine, ServeConfig, walls):
    """P(b): every other architecture at its published widths, depth cut."""
    b = P_B
    dev = torch.device("cuda")
    for arch in configs.ARCHS:
        if arch == P_A["arch"]:
            continue
        t0 = time.perf_counter()
        pub = configs.get(arch)
        cfg = dataclasses.replace(p_config(pub), dtype="float32")
        cfg_bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        cut = f"{pub.num_layers} → {cfg.num_layers} layers"
        if cfg.num_experts:
            cut += (f", capacity factor {pub.moe_capacity_factor} → "
                    f"{cfg.moe_capacity_factor}")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = lm.init_params(cfg, gen, dev)
        prompt = P_B_PROMPT.get(arch, b["prompt"])
        n = prompt + b["new"]
        seq = p_inputs(torch, np, cfg, b["batch"], n, SEED, dev)
        inputs = p_part(seq, 0, prompt)
        if prompt != b["prompt"]:
            cut += f", prompt {b['prompt']} → {prompt} tokens (chaotic)"
        with torch.inference_mode():
            if cfg.input_mode == "tokens":   # the engine's own tokens
                eng = Engine(model, cfg, ServeConfig(max_len=n,
                                                     batch_size=b["batch"]))
                tokens, logits = eng.generate(inputs["tokens"].cpu().numpy(),
                                              b["new"], return_logits=True)
                seq = p_seq(torch, inputs, tokens)
            else:
                logits = p_drive(torch, lm, model, cfg, seq, prompt, n)
            full, aux = lm.forward(model, seq, cfg)
            scale = full.abs().max()
            env = p_envelope(torch, lm, model, cfg, seq, full)
            lo = prompt - 1
            r_dec = p_within(torch, p_positions(torch, logits, full[:, lo:],
                                                scale), env[:, lo:])
            d_dec = p_rel(torch, logits, full[:, lo:])
            cpu_model = p_cpu_copy(torch, lm, model, cfg)
            d_cpu16, bar, cpu_fwd = p_bf16_bar(torch, lm, cpu_model, cfg, seq,
                                               lo, p_median)
            r_cpu = p_within(torch, p_positions(torch, full, cpu_fwd.to(dev),
                                                scale), env)
            d_cpu = p_rel(torch, full, cpu_fwd)
            del cpu_model
            bf16 = p_drive(torch, lm, model, cfg_bf16, seq, prompt, n)
            finite = bool(torch.isfinite(bf16).all())
            d_bf16 = p_median(torch, bf16, logits)
            d_bf16_max = p_rel(torch, bf16, logits)
        wall = time.perf_counter() - t0
        walls[f"P(b) {arch}"] = wall
        say(f"  Run P(b) {arch} ({cut}; d {cfg.d_model}, "
            f"{sum(p.numel() for p in model.parameters())} parameters): "
            f"f32 prefill and decode against forward {d_dec:.3e} ({r_dec:.3f}"
            f" of its bar), forward over the {n} positions card against CPU "
            f"{d_cpu:.3e} ({r_cpu:.3f} of its bar; bars max({P_F32_BAR:.0e}, "
            f"{P_ENVELOPE:g}× the one-ulp envelope, which reaches "
            f"{float(env.max()):.1e}); bf16 finite {finite}, prefill and decode "
            f"{d_bf16:.3e} from f32, median over positions (bar {bar:.3e} = "
            f"{P_BF16_FACTOR:g}× the CPU's forward at the same positions, "
            f"{d_cpu16:.3e}; maximum {d_bf16_max:.3e}); aux "
            f"{float(aux):.4f}; {wall:.1f} s")
        if arch in P_B_PROMPT:
            say("    per position (max over rows): envelope "
                + " ".join(f"{x:.0e}" for x in env.amax(0).tolist())
                + "; card against CPU " + " ".join(
                    f"{x:.0e}" for x in p_positions(
                        torch, full, cpu_fwd.to(dev), scale).amax(0).tolist())
                + "; decode against forward (from position "
                f"{lo}) " + " ".join(f"{x:.0e}" for x in p_positions(
                    torch, logits, full[:, lo:], scale).amax(0).tolist()))
        check(r_dec <= 1 and r_cpu <= 1, f"Run P(b) {arch}: f32 over its bar")
        check(finite and d_bf16 <= bar, f"Run P(b) {arch}: bf16 over its bar")
        del model, full, logits, bf16
        gc.collect()
        torch.cuda.empty_cache()


def run_p_c(torch, np, lm, configs, Engine, ServeConfig, walls):
    """P(c): mixtral's ring buffer past its window; zamba2's shared slot."""
    c = P_C
    dev = torch.device("cuda")
    pub = configs.get(c["arch"])
    cfg = dataclasses.replace(p_config(pub), dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    model = lm.init_params(cfg, gen, dev)
    n = c["prompt"] + c["new"]
    t0 = time.perf_counter()
    inputs = p_inputs(torch, np, cfg, 1, c["prompt"], SEED, dev)
    with torch.inference_mode():
        eng = Engine(model, cfg, ServeConfig(max_len=n, batch_size=1))
        tokens, logits = eng.generate(inputs["tokens"].cpu().numpy(),
                                      c["new"], return_logits=True)
        cache_len = lm.cache_init(cfg, 1, n, torch.float32, dev)[
            "body"][0]["slot0"]["k"].shape[1]
        full, _ = lm.forward(model, p_seq(torch, inputs, tokens), cfg)
        d = p_rel(torch, logits, full[:, c["prompt"] - 1:])
    walls["P(c) ring"] = time.perf_counter() - t0
    say(f"  Run P(c) {cfg.name} ({pub.num_layers} → 1 layer, capacity "
        f"factor {cfg.moe_capacity_factor}), window {cfg.sliding_window}: a "
        f"{c['prompt']}-token prompt into a {cache_len}-slot ring, "
        f"{c['new']} decode steps at slots "
        f"{c['prompt'] % cache_len}–{(n - 1) % cache_len}")
    p_check("Run P(c) f32 prefill and decode against the forward over "
            f"{n} tokens", d, P_F32_BAR, "f32 sums in other orders")
    del model, full, logits
    gc.collect()
    torch.cuda.empty_cache()

    pub = configs.get("zamba2-7b")
    periods = 2
    cfg = dataclasses.replace(p_config(pub, len(pub.prologue) + periods * len(
        pub.block_template)), dtype="float32")
    gen.manual_seed(SEED)
    model = lm.init_params(cfg, gen, dev)
    (si,) = cfg.shared_slots
    occ = [model.stack.layer(si, r) for r in range(cfg.repeats)]
    ptrs = {tuple(p.data_ptr() for p in layer.parameters()) for layer in occ}
    n_shared = sum(p.numel() for p in occ[0].parameters())
    with torch.inference_mode():
        inputs = p_inputs(torch, np, cfg, 1, 24, SEED, dev)
        caches = lm.cache_init(cfg, 1, 32, torch.float32, dev)
        _, caches = lm.prefill(model, inputs, cfg, caches)
        _, caches = lm.decode_step(model, {"tokens": inputs["tokens"][:, :1]},
                                   caches, cfg)
    ks = [caches["body"][r][f"slot{si}"]["k"] for r in range(cfg.repeats)]
    separate = (len({k.data_ptr() for k in ks}) == len(ks)
                and not torch.equal(ks[0], ks[1]))
    lengths = [caches["body"][r][f"slot{si}"]["length"]
               for r in range(cfg.repeats)]
    say(f"  Run P(c) {cfg.name} ({cfg.num_layers} layers: {periods} periods): "
        f"shared slot {si} one module at its {cfg.repeats} occurrences "
        f"({len(ptrs)} parameter storage set, {n_shared} parameters once in "
        f"the state dict: {sum(1 for k in model.state_dict() if k.startswith(f'stack.shared.slot{si}.'))} "
        f"entries); caches separate {separate}, lengths {lengths}")
    check(len(ptrs) == 1 and all(o is occ[0] for o in occ),
          "Run P(c): zamba2's shared slot is not one parameter storage")
    check(separate and lengths == [25] * cfg.repeats,
          "Run P(c): zamba2's shared slot's caches are not per occurrence")
    del model, caches, ks
    gc.collect()
    torch.cuda.empty_cache()


def run_p_driver(torch, walls):
    """P(d): the LM driver on the card, as a subprocess."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           P_A["arch"], "--batch", "4", "--prompt-len", "64", "--max-new",
           "32"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    walls["P(d) driver"] = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    say(f"  Run P(d) {' '.join(cmd[1:])}: exit {proc.returncode}, "
        f"{walls['P(d) driver']:.1f} s; first and last lines:")
    for ln in lines[:1] + lines[-1:]:
        say(f"    {ln}")
    check(proc.returncode == 0, "Run P(d): the driver failed: "
          + proc.stderr[-2000:])
    check(sum(ln.startswith("request ") for ln in lines) == 4
          and lines[-1].endswith("tok/s)"),
          "Run P(d): the driver did not answer 4 requests with a tok/s line")


def phase_lm_path(torch, np, ops, core):
    """Run P: LM serving, through repro_torch.serve.engine.Engine."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    say("phase 3, LM serving: repro_torch.serve.engine.Engine (Run P; no "
        "kernel of B1–B7 on this path)")
    say(f"  torch.backends.cuda.matmul.allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}, "
        f"allow_bf16_reduced_precision_reduction "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    start = time.perf_counter()
    walls = {}
    before = dict(ops.LAUNCHES)
    for run in (run_p_a, run_p_b, run_p_c):
        run(torch, np, lm, configs, Engine, ServeConfig, walls)
    check(ops.LAUNCHES == before, "Run P launched a kernel of B1–B7: "
          f"{before} → {ops.LAUNCHES}")
    run_p_driver(torch, walls)
    say(f"  Run P with its checks: {time.perf_counter() - start:.1f} s of "
        "wall in all")
    return {}, walls


# ---------------------------------------------------------------------------
# phase 3, training: Run Q
# ---------------------------------------------------------------------------

# bf16 against f32 is compared on the batch's first row and first
# ``bf16_seq`` tokens, on the card and on the CPU (whose bf16 step is slow:
# 4.8 s for 64 tokens on one host, 52.5 s on another; 32 since Run R joined
# the script, which took 1180 s of its 1200 s limit on the slower host)
# smollm-360m at its published widths, 16 of its 32 layers (all 32 took
# the CPU's f32 step 20.0 s and Run Q 237 s, the script at its limit)
Q_A = dict(arch="smollm-360m", layers=16, batch=8, seq=256, overfit=10,
           bf16_seq=32)
Q_B = dict(batch=2, seq=32)
Q_LR = 1e-3
# f32 train step, card against CPU: the scalars (loss, ce, grad_norm, lr)
# and the new moments m and v, each relative to its largest entry (v, a
# square of the gradient, at twice the bar).  The same f32 arithmetic
# summed in other orders (cuBLAS against the CPU's BLAS) over 32 layers
# forward and back; TF32 rounds every product's operands to 10 bits and
# must land outside.  The new parameters: where the gradient is neither
# within the bar of zero nor near AdamW's eps, within bar·(lr + |p|)
# (AdamW's first step moves a parameter by lr·g/(|g| + eps), ±lr whatever
# |g| is, so two gradients a rounding apart that straddle zero differ by
# 2·lr there; tests/_torch_train.py).
Q_F32_BAR = 1e-4
# The FGW term's f32 gradient: two f32 evaluations sit up to 1.4e-3 of a
# parameter's largest gradient from the f64 one (tests/train_spreads.py),
# the CPU tests' bar: the kernels' step against the plain route's.
Q_GW_BAR = 3e-3
# 5 steps, a checkpoint every 5 (the run's end only), SIGTERM after step
# 2's line: the stop lands at step 3 or 4 (the step in flight finishes
# first), which only the SIGTERM handler's save can write.  At Q(a)'s
# 16 layers (`--layers`; each save ~2.5 GB, 32 layers' 4.35 GB)
Q_DRIVER = dict(steps=5, ckpt_every=5, stop_after=2)


def q_tcfg(loop, optim, **kw):
    base = dict(microbatches=1, remat=False, optimizer=optim.OptimizerConfig(
        lr=Q_LR, warmup_steps=1, total_steps=100))
    base.update(kw)
    return loop.TrainConfig(**base)


def q_state(torch, lm, loop, optim, cfg, init, dev, tcfg):
    """A fresh train state on ``dev``: copies of ``init`` (name → tensor)
    and zero moments."""
    model = lm.LM(cfg, None, device="meta")
    model.load_state_dict({k: v.detach().to(dev, copy=True)
                           for k, v in init.items()}, strict=True,
                          assign=True)
    return loop.TrainState(model, optim.init(dict(model.named_parameters()),
                                             tcfg.optimizer), 0)


def q_step(torch, loop, state, batch, cfg, tcfg):
    """One train step with the launch counts and the device's peak memory
    read around it: (metrics, wall s, peak GiB, GiB held before it; NaN
    for a step on the CPU)."""
    cuda = next(iter(state.params().values())).is_cuda
    if cuda:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    metrics = loop.train_step(state, batch, cfg, tcfg)
    if cuda:
        torch.cuda.synchronize()
        return (metrics, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 2**30, held)
    return metrics, time.perf_counter() - t0, math.nan, math.nan


def q_rel(torch, got, want) -> float:
    """max |got − want| over max |want| (want's device)."""
    want = want.detach().float()
    got = got.detach().float().to(want.device)
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def q_scalars(torch, got, want, keys=("loss", "ce", "grad_norm", "lr")):
    return max(q_rel(torch, got[k], want[k]) for k in keys)


def q_moments(torch, got, want, dist=None):
    """(m's, v's largest per-tensor distance, the worst tensor of m)."""
    dist = dist or q_rel
    dm = {k: dist(torch, got.opt.m[k], v) for k, v in want.opt.m.items()}
    dv = max(dist(torch, got.opt.v[k], v) for k, v in want.opt.v.items())
    worst = max(dm, key=dm.get)
    return dm[worst], dv, worst


def q_params(torch, got, want, bar, eps=1e-8):
    """The largest |Δp| / (bar·(lr + |p|)) over the entries whose gradient
    (m) is neither within ``bar`` of zero nor near eps; ≤ 1 passes."""
    worst = 0.0
    gp = got.params()
    for k, p in want.params().items():
        m = want.opt.m[k].abs()
        away = m > max(bar * float(m.max()), 0.1 * 1e3 * eps)
        if not bool(away.any()):
            continue
        p = p.detach()
        d = (gp[k].detach().to(p.device) - p).abs()[away]
        worst = max(worst, float((d / (bar * (Q_LR + p.abs()[away]))).max()))
    return worst


def q_median_moment(torch, got, want):
    """The median over tensors of m's distance relative to its largest
    entry (a bf16 step's rounding sets a few tensors' maxima)."""
    d = sorted(q_rel(torch, got.opt.m[k], v) for k, v in
               want.opt.m.items())
    return d[len(d) // 2]


def q_batch(np, pipeline, cfg, batch, seq):
    return pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=SEED)).batch(0)


def run_q_a(torch, np, ops, core, lm, loop, optim, pipeline, configs, add,
            walls):
    """Q(a): smollm-360m at its published config through train_step."""
    a = Q_A
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(configs.get(a["arch"]), dtype="float32",
                              num_layers=a["layers"])
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    init = {k: v.detach() for k, v in
            lm.init_params(cfg, gen, dev).state_dict().items()}
    n_params = sum(v.numel() for v in init.values())
    batch = q_batch(np, pipeline, cfg, a["batch"], a["seq"])
    tokens = a["batch"] * a["seq"]
    tcfg = q_tcfg(loop, optim)
    say(f"  Run Q(a) {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {cfg.vocab_size}; "
        f"{n_params} parameters; batch {a['batch']} × {a['seq']} tokens of "
        f"SyntheticLM (seed {SEED}, step 0); AdamW lr {Q_LR}, one step from "
        "the same state unless said")

    # f32: card, CPU, TF32 control
    st32 = q_state(torch, lm, loop, optim, cfg, init, dev, tcfg)
    m32, wall32, peak32, held32 = q_step(torch, loop, st32, batch, cfg, tcfg)
    walls["Q(a) f32 step"] = wall32
    say(f"  Run Q(a) f32 step on the card: {wall32:.3f} s, "
        f"{tokens / wall32:.0f} tokens/s, peak {peak32:.3f} GiB ({held32:.3f}"
        f" held before it); loss {float(m32['loss']):.6f}, ce "
        f"{float(m32['ce']):.6f}, grad_norm {float(m32['grad_norm']):.6f}, "
        f"lr {float(m32['lr']):.3e}")
    cpu_st = q_state(torch, lm, loop, optim, cfg, init, cpu, tcfg)
    mc, wall_c, _, _ = q_step(torch, loop, cpu_st, batch, cfg, tcfg)
    walls["Q(a) CPU f32 step"] = wall_c
    d_s = q_scalars(torch, m32, mc)
    d_m, d_v, worst = q_moments(torch, st32, cpu_st)
    r_p = q_params(torch, st32, cpu_st, Q_F32_BAR)
    say(f"  Run Q(a) f32, card against the CPU's step ({wall_c:.1f} s): "
        f"scalars {d_s:.3e}, m {d_m:.3e} (worst {worst}), v {d_v:.3e}, "
        f"parameters {r_p:.3f} of their bar")
    p_check("Run Q(a) f32 scalars and m, card against CPU", max(d_s, d_m),
            Q_F32_BAR, "f32 sums in other orders")
    p_check("Run Q(a) f32 v, card against CPU", d_v, 2 * Q_F32_BAR,
            "a square of the gradient")
    p_check("Run Q(a) f32 parameters, card against CPU (ratio to the bar)",
            r_p, 1.0, "bar·(lr + |p|) away from g = 0")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st_tf = q_state(torch, lm, loop, optim, cfg, init, dev, tcfg)
        mt, walls["Q(a) TF32 step"], _, _ = q_step(torch, loop, st_tf, batch,
                                                   cfg, tcfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d_tf = max(q_scalars(torch, mt, mc), q_moments(torch, st_tf, cpu_st)[0])
    say(f"  Run Q(a) TF32 control: the step with TF32 on, {d_tf:.3e} from "
        f"the CPU's (must exceed the f32 bar {Q_F32_BAR:.1e})")
    check(d_tf > Q_F32_BAR, "Run Q(a): a TF32 step passes the f32 bar, "
          "which then cannot tell f32 from TF32")
    del st_tf, cpu_st

    # bf16 against f32: on the card at full batch, and the bar from the
    # CPU's own bf16-against-f32 distance on the batch's first rows
    small = {k: v[:1, :a["bf16_seq"]] for k, v in batch.items()}
    dists = {}
    for where, d in (("CPU", cpu), ("card", dev)):
        sts = {}
        t0 = time.perf_counter()
        for c in (cfg, cfg16):
            sts[c.dtype] = q_state(torch, lm, loop, optim, c, init, d, tcfg)
            sts[c.dtype + " metrics"] = q_step(torch, loop, sts[c.dtype],
                                               small, c, tcfg)[0]
        walls[f"Q(a) {where} f32 and bf16 steps on 1 × {a['bf16_seq']}"] \
            = time.perf_counter() - t0
        dists[where] = (q_rel(torch, sts["bfloat16 metrics"]["loss"],
                              sts["float32 metrics"]["loss"]),
                        q_median_moment(torch, sts["bfloat16"],
                                        sts["float32"]))
        del sts
    st16 = q_state(torch, lm, loop, optim, cfg16, init, dev, tcfg)
    m16, wall16, peak16, held16 = q_step(torch, loop, st16, batch, cfg16,
                                         tcfg)
    walls["Q(a) bf16 step"] = wall16
    full16 = (q_rel(torch, m16["loss"], m32["loss"]),
              q_median_moment(torch, st16, st32))
    say(f"  Run Q(a) bf16 step on the card: {wall16:.3f} s, "
        f"{tokens / wall16:.0f} tokens/s, peak {peak16:.3f} GiB "
        f"({held16:.3f} held before it); loss {float(m16['loss']):.6f}; "
        f"from f32: loss {full16[0]:.3e}, m's median tensor {full16[1]:.3e}")
    for i, what in enumerate(("loss", "m's median tensor")):
        p_check(f"Run Q(a) bf16 against f32 on 1 × {a['bf16_seq']} tokens, "
                f"{what}", dists["card"][i],
                P_BF16_FACTOR * dists["CPU"][i],
                f"{P_BF16_FACTOR:g}× the CPU's {dists['CPU'][i]:.3e}")
    check(all(math.isfinite(float(v)) for v in m16.values()),
          "Run Q(a): a bf16 metric is not finite")
    del st16

    # microbatches and remat
    for label, kw in (("2 microbatches", dict(microbatches=2)),
                      ("remat", dict(remat=True))):
        t = q_tcfg(loop, optim, **kw)
        st = q_state(torch, lm, loop, optim, cfg, init, dev, t)
        mk, wall, peak, held = q_step(torch, loop, st, batch, cfg, t)
        walls[f"Q(a) f32 {label}"] = wall
        # ce and aux are the last microbatch's (the reference's metrics)
        d = max(q_scalars(torch, mk, m32, ("loss", "grad_norm", "lr")),
                q_moments(torch, st, st32)[0])
        say(f"  Run Q(a) f32 {label}: {wall:.3f} s, peak {peak:.3f} GiB "
            f"({held:.3f} held before it), {d:.3e} from one microbatch "
            "without remat (loss, grad_norm, lr and m)")
        p_check(f"Run Q(a) {label} against the plain step", d, Q_F32_BAR,
                "f32 sums in other orders")
        if label == "remat":
            # what the step adds to the memory held before it
            say(f"  Run Q(a) remat's step adds {peak - held:.3f} GiB to what "
                f"is held, against {peak32 - held32:.3f} without")
            check(peak - held < peak32 - held32,
                  "Run Q(a): remat does not lower the step's peak")
        del st

    # the FGW term: kernels against plain, and against no term
    gen.manual_seed(SEED + 1)
    teacher = lm.init_params(cfg, gen, dev)
    with torch.inference_mode():
        _, _, hid = lm.forward(teacher, loop.to_device(batch, dev), cfg,
                               return_hidden=True)
    gw_batch = dict(batch, teacher_h=hid.float().clone())
    del teacher, hid
    out = {}
    for route, backend in (("kernels", "auto"), ("plain", "torch")):
        t = q_tcfg(loop, optim, gw_align_weight=0.5, gw_align=(
            dataclasses.replace(loop.TrainConfig().gw_align,
                                sinkhorn_backend=backend)))
        st = q_state(torch, lm, loop, optim, cfg, init, dev, t)
        with Recorded(core.sinkhorn, "_chunked_loop") as loops, \
                Recorded(core.solver, "neumann_series") as series:
            (mk, wall, peak, _), counts, _ = run_path(
                torch, ops, f"Run Q(a) f32 step with the FGW term, {route}",
                lambda: q_step(torch, loop, st, gw_batch, cfg, t))
        walls[f"Q(a) FGW {route}"] = wall
        sweeps = sum(max(used, default=0) for _, used in loops.out)
        terms = [n for _, n in series.out]
        out[route] = (mk, st, counts)
        say(f"  Run Q(a) FGW {route}: {wall:.3f} s, peak {peak:.3f} GiB, "
            f"gw_align {float(mk['gw_align']):.6f}, loss "
            f"{float(mk['loss']):.6f}; {sweeps} inner updates a side, "
            f"Neumann terms {terms}")
        if route == "kernels":
            add(counts)
            g = t.gw_align
            want = {k: 0 for k in counts}
            want.update(sinkhorn_row_update=g.outer_iters * g.sinkhorn_iters,
                        sinkhorn_col_update=g.outer_iters * g.sinkhorn_iters)
            say(f"  Run Q(a) FGW launches {counts}, expected {want} (outer "
                f"steps × Sinkhorn steps, one launch an update for the "
                f"{a['batch']} lanes; the backward launches none)")
            check(counts == want and sweeps == want["sinkhorn_row_update"],
                  "Run Q(a): the FGW term's launches differ from the code's")
        else:
            check(sum(counts.values()) == 0, "Run Q(a): the plain route "
                  "launched a kernel")
    (mk, stk, _), (mp, stp, _) = out["kernels"], out["plain"]
    d_gw = max(q_scalars(torch, mk, mp, ("loss", "ce", "grad_norm",
                                         "gw_align")),
               q_moments(torch, stk, stp)[0])
    p_check("Run Q(a) FGW step, kernels against plain", d_gw, Q_GW_BAR,
            "the f32 implicit gradient's spread")
    with torch.no_grad():
        moved = float(optim.global_norm({k: p - st32.params()[k] for k, p
                                         in stk.params().items()}))
    say(f"  Run Q(a) FGW: the parameters {moved:.3e} (global norm) from the "
        "step without the term")
    check(math.isfinite(float(mk["gw_align"])) and moved > 0,
          "Run Q(a): the FGW term is not finite or moves nothing")
    del out, stk, stp, st32

    # ten bf16 steps overfitting the batch, timed; one more profiled
    st = q_state(torch, lm, loop, optim, cfg16, init, dev, tcfg)
    ces, ts = [], []
    for _ in range(a["overfit"]):
        mk, wall, peak, _ = q_step(torch, loop, st, batch, cfg16, tcfg)
        ces.append(float(mk["ce"]))
        ts.append(wall)
    walls["Q(a) 10 bf16 steps"] = sum(ts)
    med = sorted(ts[1:])[len(ts[1:]) // 2]
    say(f"  Run Q(a) {a['overfit']} bf16 steps on one batch: ce "
        + " ".join(f"{c:.4f}" for c in ces) + f"; step walls "
        + " ".join(f"{t * 1e3:.1f}" for t in ts) + f" ms (median after the "
        f"first {med * 1e3:.1f} ms, {tokens / med:.0f} tokens/s), peak "
        f"{peak:.3f} GiB")
    check(ces[-1] < ces[0] and all(math.isfinite(c) for c in ces),
          "Run Q(a): ce does not fall over ten steps on one batch")
    ts = [q_step(torch, loop, st, batch, cfg, tcfg)[1] for _ in range(3)]
    walls["Q(a) 3 f32 steps"] = sum(ts)
    med = sorted(ts)[1]
    say(f"  Run Q(a) 3 more steps in f32: " + " ".join(
        f"{t * 1e3:.1f}" for t in ts) + f" ms (median {med * 1e3:.1f} ms, "
        f"{tokens / med:.0f} tokens/s)")
    # one profiled step in the config's own dtype (the profiler's
    # processing of a step's ~14 000 device activities takes ~10 s)
    t0 = time.perf_counter()
    rows = profile_solve(torch, "Run Q(a) one bf16 step", lambda:
                         loop.train_step(st, batch, cfg16, tcfg))
    if rows is not None:
        kernels = sum(n for name, (_, n) in rows.items()
                      if not name.startswith(("Memcpy", "Memset")))
        say(f"  Run Q(a) bf16: {kernels} kernel launches a step")
    walls["Q(a) profiled step"] = time.perf_counter() - t0
    del st, init
    gc.collect()
    torch.cuda.empty_cache()


def q_nudge_(torch, params, seed):
    """Move every weight of ``params`` one ulp up or down (seeded), in
    place."""
    gen = torch.Generator(device=next(iter(params.values())).device)
    gen.manual_seed(seed)
    for p in params.values():
        up = torch.randint(0, 2, p.shape, generator=gen,
                           device=p.device).bool()
        p.copy_(torch.nextafter(p, torch.where(up, math.inf, -math.inf).to(
            p.dtype)))


def q_grads(torch, lm, loop, optim, cfg, params, batch, tcfg):
    """A forward and backward on ``params`` (name → tensor, taken into a
    model on their device): (loss, grad_norm, name → gradient, the clip
    scale)."""
    dev = next(iter(params.values())).device
    model = lm.LM(cfg, None, device="meta")
    model.load_state_dict(params, strict=True, assign=True)
    loss, _ = loop._microbatch_loss(model, loop.to_device(batch, dev), cfg,
                                    tcfg)
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    norm = optim.global_norm(grads)
    return (loss.detach(), norm, grads,
            optim.clip_scale(norm, tcfg.optimizer.grad_clip))


def q_first_moment(g, scale, b1):
    """The first moment AdamW's first step holds: (g·s)·(1 − b1), the
    optimizer's own expression from zero moments."""
    return (g * scale) * (1 - b1)


def run_q_b(torch, np, lm, loop, optim, configs, walls):
    """Q(b): every other architecture at its published widths, depth cut
    as in P(b): one train step on the card against the CPU's forward and
    backward (the first moment its step would hold), each tensor within
    max(Q_F32_BAR, P_ENVELOPE × its one-ulp envelope), measured on the
    card from the same weights moved one ulp.  The card holds one step's
    state, then the moments and the envelope's gradients: a 2.9 · 10⁹-
    parameter model's step needs ~58 GiB."""
    b = Q_B
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    tcfg = q_tcfg(loop, optim)
    b1 = tcfg.optimizer.b1
    for arch in configs.ARCHS:
        if arch == Q_A["arch"]:
            continue
        t0 = time.perf_counter()
        pub = configs.get(arch)
        cfg = dataclasses.replace(p_config(pub), dtype="float32")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model = lm.init_params(cfg, gen, dev)
        params = dict(model.named_parameters())
        n_params = sum(v.numel() for v in params.values())
        cpu_init = {k: v.detach().to(cpu, copy=True)
                    for k, v in params.items()}
        batch = p_inputs(torch, np, cfg, b["batch"], b["seq"], SEED, dev)
        batch["labels"] = torch.tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (b["batch"], b["seq"])), device=dev)
        st = loop.TrainState(model, optim.init(params, tcfg.optimizer), 0)
        mk, wall, peak, held = q_step(torch, loop, st, batch, cfg, tcfg)
        m_card = st.opt.m
        del model, params, st
        gc.collect()
        torch.cuda.empty_cache()
        # the envelope: the weights one ulp away, on the card
        nudged = {k: v.to(dev, copy=True) for k, v in cpu_init.items()}
        q_nudge_(torch, nudged, SEED)
        le, ne, ge, se = q_grads(torch, lm, loop, optim, cfg, nudged, batch,
                                 tcfg)
        env = {k: q_rel(torch, q_first_moment(g, se, b1), m_card[k])
               for k, g in ge.items()}
        env_s = max(q_rel(torch, le, mk["loss"]),
                    q_rel(torch, ne, mk["grad_norm"]))
        del nudged, ge
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        lc, nc, gcpu, sc = q_grads(torch, lm, loop, optim, cfg, cpu_init,
                                   batch, tcfg)
        # the CPU's gradients moved to the card, where (g·s)·(1 − b1), two
        # correctly rounded products, has the CPU's bits and costs no CPU
        # pass over the model
        sc = sc.to(dev)
        ratio = {k: q_rel(torch, m_card[k], q_first_moment(g.to(dev), sc, b1))
                 / max(Q_F32_BAR, P_ENVELOPE * env[k])
                 for k, g in gcpu.items()}
        t_cpu = time.perf_counter() - t1
        worst = max(ratio, key=ratio.get)
        d_s = max(q_rel(torch, mk["loss"], lc),
                  q_rel(torch, mk["grad_norm"], nc))
        r_s = d_s / max(Q_F32_BAR, P_ENVELOPE * env_s)
        wall_all = time.perf_counter() - t0
        walls[f"Q(b) {arch}"] = wall_all
        say(f"  Run Q(b) {arch} ({pub.num_layers} → {cfg.num_layers} layers"
            f"; {n_params} parameters; {b['batch']} × {b['seq']} tokens): "
            f"step {wall:.3f} s, peak {peak:.3f} GiB ({held:.3f} held); "
            f"loss {float(mk['loss']):.6f}; card against the CPU's forward "
            f"and backward ({t_cpu:.1f} s): loss and grad_norm {d_s:.3e} "
            f"({r_s:.3f} of the bar, envelope {env_s:.1e}), m's worst "
            f"tensor {ratio[worst]:.3f} of its bar ({worst}, envelope "
            f"{env[worst]:.1e}; the largest envelope "
            f"{max(env.values()):.1e}); {wall_all:.1f} s")
        check(r_s <= 1 and ratio[worst] <= 1,
              f"Run Q(b) {arch}: the step over its bar")
        check(all(math.isfinite(float(v)) for v in mk.values()),
              f"Run Q(b) {arch}: a metric is not finite")
        del m_card, cpu_init, gcpu
        gc.collect()
        torch.cuda.empty_cache()


def q_leaves(root, step):
    d = Path(root) / f"step_{step:08d}"
    man = json.loads((d / "manifest.json").read_text())
    return {e["key"]: d / e["file"] for e in man["leaves"]}


def run_q_driver(torch, np, walls):
    """Q(c): the train driver on the card, as subprocesses: a run stopped
    by SIGTERM after step Q_DRIVER["stop_after"] and resumed, against an
    uninterrupted one; then the LM driver serving the checkpoint."""
    import shutil
    import signal
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    q = Q_DRIVER
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           Q_A["arch"], "--layers", str(Q_A["layers"]), "--steps",
           str(q["steps"]), "--ckpt-every",
           str(q["ckpt_every"]), "--log-every", "1", "--deterministic"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="run_q_"))
    procs = []
    try:
        # the uninterrupted run beside the interrupted one, on the same card
        t0 = t_whole = time.perf_counter()
        whole = subprocess.Popen(cmd + ["--ckpt-dir", str(tmp / "whole")],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        procs.append(whole)
        cut = tmp / "cut"
        proc = subprocess.Popen(cmd + ["--ckpt-dir", str(cut)], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        for ln in proc.stdout:
            if ln.startswith(f"step {q['stop_after']:5d} "):
                proc.send_signal(signal.SIGTERM)
                break
        rest, err = proc.communicate(timeout=300)
        walls["Q(c) stopped"] = time.perf_counter() - t0
        landed = CheckpointManager(str(cut)).latest_step()
        say(f"  Run Q(c) {' '.join(cmd[1:])}, twice at once: one stopped by "
            f"SIGTERM after step {q['stop_after']}'s line, exit "
            f"{proc.returncode}, checkpoint at step {landed} "
            f"({walls['Q(c) stopped']:.1f} s)")
        check(proc.returncode == 143 and landed is not None
              and q["stop_after"] <= landed < q["steps"],
              "Run Q(c): SIGTERM did not land a checkpoint: " + err[-2000:])
        t0 = time.perf_counter()
        again = subprocess.run(cmd + ["--ckpt-dir", str(cut)], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=300)
        walls["Q(c) resumed"] = time.perf_counter() - t0
        say(f"  Run Q(c) the same command again: exit {again.returncode}, "
            f"{walls['Q(c) resumed']:.1f} s; "
            + "; ".join(ln for ln in again.stdout.splitlines()
                        if ln.startswith("resumed")))
        check(again.returncode == 0 and f"resumed from checkpoint step "
              f"{landed}" in again.stdout, "Run Q(c): the resume failed: "
              + again.stderr[-2000:])
        out, err = whole.communicate(timeout=300)
        walls["Q(c) uninterrupted"] = time.perf_counter() - t_whole
        lines = out.splitlines()
        say(f"  Run Q(c) the uninterrupted run: exit {whole.returncode}, "
            f"{walls['Q(c) uninterrupted']:.1f} s from its start; first and "
            "last lines:")
        for ln in lines[:2] + lines[-2:]:
            say(f"    {ln}")
        check(whole.returncode == 0, "Run Q(c): the train driver failed: "
              + err[-2000:])
        got, want = q_leaves(cut, q["steps"]), q_leaves(tmp / "whole",
                                                         q["steps"])
        same = sum(np.array_equal(np.load(got[k]), np.load(want[k]))
                   for k in want)
        say(f"  Run Q(c) final state (step {q['steps']}): {same} of "
            f"{len(want)} leaves (parameters, moments, step counts) the "
            "uninterrupted run's bits (both runs under "
            "torch.use_deterministic_algorithms)")
        check(got.keys() == want.keys() and same == len(want),
              "Run Q(c): the resumed run's final state is not the "
              "uninterrupted run's")
        serve = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                 Q_A["arch"], "--layers", str(Q_A["layers"]), "--ckpt-dir",
                 str(cut), "--batch", "4",
                 "--prompt-len", "64", "--max-new", "16"]
        t0 = time.perf_counter()
        proc = subprocess.run(serve, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        walls["Q(c) serve"] = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        say(f"  Run Q(c) {' '.join(serve[1:5])} --ckpt-dir <the resumed "
            f"run's> ...: exit {proc.returncode}, {walls['Q(c) serve']:.1f} "
            "s; " + "; ".join(lines[:1] + lines[-1:]))
        check(proc.returncode == 0 and lines[0] == "restored params from "
              f"step {q['steps']}" and sum(ln.startswith("request ")
                                           for ln in lines) == 4,
              "Run Q(c): the LM driver did not serve the checkpoint: "
              + proc.stderr[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_train_path(torch, np, ops, core):
    """Run Q: training, through repro_torch.train.loop.train_step."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    from repro_torch.train import loop
    from repro_torch.train import optimizer as optim

    say("phase 3, training: repro_torch.train.loop.train_step (Run Q; B1/B2 "
        "under the FGW distillation term, no other kernel)")
    start = time.perf_counter()
    walls = {}
    launches = {k: 0 for k in ops.LAUNCHES}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    run_q_a(torch, np, ops, core, lm, loop, optim, pipeline, configs, add,
            walls)
    before = dict(ops.LAUNCHES)
    run_q_b(torch, np, lm, loop, optim, configs, walls)
    check(ops.LAUNCHES == before, "Run Q(b) launched a kernel of B1–B7")
    run_q_driver(torch, np, walls)
    say(f"  Run Q with its checks: {time.perf_counter() - start:.1f} s of "
        "wall in all")
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, the sharded path: Run R
# ---------------------------------------------------------------------------

# smollm-360m at its published widths, depth cut to 4 of its 32 layers
# and the sharded decode to 8 steps, Run Q(a)'s batch: with all 32 layers
# Run R took ~150 s on one card (228 s on four), at 8 layers and 16 decode
# steps 65.6 s, and the script, with Run S after it, its whole 1200 s
R_LAYERS = 4
R_STEPS = 3
R_DECODE = dict(batch=4, prompt=64, new=8)
R_MAX_WORLD = 4
R_TIMEOUT = 900
# the gathered step's gradients are bf16 values, and a data-sharded batch
# rounds each shard's partial gradient to bf16 before the sum: two bf16
# roundings (tests/test_torch_sharded.py's GATHER_BF16)
R_GATHER_BAR = 2 * 2.0 ** -8
R_SCALARS = ("loss", "ce", "grad_norm", "gw_align")
R_A_PRIME: list = []   # each rank's R(a′) collectives and added bytes


def r_meshes(world):
    """(mesh shape, strategy) of each sharded run on ``world`` cards."""
    if world >= 4:
        return [((2, 2), "2d"), ((4, 1), "dp")]
    if world > 1:
        return [((1, world), "2d"), ((world, 1), "dp")]
    return [((1, 1), "2d")]


def r_full(torch, t):
    """A tensor whole: a DTensor's full_tensor() (every rank must call)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def r_state_fulls(torch, st):
    """(params, m, v) of a state as whole tensors on this rank's card."""
    return ({k: r_full(torch, p).detach() for k, p in st.params().items()},
            {k: r_full(torch, v) for k, v in st.opt.m.items()},
            {k: r_full(torch, v) for k, v in st.opt.v.items()})


def r_holder(fulls):
    """Whole tensors (params, m, v) in the shape of a train state."""
    params, m, v = fulls
    return types.SimpleNamespace(params=lambda: params,
                                 opt=types.SimpleNamespace(m=m, v=v))


def r_distance(torch, got, want_st, bar):
    """(m's largest per-tensor distance, v's, the parameters' ratio to
    bar·(lr + |p|) where the gradient is away from zero) of whole tensors
    ``got`` against a one-card state."""
    _, m, v = got
    dm = max(q_rel(torch, m[k], w) for k, w in want_st.opt.m.items())
    dv = max(q_rel(torch, v[k], w) for k, w in want_st.opt.v.items())
    return dm, dv, q_params(torch, r_holder(got), want_st, bar)


def r_collectives(torch, prof, collectives):
    """The profiled step's collectives by kind (count, payload and wire
    bytes) and the NCCL kernels' share of its device kernel time."""
    by = {}
    trace = collectives.chrome_trace(prof)
    done = collectives.ops(trace)
    for o in done:
        c = by.setdefault(o["kind"], [0, 0.0, 0.0])
        c[0] += 1
        c[1] += o["payload_bytes"]
        c[2] += o["wire_bytes"]
    dev = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    total = sum(e.get("dur", 0) for e in dev)
    nccl = sum(e.get("dur", 0) for e in dev if "nccl" in e["name"].lower())
    bf16 = sum(o["kind"] == "all-gather" and o["dtype"] == "c10::BFloat16"
               for o in done)
    top = sorted(done, key=lambda o: -o["payload_bytes"])[:4]
    by["largest"] = [f"{o['kind']} {o['dtype']} "
                     f"{o['payload_bytes'] / 2**20:.1f} MiB" for o in top]
    return by, (nccl / total if total else math.nan), total / 1e3, bf16


def r_rank(out_dir):
    """One rank of Run R (``torch.distributed.run`` starts one a card):
    the sharded steps, the gather, the moments' bytes, the elastic
    restore and the sharded decode; rank 0 also runs the one-card
    references and holds every comparison.  Writes rank<r>.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import collectives, dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import loop
    from repro_torch.train import optimizer as optim

    rank = mesh_mod.init_distributed("cuda")
    world = dist.get_world_size()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"bars": [], "facts": [], "launches": {k: 0 for k in ops.LAUNCHES},
           "walls": {}}
    lead = rank == 0

    def note(text):
        if lead:
            print(text, flush=True)

    def bar(label, value, limit, why):
        if lead:
            out["bars"].append([label, float(value), float(limit), why])

    def fact(ok, text):
        if lead:
            out["facts"].append([bool(ok), text])

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    cfg = dataclasses.replace(configs.get("smollm-360m"), dtype="float32",
                              num_layers=R_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    init = {k: v.detach() for k, v in
            lm.init_params(cfg, gen, dev).state_dict().items()}
    batch = q_batch(np, pipeline, cfg, Q_A["batch"], Q_A["seq"])
    gen.manual_seed(SEED + 1)
    teacher = lm.init_params(cfg, gen, dev)
    with torch.inference_mode():
        _, _, hid = lm.forward(teacher, loop.to_device(batch, dev), cfg,
                               return_hidden=True)
    gw_batch = dict(batch, teacher_h=hid.float().cpu().clone())
    del teacher, hid
    tcfg = q_tcfg(loop, optim, gw_align_weight=0.5)
    g = tcfg.gw_align
    per_step = g.outer_iters * g.sinkhorn_iters
    meshes = r_meshes(world)
    note(f"  Run R {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
         f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
         f"{cfg.vocab_size}, f32; {world} NCCL rank(s), one a card; Run "
         f"Q(a)'s batch ({Q_A['batch']} × {Q_A['seq']}) with the FGW term "
         f"(weight 0.5, teacher states of a second seeded model), "
         f"{R_STEPS} steps on " + ", ".join(
             f"({a}, {b}) \"{s}\"" for (a, b), s in meshes)
         + " against the same steps on one card unsharded")

    # one-card references (rank 0)
    ref, ref1, ref_metrics = None, None, []
    if lead:
        ref = q_state(torch, lm, loop, optim, cfg, init, dev, tcfg)
        for i in range(R_STEPS):
            m_, wall, peak, _ = q_step(torch, loop, ref, gw_batch, cfg, tcfg)
            ref_metrics.append({k: float(v) for k, v in m_.items()})
            out["walls"][f"R one card step {i + 1}"] = wall
            if i == 0:      # the one-step parameter rule holds here only
                ref1 = r_holder(tuple({k: t.detach().clone() for k, t in
                                       d.items()} for d in (
                    ref.params(), ref.opt.m, ref.opt.v)))
        # the envelope: the same steps from the weights moved one ulp.  The
        # FGW term's f32 implicit gradient amplifies a rounding, and after
        # the first step two states part where AdamW's ±lr moves straddle
        # zero: the steps are held to P_ENVELOPE × this distance
        nudged = {k: v.clone() for k, v in init.items()}
        q_nudge_(torch, nudged, SEED)
        env = q_state(torch, lm, loop, optim, cfg, nudged, dev, tcfg)
        del nudged
        env_s = []
        for i in range(R_STEPS):
            m_ = loop.train_step(env, gw_batch, cfg, tcfg)
            env_s.append(max(abs(float(m_[k]) - ref_metrics[i][k])
                             / max(abs(ref_metrics[i][k]), 1e-30)
                             for k in R_SCALARS))
            if i == 0:
                env_m1, env_v1, _ = r_distance(
                    torch, r_state_fulls(torch, env), ref1, Q_GW_BAR)
        env_m, env_v, _ = r_distance(torch, r_state_fulls(torch, env), ref,
                                     Q_GW_BAR)
        del env
        gc.collect()
        torch.cuda.empty_cache()
        note("  Run R one card from the weights moved one ulp (the "
             "envelope): scalars " + " ".join(f"{e:.3e}" for e in env_s)
             + f" at steps 1–{R_STEPS}; after step 1: m {env_m1:.3e}, v "
             f"{env_v1:.3e}; after step {R_STEPS}: m {env_m:.3e}, v "
             f"{env_v:.3e}")
        # the bars of one step from one state (R(a)'s first, R(d)'s next)
        one_step = dict(
            s=(max(Q_F32_BAR, P_ENVELOPE * env_s[0]),
               f"max(1e-4, {P_ENVELOPE:g}× the one-ulp envelope "
               f"{env_s[0]:.1e})"),
            m=(max(Q_GW_BAR, P_ENVELOPE * env_m1),
               f"max(3e-3, {P_ENVELOPE:g}× the envelope {env_m1:.1e})"),
            v=(max(2 * Q_GW_BAR, P_ENVELOPE * env_v1),
               f"max(6e-3, {P_ENVELOPE:g}× the envelope {env_v1:.1e})"))
        out["ref_peak_gib"] = peak
        note(f"  Run R one card, unsharded: step walls " + " ".join(
            f"{out['walls'][f'R one card step {i + 1}']:.3f}"
            for i in range(R_STEPS)) + f" s, peak {peak:.3f} GiB")
    sync()

    # lanes each rank solves in the FGW term
    lanes = []
    real = loop.gw_losses.fgw_alignment_loss_batch

    def counted(h, *a, **kw):
        lanes.append(int(h.shape[0]))
        return real(h, *a, **kw)
    loop.gw_losses.fgw_alignment_loss_batch = counted

    saved = None
    first = None
    for (nd, nm), strat in meshes:
        mesh = mesh_mod.local_mesh(nd, nm)
        tag = f"({nd}, {nm}) \"{strat}\""
        st = q_state(torch, lm, loop, optim, cfg, init, dev, tcfg)
        loop.shard_state(st, mesh, strat)
        # R(c): the moments' bytes on this rank and the ZeRO-1 shards
        shape = sharding.mesh_shape(mesh)
        shapes = {k: tuple(p.shape) for k, p in st.params().items()}
        ps = sharding.param_specs(shapes, shape, strat)
        zs = sharding.zero_specs(shapes, ps, shape)
        mom = sum(st.opt.m[k].to_local().numel() + st.opt.v[k].to_local()
                  .numel() for k in shapes) * 4
        par = sum(p.to_local().numel() for p in st.params().values()) * 4
        zero_bad = [k for k in shapes if "data" in sharding._used(zs[k])
                    and "data" not in sharding._used(ps[k])
                    and st.opt.m[k].to_local().numel() * shape["data"]
                    != st.params()[k].to_local().numel()]
        moments = [None] * world
        dist.all_gather_object(moments, (mom, par, zero_bad))
        torch.cuda.reset_peak_memory_stats()
        lanes.clear()
        walls, profiled = [], None
        counts = {k: 0 for k in ops.LAUNCHES}
        for i in range(R_STEPS):
            ops.reset_launch_counts()
            sync()
            t0 = time.perf_counter()
            if i == R_STEPS - 1 and world > 1:    # (1, 1) moves nothing
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    m_ = loop.train_step(st, gw_batch, cfg, tcfg)
                    torch.cuda.synchronize()
                profiled = r_collectives(torch, prof, collectives)
            else:
                m_ = loop.train_step(st, gw_batch, cfg, tcfg)
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            for k, v in ops.LAUNCHES.items():
                counts[k] += v
            if lead:
                d = max(abs(float(m_[k]) - ref_metrics[i][k])
                        / max(abs(ref_metrics[i][k]), 1e-30)
                        for k in R_SCALARS)
                if i == 0:
                    bar(f"Run R(a) {tag} step 1 scalars ({', '.join(R_SCALARS)}"
                        ") against one card", d, *one_step["s"])
                else:
                    bar(f"Run R(a) {tag} step {i + 1} scalars against one "
                        "card", d, max(Q_F32_BAR, P_ENVELOPE * env_s[i]),
                        f"max(1e-4, {P_ENVELOPE:g}× the one-ulp envelope "
                        f"{env_s[i]:.1e})")
            if i == 0:
                f1 = r_state_fulls(torch, st)
                if lead:
                    dm1, dv1, rp1 = r_distance(torch, f1, ref1, Q_GW_BAR)
                    bar(f"Run R(a) {tag} step 1 m against one card", dm1,
                        *one_step["m"])
                    bar(f"Run R(a) {tag} step 1 v", dv1, *one_step["v"])
                    bar(f"Run R(a) {tag} step 1 parameters (ratio to the "
                        "bar)", rp1, 1.0, "bar·(lr + |p|) away from g = 0")
                del f1
        peak = torch.cuda.max_memory_allocated() / 2**30
        for k, v in counts.items():
            out["launches"][k] += v
        per_rank = [None] * world
        dist.all_gather_object(per_rank, (counts, list(lanes), walls, peak,
                                          profiled))
        fulls = r_state_fulls(torch, st)
        if lead:
            # after several steps the parameters are not held: where two
            # gradients a rounding apart straddle zero, AdamW moves them
            # ±lr apart, and that persists (the one-step rule above)
            dm, dv, _ = r_distance(torch, fulls, ref, Q_GW_BAR)
            bar(f"Run R(a) {tag} m after {R_STEPS} steps against one card",
                dm, max(Q_GW_BAR, P_ENVELOPE * env_m),
                f"max(3e-3, {P_ENVELOPE:g}× the envelope {env_m:.1e})")
            bar(f"Run R(a) {tag} v after {R_STEPS} steps", dv,
                max(2 * Q_GW_BAR, P_ENVELOPE * env_v),
                f"max(6e-3, {P_ENVELOPE:g}× the envelope {env_v:.1e})")
            n_data = nd
            for r, (c, ln, w, pk, prof_r) in enumerate(per_rank):
                fact(c["sinkhorn_row_update"] == R_STEPS * per_step
                     and c["sinkhorn_col_update"] == R_STEPS * per_step
                     and sum(c.values()) == 2 * R_STEPS * per_step,
                     f"Run R(a) {tag} rank {r}: B1/B2 launches {c}, "
                     f"expected {R_STEPS * per_step} each")
                fact(ln == [Q_A["batch"] // n_data] * R_STEPS,
                     f"Run R(a) {tag} rank {r}: FGW lanes {ln}, expected "
                     f"{Q_A['batch'] // n_data} a step")
            by, share, dev_ms, _ = per_rank[0][4] or ({"largest": []},
                                                       math.nan, 0.0, 0)
            note(f"  Run R(a) {tag}: step walls " + " ".join(
                f"{w:.3f}" for w in walls) + " s (the last under the "
                f"profiler on a mesh of several cards); rank peaks " + " ".join(
                f"{x[3]:.3f}" for x in per_rank) + " GiB (one card "
                f"{out['ref_peak_gib']:.3f}); B1/B2 "
                f"{per_rank[0][0]['sinkhorn_row_update']}/"
                f"{per_rank[0][0]['sinkhorn_col_update']} launches a rank "
                f"for {per_rank[0][1]} lanes a step; after step 1: m "
                f"{dm1:.3e}, v {dv1:.3e}, parameters {rp1:.3f} of their bar;"
                f" after step {R_STEPS}: m {dm:.3e}, v {dv:.3e}")
            note(f"  Run R(a) {tag} profiled step, rank 0: "
                 + ", ".join(f"{k} {v[0]}× {v[1] / 2**20:.3f} MiB payload "
                             f"{v[2] / 2**20:.3f} MiB wire"
                             for k, v in sorted(by.items())
                             if k != "largest")
                 + f"; the largest: {', '.join(by['largest'])}; NCCL "
                 f"kernels {share:.1%} of {dev_ms:.3f} ms of device kernel "
                 "time" if world > 1 else f"  Run R(a) {tag}: not profiled "
                 "(a (1, 1) mesh makes no collective)")
            out["walls"][f"R {tag} steps"] = sum(walls)
            mom_bytes = [x[0] for x in moments]
            one = sum(v.numel() for v in init.values()) * 8
            note(f"  Run R(c) {tag}: moments (m and v) a rank " + " ".join(
                f"{b / 2**20:.1f}" for b in mom_bytes) + f" MiB against "
                f"{one / 2**20:.1f} MiB on one card; parameters a rank "
                + " ".join(f"{x[1] / 2**20:.1f}" for x in moments)
                + " MiB")
            fact(all(not x[2] for x in moments),
                 f"Run R(c) {tag}: a moment sharded over data does not "
                 "hold 1/|data| of its parameter's local elements")
            fact(all(b < one for b in mom_bytes) or nd * nm == 1,
                 f"Run R(c) {tag}: a rank holds all the moments")
        if first is None:
            first = (mesh, tag)
            # R(d): save this state (its whole tensors stay, to compare),
            # then its uninterrupted next step
            ckpt = Path(out_dir) / "ckpt"
            t0 = time.perf_counter()
            CheckpointManager(str(ckpt)).save(R_STEPS, loop.state_tree(st))
            out["walls"]["R(d) save"] = time.perf_counter() - t0
            # copies: a replicated leaf's whole tensor is the state's own
            saved = tuple({k: t.clone() for k, t in d.items()}
                          for d in fulls) if lead else None
            m_ = loop.train_step(st, gw_batch, cfg, tcfg)
            cont = r_holder(r_state_fulls(torch, st))
            cont_metrics = {k: float(v) for k, v in m_.items()}
        del st, fulls
        gc.collect()
        torch.cuda.empty_cache()
    loop.gw_losses.fgw_alignment_loss_batch = real

    # R(a′): one plain f32 step (no FGW term) on the first mesh against
    # one card's: the sharded forward and backward at Run Q(a)'s f32 bars
    mesh, tag = first
    tp = q_tcfg(loop, optim)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    st = q_state(torch, lm, loop, optim, cfg, init, dev, tp)
    loop.shard_state(st, mesh, meshes[0][1])
    torch.cuda.reset_peak_memory_stats()
    recorder = dryrun.CollectiveRecorder()
    with recorder:      # Run S(b) holds the dry run of this step to it
        m_ = loop.train_step(st, batch, cfg, tp)
    torch.cuda.synchronize()
    out["a_prime"] = {"collectives": recorder.summary(),
                      "added_bytes": torch.cuda.max_memory_allocated() - base,
                      "mesh": [int(n) for n in mesh.mesh.shape],
                      "strategy": meshes[0][1]}
    fulls = r_state_fulls(torch, st)
    if lead:
        one = q_state(torch, lm, loop, optim, cfg, init, dev, tp)
        mo = loop.train_step(one, batch, cfg, tp)
        d = max(q_rel(torch, m_[k], mo[k]) for k in ("loss", "ce",
                                                      "grad_norm"))
        dm, dv, rp = r_distance(torch, fulls, one, Q_F32_BAR)
        note(f"  Run R(a′) {tag} one f32 step without the FGW term against "
             f"one card's: scalars {d:.3e}, m {dm:.3e}, v {dv:.3e}, "
             f"parameters {rp:.3f} of their bar")
        bar("Run R(a′) plain step scalars against one card's", d, Q_F32_BAR,
            "f32 sums in other orders")
        bar("Run R(a′) plain step m", dm, Q_F32_BAR, "f32 sums in other "
            "orders")
        bar("Run R(a′) plain step v", dv, 2 * Q_F32_BAR, "a square of the "
            "gradient")
        bar("Run R(a′) plain step parameters (ratio to the bar)", rp, 1.0,
            "bar·(lr + |p|) away from g = 0")
        del one
    del st, fulls
    gc.collect()
    torch.cuda.empty_cache()

    # R(b): one step with the in-loop gather on the first mesh
    tg = q_tcfg(loop, optim, gather_params=True)
    st = q_state(torch, lm, loop, optim, cfg, init, dev, tg)
    loop.shard_state(st, mesh, meshes[0][1])
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        m_ = loop.train_step(st, batch, cfg, tg)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by, share, dev_ms, gathers = r_collectives(torch, prof, collectives)
    shapes = {k: tuple(p.shape) for k, p in st.params().items()}
    ms = sharding.mesh_shape(mesh)
    specs = sharding.param_specs(shapes, ms)
    # a size-1 mesh dim moves nothing
    want = sum(sum(ms[a] > 1 for a in sharding._used(s))
               for k, s in specs.items() if k.startswith("stack.scanned."))
    fulls = r_state_fulls(torch, st)
    if lead:
        one = q_state(torch, lm, loop, optim, cfg, init, dev, tg)
        mo = loop.train_step(one, batch, cfg, tg)
        d = max(q_rel(torch, m_[k], mo[k]) for k in ("loss", "grad_norm"))
        dm, dv, rp = r_distance(torch, fulls, one, R_GATHER_BAR)
        note(f"  Run R(b) {tag} gather_params step: {wall:.3f} s (profiled)"
             f", {gathers} bf16 all-gathers (expected {want}: one a sharded "
             f"slot parameter and period, a mesh dim of size > 1 it is "
             f"sharded on); "
             + ", ".join(f"{k} {v[0]}×" for k, v in sorted(by.items())
                         if k != "largest")
             + f"; NCCL {share:.1%} of {dev_ms:.3f} ms; against one card's "
             f"gather step: loss and grad_norm {d:.3e}, m {dm:.3e}, v "
             f"{dv:.3e}, parameters {rp:.3f} of their bar")
        fact(gathers == want, f"Run R(b): {gathers} bf16 all-gathers, "
             f"expected {want}")
        bar("Run R(b) gather step scalars against one card's", d,
            R_GATHER_BAR, "two bf16 roundings of a gradient")
        bar("Run R(b) gather step m against one card's", dm, R_GATHER_BAR,
            "two bf16 roundings of a gradient")
        bar("Run R(b) gather step parameters (ratio to the bar)", rp, 1.0,
            "bar·(lr + |p|) away from g = 0")
        del one
    del st, fulls
    gc.collect()
    torch.cuda.empty_cache()

    # R(d): restore onto the other mesh and onto one card, then a step
    ref = ref1 = None
    gc.collect()
    torch.cuda.empty_cache()
    mgr = CheckpointManager(str(Path(out_dir) / "ckpt"))
    targets = [(mesh_mod.local_mesh(*m), m, s) for m, s in meshes[1:]]
    for mesh, m, s in targets + [(None, None, None)]:
        if mesh is None and not lead:
            continue
        like = q_state(torch, lm, loop, optim, cfg, init, dev, tcfg)
        if mesh is not None:
            loop.shard_state(like, mesh, s)
        t0 = time.perf_counter()
        tree = mgr.restore(loop.state_tree(like))
        loop.load_state_tree(like, tree)
        where = f"({m[0]}, {m[1]}) \"{s}\"" if mesh else "one card, no mesh"
        out["walls"][f"R(d) restore {where}"] = time.perf_counter() - t0
        # compared before the step: a replicated leaf's whole tensor is
        # the state's own storage, which the step updates in place
        got = r_state_fulls(torch, like)
        same = lead and all(torch.equal(got[i][k], saved[i][k])
                            for i in range(3) for k in saved[i])
        del got
        m_ = loop.train_step(like, gw_batch, cfg, tcfg)
        after = r_state_fulls(torch, like)
        if lead:
            d = max(abs(float(m_[k]) - cont_metrics[k])
                    / max(abs(cont_metrics[k]), 1e-30) for k in R_SCALARS)
            dm, dv, rp = r_distance(torch, after, cont, Q_GW_BAR)
            dp = max(float((after[0][k] - p).abs().max())
                     for k, p in cont.params().items()) / (2 * Q_LR)
            note(f"  Run R(d) saved on {tag}, restored on {where}: every "
                 f"leaf the saved bits: {same}; the next step against the "
                 f"uninterrupted run's on {tag}: scalars {d:.3e}, m {dm:.3e},"
                 f" v {dv:.3e}, parameters {rp:.3f} of the one-step rule's "
                 f"bar, the largest move {dp:.3f} of 2·lr")
            fact(same, f"Run R(d) restored on {where}: a leaf differs from "
                 "the saved state's")
            # from one state, AdamW's update lr·m̂/(√v̂ + eps) is at most
            # lr at step 4 (b1 0.9, b2 0.95): two next steps part by ≤ 2·lr
            bar(f"Run R(d) {where} next step scalars", d, *one_step["s"])
            bar(f"Run R(d) {where} next step m", dm, *one_step["m"])
            bar(f"Run R(d) {where} next step v", dv, *one_step["v"])
            bar(f"Run R(d) {where} next step parameters (largest move over "
                "2·lr)", dp, 1.0 + 1e-3, "two AdamW moves of at most lr")
        del like, tree, after
        gc.collect()
        torch.cuda.empty_cache()
    sync()
    saved = cont = None
    gc.collect()
    torch.cuda.empty_cache()

    # R(e): the sharded decode on the first mesh against one card's engine
    mesh, tag = first
    a = R_DECODE
    max_len = a["prompt"] + a["new"]
    model = lm.LM(cfg, None, device="meta")
    model.load_state_dict({k: v.clone() for k, v in init.items()},
                          strict=True, assign=True)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    sharding.distribute_module(model, mesh, sharding.param_specs(
        shapes, sharding.mesh_shape(mesh)))
    prompts = torch.as_tensor(batch["tokens"][:a["batch"], :a["prompt"]],
                              dtype=torch.long, device=dev)
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        caches = lm.cache_init(cfg, a["batch"], max_len, "float32", dev,
                               mesh=mesh)
        logits, caches = lm.prefill(
            model, sharding.distribute_batch({"tokens": prompts}, mesh),
            cfg, caches)
        seen, toks = [r_full(torch, logits)], []
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        for _ in range(a["new"]):
            tok = torch.argmax(seen[-1], dim=-1)
            toks.append(tok)
            logits, caches = lm.decode_step(
                model, sharding.distribute_batch({"tokens": tok[:, None]},
                                                 mesh), caches, cfg)
            seen.append(r_full(torch, logits))
        torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    out["walls"]["R(e) decode"] = t_all
    if lead:
        plain = lm.LM(cfg, None, device="meta")
        plain.load_state_dict({k: v.clone() for k, v in init.items()},
                              strict=True, assign=True)
        want_t, want_l = Engine(plain, cfg, ServeConfig(
            max_len=max_len, batch_size=a["batch"])).generate(
            prompts.cpu().numpy(), a["new"], return_logits=True)
        got_t = torch.stack(toks, 1).cpu().numpy()
        got_l = torch.stack(seen, 1)
        d = p_rel(torch, got_l, want_l)
        note(f"  Run R(e) {tag} decode, batch {a['batch']}, {a['prompt']}-"
             f"token prompts, {a['new']} greedy steps: prefill {t_pre:.3f} "
             f"s, {(t_all - t_pre) / a['new'] * 1e3:.1f} ms a step; tokens "
             f"{'equal' if (got_t == want_t).all() else 'DIFFER'} to one "
             f"card's engine; logits {d:.3e} from its")
        fact((got_t == want_t).all(), "Run R(e): the sharded decode's "
             "greedy tokens differ from one card's engine")
        bar("Run R(e) sharded decode logits against one card's engine", d,
            P_F32_BAR, "Run P(a)'s f32 bar")
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    sync()
    dist.destroy_process_group()
    return 0


def phase_sharded_path(torch, np, ops, core):
    """Run R: the sharded path, one NCCL rank a card (at most 4), started
    by torch.distributed.run; the ranks' checks are held here."""
    import shutil
    import signal
    import socket
    world = min(torch.cuda.device_count(), R_MAX_WORLD)
    say(f"phase 3, the sharded path: repro_torch.train.loop.shard_state and "
        f"train_step on a DeviceMesh, the elastic restore and the sharded "
        f"decode (Run R; {world} card(s), B1/B2 under the FGW term on each "
        "rank's lanes)")
    walls = {}
    gc.collect()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "run_r"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(world), "--master-addr", "127.0.0.1", "--master-port",
           str(port), str(ROOT / "chip_smoke.py"), "--run-r-rank", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=R_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    walls["R"] = time.perf_counter() - t0
    for ln in stdout.splitlines():
        if ln.startswith("  Run R"):
            say(ln)
    (out / "ranks.err").write_text(stderr)
    first = stderr.find("Traceback")
    check(proc.returncode == 0, f"Run R: the ranks exited with "
          f"{proc.returncode}: " + (stderr[first:first + 6000] if first >= 0
                                    else stderr[-3000:]))
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)]
    for label, value, limit, why in ranks[0]["bars"]:
        p_check(label, value, limit, why)
    for ok, text in ranks[0]["facts"]:
        check(ok, text)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ops.LAUNCHES}
    walls.update(ranks[0]["walls"])
    R_A_PRIME[:] = [r["a_prime"] for r in ranks]
    if world < 4:
        say(f"  Run R: the 2- and 4-card meshes ((2, 2) \"2d\", (4, 1) "
            f"\"dp\") did not run for want of cards ({world} here): R(a) "
            "ran on " + ", ".join(f"({a}, {b}) \"{s}\"" for (a, b), s in
                                  r_meshes(world))
            + " and R(d) restored onto one card with no mesh")
    say(f"  Run R: {walls['R']:.1f} s of wall in all, the ranks' start "
        "included; B1/B2 launches over the ranks "
        f"{launches['sinkhorn_row_update']}/{launches['sinkhorn_col_update']}")
    shutil.rmtree(out / "ckpt", ignore_errors=True)
    return launches, walls


# ---------------------------------------------------------------------------
# phase 3, the dry run: Run S
# ---------------------------------------------------------------------------

# S(a): the dry run's cells on the card (`repro_torch.launch.dryrun`'s
# CLI, in one subprocess: the fake group shares no process with the NCCL
# ranks of Run R)
S_CELLS = (("smollm-360m", "all", "single"),
           ("deepseek-v2-lite-16b", "train_4k", "multi"))
S_TIMEOUT = 400
# the collectives a "2d" layout issues: the activations' partial sums and
# their reshuffles, the gradients' reductions, ZeRO-1's gathers of the
# updated parameters, an MoE's shard-to-shard moves
S_2D_KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all"}
# S(b): the dry run's peak against the memory one real rank's R(a′) step
# adds (ranks 1–3; rank 0 also holds the one-card references).
# Provisional: no 4-card run has measured the ratio yet
S_PEAK_BAR = (0.8, 1.25)


def s_args(i, out_dir):
    """The dry run's CLI arguments of S(a)'s cell ``i`` (no analytic
    count: no check reads it)."""
    arch, shape, mesh = S_CELLS[i]
    return ["--device", "cuda", "--arch", arch, "--shape", shape, "--mesh",
            mesh, "--out", str(out_dir / f"a{i}.json"), "--no-flops"]


def s_cells(out_dir):
    """The subprocess of Run S: S(a)'s CLI runs, then (with a path to
    R(a′)'s cell) S(b)'s dry run of it on a fake (2, 2) group.  The first
    cell runs here; the others, each in a process of its own, start once
    its first record (smollm-360m's train_4k, its largest share) is
    written and its memory handed back, and overlap its smaller shares
    (a deepseek-v2-lite-16b train share and a smollm prefill share
    together hold ~52 GiB of the card's 80)."""
    import torch
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(out_dir)
    done, others = threading.Event(), []

    def start_others():
        while not (out_dir / "a0.json").exists() and not done.is_set():
            time.sleep(0.2)
        for i in range(1, len(S_CELLS)):
            others.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 *s_args(i, out_dir)], cwd=ROOT))
    starter = threading.Thread(target=start_others)
    starter.start()
    try:
        rc = dryrun.main(s_args(0, out_dir))
    finally:
        done.set()
        starter.join()
        for p in others:
            rc |= p.wait()
    cell = out_dir / "b_cell.json"
    if cell.exists():
        c = json.loads(cell.read_text())
        cfg = dataclasses.replace(configs.get("smollm-360m"),
                                  dtype="float32", num_layers=c["layers"])
        shape = ShapeSpec("r_a_prime", "train", c["seq"], c["batch"])
        rec = dryrun.run_cell("smollm-360m", shape.name, False,
                              count_flops=False, strategy=c["strategy"],
                              remat=False,
                              device="cuda", mesh_shape=tuple(c["mesh"]),
                              cfg=cfg, shape=shape)
        (out_dir / "b.json").write_text(json.dumps(rec))
    return rc


def phase_dryrun_path(torch, np, ops, core):
    """Run S: the production dry run on the card, as a subprocess: S(a)
    smollm-360m's cells on the 16×16 mesh and deepseek-v2-lite-16b's
    train_4k on 2×16×16; S(b), with 4 cards, Run R(a′)'s step dry-run on
    a fake (2, 2) group against Run R's real ranks."""
    import shutil
    import signal
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import specs as specs_mod
    say("phase 3, the dry run: repro_torch.launch.dryrun on fake groups of "
        "256 and 512 ranks, one rank's real shards on the card (Run S; no "
        "kernel of B1–B7)")
    walls = {}
    gc.collect()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "run_s"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    world = min(torch.cuda.device_count(), R_MAX_WORLD)
    s_b = world >= 4 and len(R_A_PRIME) >= 4
    if s_b:
        a = R_A_PRIME[0]
        (out / "b_cell.json").write_text(json.dumps(dict(
            layers=R_LAYERS, seq=Q_A["seq"], batch=Q_A["batch"],
            mesh=a["mesh"], strategy=a["strategy"])))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             "--run-s", str(out)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=S_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
    walls["S"] = time.perf_counter() - t0
    (out / "cells.err").write_text(stderr)
    for ln in stdout.splitlines():
        if ln.startswith("["):
            say("  Run S(a) " + ln)
    first = stderr.find("Traceback")
    check(proc.returncode == 0, f"Run S: the dry run exited with "
          f"{proc.returncode}: " + (stderr[first:first + 4000]
                                    if first >= 0 else stderr[-3000:]))
    recs = [r for i in range(len(S_CELLS))
            for r in json.loads((out / f"a{i}.json").read_text())]
    ran = [r for r in recs if "skipped" not in r]
    check(len(ran) == 4 and len(recs) == 5 and not any(
        "error" in r for r in recs), f"Run S(a): {len(ran)} records run and "
        f"{len(recs) - len(ran)} skipped (want 4 and 1), errors "
        f"{[r.get('error') for r in recs if 'error' in r]}")
    skipped = [r for r in recs if "skipped" in r]
    check([(r["arch"], r["shape"]) for r in skipped]
          == [("smollm-360m", "long_500k")],
          f"Run S(a): skipped {[(r['arch'], r['shape']) for r in skipped]}")
    for r in ran:
        mem = r["memory_per_device"]
        label = f"{r['arch']} × {r['shape']} [{r['mesh']}]"
        check("oom" not in r, f"Run S(a) {label}: out of memory at "
              f"≥{mem['total_bytes'] / 2**30:.3f} GiB: {r.get('oom')}")
        want = specs_mod.argument_bytes(
            configs.get(r["arch"]), SHAPES[r["shape"]],
            [int(n) for n in r["mesh"].split("x")], r["strategy"])
        kinds = set(r["collectives"]["counts"])
        say(f"  Run S(a) {label}: peak {mem['total_bytes'] / 2**30:.3f} GiB"
            f" of {r['hbm_bytes'] / 2**30:.2f}, fits {r['fits_hbm']}, arguments "
            f"{mem['argument_bytes'] / 2**30:.3f} GiB (the specs' reckoning "
            f"{want / 2**30:.3f}), first step {r['first_step_s']:.2f} s, "
            f"{r['device_cost']['flops_per_device']:.4g} FLOPs and "
            f"{r['device_cost']['bytes_per_device']:.4g} bytes a device, "
            f"collectives {r['collectives']['counts']} "
            f"({r['collectives']['wire_bytes_per_device'] / 2**30:.3f} GiB "
            f"on the wire), dominant {r['dominant']}")
        walls[f"S(a) {label} first step"] = r["first_step_s"]
        check(mem["argument_bytes"] == want, f"Run S(a) {label}: argument "
              f"bytes {mem['argument_bytes']} against the specs' {want}")
        check(mem["total_bytes"] >= mem["argument_bytes"],
              f"Run S(a) {label}: peak below the arguments")
        check(kinds and kinds <= S_2D_KINDS and (
            r["shape"] != "train_4k" or {"all-reduce", "all-gather"}
            <= kinds), f"Run S(a) {label}: collective kinds {kinds}")
    if s_b:
        rec = json.loads((out / "b.json").read_text())
        real = R_A_PRIME
        got, want = rec["collectives"], real[0]["collectives"]
        say(f"  Run S(b) R(a′)'s step dry-run on a fake {tuple(real[0]['mesh'])}"
            f" group: collectives {got['counts']}, "
            f"{got['payload_bytes_per_device'] / 2**20:.1f} MiB a device; "
            f"Run R's rank 0: {want['counts']}, "
            f"{want['payload_bytes_per_device'] / 2**20:.1f} MiB")
        check(got["counts"] == want["counts"] and
              got["payload_bytes_per_device"]
              == want["payload_bytes_per_device"],
              "Run S(b): the dry run's collectives differ from Run R's rank 0")
        added = [r["added_bytes"] for r in real[1:]]
        ratio = rec["memory_per_device"]["total_bytes"] / (sum(added)
                                                            / len(added))
        say(f"  Run S(b) peak {rec['memory_per_device']['total_bytes'] / 2**30:.3f} "
            f"GiB against ranks 1–3's R(a′) step, "
            + ", ".join(f"{b / 2**30:.3f}" for b in added)
            + f" GiB: ratio {ratio:.3f} (provisional bar {S_PEAK_BAR})")
        check(S_PEAK_BAR[0] <= ratio <= S_PEAK_BAR[1],
              f"Run S(b): peak ratio {ratio:.3f} outside {S_PEAK_BAR}")
    else:
        say(f"  Run S(b) did not run for want of cards ({world} here; it "
            "needs Run R on 4)")
    say(f"  Run S: {walls['S']:.1f} s of wall in all, the subprocess's "
        "start included")
    return {}, walls


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def phase_times(torch, ops, sk, fs, core, gen):
    """Returns ({key: (ms, plain ms, bound ms, bound by)}, {key: library
    ms})."""
    say("phase 4: times (CUDA events, after a warm-up; plain versions are "
        "no yardstick of speed: they repeat the arithmetic in PyTorch ops)")
    dev = "cuda"
    rows, library = {}, {}
    for m, n, dt, cdt, tag in half_step_cases(torch):
        cost = torch.rand((1, m, n), generator=gen, device=dev,
                          dtype=dt).to(cdt)
        g = torch.randn((1, n), generator=gen, device=dev, dtype=dt)
        f = torch.randn((1, m), generator=gen, device=dev, dtype=dt)
        lm = torch.full((1, m), -math.log(m), device=dev, dtype=dt)
        ln = torch.full((1, n), -math.log(n), device=dev, dtype=dt)
        e = torch.full((1,), 2e-3, device=dev, dtype=dt)
        vb = torch.finfo(dt).bits // 8
        nbytes = cost.numel() * cost.element_size() + 3 * n * vb
        flops = 5.0 * m * n      # subtract, divide, exp, max/compare, add
        for kind, vec, logw in (("row", g, lm), ("col", f, ln)):
            wrap = getattr(ops, f"sinkhorn_{kind}_update_batched")
            plain = getattr(sk, f"{kind}_update_plain")
            ms = time_ms(torch, lambda: wrap(cost, vec, logw, e), reps=20)
            pms = time_ms(torch, lambda: plain(cost, vec, logw, e), reps=3)
            b, by = bound_ms(nbytes, flops, str(dt).split(".")[-1])
            label = f"{'B1' if kind == 'row' else 'B2'} {kind} {tag}"
            key = label if m == N_BIG else f"{label} C{m}x{n}"
            rows[key] = (ms, pms, b, by)
            say(f"  {label} C{m}x{n}: {ms:.5f} ms, bound {b:.5f} ms "
                f"({by}), {b / ms:.1%} of bound; plain {pms:.5f} ms")
        del cost
    # B3 and B4 (L, Lᵀ) at p = 1, each beside the library yardstick: one
    # torch.matmul against the dense D̃, L or Lᵀ (the "dense" backend's
    # product; the matrix is built before the timing), and as a note the
    # default "cumsum" backend's call
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        p = 1
        lo = core.fgc.lower_toeplitz(N_BIG, p, dt, dev)
        dense = {"dtilde": lo + lo.T, "l": lo, "lt": lo.T.contiguous()}
        cumsum = {"dtilde": core.fgc.apply_abs_power, "l": core.fgc.apply_L,
                  "lt": core.fgc.apply_LT}
        for cols in (N_BIG, 16, 1):
            x = torch.randn((N_BIG, cols), generator=gen, device=dev,
                            dtype=dt)
            nbytes = 2 * x.numel() * x.element_size()
            for kind in ("dtilde", "l", "lt"):
                streams = 2 if kind == "dtilde" else 1
                flops = streams * ((p + 1) * (p + 2)) * x.numel()
                wrap, plain = fgc_apply(ops, fs, kind)[:2]
                ms = time_ms(torch, lambda: wrap(x, p), reps=20)
                pms = time_ms(torch, lambda: plain(x, p), reps=1, warmup=0)
                lib = time_ms(torch, lambda: dense[kind] @ x,
                              reps=3 if cols == N_BIG else 20)
                cs = time_ms(torch, lambda: cumsum[kind](x, 0, p, "cumsum"),
                             reps=5)
                b, by = bound_ms(nbytes, flops, str(dt).split(".")[-1])
                key = f"{'B3' if kind == 'dtilde' else 'B4'} {kind} {tag} " \
                      f"x{N_BIG}x{cols}"
                rows[key] = (ms, pms, b, by)
                library[key] = lib
                say(f"  {key} p={p}: {ms:.5f} ms, bound {b:.5f} ms ({by}), "
                    f"{b / ms:.1%} of bound; plain {pms:.5f} ms; library "
                    f"(matmul against the dense matrix) {lib:.5f} ms; "
                    f"cumsum backend {cs:.5f} ms")
        del lo, dense
    # B3 at Run B's own shape: Grid2D(64) sweeps one 64-long axis of the
    # unfolded (64, 64, 4096) plan, that is (64, 262144) columns
    x = torch.randn((64, 64 * N_RUN_B), generator=gen, device=dev,
                    dtype=torch.float64)
    for p in (1, 2):
        ms = time_ms(torch, lambda: ops.fgc_apply_dtilde(x, p), reps=20)
        pms = time_ms(torch, lambda: fs.apply_dtilde_plain(x, p), reps=1,
                      warmup=0)
        b, by = bound_ms(2 * x.numel() * x.element_size(),
                         2.0 * (p + 1) * (p + 2) * x.numel(), "float64")
        key = f"B3 dtilde f64 x{x.shape[0]}x{x.shape[1]} p={p}"
        rows[key] = (ms, pms, b, by)
        say(f"  {key} (Run B's shape): {ms:.5f} ms, bound {b:.5f} ms "
            f"({by}), {b / ms:.1%} of bound; plain {pms:.5f} ms")
    # the scan at p = 2 on the squared-distance shape, and B4 on 300 000
    # rows of one f64 column
    for rows_, dt, p in ((N_BIG, torch.float32, 2), (N_BIG, torch.float64, 2),
                         (300_000, torch.float64, 1)):
        x = torch.randn((rows_, 1), generator=gen, device=dev, dtype=dt)
        name = str(dt).split(".")[-1]
        for kind in ("dtilde", "l", "lt") if rows_ == N_BIG else ("l", "lt"):
            wrap, plain = fgc_apply(ops, fs, kind)[:2]
            ms = time_ms(torch, lambda: wrap(x, p), reps=20)
            b, by = bound_ms(2 * x.numel() * x.element_size(),
                             (2.0 if kind == "dtilde" else 1.0) * (p + 1)
                             * (p + 2) * x.numel(), name)
            key = f"{'B3' if kind == 'dtilde' else 'B4'} {kind} " \
                  f"{name[:1]}{name[-2:]} x{rows_}x1 p={p}"
            if rows_ == N_BIG:
                pms = time_ms(torch, lambda: plain(x, p), reps=1, warmup=0)
                rows[key] = (ms, pms, b, by)
                plain_note = f"plain {pms:.5f} ms"
            else:
                plain_note = "plain not timed (300 000 steps of a Python loop)"
            say(f"  {key}: {ms:.5f} ms, bound {b:.5f} ms ({by}), "
                f"{b / ms:.1%} of bound; {plain_note}")
    return rows, library


def lowrank_times(torch, ops, lr, gen):
    """B5–B7 at Run C's shapes (N = 10⁶, c = 5, r = 16).  Bounds count each
    input read once and each output written once; operations: B5 about
    10 a kernel entry (two LSE passes: add, max, subtract, exp, sum), B6
    2·N·r·(2c + 2) + 2·c·r² (XᵀQ for X = [B | A | 1 | w], then the
    (r, c)·(c, r) Gram), B7 N·r·(2c + 6)."""
    rows = {}
    n, c, r = N_LR, C_LR, R_LR
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        name = str(dt).split(".")[-1]
        vb = torch.finfo(dt).bits // 8
        lk = torch.randn((1, n, r), generator=gen, device="cuda", dtype=dt)
        gcol = torch.randn((1, r), generator=gen, device="cuda", dtype=dt)
        logw = torch.full((1, n), -math.log(n), device="cuda", dtype=dt)
        a, b, q, w = lr_inputs(torch, gen, n, c, r, dt)
        wm, s_, t_, iq = combine_inputs(torch, gen, c, r, dt)
        cases = (
            ("B5", lambda: ops.lr_dykstra_half_batched(lk, gcol, logw),
             lambda: lr.dykstra_half_plain(lk, gcol, logw),
             (n * r + 2 * n + 2 * r) * vb, 10.0 * n * r),
            ("B6", lambda: ops.lr_gram_chain_batched(a, b, q, w),
             lambda: lr.gram_chain_plain(a, b, q, w),
             (n * (2 * c + r + 1) + c * r + r * r + 2 * r) * vb,
             2.0 * n * r * (2 * c + 2) + 2.0 * c * r * r),
            ("B7", lambda: ops.lr_grad_combine_batched(a, wm, w, s_, t_, iq),
             lambda: lr.grad_combine_plain(a, wm, w, s_, t_, iq),
             (n * (c + 1 + r) + c * r + 3 * r) * vb,
             1.0 * n * r * (2 * c + 6)))
        for key, kern, plain, nbytes, flops in cases:
            ms = time_ms(torch, kern, reps=20)
            pms = time_ms(torch, plain, reps=5)
            bnd, by = bound_ms(nbytes, flops, name)
            label = f"{key} {tag} N{n} c{c} r{r}"
            rows[label] = (ms, pms, bnd, by)
            say(f"  {label}: {ms:.5f} ms, bound {bnd:.5f} ms ({by}), "
                f"{bnd / ms:.1%} of bound; plain {pms:.5f} ms")
        del lk, a, b, q, w
    return rows


def warm_cold(torch, fn, flush):
    """(warm, cold) device ms of fn: back to back with the card kept busy
    while the host enqueues, and each launch after a write that flushes
    L2."""
    warm = time_ms(torch, fn, reps=20)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cold = 0.0
    for _ in range(10):
        flush.fill_(1)
        torch.cuda._sleep(SLEEP_CYCLES // 20)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        cold += start.elapsed_time(end) / 10
    return warm, cold


def lowrank_shape_times(torch, ops, gen):
    """B5–B7 in f64 at Runs C and D's shapes (N = 10⁶, r = 16; 10⁵, r =
    8, 16, 32; c = 5), B5 also at Run E's (8192, r = 16), each beside its
    bytes bound (each input read once, each output written once).  "warm":
    back to back on the same inputs, which at 10⁵ and 8192 rows stay in
    the 50 MB L2; "cold": each launch after a 64 MB write that flushes
    L2."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    dt, c = torch.float64, C_LR
    for n, r, run in ((N_LR, R_LR, "C"), (100_000, 8, "D"),
                      (100_000, 16, "D"), (100_000, 32, "D"),
                      (N_BIG, R_LR, "E")):
        lk = torch.randn((1, n, r), generator=gen, device="cuda", dtype=dt)
        gcol = torch.randn((1, r), generator=gen, device="cuda", dtype=dt)
        logw = torch.full((1, n), -math.log(n), device="cuda", dtype=dt)
        cases = [("B5", lambda: ops.lr_dykstra_half_batched(lk, gcol, logw),
                  (n * r + 2 * n + 2 * r) * 8, 10.0 * n * r)]
        if run != "E":        # a grid: no B6/B7
            a, b, q, w = lr_inputs(torch, gen, n, c, r, dt)
            wm, s_, t_, iq = combine_inputs(torch, gen, c, r, dt)
            cases += [
                ("B6", lambda: ops.lr_gram_chain_batched(a, b, q, w),
                 (n * (2 * c + r + 1) + c * r + r * r + 2 * r) * 8,
                 2.0 * n * r * (2 * c + 2) + 2.0 * c * r * r),
                ("B7", lambda: ops.lr_grad_combine_batched(a, wm, w, s_, t_,
                                                           iq),
                 (n * (c + 1 + r) + c * r + 3 * r) * 8,
                 1.0 * n * r * (2 * c + 6))]
        for key, fn, nbytes, flops in cases:
            warm, cold = warm_cold(torch, fn, flush)
            bnd, by = bound_ms(nbytes, flops, "float64")
            say(f"  {key} f64 N{n} r{r} (Run {run}'s shape): {warm:.5f} ms "
                f"warm, {cold:.5f} ms with L2 flushed, bound {bnd:.5f} ms "
                f"({by}), {bnd / cold:.1%} of bound cold")
        del lk


def batch_shape_times(torch, ops, lr, ss):
    """Each kernel of Runs F and G at their batched shapes, f64: B1/B2 on
    16 lanes of 2048², B3 on 16 lanes of (2048, 2048) folded into its
    columns, B5–B7 on Run G's 4 lanes of 10⁵ rows (c = 5, r = 16); each
    beside its bytes bound, beside one lane alone times the lanes, and
    with the grid's blocks against one wave of the card (B2's splits, B5's
    and B6's blocks are one lane's each, so the lanes multiply the
    waves).  Inputs from a generator of their own."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 23)
    dev, dt = "cuda", torch.float64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}

    def line(key, fn, one, lanes, nbytes, flops, grid=""):
        ms = time_ms(torch, fn, reps=10)
        one_ms = time_ms(torch, one, reps=10)
        b, by = bound_ms(nbytes, flops, "float64")
        rows[key] = (ms, b, by)
        say(f"  {key}: {ms:.5f} ms, bound {b:.5f} ms ({by}), {b / ms:.1%} "
            f"of bound; one lane alone {one_ms:.5f} ms × {lanes} = "
            f"{one_ms * lanes:.5f} ms{grid}")

    cost = torch.rand((LANES, N_F, N_F), generator=gen, device=dev, dtype=dt)
    vec = torch.randn((LANES, N_F), generator=gen, device=dev, dtype=dt)
    logw = torch.full((LANES, N_F), -math.log(N_F), device=dev, dtype=dt)
    eps = torch.tensor([EPS_CYCLE[b % 4] for b in range(LANES)], dtype=dt,
                       device=dev)
    splits = ss.col_split(LANES, N_F, N_F, 8, sms)[0]
    col_blocks = LANES * splits * -(-N_F // 64)
    for kind in ("row", "col"):
        fn = getattr(ops, f"sinkhorn_{kind}_update_batched")
        grid = "" if kind == "row" else (
            f"; {col_blocks} blocks ({LANES} lanes × {splits} splits × "
            f"{-(-N_F // 64)} column tiles) = "
            f"{col_blocks / (ss.COL_BLOCKS_PER_SM * sms):.1f}× "
            f"COL_BLOCKS_PER_SM·SMs")
        line(f"B{1 if kind == 'row' else 2} {kind} f64 C{LANES}x{N_F}x{N_F}"
             " (Run F)", lambda: fn(cost, vec, logw, eps),
             lambda: fn(cost[:1], vec[:1], logw[:1], eps[:1]), LANES,
             (cost.numel() + 3 * LANES * N_F) * 8, 5.0 * cost.numel(), grid)
    del cost
    x = torch.randn((N_F, LANES * N_F), generator=gen, device=dev, dtype=dt)
    x1 = x[:, :N_F].contiguous()
    line(f"B3 dtilde f64 x{N_F}x({LANES}x{N_F}) p=1 (Run F)",
         lambda: ops.fgc_apply_dtilde(x, 1, lanes=LANES),
         lambda: ops.fgc_apply_dtilde(x1, 1), LANES, 2 * x.numel() * 8,
         2.0 * 2 * 3 * x.numel())
    del x, x1
    n, c, r, lanes = N_G, C_LR, R_LR, LANES_G
    lk = torch.randn((lanes, n, r), generator=gen, device=dev, dtype=dt)
    gcol = torch.randn((lanes, r), generator=gen, device=dev, dtype=dt)
    lw = torch.full((lanes, n), -math.log(n), device=dev, dtype=dt)
    a = torch.randn((lanes, n, c), generator=gen, device=dev, dtype=dt)
    bf = torch.randn((lanes, n, c), generator=gen, device=dev, dtype=dt)
    q = torch.rand((lanes, n, r), generator=gen, device=dev, dtype=dt) / n
    wm = torch.randn((lanes, c, r), generator=gen, device=dev, dtype=dt)
    s_, t_, iq = (torch.randn((lanes, r), generator=gen, device=dev,
                              dtype=dt) for _ in range(3))
    plans = {"B5": lr.dykstra_plan(lanes, n, r, 8, sms).blocks,
             "B6": lr.gram_plan(lanes, n, c, r, 8, sms).blocks}

    def waves(key):
        return (f"; {lanes} lanes × {plans[key]} blocks = "
                f"{lanes * plans[key] / (lr.DYKSTRA_MIN_BLOCKS_PER_SM * sms):.1f}"
                f"× the one-lane wave of {lr.DYKSTRA_MIN_BLOCKS_PER_SM} an SM")

    line(f"B5 f64 lk{lanes}x{n}x{r} (Run G)",
         lambda: ops.lr_dykstra_half_batched(lk, gcol, lw),
         lambda: ops.lr_dykstra_half_batched(lk[:1], gcol[:1], lw[:1]),
         lanes, lanes * (n * r + 2 * n + 2 * r) * 8, 10.0 * lanes * n * r,
         waves("B5"))
    line(f"B6 f64 N{n} c{c} r{r} x{lanes} (Run G)",
         lambda: ops.lr_gram_chain_batched(a, bf, q, lw),
         lambda: ops.lr_gram_chain_batched(a[:1], bf[:1], q[:1], lw[:1]),
         lanes, lanes * (n * (2 * c + r + 1) + c * r + r * r + 2 * r) * 8,
         lanes * (2.0 * n * r * (2 * c + 2) + 2.0 * c * r * r), waves("B6"))
    line(f"B7 f64 N{n} c{c} r{r} x{lanes} (Run G)",
         lambda: ops.lr_grad_combine_batched(a, wm, lw, s_, t_, iq),
         lambda: ops.lr_grad_combine_batched(a[:1], wm[:1], lw[:1], s_[:1],
                                             t_[:1], iq[:1]),
         lanes, lanes * (n * (c + 1 + r) + c * r + 3 * r) * 8,
         lanes * 1.0 * n * r * (2 * c + 6))
    return rows


KERNELS = (
    ("sinkhorn_row_update", "B1 row f32", f"B1 row f32 C{N_BIG}x{N_BIG}",
     "src/repro_torch/kernels/csrc/sinkhorn_step.cu",
     "src/repro/kernels/sinkhorn_step.py:170"),
    ("sinkhorn_col_update", "B2 col f32", f"B2 col f32 C{N_BIG}x{N_BIG}",
     "src/repro_torch/kernels/csrc/sinkhorn_step.cu",
     "src/repro/kernels/sinkhorn_step.py:202"),
    ("fgc_apply_dtilde", f"B3 dtilde f32 x{N_BIG}x{N_BIG}",
     f"B3 dtilde f32 x{N_BIG}x{N_BIG} p=1",
     "src/repro_torch/kernels/csrc/fgc_scan.cu",
     "src/repro/kernels/fgc_scan.py:127"),
    ("fgc_apply_l", f"B4 l f32 x{N_BIG}x{N_BIG}",
     f"B4 L f32 x{N_BIG}x{N_BIG} p=1",
     "src/repro_torch/kernels/csrc/fgc_scan.cu",
     "src/repro/kernels/fgc_scan.py:166"),
    ("lr_dykstra_half", f"B5 f32 N{N_LR} c{C_LR} r{R_LR}",
     f"B5 N{N_LR} c{C_LR} r{R_LR} f32",
     "src/repro_torch/kernels/csrc/lr_step.cu",
     "src/repro/kernels/lr_step.py:135"),
    ("lr_gram_chain", f"B6 f32 N{N_LR} c{C_LR} r{R_LR}",
     f"B6 N{N_LR} c{C_LR} r{R_LR} f32",
     "src/repro_torch/kernels/csrc/lr_step.cu",
     "src/repro/kernels/lr_step.py:237"),
    ("lr_grad_combine", f"B7 f32 N{N_LR} c{C_LR} r{R_LR}",
     f"B7 N{N_LR} c{C_LR} r{R_LR} f32",
     "src/repro_torch/kernels/csrc/lr_step.cu",
     "src/repro/kernels/lr_step.py:309"),
)


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        say(f"FAIL: {exc}")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    try:
        from repro_torch import core
        from repro_torch.kernels import (build, fgc_scan, lr_step, ops,
                                         sinkhorn_step)
    except ImportError as exc:
        say(f"FAIL: the repro_torch package is not beside this script "
            f"({exc})")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        say("phase 1: device and build")
        card = device_line(torch)
        say(f"card: {card}")
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
            f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
        build_kernels(build)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        errs = phase_kernels(torch, ops, sinkhorn_step, fgc_scan, gen)
        errs.update(phase_lowrank_kernels(torch, ops, lr_step, gen))
        errs.update(phase_lane_kernels(torch, np, ops, sinkhorn_step,
                                       fgc_scan, lr_step))
        launches, walls = phase_main_path(torch, np, ops, core, gen)
        for phase in (phase_lowrank_path, phase_batch_path,
                      phase_grad_path, phase_variants_path,
                      phase_serving_path, phase_lm_path,
                      phase_train_path, phase_sharded_path,
                      phase_dryrun_path):
            more, more_walls = phase(torch, np, ops, core)
            for k, v in more.items():
                launches[k] += v
            walls.update(more_walls)
        rows, library = phase_times(torch, ops, sinkhorn_step, fgc_scan,
                                    core, gen)
        rows.update(lowrank_times(torch, ops, lr_step, gen))
        lowrank_shape_times(torch, ops, gen)
        batch_shape_times(torch, ops, lr_step, sinkhorn_step)
        say("  runs (host clock around synchronised work): " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items()))
        say("phase 5: kernels")
        for name, count in launches.items():
            check(count > 0, f"{name} was never launched on the main path")
        kernels = []
        for name, time_key, err_key, src, replaces in KERNELS:
            ms, pms, b, by = rows[time_key]
            kernels.append({"name": name, "route": "cuda", "source": src,
                            "replaces": replaces,
                            "launches": launches[name],
                            "max_abs_err": errs[err_key], "ms": ms,
                            "plain_ms": pms, "bound_ms": b, "bound_by": by,
                            "library_ms": library.get(time_key)})
        say(f"card: {card}")
        say(json.dumps({"kernels": kernels}))
    except (SmokeFailure, RuntimeError, subprocess.SubprocessError) as exc:
        say(f"FAIL: {type(exc).__name__}: {exc}")
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--run-r-rank"]:
        sys.exit(r_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--run-s"]:
        sys.exit(s_cells(sys.argv[2]))
    sys.exit(main())
