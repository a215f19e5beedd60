#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every kernel from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` (seconds, registers).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (8192 × 8192 and 8192 × 1 for B1–B4; N = 10⁶, c = 5,
   r = 16 for B5–B7) and dtypes, plus zero-mass rows and columns, an
   all-masked leading block of columns, four lanes with four different ε,
   r = 64 and a ragged N.  Each line prints the measured difference beside
   its tolerance and the reason for it.
3. The main path through ``repro_torch.core.entropic_gw``: a small check
   of the FGC kernels against the dense oracle, Run A (``Grid1D(8192)``,
   the paper's §4.1 settings, f32 and f64), Run B (``Grid2D(64)``, f64,
   adaptive with ε-annealing), the FGC primitives ``apply_L``/``apply_LT``,
   and the factored plan: Run C (two 10⁶-point clouds, rank 16, f64 and
   f32, then the same solves kernels and plain side by side, f32 checked
   one step at a time), Run D (``plan_rank="auto"`` on two 10⁵-point
   clouds, f64, growing the rank by restarts) and Run E
   (``Grid1D(8192)``, rank 16, f64), each against the plain path on the
   card.  The launch counts are set to 0 just before each path and read
   just after.
4. Times: each kernel (CUDA events) beside its bound and its plain
   version's time.
5. The ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
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
        lines = log.read_text().splitlines() if log.is_file() else []
        regs = [int(piece.split("Used")[-1].split()[0]) for line in lines
                for piece in line.split(",") if "registers" in piece]
        spill = sum(int(piece.split()[0]) for line in lines
                    for piece in line.split(",") if "bytes spill" in piece)
        say(f"  {stem}: max {max(regs) if regs else 'n/a'} registers a "
            f"thread, {spill} spill bytes over all instantiations")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def sinkhorn_case(torch, ops, sk, kind, cost, vec, logw, eps, tol_ulp,
                  label, results, why="the online (max, sumexp) associates "
                  "the sum otherwise than the plain two-pass logsumexp "
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


def fgc_case(torch, ops, fs, kind, x, p, label, results):
    """One FGC kernel against its plain recursion.  The bound of a
    recursive sum of N terms: |Δy_i| ≤ (p+2)·N·u·(D|x|)_i for each version,
    so the two differ by at most twice that."""
    fn = ops.fgc_apply_l if kind == "l" else ops.fgc_apply_dtilde
    plain = fs.apply_l_plain if kind == "l" else fs.apply_dtilde_plain
    name = f"fgc_apply_{kind}"
    before = ops.LAUNCHES[name]
    got = fn(x, p)
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] == before + 1,
          f"{label}: the wrapper did not launch its kernel")
    want = plain(x, p)
    scale = plain(x.abs().double(), p)
    n = x.shape[0]
    u = torch.finfo(x.dtype).eps / 2
    ratio = float(((got - want).abs().double()
                   / (n * u * scale).clamp_min(1e-300)).max())
    max_abs = float((got - want).abs().max())
    tol = 2 * (p + 2)
    say(f"  {label}: max |Δ| {max_abs:.3e}; max |Δ| / (N·u·(D|x|)) = "
        f"{ratio:.3f}, tolerance {tol} (twice the recursive-sum bound)")
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(ratio <= tol, f"{label}: {ratio:.3f} > {tol}")
    results[label] = max_abs
    return max_abs


def phase_kernels(torch, ops, sk, fs, gen):
    say("phase 2: kernels against their plain versions on the card")
    dev = "cuda"
    errs = {}
    m = n = N_BIG
    eps = 2e-3
    for dt, cdt, tag in ((torch.float32, torch.float32, "f32"),
                         (torch.float64, torch.float64, "f64"),
                         (torch.float32, torch.bfloat16, "bf16-C/f32")):
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
        wm = torch.randn((1, C_LR, r), generator=gen, device=dev, dtype=dt)
        s_, t_, iq = (torch.randn((1, r), generator=gen, device=dev,
                                  dtype=dt) for _ in range(3))
        combine_case(torch, ops, lr, a, wm, w, s_, t_, iq, f"B7 {shape}",
                     errs)
        del a, b, q, w
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
    return launches, walls


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
    while cp.t < cfg.outer_iters and not (cp.done or ck.done):
        if one_step:
            eps, s = ctl.eps_at(cp.stage), cp.state
            nk, npl = step_k(s, eps, 0.0)[0], step_p(s, eps, 0.0)[0]
            n64 = step_64(up(core, s), eps, 0.0)[0]
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
# phase 4: times
# ---------------------------------------------------------------------------

def phase_times(torch, ops, sk, fs, gen):
    say("phase 4: times (CUDA events, after a warm-up; plain versions are "
        "no yardstick of speed: they repeat the arithmetic in PyTorch ops)")
    dev = "cuda"
    rows = {}
    m = n = N_BIG
    for dt, cdt, tag in ((torch.float32, torch.float32, "f32"),
                         (torch.float64, torch.float64, "f64"),
                         (torch.float32, torch.bfloat16, "bf16-C/f32")):
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
            key = f"{'B1' if kind == 'row' else 'B2'} {kind} {tag}"
            rows[key] = (ms, pms, b, by)
            say(f"  {key} C{m}x{n}: {ms:.5f} ms, bound {b:.5f} ms "
                f"({by}), {b / ms:.1%} of bound; plain {pms:.5f} ms")
        del cost
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        for cols in (N_BIG, 1):
            x = torch.randn((N_BIG, cols), generator=gen, device=dev,
                            dtype=dt)
            p = 1
            nbytes = 2 * x.numel() * x.element_size()
            for kind in ("dtilde", "l"):
                streams = 2 if kind == "dtilde" else 1
                flops = streams * ((p + 1) * (p + 2)) * x.numel()
                wrap = getattr(ops, f"fgc_apply_{kind}")
                plain = getattr(fs, f"apply_{kind}_plain")
                ms = time_ms(torch, lambda: wrap(x, p), reps=5)
                pms = time_ms(torch, lambda: plain(x, p), reps=1, warmup=0)
                b, by = bound_ms(nbytes, flops, str(dt).split(".")[-1])
                key = f"{'B3' if kind == 'dtilde' else 'B4'} {kind} {tag} " \
                      f"x{N_BIG}x{cols}"
                rows[key] = (ms, pms, b, by)
                say(f"  {key} p={p}: {ms:.5f} ms, bound {b:.5f} ms ({by}), "
                    f"{b / ms:.1%} of bound; plain {pms:.5f} ms")
    return rows


def lowrank_times(torch, ops, lr, gen):
    """B5–B7 at Run C's shapes (N = 10⁶, c = 5, r = 16).  Bounds count each
    input read once and each output written once; operations: B5 about
    10 a kernel entry (two LSE passes: add, max, subtract, exp, sum), B6
    2·N·r·(2c + 2 + r) (BᵀQ with Qᵀ1 and Qᵀw, then A·bq and Qᵀ·U), B7
    N·r·(2c + 6)."""
    rows = {}
    n, c, r = N_LR, C_LR, R_LR
    for dt, tag in ((torch.float32, "f32"), (torch.float64, "f64")):
        name = str(dt).split(".")[-1]
        vb = torch.finfo(dt).bits // 8
        lk = torch.randn((1, n, r), generator=gen, device="cuda", dtype=dt)
        gcol = torch.randn((1, r), generator=gen, device="cuda", dtype=dt)
        logw = torch.full((1, n), -math.log(n), device="cuda", dtype=dt)
        a, b, q, w = lr_inputs(torch, gen, n, c, r, dt)
        wm = torch.randn((1, c, r), generator=gen, device="cuda", dtype=dt)
        s_, t_, iq = (torch.randn((1, r), generator=gen, device="cuda",
                                  dtype=dt) for _ in range(3))
        cases = (
            ("B5", lambda: ops.lr_dykstra_half_batched(lk, gcol, logw),
             lambda: lr.dykstra_half_plain(lk, gcol, logw),
             (n * r + 2 * n + 2 * r) * vb, 10.0 * n * r),
            ("B6", lambda: ops.lr_gram_chain_batched(a, b, q, w),
             lambda: lr.gram_chain_plain(a, b, q, w),
             (n * (2 * c + r + 1) + c * r + r * r + 2 * r) * vb,
             2.0 * n * r * (2 * c + 2 + r)),
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
        launches, walls = phase_main_path(torch, np, ops, core, gen)
        lr_launches, lr_walls = phase_lowrank_path(torch, np, ops, core)
        for k, v in lr_launches.items():
            launches[k] += v
        walls.update(lr_walls)
        rows = phase_times(torch, ops, sinkhorn_step, fgc_scan, gen)
        rows.update(lowrank_times(torch, ops, lr_step, gen))
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
                            "library_ms": None})
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
    sys.exit(main())
