#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. Device and build: the card's name and power limit (``nvidia-smi``), the
   torch and CUDA versions, and the build of every kernel from
   ``src/repro_torch/kernels/csrc`` for ``sm_90a`` (seconds, registers).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (8192 × 8192 and 8192 × 1) and dtypes, plus zero-mass rows
   and columns, an all-masked leading block of columns and four lanes with
   four different ε.  Each line prints the measured difference beside its
   tolerance and the reason for it.
3. The main path through ``repro_torch.core.entropic_gw``: a small check
   of the FGC kernels against the dense oracle, Run A (``Grid1D(8192)``,
   the paper's §4.1 settings, f32 and f64) and Run B (``Grid2D(64)``, f64,
   adaptive with ε-annealing), each against the plain path on the card,
   then the FGC primitives ``apply_L``/``apply_LT``.  The launch counts are
   set to 0 just before each path and read just after.
4. Times: each kernel (CUDA events) beside its bound and its plain
   version's time.
5. The ``kernels`` JSON line, and the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

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
                  label, results):
    """One half-step kernel against its plain version.  Differences are
    counted in ulps of the operand scale ε·max(|log w|, |lse|) of the final
    subtraction f = ε(log w − lse): the scale its rounding is set by."""
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
    diff = (got - want).abs()[fin]
    lse = (logw - want / e[:, None])
    scale = (e[:, None] * torch.maximum(logw.abs(), lse.abs()))[fin]
    ulps = float((diff / ulp_of(torch, scale)).max()) if diff.numel() else 0.
    out_ulps = float((diff / ulp_of(torch, want.abs()[fin]
                                    .clamp_min(torch.finfo(want.dtype)
                                               .tiny))).max()) \
        if diff.numel() else 0.0
    max_abs = float(diff.max()) if diff.numel() else 0.0
    say(f"  {label}: max |Δ| {max_abs:.3e} = {ulps:.2f} ulp of the operand "
        f"scale ({out_ulps:.2f} ulp of the output); tolerance "
        f"{tol_ulp} ulp: the online (max, sumexp) associates the sum "
        f"otherwise than the plain two-pass logsumexp (reference bar: 1)")
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
        sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, eps, 2,
                      f"B1 row {tag} C{m}x{n}", errs)
        sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, eps, 2,
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
    sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, 0.01, 2,
                  "B1 row zero-mass f64", errs)
    sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, 0.01, 2,
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
    sinkhorn_case(torch, ops, sk, "row", cost, g, log_mu, epss, 2,
                  "B1 row 4 lanes/4 eps f64", errs)
    sinkhorn_case(torch, ops, sk, "col", cost, f, log_nu, epss, 2,
                  "B2 col 4 lanes/4 eps f64", errs)
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
        from repro_torch.kernels import build, fgc_scan, ops, sinkhorn_step
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
        launches, walls = phase_main_path(torch, np, ops, core, gen)
        rows = phase_times(torch, ops, sinkhorn_step, fgc_scan, gen)
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
