"""Counted work of the FGC-GW solve: operations and bytes from shapes and
iteration counts alone, so a count reads the same whatever implements it.

Every stage counts each input byte read once and each output byte written
once, and no more (the convention of a roofline: what the algorithm needs,
not what an implementation moves again).  Operations are elementwise
float operations; an ``exp`` counts one.

A side of a problem is a `Side`: a ``Grid1D`` of n points or a ``Grid2D``
of n×n points, with the metric power k.  The stages of one dense-plan solve
(paper §2.1 with §3's fast gradient) are:

  constant   (D∘D)μ and (D∘D)ν: one apply a side on a vector, once a solve
  product    D_X Γ D_Y: an apply a side on an (M, N) array, each reading
             and writing M·N, once an outer step and once for the energy
  cost       C = C1 − 4·D_X Γ D_Y: reads the product, writes C
  sinkhorn   log mode: two half-steps an inner iteration, each reading C
             once with its vectors and writing one potential; kernel mode:
             K = exp(−C/ε) once an outer step, then two matrix–vector
             products over K an inner iteration
  plan       Γ from C (log) or K (kernel) and the potentials, once an outer
             step
  residual   with a tolerance, the marginal residual at each chunk's end
             (one read of C or K) and the plan's movement each outer step
             (two plans read)
  energy     ⟨Γ, D_X Γ D_Y⟩ at the end: the product's stage again, and one
             read of Γ and of the product

The FGC kernel (B3) applies D̃ along one grid axis.  A 1-D grid's apply of
power p is one such pass; a 2-D grid's is the Kronecker-binomial expansion
Σ_r C(p, r) D1^{⊙r} ⊗ D1^{⊙(p−r)} (paper eq. 3.12), whose factors of power
0 are all-ones sums and not B3 passes.  `fgc_passes` lists the B3 passes
of an apply; `fgc_work` counts their bytes, which is what B3's roofline
divides by B3's time.
"""
from __future__ import annotations

import dataclasses
import math

ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "f32": 4, "bf16": 2}


def itemsize(dtype: str) -> int:
    return ITEMSIZE[dtype]


@dataclasses.dataclass(frozen=True)
class Side:
    """One side of a problem: ``kind`` "Grid1D" (n points) or "Grid2D" (n×n
    points), metric |·|^k."""

    kind: str
    n: int
    k: int = 1

    @property
    def size(self) -> int:
        return self.n if self.kind == "Grid1D" else self.n * self.n


@dataclasses.dataclass
class Work:
    """Operations and bytes, added stage by stage."""

    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, times: float) -> "Work":
        return Work(self.flops * times, self.bytes * times)

    __rmul__ = __mul__


def dtilde_flops_per_element(p: int) -> int:
    """One D̃ = L + Lᵀ apply of power p: the paper's L-apply count (§3:
    p(p+1)/2 multiplications and (p+2)(p+1)/2 additions an element) twice,
    and the sum of the two triangles."""
    return 2 * (p * (p + 1) // 2 + (p + 2) * (p + 1) // 2) + 1


def fgc_passes(side: Side, power_mult: int) -> list[int]:
    """The powers of the B3 passes of one apply of D^{⊙power_mult} along
    this side: one pass for a 1-D grid; for a 2-D grid, one pass for each
    factor of nonzero power in the Kronecker-binomial terms."""
    p = side.k * power_mult
    if side.kind == "Grid1D":
        return [p]
    if side.kind != "Grid2D":
        raise ValueError(f"unknown side kind {side.kind!r}")
    out = []
    for r in range(p + 1):
        out += [q for q in (r, p - r) if q > 0]
    return out


def fgc_apply(side: Side, power_mult: int, elements: int,
              size: int) -> Work:
    """The B3 passes of one apply along ``side`` of an array of
    ``elements`` elements of ``size`` bytes: each pass reads and writes the
    whole array."""
    w = Work()
    for p in fgc_passes(side, power_mult):
        w += Work(dtilde_flops_per_element(p) * elements,
                  2.0 * elements * size)
    return w


def fgc_work(sx: Side, sy: Side, outer: int, dtype: str) -> Work:
    """Every B3 pass of one dense-plan solve: the constant term's two
    vector applies, and the two (M, N) applies of the product at each of
    ``outer`` steps and once more for the energy."""
    s = itemsize(dtype)
    m, n = sx.size, sy.size
    const = fgc_apply(sx, 2, m, s) + fgc_apply(sy, 2, n, s)
    product = fgc_apply(sx, 1, m * n, s) + fgc_apply(sy, 1, m * n, s)
    return const + product * (outer + 1)


def half_steps(m: int, n: int, iters: int, dtype: str,
               cost_dtype: str = "f32") -> Work:
    """``iters`` log-mode inner iterations, two half-steps each: a half-step
    reads the (M, N) cost once in ``cost_dtype``, the other potential and
    its log-marginal, and writes one potential; sub, divide, exp and add an
    element."""
    s, cs = itemsize(dtype), itemsize(cost_dtype)
    row = Work(4.0 * m * n, m * n * cs + (n + 2 * m) * s)
    col = Work(4.0 * m * n, m * n * cs + (m + 2 * n) * s)
    return (row + col) * iters


def kernel_iterations(m: int, n: int, iters: int, dtype: str) -> Work:
    """``iters`` kernel-mode inner iterations: Kᵀa and K(ν / Kᵀa), each
    reading K once (a multiply and an add an element), and the two
    divisions by the marginals."""
    s = itemsize(dtype)
    one = Work(4.0 * m * n + m + n, 2.0 * m * n * s + 3.0 * (m + n) * s)
    return one * iters


def solve_work(sx: Side, sy: Side, outer: int, inner: int, dtype: str,
               mode: str = "log", cost_dtype: str = "f32",
               tol: float = 0.0, chunk: int = 25) -> dict[str, Work]:
    """The counted work of one dense-plan solve that ran ``outer`` outer
    steps and ``inner`` inner iterations in all, by stage (see the module
    docstring).  ``cost_dtype`` is what log-mode half-steps read C in."""
    s = itemsize(dtype)
    m, n = sx.size, sy.size
    mn = m * n
    product = Work(0.0, 0.0)
    for side, count in ((sx, mn), (sy, mn)):
        # an apply reads its input and writes its output once, whatever
        # passes implement it; the operations are its passes' operations
        product += Work(fgc_apply(side, 1, count, s).flops, 2.0 * mn * s)
    out = {
        "constant": Work(fgc_apply(sx, 2, m, s).flops
                         + fgc_apply(sy, 2, n, s).flops,
                         2.0 * (m + n) * s),
        "product": product * (outer + 1),
        "cost": Work(3.0 * mn, 2.0 * mn * s + (m + n) * s) * outer,
        "plan": Work(4.0 * mn, 2.0 * mn * s + (m + n) * s) * outer,
        "energy": Work(2.0 * mn, 2.0 * mn * s),
    }
    if mode == "log":
        out["sinkhorn"] = half_steps(m, n, inner, dtype, cost_dtype)
    elif mode == "kernel":
        out["sinkhorn"] = (Work(3.0 * mn, 2.0 * mn * s) * outer
                           + kernel_iterations(m, n, inner, dtype))
    else:
        raise ValueError(f"unknown Sinkhorn mode {mode!r}")
    if tol > 0.0:
        checks = max(math.ceil(inner / chunk), outer)
        out["residual"] = (Work(4.0 * mn, mn * s) * checks
                           + Work(2.0 * mn, 2.0 * mn * s) * outer)
    return out


def total(stages: dict[str, Work]) -> Work:
    out = Work()
    for w in stages.values():
        out += w
    return out
