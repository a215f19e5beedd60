"""Closed loop of back-to-back solves, one caller: each solve of
`repro_torch.core.entropic_gw` ends in a synchronisation, and the next
starts at once on the next pair of marginals from a pool drawn from the
seed in set-up.

Mix keys: ``n`` (grid points a side, n×n for a 2-D grid), ``pool`` (pairs
of marginals), ``warmup`` (solves in set-up), ``trace_solves`` (the
indices, in the window, of the whole solves the traced stretch covers).

End-to-end: ``solve_ms``, the window's wall from the first solve's start to
the last solve's end over the solves completed; ``peak_mem_gib``, the
allocator's peak over the window.  The window ends with the first solve to
finish after ``seconds``, and not before the solve the check samples.
"""
from __future__ import annotations

import dataclasses
import time

import torch
from torch.profiler import record_function

from gwbench import common, reference, trace, work
from gwbench.record import Context, Window


@dataclasses.dataclass
class _Answer:
    plan: torch.Tensor
    value: torch.Tensor | float
    outer: int
    inner: int


class Driver:
    kind = "closed_solve"

    def __init__(self, cell: common.Cell, seed: int, device: torch.device,
                 variant: dict | None = None):
        self.cell, self.seed, self.device = cell, seed, device
        self.variant = variant or {}
        geo = cell.config["geometry"]
        self.grid_kind, self.k = geo["kind"], int(geo["k"])
        self.n = int(cell.traffic["n"])
        self.size = common.size_of(self.grid_kind, self.n)
        self.pool_size = int(cell.traffic["pool"])
        self.solver = {**cell.solver(), **self.variant.get("solver", {})}
        self.sample = common.rng(seed, "solve").randrange(self.pool_size)
        self.pool = None
        self.kept = None

    # -- the program ------------------------------------------------------

    def _config(self):
        from repro_torch.core import GWConfig
        return GWConfig(**self.solver)

    def _solve(self, gx, gy, mu, nu, cfg) -> _Answer:
        precision = self.variant.get("reference")
        if precision is not None:
            # the control: the reference, in a lower precision, in the
            # program's place
            sol = reference.solve(self._problem(mu, nu), self._settings(),
                                  precision)
            return _Answer(sol.plan, sol.value, sol.outer_iters,
                           sol.inner_iters)
        from repro_torch.core import entropic_gw
        res = entropic_gw(gx, gy, mu, nu, cfg, device=self.device)
        return _Answer(res.plan, res.value, int(res.info.outer_iters),
                       int(res.info.inner_iters))

    def _problem(self, mu, nu) -> reference.Problem:
        return reference.Problem(self.grid_kind, self.n, self.grid_kind,
                                 self.n, self.k, mu, nu)

    def _settings(self) -> reference.Settings:
        s = self.solver
        return reference.Settings(
            eps=s["eps"], outer_iters=s["outer_iters"],
            sinkhorn_iters=s["sinkhorn_iters"],
            mode=s.get("sinkhorn_mode", "log"), tol=s.get("tol", 0.0),
            eps_init=s.get("eps_init"),
            anneal_decay=s.get("anneal_decay", 0.5),
            chunk=s.get("sinkhorn_chunk", 25),
            inner_loosen=s.get("inner_loosen", 1.0))

    def _grids(self):
        g = common.grid(self.grid_kind, self.n, self.k)
        return g, g

    # -- the run ------------------------------------------------------------

    def setup(self) -> None:
        gen = common.generator(self.seed, self.device)
        self.pool = common.marginals(gen, (self.pool_size, 2, self.size),
                                     self.cell.dtype, self.device)
        gx, gy = self._grids()
        cfg = self._config()
        for i in range(int(self.cell.traffic.get("warmup", 1))):
            self._solve(gx, gy, self.pool[i % self.pool_size, 0],
                        self.pool[i % self.pool_size, 1], cfg)
        common.sync(self.device)

    def _work(self, answers) -> dict:
        s = self.solver
        side = work.Side(self.grid_kind, self.n, self.k)
        dt = self.cell.config["dtype"]
        stages, half, fgc = {}, work.Work(), work.Work()
        for a in answers:
            for name, w in work.solve_work(
                    side, side, a.outer, a.inner, dt,
                    s.get("sinkhorn_mode", "log"),
                    s.get("cost_dtype", "f32"), s.get("tol", 0.0),
                    s.get("sinkhorn_chunk", 25)).items():
                stages[name] = stages.get(name, work.Work()) + w
            if s.get("sinkhorn_mode", "log") == "log":
                half += work.half_steps(self.size, self.size, a.inner, dt,
                                        s.get("cost_dtype", "f32"))
            if s.get("backend") == "kernel":
                fgc += work.fgc_work(side, side, a.outer, dt)
        return {"solves": len(answers), "work": stages, "half_steps": half,
                "fgc": fgc}

    def window(self, seconds: float, traced: bool) -> Window:
        gx, gy = self._grids()
        cfg = self._config()
        marks = sorted(self.cell.traffic.get("trace_solves", [1, 2]))
        marks = marks if traced else []
        last = max([self.sample] + marks)
        stretch, summary, profiled = None, None, []
        common.reset_peak(self.device)
        t_open = time.perf_counter()
        count = 0
        while True:
            i = count
            if marks and i == marks[0]:
                stretch = trace.Stretch(self.device).__enter__()
            pair = i % self.pool_size
            with record_function("gwbench.solve"):
                ans = self._solve(gx, gy, self.pool[pair, 0],
                                  self.pool[pair, 1], cfg)
            common.sync(self.device)
            t_end = time.perf_counter()
            count += 1
            if i in marks:
                profiled.append(_Answer(None, 0.0, ans.outer, ans.inner))
            if stretch is not None and i == marks[-1]:
                stretch.__exit__(None, None, None)
                summary, stretch = stretch.summary, None
            if i == self.sample:
                self.kept = (pair, ans)
            del ans
            if t_end - t_open >= seconds and count > last:
                break
        peak = common.peak_bytes(self.device)
        wall = t_end - t_open
        ctx = Context(kind=self.kind, trace=summary,
                      profiled=self._work(profiled),
                      window={"seconds": wall})
        e2e = {"solve_ms": wall / count * 1e3,
               "peak_mem_gib": peak / 2 ** 30}
        return Window(e2e, count, 0, peak, ctx, t_open)

    def release(self) -> None:
        """Free the program's state: only the checked answer and the inputs
        (the benchmark's own) stay."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        from gwbench.check import gaps
        pair, ans = self.kept
        sol = reference.solve(self._problem(self.pool[pair, 0],
                                            self.pool[pair, 1]),
                              self._settings())
        l1, rel = gaps(ans.plan, ans.value, sol)
        return {"plan_l1": l1, "value_rel": rel}
