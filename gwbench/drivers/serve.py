"""GW serving: an endless stream of distinct requests pulled by
`repro_torch.serve.engine.GWEngine.serve` under its own backpressure (a
closed loop with ``max_inflight_buckets × max_batch`` requests
outstanding).  When the window ends the stream stops and the requests still
out are drained.

Mix keys: ``sizes`` ([lo, hi]: each side's points drawn uniformly, both
ends included), ``eps_cycle`` (request j of the bank takes entry j mod its
length), ``request`` (knobs every request carries: ``eps_init``,
``anneal_decay``), ``engine`` (the `GWServeConfig` fields), ``bank``
(distinct requests, drawn in set-up from ``bank_seed``): every run serves
the bank in its order, whatever the seed, cycling through it when a window
pulls more; ``warmup`` (the bank's last requests, served in
set-up at ``warmup_eps``), ``check`` (``per_class``: answers checked an ε
class, one in each of ``per_class`` equal stretches of the window: the
first answer of the class that `serve` yields after a time drawn from the
seed in its stretch, the drain's included; the seed chooses nothing else),
``trace`` ([start, length] of the traced stretch in seconds from the
window's start).

End-to-end: ``answers_per_s``, the requests answered in the window over the
window's length; ``answer_p95_ms``, the 95th percentile of the time from
the engine's pull of a request to `serve` yielding its answer, over every
request answered in the window; ``peak_mem_gib``, the allocator's
peak.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gwbench import common, reference, trace, work
from gwbench.record import Context, Window


class Driver:
    kind = "serve"

    def __init__(self, cell: common.Cell, seed: int, device: torch.device,
                 variant: dict | None = None):
        if variant and "reference" in variant:
            raise ValueError("the serving driver runs the program only: its "
                             "control is a path of the program")
        self.cell, self.seed, self.device = cell, seed, device
        self.variant = variant or {}
        t = cell.traffic
        geo = cell.config["geometry"]
        if geo["kind"] != "Grid1D":
            raise ValueError("the serving mix draws 1-D grids")
        self.k = int(geo["k"])
        self.lo, self.hi = (int(v) for v in t["sizes"])
        self.cycle = [float(e) for e in t["eps_cycle"]]
        self.bank_size = int(t["bank"])
        self.solver = {**cell.solver(), **self.variant.get("solver", {})}
        self.engine = None
        self.store = None
        self.kept: dict[int, tuple] = {}
        self.base = 0
        self.targets = self._draw_targets(seed)
        self.details: list[dict] = []

    def _eps(self, i: int) -> float:
        return self.cycle[(i % self.bank_size) % len(self.cycle)]

    def _draw_targets(self, seed) -> dict[float, list[float]]:
        """For each ε class, the times (shares of the window) after which
        an answer is checked: one drawn in each of ``per_class`` equal
        stretches."""
        per = int(self.cell.traffic["check"]["per_class"])
        pick = common.rng(seed, "serve")
        return {eps: [(k + pick.random()) / per for k in range(per)]
                for eps in self.cycle}

    # -- requests ---------------------------------------------------------

    def _request(self, i: int, j: int | None = None):
        """Stream position i's request (or the bank's request j): its
        problem and its knobs."""
        j = i % self.bank_size if j is None else j
        m, n = int(self.sizes[j, 0]), int(self.sizes[j, 1])
        mu = self.u[j, 0, :m]
        nu = self.u[j, 1, :n]
        mu, nu = mu / mu.sum(), nu / nu.sum()
        knobs = dict(self.cell.traffic.get("request", {}),
                     eps=self.cycle[j % len(self.cycle)])
        return ((common.grid("Grid1D", m, self.k),
                 common.grid("Grid1D", n, self.k), mu, nu), knobs)

    def _warm(self, j: int, eps):
        """The bank's request j as set-up serves it: at ``eps`` when given
        (every width of the window's batches is met all the same)."""
        prob, knobs = self._request(0, j)
        return prob, (knobs if eps is None else dict(knobs, eps=float(eps)))

    def _engine(self):
        from repro_torch.core import GWConfig
        from repro_torch.serve.engine import GWEngine, GWServeConfig
        return GWEngine(GWServeConfig(solver=GWConfig(**self.solver),
                                      device=self.device,
                                      **self.cell.traffic["engine"]))

    def setup(self) -> None:
        bank_seed = int(self.cell.traffic["bank_seed"])
        gen = common.generator(bank_seed, self.device)
        self.u = torch.rand((self.bank_size, 2, self.hi), generator=gen,
                            dtype=self.cell.dtype, device=self.device) + 0.05
        sizes = common.generator(bank_seed, torch.device("cpu"))
        self.sizes = torch.randint(self.lo, self.hi + 1,
                                   (self.bank_size, 2), generator=sizes)
        self.engine = self._engine()
        warm = int(self.cell.traffic.get("warmup", 0))
        eps = self.cell.traffic.get("warmup_eps")
        for _ in self.engine.serve(self._warm(self.bank_size - warm + i, eps)
                                   for i in range(warm)):
            pass
        self.base = warm
        # the checked plans, copied out as they come without a wait on the
        # host, into memory the allocator's peak does not count
        slots = sum(len(v) for v in self.targets.values())
        self.store = torch.empty((slots, self.hi * self.hi),
                                 dtype=self.cell.dtype,
                                 pin_memory=self.device.type == "cuda")
        common.sync(self.device)

    def _keep(self, i: int, at: float, res) -> None:
        """Keep answer i if it is the first of its class after one of the
        class's check times (``at``: its share of the window)."""
        due = self.targets[self._eps(i)]
        if not due or due[0] > at:
            return
        due.pop(0)
        slot = len(self.kept)
        m, n = res.plan.shape
        self.store[slot, :m * n].view(m, n).copy_(res.plan,
                                                  non_blocking=True)
        self.kept[i] = (slot, m, n, res.value, int(res.info.outer_iters),
                        int(res.info.inner_iters), at)

    # -- the window -------------------------------------------------------

    def _served_work(self, i: int, res) -> work.Work:
        s = self.solver
        m, n = (int(v) for v in self.sizes[i % self.bank_size])
        return work.total(work.solve_work(
            work.Side("Grid1D", m, self.k), work.Side("Grid1D", n, self.k),
            int(res.info.outer_iters), int(res.info.inner_iters),
            self.cell.config["dtype"], s.get("sinkhorn_mode", "log"),
            s.get("cost_dtype", "f32"), float(s.get("tol", 0.0)),
            int(s.get("sinkhorn_chunk", 25))))

    def window(self, seconds: float, traced: bool) -> Window:
        pulled: list[float] = []
        t_open = time.perf_counter()
        t_close = t_open + seconds

        def source():
            i = 0
            while time.perf_counter() < t_close:
                item = self._request(i)
                pulled.append(time.perf_counter())
                i += 1
                yield item

        t_on, length = (float(v) for v in
                        self.cell.traffic.get("trace", [seconds / 3, 3.0]))
        t_on, t_off = t_on + t_open, math.inf
        stretch, summary = None, None
        lat, served, stats, total = [], work.Work(), None, 0
        common.reset_peak(self.device)
        for rid, res in self.engine.serve(source()):
            now = time.perf_counter()
            i = rid - self.base
            total += 1
            self._keep(i, (now - t_open) / seconds, res)
            if now <= t_close:
                lat.append(now - pulled[i])
                served += self._served_work(i, res)
                stats = {k: (dict(v) if isinstance(v, dict) else v)
                         for k, v in self.engine.stats.items()}
            del res
            if traced and stretch is None and summary is None \
                    and now >= t_on:
                stretch = trace.Stretch(self.device).__enter__()
                t_off = time.perf_counter() + length
            elif stretch is not None and now >= t_off:
                stretch.__exit__(None, None, None)
                summary, stretch = stretch.summary, None
        if stretch is not None:
            stretch.__exit__(None, None, None)
            summary = stretch.summary
        peak = common.peak_bytes(self.device)
        answers = len(lat)
        ctx = Context(kind=self.kind, trace=summary,
                      window={"seconds": seconds, "answers": answers,
                              "stats": stats or {}, "served": served})
        e2e = {"answers_per_s": answers / seconds,
               "answer_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                                 if lat else math.nan),
               "peak_mem_gib": peak / 2 ** 30}
        # a request answered after the window is late, not failed; one the
        # drain never answered has failed
        return Window(e2e, len(pulled), len(pulled) - total, peak, ctx,
                      t_open)

    def release(self) -> None:
        self.engine = None
        common.sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self) -> dict:
        """The widest gaps, over the checked answers, from the reference's
        solo solve of the same request: the plans' L1 gap, the value's
        relative gap and the relative gap of the plan's value (the
        reference's energy of the program's plan).  ``details`` keeps each
        answer's readings and both sides' iteration counts."""
        from gwbench.check import gaps
        s = self.solver
        self.details = []
        for i, (slot, m, n, value, outer, inner, at) in sorted(
                self.kept.items()):
            plan = self.store[slot, :m * n].view(m, n)
            (gx, gy, mu, nu), knobs = self._request(i)
            prob = reference.Problem("Grid1D", gx.n, "Grid1D", gy.n, self.k,
                                     mu, nu)
            sol = reference.solve(prob, reference.Settings(
                eps=knobs["eps"], outer_iters=s["outer_iters"],
                sinkhorn_iters=s["sinkhorn_iters"],
                mode=s.get("sinkhorn_mode", "log"), tol=s["tol"],
                eps_init=knobs.get("eps_init"),
                anneal_decay=knobs.get("anneal_decay", 0.5),
                chunk=s.get("sinkhorn_chunk", 25)))
            l1, rel = gaps(plan, value, sol)
            plan_rel = abs(reference.energy(prob, plan) - sol.value) \
                / abs(sol.value)
            self.details.append({
                "request": i, "at": at, "eps": knobs["eps"], "m": gx.n,
                "n": gy.n,
                "value_rel": rel, "plan_energy_rel": plan_rel,
                "plan_l1": l1, "outer": [outer, sol.outer_iters],
                "inner": [inner, sol.inner_iters]})
        if not self.details:
            return {}
        return {key + "_max": max(d[key] for d in self.details)
                for key in ("plan_l1", "value_rel", "plan_energy_rel")}
