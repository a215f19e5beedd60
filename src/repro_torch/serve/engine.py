"""Batched serving engines: the LM `Engine`, and the GW engine with its
admission queue, buckets, and three schedulers.

Reference: ``repro/serve/engine.py`` (``ServeConfig``, ``Engine``,
``GWServeConfig``, ``_Request``, ``_new_stats``, the lane surgery
``_write_lanes`` / ``_retire_lanes`` / ``_gather_lanes``,
``_service_tier``, ``_BucketRun``, ``GWEngine`` and ``run_event_loop``).

`Engine` (LM) prefills a batch of equal-length prompts into preallocated
caches and decodes token by token (greedy, or sampled with a temperature
from a `torch.Generator` seeded with ``rng_seed``, where the reference
draws ``jax.random.categorical``: the same Gumbel-max rule, other bits).
A request that has emitted ``eos_id`` keeps repeating its token.

`GWEngine` takes Gromov-Wasserstein requests over any geometry (uniform
grids on the FGC path, low-rank factored costs, point clouds, dense
matrices) and groups them into buckets by geometry spec: the plan
representation, each side's class and static params, the sizes rounded up
to ``size_bucket``, and the objective (GW, or FGW with its θ).  A bucket's
requests run as the lanes of one lane-leading batch on the port's
segmented surface (`repro_torch.core.gw._segment_stacked`), so every
kernel launches once for all of a batch's lanes: B1/B2 on every inner
sweep of a full-plan bucket, B3 in a grid bucket's gradient on the FGC
``kernel`` backend, B5–B7 in a factored bucket.

Schedulers (``GWServeConfig.scheduler``):

``"continuous"`` (default)
    A bucket's requests take the slots of a batch whose width is the
    queue length rounded up to a power of two (at most ``max_batch``).
    Each dispatch advances every lane by at most ``segment_iters`` outer
    steps; finished lanes are harvested and their slots refilled from the
    queue; once the queue drains, a mostly empty batch is repacked to a
    narrower width.  A lane's schedule is a function of its own carried
    counters, and every kernel (by its lane-count-invariant plan) and
    every PyTorch step that would split its work by the batch's width
    (`geometry.per_lane`) gives a lane the bits it has alone, so a request
    returns the plan, the potentials and the counts of its solo solve, bit
    for bit, whatever its slot-mates.
``"pipeline"``
    The same per-bucket loop across buckets at once: up to
    ``max_inflight_buckets`` buckets each have one segment in flight, and
    the host harvests whichever finishes first.  The driver is a host loop
    that reads lane flags once per outer step, so a segment blocks the
    thread that runs it: each in-flight segment runs on a worker thread of
    its own, on a `torch.cuda.Stream` of its own (on the CPU, threads
    without streams).  The operands and refills the main thread made are
    ordered before the worker's stream by an event; the worker
    synchronises its stream before its future completes, so a harvest
    reads finished values; every tensor that crosses the two streams is
    marked used on both (`_Dispatcher`).  Results equal the continuous
    scheduler's bit for bit.
``"barrier"``
    Chunked one-shot `entropic_gw_batch` calls, each chunk running until
    its slowest lane finishes: the baseline.

The reference's async dispatch polls ``MirrorCarry.dispatch_ready`` and
donates carry buffers; here ``ready()`` is the worker future's ``done()``,
and ``donate_carries`` is kept for the reference's API only: the port has
one code path, so results with and without it are the same bits (the
reference promises 1e-12).  The reference bounds its jit cache by padding
refills to the slot width; here there is no compile cache, only the
slot-width menu (≤ log2(max_batch)+1 widths a bucket, so the kernels' plan
caches stay bounded) and the kernels are built once, before a stream.

A harvested result owns its tensors: it is cloned out of the batch, and
lane surgery (refills, repacks, retirements) builds new tensors instead of
writing the batch in place, so a refill never changes a result a caller
holds, nor an entry of the plan cache (`repro_torch.serve.cache`), whose
exact hits return a stored result with no device work and whose near and
profile hits warm-start a lane from a cached coupling.  The sliced tier
(``service="sliced"`` / ``"refine"``) answers from
`repro_torch.core.sliced` in one call; its direction bank is drawn from a
CPU generator seeded with ``sliced_seed``, or taken from
``sliced_directions``.

The engine runs on the CUDA device unless ``GWServeConfig.device`` says
otherwise (``device="cpu"`` for the plain PyTorch path); with no card and
no device it raises.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core.coupling import FullCoupling
from repro_torch.core.geometry import GridGeometry, as_geometry
from repro_torch.core.gw import (GWConfig, GWResult, _init_stacked,
                                 _result_of, _segment_stacked, as_tensor,
                                 entropic_gw_batch, resolve_device,
                                 stack_problems)
from repro_torch.core.sliced import (_canonical_keys, _sliced_core,
                                     _sliced_plan_core, sliced_embedding,
                                     sliced_supported)
from repro_torch.core.solver import (ConvergenceInfo, MirrorCarry,
                                     SolveControls, fields_of, info_of,
                                     init_carry, tensor_leaves)
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.serve.cache import Fingerprint, PlanCache, fingerprint
from repro_torch.serve.calibration import HardnessCalibrator

SERVICES = ("exact", "sliced", "refine")


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    batch_size: int = 4
    temperature: float = 0.0      # 0 = greedy
    eos_id: int = -1              # -1: never stop early
    cache_dtype: str = "float32"


class Engine:
    """Prefill + decode for a batch of ``scfg.batch_size`` requests on the
    device of ``params`` (an `repro_torch.models.lm.LM`)."""

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig,
                 rng_seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.device = next(params.parameters()).device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rng_seed)

    def _sample(self, logits):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        u = torch.rand(logits.shape, generator=self.generator,
                       device=self.device, dtype=logits.dtype)
        u = u.clamp_min(torch.finfo(logits.dtype).tiny)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits / self.scfg.temperature + gumbel, dim=-1)

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int,
                 return_logits: bool = False):
        """prompts: (B, S0) token ids, all of one length (the caches hold
        one length for the batch).  Returns the (B, max_new_tokens) tokens
        as a numpy array, and with ``return_logits`` also the f32 logits
        that chose each of them and the last step's, (B, max_new_tokens +
        1, V) on the device.  With no new tokens it runs the prefill
        alone."""
        cfg, scfg = self.cfg, self.scfg
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                  device=self.device)
        b = prompts.shape[0]
        if b != scfg.batch_size:
            raise ValueError(f"{b} prompts for a batch of {scfg.batch_size}")
        caches = lm.cache_init(cfg, b, scfg.max_len, scfg.cache_dtype,
                               self.device)
        logits, caches = lm.prefill(self.params, {"tokens": prompts}, cfg,
                                    caches)
        seen = [logits]
        out = []
        tok = self._sample(logits)
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        for _ in range(max_new_tokens):
            out.append(tok)
            done = done | (tok == scfg.eos_id)
            logits, caches = lm.decode_step(self.params,
                                            {"tokens": tok[:, None]},
                                            caches, cfg)
            seen.append(logits)
            tok = torch.where(done, tok, self._sample(logits))
        tokens = (torch.stack(out, dim=1) if out else torch.zeros(
            (b, 0), dtype=torch.long)).cpu().numpy()
        if return_logits:
            return tokens, torch.stack(seen, dim=1)
        return tokens


@dataclasses.dataclass
class GWServeConfig:
    solver: GWConfig = dataclasses.field(default_factory=GWConfig)
    max_batch: int = 16        # cap problems per batch / slot batch
    size_bucket: int = 64      # pad 1D sizes up to multiples of this
    #: serving-time convergence tolerance; overrides ``solver.tol`` when
    #: set (a per-lane control: retuning it between flushes reaches queued
    #: requests)
    tol: float | None = None
    #: "continuous" | "pipeline" | "barrier" (see the module docstring)
    scheduler: str = "continuous"
    #: outer mirror-descent steps per continuous dispatch
    segment_iters: int = 6
    #: order each bucket's queue by predicted hardness (hardest first)
    order_by_hardness: bool = True
    #: log-mode dual-update backend for every dispatch ("auto" | "kernel" |
    #: "torch"); overrides ``solver.sinkhorn_backend`` when set
    sinkhorn_backend: str | None = None
    #: factored-plan kernel backend for every dispatch; overrides
    #: ``solver.lowrank_backend`` when set
    lowrank_backend: str | None = None
    #: plan representation for queued requests ("full" | "lowrank"); None
    #: inherits ``solver.plan``.  Per-request ``submit(plan=...)`` wins.
    #: The plan leads the bucket key.
    plan: str | None = None
    #: requests whose larger side has ≥ this many points go to the
    #: factored plan (unless submit() pinned one); None disables it
    lowrank_above: int | None = None
    #: pipeline scheduler: buckets with a segment in flight at once (one
    #: worker thread, and on the card one stream, each)
    max_inflight_buckets: int = 2
    #: kept for the reference's API: the port has one code path, so
    #: pipelined results with and without it are the same bits
    donate_carries: bool = True
    #: solved-plan cache entries (`repro_torch.serve.cache.PlanCache`); 0
    #: disables caching
    cache_capacity: int = 0
    #: near-hit tolerance: content equal after quantization to this grid
    #: warm-starts from the cached coupling (annealing off); 0 keeps the
    #: cache exact-only
    cache_near_tol: float = 0.0
    #: answer class for requests that do not pin one: "exact", "sliced"
    #: (the sliced estimate, one call, no plan) or "refine" (the sliced
    #: answer first, then the exact solve warm-started from its plan)
    service: str = "exact"
    #: exact requests are scheduled ahead of refine ones at every decision
    #: point (refine callers already hold their sliced preliminary)
    refine_priority: bool = True
    #: sliced tier: projection directions (also the cache profile length)
    sliced_n_proj: int = 32
    #: sliced tier: seed of the direction bank, fixed per engine so
    #: profiles are comparable across requests
    sliced_seed: int = 0
    #: sliced tier: explicit direction banks, {d_max: (d_max, n_proj)}; a
    #: dimension absent from it draws its bank from ``sliced_seed``.  The
    #: reference draws its bank with ``jax.random``, whose bits PyTorch
    #: cannot redraw: parity runs carry the reference's banks here
    #: (`repro_torch.convert.serve_config`)
    sliced_directions: dict | None = None
    #: second cache stage: on a digest miss, a same-bucket cached solve
    #: whose sliced profile is within this normalized distance warm-starts
    #: the request (rotated / re-indexed repeats); 0 disables it
    cache_profile_tol: float = 0.0
    #: learn `predicted_hardness` online per bucket from observed counts
    calibrate_hardness: bool = True
    calib_min_obs: int = 12
    #: the engine's device: None is the CUDA device (raising without one),
    #: "cpu" the plain PyTorch path
    device: str | torch.device | None = None

    def solver_cfg(self) -> GWConfig:
        cfg = self.solver
        if self.tol is not None:
            cfg = dataclasses.replace(cfg, tol=self.tol)
        if self.sinkhorn_backend is not None:
            cfg = dataclasses.replace(cfg,
                                      sinkhorn_backend=self.sinkhorn_backend)
        if self.lowrank_backend is not None:
            cfg = dataclasses.replace(cfg,
                                      lowrank_backend=self.lowrank_backend)
        return cfg


@dataclasses.dataclass
class _Request:
    """A queued GW solve: the problem and the knobs submit() was given
    explicitly.  Effective controls are resolved against the engine config
    at FLUSH time (`GWEngine._resolve`), so retuning engine-level knobs
    still reaches queued requests."""

    rid: int
    prob: tuple                      # (geom_x, geom_y, mu, nu)
    overrides: dict                  # explicit per-request knobs
    #: FGW feature-cost matrix (M, N), or None for a plain GW request
    feature: torch.Tensor | None = None
    #: err trace observed before a bucket failure interrupted this request
    errs: np.ndarray | None = None
    #: resolved at flush time by _resolve()
    ctl: SolveControls | None = None
    knobs: tuple | None = None       # (eps, tol, eps_init, anneal_decay)
    plan: str | None = None          # effective plan
    theta: float | None = None       # effective FGW feature weight
    #: cache identity, computed at flush time when the engine has a cache
    fp: Fingerprint | None = None
    #: warm-start source: a cached `GWResult` (annealing off) or the
    #: refine tier's sliced preliminary (annealing on)
    warm: GWResult | None = None
    #: answer class, resolved at flush time ("exact" | "sliced" | "refine")
    service: str = "exact"
    #: sliced fast-tier outputs, computed at most once per request
    sliced_est: float | None = None
    sliced_profile: np.ndarray | None = None
    #: per-side canonical atom orders: the correspondence that re-indexes
    #: a profile-matched cached plan onto this request's atoms
    sliced_orders: tuple | None = None
    #: exact bytes of the resolved value knobs, taken before any warm-start
    #: change of ``ctl``: the profile stage's knob key
    knob_key: bytes | None = None


def _new_stats() -> dict:
    """Per-flush scheduler accounting.  ``executed_*`` count the
    lane-iterations a batch ran (lanes run in lockstep: a dispatch costs
    its width × the slowest lane's advance); ``useful_*`` those the
    requests needed.  ``flush_wall_s`` is the flush's wall time;
    ``dispatch_depth`` histograms the segments in flight (issued, not yet
    harvested) at each issue; ``device_idle_s`` the time with none in
    flight.  The cache counters mirror the flush's `PlanCache` traffic, and
    ``sliced_answers`` counts results of the sliced tier."""
    return {"dispatches": 0, "executed_outer": 0, "useful_outer": 0,
            "executed_inner": 0, "useful_inner": 0, "refills": 0,
            "repacks": 0, "flush_wall_s": 0.0, "dispatch_depth": {},
            "device_idle_s": 0.0, "cache_hits": 0, "cache_misses": 0,
            "cache_warm_starts": 0, "cache_profile_hits": 0,
            "sliced_answers": 0}


# ---------------------------------------------------------------------------
# lane surgery on a batch's operands and carry.  In a batch's dataclasses
# (stacked geometries, SolveControls, couplings, MirrorCarry) a tensor is
# lane-leading and a tuple is one entry a lane (a GridStack's grids, a
# carry's counters); other fields are static.  Every function builds new
# tensors: results harvested from a batch never see a later write.
# ---------------------------------------------------------------------------

def _lane_fields(tree, fn):
    """``tree`` (a dataclass) with ``fn`` applied to each field's value."""
    return dataclasses.replace(tree, **{
        f.name: fn(f.name) for f in dataclasses.fields(tree) if f.init})


def _is_record(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _take_lanes(tree, idx: list[int]):
    """Lanes ``idx`` of a batch tree (the reference's ``_gather_lanes``)."""
    if isinstance(tree, torch.Tensor):
        return tree.index_select(0, torch.tensor(idx, device=tree.device))
    if isinstance(tree, tuple):
        return tuple(tree[i] for i in idx)
    if _is_record(tree):
        return _lane_fields(tree, lambda n: _take_lanes(getattr(tree, n),
                                                        idx))
    return tree


def _cat_lanes(trees: list):
    """Batch trees of one structure joined along their lanes."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return torch.cat(trees) if len(trees) > 1 else t0
    if isinstance(t0, tuple):
        return sum(trees, ())
    if _is_record(t0):
        return _lane_fields(t0, lambda n: _cat_lanes(
            [getattr(t, n) for t in trees]))
    return t0


def _put_lanes(tree, idx: list[int], new):
    """``tree`` with its lanes ``idx`` replaced by the lanes of ``new``, in
    order (the reference's ``_write_lanes``), as new tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.index_copy(0, torch.tensor(idx, device=tree.device),
                               new.to(tree.dtype))
    if isinstance(tree, tuple):
        out = list(tree)
        for k, i in enumerate(idx):
            out[i] = new[k]
        return tuple(out)
    if _is_record(tree):
        return _lane_fields(tree, lambda n: _put_lanes(getattr(tree, n), idx,
                                                       getattr(new, n)))
    return tree


def _retire_lanes(carry: MirrorCarry, mask) -> MirrorCarry:
    """Mark masked lanes done so idle slots never take a step."""
    return dataclasses.replace(carry, done=tuple(
        bool(d) or bool(m) for d, m in zip(carry.done, mask)))


def _owned_result(res: GWResult) -> GWResult:
    """``res`` with its own copies of every tensor, so it pins no batch
    state and no later write to one reaches it."""
    info = res.info
    info = dataclasses.replace(info, marginal_err=info.marginal_err.clone(),
                               err_trace=info.err_trace.clone())
    coup = type(res.coupling)(*(t.clone() for t in fields_of(res.coupling)))
    return _result_of(coup, res.value.clone(), info)


def _service_tier(req: _Request) -> int:
    """Admission priority tier: 0 = exact (a caller is blocked on this),
    1 = refine (its caller already has the sliced preliminary)."""
    return 1 if req.service == "refine" else 0


class _Dispatcher:
    """The pipeline's segment runner: ``workers`` threads, each with a CUDA
    stream of its own on a card.

    The caching allocator hands a freed block back to the stream that
    allocated it at once, so each tensor crossing between the main stream
    and a worker's is ordered both ways:

    - main → worker: ``submit`` records an event on the main stream, which
      the worker's stream waits on before the segment, so the operands and
      refills the main thread enqueued come first; the worker marks the
      operands and carry as used on its stream (``record_stream``), so no
      main-stream allocation reuses them before the segment has run.
    - worker → main: the worker synchronises its stream before its future
      completes, so the outputs are written; ``result`` marks them as used
      on the main stream, so once the main thread drops them (a harvest's
      clone, a refill's or repack's read still queued) no worker's
      segment, on any stream, reuses their blocks before those reads run."""

    def __init__(self, workers: int, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.local = threading.local()
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="gw-segment")

    def submit(self, ops, carry, cfg, segment):
        ready = None
        if self.cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return self.pool.submit(self._run, ready, ops, carry, cfg, segment)

    def _run(self, ready, ops, carry, cfg, segment):
        if not self.cuda:
            return _segment_stacked(*ops, carry, cfg, segment)
        stream = getattr(self.local, "stream", None)
        if stream is None:
            stream = self.local.stream = torch.cuda.Stream(self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
            for t in tensor_leaves((ops, carry)):
                t.record_stream(stream)
            out = _segment_stacked(*ops, carry, cfg, segment)
        stream.synchronize()
        return out

    def result(self, future):
        """A finished segment's (carry, values), marked as used on the
        main thread's stream (see the class docstring)."""
        out = future.result()
        if self.cuda:
            main = torch.cuda.current_stream(self.device)
            for t in tensor_leaves(out):
                t.record_stream(main)
        return out

    def close(self) -> None:
        self.pool.shutdown(wait=True)


class _BucketRun:
    """One bucket's continuous-batching state, split into issue / ready /
    harvest.

    ``issue()`` refills freed slots and dispatches the next segment: inline
    for the continuous scheduler, on a worker of ``dispatcher`` for the
    pipeline.  ``ready()`` says (without blocking) whether the segment has
    finished.  ``harvest()`` waits for it, returns converged lanes'
    results, repacks stragglers, and reports whether the bucket still has
    work."""

    def __init__(self, engine: "GWEngine", key, entries,
                 dispatcher: _Dispatcher | None = None):
        self.eng = engine
        self.key = key
        self.dispatcher = dispatcher
        self.cfg = engine._bucket_cfg(key)
        self.pad_to = (key[2], key[4])
        self.segment = max(1, int(engine.cfg.segment_iters))
        if engine.cfg.order_by_hardness:
            entries = sorted(entries, key=engine.predicted_hardness,
                             reverse=True)
        if engine.cfg.refine_priority:
            # stable: exact-first, hardness order preserved within a tier
            entries = sorted(entries, key=_service_tier)
        self.pending = collections.deque(entries)
        b = engine._slot_width(len(entries))
        self.b = b
        # initial slot batch: the first B requests; short queues replicate
        # the first problem into the unused slots, retired before the first
        # dispatch so they never take a step
        first = [self.pending.popleft()
                 for _ in range(min(b, len(self.pending)))]
        self.slots: list[Optional[_Request]] = (
            list(first) + [None] * (b - len(first)))
        filler = [(s or first[0]) for s in self.slots]
        self.ops, _, _ = stack_problems(
            [r.prob for r in filler], self.cfg, self.pad_to,
            [r.ctl for r in filler], engine.device, _features(filler))
        self.carry = _init_stacked(*self.ops[:4], self.cfg)
        # warm starts in the initial batch: their cold lanes overwritten,
        # through the same write a refill takes
        warm = [(i, engine._lane_operands(r, self.pad_to, self.cfg))
                for i, r in enumerate(first) if r.warm is not None]
        if warm:
            self._scatter(warm)
        if len(first) < b:
            self.carry = _retire_lanes(self.carry,
                                       [s is None for s in self.slots])
        self.t_prev = np.zeros(b, np.int64)
        self.inner_prev = np.zeros(b, np.int64)
        self.values = None
        self.future = None

    def live(self) -> bool:
        return any(s is not None for s in self.slots) or bool(self.pending)

    def _scatter(self, refills) -> None:
        """Write refilled requests' operands and carries into their slots:
        the real refills only, joined into one write a field."""
        idx = [i for i, _ in refills]
        ops = [o for _, (o, _) in refills]
        carries = [c for _, (_, c) in refills]
        self.ops = tuple(_put_lanes(a, idx, _cat_lanes(list(parts)))
                         for a, parts in zip(self.ops, zip(*ops)))
        self.carry = _put_lanes(self.carry, idx, _cat_lanes(carries))

    def issue(self) -> None:
        """Refill freed slots, then dispatch the next segment."""
        eng = self.eng
        refills: list[tuple[int, tuple]] = []
        for i in range(self.b):
            if self.slots[i] is None and self.pending:
                req = self.pending.popleft()
                refills.append(
                    (i, eng._lane_operands(req, self.pad_to, self.cfg)))
                self.slots[i] = req
                self.t_prev[i] = self.inner_prev[i] = 0
                eng.stats["refills"] += 1
        if refills:
            self._scatter(refills)
        eng._mark_issue()
        if self.dispatcher is not None:
            self.future = self.dispatcher.submit(self.ops, self.carry,
                                                 self.cfg, self.segment)
        else:
            try:
                self.carry, self.values = _segment_stacked(
                    *self.ops, self.carry, self.cfg, self.segment)
            except Exception:
                eng._mark_drain()
                raise
        eng.stats["dispatches"] += 1

    def ready(self) -> bool:
        """Has the last issued segment finished?  Never blocks."""
        return self.future is None or self.future.done()

    def harvest(self, results: dict, done: set) -> bool:
        """Wait for the issued segment, harvest finished lanes into
        ``results``/``done``, repack stragglers.  Returns ``live()``: False
        retires the run.  A segment's error is raised here, with the carry
        it started from kept (`record_interrupt`)."""
        eng = self.eng
        if self.future is not None:
            future, self.future = self.future, None
            try:
                self.carry, self.values = self.dispatcher.result(future)
            finally:
                eng._mark_drain()
        else:
            eng._mark_drain()
        carry, b = self.carry, self.b
        t = np.asarray(carry.t, np.int64)
        inner = np.asarray(carry.inner, np.int64)
        finished = np.asarray(carry.done, bool) | (t >= self.cfg.outer_iters)
        adv_t, adv_i = t - self.t_prev, inner - self.inner_prev
        eng.stats["executed_outer"] += int(b * adv_t.max())
        eng.stats["executed_inner"] += int(b * adv_i.max())
        live = np.asarray([s is not None for s in self.slots])
        eng.stats["useful_outer"] += int(adv_t[live].sum())
        eng.stats["useful_inner"] += int(adv_i[live].sum())
        self.t_prev, self.inner_prev = t, inner
        for i in range(b):
            if self.slots[i] is not None and finished[i]:
                req = self.slots[i]
                res = eng._harvest(carry, self.values, i, req)
                results[req.rid] = res
                done.add(req.rid)
                eng._cache_store(req, res)
                eng._observe_hardness(req, res)
                self.slots[i] = None
        # drained queue + mostly-empty batch: repack the live stragglers
        # into a narrower slot batch of the same power-of-two menu; lane
        # data is only gathered, so results keep their bits
        live_ct = sum(s is not None for s in self.slots)
        if not self.pending and b > 1 and 0 < live_ct <= b // 2:
            nb = eng._slot_width(live_ct)
            idx = [i for i in range(b) if self.slots[i] is not None]
            pad_idx = idx + [idx[-1]] * (nb - live_ct)
            self.ops = tuple(_take_lanes(o, pad_idx) for o in self.ops)
            self.carry = _take_lanes(self.carry, pad_idx)
            self.values = None
            self.slots = ([self.slots[i] for i in idx]
                          + [None] * (nb - live_ct))
            if live_ct < nb:   # duplicated pad lanes never run
                self.carry = _retire_lanes(
                    self.carry, [k >= live_ct for k in range(nb)])
            self.t_prev = self.t_prev[pad_idx]
            self.inner_prev = self.inner_prev[pad_idx]
            self.b = nb
            eng.stats["repacks"] += 1
        return self.live()

    def record_interrupt(self) -> None:
        """After a failed segment: keep what the in-flight requests' error
        traces revealed, for the hardness predictor at re-admission."""
        try:
            trace = self.carry.trace.detach().cpu().numpy()
        except Exception:   # noqa: BLE001 — a poisoned device
            trace = None
        if trace is not None:
            for i, req in enumerate(self.slots):
                if req is not None:
                    req.errs = trace[i]


def _features(reqs):
    """The FGW feature costs of a bucket's requests (None for GW)."""
    feats = [r.feature for r in reqs]
    return None if all(f is None for f in feats) else feats


class GWEngine:
    """Admission-queue front end for batched GW solving.

    ``submit()`` enqueues a (geom_x, geom_y, mu, nu) problem (raw grids,
    adapted with the solver backend, or any
    `repro_torch.core.geometry.Geometry`) and returns a request id; each
    request may carry its own knobs (``eps``/``tol``/``eps_init``/
    ``anneal_decay``, or a full `SolveControls`), which ride as per-lane
    controls.  ``flush()`` resolves the queue, answers sliced requests and
    cache hits, buckets the rest by geometry spec, and runs each bucket
    through the scheduler (see the module docstring).  ``serve()`` runs
    the pipelined loop as a standing event loop over a request stream.

    Plan routing: each request resolves to "full" or "lowrank" at flush
    time (``submit(plan=...)``, else ``GWServeConfig.plan``, upgraded by
    ``lowrank_above``); the plan leads the bucket key.

    ``stats`` (reset each flush) counts dispatches, executed against
    useful lane-iterations, refills, repacks, the pipeline telemetry and
    the cache traffic (see `_new_stats`).

    Failure isolation: each bucket runs on its own.  When a bucket raises,
    its unsolved requests stay queued for retry (keeping their observed
    error trace as a hardness hint), the error is recorded in
    ``last_errors``, and other buckets' results are still returned.  If
    every bucket failed, the first error is raised.
    """

    def __init__(self, cfg: GWServeConfig | None = None):
        self.cfg = cfg or GWServeConfig()
        self.device = resolve_device(self.cfg.device)
        self._queue: list[_Request] = []
        self._next_id = 0
        self.last_errors: list[tuple[tuple, Exception]] = []
        self.stats = _new_stats()
        self.cache: PlanCache | None = None
        if self.cfg.cache_capacity > 0:
            self.cache = PlanCache(self.cfg.cache_capacity,
                                   self.cfg.cache_near_tol)
        self.calib: HardnessCalibrator | None = None
        if self.cfg.calibrate_hardness:
            self.calib = HardnessCalibrator(
                5, min_obs=self.cfg.calib_min_obs)
        self._inflight = 0
        self._idle_since: float | None = None

    def _bucket_size(self, size: int) -> int:
        b = self.cfg.size_bucket
        return -(-size // b) * b

    def _padded(self, geom) -> int:
        return self._bucket_size(geom.size) if geom.paddable else geom.size

    def submit(self, geom_x, geom_y, mu, nu, *, eps=None, tol=None,
               eps_init=None, anneal_decay=None, plan=None,
               feature_cost=None, theta=None,
               controls: SolveControls | None = None,
               service: str | None = None) -> int:
        """Enqueue a problem; returns its request id.  Keyword knobs (or a
        full ``controls``) override the engine's solver defaults for this
        request only.  ``plan`` ("full" | "lowrank") pins its
        representation.  ``feature_cost`` (an (M, N) matrix) makes it an
        FGW request, with ``theta`` its feature weight (structural: FGW
        requests bucket by θ).  ``service`` picks the answer class:
        "exact", "sliced" (the sliced estimate, one call, no plan) or
        "refine" (the sliced answer, yielded first by `serve`, then the
        exact solve warm-started from the sliced plan); the last two need
        geometries with a coordinate embedding and no feature cost.
        Measures and feature costs are moved to the engine's device; a
        geometry's tensors must lie there already."""
        backend = self.cfg.solver.backend
        gx = as_geometry(geom_x, backend)
        gy = as_geometry(geom_y, backend)
        mu = as_tensor(mu, self.device)
        nu = as_tensor(nu, self.device)
        # reject data-independent malformations here: once queued, a bad
        # request would fail its whole bucket on every flush
        if tuple(mu.shape) != (gx.size,) or tuple(nu.shape) != (gy.size,):
            raise ValueError(
                f"measure shapes {tuple(mu.shape)}/{tuple(nu.shape)} do not "
                f"match geometry sizes {gx.size}/{gy.size}")
        if plan is not None and plan not in ("full", "lowrank"):
            raise ValueError(
                f"unknown plan {plan!r}: expected 'full' or 'lowrank'")
        if theta is not None and feature_cost is None:
            raise ValueError("theta is the FGW feature weight — it needs a "
                             "feature_cost to weight")
        if service is not None:
            if service not in SERVICES:
                raise ValueError(
                    f"unknown service {service!r}: expected 'exact', "
                    "'sliced', or 'refine'")
            if service != "exact" and not (sliced_supported(gx)
                                           and sliced_supported(gy)):
                raise ValueError(
                    f"service={service!r} needs geometries with a "
                    "coordinate embedding to slice (grids, point clouds, "
                    "or low-rank factors) — got "
                    f"{type(gx).__name__}/{type(gy).__name__}")
            if service != "exact" and feature_cost is not None:
                raise ValueError(
                    f"service={service!r} estimates the plain GW term "
                    "only — FGW requests (feature_cost) must use the "
                    "exact service")
        feature = None
        if feature_cost is not None:
            feature = as_tensor(feature_cost, self.device)
            if tuple(feature.shape) != (gx.size, gy.size):
                raise ValueError(
                    f"feature cost shape {tuple(feature.shape)} != problem "
                    f"sizes ({gx.size}, {gy.size})")
        overrides = {k: v for k, v in [("eps", eps), ("tol", tol),
                                       ("eps_init", eps_init),
                                       ("anneal_decay", anneal_decay),
                                       ("plan", plan), ("theta", theta),
                                       ("controls", controls),
                                       ("service", service)]
                     if v is not None}
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Request(rid, (gx, gy, mu, nu), overrides,
                                    feature=feature))
        return rid

    def _resolve(self, req: _Request) -> None:
        """A request's effective service, plan and SolveControls: the
        engine's current solver config, overridden by what submit() was
        given explicitly."""
        o = req.overrides
        s = self.cfg.solver_cfg()
        svc = o.get("service", self.cfg.service)
        if svc not in SERVICES:
            raise ValueError(
                f"unknown service {svc!r}: expected 'exact', 'sliced', or "
                "'refine'")
        if svc != "exact" and (req.feature is not None
                               or not (sliced_supported(req.prob[0])
                                       and sliced_supported(req.prob[1]))):
            # the engine-level fast tier degrades to the exact solve on
            # geometries with no embedding and on FGW requests (an explicit
            # per-request service was rejected at submit())
            svc = "exact"
        req.service = svc
        if req.feature is not None:
            req.theta = float(o.get("theta", getattr(s, "theta", 0.5)))
        if "plan" in o:
            req.plan = o["plan"]
        else:
            req.plan = self.cfg.plan if self.cfg.plan is not None else s.plan
            gx, gy = req.prob[0], req.prob[1]
            if (self.cfg.lowrank_above is not None
                    and max(gx.size, gy.size) >= self.cfg.lowrank_above):
                req.plan = "lowrank"
        if "controls" in o:
            c = o["controls"]
            req.ctl = c
            req.knobs = (float(c.eps), float(c.tol), float(c.eps_init),
                         float(c.anneal_decay))
            return
        eps_v = float(o.get("eps", s.eps))
        tol_v = float(o.get("tol", s.tol))
        e0 = o.get("eps_init", s.eps_init)
        e0 = eps_v if e0 is None else float(e0)
        e0 = max(e0, eps_v)        # eps_init ≤ eps means "no annealing"
        decay_v = float(o.get("anneal_decay", s.anneal_decay))
        req.ctl = SolveControls.make(eps_v, tol_v, e0, decay_v,
                                     s.inner_loosen, s.lr_gamma)
        req.knobs = (eps_v, tol_v, e0, decay_v)

    def _bucket_key(self, req: _Request):
        gx, gy, _, _ = req.prob
        # the plan leads the key (different programs, different carries);
        # FGW requests carry a feature operand and a structural θ
        mode = ("fgw", req.theta) if req.feature is not None else ("gw",)
        return (req.plan, gx.batch_key(), self._padded(gx), gy.batch_key(),
                self._padded(gy), mode)

    # -- plan cache -------------------------------------------------------

    def _fingerprint(self, req: _Request) -> Fingerprint:
        """A resolved request's cache identity: the bucket key and the
        bucket's structural solver config as the static part; both
        geometries' content (a grid's spacing, factors, points, a dense
        cost), the marginals and the feature cost as leaves; the resolved
        value knobs hashed exactly."""
        gx, gy, mu, nu = req.prob
        key = self._bucket_key(req)
        static = (key, self._bucket_cfg(key).static_key())
        leaves = _content_leaves(gx) + _content_leaves(gy) + [mu, nu]
        if req.feature is not None:
            leaves.append(req.feature)
        near_tol = 0.0 if self.cache is None else self.cache.near_tol
        return fingerprint(static, leaves, _knob_values(req.ctl), near_tol)

    def _cache_lookup(self, req: _Request, results: dict, done: set) -> bool:
        """Consult the plan cache for a resolved request.  True: an exact
        hit, already in ``results`` (no device work).  A near hit arms the
        request's warm start from the cached coupling with annealing off
        (``eps_init := eps``); on a miss the profile stage may."""
        if self.cache is None:
            return False
        req.fp = self._fingerprint(req)
        req.knob_key = np.asarray(_knob_values(req.ctl), np.float64).tobytes()
        kind, entry = self.cache.lookup(req.fp)
        if kind == "exact":
            results[req.rid] = entry
            done.add(req.rid)
            self.stats["cache_hits"] += 1
            return True
        if (kind == "near" and entry.coupling is not None
                and self.cfg.scheduler != "barrier"):
            # the barrier scheduler has no lane carry to seed
            req.warm = entry
            req.ctl = dataclasses.replace(req.ctl, eps_init=req.ctl.eps)
            self.stats["cache_warm_starts"] += 1
        elif not self._profile_warm_start(req):
            self.stats["cache_misses"] += 1
        return False

    def _profile_warm_start(self, req: _Request) -> bool:
        """Second cache stage: on a digest miss, compare the request's
        sliced profile with same-bucket cached solves (a rotated or
        re-indexed repeat has the same canonical profile and different
        bytes).  Armed like a near hit."""
        if (self.cfg.cache_profile_tol <= 0.0
                or self.cfg.scheduler == "barrier"
                or req.plan != "full"):
            return False
        gx, gy = req.prob[0], req.prob[1]
        if not (sliced_supported(gx) and sliced_supported(gy)):
            return False
        if req.sliced_profile is None:
            self._sliced_compute(req, with_plan=False)
        match = self.cache.profile_match(req.fp.static, req.knob_key,
                                         req.sliced_profile,
                                         self.cfg.cache_profile_tol)
        if match is None:
            return False
        entry, aux = match
        if not isinstance(entry.coupling, FullCoupling):
            return False
        if tuple(entry.coupling.plan.shape) != (gx.size, gy.size):
            # same bucket, other raw sizes: that coupling cannot seed
            return False
        warm = entry
        if aux is not None and req.sliced_orders is not None:
            warm = _realign_cached(entry, aux, req.sliced_orders)
        req.warm = warm
        req.ctl = dataclasses.replace(req.ctl, eps_init=req.ctl.eps)
        self.stats["cache_profile_hits"] += 1
        self.stats["cache_warm_starts"] += 1
        return True

    def _cache_store(self, req: _Request, res: GWResult) -> None:
        if self.cache is not None and req.fp is not None:
            self.cache.store(req.fp, res, profile=req.sliced_profile,
                             knob_key=req.knob_key, aux=req.sliced_orders)

    # -- sliced fast tier -------------------------------------------------

    def _sliced_compute(self, req: _Request, with_plan: bool):
        """The sliced estimator for one request, on its bucket's padded
        sizes (zero-mass padding atoms are inert in every mass-weighted
        moment).  Keeps the estimate, the profile and the canonical atom
        orders on the request; returns the true-size monotone plan when
        ``with_plan``."""
        gx, gy, mu, nu = req.prob
        ex, px = sliced_embedding(gx, self.device)
        ey, py = sliced_embedding(gy, self.device)
        pad_x, pad_y = self._padded(gx), self._padded(gy)
        pad = torch.nn.functional.pad
        ex = pad(ex, (0, 0, 0, pad_x - ex.shape[0]))
        ey = pad(ey, (0, 0, 0, pad_y - ey.shape[0]))
        mu_p = pad(mu, (0, pad_x - mu.shape[0]))
        nu_p = pad(nu, (0, pad_y - nu.shape[0]))
        banks = self.cfg.sliced_directions or {}
        bank = banks.get(max(ex.shape[1], ey.shape[1]))
        args = (ex, ey, mu_p, nu_p, bank, self.cfg.sliced_seed, px, py,
                int(self.cfg.sliced_n_proj))
        self._mark_issue()
        try:
            plan = None
            if with_plan:
                est, prof, plan = _sliced_plan_core(*args)
                plan = plan[:gx.size, :gy.size]
            else:
                est, prof = _sliced_core(*args)
            # the canonical sort orders of the true atoms: the
            # correspondence that re-indexes a profile-matched cached plan
            kx = _canonical_keys(ex, mu_p)[:gx.size].cpu().numpy()
            ky = _canonical_keys(ey, nu_p)[:gy.size].cpu().numpy()
            req.sliced_orders = (np.argsort(kx, kind="stable"),
                                 np.argsort(ky, kind="stable"))
            req.sliced_est = float(est)
            req.sliced_profile = prof.detach().cpu().numpy().astype(
                np.float64)
        finally:
            self._mark_drain()
        self.stats["dispatches"] += 1
        return plan

    def _sliced_result(self, req: _Request, coup=None) -> GWResult:
        """The fast tier's numbers as a `GWResult`: the sliced estimate as
        the value, zero iterations, converged.  With ``coup`` (the refine
        preliminary) it carries the best direction's monotone coupling,
        exactly feasible, so its marginal error is 0."""
        dev, f64 = self.device, torch.float64
        zero = torch.zeros((), dtype=f64, device=dev)
        info = ConvergenceInfo(outer_iters=0, inner_iters=0,
                               marginal_err=zero, converged=True,
                               err_trace=torch.zeros((0,), dtype=f64,
                                                     device=dev))
        value = torch.tensor(req.sliced_est, dtype=f64, device=dev)
        if coup is None:
            return GWResult(plan=None, value=value, marginal_err=zero,
                            f=None, g=None, errs=None, info=info,
                            coupling=None)
        return dataclasses.replace(_result_of(coup, value, info), errs=None)

    def _sliced_answer(self, req: _Request) -> GWResult:
        """The ``service="sliced"`` answer: one call of the sliced tier
        (none when the profile stage already ran)."""
        if req.sliced_est is None:
            self._sliced_compute(req, with_plan=False)
        self.stats["sliced_answers"] += 1
        return self._sliced_result(req)

    def _arm_sliced_warm(self, req: _Request) -> GWResult:
        """``service="refine"``: the sliced answer, and (when the lane takes
        a dense seed) the request's warm start from the best direction's
        monotone plan (`FullCoupling.from_sliced`).  A cache near or
        profile hit keeps precedence.  The sliced seed keeps the annealing
        ramp on: it is a basin hint, not an optimum to resume.  Returns the
        preliminary (`serve` yields it at once)."""
        arm = (req.warm is None and req.plan == "full"
               and self.cfg.scheduler != "barrier")
        coup = None
        if arm:
            plan = self._sliced_compute(req, with_plan=True)
            coup = FullCoupling.from_sliced(plan, req.prob[2], req.prob[3])
        elif req.sliced_profile is None:
            self._sliced_compute(req, with_plan=False)
        pre = self._sliced_result(req, coup)
        if arm:
            req.warm = pre
        self.stats["sliced_answers"] += 1
        return pre

    # -- difficulty-aware admission --------------------------------------

    def predicted_hardness(self, req: _Request) -> float:
        """Rank a request by the outer-loop work it should need: the
        ε-annealing stages to its target, the sharpness of the target ε,
        and log problem size (the factored plan's O((M+N)r) for factored
        lanes); with ``calibrate_hardness`` a bucket's ridge regression
        replaces those static terms once it has ``calib_min_obs``
        observations.  A slowly decaying error trace from an interrupted
        run adds to it, and a warm start divides it by 100."""
        if req.knobs is None:
            self._resolve(req)
        h = None
        if self.calib is not None:
            h = self.calib.predict(self._bucket_key(req),
                                   self._hardness_features(req))
        if h is None:
            eps, _tol, eps_init, decay = req.knobs
            h = 0.0
            if eps_init > eps and 0.0 < decay < 1.0:
                h += math.log(eps_init / eps) / math.log(1.0 / decay)
            h += math.log10(1.0 / max(eps, 1e-30))
            gx, gy = req.prob[0], req.prob[1]
            if req.plan == "lowrank":
                r = self.cfg.solver.plan_rank
                if not isinstance(r, int):        # plan_rank="auto"
                    r = self.cfg.solver.plan_rank_max
                h += math.log2(max((gx.size + gy.size) * r, 2)) / 16.0
            else:
                h += math.log2(max(gx.size * gy.size, 2)) / 16.0
        if req.errs is not None:
            e = np.asarray(req.errs)
            e = e[np.isfinite(e) & (e > 0)]
            if len(e) >= 2:
                slope = (math.log(e[0]) - math.log(e[-1])) / (len(e) - 1)
                h += 1.0 / max(slope, 0.05)   # slow decay ⇒ hard
        if req.warm is not None:
            h /= 100.0
        return h

    def _hardness_features(self, req: _Request) -> np.ndarray:
        """[bias, sliced estimate, estimate-present flag, ε-annealing stage
        count, log₂ problem size]: the calibrator's features."""
        eps, _tol, eps_init, decay = req.knobs
        stages = 0.0
        if eps_init > eps and 0.0 < decay < 1.0:
            stages = math.log(eps_init / eps) / math.log(1.0 / decay)
        gx, gy = req.prob[0], req.prob[1]
        est = req.sliced_est
        return np.asarray([1.0,
                           0.0 if est is None else float(est),
                           0.0 if est is None else 1.0,
                           stages,
                           math.log2(max(gx.size * gy.size, 2))],
                          np.float64)

    def _observe_hardness(self, req: _Request, res: GWResult) -> None:
        """Fold (features → observed outer iterations) into the request's
        bucket statistics."""
        if self.calib is None or req.knobs is None or res.info is None:
            return
        self.calib.observe(self._bucket_key(req),
                           self._hardness_features(req),
                           float(res.info.outer_iters))

    # -- pipeline telemetry ----------------------------------------------

    def _mark_issue(self) -> None:
        """A dispatch enters flight: close any device-idle window and
        histogram the in-flight depth."""
        now = time.perf_counter()
        if self._inflight == 0 and self._idle_since is not None:
            self.stats["device_idle_s"] += now - self._idle_since
            self._idle_since = None
        self._inflight += 1
        hist = self.stats["dispatch_depth"]
        hist[self._inflight] = hist.get(self._inflight, 0) + 1

    def _mark_drain(self) -> None:
        """A dispatch was harvested; with nothing else in flight, the device
        is idle until the next issue."""
        self._inflight = max(0, self._inflight - 1)
        if self._inflight == 0:
            self._idle_since = time.perf_counter()

    def _start_clock(self) -> float:
        t0 = time.perf_counter()
        self.last_errors = []
        self.stats = _new_stats()
        self._inflight = 0
        self._idle_since = t0
        return t0

    def _stop_clock(self, t0: float) -> None:
        now = time.perf_counter()
        if self._inflight == 0 and self._idle_since is not None:
            self.stats["device_idle_s"] += now - self._idle_since
            self._idle_since = None
        self.stats["flush_wall_s"] = now - t0

    # -- schedulers -------------------------------------------------------

    def flush(self) -> dict[int, GWResult]:
        if self.cfg.scheduler not in ("continuous", "barrier", "pipeline"):
            raise ValueError(
                f"unknown scheduler {self.cfg.scheduler!r}: expected "
                "'continuous', 'pipeline', or 'barrier'")
        t0 = self._start_clock()
        results: dict[int, GWResult] = {}
        done: set[int] = set()
        buckets: dict[tuple, list[_Request]] = {}
        try:
            for req in self._queue:
                self._resolve(req)
                if req.service == "sliced":
                    results[req.rid] = self._sliced_answer(req)
                    done.add(req.rid)
                    continue
                if self._cache_lookup(req, results, done):
                    continue
                if req.service == "refine":
                    self._arm_sliced_warm(req)
                buckets.setdefault(self._bucket_key(req), []).append(req)
            if self.cfg.refine_priority:
                # refine-only buckets drive last (stable within each class)
                buckets = dict(sorted(
                    buckets.items(),
                    key=lambda kv: all(_service_tier(r) for r in kv[1])))
            if self.cfg.scheduler == "pipeline":
                self._drive_pipeline(buckets, results, done)
            else:
                drive = (self._drive_bucket
                         if self.cfg.scheduler == "continuous"
                         else self._barrier_bucket)
                for key, entries in buckets.items():
                    try:
                        drive(key, entries, results, done)
                    except Exception as exc:   # noqa: BLE001 — isolation
                        self.last_errors.append((key, exc))
        finally:
            # only drop what actually solved
            self._queue = [r for r in self._queue if r.rid not in done]
            self._stop_clock(t0)
        if self.last_errors and not results:
            raise self.last_errors[0][1]
        return results

    def _slot_width(self, n: int) -> int:
        """Queue length rounded up to a power of two, capped at max_batch:
        at most log2(max_batch)+1 widths a bucket."""
        b = 1
        while b < min(n, self.cfg.max_batch):
            b *= 2
        return min(b, self.cfg.max_batch)

    def _bucket_cfg(self, key) -> GWConfig:
        """The solver cfg a bucket runs: the engine's current config with
        the bucket's plan, lifted to an `FGWConfig` with the bucket's θ for
        FGW buckets."""
        cfg = dataclasses.replace(self.cfg.solver_cfg(), plan=key[0])
        mode = key[-1]
        if mode[0] == "fgw":
            from repro_torch.core.fgw import FGWConfig
            base = {f.name: getattr(cfg, f.name)
                    for f in dataclasses.fields(GWConfig)}
            cfg = FGWConfig(**base, theta=mode[1])
        return cfg

    def _barrier_bucket(self, key, entries, results, done):
        """Chunked one-shot solves; every chunk runs until its slowest lane
        converges."""
        pad_to = (key[2], key[4])
        cfg = self._bucket_cfg(key)
        for i in range(0, len(entries), self.cfg.max_batch):
            chunk = entries[i:i + self.cfg.max_batch]
            # pad the chunk to the slot width with copies of its last
            # problem (solved for the width, never returned)
            b = self._slot_width(len(chunk))
            filled = chunk + [chunk[-1]] * (b - len(chunk))
            self._mark_issue()
            try:
                solved = entropic_gw_batch(
                    [r.prob for r in filled], cfg, pad_to=pad_to,
                    num_results=len(chunk), controls=[r.ctl for r in filled],
                    features=_features(filled), device=self.device)
            finally:
                self._mark_drain()
            outers = [r.info.outer_iters for r in solved]
            inners = [r.info.inner_iters for r in solved]
            self.stats["dispatches"] += 1
            self.stats["executed_outer"] += b * max(outers)
            self.stats["useful_outer"] += sum(outers)
            self.stats["executed_inner"] += b * max(inners)
            self.stats["useful_inner"] += sum(inners)
            for req, res in zip(chunk, solved):
                res = _owned_result(res)
                results[req.rid] = res
                done.add(req.rid)
                self._cache_store(req, res)
                self._observe_hardness(req, res)

    def _drive_bucket(self, key, entries, results, done):
        """Continuous batching for one bucket: issue and harvest in
        lockstep."""
        run = _BucketRun(self, key, entries)
        try:
            while run.live():
                run.issue()
                run.harvest(results, done)
        except Exception:
            run.record_interrupt()
            raise

    def _start_run(self, key, entries, dispatcher, inflight) -> None:
        """A bucket's run with its first segment issued, into ``inflight``;
        a failure is recorded instead."""
        run = None
        try:
            run = _BucketRun(self, key, entries, dispatcher)
            run.issue()
        except Exception as exc:   # noqa: BLE001 — isolation
            if run is not None:
                run.record_interrupt()
            self.last_errors.append((key, exc))
            return
        inflight.append(run)

    def _step_pipeline(self, inflight, results, done) -> None:
        """Harvest the readiest in-flight run (waiting for the oldest when
        none is ready) and re-issue it while it has work."""
        run = next((r for r in inflight if r.ready()), inflight[0])
        inflight.remove(run)
        try:
            if run.harvest(results, done):
                run.issue()
                inflight.append(run)
        except Exception as exc:       # noqa: BLE001 — isolation
            run.record_interrupt()
            self.last_errors.append((run.key, exc))

    def _drive_pipeline(self, buckets, results, done):
        """Keep up to ``max_inflight_buckets`` buckets with a segment in
        flight, harvest whichever finishes first and re-issue it, so one
        bucket's harvest and refills overlap the others' segments."""
        depth = max(1, int(self.cfg.max_inflight_buckets))
        todo = collections.deque(buckets.items())
        inflight: list[_BucketRun] = []
        dispatcher = _Dispatcher(depth, self.device)
        try:
            while todo or inflight:
                while todo and len(inflight) < depth:
                    self._start_run(*todo.popleft(), dispatcher, inflight)
                if inflight:
                    self._step_pipeline(inflight, results, done)
        finally:
            dispatcher.close()

    # -- standing event loop ----------------------------------------------

    def serve(self, source: Iterable) -> Iterator[tuple[int, GWResult]]:
        """Standing event loop over a request stream: admission, dispatch
        and harvest as interleaved phases.  ``source`` yields problems,
        plain ``(geom_x, geom_y, mu, nu)`` tuples or ``(args, kwargs)``
        pairs forwarded to :meth:`submit`.  Yields ``(rid, GWResult)`` in
        completion order: cache exact hits and ``service="sliced"`` answers
        at once; a ``service="refine"`` request twice, its sliced
        preliminary at once and its refined result later.

        Each cycle pulls up to ``max_batch`` requests (while fewer than
        ``max_inflight_buckets × max_batch`` are unfinished), routes them
        into the live runs (exact requests ahead of queued refine work) or
        into waiting buckets, starts waiting buckets up to the depth bound,
        and runs one harvest step of the pipeline.  Failed buckets are
        recorded in ``last_errors``; their unsolved requests stay queued."""
        depth = max(1, int(self.cfg.max_inflight_buckets))
        t0 = self._start_clock()
        src = iter(source)
        exhausted = False
        waiting: dict[tuple, list[_Request]] = {}
        inflight: list[_BucketRun] = []
        results: dict[int, GWResult] = {}
        done: set[int] = set()
        dispatcher = _Dispatcher(depth, self.device)
        try:
            while not exhausted or waiting or inflight:
                # admission (backpressure counts active work only)
                pulled = 0
                active = (sum(len(v) for v in waiting.values())
                          + sum(len(r.pending)
                                + sum(s is not None for s in r.slots)
                                for r in inflight))
                room = depth * self.cfg.max_batch
                while (not exhausted and pulled < self.cfg.max_batch
                       and active + pulled < room):
                    try:
                        item = next(src)
                    except StopIteration:
                        exhausted = True
                        break
                    if len(item) == 2 and isinstance(item[1], dict):
                        rid = self.submit(*item[0], **item[1])
                    else:
                        rid = self.submit(*item)
                    req = self._queue[-1]
                    pulled += 1
                    self._resolve(req)
                    if req.service == "sliced":
                        self._queue.pop()
                        yield rid, self._sliced_answer(req)
                        continue
                    if self._cache_lookup(req, results, done):
                        self._queue.pop()
                        yield rid, results.pop(rid)
                        continue
                    if req.service == "refine":
                        # the preliminary now, the refined solve later
                        yield rid, self._arm_sliced_warm(req)
                    key = self._bucket_key(req)
                    live = next((r for r in inflight if r.key == key), None)
                    if live is None:
                        waiting.setdefault(key, []).append(req)
                    elif (self.cfg.refine_priority
                          and _service_tier(req) == 0):
                        # exact admissions jump ahead of queued refine work
                        at = next((i for i, p in enumerate(live.pending)
                                   if _service_tier(p)), len(live.pending))
                        live.pending.insert(at, req)
                    else:
                        live.pending.append(req)
                # dispatch: start waiting buckets up to the depth bound
                while waiting and len(inflight) < depth:
                    if self.cfg.refine_priority:
                        # exact-bearing buckets first (stable among ties)
                        key = min(waiting, key=lambda k: all(
                            _service_tier(r) for r in waiting[k]))
                    else:
                        key = next(iter(waiting))
                    self._start_run(key, waiting.pop(key), dispatcher,
                                    inflight)
                # harvest: the readiest run's finished segment
                if inflight:
                    self._step_pipeline(inflight, results, done)
                    if done:
                        self._queue = [r for r in self._queue
                                       if r.rid not in done]
                    for rid in list(results):
                        yield rid, results.pop(rid)
                self.stats["flush_wall_s"] = time.perf_counter() - t0
        finally:
            dispatcher.close()
            self._stop_clock(t0)

    def _lane_operands(self, req: _Request, pad_to, cfg):
        """One request's padded operands and carry as a batch of one, to
        drop into a slot: a fresh cold carry, or the warm start's coupling
        padded to the bucket (`Coupling.pad_to`: zero-mass padding)."""
        ops, _, _ = stack_problems(
            [req.prob], cfg, pad_to, [req.ctl], self.device,
            None if req.feature is None else [req.feature])
        if req.warm is not None:
            state0 = req.warm.coupling.pad_to(*pad_to)
            return ops, init_carry(type(state0).stack([state0]),
                                   cfg.outer_iters, self.device, 1)
        return ops, _init_stacked(*ops[:4], cfg)

    def _harvest(self, carry: MirrorCarry, values, i: int,
                 req: _Request) -> GWResult:
        """Lane ``i`` of the batch as this request's true-size `GWResult`,
        its tensors copied out of the batch."""
        lane = carry.lane(i)
        m, n = req.prob[0].size, req.prob[1].size
        return _owned_result(_result_of(lane.state.slice_to(m, n),
                                        values[i], info_of(lane)))

    def solve(self, problems, pad_to=None) -> list[GWResult]:
        """Direct batched solve (no queue): `entropic_gw_batch`."""
        return entropic_gw_batch(problems, self.cfg.solver_cfg(),
                                 pad_to=pad_to, device=self.device)


def _knob_values(c: SolveControls) -> list[float]:
    """The resolved value knobs the fingerprint and the profile stage key
    on, exactly."""
    return [float(c.eps), float(c.tol), float(c.eps_init),
            float(c.anneal_decay), float(c.inner_loosen), float(c.lr_gamma)]


def _content_leaves(geom) -> list:
    """A geometry's content for the fingerprint: a grid's spacing (its
    size and power are in the static part), else its tensors."""
    if isinstance(geom, GridGeometry):
        h = geom.grid.h
        return [h if torch.is_tensor(h) else np.asarray(h, np.float64)]
    return tensor_leaves(geom)


def _realign_cached(entry: GWResult, aux, orders) -> GWResult:
    """A profile-matched cached solve re-indexed onto this request's atom
    order: rank k of the cached request's canonical sort order corresponds
    to rank k of the new request's, so composing the two argsorts recovers
    the permutation a re-indexed repeat applied (the identity for a plain
    rotated copy)."""
    coup = entry.coupling
    dev = coup.plan.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    (ox_c, oy_c), (ox_n, oy_n) = (tuple(map(t, aux)), tuple(map(t, orders)))
    plan = torch.empty_like(coup.plan)
    plan[ox_n[:, None], oy_n[None, :]] = coup.plan[ox_c[:, None],
                                                   oy_c[None, :]]
    f, g = torch.empty_like(coup.f), torch.empty_like(coup.g)
    f[ox_n] = coup.f[ox_c]
    g[oy_n] = coup.g[oy_c]
    new = FullCoupling(plan, f, g)
    return dataclasses.replace(entry, plan=plan, f=f, g=g, coupling=new)


def run_event_loop(engine: GWEngine, source: Iterable,
                   on_result: Callable[[int, GWResult], None] | None = None,
                   ) -> dict[int, GWResult]:
    """Drain a request stream through `GWEngine.serve` and collect every
    completed result (a refine request's last, its refined one).
    ``on_result`` observes each ``(rid, result)`` as it completes."""
    out: dict[int, GWResult] = {}
    for rid, res in engine.serve(source):
        out[rid] = res
        if on_result is not None:
            on_result(rid, res)
    return out
