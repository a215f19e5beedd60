"""The production dry run: for each architecture and shape on the 16×16
(256 ranks) and 2×16×16 (512 ranks) production meshes, what one device
holds, computes and sends.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        [--arch A|all] [--shape S|all] [--mesh single|multi|both] \\
        [--out build/dryrun.json] [--device cuda|cpu] [--rank R] ...

Reference: ``repro/launch/dryrun.py``, which lowers and compiles each
cell's jitted step against abstract inputs on 512 forced XLA host devices
and reads the compiler's memory and cost analyses and the HLO's
collectives.  The port has no compiler to ask.  It runs one rank's real
share of the step instead:

- **The group.** A process group of the production world size in this
  one process: ``torch.testing._internal.distributed.fake_pg`` (a
  PyTorch-internal testing module; `tests/test_torch_dryrun.py` pins
  what this module relies on), whose collectives complete at once with
  no peer and move no data between ranks.  `run_cell` starts it as rank ``--rank`` (0 by default),
  builds the mesh with `repro_torch.launch.mesh.make_production_mesh`,
  and destroys the group before it returns.  Importing this module
  starts nothing.
- **The state, never whole.** The model (and, for a train cell, AdamW's
  moments) is built on the ``meta`` device (`repro_torch.launch.specs`)
  and laid out by `repro_torch.distributed.sharding.param_specs` and
  `zero_specs`; the rank makes only its own shards on the device
  (`sharding.local_shard`): parameters and inputs drawn from a seeded
  ``torch.Generator``, moments and caches zero.
- **The run.** The rank's share of `repro_torch.train.loop.train_step`
  (the FGW term off, as in the reference), `repro_torch.models.lm.prefill`
  or `lm.decode_step` (one token against caches of ``seq_len``, held as
  full) runs once on ``DTensor``s, under `repro_torch.launch.flops`'s
  `TrafficCounter` (FLOPs, bytes and transcendentals on the local
  shards) and `CollectiveRecorder` (each collective's kind and result).
  **Its values are meaningless**: the fake group's collectives do not
  reduce or gather across ranks, so nothing reads, checks or prints a
  value; what the run measures is the shapes it touches, its memory and
  its time.

The record keeps the reference's keys where their meaning holds:
``memory_per_device`` (``argument_bytes``: the rank's parameters,
moments, batch and caches; ``output_bytes``: the results not written in
place; ``temp_bytes``: the peak less both; ``total_bytes``: the peak,
``torch.cuda.max_memory_allocated`` after a reset on the card, and
``MemTracker``'s on the CPU), ``device_cost`` (the reference's
``hlo_cost``: per-device FLOPs, products plus elementwise, bytes and
transcendentals from the counters around the run), ``analytic``
(`repro_torch.launch.flops.count_fn` over the whole unsharded step on
``meta``: products plus elementwise FLOPs and bytes, global),
``collectives`` (counts by the reference's kinds, payload and wire
bytes a device, `repro_torch.launch.collectives._WIRE_FACTOR`),
``roofline``, ``dominant``, ``mfu_bound`` and ``model_vs_counted`` by
the reference's formulas, ``first_step_s`` (the wall of the rank's run,
``DTensor``'s sharding propagation included; the reference's
``lower_s``/``compile_s``), and ``fits_hbm`` against ``hbm_bytes`` (the
card's memory; on the CPU `H100_80GB_HBM3_BYTES`).  A share that does
not fit the card stops with an out-of-memory error: the cell's record
then says so (``oom``), ``fits_hbm`` is false, ``total_bytes`` is the
peak reached before it (a lower bound), and ``device_cost``,
``collectives``, ``roofline``, ``dominant`` and ``mfu_bound`` are null
(they would count part of a step).  Any other failure is recorded with
its traceback and `main` exits 1.

The CPU group runs DTensor's shard-to-shard moves (an MoE's experts) as
all-gathers where the card runs all-to-alls, so ``--device cpu`` counts
differ from the card's there.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch import collectives
from repro_torch.launch import flops as flopcount
from repro_torch.launch import specs as spec_mod
from repro_torch.launch.mesh import local_mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as optim

# NVIDIA H100 SXM5 datasheet values (not measurements): dense bf16 tensor
# peak, HBM3 bandwidth, and the link a 16-wide mesh axis crosses (8 GPUs
# a node, so the axis spans two: one 400 Gb/s NDR port a GPU)
PEAK_FLOPS = 989.4e12   # FLOP/s a GPU
HBM_BW = 3.35e12        # bytes/s a GPU
LINK_BW = 50e9          # bytes/s a GPU
# what torch.cuda.get_device_properties(0).total_memory reads on an
# NVIDIA H100 80GB HBM3: the bar of ``fits_hbm`` on the CPU
H100_80GB_HBM3_BYTES = 85_017_493_504

SEED = 0

class CollectiveRecorder(TorchDispatchMode):
    """Records each ``_c10d_functional`` collective run under it (the ops
    ``DTensor`` and the functional collectives issue) as a
    `repro_torch.launch.collectives.record` of its result, the yardstick
    that a profiled trace's collectives are read with."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTensor in types:
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = (collectives._KINDS.get(func._overloadpacket.__name__)
                if func.namespace == "_c10d_functional" else None)
        if kind is not None and not flopcount.faking():
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor):
                    self.ops.append(collectives.record(
                        kind, str(t.dtype).replace("torch.", ""),
                        t.numel() * t.element_size()))
        return out

    def summary(self) -> dict:
        """{"counts": kind → ops, "payload_bytes_per_device",
        "wire_bytes_per_device"} (the reference's record keys)."""
        s = collectives.summarize(self.ops)
        return {"counts": s["counts"],
                "payload_bytes_per_device": s["payload_bytes"],
                "wire_bytes_per_device": s["wire_bytes"]}


def _filler(gen: torch.Generator, high: int):
    """A `sharding.local_shard` fill: floats N(0, 0.02²), integers
    uniform in [0, high) (token ids and labels valid for the vocab)."""
    def fill(shape, dtype, device):
        if dtype.is_floating_point:
            return torch.empty(shape, dtype=dtype, device=device).normal_(
                0.0, 0.02, generator=gen)
        return torch.randint(0, high, shape, dtype=dtype, device=device,
                             generator=gen)
    return fill


def _local_batch(batch: dict, mesh, fill) -> dict:
    """The rank's shards of a ``meta`` batch, laid out by
    `sharding.batch_specs` over the mesh's data axes."""
    shape = sharding.mesh_shape(mesh)
    specs = sharding.batch_specs(batch, shape, sharding.data_axes_of(shape))
    return {k: sharding.local_shard(v, mesh, specs[k], fill)
            for k, v in batch.items()}


def _set_length(caches, length: int):
    """Every cache ``length`` set to ``length`` (a decode against a full
    cache)."""
    if isinstance(caches, dict):
        for k, v in caches.items():
            if k == "length":
                caches[k] = length
            else:
                _set_length(v, length)
    elif isinstance(caches, (list, tuple)):
        for v in caches:
            _set_length(v, length)


def train_config(microbatches: int = 1, compress: bool = False,
                 remat: bool = True, gather_params: bool = False):
    return train_loop.TrainConfig(
        microbatches=microbatches, remat=remat, gather_params=gather_params,
        optimizer=optim.OptimizerConfig(compress_grads=compress))


def step_of(cfg, shape, tcfg):
    """The step function of a cell, over the arguments `build_cell` and
    `specs.input_specs` give."""
    if shape.kind == "train":
        def step_fn(state, batch):
            return train_loop.train_step(state, batch, cfg, tcfg)
    elif shape.kind == "prefill":
        @torch.no_grad()
        def step_fn(params, batch, caches):
            return lm.prefill(params, batch, cfg, caches)
    else:
        @torch.no_grad()
        def step_fn(params, batch, caches):
            return lm.decode_step(params, batch, caches, cfg)
    return step_fn


def build_cell(arch: str, shape_name: str, mesh, strategy: str = "2d",
               microbatches: int = 1, compress: bool = False,
               remat: bool = True, gather_params: bool = False, cfg=None,
               shape=None):
    """(step_fn, args, cfg, shape): this rank's share of the cell's
    arguments on ``mesh`` (a ``DeviceMesh``), ``DTensor``s of which only
    the local shards exist.  ``cfg`` and ``shape`` override the
    registry's (tests run smoke configs)."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    tcfg = train_config(microbatches, compress, remat, gather_params)
    specs = spec_mod.input_specs(cfg, shape, tcfg)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    fill = _filler(torch.Generator(device=dev).manual_seed(SEED),
                   cfg.vocab_size)
    step_fn = step_of(cfg, shape, tcfg)
    if shape.kind == "train":
        state = specs["state"]
        train_loop.shard_state(state, mesh, strategy, fill)
        return (step_fn, (state, _local_batch(specs["batch"], mesh, fill)),
                cfg, shape)
    model = specs["params"]
    mshape = sharding.mesh_shape(mesh)
    pspecs = sharding.param_specs(
        {k: tuple(p.shape) for k, p in model.named_parameters()}, mshape,
        strategy)
    sharding.distribute_module(model, mesh, pspecs, fill=fill)
    caches = lm.cache_init(cfg, shape.global_batch, shape.seq_len,
                           torch.bfloat16, mesh=mesh)
    if shape.kind == "decode":
        _set_length(caches, shape.seq_len - 1)
    return (step_fn, (model, _local_batch(specs["batch"], mesh, fill),
                      caches), cfg, shape)


def _locals(tree) -> list:
    """The local tensors of a tree of arguments (a train state, a model,
    dicts and lists of ``DTensor``s)."""
    if isinstance(tree, train_loop.TrainState):
        opt = tree.opt
        return _locals([tree.params(), opt.m, opt.v, opt.ef or {}])
    if isinstance(tree, torch.nn.Module):
        return _locals(dict(tree.named_parameters()))
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _locals(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _locals(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return []


def local_bytes(tree) -> int:
    """The bytes of a tree's local tensors, each storage once."""
    seen, total = set(), 0
    for t in _locals(tree):
        key = t.untyped_storage().data_ptr() if t.numel() else id(t)
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _run_share(step_fn, args, device_type: str):
    """Run the rank's share once under the counters; returns (the
    results (None after an out-of-memory error), the peak bytes, the
    wall, the traffic counter, the collective recorder, the error
    message of an out-of-memory error or None)."""
    traffic, recorder = flopcount.TrafficCounter(), CollectiveRecorder()
    oom, out = None, None
    if device_type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracker = None
    else:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        tracker.track_external(*_locals(args))
    t0 = time.perf_counter()
    try:
        with tracker or contextlib.nullcontext(), traffic, recorder:
            out = step_fn(*args)
        if device_type == "cuda":
            torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        where = [f"{f.filename.split('src/')[-1]}:{f.lineno}" for f in
                 traceback.extract_tb(exc.__traceback__)
                 if "repro_torch" in f.filename]
        oom = (f"{type(exc).__name__} at {where[-1] if where else '?'}: "
               f"{str(exc)[:300]}")
    wall = time.perf_counter() - t0
    if device_type == "cuda":
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = max(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
    return out, peak, wall, traffic, recorder, oom


def _output_bytes(out, args) -> int:
    """The local bytes of the results that are not written in place into
    an argument (a train step's metrics, the logits)."""
    if out is None:
        return 0
    held = {t.untyped_storage().data_ptr() for t in _locals(args)
            if t.numel()}
    fresh = [t for t in _locals(out)
             if t.numel() and t.untyped_storage().data_ptr() not in held]
    return local_bytes(fresh)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             count_flops: bool = True, verbose: bool = True,
             strategy: str = "2d", microbatches: int = 1,
             compress: bool = False, remat: bool = True,
             gather_params: bool = False, device: str = "cuda",
             rank: int = 0, mesh_shape=None, cfg=None, shape=None) -> dict:
    """The record of one cell (see the module docstring), from rank
    ``rank``'s share on a fake group of the mesh's size.  ``mesh_shape``
    (a (data, model) pair), ``cfg`` and ``shape`` override the
    production mesh and the registry's cell (tests)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run runs on a CUDA device unless told otherwise, and "
            "none is available: pass --device cpu to run it on the CPU")
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    sizes = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    chips = math.prod(sizes)
    ok, why = configs.applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(map(str, sizes)), "chips": chips,
           "strategy": strategy, "microbatches": microbatches,
           "compress": compress}
    if not ok:
        rec["skipped"] = why
        return rec
    rec["rank"] = rank
    rec["device"] = (torch.cuda.get_device_name() if device == "cuda"
                     else "cpu")
    rec["hbm_bytes"] = (torch.cuda.get_device_properties(0).total_memory
                        if device == "cuda" else H100_80GB_HBM3_BYTES)
    kw = dict(strategy=strategy, microbatches=microbatches,
              compress=compress, remat=remat, gather_params=gather_params,
              cfg=cfg, shape=shape)
    rec.update(_share(arch, shape_name, multi_pod, mesh_shape, chips,
                      device, rank, kw))

    # analytic accounting (global), over the unsharded step
    tcfg = train_config(microbatches, compress, remat, gather_params)
    if count_flops:
        counted = analytic_count(cfg, shape, tcfg)
        rec["analytic"] = {
            "flops_global": counted["flops"] + counted["elementwise_flops"],
            "bytes_global": counted["bytes"]}
    else:
        rec["analytic"] = {"flops_global": 0, "bytes_global": 0}

    total_p, active_p = flopcount.param_counts(
        flopcount.meta_shapes(cfg), cfg)
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mf = flopcount.model_flops(cfg, n_tokens, shape.kind == "train",
                               total_p, active_p)
    rec["params_total"] = total_p
    rec["params_active"] = active_p
    rec["model_flops"] = mf

    fl = rec["analytic"]["flops_global"]
    if "oom" in rec:
        # a share that stopped partway: no roofline from part of a step
        rec.update(roofline=None, dominant=None, mfu_bound=None,
                   model_vs_counted=mf / fl if fl else None)
        if verbose:
            print(f"[{rec['mesh']}] {arch} × {shape_name}: out of memory at "
                  f"≥{rec['memory_per_device']['total_bytes'] / 2 ** 30:.2f}"
                  f"GiB after {rec['first_step_s']:.1f}s", flush=True)
        return rec

    # roofline terms (seconds)
    fl = fl or rec["device_cost"]["flops_per_device"] * chips
    by = rec["analytic"]["bytes_global"]
    t_comp = fl / (chips * PEAK_FLOPS)
    t_mem_device = rec["device_cost"]["bytes_per_device"] / HBM_BW
    t_mem_analytic = by / (chips * HBM_BW)
    t_coll = rec["collectives"]["wire_bytes_per_device"] / LINK_BW
    rec["roofline"] = {"compute_s": t_comp,
                       "memory_s_analytic": t_mem_analytic,
                       "memory_s_device": t_mem_device,
                       "collective_s": t_coll}
    t_mem = t_mem_analytic
    rec["dominant"] = max(("compute", t_comp), ("memory", t_mem),
                          ("collective", t_coll), key=lambda kv: kv[1])[0]
    top = max(t_comp, t_mem, t_coll)
    rec["mfu_bound"] = t_comp / top if top > 0 else 0.0
    rec["model_vs_counted"] = mf / fl if fl else 0.0
    if verbose:
        mem = rec["memory_per_device"]["total_bytes"] / 2 ** 30
        print(f"[{rec['mesh']}] {arch} × {shape_name}: "
              f"first_step={rec['first_step_s']:.1f}s mem/dev={mem:.2f}GiB "
              f"dom={rec['dominant']} "
              f"terms(ms)=({t_comp * 1e3:.2f},{t_mem * 1e3:.2f},"
              f"{t_coll * 1e3:.2f}) mfu_bound={rec['mfu_bound']:.2f}",
              flush=True)
    return rec


def _count_unsharded(cfg, shape, tcfg) -> dict:
    specs = spec_mod.input_specs(cfg, shape, tcfg)
    args = ((specs["state"], specs["batch"]) if shape.kind == "train"
            else (specs["params"], specs["batch"], specs["caches"]))
    if shape.kind == "decode":
        _set_length(args[2], shape.seq_len - 1)
    return flopcount.count_fn(step_of(cfg, shape, tcfg), *args)


def analytic_count(cfg, shape, tcfg) -> dict:
    """`flops.count_fn` over the whole unsharded step on ``meta``: counted
    at one and at two template periods and extended linearly to
    ``cfg.repeats`` (every period has the same shapes; the reference's
    walker multiplies its scan body by the trip count so), as a step at
    full depth runs one op at a time on the host."""
    if cfg.repeats <= 2:
        return _count_unsharded(cfg, shape, tcfg)
    one, two = (_count_unsharded(dataclasses.replace(
        cfg, num_layers=len(cfg.prologue) + r * len(cfg.block_template)),
        shape, tcfg) for r in (1, 2))
    return {k: one[k] + (cfg.repeats - 1) * (two[k] - one[k]) for k in one}


def _share(arch, shape_name, multi_pod, mesh_shape, world, device, rank,
           kw) -> dict:
    """Rank ``rank``'s share of the cell on a fake group of ``world``
    ranks (the production mesh, or a (data, model) ``mesh_shape``):
    memory, device cost, collectives and the wall."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        mesh = (local_mesh(*mesh_shape, device_type=device) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod,
                                          device_type=device))
        step_fn, args, _, _ = build_cell(arch, shape_name, mesh, **kw)
        arg_bytes = local_bytes(args)
        out, peak, wall, traffic, recorder, oom = _run_share(
            step_fn, args, device)
        out_bytes = _output_bytes(out, args)
        rec = {"first_step_s": wall, "memory_per_device": {
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes - out_bytes,
            "total_bytes": peak}}
        if oom is None:
            t = traffic.totals()
            rec["device_cost"] = {
                "flops_per_device": t["flops"] + t["elementwise_flops"],
                "bytes_per_device": t["bytes"],
                "transcendentals": t["transcendentals"]}
            rec["collectives"] = recorder.summary()
        else:   # counts of part of a step: none is kept
            rec["oom"] = oom
            rec["memory_per_device"]["peak_is_lower_bound"] = True
            rec["device_cost"] = rec["collectives"] = None
        hbm = (torch.cuda.get_device_properties(0).total_memory
               if device == "cuda" else H100_80GB_HBM3_BYTES)
        rec["fits_hbm"] = oom is None and peak < hbm
        del out, args, step_fn
        return rec
    finally:
        dist.destroy_process_group()
        _forget_meshes()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()


def _forget_meshes():
    """Clear ``DTensor``'s sharding-propagation cache: its entries hold
    their mesh, whose groups die with the fake group, and a later mesh of
    the same shape would find them."""
    cache = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
    if hasattr(cache, "cache_clear"):
        cache.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:     # the C++ dispatch's own (newer torch)
        native()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun.json")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-flops", action="store_true")
    ap.add_argument("--strategy", default="2d",
                    choices=["2d", "dp", "fsdp", "2d_fsdp", "fsdp_all"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--gather-params", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the dry run runs on a CUDA device unless told otherwise, and "
            "none is available: pass --device cpu to run it on the CPU")

    archs = list(configs.ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
        done = {(r["arch"], r["shape"], r["mesh"]) for r in records}

    for multi in meshes:
        mesh_name = "2x16x16" if multi else "16x16"
        for arch in archs:
            for shape in shapes:
                if (arch, shape, mesh_name) in done:
                    continue
                try:
                    rec = run_cell(arch, shape, multi,
                                   count_flops=not args.no_flops,
                                   strategy=args.strategy,
                                   microbatches=args.microbatches,
                                   compress=args.compress,
                                   remat=not args.no_remat,
                                   gather_params=args.gather_params,
                                   device=args.device, rank=args.rank)
                except Exception as e:  # a failing cell is a bug: record it
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[{mesh_name}] {arch} × {shape}: FAILED {e}",
                          flush=True)
                records.append(rec)
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)

    n_err = sum(1 for r in records if "error" in r)
    n_skip = sum(1 for r in records if "skipped" in r)
    print(f"\ndry-run complete: {len(records)} cells, {n_skip} skipped, "
          f"{n_err} errors → {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
