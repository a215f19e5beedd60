"""Serving drivers: LM generation and GW serving.

Reference: ``repro/launch/serve.py`` (``_gw_stream``, ``gw_main`` and
``main``).  Both run on the CUDA device unless ``--device`` says
otherwise.

LM generation: a randomly initialised model (seeded ``torch.Generator``),
or with ``--ckpt-dir`` the parameters of the latest checkpoint that
`repro_torch.launch.train` wrote there, answers a batch of random
equal-length prompts through
`repro_torch.serve.engine.Engine`; on the CPU the model computes in f32,
as the reference's does there:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --batch 4 --prompt-len 64 --max-new 32

GW serving: a standing event loop over a synthetic mixed-size request
stream, through `GWEngine.serve` (admission, dispatch and harvest
interleaved, pipelined across buckets, plan cache on):

  PYTHONPATH=src python -m repro_torch.launch.serve --gw --requests 24 \
      --repeat-frac 0.5 --cache-capacity 64

``run_event_loop`` (from `repro_torch.serve.engine`) is the library
surface: feed any iterable of problems to an engine and collect results as
they complete.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.geometry import PointCloudGeometry
from repro_torch.core.gw import GWConfig, resolve_device
from repro_torch.models import lm
from repro_torch.serve.engine import (Engine, GWEngine, GWServeConfig,
                                      ServeConfig, run_event_loop)

__all__ = ["main", "run_event_loop", "gw_main", "lm_main"]


def _gw_stream(n_requests: int, repeat_frac: float, seed: int, device):
    """A synthetic serving stream: mixed-size point-cloud GW problems (f32
    points, f64 marginals, on ``device``), a ``repeat_frac`` fraction of
    them exact repeats of earlier requests, the traffic shape the plan
    cache exists for."""
    rng = np.random.default_rng(seed)
    sizes = [(12, 16), (16, 12), (24, 24), (8, 20)]
    seen: list[tuple] = []
    for _ in range(n_requests):
        if seen and rng.random() < repeat_frac:
            yield seen[rng.integers(len(seen))]
            continue
        m, n = sizes[int(rng.integers(len(sizes)))]
        mu = rng.uniform(0.5, 1.5, m)
        nu = rng.uniform(0.5, 1.5, n)
        prob = (PointCloudGeometry(torch.tensor(
                    rng.normal(size=(m, 3)), dtype=torch.float32,
                    device=device)),
                PointCloudGeometry(torch.tensor(
                    rng.normal(size=(n, 3)), dtype=torch.float32,
                    device=device)),
                torch.tensor(mu / mu.sum(), device=device),
                torch.tensor(nu / nu.sum(), device=device))
        seen.append(prob)
        yield prob


def gw_main(args) -> None:
    """Drive `GWEngine.serve` over the synthetic stream and report the
    pipeline and cache telemetry the engine collected."""
    device = resolve_device(args.device)
    solver = GWConfig(eps=2e-1, outer_iters=60, sinkhorn_iters=200,
                      sinkhorn_chunk=25, backend="dense", eps_init=1.0,
                      anneal_decay=0.7)
    engine = GWEngine(GWServeConfig(
        solver=solver, tol=5e-4, max_batch=args.batch, size_bucket=16,
        scheduler="pipeline", max_inflight_buckets=args.inflight,
        cache_capacity=args.cache_capacity, cache_near_tol=args.near_tol,
        cache_profile_tol=args.profile_tol, service=args.service,
        device=device))
    t0 = time.perf_counter()
    done = run_event_loop(
        engine, _gw_stream(args.requests, args.repeat_frac, args.seed,
                           device),
        on_result=lambda rid, res: print(
            f"request {rid}: value={float(res.value):.6f} "
            f"outer={int(res.info.outer_iters)} "
            f"converged={bool(res.info.converged)}", flush=True))
    dt = time.perf_counter() - t0
    s = engine.stats
    print(f"{len(done)} results in {dt:.2f}s "
          f"({len(done) / max(dt, 1e-9):.1f} req/s) on {device}")
    print(f"dispatches={s['dispatches']} depth={s['dispatch_depth']} "
          f"device_idle={s['device_idle_s']:.3f}s "
          f"cache hits/warm/miss={s['cache_hits']}/"
          f"{s['cache_warm_starts']}/{s['cache_misses']} "
          f"(profile={s['cache_profile_hits']}) "
          f"sliced_answers={s['sliced_answers']}", flush=True)
    if engine.last_errors:
        print(f"{len(engine.last_errors)} bucket failures: "
              f"{[k for k, _ in engine.last_errors]}")


def lm_main(args) -> None:
    """Generate ``--max-new`` tokens for ``--batch`` random prompts with a
    randomly initialised ``--arch`` model."""
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cpu":
        cfg = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, gen, device)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is None:
            sys.exit(f"repro_torch.launch.serve: no checkpoint in "
                     f"{args.ckpt_dir} (repro_torch.launch.train --ckpt-dir "
                     "writes them)")
        restored = mgr.restore({"params": dict(params.named_parameters())})
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(restored["params"][k])
        print(f"restored params from step {mgr.latest_step()}", flush=True)
    engine = Engine(params, cfg,
                    ServeConfig(max_len=args.max_len, batch_size=args.batch,
                                temperature=args.temperature),
                    rng_seed=args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    print(f"{cfg.name} ({cfg.dtype}) on {device}: initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.max_new)
    dt = time.perf_counter() - t0
    for i, row in enumerate(out):
        print(f"request {i}: {row.tolist()}")
    print(f"{args.batch * args.max_new} tokens in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gw", action="store_true",
                    help="serve a synthetic GW request stream instead of LM")
    ap.add_argument("--arch", default="smollm-360m",
                    choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced smoke config")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM: cut the config's depth to this many layers "
                         "(as the checkpoint's train run did)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore trained params (a checkpoint of "
                         "repro_torch.launch.train) instead of random init")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the CUDA device)")
    # GW event-loop knobs
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--repeat-frac", type=float, default=0.5)
    ap.add_argument("--inflight", type=int, default=2)
    ap.add_argument("--cache-capacity", type=int, default=64)
    ap.add_argument("--near-tol", type=float, default=1e-6)
    ap.add_argument("--profile-tol", type=float, default=0.0,
                    help="sliced-profile second cache stage tolerance "
                         "(0 disables; catches rotated/re-indexed repeats)")
    ap.add_argument("--service", default="exact",
                    choices=["exact", "sliced", "refine"],
                    help="answer class: full solve, O(N log N) sliced "
                         "estimate, or sliced-then-refined")
    args = ap.parse_args(argv)
    if args.gw:
        gw_main(args)
    else:
        lm_main(args)


if __name__ == "__main__":
    main()
