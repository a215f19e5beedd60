"""End-to-end training driver.

Reference: ``repro/launch/train.py``, with the same flags, plus
``--device`` (the CUDA device unless it says otherwise) and
``--deterministic`` (PyTorch's deterministic algorithms, so that a resumed
run repeats an uninterrupted one bit for bit on the card).  On the CPU the
model computes in f32, as the reference's does there; on the card in its
config's dtype (bf16 compute, f32 parameters).

  # a smoke-sized smollm-family model, a few hundred steps on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --smoke --steps 300 --global-batch 8 --seq 256 --device cpu
  # smollm-360m at its published config on the card, checkpointed; run
  # again to resume from the latest checkpoint (after a crash or SIGTERM):
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 100 --ckpt-dir /tmp/run1
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            install_preemption_handler)
from repro_torch.core.gw import resolve_device
from repro_torch.data import pipeline
from repro_torch.distributed.fault_tolerance import Heartbeat
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as optim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--gw-align-weight", type=float, default=0.0,
                    help=">0 adds the FGW sequence-alignment loss against "
                         "batch['teacher_h']")
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "memmap"])
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="the training device (default: the CUDA device)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms(True)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.deterministic:
        # cuBLAS's deterministic workspace, before its first use
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if device.type == "cpu":       # CPU runs want f32 compute
        cfg = dataclasses.replace(cfg, dtype="float32")

    ocfg = optim.OptimizerConfig(lr=args.lr, warmup_steps=args.warmup,
                                 total_steps=args.steps,
                                 compress_grads=args.compress_grads)
    tcfg = train_loop.TrainConfig(microbatches=args.microbatches,
                                  remat=False,
                                  gw_align_weight=args.gw_align_weight,
                                  optimizer=ocfg)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.global_batch,
                               seed=args.seed, kind=args.data,
                               path=args.data_path)
    data = pipeline.make_dataset(dcfg)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = train_loop.init_state(cfg, tcfg, gen, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tokens/step={args.global_batch * args.seq} device={device} "
          f"dtype={cfg.dtype}", flush=True)

    manager = None
    hold = contextlib.nullcontext
    start_step = 0
    hb = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        hold = install_preemption_handler(
            manager, lambda: train_loop.state_tree(state),
            lambda: state.step).hold
        latest = manager.latest_step()
        if latest is not None:
            train_loop.load_state_tree(state, manager.restore(
                train_loop.state_tree(state), latest))
            start_step = state.step
            print(f"resumed from checkpoint step {start_step}", flush=True)
        hb = Heartbeat(os.path.join(args.ckpt_dir, "heartbeats"), host_id=0)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = data.batch(step)
        with hold():           # SIGTERM waits for the in-place update
            metrics = train_loop.train_step(state, batch, cfg, tcfg)
        if hb:
            hb.beat(step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            tps = (step - start_step + 1) * args.global_batch * args.seq / dt
            print(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"tok/s={tps:.0f}", flush=True)
        if manager and args.ckpt_every and step and \
                step % args.ckpt_every == 0:
            manager.save_async(step, train_loop.state_tree(state))
    if manager:
        t0 = time.time()
        manager.save(args.steps, train_loop.state_tree(state))
        manager.wait()
        print(f"checkpoint step {args.steps} saved in {time.time() - t0:.1f}s",
              flush=True)
    return state


if __name__ == "__main__":
    main()
