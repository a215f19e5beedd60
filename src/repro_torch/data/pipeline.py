"""Data pipeline: deterministic synthetic LM stream + memmap token shards.

Reference: ``repro/data/pipeline.py``, kept as the port's own copy (it
needs numpy only).  The same numpy calls in the same order, so a ``(seed,
step, host)`` batch is the reference's, bit for bit.  Batches come back as
numpy arrays; the train step moves them to its device.

Multi-host discipline: every batch is derived from (seed, step,
host_slice), so any host can reconstruct any step — restart and elastic
resume need no iterator state beyond the step counter (checkpointed with
the model), and a straggler's batch can be re-issued deterministically.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 50304
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    kind: str = "synthetic"        # synthetic | memmap
    path: Optional[str] = None     # memmap token file (uint16/uint32)
    num_hosts: int = 1
    host_id: int = 0


def _host_slice(cfg: DataConfig):
    per_host = cfg.global_batch // cfg.num_hosts
    lo = cfg.host_id * per_host
    return lo, per_host


class SyntheticLM:
    """Zipf-ish token stream with local structure (repeats + an n-gram
    echo), so that a small model visibly learns within a few hundred
    steps."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int):
        cfg = self.cfg
        lo, per_host = _host_slice(cfg)
        rng = np.random.default_rng((cfg.seed, step))
        # zipf-like marginal over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch,
                                                cfg.seq_len + 1), p=probs)
        # learnable structure: echo token i − 4 with probability 1/2
        echo = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 0.5
        toks[:, 4:] = np.where(echo[:, 4:], toks[:, :-4], toks[:, 4:])
        toks = toks[lo:lo + per_host].astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapLM:
    """A flat binary token file (np.uint16/uint32).  Deterministic block
    sampling per (seed, step); hosts read disjoint row slices."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        if not (cfg.path and os.path.exists(cfg.path)):
            raise FileNotFoundError(f"no token file at {cfg.path!r}")
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=dtype, mode="r")
        self.n = len(self.tokens) - cfg.seq_len - 1
        if self.n <= 0:
            raise ValueError(f"{cfg.path}: {len(self.tokens)} tokens, fewer "
                             f"than a sequence of {cfg.seq_len + 1}")

    def batch(self, step: int):
        cfg = self.cfg
        lo, per_host = _host_slice(cfg)
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, self.n, size=cfg.global_batch)
        starts = starts[lo:lo + per_host]
        rows = np.stack([self.tokens[s:s + cfg.seq_len + 1] for s in starts])
        rows = rows.astype(np.int32)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_dataset(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "memmap":
        return MemmapLM(cfg)
    raise ValueError(cfg.kind)


def write_token_file(path: str, tokens: np.ndarray):
    tokens.astype(np.uint16).tofile(path)
