"""Atomic, async checkpointing with keep-k GC and restore onto any device.

Reference: ``repro/checkpoint/manager.py``, with the same layout:
``<dir>/step_<N>/`` (N zero-padded to 8 digits) holding ``leaf_<i>.npy``
and ``manifest.json`` (each leaf's key, file, shape and dtype; the
manifest marked complete).  A save writes ``step_<N>.tmp`` and renames it
into place, so a crashed save is never mistaken for a checkpoint: only
directories with a manifest count, and ``.tmp`` directories are ignored.

A tree is a nested dict (or list) of tensors, numpy arrays or Python
numbers; a leaf's key is its path joined by dots (``params.embed``,
``opt.m.stack.scanned.slot0.3.attn.wq``, ``step``), the port's state
names (`repro_torch.train.loop.state_tree`).  numpy has no bfloat16, so a
bf16 tensor is stored as its uint16 bit pattern with ``"dtype":
"bfloat16"`` in the manifest, and comes back as bf16.

Elastic restore: leaves are stored whole, and `CheckpointManager.restore`
puts each on any device: saved from the card, restored on the CPU, and
back; and on any mesh (``shardings``): saved on a (2, 2) mesh, restored on
(4, 1) or in one process.  A ``DTensor`` leaf is saved whole too: every
rank takes part in its ``full_tensor()``, rank 0 writes, and every rank
waits for the write (a barrier in `CheckpointManager.wait`).

Async: `CheckpointManager.save_async` copies the leaves to host memory
synchronously (a copy, so that an in-place update after it does not reach
the snapshot) and writes on a daemon thread; `wait` joins it before the
next save or exit.  Preemption: `install_preemption_handler` turns
SIGTERM into a final synchronous save.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, distribute_tensor

from repro_torch.core.gw import resolve_device
from repro_torch.distributed.sharding import placements as spec_placements


def _tree_leaves(tree, prefix: str = ""):
    """(dotted key, leaf) of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _tree_map(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` and the dtype name for the manifest."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._sharded = False
        self._writer = True

    # -- write ------------------------------------------------------------
    def save(self, step: int, tree: Any):
        self.wait()
        snap = self._snapshot(tree)
        if self._writer:
            self._write(step, snap)
        self.wait()

    def save_async(self, step: int, tree: Any):
        self.wait()
        snap = self._snapshot(tree)           # host copy, synchronous
        if self._writer:
            self._thread = threading.Thread(
                target=self._write, args=(step, snap), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:       # every rank waits for rank 0's write
            self._sharded = False
            dist.barrier()

    def _snapshot(self, tree):
        leaves = list(_tree_leaves(tree))
        self._sharded = any(isinstance(v, DTensor) for _, v in leaves)
        self._writer = not self._sharded or dist.get_rank() == 0
        snap = []
        for k, v in leaves:
            if isinstance(v, DTensor):
                v = v.full_tensor()     # a collective: every rank gathers
            if self._writer:
                snap.append((k,) + _to_numpy(v))
        return snap

    def _write(self, step: int, snap):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "complete": True}
        for i, (key, arr, dtype) in enumerate(snap):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            manifest["leaves"].append(
                {"key": key, "file": f"leaf_{i}.npy",
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- read -------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                man = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(man):
                    out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None, device=None,
                shardings: Any = None):
        """The checkpoint (by default the latest) in the structure of
        ``like``: each tensor leaf of ``like`` gives its dtype and, unless
        ``device`` is given, its device (a ``meta`` leaf: the CUDA device);
        a numpy leaf gives its dtype, a Python number its type.

        ``shardings`` (the elastic re-shard): a tree of the structure of
        ``like`` whose leaves are None or ``(mesh, spec)``, a spec of
        `repro_torch.distributed.sharding` or a list of placements; each
        such leaf is distributed onto its mesh (any mesh: not the one it
        was saved from), each rank cutting its shard from the whole leaf
        it read.  Without ``shardings`` a ``DTensor`` leaf of ``like`` is
        laid out as it is."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {e["key"]: e for e in manifest["leaves"]}
        shard_of = dict(_sharding_leaves(shardings)) if shardings else {}

        def load(key, ref):
            e = by_key[key]
            arr = np.load(os.path.join(d, e["file"]))
            if isinstance(ref, torch.Tensor):
                t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                     if e["dtype"] == "bfloat16" else torch.from_numpy(arr))
                sh = shard_of.get(key)
                if sh is None and isinstance(ref, DTensor):
                    sh = (ref.device_mesh, ref.placements)
                if sh is not None:
                    mesh, spec = sh
                    pl = (list(spec) if spec and all(
                        isinstance(q, Placement) for q in spec)
                        else spec_placements(spec, mesh))
                    t = t.to(device=_mesh_device(mesh), dtype=ref.dtype)
                    return distribute_tensor(t, mesh, pl, src_data_rank=None)
                dev = device if device is not None else (
                    ref.device if ref.device.type != "meta" else None)
                return t.to(device=resolve_device(dev), dtype=ref.dtype)
            if isinstance(ref, np.ndarray):
                return arr.astype(ref.dtype)
            return type(ref)(arr)
        return _tree_map(load, like)


def _sharding_leaves(tree, prefix: str = ""):
    """(dotted key, leaf) of a ``shardings`` tree, whose leaves are None
    or (mesh, spec or placements) pairs."""
    if isinstance(tree, tuple) and tree and isinstance(tree[0], DeviceMesh):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _sharding_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _sharding_leaves(v, f"{prefix}{i}.")
    elif tree is not None:
        raise TypeError(f"a sharding leaf at {prefix[:-1]}: {tree!r}")


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Preemption:
    """The SIGTERM handler's state: a signal that arrives while `hold` is
    entered is deferred to its exit, so that the final save never sees a
    state half updated in place."""

    def __init__(self, manager: CheckpointManager, get_state: Callable,
                 get_step: Callable):
        self.manager = manager
        self.get_state = get_state
        self.get_step = get_step
        self._held = 0
        self._pending = False

    def handler(self, signum, frame):
        if self._held:
            self._pending = True
        else:
            self._save_and_exit()

    def _save_and_exit(self):
        self.manager.save(int(self.get_step()), self.get_state())
        raise SystemExit(143)

    @contextlib.contextmanager
    def hold(self):
        self._held += 1
        try:
            yield
        finally:
            self._held -= 1
        if not self._held and self._pending:
            self._save_and_exit()


def install_preemption_handler(manager: CheckpointManager, get_state,
                               get_step) -> Preemption:
    """SIGTERM → a synchronous final checkpoint, then exit 143.  Returns the
    `Preemption` whose ``hold()`` a train loop enters around each in-place
    update (the reference's state is replaced whole, so it needs none)."""
    pre = Preemption(manager, get_state, get_step)
    signal.signal(signal.SIGTERM, pre.handler)
    return pre
