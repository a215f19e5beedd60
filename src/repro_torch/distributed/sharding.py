"""Divisibility-aware sharding rules: TP / EP / DP / ZeRO partition specs.

Reference: ``repro/distributed/sharding.py``, as plain functions over the
port's named parameter shapes and a mesh shape (``{"data": 16, "model":
16}``); a spec is a tuple of axis names (or None, or a tuple of names),
one entry a dimension.  `placements` turns a spec into ``DTensor``
placements on a ``DeviceMesh`` (the reference's ``named``), and
`distribute` / `distribute_module` lay a tensor or a module's parameters
out by such specs (`repro_torch.launch.mesh` builds the meshes).

The rule engine lists candidate dims per parameter name in priority order
and picks the first one divisible by the mesh axis; anything that fails
every candidate stays replicated.  The rules read the reference's leaf
(`repro_torch.train.optimizer.reference_leaf`): a scanned parameter (one
tensor a repeat here) is given the spec of its stacked reference leaf,
(repeats,) + its shape, with the leading repeat axis removed.  So every
spec is the reference's without that axis; where the reference shards the
repeat axis itself (a candidate that reaches past a small leaf's rank, or
the largest divisible dim under an FSDP rule), the port's parameter
leaves that mesh axis unused.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.train.optimizer import reference_leaf

# param-name → candidate dims (from the end) for the `model` axis
MODEL_AXIS_RULES: dict[str, list[int]] = {
    # embeddings / head: shard vocab
    "embed": [-2],
    "head": [-1],
    "in_proj": [-1],
    # attention: shard heads (col-parallel) / first dim of wo (row-parallel)
    "wq": [-2, -3],
    "wk": [-2],
    "wv": [-2],
    "wo": [-2],
    # MLA
    "w_dkv": [-1],
    "w_uk": [-2],
    "w_uv": [-2],
    "w_kr": [],
    # dense MLP: col-parallel up/gate, row-parallel down
    "w_gate": [-1],
    "w_up": [-1],
    "w_down": [-2],
    # MoE: expert-parallel first, fall back to ff sharding
    "router": [],
    # ssm
    "w_in": [-1],
    "w_out": [-2],
    "conv_w": [-1],
    "conv_b": [-1],
    "w_igate": [],
    "w_fgate": [],
    "b_fgate": [],
    "r_gates": [-1],
    "w_gates": [-1],
    "b_gates": [-1],
}

# MoE expert tensors get the expert dim tried first (EP), then ff
MOE_EXPERT_RULES = {
    "w_gate": [-3, -1],
    "w_up": [-3, -1],
    "w_down": [-3, -2],
}


def _axis_size(mesh: dict, axis) -> int:
    if isinstance(axis, tuple):
        return int(np.prod([mesh[a] for a in axis]))
    return mesh[axis]


def _spec_for(shape, candidates, mesh: dict, axis="model") -> tuple:
    size = _axis_size(mesh, axis)
    spec = [None] * len(shape)
    for dim in candidates:
        d = dim % len(shape) if dim < 0 else dim
        if d < len(shape) and shape[d] % size == 0 and shape[d] > 0:
            spec[d] = axis
            return tuple(spec)
    return tuple(spec)


def _used(entries) -> set:
    used = set()
    for e in entries:
        if isinstance(e, tuple):
            used.update(e)
        elif e is not None:
            used.add(e)
    return used


def _add_largest_dim(shape, spec: tuple, mesh: dict, axis) -> tuple:
    size = _axis_size(mesh, axis)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    new_axes = set(axis) if isinstance(axis, tuple) else {axis}
    if _used(entries) & new_axes:
        return tuple(entries)
    best, best_dim = 0, None
    for d in range(len(shape)):
        if entries[d] is None and shape[d] % size == 0 and shape[d] > best:
            best, best_dim = shape[d], d
    if best_dim is not None and best >= size:
        entries[best_dim] = axis
    return tuple(entries)


def _on_reference_leaves(shapes: dict, spec_of) -> dict:
    """Name → spec, ``spec_of(name, shape)`` evaluated on each parameter's
    reference leaf shape (a scanned slot's repeats stacked in front) and
    the repeat axis dropped again."""
    leaf_of = {k: reference_leaf(k, len(s)) for k, s in shapes.items()}
    repeats: dict[str, int] = {}
    for leaf, _ in leaf_of.values():
        repeats[leaf] = repeats.get(leaf, 0) + 1
    out = {}
    for k, shape in shapes.items():
        leaf, rank = leaf_of[k]
        shape = tuple(shape)
        if rank > len(shape):
            out[k] = spec_of(k, (repeats[leaf],) + shape)[1:]
        else:
            out[k] = spec_of(k, shape)
    return out


def param_specs(shapes: dict, mesh: dict, strategy: str = "2d") -> dict:
    """Name → spec for a model's parameters (``shapes``: name → shape).

    strategy:
      "2d"       — TP/EP over ``model`` (the default baseline).
      "dp"       — replicated parameters (pure data parallel + ZeRO
                   moments), except the vocab of embed/head, which stays on
                   ``model`` so the (B,S,V) logits never materialize whole.
      "fsdp"     — parameters over ``data`` on their largest divisible dim;
                   no TP.
      "fsdp_all" — ZeRO-3 over every mesh axis at once.
      "2d_fsdp"  — TP over ``model`` + the largest remaining dim over
                   ``data``.
    """
    def leaf_spec(path: str, shape) -> tuple:
        names = path.split(".")
        name = names[-1]
        ndim = len(shape)
        if strategy == "dp":
            if name in ("embed", "head"):
                return _spec_for(shape, MODEL_AXIS_RULES[name], mesh)
            return (None,) * ndim
        if name in ("scale", "bias", "a_log", "dt_bias", "d_skip"):
            return (None,) * ndim
        if strategy == "fsdp":
            return _add_largest_dim(shape, (None,) * ndim, mesh, "data")
        if strategy == "fsdp_all":
            return _add_largest_dim(shape, (None,) * ndim, mesh, tuple(mesh))
        if "moe" in names and name in MOE_EXPERT_RULES:
            cands = MOE_EXPERT_RULES[name]
        else:
            cands = MODEL_AXIS_RULES.get(name, [-1, -2])
        spec = _spec_for(shape, cands, mesh)
        if strategy == "2d_fsdp":
            spec = _add_largest_dim(shape, spec, mesh, "data")
        return spec

    return _on_reference_leaves(shapes, leaf_spec)


def zero_specs(shapes: dict, pspecs: dict, mesh: dict,
               axis="data") -> dict:
    """ZeRO-1: the optimizer moments take the parameter's spec plus a
    ``data`` shard on the largest still-unsharded divisible dim."""
    size = _axis_size(mesh, axis)

    def add_axis(name, shape):
        spec = pspecs[name]
        if len(spec) < len(shape):      # a scanned leaf: its repeat axis
            spec = (None,) + tuple(spec)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if axis in _used(entries):
            return tuple(entries)
        best, best_dim = 0, None
        for d in range(len(shape)):
            if entries[d] is None and shape[d] % size == 0 \
                    and shape[d] > best:
                best, best_dim = shape[d], d
        if best_dim is not None and best >= size:
            entries[best_dim] = axis
        return tuple(entries)

    return _on_reference_leaves(shapes, add_axis)


def cache_specs(caches, mesh: dict, data_axes=("data",)):
    """KV caches / SSM states (the port's caches: per repeat, so no
    leading repeats axis to skip): the batch dim over the data axes when
    divisible, and ``model`` on the longest divisible remaining dim
    (sequence/state parallelism for batch-1 long-context decode).  The
    same structure, with a spec for each tensor and () for ``length``."""
    batch_size = _axis_size(mesh, tuple(data_axes))
    msize = _axis_size(mesh, "model")

    def leaf_spec(shape) -> tuple:
        spec = [None] * len(shape)
        if shape and shape[0] % batch_size == 0 and shape[0] >= batch_size:
            spec[0] = data_axes if len(data_axes) > 1 else data_axes[0]
        best, best_dim = 0, None
        for d in range(1, len(shape)):
            if shape[d] % msize == 0 and shape[d] > best:
                best, best_dim = shape[d], d
        if best_dim is not None and best >= msize:
            spec[best_dim] = "model"
        return tuple(spec)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (() if k == "length" else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return leaf_spec(tuple(tree.shape))

    return walk(caches)


def batch_specs(batch: dict, mesh: dict, data_axes=("data",)) -> dict:
    """Input batches: the leading (batch) dim over the data axes."""
    size = _axis_size(mesh, tuple(data_axes))
    axis = data_axes if len(data_axes) > 1 else data_axes[0]

    def leaf_spec(shape) -> tuple:
        spec = [None] * len(shape)
        if shape and shape[0] % size == 0 and shape[0] >= size:
            spec[0] = axis
        return tuple(spec)

    return {k: leaf_spec(tuple(np.shape(v))) for k, v in batch.items()}


def data_axes_of(mesh: dict) -> tuple[str, ...]:
    return tuple(a for a in mesh if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# applying the specs: DTensor placements on a DeviceMesh
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> dict:
    """Axis name → size of a ``DeviceMesh``, the mesh shape the rules
    read."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: tuple, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh`` (a
    ``DeviceMesh``), one per mesh dim: a mesh dim named in entry d gives
    ``Shard(d)``, each mesh dim of a tuple entry too (its axes must be in
    mesh order, the major one first, as JAX splits a tuple entry, which is
    also ``DTensor``'s order), any other mesh dim ``Replicate()``.  A
    mesh dim of size 1 replicates (a shard of one is the whole tensor,
    and ``DTensor`` refuses some views of a dim sharded over one rank)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the order of "
                             f"the mesh axes {tuple(names)}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def distribute(x: torch.Tensor, mesh, spec: tuple,
               src_data_rank=0, fill=None) -> DTensor:
    """``x`` laid out by ``spec`` on ``mesh``: with ``src_data_rank=0``
    every rank's shard comes from rank 0's ``x``; with None each rank cuts
    its shard from its own ``x`` (the same on every rank) with no
    communication.  An ``x`` on the ``meta`` device has no values: with
    ``fill`` each rank makes only its own shard (`local_shard`)."""
    if x.is_meta and fill is not None:
        return local_shard(x, mesh, spec, fill)
    return distribute_tensor(x, mesh, placements(spec, mesh),
                             src_data_rank=src_data_rank)


def local_shard(x: torch.Tensor, mesh, spec: tuple, fill) -> DTensor:
    """A ``DTensor`` of ``x``'s shape and dtype laid out by ``spec`` of
    which this rank makes and holds only its own shard, ``fill(shape,
    dtype, device)`` on the mesh's device: for a tensor whose whole never
    exists anywhere (``x`` may lie on ``meta``; a production state, of
    which a rank holds a 256th)."""
    pl = placements(spec, mesh)
    shape, _ = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    return DTensor.from_local(fill(tuple(shape), x.dtype, dev), mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def zeros(shape, dtype, device) -> torch.Tensor:
    """A `local_shard` fill: zeros (moments and caches start so)."""
    return torch.zeros(shape, dtype=dtype, device=device)


def distribute_module(module: torch.nn.Module, mesh, specs: dict,
                      src_data_rank=0, fill=None) -> torch.nn.Module:
    """Replace each named parameter of ``module`` (in place) by a
    parameter holding its ``DTensor`` laid out by ``specs[name]``
    (``fill``: as `distribute`'s, for a module on ``meta``)."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        d = distribute(p.detach(), mesh, specs[name], src_data_rank, fill)
        sub._parameters[leaf] = torch.nn.Parameter(
            d, requires_grad=p.requires_grad)
    return module


def mesh_of(module: torch.nn.Module):
    """The ``DeviceMesh`` of a module whose parameters are ``DTensor``s
    (`distribute_module`), else None."""
    p = next(iter(module.parameters()), None)
    return p.device_mesh if isinstance(p, DTensor) else None


_ON_MESH = [0]


@contextlib.contextmanager
def on_mesh(mesh):
    """The context a sharded forward and backward run in: a plain tensor
    that meets a ``DTensor`` (an ``arange``, a mask, a zero carry: the
    same on every rank) counts as replicated on ``mesh``
    (``implicit_replication``, entered once however deep the nesting).
    A null context without a mesh."""
    if mesh is None or _ON_MESH[0]:
        yield
        return
    _ON_MESH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _ON_MESH[0] -= 1


def pin(x):
    """``x`` unchanged; on a ``DTensor``, its gradient is laid out as
    ``x`` is (a redistribute in the backward pass).  Placed before a view
    that splits a sharded dim into one that does not divide the mesh axis
    (3 heads of 16 on a 2-wide ``model`` axis)."""
    if isinstance(x, DTensor):
        return x.redistribute(x.device_mesh, x.placements)
    return x


def distribute_batch(batch: dict, mesh) -> dict:
    """A batch's tensors (the same on every rank) as ``DTensor``s split
    by `batch_specs` over the mesh's data axes; each rank cuts its shard
    from its own copy, with no communication."""
    shape = mesh_shape(mesh)
    specs = batch_specs(batch, shape, data_axes_of(shape))
    return {k: distribute(v, mesh, specs[k], src_data_rank=None)
            for k, v in batch.items()}


def batch_local(fn, *args, whole=(), **kw):
    """``fn(*args, *whole, **kw)`` run on each rank's batch shard.  A
    ``DTensor`` in ``args`` (each batch-leading) is laid out with its
    dim 0 sharded as the first one's and every other dim whole, and
    ``fn`` gets its local tensor; a tensor in ``whole`` (a parameter) is
    gathered whole, its local gradient a ``Partial`` sum over the mesh
    dims that split the batch.  ``fn``'s tensors come back as
    ``DTensor``s in the batch layout.  Without a ``DTensor`` it is
    ``fn`` itself.  For the ops whose layout ``DTensor`` cannot carry
    through (a flash loop's reshapes, a recurrence over time, a softmax
    over a sharded sequence): each costs the gathers of its inputs'
    non-batch shards."""
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args, *whole, **kw)
    mesh = first.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate()
          for p in first.placements]
    grad = [Partial() if p == Shard(0) else Replicate() for p in pl]
    local = [a.redistribute(mesh, pl).to_local()
             if isinstance(a, DTensor) else a for a in args]
    full = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad) if isinstance(w, DTensor) else w
        for w in whole]
    out = fn(*local, *full, **kw)

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, pl, run_check=False)
        if isinstance(t, tuple):
            return tuple(wrap(u) for u in t)
        return t
    return wrap(out)
