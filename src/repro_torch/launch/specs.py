"""Stand-ins for every model input: tensors on the ``meta`` device, which
have a shape and a dtype and hold no storage.  The dry run
(`repro_torch.launch.dryrun`) counts against them and lays them out by
the sharding specs before a rank makes its own shards.

Reference: ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s these
``meta`` tensors stand in for.  Token ids and labels are int64, what the
port's `repro_torch.models.lm` takes (the reference's int32); embeddings
are bf16 and M-RoPE positions int32, the reference's dtypes.  A model is
`repro_torch.models.lm.LM` built on ``meta``, and its caches are
`lm.cache_init` on ``meta``: one dict a repeat, where the reference
stacks the repeats (`repro_torch.convert.lm_caches` splits them so).
`argument_bytes` reckons a rank's share of them from the sharding specs
alone.  Importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """The input batch of a (cfg, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"tokens": _sds((b, 1), torch.long)}
        return {"embeddings": _sds((b, 1, cfg.d_model), torch.bfloat16)}
    if cfg.input_mode == "tokens":
        batch = {"tokens": _sds((b, s), torch.long)}
    else:
        batch = {"embeddings": _sds((b, s, cfg.d_model), torch.bfloat16)}
        if cfg.m_rope:
            batch["positions"] = _sds((b, s, 3), torch.int32)
    if shape.kind == "train":
        batch["labels"] = _sds((b, s), torch.long)
    return batch


def abstract_params(cfg: ModelConfig) -> lm.LM:
    """The model of ``cfg`` with its parameters on ``meta``."""
    return lm.init_params(cfg, None, META)


def abstract_caches(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=torch.bfloat16) -> dict:
    return lm.cache_init(cfg, batch, max_len, dtype, META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, tcfg=None) -> dict:
    """Everything the step of this cell takes, on ``meta``.

    train  → {"state", "batch"}   state: the model and AdamW's moments
                                  (a `repro_torch.train.loop.TrainState`;
                                  ``tcfg`` picks the error feedback)
    prefill→ {"params", "batch", "caches"}
    decode → {"params", "batch", "caches"}   batch is the 1-token feed
    """
    from repro_torch.train import loop as train_loop

    if shape.kind == "train":
        state = train_loop.init_state(cfg, tcfg or train_loop.TrainConfig(),
                                      None, META)
        return {"state": state, "batch": batch_specs_for(cfg, shape)}
    return {"params": abstract_params(cfg),
            "batch": batch_specs_for(cfg, shape),
            "caches": abstract_caches(cfg, shape.global_batch,
                                      shape.seq_len)}


def mesh_axes(sizes) -> dict:
    """{axis: size} of a mesh of ``sizes``, named as the port's meshes
    are: (data, model), or (pod, data, model)."""
    return dict(zip(("pod", "data", "model")[-len(sizes):], sizes))


def local_numel(full, spec: tuple, mesh: dict, coords=None) -> int:
    """Elements of a rank's shard of a tensor of shape ``full`` laid out
    by ``spec`` on ``mesh`` ({axis: size}, in mesh order): each mesh
    axis that an entry names splits that dim as ``torch.chunk`` does
    (``DTensor``'s ``Shard``), axis after axis in mesh order.
    ``coords``: the rank's index on each axis (0 on each if omitted)."""
    sizes = list(full)
    for axis, n in mesh.items():
        for d, entry in enumerate(spec):
            if n > 1 and axis in (entry if isinstance(entry, tuple)
                                  else (entry,)):
                c = (coords or {}).get(axis, 0)
                chunk = -(-sizes[d] // n)
                sizes[d] = max(0, min(sizes[d], chunk * (c + 1)) - chunk * c)
    return math.prod(sizes)


def argument_bytes(cfg: ModelConfig, shape: ShapeSpec, sizes,
                   strategy: str = "2d", coords=None) -> int:
    """The bytes of a rank's share of a cell's arguments on a mesh of
    ``sizes`` (`mesh_axes`), from the sharding specs alone: parameters
    by `param_specs`, a train state's two f32 moments by `zero_specs`
    (no error feedback: ``--compress`` off), the batch by `batch_specs`,
    the caches by `cache_specs`; each tensor's `local_numel` times its
    item size."""
    from repro_torch.distributed import sharding
    mesh = mesh_axes(tuple(sizes))
    data = sharding.data_axes_of(mesh)

    def nbytes(t, spec, itemsize=None):
        return local_numel(tuple(t.shape), spec, mesh, coords) * (
            itemsize or t.element_size())
    params = dict(abstract_params(cfg).named_parameters())
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    pspecs = sharding.param_specs(shapes, mesh, strategy)
    total = sum(nbytes(p, pspecs[k]) for k, p in params.items())
    if shape.kind == "train":
        zspecs = sharding.zero_specs(shapes, pspecs, mesh)
        total += 2 * sum(nbytes(p, zspecs[k], 4) for k, p in params.items())
    batch = batch_specs_for(cfg, shape)
    bspecs = sharding.batch_specs(batch, mesh, data)
    total += sum(nbytes(v, bspecs[k]) for k, v in batch.items())
    if shape.kind != "train":
        caches = abstract_caches(cfg, shape.global_batch, shape.seq_len)

        def walk(c, sp):
            if isinstance(c, dict):
                return sum(walk(c[k], sp[k]) for k in c if k != "length")
            if isinstance(c, (list, tuple)):
                return sum(walk(a, b) for a, b in zip(c, sp))
            return nbytes(c, sp)
        total += walk(caches, sharding.cache_specs(caches, mesh, data))
    return total
