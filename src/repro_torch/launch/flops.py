"""FLOP accounting: parameter counts, the 6·N·D model FLOPs, and a counter
of a function's matrix-product FLOPs.

Reference: ``repro/launch/flops.py``.  `param_counts` walks the port's
named parameters (build the model on the ``meta`` device: nothing is
allocated) and groups them by reference leaf
(`repro_torch.train.optimizer.reference_leaf`), so each of the ten configs
gives the reference's (total, active).  The reference's jaxpr walker
(``count_jaxpr``/``count_fn``) has as its counterpart `count_fn`, which
runs the function under ``torch.utils.flop_counter.FlopCounterMode``: it
counts the products (matmul, einsum, convolution, attention), each call
as it runs, so the backward pass and the recompute under
``torch.utils.checkpoint`` are counted as often as they run.  It counts
no bytes (the reference's walker also gives an unfused-traffic byte
bound), and no elementwise or transcendental operations.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.models.lm import LM
from repro_torch.train.optimizer import reference_leaf


def count_fn(fn, *args, **kwargs) -> dict:
    """{"flops": the matrix-product FLOPs of ``fn(*args, **kwargs)``}, as
    ``FlopCounterMode`` counts them (the arguments may lie on the ``meta``
    device)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": int(counter.get_total_flops())}


def model_flops(cfg, n_tokens: int, train: bool,
                params_count: int, active_params_count: int) -> float:
    """The 6·N·D convention (2·N·D for inference), MoE-active-aware."""
    n = active_params_count
    return (6.0 if train else 2.0) * n * n_tokens


def param_counts(named_shapes, cfg):
    """(total, active) over ``named_shapes`` (name → shape, or a module's
    ``named_parameters()``): active discounts routed experts to top-k/E
    and leaves out the embedding and head, the reference's rule, applied
    to each reference leaf."""
    if hasattr(named_shapes, "items"):
        named_shapes = named_shapes.items()
    leaves: dict[str, int] = {}
    for name, shape in named_shapes:
        shape = tuple(shape)
        leaf = reference_leaf(name, len(shape))[0]
        leaves[leaf] = leaves.get(leaf, 0) + int(np.prod(shape))
    total = 0
    active = 0
    for leaf, size in leaves.items():
        names = leaf.split(".")
        total += size
        if "moe" in names and any(n in ("w_gate", "w_up", "w_down")
                                  for n in names) and "shared" not in names:
            frac = cfg.num_experts_per_tok / max(cfg.num_experts, 1)
            active += int(size * frac)
        elif "embed" in names or "head" in names:
            pass  # embeddings are outside the 6ND convention
        else:
            active += size
    return total, active


def meta_shapes(cfg) -> dict:
    """Name → shape of a model of ``cfg`` built on the ``meta`` device (the
    reference's ``jax.eval_shape`` of ``init_params``)."""
    model = LM(cfg, None, device="meta")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}
