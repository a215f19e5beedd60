"""FLOP and byte accounting: parameter counts, the 6·N·D model FLOPs, and
a counter of what a function computes and moves.

Reference: ``repro/launch/flops.py``.  `param_counts` walks the port's
named parameters (build the model on the ``meta`` device: nothing is
allocated) and groups them by reference leaf
(`repro_torch.train.optimizer.reference_leaf`), so each of the ten configs
gives the reference's (total, active).

`count_fn` is the counterpart of the reference's jaxpr walker
(``count_jaxpr``/``count_fn``).  It runs the function once, each op as
it runs (so the backward pass and the recompute under
``torch.utils.checkpoint`` count as often as they run; on ``meta``
tensors nothing is computed), and returns:

- ``flops``: the matrix-product FLOPs (matmul, einsum, convolution,
  attention), as ``torch.utils.flop_counter.FlopCounterMode`` counts them;
- ``elementwise_flops``, ``bytes`` and ``transcendentals``: the
  reference's fused-traffic model, applied to each aten op by the class
  `OP_CLASS` gives its name (`TrafficCounter`).  Products and
  convolutions move their input and output bytes; reductions,
  ``argmax``/``argmin``, ``cumsum`` and sorts read their input and cost a
  FLOP an output element; gathers, scatters, ``index_put``, ``cat``, pads
  and slice writes (``copy_``) write their output, and a gather costs 3
  FLOPs an index (the reference's index normalisation: a compare, an add,
  a select); pure movement (views, reshapes, transposes, broadcasts, dtype
  casts, factories) costs nothing; a transcendental costs 10 FLOPs an
  output element and counts one in ``transcendentals``; any other op is
  elementwise, a FLOP an output element.  A few aten ops are one
  reference primitive chain each (``_softmax``, ``_log_softmax``,
  ``logsumexp``, ``logaddexp``, ``silu``, ``mean``): `_COMPOSITE` counts
  them as the reference's chain.  The reference's ``flops`` is products plus
  elementwise: the dry run's ``analytic.flops_global`` is that sum.

`TrafficCounter` also counts on ``DTensor``s' local shards: it lets
``DTensor`` run first and sees the local ops it issues (sharding
propagation, which runs under a fake mode, is skipped), and there it
counts the products itself, with ``FlopCounterMode``'s formulas on the
local shapes.  Collectives are not counted here
(`repro_torch.launch.dryrun` records them).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.models.lm import LM
from repro_torch.train.optimizer import reference_leaf

MOVEMENT, REDUCTION, WRITE, GATHER, TRANSCENDENTAL = (
    "movement", "reduction", "write", "gather", "transcendental")

# aten op name (an in-place op's trailing "_" dropped) → class; products
# are the ops of FlopCounterMode's registry, any name not here is
# elementwise
OP_CLASS: dict[str, str] = {
    **dict.fromkeys((
        "view", "_unsafe_view", "reshape", "_reshape_alias", "permute",
        "transpose", "t", "expand", "expand_as", "unsqueeze", "squeeze",
        "slice", "select", "as_strided", "clone", "contiguous", "_to_copy",
        "to", "detach", "alias", "split", "split_with_sizes", "unbind",
        "chunk", "narrow", "flip", "repeat", "diagonal", "unfold",
        "view_as_real", "view_as_complex", "lift_fresh", "lift_fresh_copy",
        "zeros", "zeros_like", "empty", "empty_like", "empty_strided",
        "full", "full_like", "ones", "ones_like", "new_zeros", "new_empty",
        "new_full", "new_ones", "new_empty_strided", "arange",
        "scalar_tensor", "fill", "zero", "_local_scalar_dense",
        "resize", "set", "_assert_async", "_assert_scalar"), MOVEMENT),
    **dict.fromkeys((
        "sum", "nansum", "mean", "amax", "amin", "max", "min", "aminmax",
        "prod", "argmax", "argmin", "any", "all", "cumsum", "cumprod",
        "cummax", "cummin", "logcumsumexp", "sort", "topk", "var",
        "var_mean", "std", "std_mean", "linalg_vector_norm", "norm",
        "count_nonzero"), REDUCTION),
    **dict.fromkeys((
        "scatter", "scatter_add", "scatter_reduce", "index_put",
        "_index_put_impl", "index_add", "index_copy", "index_fill",
        "masked_scatter", "cat", "stack", "constant_pad_nd", "pad",
        "reflection_pad1d", "reflection_pad2d", "replication_pad1d",
        "replication_pad2d", "slice_scatter", "select_scatter",
        "diagonal_scatter", "as_strided_scatter", "copy", "roll",
        "embedding_dense_backward"), WRITE),
    **dict.fromkeys((
        "index", "index_select", "gather", "embedding", "take",
        "take_along_dim"), GATHER),
    **dict.fromkeys((
        "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
        "sigmoid", "sin", "cos", "rsqrt", "sqrt", "erf", "erfinv", "pow",
        "float_power"), TRANSCENDENTAL),
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):     # most ops' output: no flatten
        return [tree]
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _rows(x, dim) -> int:
    """The output elements of a reduction of ``x`` over ``dim``."""
    return x.numel() // max(x.shape[dim] if x.dim() else 1, 1)


def _softmax(args, out):
    x, dim = args[0], args[1]
    n, r = x.numel(), _rows(x, dim)
    return 12 * n + 3 * r, 2 * _nbytes(x), n


def _log_softmax(args, out):
    x, dim = args[0], args[1]
    n, r = x.numel(), _rows(x, dim)
    return 12 * n + 13 * r, 2 * _nbytes(x), n + r


def _logsumexp(args, out):
    x = args[0]
    n, r = x.numel(), out.numel()
    return 11 * n + 18 * r, 2 * _nbytes(x), n + r


def _silu(args, out):
    return 11 * out.numel(), 0, out.numel()


def _mean(args, out):
    return 2 * out.numel(), _nbytes(args[0]), 0


def _logaddexp(args, out):
    # max, sub, ne, add, abs, neg, exp, log1p, add, select
    return 28 * out.numel(), 0, 2 * out.numel()


def _softmax_backward(args, out):
    # the VJP of the reference's chain: g·y, its row sum, g − Σ, ·y
    n = out.numel()
    return 3 * n + _rows(out, args[2]), _nbytes(args[0]), 0


def _log_softmax_backward(args, out):
    # exp(y), the row sum of g, exp(y)·Σ, g − that
    n = out.numel()
    return 12 * n + _rows(out, args[2]), _nbytes(args[0]), n


def _silu_backward(args, out):
    # σ(x), then g·(σ + x·σ·(1 − σ)): 10 + 4 an element
    return 14 * out.numel(), 0, out.numel()


# aten op name → (args, output) → (elementwise FLOPs, bytes,
# transcendentals), where one aten op is a chain of reference primitives
_COMPOSITE = {
    "_softmax": _softmax, "_log_softmax": _log_softmax,
    "logsumexp": _logsumexp, "logaddexp": _logaddexp, "silu": _silu,
    "mean": _mean,
    "_softmax_backward_data": _softmax_backward,
    "_log_softmax_backward_data": _log_softmax_backward,
    "silu_backward": _silu_backward,
}


def op_name(func) -> str:
    """An aten op's name for `OP_CLASS`: its packet's name, an in-place
    op's trailing ``_`` dropped (``add_`` → ``add``)."""
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _pow_is_integer(args) -> bool:
    e = args[1] if len(args) > 1 else None
    return isinstance(e, (int, float)) and not isinstance(e, bool) \
        and float(e).is_integer()


def faking() -> bool:
    """Whether a fake tensor mode is active (``DTensor``'s sharding
    propagation runs its ops under one: they compute nothing)."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


_SKIP, _PRODUCT = "skip", "product"


@functools.lru_cache(maxsize=None)
def _plan(func) -> tuple:
    """(whether to decompose ``func`` into the ops it is made of, how to
    count it: `_SKIP`, `_PRODUCT`, a `_COMPOSITE` entry, or its
    `OP_CLASS` class, None for elementwise), worked out once an op."""
    if func.namespace in ("_c10d_functional", "c10d",
                          "_c10d_functional_autograd"):
        return False, _SKIP
    if func._overloadpacket in flop_registry:
        return False, _PRODUCT
    name = op_name(func)
    if name in _COMPOSITE:
        return False, _COMPOSITE[name]
    # an op with a composite implementation (einsum under inference
    # mode): count the ops it is made of
    return (func.namespace == "aten" and func.has_kernel_for_dispatch_key(
        torch._C.DispatchKey.CompositeImplicitAutograd)), OP_CLASS.get(name)


class TrafficCounter(TorchDispatchMode):
    """Counts each aten op run under it by the reference's fused-traffic
    model (see the module docstring): ``flops`` (products, by
    ``FlopCounterMode``'s formulas), ``elementwise_flops``, ``bytes`` and
    ``transcendentals``.  Collective ops are left out."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.elementwise_flops = 0
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # let DTensor run first and count the local ops it issues
        if DTensor in types:
            return NotImplemented
        kwargs = kwargs or {}
        decompose, how = _plan(func)
        if decompose:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if how is not _SKIP and how != MOVEMENT and not faking():
            self._count(func, how, args, kwargs, out)
        return out

    def _count(self, func, how, args, kwargs, out):
        outs = _tensors(out)
        if how is _PRODUCT:
            self.flops += int(flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
            self._add(0, sum(map(_nbytes, _tensors((args, kwargs))))
                      + sum(map(_nbytes, outs)), 0)
            return
        if callable(how):
            self._add(*how(args, outs[0]))
            return
        n_out = sum(t.numel() for t in outs)
        if how == REDUCTION and func._overloadname != "other":
            self._add(n_out, _nbytes(args[0]), 0)
        elif how == WRITE:
            self._add(0, sum(map(_nbytes, outs)), 0)
        elif how == GATHER:
            idx = [t for t in _tensors(args[1:]) if not t.is_floating_point()]
            self._add(3 * sum(t.numel() for t in idx),
                      sum(map(_nbytes, outs)), 0)
        elif how == TRANSCENDENTAL and not (op_name(func) == "pow"
                                            and _pow_is_integer(args)):
            self._add(10 * n_out, 0, n_out)
        else:
            self._add(n_out, 0, 0)

    def _add(self, flops, nbytes, trans):
        self.elementwise_flops += flops
        self.bytes += nbytes
        self.transcendentals += trans

    def totals(self) -> dict:
        return {"flops": self.flops,
                "elementwise_flops": self.elementwise_flops,
                "bytes": self.bytes, "transcendentals": self.transcendentals}


def count_fn(fn, *args, **kwargs) -> dict:
    """What ``fn(*args, **kwargs)`` computes and moves (the arguments may
    lie on the ``meta`` device): {"flops": its matrix-product FLOPs, as
    ``FlopCounterMode`` counts them, "elementwise_flops", "bytes",
    "transcendentals": the reference's fused-traffic model}."""
    counter = FlopCounterMode(display=False)
    traffic = TrafficCounter()
    with counter, traffic:
        fn(*args, **kwargs)
    out = traffic.totals()
    out["flops"] = int(counter.get_total_flops())
    return out


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
