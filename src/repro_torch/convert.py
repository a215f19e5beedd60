"""Carry the reference's objects across to the port.

What carries across of the GW side is the geometry (grids, low-rank
factors, point clouds), the measures and the solver state (dense or
factored couplings).  Each function takes the
reference object's fields as plain Python values and numpy arrays (so this
module needs nothing of JAX) and returns the port's object on ``device``.
A language model's parameters and caches carry across with `lm_params`,
`lm_model` and `lm_caches`, its config with `model_config`, and a
trainer's whole state (parameters, AdamW moments, step counts) with
`train_state`.
A solve begun in the reference can be resumed here: convert its
``MirrorCarry`` leaves with `mirror_carry` and hand the result to
`repro_torch.core.gw_plan_segment` (one problem's carry) or, as
``resume_state``, to `repro_torch.core.entropic_gw_batch` (a batch's
stacked carry, with `solve_controls` for its stacked controls).  A serving
engine's config carries across with `serve_config`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.barycenter import BarycenterConfig
from repro_torch.core.coot import COOTConfig
from repro_torch.core.coupling import FullCoupling, LowRankCoupling
from repro_torch.core.fgw import FGWConfig
from repro_torch.core.geometry import LowRankGeometry, PointCloudGeometry
from repro_torch.core.grids import Grid1D, Grid2D
from repro_torch.core.gw import GWConfig, as_tensor, resolve_device
from repro_torch.core.losses import AlignConfig
from repro_torch.core.solver import MirrorCarry, SolveControls
from repro_torch.core.ugw import UGWConfig
from repro_torch.models.common import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.serve.engine import GWServeConfig
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import AdamWState

#: the reference's FGC backend names → the port's
FGC_BACKEND_NAMES = {"scan": "scan", "cumsum": "cumsum",
                     "blocked": "blocked", "dense": "dense",
                     "pallas": "kernel"}
#: the reference's Sinkhorn and factored-plan backend names → the port's
SINKHORN_BACKEND_NAMES = {"auto": "auto", "pallas": "kernel", "xla": "torch"}
LOWRANK_BACKEND_NAMES = SINKHORN_BACKEND_NAMES


def grid1d(n: int, h: float, k: int) -> Grid1D:
    return Grid1D(int(n), float(h), int(k))


def grid2d(n: int, h: float, k: int) -> Grid2D:
    return Grid2D(int(n), float(h), int(k))


def _backend_names(fields: dict) -> dict:
    """``fields`` with the reference's backend names mapped to the port's
    ("pallas" → "kernel", "xla" → "torch")."""
    kw = dict(fields)
    for key, names in (("backend", FGC_BACKEND_NAMES),
                       ("sinkhorn_backend", SINKHORN_BACKEND_NAMES),
                       ("lowrank_backend", LOWRANK_BACKEND_NAMES)):
        if key in kw:
            kw[key] = names[kw[key]]
    return kw


def gw_config(fields: dict) -> GWConfig:
    """A port `GWConfig` from ``dataclasses.asdict`` of a reference one
    (every field, the gradient's ``grad_mode`` and ``implicit_*``
    included), or an `FGWConfig` when the fields hold ``theta``."""
    return (FGWConfig if "theta" in fields else GWConfig)(
        **_backend_names(fields))


def align_config(fields: dict) -> AlignConfig:
    """A port `AlignConfig` from ``dataclasses.asdict`` of a reference
    one."""
    return AlignConfig(**_backend_names(fields))


def ugw_config(fields: dict) -> UGWConfig:
    """A port `UGWConfig` from ``dataclasses.asdict`` of a reference one."""
    return UGWConfig(**_backend_names(fields))


def coot_config(fields: dict) -> COOTConfig:
    """A port `COOTConfig` from ``dataclasses.asdict`` of a reference
    one."""
    return COOTConfig(**_backend_names(fields))


def barycenter_config(fields: dict) -> BarycenterConfig:
    """A port `BarycenterConfig` from ``dataclasses.asdict`` of a reference
    one."""
    return BarycenterConfig(**_backend_names(fields))


def direction_bank(bank, device=None) -> torch.Tensor:
    """The reference's sliced-GW direction bank — the (d_max, n_proj)
    ``jax.random.normal(key, ...)`` draw of its ``_directions``, as an
    array — as the ``directions=`` tensor of `repro_torch.core.sliced_gw`
    and `sliced_plan` on ``device``.  PyTorch cannot redraw those bits, so
    a parity run carries them across."""
    return as_tensor(bank, resolve_device(device))


def solve_controls(eps, tol, eps_init, anneal_decay, inner_loosen, lr_gamma,
                   device=None) -> SolveControls:
    """`SolveControls` from the reference's six leaves: scalars, or (B,)
    arrays of a batch's stacked controls."""
    def f64(v):
        return np.asarray(v, np.float64)
    return SolveControls.make(f64(eps), f64(tol), f64(eps_init),
                              f64(anneal_decay), f64(inner_loosen),
                              f64(lr_gamma), device=resolve_device(device))


def low_rank_geometry(a, b, device=None) -> LowRankGeometry:
    """A `LowRankGeometry` from the reference's factors ``a``, ``b``."""
    dev = resolve_device(device)
    return LowRankGeometry(as_tensor(a, dev), as_tensor(b, dev))


def point_cloud_geometry(points, metric: str = "sqeuclidean",
                         device=None) -> PointCloudGeometry:
    """A `PointCloudGeometry` from the reference's points and metric."""
    return PointCloudGeometry(as_tensor(points, resolve_device(device)),
                              str(metric))


def low_rank_coupling(q, r, g, device=None) -> LowRankCoupling:
    """A `LowRankCoupling` from the reference's factors (q, r, g)."""
    dev = resolve_device(device)
    return LowRankCoupling(as_tensor(q, dev), as_tensor(r, dev),
                           as_tensor(g, dev))


def full_coupling(plan, f, g, device=None) -> FullCoupling:
    dev = resolve_device(device)
    return FullCoupling(as_tensor(plan, dev), as_tensor(f, dev),
                        as_tensor(g, dev))


def mirror_carry(s0, s1, s2, t, stage, inner, err, done, trace,
                 device=None, plan: str = "full") -> MirrorCarry:
    """A `MirrorCarry` from the reference carry's leaves: its state's three
    (``state.plan``, ``state.f``, ``state.g`` of a `FullCoupling`, or with
    ``plan="lowrank"`` ``state.q``, ``state.r``, ``state.g`` of a
    `LowRankCoupling`), then ``t``, ``stage``, ``inner``, ``err``, ``done``,
    ``trace``.  A batch's stacked carry (``t`` a (B,) array) gives the
    port's batch carry, one problem's carry one problem's."""
    dev = resolve_device(device)
    make = {"full": full_coupling, "lowrank": low_rank_coupling}[plan]
    state = make(s0, s1, s2, dev)
    err = torch.tensor(np.array(err, np.float64), device=dev)
    trace = torch.tensor(np.array(trace, np.float64), device=dev)
    if np.ndim(t) == 0:
        return MirrorCarry(state=state, t=int(t), stage=int(stage),
                           inner=int(inner), err=err, done=bool(done),
                           trace=trace)

    def ints(v):
        return tuple(int(x) for x in np.asarray(v))
    return MirrorCarry(state=state, t=ints(t), stage=ints(stage),
                       inner=ints(inner), err=err,
                       done=tuple(bool(x) for x in np.asarray(done)),
                       trace=trace)


def serve_config(fields: dict, device=None,
                 sliced_directions: dict | None = None) -> GWServeConfig:
    """A port `GWServeConfig` from ``dataclasses.asdict`` of a reference
    one: its nested solver config through `gw_config` (an `FGWConfig` when
    it holds ``theta``), the backend overrides' names mapped as there, and
    the port's own ``device``.  ``sliced_directions`` maps an embedding
    dimension d_max to the reference's (d_max, n_proj) direction bank
    (``jax.random.normal(PRNGKey(sliced_seed), (d_max, n_proj))``), so the
    sliced tier sees the reference's directions (`direction_bank`)."""
    kw = dict(fields)
    kw["solver"] = gw_config(kw["solver"])
    for key, names in (("sinkhorn_backend", SINKHORN_BACKEND_NAMES),
                       ("lowrank_backend", LOWRANK_BACKEND_NAMES)):
        if kw.get(key) is not None:
            kw[key] = names[kw[key]]
    if sliced_directions is not None:
        kw["sliced_directions"] = {int(d): direction_bank(bank, device)
                                   for d, bank in sliced_directions.items()}
    return GWServeConfig(**kw, device=device)


# ---------------------------------------------------------------------------
# language models
# ---------------------------------------------------------------------------

def model_config(fields: dict) -> ModelConfig:
    """A port `ModelConfig` from ``dataclasses.asdict`` of a reference
    one."""
    return ModelConfig(**fields)


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict/list/tuple tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def lm_params(tree, device=None) -> dict:
    """The state dict of a port `LM` from the reference's ``lm.init_params``
    tree (leaves as numpy arrays): the same names joined by dots, a
    ``scanned`` slot's leaves (stacked over repeats in the reference)
    split into one entry a repeat (``stack.scanned.slot<i>.<r>.…``).  A
    shared slot is kept once and a tied head is the embedding, as in the
    reference's tree."""
    dev = resolve_device(device)
    out = {}
    for path, leaf in _leaves(tree):
        arr = np.asarray(leaf)
        if path[:2] == ("stack", "scanned"):
            for r in range(arr.shape[0]):
                name = ".".join(path[:3] + (str(r),) + path[3:])
                out[name] = torch.tensor(arr[r], device=dev)
        else:
            out[".".join(path)] = torch.tensor(arr, device=dev)
    return out


def lm_model(tree, cfg: ModelConfig, device=None) -> LM:
    """A port `LM` holding the reference's parameters (`lm_params`); every
    parameter of the model must come from the tree and every leaf of the
    tree must land in the model."""
    model = LM(cfg, None, device="meta")
    model.load_state_dict(lm_params(tree, device), strict=True, assign=True)
    return model


def _cache(tree, dev, rep=None):
    def take(a):
        a = np.asarray(a)
        return a if rep is None else a[rep]
    out = {}
    for k, v in tree.items():
        if k == "length":
            out[k] = int(take(v))
        elif k == "carry":
            out[k] = tuple(torch.tensor(take(a), device=dev) for a in v)
        else:
            out[k] = torch.tensor(take(v), device=dev)
    return out


def lm_caches(tree, cfg: ModelConfig, device=None) -> dict:
    """The port's caches from the reference's ``lm.cache_init`` or
    ``prefill`` caches (leaves as numpy arrays): the body's caches,
    stacked over repeats in the reference, split into one dict a repeat;
    ``length`` a host int."""
    dev = resolve_device(device)
    return {"prologue": [_cache(c, dev) for c in tree["prologue"]],
            "body": [{f"slot{si}": _cache(tree["body"][f"slot{si}"], dev, r)
                      for si in range(len(cfg.block_template))}
                     for r in range(cfg.repeats)]}


def train_state(tree, cfg: ModelConfig, device=None):
    """A port `repro_torch.train.loop.TrainState` from the reference's
    ``train.loop.init_state`` tree (leaves as numpy arrays): the
    parameters through `lm_model`, the moments ``opt.m``, ``opt.v`` (and
    ``opt.ef``) split as `lm_params` splits the parameters, keyed by the
    model's parameter names, and the step counts as ints."""
    dev = resolve_device(device)
    opt = tree["opt"]
    return TrainState(
        model=lm_model(tree["params"], cfg, dev),
        opt=AdamWState(m=lm_params(opt["m"], dev), v=lm_params(opt["v"], dev),
                       step=int(np.asarray(opt["step"])),
                       ef=lm_params(opt["ef"], dev) if "ef" in opt else None),
        step=int(np.asarray(tree["step"])))
