"""Carry the reference's objects across to the port.

The reference (``repro``) holds no weights: what carries across is the
geometry (grids, low-rank factors, point clouds), the measures and the
solver state (dense or factored couplings).  Each function takes the
reference object's fields as plain Python values and numpy arrays (so this
module needs nothing of JAX) and returns the port's object on ``device``.
A solve begun in the reference can be resumed here: convert its
``MirrorCarry`` leaves with `mirror_carry` and hand the result to
`repro_torch.core.gw_plan_segment`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.coupling import FullCoupling, LowRankCoupling
from repro_torch.core.geometry import LowRankGeometry, PointCloudGeometry
from repro_torch.core.grids import Grid1D, Grid2D
from repro_torch.core.gw import GWConfig, as_tensor, resolve_device
from repro_torch.core.solver import MirrorCarry, SolveControls

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


def gw_config(fields: dict) -> GWConfig:
    """A port `GWConfig` from ``dataclasses.asdict`` of a reference one.

    Backend names are mapped ("pallas" → "kernel", "xla" → "torch").
    Fields of features the port does not have yet (reverse-mode gradients)
    are dropped: they do not act on a forward solve.
    """
    known = {f.name for f in dataclasses.fields(GWConfig)}
    kw = {k: v for k, v in fields.items() if k in known}
    for key, names in (("backend", FGC_BACKEND_NAMES),
                       ("sinkhorn_backend", SINKHORN_BACKEND_NAMES),
                       ("lowrank_backend", LOWRANK_BACKEND_NAMES)):
        if key in kw:
            kw[key] = names[kw[key]]
    return GWConfig(**kw)


def solve_controls(eps, tol, eps_init, anneal_decay, inner_loosen, lr_gamma,
                   device=None) -> SolveControls:
    """`SolveControls` from the reference's six scalars."""
    return SolveControls.make(float(eps), float(tol), float(eps_init),
                              float(anneal_decay), float(inner_loosen),
                              float(lr_gamma),
                              device=resolve_device(device))


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


def mirror_carry(plan, f, g, t, stage, inner, err, done, trace,
                 device=None) -> MirrorCarry:
    """A `MirrorCarry` over a `FullCoupling` from the reference carry's
    leaves (``state.plan``, ``state.f``, ``state.g``, then ``t``,
    ``stage``, ``inner``, ``err``, ``done``, ``trace``)."""
    dev = resolve_device(device)
    return MirrorCarry(state=full_coupling(plan, f, g, dev), t=int(t),
                       stage=int(stage), inner=int(inner),
                       err=torch.as_tensor(float(err), dtype=torch.float64,
                                           device=dev),
                       done=bool(done),
                       trace=torch.tensor(np.array(trace, np.float64),
                                          device=dev))
