"""FGW sequence-alignment losses: the paper's technique as a training loss.

Reference: ``repro/core/losses.py`` (``AlignConfig``, ``_fgw_config``,
``_feature_cost``, ``_seq_problem``, ``fgw_alignment_loss``,
``fgw_alignment_loss_batch`` and ``fgw_patch_alignment_loss``).

Token positions form a uniform 1D grid and ViT patches a uniform 2D grid,
so the FGC structure holds exactly for sequence and patch alignment: the
quadratic term is positional distortion with d(i, j) = |i − j|^k and the
linear term compares hidden states.  The losses return the FGW value, whose
gradient reaches the hidden states through the feature cost by the implicit
surface (`repro_torch.core.solver.fixed_point_value`): ``grad_mode``
"envelope" holds the plan constant, "implicit" adds its response.

Every loss runs on the card unless ``device`` says otherwise; the hidden
states' dtype is the solve's.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.fgw import FGWConfig, entropic_fgw
from repro_torch.core.grids import Grid1D, Grid2D
from repro_torch.core.gw import entropic_gw_batch


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    theta: float = 0.5
    eps: float = 5e-2
    outer_iters: int = 5
    sinkhorn_iters: int = 50
    k: int = 1
    backend: str = "cumsum"
    #: "implicit" (IFT-corrected) or "envelope" (plan held constant)
    grad_mode: str = "implicit"
    #: the Neumann series' length for the implicit correction
    implicit_solve_iters: int = 60
    #: carried for the reference's fields; like the reference's
    #: ``_fgw_config``, `_fgw_config` does not forward them, so the losses
    #: solve on the full plan (ROADMAP §C)
    plan: str = "full"
    plan_rank: int = 8
    lr_gamma: float = 5.0
    #: kernel knobs, forwarded to the solver config
    sinkhorn_backend: str = "auto"
    lowrank_backend: str = "auto"
    cost_dtype: str = "f32"


def _fgw_config(cfg: AlignConfig) -> FGWConfig:
    return FGWConfig(eps=cfg.eps, outer_iters=cfg.outer_iters,
                     sinkhorn_iters=cfg.sinkhorn_iters, backend=cfg.backend,
                     theta=cfg.theta, grad_mode=cfg.grad_mode,
                     implicit_solve_iters=cfg.implicit_solve_iters,
                     sinkhorn_backend=cfg.sinkhorn_backend,
                     cost_dtype=cfg.cost_dtype)


def _feature_cost(h_src, h_tgt):
    """Pairwise L2 feature distance (fgw squares it); matching feature
    dims."""
    sq = ((h_src ** 2).sum(dim=-1)[:, None]
          + (h_tgt ** 2).sum(dim=-1)[None, :] - 2.0 * h_src @ h_tgt.T)
    return torch.sqrt(torch.clamp_min(sq, 1e-12))


def _uniform(n: int, like):
    return torch.full((n,), 1.0 / n, dtype=like.dtype, device=like.device)


def _seq_problem(h_src, h_tgt, cfg: AlignConfig, feature_cost):
    s, t = h_src.shape[0], h_tgt.shape[0]
    gx = Grid1D(s, h=1.0 / max(s - 1, 1), k=cfg.k)
    gy = Grid1D(t, h=1.0 / max(t - 1, 1), k=cfg.k)
    if feature_cost is None:
        feature_cost = (_feature_cost(h_src, h_tgt) if cfg.theta < 1.0
                        else torch.zeros((s, t), dtype=h_src.dtype,
                                         device=h_src.device))
    return gx, gy, _uniform(s, h_src), _uniform(t, h_tgt), feature_cost


def fgw_alignment_loss(h_src, h_tgt, cfg: AlignConfig = AlignConfig(),
                       feature_cost=None, device=None):
    """FGW(seq_src, seq_tgt) with positions as structure: (S, d), (T, d')
    → scalar.  If the feature dims differ, pass ``feature_cost`` or use
    θ = 1 (pure GW, dimension-agnostic).  Differentiable in the hidden
    states through the feature cost."""
    gx, gy, mu, nu, feature_cost = _seq_problem(h_src, h_tgt, cfg,
                                                feature_cost)
    return entropic_fgw(gx, gy, feature_cost, mu, nu, _fgw_config(cfg),
                        device=device).value


def fgw_alignment_loss_batch(h_srcs, h_tgts, cfg: AlignConfig = AlignConfig(),
                             device=None):
    """Mean FGW alignment loss over sequence pairs in ONE batched solve:
    ``h_srcs`` a (B, S, d) tensor or B ragged (S_b, d) tensors, ``h_tgts``
    likewise.  One `entropic_gw_batch` call: every lane rides one solve and
    the batch back-propagates through one implicit backward pass."""
    problems, features = [], []
    for h_s, h_t in zip(h_srcs, h_tgts):
        gx, gy, mu, nu, fc = _seq_problem(h_s, h_t, cfg, None)
        problems.append((gx, gy, mu, nu))
        features.append(fc)
    results = entropic_gw_batch(problems, _fgw_config(cfg),
                                features=features, device=device)
    return torch.stack([r.value for r in results]).mean()


def fgw_patch_alignment_loss(h_src, h_tgt, grid_n: int,
                             cfg: AlignConfig = AlignConfig(),
                             feature_cost=None, device=None):
    """2D variant for ViT patch grids: h_* are (n², d) row-major patch
    embeddings."""
    n2 = grid_n * grid_n
    if h_src.shape[0] != n2 or h_tgt.shape[0] != n2:
        raise ValueError(f"patch embeddings of {h_src.shape[0]} and "
                         f"{h_tgt.shape[0]} rows for a {grid_n}² grid")
    grid = Grid2D(grid_n, h=1.0 / max(grid_n - 1, 1), k=cfg.k)
    mu = _uniform(n2, h_src)
    if feature_cost is None:
        feature_cost = (_feature_cost(h_src, h_tgt) if cfg.theta < 1.0
                        else torch.zeros((n2, n2), dtype=h_src.dtype,
                                         device=h_src.device))
    return entropic_fgw(grid, grid, feature_cost, mu, mu, _fgw_config(cfg),
                        device=device).value
