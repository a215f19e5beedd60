"""FGC-GW core, ported slice by slice from ``repro.core``.

Public API of this slice:
  fgc       — L/Lᵀ/|i−j|^p applies (scan|cumsum|blocked|dense|kernel)
  grids     — Grid1D / Grid2D + gw_product (D_X Γ D_Y)
  geometry  — Geometry, GridGeometry (FGC), LowRankGeometry,
              PointCloudGeometry, DenseGeometry, as_geometry
  gradient  — GradientOperator (dense plan) and LowRankGradientOperator
              (factored plan): constant term, gradients, energy
  sinkhorn  — log/kernel-domain Sinkhorn (+ chunked early stopping), and
              the factored plan's Dykstra projection and mirror step
  coupling  — FullCoupling (dense plan + log potentials), LowRankCoupling
              (factors Q, R, g) and its cold starts
  solver    — the convergence-controlled mirror-descent loop
  gw        — entropic_gw (forward, dense or factored plan) and
              entropic_gw_batch (many problems as lanes: padded, per-lane
              controls and stopping, segmented resume)
"""
from repro_torch.core import (coupling, fgc, geometry, gradient, grids, gw,
                              sinkhorn, solver)
from repro_torch.core.coupling import (Coupling, FullCoupling,
                                       LowRankCoupling, coupling_delta,
                                       full_init, lowrank_init)
from repro_torch.core.geometry import (DenseGeometry, DenseStack, Geometry,
                                       GridGeometry, GridStack,
                                       LowRankGeometry, LowRankStack,
                                       PointCloudGeometry, PointCloudStack,
                                       StackedGeometry, as_geometry)
from repro_torch.core.gradient import GradientOperator, LowRankGradientOperator
from repro_torch.core.grids import Grid1D, Grid2D, gw_product, gw_product_dense
from repro_torch.core.gw import (GWConfig, GWResult, entropic_gw,
                                 entropic_gw_batch, gw_energy, gw_init_state,
                                 gw_lr_step_fn, gw_plan_segment,
                                 gw_plan_solve, gw_step_fn, lowrank_descent,
                                 stack_controls, stack_problems)
from repro_torch.core.solver import (ConvergenceInfo, MirrorCarry,
                                     SolveControls, info_of, init_carry,
                                     mirror_descent, mirror_descent_segment,
                                     resolve_controls)

__all__ = [
    "coupling", "fgc", "geometry", "gradient", "grids", "gw", "sinkhorn",
    "solver",
    "Coupling", "FullCoupling", "LowRankCoupling", "coupling_delta",
    "full_init", "lowrank_init",
    "DenseGeometry", "DenseStack", "Geometry", "GridGeometry", "GridStack",
    "LowRankGeometry", "LowRankStack", "PointCloudGeometry",
    "PointCloudStack", "StackedGeometry", "as_geometry",
    "GradientOperator", "LowRankGradientOperator",
    "Grid1D", "Grid2D", "gw_product", "gw_product_dense",
    "GWConfig", "GWResult", "entropic_gw", "entropic_gw_batch", "gw_energy",
    "gw_init_state", "gw_lr_step_fn", "gw_plan_segment", "gw_plan_solve",
    "gw_step_fn", "lowrank_descent", "stack_controls", "stack_problems",
    "ConvergenceInfo", "MirrorCarry", "SolveControls", "info_of",
    "init_carry", "mirror_descent", "mirror_descent_segment",
    "resolve_controls",
]
