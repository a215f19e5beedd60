"""FGC-GW core, ported slice by slice from ``repro.core``.

Public API of this slice:
  fgc       — L/Lᵀ/|i−j|^p applies (scan|cumsum|blocked|dense|kernel)
  grids     — Grid1D / Grid2D + gw_product (D_X Γ D_Y)
  geometry  — Geometry, GridGeometry (FGC), LowRankGeometry,
              PointCloudGeometry, DenseGeometry, as_geometry
  gradient  — GradientOperator (dense plan) and LowRankGradientOperator
              (factored plan): constant term, gradients, energy; COOT's
              bilinear_product
  sinkhorn  — log/kernel-domain and unbalanced Sinkhorn (+ chunked early
              stopping), and the factored plan's Dykstra projection and
              mirror step
  coupling  — FullCoupling (dense plan + log potentials), LowRankCoupling
              (factors Q, R, g) and its cold starts
  solver    — the convergence-controlled mirror-descent loop, and the
              implicit differentiation surface (fixed_point_value)
  gw        — entropic_gw (dense or factored plan, differentiable) and
              entropic_gw_batch (many problems as lanes: padded, per-lane
              controls and stopping, FGW feature costs, segmented resume)
  fgw       — entropic_fgw (fused GW: a feature cost beside the structure)
  ugw       — entropic_ugw (unbalanced GW: KL marginal penalties, on the
              unbalanced Sinkhorn of `sinkhorn`)
  coot      — entropic_coot (co-optimal transport: sample and feature
              plans; grid-structured data through bilinear_product's FGC)
  barycenter — gw_barycenter (fixed-support GW barycenter)
  sliced    — sliced GW: the closed-form sorted estimate, the grid method
              on entropic_gw_batch, and the monotone plan that
              FullCoupling.from_sliced warm-starts from
  losses    — the FGW sequence and patch alignment losses
"""
from repro_torch.core import (barycenter, coot, coupling, fgc, fgw, geometry,
                              gradient, grids, gw, losses, sinkhorn, sliced,
                              solver, ugw)
from repro_torch.core.barycenter import BarycenterConfig, gw_barycenter
from repro_torch.core.coupling import (Coupling, FullCoupling,
                                       LowRankCoupling, coupling_delta,
                                       full_init, lowrank_init)
from repro_torch.core.geometry import (DenseGeometry, DenseStack, Geometry,
                                       GridGeometry, GridStack,
                                       LowRankGeometry, LowRankStack,
                                       PointCloudGeometry, PointCloudStack,
                                       StackedGeometry, as_geometry)
from repro_torch.core.fgw import (FGWConfig, entropic_fgw, fgw_energy,
                                  fgw_full_value, fgw_lr_step_fn,
                                  fgw_lr_value, fgw_step_fn)
from repro_torch.core.gradient import (GradientOperator,
                                       LowRankGradientOperator,
                                       bilinear_product)
from repro_torch.core.grids import Grid1D, Grid2D, gw_product, gw_product_dense
from repro_torch.core.gw import (GWConfig, GWResult, entropic_gw,
                                 entropic_gw_batch, gw_energy, gw_init_state,
                                 gw_lr_step_fn, gw_plan_segment,
                                 gw_plan_solve, gw_step_fn, implicit_spec,
                                 lowrank_descent, stack_controls,
                                 stack_problems)
from repro_torch.core.losses import (AlignConfig, fgw_alignment_loss,
                                     fgw_alignment_loss_batch,
                                     fgw_patch_alignment_loss)
from repro_torch.core.solver import (ConvergenceInfo, ImplicitSpec,
                                     MirrorCarry, SolveControls,
                                     fixed_point_value, info_of, init_carry,
                                     mirror_descent, mirror_descent_segment,
                                     plan_delta, resolve_controls)
from repro_torch.core.sliced import (SlicedEstimate, profile_distance,
                                     sliced_embedding, sliced_gw, sliced_plan,
                                     sliced_supported)
from repro_torch.core.ugw import UGWConfig, entropic_ugw

__all__ = [
    "barycenter", "coot", "coupling", "fgc", "fgw", "geometry", "gradient",
    "grids", "gw", "losses", "sinkhorn", "sliced", "solver", "ugw",
    "BarycenterConfig", "gw_barycenter",
    "Coupling", "FullCoupling", "LowRankCoupling", "coupling_delta",
    "full_init", "lowrank_init",
    "DenseGeometry", "DenseStack", "Geometry", "GridGeometry", "GridStack",
    "LowRankGeometry", "LowRankStack", "PointCloudGeometry",
    "PointCloudStack", "StackedGeometry", "as_geometry",
    "FGWConfig", "entropic_fgw", "fgw_energy", "fgw_full_value",
    "fgw_lr_step_fn", "fgw_lr_value", "fgw_step_fn",
    "GradientOperator", "LowRankGradientOperator", "bilinear_product",
    "Grid1D", "Grid2D", "gw_product", "gw_product_dense",
    "GWConfig", "GWResult", "entropic_gw", "entropic_gw_batch", "gw_energy",
    "gw_init_state", "gw_lr_step_fn", "gw_plan_segment", "gw_plan_solve",
    "gw_step_fn", "implicit_spec", "lowrank_descent", "stack_controls",
    "stack_problems",
    "AlignConfig", "fgw_alignment_loss", "fgw_alignment_loss_batch",
    "fgw_patch_alignment_loss",
    "ConvergenceInfo", "ImplicitSpec", "MirrorCarry", "SolveControls",
    "fixed_point_value", "info_of", "init_carry", "mirror_descent",
    "mirror_descent_segment", "plan_delta", "resolve_controls",
    "SlicedEstimate", "profile_distance", "sliced_embedding", "sliced_gw",
    "sliced_plan", "sliced_supported",
    "UGWConfig", "entropic_ugw",
]
