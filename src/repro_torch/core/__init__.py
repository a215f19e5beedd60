"""FGC-GW core, ported slice by slice from ``repro.core``.

Public API of this slice:
  fgc       — L/Lᵀ/|i−j|^p applies (scan|cumsum|blocked|dense|kernel)
  grids     — Grid1D / Grid2D + gw_product (D_X Γ D_Y)
  geometry  — Geometry, GridGeometry (FGC), DenseGeometry, as_geometry
  gradient  — GradientOperator: product, constant term, gradient, energy
  sinkhorn  — log/kernel-domain Sinkhorn (+ chunked early stopping)
  coupling  — FullCoupling (dense plan + log potentials)
  solver    — the convergence-controlled mirror-descent loop
  gw        — entropic_gw (forward, dense plan)
"""
from repro_torch.core import (coupling, fgc, geometry, gradient, grids, gw,
                              sinkhorn, solver)
from repro_torch.core.coupling import (Coupling, FullCoupling,
                                       coupling_delta, full_init)
from repro_torch.core.geometry import (DenseGeometry, Geometry, GridGeometry,
                                       as_geometry)
from repro_torch.core.gradient import GradientOperator
from repro_torch.core.grids import Grid1D, Grid2D, gw_product, gw_product_dense
from repro_torch.core.gw import (GWConfig, GWResult, entropic_gw, gw_energy,
                                 gw_init_state, gw_plan_segment,
                                 gw_plan_solve, gw_step_fn)
from repro_torch.core.solver import (ConvergenceInfo, MirrorCarry,
                                     SolveControls, info_of, init_carry,
                                     mirror_descent, mirror_descent_segment,
                                     resolve_controls)

__all__ = [
    "coupling", "fgc", "geometry", "gradient", "grids", "gw", "sinkhorn",
    "solver",
    "Coupling", "FullCoupling", "coupling_delta", "full_init",
    "DenseGeometry", "Geometry", "GridGeometry", "as_geometry",
    "GradientOperator",
    "Grid1D", "Grid2D", "gw_product", "gw_product_dense",
    "GWConfig", "GWResult", "entropic_gw", "gw_energy", "gw_init_state",
    "gw_plan_segment", "gw_plan_solve", "gw_step_fn",
    "ConvergenceInfo", "MirrorCarry", "SolveControls", "info_of",
    "init_carry", "mirror_descent", "mirror_descent_segment",
    "resolve_controls",
]
