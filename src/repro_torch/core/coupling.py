"""Plan representations: the `Coupling` interface behind a GW solve.

Reference: ``repro/core/coupling.py`` (``Coupling``, ``FullCoupling``,
``coupling_delta`` and ``full_init``; the factored plan belongs to a later
slice).

``FullCoupling`` is the dense plan Γ (M, N) plus the log-domain Sinkhorn
potentials (f, g) warm-started across outer steps — the paper's setting.
``coupling_delta`` is the outer loop's movement metric: the L1 plan change.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import sinkhorn as sk


class Coupling:
    """Interface: what the solver stack needs from a plan representation."""

    def delta(self, other: "Coupling"):
        """L1-style movement between two iterates (the outer loop's delta_fn)."""
        raise NotImplementedError

    def dense(self):
        """The explicit (M, N) plan."""
        raise NotImplementedError

    def marginals(self):
        """(P 1_N, Pᵀ 1_M)."""
        raise NotImplementedError


@dataclasses.dataclass
class FullCoupling(Coupling):
    """Dense plan + warm-started log-domain Sinkhorn potentials."""

    plan: torch.Tensor       # (M, N)
    f: torch.Tensor          # (M,) row potential (−inf on zero-mass atoms)
    g: torch.Tensor          # (N,) column potential

    def delta(self, other: "FullCoupling"):
        return (self.plan - other.plan).abs().sum()

    def dense(self):
        return self.plan

    def marginals(self):
        return self.plan.sum(dim=1), self.plan.sum(dim=0)


def coupling_delta(new: Coupling, old: Coupling):
    """The outer loop's delta_fn for coupling-valued solver states."""
    return new.delta(old)


def full_init(mu, nu, gamma0=None, f0=None, g0=None) -> FullCoupling:
    """Cold start for the dense representation: product-coupling plan,
    zero-mass-aware potentials."""
    f, g = sk.zero_mass_potentials(mu, nu)
    return FullCoupling(mu[:, None] * nu[None, :] if gamma0 is None
                        else gamma0,
                        f if f0 is None else f0, g if g0 is None else g0)
