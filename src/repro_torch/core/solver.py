"""Convergence-controlled mirror-descent loop (forward).

Reference: ``repro/core/solver.py`` (``SolveControls``, ``ConvergenceInfo``,
``MirrorCarry``, ``init_carry``, ``info_of``, ``resolve_controls``,
``mirror_descent_segment`` and ``mirror_descent``; the implicit
differentiation surface belongs to a later slice).

The reference's ``lax.while_loop`` is a host loop here:

  * **Early stopping** — stop when annealing is done and the plan's L1
    change and the inner residual are both ≤ ``tol``.  ``tol=0`` runs
    exactly ``outer_cap`` steps (the paper's fixed mode) and then never
    synchronises with the device inside the outer loop; ``tol>0`` reads the
    step's flags back once per outer step.
  * **ε-annealing** — step ``t`` of the schedule runs at
    ``max(eps, eps_init · decay^t)``, with warm-started potentials.
  * **Annealing stage clock** — the schedule is read at the carried
    ``stage``, which holds (up to ``outer_cap // 2`` steps in all) while
    the inner solve is capped out mid-ramp, exactly as in the reference.
  * **Resumability** — ``MirrorCarry`` is the loop's whole state and every
    schedule quantity is a function of its counters, so segments of k
    steps reproduce one uninterrupted run bit for bit.

The value knobs live in ``SolveControls`` as 0-d float64 tensors on the
problem's device, so the schedule never needs a host round trip to reach a
kernel.  Counters are host integers: the host runs the loop.
"""
from __future__ import annotations

import dataclasses

import torch

_CTL = torch.float64


@dataclasses.dataclass(frozen=True)
class SolveControls:
    """Solve knobs as 0-d float64 tensors.  ``tol=0`` disables early
    stopping; ``eps_init <= eps`` disables annealing."""

    eps: torch.Tensor
    tol: torch.Tensor
    eps_init: torch.Tensor
    anneal_decay: torch.Tensor
    inner_loosen: torch.Tensor
    lr_gamma: torch.Tensor   # factored-plan mirror step size γ

    @classmethod
    def make(cls, eps, tol=0.0, eps_init=None, anneal_decay=0.5,
             inner_loosen=1.0, lr_gamma=30.0, device=None):
        def t(v):
            return torch.as_tensor(v, dtype=_CTL, device=device)
        return cls(eps=t(eps), tol=t(tol),
                   eps_init=t(eps if eps_init is None else eps_init),
                   anneal_decay=t(anneal_decay),
                   inner_loosen=t(inner_loosen), lr_gamma=t(lr_gamma))

    @classmethod
    def from_config(cls, cfg, device=None):
        return cls.make(cfg.eps, cfg.tol, cfg.eps_init, cfg.anneal_decay,
                        getattr(cfg, "inner_loosen", 1.0),
                        getattr(cfg, "lr_gamma", 30.0), device=device)

    def _ramp(self, t: int):
        return self.eps_init * self.anneal_decay ** torch.tensor(
            float(t), dtype=_CTL, device=self.eps.device)

    def eps_at(self, t: int):
        """Annealed ε for outer step ``t``: max(eps, eps_init · decay^t)."""
        return torch.maximum(self.eps, self._ramp(t))

    def anneal_done(self, t: int):
        """True once step ``t`` runs at the target ε."""
        return self._ramp(t) <= self.eps

    def inner_tol_at(self, t: int):
        """Inner tolerance for step ``t``: ``tol · (eps_t/eps)`` scaled by
        ``inner_loosen`` while the schedule ramps, exactly ``tol`` after."""
        ratio = self.eps_at(t) / self.eps
        return self.tol * (1.0 + self.inner_loosen * (ratio - 1.0))


@dataclasses.dataclass
class ConvergenceInfo:
    """What a solve actually did."""

    outer_iters: int          # outer mirror-descent steps executed
    inner_iters: int          # total inner (Sinkhorn) iterations
    marginal_err: torch.Tensor  # residual after the last executed step
    converged: bool           # tol reached before the cap (False at tol=0)
    err_trace: torch.Tensor   # (outer_cap,) residual per step; NaN past stop


@dataclasses.dataclass
class MirrorCarry:
    """The outer loop's complete resumable state."""

    state: object             # solver state (a Coupling for GW)
    t: int                    # outer steps executed so far
    stage: int                # annealing-schedule position (≤ t)
    inner: int                # total inner iterations so far
    err: torch.Tensor         # residual after the last executed step
    done: bool                # converged (never set under tol=0)
    trace: torch.Tensor       # (outer_cap,) per-step residual; NaN past t


def init_carry(state0, outer_cap: int, device=None) -> MirrorCarry:
    """A fresh carry: no steps taken, trace all-NaN, not converged."""
    return MirrorCarry(state=state0, t=0, stage=0, inner=0,
                       err=torch.tensor(torch.inf, dtype=_CTL,
                                        device=device),
                       done=False,
                       trace=torch.full((outer_cap,), torch.nan, dtype=_CTL,
                                        device=device))


def info_of(carry: MirrorCarry) -> ConvergenceInfo:
    return ConvergenceInfo(outer_iters=carry.t, inner_iters=carry.inner,
                           marginal_err=carry.err, converged=carry.done,
                           err_trace=carry.trace)


def resolve_controls(cfg, controls: SolveControls | None = None,
                     device=None) -> SolveControls:
    """Controls built from ``cfg`` on ``device`` unless given explicitly."""
    return SolveControls.from_config(cfg, device) if controls is None \
        else controls


def mirror_descent_segment(step_fn, delta_fn, controls: SolveControls,
                           outer_cap: int, carry: MirrorCarry,
                           segment: int | None = None) -> MirrorCarry:
    """Advance a solve by at most ``segment`` outer steps (all remaining
    steps when None) and return the new carry.

    ``step_fn(state, eps_t, inner_tol) -> (new_state, err, inner_iters)``
    runs one mirror-descent step; ``delta_fn(new, old)`` measures the plan's
    L1 movement.  Convergence: annealing done AND movement ≤ tol AND inner
    residual ≤ tol, only when tol > 0.  The stage holds while the inner
    solve misses its stage tolerance mid-ramp, bounded by
    ``outer_cap // 2`` holds over the whole solve.
    """
    t_end = outer_cap if segment is None else min(outer_cap,
                                                  carry.t + segment)
    dwell_cap = max(outer_cap // 2, 1)
    gated = bool(controls.tol > 0.0)
    while carry.t < t_end and not carry.done:
        inner_tol = controls.inner_tol_at(carry.stage)
        new_state, step_err, used = step_fn(
            carry.state, controls.eps_at(carry.stage), inner_tol)
        conv = hold = False
        if gated:
            # one device read per outer step
            annealed, moved, fits, capped = torch.stack([
                controls.anneal_done(carry.stage),
                delta_fn(new_state, carry.state) <= controls.tol,
                step_err <= controls.tol,
                step_err > inner_tol]).tolist()
            conv = annealed and moved and fits
            hold = (not annealed and capped
                    and (carry.t - carry.stage) < dwell_cap)
        trace = carry.trace.clone()
        trace[carry.t] = step_err
        carry = MirrorCarry(state=new_state, t=carry.t + 1,
                            stage=carry.stage + (0 if hold else 1),
                            inner=carry.inner + used,
                            err=step_err.to(carry.err.dtype), done=conv,
                            trace=trace)
    return carry


def mirror_descent(step_fn, state0, delta_fn, controls: SolveControls,
                   outer_cap: int):
    """Run ``step_fn`` to convergence (or to ``outer_cap``).  Returns
    ``(final_state, ConvergenceInfo)``."""
    carry = mirror_descent_segment(
        step_fn, delta_fn, controls, outer_cap,
        init_carry(state0, outer_cap, controls.eps.device))
    return carry.state, info_of(carry)
