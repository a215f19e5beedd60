"""Convergence-controlled mirror-descent loop (forward).

Reference: ``repro/core/solver.py`` (``SolveControls``, ``ConvergenceInfo``,
``MirrorCarry``, ``init_carry``, ``info_of``, ``resolve_controls``,
``mirror_descent_segment`` and ``mirror_descent``; the implicit
differentiation surface belongs to a later slice).

The reference's ``lax.while_loop`` is a host loop here, over B lanes at
once (a single problem is one lane): every outer step runs on every lane,
and a lane that has converged or reached its segment's end keeps its state
(a select, as the reference's vmapped loop masks its carry).

  * **Early stopping** — a lane stops when its annealing is done and its
    plan's L1 change and inner residual are both ≤ its ``tol``.  A lane
    with ``tol=0`` runs exactly ``outer_cap`` steps (the paper's fixed
    mode).  When no lane has ``tol>0`` the loop never reads the device
    inside the outer loop; otherwise it reads every lane's flags once per
    outer step, in one read.
  * **ε-annealing** — step ``t`` of a lane's schedule runs at
    ``max(eps, eps_init · decay^t)``, with warm-started potentials.  The
    schedule is evaluated on the host in Python floats, from the lanes'
    controls read once a call (`SolveControls.lanes_on_host`).
  * **Annealing stage clock** — each lane's schedule is read at its
    carried ``stage``, which holds (up to ``outer_cap // 2`` steps in all)
    while the inner solve is capped out mid-ramp, exactly as in the
    reference.
  * **Resumability** — ``MirrorCarry`` is the loop's whole state and every
    schedule quantity is a function of its counters, so segments of k
    steps reproduce one uninterrupted run bit for bit.

The value knobs live in ``SolveControls`` as float64 tensors, 0-d for one
problem or (B,) for B lanes.  Counters are host integers (tuples of them
for lanes): the host runs the loop.
"""
from __future__ import annotations

import dataclasses

import torch

_CTL = torch.float64


@dataclasses.dataclass(frozen=True)
class SolveControls:
    """Solve knobs: float64 tensors, 0-d (one problem) or (B,) (one value a
    lane; `repro_torch.core.gw.stack_controls`).  ``tol=0`` disables early
    stopping; ``eps_init <= eps`` disables annealing.

    The schedule (`eps_at`, `anneal_done`, `inner_tol_at`) is evaluated on
    the host in Python floats, for one problem's controls or one lane's
    (`lanes_on_host`): a lane's ε is then the same whatever lanes ride with
    it (a vectorised pow may round otherwise than a scalar one)."""

    eps: torch.Tensor | float
    tol: torch.Tensor | float
    eps_init: torch.Tensor | float
    anneal_decay: torch.Tensor | float
    inner_loosen: torch.Tensor | float
    lr_gamma: torch.Tensor | float   # factored-plan mirror step size γ

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

    def lanes_on_host(self, lanes: int) -> list["SolveControls"]:
        """Each of ``lanes`` lanes' controls as Python floats, in one read
        of the device (0-d controls are every lane's)."""
        dev = self.eps.device
        rows = torch.stack([torch.as_tensor(v, dtype=_CTL, device=dev)
                            .reshape(-1).expand(lanes)
                            for v in dataclasses.astuple(self)]).tolist()
        return [SolveControls(*(row[b] for row in rows))
                for b in range(lanes)]

    def _ramp(self, t: int) -> float:
        return float(self.eps_init) * float(self.anneal_decay) ** float(t)

    def eps_at(self, t: int) -> float:
        """Annealed ε for outer step ``t``: max(eps, eps_init · decay^t)."""
        return max(float(self.eps), self._ramp(t))

    def anneal_done(self, t: int) -> bool:
        """True once step ``t`` runs at the target ε."""
        return self._ramp(t) <= float(self.eps)

    def inner_tol_at(self, t: int) -> float:
        """Inner tolerance for step ``t``: ``tol · (eps_t/eps)`` scaled by
        ``inner_loosen`` while the schedule ramps, exactly ``tol`` after."""
        ratio = self.eps_at(t) / float(self.eps)
        return float(self.tol) * (1.0 + float(self.inner_loosen)
                                  * (ratio - 1.0))


@dataclasses.dataclass
class ConvergenceInfo:
    """What a solve actually did (for lanes: a tuple of counts, a (B,)
    residual and a (B, outer_cap) trace)."""

    outer_iters: int          # outer mirror-descent steps executed
    inner_iters: int          # total inner (Sinkhorn) iterations
    marginal_err: torch.Tensor  # residual after the last executed step
    converged: bool           # tol reached before the cap (False at tol=0)
    err_trace: torch.Tensor   # (outer_cap,) residual per step; NaN past stop

    def lane(self, b: int) -> "ConvergenceInfo":
        """Lane ``b`` of a batch's info."""
        return ConvergenceInfo(self.outer_iters[b], self.inner_iters[b],
                               self.marginal_err[b], self.converged[b],
                               self.err_trace[b])


@dataclasses.dataclass
class MirrorCarry:
    """The outer loop's complete resumable state.  One problem's carry has
    int counters, a bool and a 0-d residual; a batch's carry has a tuple of
    them a lane, (B,) residuals, a (B, outer_cap) trace and a lane-leading
    state."""

    state: object             # solver state (a Coupling for GW)
    t: int                    # outer steps executed so far
    stage: int                # annealing-schedule position (≤ t)
    inner: int                # total inner iterations so far
    err: torch.Tensor         # residual after the last executed step
    done: bool                # converged (never set under tol=0)
    trace: torch.Tensor       # (outer_cap,) per-step residual; NaN past t

    @property
    def lanes(self) -> int | None:
        """The lane count of a batch's carry, None for one problem's."""
        return len(self.t) if isinstance(self.t, tuple) else None

    def lane(self, b: int) -> "MirrorCarry":
        """Lane ``b`` of a batch's carry, as one problem's carry."""
        return MirrorCarry(self.state.lane(b), self.t[b], self.stage[b],
                           self.inner[b], self.err[b], self.done[b],
                           self.trace[b])

    @classmethod
    def stack(cls, carries) -> "MirrorCarry":
        """One problems' carries as a batch's carry."""
        s0 = carries[0].state
        return cls(type(s0).stack([c.state for c in carries]),
                   tuple(c.t for c in carries),
                   tuple(c.stage for c in carries),
                   tuple(c.inner for c in carries),
                   torch.stack([c.err for c in carries]),
                   tuple(c.done for c in carries),
                   torch.stack([c.trace for c in carries]))


def init_carry(state0, outer_cap: int, device=None,
               lanes: int | None = None) -> MirrorCarry:
    """A fresh carry: no steps taken, trace all-NaN, not converged; for a
    batch's lane-leading ``state0`` give its ``lanes``."""
    if lanes is None:
        return MirrorCarry(state=state0, t=0, stage=0, inner=0,
                           err=torch.tensor(torch.inf, dtype=_CTL,
                                            device=device),
                           done=False,
                           trace=torch.full((outer_cap,), torch.nan,
                                            dtype=_CTL, device=device))
    zeros = (0,) * lanes
    return MirrorCarry(state=state0, t=zeros, stage=zeros, inner=zeros,
                       err=torch.full((lanes,), torch.inf, dtype=_CTL,
                                      device=device),
                       done=(False,) * lanes,
                       trace=torch.full((lanes, outer_cap), torch.nan,
                                        dtype=_CTL, device=device))


def info_of(carry: MirrorCarry) -> ConvergenceInfo:
    return ConvergenceInfo(outer_iters=carry.t, inner_iters=carry.inner,
                           marginal_err=carry.err, converged=carry.done,
                           err_trace=carry.trace)


def resolve_controls(cfg, controls: SolveControls | None = None,
                     device=None) -> SolveControls:
    """Controls built from ``cfg`` on ``device`` unless given explicitly."""
    return SolveControls.from_config(cfg, device) if controls is None \
        else controls


def _lift_carry(carry: MirrorCarry) -> MirrorCarry:
    """One problem's carry as a batch of one."""
    st = carry.state
    return MirrorCarry(type(st).stack([st]), (carry.t,), (carry.stage,),
                       (carry.inner,), carry.err.reshape(1), (carry.done,),
                       carry.trace[None])


def mirror_descent_segment(step_fn, delta_fn, controls: SolveControls,
                           outer_cap: int, carry: MirrorCarry,
                           segment: int | None = None) -> MirrorCarry:
    """Advance every lane of a solve by at most ``segment`` outer steps
    (all remaining steps when None) and return the new carry; one
    problem's carry is run as a batch of one and comes back as it went in.

    ``step_fn(state, eps_t, inner_tol) -> (new_state, err, inner_iters)``
    runs one mirror-descent step on every lane (a lane-leading state, (B,)
    float64 ε and inner tolerances; (B,) residuals and a list of inner
    counts back); ``delta_fn(new, old)`` measures each lane's plan L1
    movement.  Convergence of a lane: its annealing done AND movement ≤ tol
    AND inner residual ≤ tol, only when its tol > 0.  A lane's stage holds
    while its inner solve misses its stage tolerance mid-ramp, bounded by
    ``outer_cap // 2`` holds over its whole solve.  A lane stops at its
    own segment end ``t + segment``.
    """
    if carry.lanes is None:
        return mirror_descent_segment(step_fn, delta_fn, controls,
                                      outer_cap, _lift_carry(carry),
                                      segment).lane(0)
    lanes = carry.lanes
    ctl = controls.lanes_on_host(lanes)
    t_end = [outer_cap if segment is None else min(outer_cap, t + segment)
             for t in carry.t]
    dwell_cap = max(outer_cap // 2, 1)
    gated = any(c.tol > 0.0 for c in ctl)
    t, stage = list(carry.t), list(carry.stage)
    inner, done = list(carry.inner), list(carry.done)
    state, err, trace = carry.state, carry.err, carry.trace
    dev = err.device
    while True:
        active = [not done[b] and t[b] < t_end[b] for b in range(lanes)]
        if not any(active):
            break
        eps_t = [c.eps_at(s) for c, s in zip(ctl, stage)]
        itol = [c.inner_tol_at(s) for c, s in zip(ctl, stage)]
        sched = torch.tensor([eps_t, itol], dtype=_CTL, device=dev)
        new_state, step_err, used = step_fn(state, sched[0], sched[1])
        step_err = step_err.to(_CTL)
        conv = hold = [False] * lanes
        if gated:
            # one device read per outer step, for all lanes
            moved, fit = torch.stack([delta_fn(new_state, state).to(_CTL),
                                      step_err]).tolist()
            annealed = [c.anneal_done(s) for c, s in zip(ctl, stage)]
            conv = [c.tol > 0.0 and a and dm <= c.tol and e <= c.tol
                    for c, a, dm, e in zip(ctl, annealed, moved, fit)]
            hold = [c.tol > 0.0 and not a and e > it
                    and (tb - sb) < dwell_cap
                    for c, a, e, it, tb, sb in zip(ctl, annealed, fit, itol,
                                                   t, stage)]
        rows = [b for b in range(lanes) if active[b]]
        if len(rows) == lanes:
            state, err = new_state, step_err
        else:
            live = torch.tensor(active, device=dev)
            state = new_state.select(live, state)
            err = torch.where(live, step_err, err)
        idx = torch.tensor(rows, device=dev)
        trace = trace.index_put((idx, torch.tensor([t[b] for b in rows],
                                                   device=dev)),
                                step_err[idx])
        for b in rows:
            stage[b] += 0 if hold[b] else 1
            t[b] += 1
            inner[b] += used[b]
            done[b] = conv[b]
    return MirrorCarry(state=state, t=tuple(t), stage=tuple(stage),
                       inner=tuple(inner), err=err, done=tuple(done),
                       trace=trace)


def mirror_descent(step_fn, state0, delta_fn, controls: SolveControls,
                   outer_cap: int, lanes: int | None = None):
    """Run ``step_fn`` to convergence (or to ``outer_cap``) from one
    problem's ``state0``, or from a batch's lane-leading one with its
    ``lanes``.  Returns ``(final_state, ConvergenceInfo)``."""
    carry = mirror_descent_segment(
        step_fn, delta_fn, controls, outer_cap,
        init_carry(state0, outer_cap, controls.eps.device, lanes))
    return carry.state, info_of(carry)
