"""Convergence-controlled mirror-descent loop, and the implicit
differentiation surface around it.

Reference: ``repro/core/solver.py`` (``SolveControls``, ``ConvergenceInfo``,
``MirrorCarry``, ``init_carry``, ``info_of``, ``resolve_controls``,
``plan_delta``, ``mirror_descent_segment``, ``mirror_descent``,
``ImplicitSpec`` and ``fixed_point_value``).

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

Reverse-mode differentiation is not a loop mode: `fixed_point_value` wraps
a solve in a `torch.autograd.Function` whose backward pass is built from
the converged state alone — the envelope gradient of the objective plus
an implicit (fixed-point) correction from ONE differentiable mirror step
at the solution.  The forward may run any backend, kernels included; the
backward replays only the one-step map, so its memory is O(1) in the
iteration counts.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch
from torch.autograd.function import once_differentiable

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
                            for v in fields_of(self)]).tolist()
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


def fields_of(obj) -> tuple:
    """A dataclass's field values, shallow: ``dataclasses.astuple`` deep
    copies every tensor (and refuses one inside an autograd graph)."""
    return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))


def plan_delta(new_state, old_state):
    """L1 change of the transport plan between outer steps, for states whose
    first element is the plan (one value a lane for lane-leading plans)."""
    return (new_state[0] - old_state[0]).abs().sum(dim=(-2, -1))


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


# ---------------------------------------------------------------------------
# The implicit-differentiation surface.
#
# By the envelope / Danskin argument the derivative of the entropic value
# depends only on the converged plan, and the residual sensitivity comes
# from the implicit function theorem at the mirror-descent fixed point
# s* = T(s*, θ).  For any downstream F(s*, θ),
#
#   dF/dθ = ∂θF + (∂θT)ᵀ u,     u = (I − ∂sTᵀ)⁻¹ w,     w = ∂sF-cotangent,
#
# with u the Neumann series Σₖ (∂sTᵀ)ᵏ w: each term is one VJP of the
# one-step map at the converged state.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImplicitSpec:
    """One differentiable fixed-point problem, as callables over a batch's
    lane-leading ``inputs`` (a tuple of tensors, geometries and None) and
    ``controls``:

    - ``solve(inputs, controls) -> (state, info, value)``: the full solve,
      any backend, kernels included, and its (B,) objective (the reference
      splits the value into a ``value`` callable; one call here lets the
      forward reuse its constant term, as XLA's common-subexpression pass
      lets the reference's).  Run without a graph.
    - ``step(state, inputs, controls) -> state``: ONE differentiable
      application of the fixed-point map T̃ (plain PyTorch ops),
      (approximately) idempotent at a converged state.
    - ``value_bwd(state, inputs, controls) -> (B,)``: the gradient-correct
      objective the backward pass differentiates.
    - ``grad_mode``: ``"implicit"`` (envelope + Neumann correction) or
      ``"envelope"`` (the Danskin term only).
    - ``solve_iters`` / ``solve_tol``: the Neumann series' cap and its
      per-lane stop on the L1 norm of the latest term.
    """

    solve: Callable
    step: Callable
    value_bwd: Callable
    grad_mode: str = "implicit"
    solve_iters: int = 30
    solve_tol: float = 1e-10


def tensor_leaves(tree) -> list:
    """The tensors of a tree of tuples and dataclasses, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in tensor_leaves(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensor_leaves(getattr(tree, f.name))]
    return []


class _Slot:
    """Where a tensor was, in a `_skeleton`."""


def with_leaves(tree, leaves):
    """``tree`` with its tensors (or a skeleton's slots) replaced, in
    `tensor_leaves` order, by the items of the iterator ``leaves``."""
    if isinstance(tree, (torch.Tensor, _Slot)):
        return next(leaves)
    if isinstance(tree, tuple):
        return tuple(with_leaves(x, leaves) for x in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: with_leaves(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    return tree


def _skeleton(tree):
    """``tree`` with a slot in place of each tensor: what a backward pass
    keeps to rebuild it from saved tensors, without holding them."""
    return with_leaves(tree, itertools.repeat(_Slot()))


def _lane_l1(ts):
    """Each lane's L1 mass over lane-leading tensors."""
    return sum(t.abs().reshape(t.shape[0], -1).sum(dim=1) for t in ts)


def neumann_series(vjp, w, iters: int, tol: float):
    """u = Σₖ (∂sT̃ᵀ)ᵏ w over lanes, with ``vjp(term)`` one application of
    ∂sT̃ᵀ to a list of lane-leading tensors.  A lane stops, keeping its
    term and sum, once its term's L1 mass is ≤ ``tol`` or after ``iters``
    terms, as the reference's vmapped while_loop masks it; so a lane's
    series is the one it has alone.  Returns (u, terms per lane)."""
    term, acc = list(w), list(w)
    live = _lane_l1(term) > tol
    terms = torch.zeros_like(live, dtype=torch.int64)
    for _ in range(iters):
        if not bool(live.any()):
            break
        new = vjp(term)

        def keep(n, o):
            return torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)),
                               n, o)
        acc = [keep(a + n, a) for a, n in zip(acc, new)]
        term = [keep(n, t) for n, t in zip(new, term)]
        terms += live
        live = live & (_lane_l1(term) > tol)
    return acc, terms.tolist()


def _grads(outs, wrt, cts, retain: bool = False):
    """torch.autograd.grad with zeros where an input is unused."""
    got = torch.autograd.grad(outs, wrt, cts, retain_graph=retain,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, wrt)]


class _FixedPoint(torch.autograd.Function):
    """`fixed_point_value` with inputs that require grad.  ``leaves`` are
    the tensors of ``(inputs, controls)`` (autograd follows top-level
    tensor arguments only); ``tree`` rebuilds them.  Returns the value,
    the state's tensors and the info's tensors (not differentiable)."""

    @staticmethod
    def forward(ctx, spec, tree, out, *leaves):
        inputs, controls = with_leaves(tree, iter(leaves))
        state, info, value = spec.solve(inputs, controls)
        states, infos = tensor_leaves(state), tensor_leaves(info)
        out["state"], out["info"] = _skeleton(state), _skeleton(info)
        ctx.spec, ctx.tree, ctx.state = spec, tree, out["state"]
        ctx.save_for_backward(*leaves, *states)
        ctx.mark_non_differentiable(*infos)
        return (value, *states, *infos)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_value, *cts):
        spec = ctx.spec
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        n_in = len(need)
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(nd)
                  for t, nd in zip(saved[:n_in], need)]
            ss = [t.detach().requires_grad_() for t in saved[n_in:]]
            inputs, controls = with_leaves(ctx.tree, iter(xs))
            state = with_leaves(ctx.state, iter(ss))
            wrt = [x for x in xs if x.requires_grad]
            dv = _grads(spec.value_bwd(state, inputs, controls), ss + wrt,
                        ct_value)
            dv_s, dv_x = dv[:len(ss)], dv[len(ss):]
            if spec.grad_mode == "implicit":
                # the cotangent entering the fixed point: the value's plus
                # any direct one on the returned state (a loss reading the
                # plan); one graph of T̃ serves every term
                w = [a + b for a, b in zip(dv_s, cts[:len(ss)])]
                outs = tensor_leaves(spec.step(state, inputs, controls))
                u, _ = neumann_series(
                    lambda term: _grads(outs, ss, term, retain=True), w,
                    spec.solve_iters, spec.solve_tol)
                dv_x = [a + b for a, b in zip(dv_x, _grads(outs, wrt, u))]
        grads = iter(dv_x)
        return (None, None, None) + tuple(next(grads) if nd else None
                                          for nd in need)


def fixed_point_value(spec: ImplicitSpec, inputs, controls):
    """Solve the fixed point described by ``spec`` and return ``(value,
    state, info)``, reverse-mode differentiable in the tensors of
    ``inputs`` and ``controls`` through the implicit backward pass,
    whatever backend ``spec.solve`` runs.

    When no input requires grad (or grad mode is off) this is exactly
    ``spec.solve``; with one, the same call runs inside a
    `torch.autograd.Function` without a graph, and gives the same bits.
    """
    leaves = tensor_leaves((inputs, controls))
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in leaves)):
        state, info, value = spec.solve(inputs, controls)
        return value, state, info
    out = {}
    res = _FixedPoint.apply(spec, _skeleton((inputs, controls)), out,
                            *leaves)
    rest = iter(res[1:])
    state = with_leaves(out["state"], rest)
    return res[0], state, with_leaves(out["info"], rest)
