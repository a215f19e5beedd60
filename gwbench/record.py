"""What a run's window hands the harness and the per-layer metrics."""
from __future__ import annotations

import dataclasses

from gwbench.trace import Summary


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads (``metrics/<name>.py``: ``read(ctx)``).

    kind      the driver kind ("closed_solve" or "serve")
    trace     the traced stretch's `Summary`, None without ``--trace 1``
    peaks     the card's published peaks (`gwbench.peaks`), None where the
              table lacks the card or the run is on the CPU
    profiled  of the traced stretch: "solves" (whole solves in it),
              "work" {stage: `gwbench.work.Work`}, "half_steps" and "fgc"
              (the B1/B2 and B3 work in it)
    window    of the whole window: "seconds", "answers", "stats" (the
              engine's counters at the last answer in the window),
              "served" (the counted `Work` of the answered requests)
    """

    kind: str
    trace: Summary | None = None
    peaks: dict | None = None
    profiled: dict = dataclasses.field(default_factory=dict)
    window: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    """A closed window: the end-to-end readings by metric name, the work
    attempted and failed, the allocator's peak, the metrics' context, and
    the host clock (`time.perf_counter`) when the window opened."""

    e2e: dict[str, float]
    attempted: int
    failed: int
    peak_bytes: int
    ctx: Context
    opened: float
