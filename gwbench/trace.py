"""The traced stretch of a run: `torch.profiler` over a few whole solves or
a few seconds of serving, reduced to what the per-layer metrics read.

`Stretch` profiles CPU and CUDA activities between two synchronisations
and keeps no chrome trace.  `reduce` turns the profile into a `Summary`:

  kernels    {device operation name: [device seconds, count]}
  busy_s     the union of every device operation's interval (kernels,
             copies, fills), in seconds
  window_s   the stretch's wall time on the host's clock, between the two
             synchronisations
  launches   the kernels among the device operations (copies and fills
             are not kernels)
  gaps       {what the host was doing: idle device seconds}: each interval
             in which no device operation ran is named after the innermost
             host span or operator running at its start
"""
from __future__ import annotations

import dataclasses
import time

import torch

NOT_KERNELS = ("Memcpy", "Memset")


@dataclasses.dataclass
class Summary:
    kernels: dict[str, list[float]]
    busy_s: float
    window_s: float
    launches: int
    gaps: dict[str, float]

    def device_seconds(self, fragments) -> float:
        """Device time of the operations whose name holds one of
        ``fragments``."""
        return sum(t for name, (t, _) in self.kernels.items()
                   if any(f in name for f in fragments))

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, t] for n, (t, _) in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


class Stretch:
    """``with Stretch(device) as st: ...`` profiles the body; ``st.summary``
    is its `Summary` (None until the body has run).  On the CPU it records
    host activity only, and the summary then has no device operation."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.summary: Summary | None = None
        self._prof = None
        self._t0 = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce(
                self._prof.profiler.kineto_results.events(), wall)
        self._prof = None
        return False


def _union(spans):
    """Merged intervals of ``spans`` (sorted by start)."""
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _rows(events):
    """(name, on the device, start ns, end ns) of the profiler's raw
    events (the kineto records: far cheaper to read than the event tree
    `profile.events` builds).  A host span's mirror on the device's
    timeline (a user annotation) is no device operation and is left
    out."""
    out = []
    for e in events:
        if e.device_type().name == "CUDA" and e.is_user_annotation():
            continue
        t0 = e.start_ns()
        out.append((e.name(), e.device_type().name == "CUDA", t0,
                    t0 + e.duration_ns()))
    return out


def reduce(events, wall_s: float) -> Summary:
    """A `Summary` of a profiler's raw events."""
    rows = _rows(events)
    dev = [r for r in rows if r[1]]
    kernels: dict[str, list[float]] = {}
    for name, _, a, b in dev:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += (b - a) * 1e-9
        row[1] += 1
    merged = _union(sorted((a, b) for _, _, a, b in dev))
    busy = sum(b - a for a, b in merged) * 1e-9
    launches = sum(1 for r in dev if not r[0].startswith(NOT_KERNELS))
    return Summary(kernels, busy, wall_s, launches,
                   _gaps(merged, sorted((r for r in rows if not r[1]),
                                        key=lambda r: r[2])))


def _gaps(merged, host) -> dict[str, float]:
    """Idle device seconds by the innermost host event running at each
    gap's start: of the host events started by then and not yet ended,
    the one that started last."""
    out: dict[str, float] = {}
    live, j = [], 0
    for (_, a), (b, _) in zip(merged, merged[1:]):
        while j < len(host) and host[j][2] <= a:
            live.append(host[j])
            j += 1
        while live and live[-1][3] < a:
            live.pop()
        name = live[-1][0] if live else "(no host event)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out
