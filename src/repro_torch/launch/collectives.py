"""Collective ops and their wire bytes, read from a ``torch.profiler``
trace.

Reference: ``repro/launch/collectives.py``, which scans compiled HLO for
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops.  The port has no HLO: it reads the c10d
collectives that a profiled window ran, the backend's events (``nccl:*``
on the card, ``gloo:*`` on the CPU; profile with ``record_shapes=True``),
and returns the reference's keys: ``counts`` by the reference's kind
names, ``payload_bytes`` (each op's result bytes, as the reference takes
the result shape) and ``wire_bytes`` (the payload times the reference's
ring factor `_WIRE_FACTOR`).

An event's kind and dtype are its own (``nccl:all_gather``, its input
type); its result size is the first argument of the ``c10d::`` op that
issued it (the output of a gather or a scatter, the tensor of an
in-place all-reduce; the backend's events and the ops pair up in issue
order), or, where they do not pair up, the event's own input.  The
port's loops are host loops, so every launch of a collective is an event
of the trace: there is no loop body to multiply by a trip count, and the
reference's ``in_loop_payload_bytes`` has no counterpart.  The gloo
backend has no all-to-all: PyTorch runs one as an all-gather there.
"""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# wire-byte multiplier per payload byte (ring algorithms, (n-1)/n ≈ 1)
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# a collective's name → the kind: a backend event's after ``nccl:`` /
# ``gloo:``, or a ``_c10d_functional`` op's (what ``DTensor`` issues;
# `repro_torch.launch.dryrun.CollectiveRecorder` reads those)
_KINDS = {"all_reduce": "all-reduce", "allreduce": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "all_gather": "all-gather", "allgather": "all-gather",
          "_allgather_base": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "all_gather_base": "all-gather",
          "reduce_scatter": "reduce-scatter",
          "_reduce_scatter_base": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "reduce_scatter_base": "reduce-scatter",
          "all_to_all": "all-to-all", "alltoall": "all-to-all",
          "all_to_allv": "all-to-all", "alltoall_base": "all-to-all",
          "send": "collective-permute", "recv": "collective-permute"}

# a trace's element type name → bytes
_DTYPE_BYTES = {"double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
                "long int": 8, "long": 8, "int": 4, "short int": 2,
                "signed char": 1, "unsigned char": 1, "bool": 1,
                "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
                "Double": 8, "Float": 4, "BFloat16": 2, "Half": 2,
                "Long": 8, "Int": 4, "Char": 1, "Byte": 1, "Bool": 1}


def _nelems(dims) -> int:
    """Elements of a dims entry: a shape ([] for a 0-d tensor), or a list
    of shapes."""
    if dims and isinstance(dims[0], list):
        return sum(_nelems(d) for d in dims)
    return int(np.prod(dims))


def chrome_trace(prof) -> dict:
    """A ``torch.profiler.profile``'s chrome trace, loaded (exported once
    to a temporary file: a profile exports only once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _events(trace) -> list:
    """The complete ("X") events of a chrome trace: a path, a loaded
    dict, or a ``torch.profiler.profile``."""
    if hasattr(trace, "export_chrome_trace"):
        trace = chrome_trace(trace)
    elif isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X"]


def ops(trace) -> list[dict]:
    """Each collective of a trace (a profile, a loaded chrome trace or
    its path), in order: {"kind", "dtype", "payload_bytes",
    "wire_bytes"}."""
    evs = sorted(_events(trace), key=lambda e: float(e["ts"]))
    c10d = [e for e in evs if e.get("name", "").startswith("c10d::")]
    backend = [e for e in evs
               if e.get("name", "").partition(":")[0] in ("nccl", "gloo")]
    # one backend event per c10d op, in issue order (gloo runs its work
    # on worker threads, after the op has returned)
    calls = (list(zip(backend, c10d)) if len(backend) == len(c10d)
             else [(e, None) for e in backend])
    out = []
    for e, call in calls:
        op = e["name"].partition(":")[2]
        if op not in _KINDS:
            continue
        kind = _KINDS[op]
        args = e.get("args", {})
        types = args.get("Input type") or [args.get("dtype", "float")]
        dtype = types[0]
        dims = call.get("args", {}).get("Input Dims") if call else None
        if "Out msg nelems" in args:
            n = int(args["Out msg nelems"])
        elif dims:
            n = _nelems(dims[0])
        else:
            n = _nelems(args.get("Input Dims", []))
        out.append(record(kind, dtype, n * _DTYPE_BYTES.get(dtype, 4)))
    return out


def record(kind: str, dtype: str, payload_bytes: int) -> dict:
    """One collective: {"kind", "dtype", "payload_bytes" (its result's
    bytes), "wire_bytes" (the payload times `_WIRE_FACTOR`)}."""
    return {"kind": kind, "dtype": dtype, "payload_bytes": payload_bytes,
            "wire_bytes": payload_bytes * _WIRE_FACTOR[kind]}


def summarize(records) -> dict:
    """{"counts": kind → ops, "payload_bytes", "wire_bytes"} of a list of
    `record`s (the reference's keys)."""
    out = {"counts": defaultdict(int), "payload_bytes": 0.0,
           "wire_bytes": 0.0}
    for o in records:
        out["counts"][o["kind"]] += 1
        out["payload_bytes"] += o["payload_bytes"]
        out["wire_bytes"] += o["wire_bytes"]
    out["counts"] = dict(out["counts"])
    return out


def parse(trace) -> dict:
    """`summarize` of a trace's collectives (`ops`)."""
    return summarize(ops(trace))
