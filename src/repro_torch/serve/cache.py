"""Solved-plan cache keyed by geometry fingerprints.

Reference: ``repro/serve/cache.py`` (``Fingerprint``, ``_hash_leaf``,
``fingerprint`` and ``PlanCache`` with its LRU, near digests and
``profile_match``).  The reference is numpy only; this copy also takes
tensors as leaves, hashing their host bytes (``.detach().cpu()``), so a
leaf on the card and its host copy share a digest.

A GW solve is a pure function of (geometry content, marginals, feature
cost, solve knobs, structural config), so an exact repeat is answered
from the stored `GWResult` without touching the device; and solved plans
are stable under small perturbations (Rioux et al., *Entropic
Gromov-Wasserstein Distances: Stability and Algorithms*), so a near
repeat warm-starts from a cached coupling.

A :class:`Fingerprint` has three layers:

``static``  structural identity: the bucket key (plan representation,
            geometry specs, padded sizes, objective and θ) and the solver
            config's ``static_key()`` (backends, caps, plan rank, ...).
            Requests whose static parts differ never share an entry.
``exact``   a blake2b digest over the raw bytes (dtype + shape + data) of
            every content leaf (a grid's spacing, cost factors, points,
            marginals, the feature cost) and the resolved value knobs
            (ε, tol, ε₀, decay, inner_loosen, γ): a hit returns the cached
            result bit for bit.
``near``    the same stream with every float quantized to a ``near_tol``
            grid first (``round(x / near_tol)``); the knobs still hash
            exactly.  A hit warm-starts the solve from the cached coupling.

Eviction is LRU over exact entries (``capacity`` of them); the near index
maps quantized digests to the most recently stored entry of that
neighbourhood and is pruned with its entries.  Counters (`hits`,
`near_hits`, `profile_hits`, `misses`, `evictions`) accumulate over the
cache's lifetime; `GWEngine.stats` counts per flush.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """A request's cache identity (see module docstring).  ``near`` is None
    when the cache was built with ``near_tol=0`` (exact-only mode)."""

    static: tuple
    exact: str
    near: str | None = None


def _hash_leaf(h, arr, quantum: float | None = None) -> None:
    """Feed one content leaf into a digest: dtype and shape always (an f32
    and an f64 solve differ even on equal values), bytes raw or quantized.
    Quantization rounds in f64 regardless of storage dtype, so an f32 leaf
    and its f64 round-trip stay neighbours.

    Non-finite values need their own channel: the NaN positions are hashed
    as a separate bitmask payload before the (NaN→0) quantized bytes, so a
    NaN-bearing leaf can never share a digest with any finite- or
    inf-bearing one (mapping NaN onto ±inf inside the value bytes — the
    old scheme — made a NaN request warm-start from an inf entry's plan)."""
    a = arr.detach().cpu().numpy() if torch.is_tensor(arr) \
        else np.asarray(arr)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    if quantum is None:
        h.update(a.tobytes())
    else:
        q = np.round(a.astype(np.float64) / quantum)
        mask = np.isnan(q)
        h.update(np.packbits(mask.ravel()).tobytes())
        # ±inf survive round() and tobytes() with their identity intact;
        # NaNs were recorded in the mask and are zeroed here (NaN != NaN
        # would otherwise hash unstably through astype(int))
        h.update(np.where(mask, 0.0, q).astype(np.float64).tobytes())


def fingerprint(static: tuple, leaves, knobs, near_tol: float = 0.0
                ) -> Fingerprint:
    """Fingerprint a request: ``static`` is the structural tuple, ``leaves``
    the content arrays (geometry leaves, marginals, feature cost), ``knobs``
    the resolved value-knob floats.  ``near_tol > 0`` adds the quantized
    digest that enables warm-start near hits."""
    knobs = np.asarray(knobs, np.float64)
    exact = hashlib.blake2b(digest_size=16)
    for a in leaves:
        _hash_leaf(exact, a)
    _hash_leaf(exact, knobs)
    near = None
    if near_tol > 0.0:
        nh = hashlib.blake2b(digest_size=16)
        for a in leaves:
            _hash_leaf(nh, a, near_tol)
        # knobs hash EXACTLY even in the near digest: nearness is a content
        # property, but ε=1e-3 and ε=1e-4 are different solves — under a
        # content-scale near_tol both would quantize to 0 and a loose solve
        # could seed a tight request
        _hash_leaf(nh, knobs)
        near = nh.hexdigest()
    return Fingerprint(static, exact.hexdigest(), near)


class PlanCache:
    """LRU cache of solved plans, keyed by :class:`Fingerprint`.

    ``lookup`` returns ``("exact", result)`` (bit-identical stored
    `GWResult`, zero device work), ``("near", result)`` (same static
    identity, content within ``near_tol`` — warm-start material), or
    ``(None, None)``.  ``store`` inserts/refreshes an entry and evicts the
    least recently used beyond ``capacity``.
    """

    def __init__(self, capacity: int, near_tol: float = 0.0):
        if capacity <= 0:
            raise ValueError(f"cache capacity must be positive, got "
                             f"{capacity}")
        if near_tol < 0.0:
            raise ValueError(f"near_tol must be >= 0, got {near_tol}")
        self.capacity = int(capacity)
        self.near_tol = float(near_tol)
        self._entries: OrderedDict[tuple, object] = OrderedDict()
        self._near_index: dict[tuple, tuple] = {}
        # entry key -> (knob bytes, sliced profile, aux): the second-stage
        # semantic signature (see profile_match); aux is opaque caller
        # data returned with a match (the engine stores canonical atom
        # orders there, to re-index a matched plan)
        self._profiles: dict[tuple, tuple] = {}
        self.hits = 0
        self.near_hits = 0
        self.profile_hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, fp: Fingerprint):
        key = (fp.static, fp.exact)
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return "exact", entry
        if fp.near is not None:
            ekey = self._near_index.get((fp.static, fp.near))
            if ekey is not None:
                entry = self._entries.get(ekey)
                if entry is not None:
                    self._entries.move_to_end(ekey)
                    self.near_hits += 1
                    return "near", entry
        self.misses += 1
        return None, None

    def store(self, fp: Fingerprint, result, profile=None,
              knob_key: bytes | None = None, aux=None) -> None:
        """Insert/refresh an entry.  ``profile`` (optional) attaches the
        request's sliced profile — the semantic geometry signature the
        second-stage `profile_match` compares on byte-digest misses —
        together with ``knob_key``, an exact encoding of the resolved
        solver knobs (profile matches never cross knob settings, for the
        same reason the near digest hashes knobs exactly), and ``aux``,
        opaque caller data handed back with a match (the engine keeps the
        canonical atom orders there)."""
        key = (fp.static, fp.exact)
        self._entries[key] = result
        self._entries.move_to_end(key)
        if fp.near is not None:
            # latest-wins: the newest solve of a neighbourhood is the best
            # warm-start source for the next near-repeat
            self._near_index[(fp.static, fp.near)] = key
        if profile is not None:
            self._profiles[key] = (knob_key,
                                   np.asarray(profile, np.float64), aux)
        while len(self._entries) > self.capacity:
            evicted, _ = self._entries.popitem(last=False)
            self.evictions += 1
            self._near_index = {nk: ek for nk, ek in self._near_index.items()
                                if ek != evicted}
            self._profiles.pop(evicted, None)

    def profile_match(self, static: tuple, knob_key: bytes | None, profile,
                      tol: float):
        """Second-stage near-miss detection: the closest same-static entry
        whose stored sliced profile is within normalized distance ``tol``
        of ``profile`` (and whose knobs match exactly).  Returns
        ``(cached result, stored aux)`` — warm-start material — or None.

        This is what catches semantically-close geometries whose BYTES
        differ — a rotated point cloud, a re-indexed grid: their quantized
        content digests miss, but their canonicalized sliced profiles
        coincide.  O(same-bucket entries) per miss, on ~n_proj-length
        vectors — noise next to a solve."""
        p = np.asarray(profile, np.float64)
        best, best_d = None, float(tol)
        for key in self._entries:
            if key[0] != static:
                continue
            stored = self._profiles.get(key)
            if stored is None or stored[0] != knob_key:
                continue
            q = stored[1]
            if q.shape != p.shape:
                continue
            d = (np.linalg.norm(p - q)
                 / (np.linalg.norm(p) + np.linalg.norm(q) + 1e-30))
            if d <= best_d:
                best, best_d = key, d
        if best is None:
            return None
        self._entries.move_to_end(best)
        self.profile_hits += 1
        return self._entries[best], self._profiles[best][2]
