"""Traffic-driven tier policy for the registry's storage hierarchy.

The registry's original two tiers — "resident" and "spilled ``.npz``" —
become three:

* **hot** — resident classifier (device/host arrays, compiled base
  program): serves writes directly;
* **warm** — host-RAM packed snapshot state only (no engine, no
  compiled-program references, no device arrays): restorable to hot in
  milliseconds because promotion skips the cold path's frontend replay
  (parse → normalize → index) entirely;
* **cold** — compressed on-disk spill (``savez_compressed`` + integrity
  checksum): the cheapest place an idle tenant can live.

This module is the *policy* half — pure data structures, no locks held
across calls into anything else: a per-ontology read/write EWMA decides
the eviction victim (lowest traffic cools first) and the prefetch
candidate (highest read traffic warms first).  The registry executes
the decisions under its own entry locks.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple


class TierTraffic:
    """Per-ontology read/write exponentially-decayed rates.

    A touch adds 1 to the decayed count; ``halflife_s`` controls how
    fast history fades.  Thread-safe leaf structure (one internal lock,
    nothing called while holding it)."""

    __slots__ = ("halflife_s", "_lock", "_acc")

    def __init__(self, halflife_s: float = 60.0):
        if halflife_s <= 0:
            raise ValueError("halflife_s must be > 0")
        self.halflife_s = halflife_s
        self._lock = threading.Lock()
        #: oid → [read_rate, write_rate, last_touch_monotonic]
        self._acc: Dict[str, List[float]] = {}

    def _decay(self, acc: List[float], now: float) -> None:
        dt = now - acc[2]
        if dt > 0:
            k = math.exp(-math.log(2.0) * dt / self.halflife_s)
            acc[0] *= k
            acc[1] *= k
            acc[2] = now

    def _note(self, oid: str, slot: int) -> None:
        now = time.monotonic()
        with self._lock:
            acc = self._acc.get(oid)
            if acc is None:
                acc = self._acc[oid] = [0.0, 0.0, now]
            self._decay(acc, now)
            acc[slot] += 1.0

    def note_read(self, oid: str) -> None:
        self._note(oid, 0)

    def note_write(self, oid: str) -> None:
        self._note(oid, 1)

    def rates(self, oid: str) -> Tuple[float, float]:
        """Current (read_rate, write_rate), decayed to now."""
        now = time.monotonic()
        with self._lock:
            acc = self._acc.get(oid)
            if acc is None:
                return 0.0, 0.0
            self._decay(acc, now)
            return acc[0], acc[1]

    def score(self, oid: str) -> float:
        """Combined traffic score (reads + writes) for victim/prefetch
        ranking."""
        r, w = self.rates(oid)
        return r + w

    def forget(self, oid: str) -> None:
        with self._lock:
            self._acc.pop(oid, None)

    # --------------------------------------------------------- decisions

    def victim(self, candidates: Iterable[str]) -> Optional[str]:
        """The candidate to demote: lowest combined traffic (ties break
        deterministically by oid).  None when there are no candidates."""
        best = None
        for oid in candidates:
            key = (self.score(oid), oid)
            if best is None or key < best:
                best = key
        return best[1] if best is not None else None

    def hottest(self, candidates: Iterable[str]) -> Optional[str]:
        """The candidate to prefetch/promote: highest READ traffic
        (promotion serves the read plane; writes promote themselves on
        arrival).  None when no candidate has any read traffic."""
        best = None
        for oid in candidates:
            r, _w = self.rates(oid)
            if r <= 0.0:
                continue
            key = (r, oid)
            if best is None or key > best:
                best = key
        return best[1] if best is not None else None

    def snapshot(self) -> Dict[str, Tuple[float, float]]:
        with self._lock:
            now = time.monotonic()
            out = {}
            for oid, acc in self._acc.items():
                self._decay(acc, now)
                out[oid] = (acc[0], acc[1])
            return out
