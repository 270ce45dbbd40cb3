"""Affinity placement + rebalance decisions for the serve fleet.

Pure data structures — no sockets, no threads — so the policy is
unit-testable and the router stays a thin transport around it.

The model mirrors the reference's cluster config + work stealer
(``ShardInfo`` / ``worksteal/WorkStealer``): every ontology is *pinned*
to exactly one replica (its warm programs and resident closure live
there — requests must follow the state, not the other way round), new
ontologies land on the least-loaded healthy replica, and when one
replica's scheduler queue depth diverges from the coolest replica's by
more than ``depth_divergence``, the table proposes migrating one of the
hot replica's ontologies to the cool one.  The router executes the
proposal with the registry's spill/restore wire so results stay
byte-identical regardless of placement.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class ReplicaState:
    """What the router knows about one replica, refreshed by heartbeat."""

    __slots__ = (
        "rid", "url", "healthy", "queue_depth", "resident", "spilled",
        "consecutive_failures", "consecutive_timeouts", "last_seen",
    )

    def __init__(self, rid: str, url: str):
        self.rid = rid
        self.url = url
        self.healthy = True
        self.queue_depth = 0
        self.resident = 0
        self.spilled = 0
        #: consecutive FATAL probe failures (connection refused/reset —
        #: nothing is listening)
        self.consecutive_failures = 0
        #: consecutive SOFT probe failures (timeouts — a replica whose
        #: GIL is pinned by a long inline device program answers late,
        #: not never; ejecting it would kill healthy warm state)
        self.consecutive_timeouts = 0
        self.last_seen = 0.0

    def note_ok(self, healthz: dict) -> None:
        self.healthy = True
        self.consecutive_failures = 0
        self.consecutive_timeouts = 0
        self.last_seen = time.monotonic()
        self.queue_depth = int(healthz.get("queue_depth", 0))
        self.resident = int(healthz.get("resident", 0))
        self.spilled = int(healthz.get("spilled", 0))

    def note_failure(self, timeout: bool = False) -> None:
        if timeout:
            self.consecutive_timeouts += 1
        else:
            self.consecutive_failures += 1

    def as_dict(self) -> dict:
        return {
            "id": self.rid,
            "url": self.url,
            "healthy": self.healthy,
            "queue_depth": self.queue_depth,
            "resident": self.resident,
            "spilled": self.spilled,
            "consecutive_failures": self.consecutive_failures,
        }


class PlacementTable:
    """Ontology→replica affinity map + the placement/rebalance policy.

    Thread-safe: the router's request threads (place/lookup), heartbeat
    thread (health), and rebalance thread (propose/commit) all touch it.
    """

    def __init__(self, depth_divergence: int = 8):
        if depth_divergence < 1:
            raise ValueError("depth_divergence must be >= 1")
        self.depth_divergence = depth_divergence
        self._lock = threading.Lock()
        self._replicas: Dict[str, ReplicaState] = {}
        #: oid → replica id
        self._affinity: Dict[str, str] = {}
        #: oid → touch counter tick (cheap LRU for victim selection)
        self._touched: Dict[str, int] = {}
        self._tick = 0

    # ------------------------------------------------------- replica set

    def add_replica(self, rid: str, url: str) -> ReplicaState:
        with self._lock:
            if rid in self._replicas:
                raise ValueError(f"duplicate replica id {rid!r}")
            st = self._replicas[rid] = ReplicaState(rid, url)
            return st

    def replica(self, rid: str) -> ReplicaState:
        with self._lock:
            return self._replicas[rid]

    def replicas(self) -> List[ReplicaState]:
        with self._lock:
            return list(self._replicas.values())

    def healthy_replicas(self) -> List[ReplicaState]:
        with self._lock:
            return [r for r in self._replicas.values() if r.healthy]

    def mark_ejected(self, rid: str) -> List[str]:
        """Mark a replica unhealthy and return the ontologies stranded
        on it (the router re-places them via journal replay)."""
        with self._lock:
            st = self._replicas[rid]
            st.healthy = False
            return [o for o, r in self._affinity.items() if r == rid]

    def mark_respawned(self, rid: str, url: str) -> None:
        """A fresh process under the old id: every failure counter from
        the previous process resets with it."""
        with self._lock:
            st = self._replicas[rid]
            st.url = url
            st.healthy = True
            st.consecutive_failures = 0
            st.consecutive_timeouts = 0
            st.queue_depth = 0
            st.resident = 0
            st.spilled = 0

    # ---------------------------------------------------------- affinity

    def place(self, oid: str) -> ReplicaState:
        """Pin a NEW ontology: least queue depth among healthy replicas,
        resident count as the tiebreak (spread warm state evenly when
        the fleet is idle)."""
        with self._lock:
            live = [r for r in self._replicas.values() if r.healthy]
            if not live:
                raise NoHealthyReplica("no healthy replica to place on")
            best = min(
                live, key=lambda r: (r.queue_depth, r.resident, r.rid)
            )
            self._affinity[oid] = best.rid
            # count the placement toward load immediately: a burst of
            # loads between two heartbeats must not all pile onto the
            # same replica
            best.resident += 1
            self._touch(oid)
            return best

    def assign(self, oid: str, rid: str) -> None:
        """Pin (or re-pin) explicitly — migration commit, recovery."""
        with self._lock:
            if rid not in self._replicas:
                raise KeyError(f"unknown replica {rid!r}")
            self._affinity[oid] = rid
            self._touch(oid)

    def drop(self, oid: str) -> None:
        with self._lock:
            self._affinity.pop(oid, None)
            self._touched.pop(oid, None)

    def lookup(self, oid: str) -> Optional[ReplicaState]:
        """The replica pinned for ``oid`` (None = unknown ontology);
        touches the LRU tick."""
        with self._lock:
            rid = self._affinity.get(oid)
            if rid is None:
                return None
            self._touch(oid)
            return self._replicas[rid]

    def ontologies_on(self, rid: str) -> List[str]:
        with self._lock:
            return [o for o, r in self._affinity.items() if r == rid]

    def _touch(self, oid: str) -> None:
        """Bump the LRU tick.  Caller holds ``self._lock``."""
        self._tick += 1
        self._touched[oid] = self._tick

    # --------------------------------------------------------- rebalance

    def propose_migration(self) -> Optional[Tuple[str, str, str]]:
        """``(oid, src_rid, dst_rid)`` when one healthy replica's queue
        depth diverges from the coolest healthy replica's by at least
        ``depth_divergence`` and the hot replica holds an ontology to
        move — else None.

        Victim: the hot replica's least-recently-touched ontology — the
        cheapest warm state to cool down (its programs are bucket-shared
        anyway; only the closure moves, via spill/restore)."""
        with self._lock:
            live = [r for r in self._replicas.values() if r.healthy]
            if len(live) < 2:
                return None
            hot = max(live, key=lambda r: r.queue_depth)
            cool = min(live, key=lambda r: r.queue_depth)
            if hot.queue_depth - cool.queue_depth < self.depth_divergence:
                return None
            mine = [o for o, r in self._affinity.items() if r == hot.rid]
            if not mine:
                return None
            victim = min(mine, key=lambda o: self._touched.get(o, 0))
            return victim, hot.rid, cool.rid

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": [r.as_dict() for r in self._replicas.values()],
                "ontologies": len(self._affinity),
                "placement": dict(self._affinity),
            }


class NoHealthyReplica(RuntimeError):
    """Every replica is ejected or unreachable."""
