"""Read-optimized query plane: immutable versioned closure snapshots.

At serving scale reads (is-subsumed-by, subsumer sets, taxonomy slices)
vastly outnumber classifies, yet the original serve plane routed every
read through the scheduler's per-ontology lane — a point read queued
behind a multi-second delta saturation.  This module is the read path
that never does: on every commit (load, applied delta, restore/adopt)
the registry publishes a **frozen host-resident view** of the packed
S(X) bit-table plus the concept dictionaries under a monotonically
increasing per-ontology version.  The publish is swap-on-commit — the
snapshot is built off to the side (on the committing worker, which
already holds the entry) and then the store reference is swapped
atomically — so readers never take the scheduler lane or the entry
lock, and a read can never observe a half-applied update: it sees the
previous version until the swap, the new one after.

Answer shapes, straight off the wire-packed closure (subsumer-major
uint32 rows, the row-packed engine's native layout):

* ``is_subsumed(x, y)`` — one word read + shift: O(1);
* ``subsumers(x)`` — one packed-column gather over the class signature
  plus one lazily decoded row (small LRU of decoded rows);
* ``slice(x)`` — the taxonomy neighborhood of one class (equivalents,
  strict subsumers, strict subsumees, unsat flag) from the same two
  gathers.

Every response carries the snapshot ``version`` it was answered from;
callers thread it back as ``min_version`` to get monotonic reads and
read-your-writes across replicas (a lagging read replica answers
:class:`StaleSnapshot` → HTTP 412 and the router falls back to the
ontology's primary).

The port's copy of ``distel_tpu/serve/query/snapshot.py``.  One thing
differs: :meth:`OntologySnapshot.from_result` reads a row-packed
result's closure as the port keeps it, an int32 tensor that may lie on
the card (the reference fetches a device array with
``result._fetch()``), copying only its live subsumer rows to the host.
Everything else is the reference's.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID
from distel_tpu_torch.obs import trace as obs_trace


class SnapshotMiss(KeyError):
    """No snapshot published for this ontology (yet)."""


class StaleSnapshot(Exception):
    """The published snapshot is older than the caller's ``min_version``
    watermark — the monotonic-reads / read-your-writes guard a lagging
    read replica trips (HTTP 412; the router retries the primary)."""

    def __init__(self, oid: str, version: int, min_version: int):
        super().__init__(
            f"snapshot of {oid!r} is at version {version}, caller "
            f"requires >= {min_version}"
        )
        self.oid = oid
        self.version = version
        self.min_version = min_version


def _pack_rows_host(b: np.ndarray) -> np.ndarray:
    """bool [rows, bits] → little-endian uint32 wire rows (the
    row-packed engine's layout, built on host for non-transposed
    engine results)."""
    packed = np.packbits(b, axis=1, bitorder="little")
    pad = (-packed.shape[1]) % 4
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return np.ascontiguousarray(packed).view(np.uint32)


def _freeze(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    a.flags.writeable = False
    return a


class OntologySnapshot:
    """One frozen, host-resident view of a saturated closure.

    Immutable by construction (arrays are read-only, the store swaps
    whole snapshots) — safe to read from any number of handler threads
    with no locking.  The only mutable member is the decoded-row LRU,
    which is a ``functools.lru_cache`` (internally synchronized)."""

    __slots__ = (
        "oid", "version", "increment", "n_concepts", "s_wire",
        "concept_ids", "concept_names", "sig_ids", "sig_names",
        "_unsat", "_unsat_sig", "published_unix",
        "_decode_row", "__weakref__",
    )

    def __init__(
        self,
        oid: str,
        version: int,
        increment: int,
        n_concepts: int,
        s_wire: np.ndarray,
        concept_names: List[str],
        sig_ids: np.ndarray,
        *,
        row_cache: int = 256,
    ):
        self.oid = oid
        self.version = int(version)
        self.increment = int(increment)
        self.n_concepts = int(n_concepts)
        #: wire-packed subsumption closure, subsumer-major:
        #: ``bit(s_wire[a], x)`` ⇔ x ⊑ a (little-endian uint32 words)
        self.s_wire = _freeze(np.asarray(s_wire, np.uint32))
        self.concept_names = list(concept_names)
        self.concept_ids: Dict[str, int] = {
            nm: i for i, nm in enumerate(self.concept_names)
        }
        #: the original class signature (internal gensym/aux names
        #: excluded — reads never leak them), reference order
        self.sig_ids = _freeze(np.asarray(sig_ids, np.int64))
        self.sig_names = [self.concept_names[i] for i in self.sig_ids]
        self.published_unix = time.time()
        # unsat over the signature: unsat[x] ⇔ x ⊑ ⊥, one bottom-row
        # decode at build time (every read consults it)
        bot = self._row_bits_uncached(BOTTOM_ID)
        self._unsat = _freeze(bot)
        self._unsat_sig = _freeze(bot[self.sig_ids])
        self._decode_row = functools.lru_cache(maxsize=max(row_cache, 1))(
            self._row_bits_uncached
        )

    # ------------------------------------------------------ construction

    @classmethod
    def from_result(
        cls,
        oid: str,
        version: int,
        increment: int,
        result,
        *,
        row_cache: int = 256,
    ) -> "OntologySnapshot":
        """Build from a :class:`~distel_tpu.core.engine.SaturationResult`
        (fetches the packed closure to host; the row slice drops the
        engine's padding rows so the snapshot holds only live state)."""
        idx = result.idx
        n = idx.n_concepts
        if result.transposed:
            # the port's packed state may lie on the card: copy only the
            # live subsumer rows to the host (a copy on the CPU too, so
            # the next increment's in-place writes never reach it)
            s_wire = result.packed_s[:n].to("cpu", copy=True).numpy().view(np.uint32)
        else:
            # reference engines carry x-major bool state — pack the
            # subsumer-major wire form on host
            s_wire = _pack_rows_host(np.asarray(result.s[:n, :n]).T)
        orig = idx.original_classes
        sig = orig[(orig != BOTTOM_ID) & (orig != TOP_ID)]
        return cls(
            oid,
            version,
            increment,
            n,
            s_wire,
            list(idx.concept_names),
            sig,
            row_cache=row_cache,
        )

    # -------------------------------------------------------- wire forms

    def save(self, path: str) -> int:
        """Persist for read-replica adoption (``np.savez_compressed``).
        Returns bytes written."""
        import os

        np.savez_compressed(
            path,
            s_wire=self.s_wire,
            n_concepts=np.int64(self.n_concepts),
            version=np.int64(self.version),
            increment=np.int64(self.increment),
            concept_names=np.array(self.concept_names, dtype=object),
            sig_ids=np.asarray(self.sig_ids),
            meta=np.array(
                [json.dumps({"oid": self.oid, "time": time.time()})],
                dtype=object,
            ),
        )
        return os.path.getsize(path)

    @classmethod
    def load(cls, path: str, *, row_cache: int = 256) -> "OntologySnapshot":
        z = np.load(path, allow_pickle=True)
        meta = json.loads(str(z["meta"][0]))
        return cls(
            meta["oid"],
            int(z["version"]),
            int(z["increment"]),
            int(z["n_concepts"]),
            z["s_wire"],
            [str(n) for n in z["concept_names"]],
            z["sig_ids"],
            row_cache=row_cache,
        )

    # ------------------------------------------------------------- reads

    @property
    def nbytes(self) -> int:
        return int(self.s_wire.nbytes)

    def _row_bits_uncached(self, a: int) -> np.ndarray:
        """Decode wire row ``a`` → bool over x (x ⊑ a for all x)."""
        row = np.unpackbits(
            self.s_wire[a].view(np.uint8), bitorder="little"
        )
        return row[: self.n_concepts].astype(bool)

    def _id(self, name: str) -> int:
        cid = self.concept_ids.get(name)
        if cid is None:
            raise KeyError(name)
        return cid

    def _bit(self, a: int, x: int) -> bool:
        return bool((self.s_wire[a, x >> 5] >> np.uint32(x & 31)) & 1)

    def _col_sig(self, x: int) -> np.ndarray:
        """``up[p]`` ⇔ x ⊑ sig[p] — one packed-column gather over the
        signature (O(|sig|) word reads, vectorized)."""
        return (
            (self.s_wire[self.sig_ids, x >> 5] >> np.uint32(x & 31)) & 1
        ).astype(bool)

    def is_subsumed(self, sub: str, sup: str) -> bool:
        """x ⊑ y under the closure (reflexive; unsat x ⊑ everything —
        the same normalization the taxonomy applies)."""
        x, y = self._id(sub), self._id(sup)
        if x == y or self._unsat[x]:
            return True
        return self._bit(y, x)

    def subsumers(self, name: str) -> List[str]:
        """Strict named subsumers of ``name`` — byte-identical
        semantics to ``Taxonomy.subsumers[name]`` (equivalents and
        unsat classes excluded; an unsat class subsumes under
        everything)."""
        x = self._id(name)
        if self._unsat[x]:
            return sorted(n for n in self.sig_names if n != name)
        up = self._col_sig(x)  # x ⊑ a
        down = self._decode_row(x)[self.sig_ids]  # a ⊑ x
        strict = up & ~(down | self._unsat_sig)
        return sorted(
            self.sig_names[p] for p in np.nonzero(strict)[0]
        )

    def equivalents(self, name: str) -> List[str]:
        x = self._id(name)
        if self._unsat[x]:
            eq = set(
                self.sig_names[p]
                for p in np.nonzero(self._unsat_sig)[0]
            )
        else:
            up = self._col_sig(x)
            down = self._decode_row(x)[self.sig_ids]
            eq = set(
                self.sig_names[p] for p in np.nonzero(up & down)[0]
            )
        eq.add(name)
        return sorted(eq)

    def slice(self, name: str) -> dict:
        """The taxonomy neighborhood of one class: equivalents, strict
        subsumers (ancestors), strict named subsumees (descendants),
        unsat flag — the "taxonomy slice" read shape."""
        x = self._id(name)
        unsat_x = bool(self._unsat[x])
        up = self._col_sig(x) | unsat_x
        down = self._decode_row(x)[self.sig_ids] | self._unsat_sig
        eq = up & down
        doc = {
            "class": name,
            "unsatisfiable": unsat_x,
            "equivalents": sorted(
                {self.sig_names[p] for p in np.nonzero(eq)[0]} | {name}
            ),
            "subsumers": sorted(
                self.sig_names[p] for p in np.nonzero(up & ~down)[0]
            ),
            "subsumees": sorted(
                self.sig_names[p] for p in np.nonzero(down & ~up)[0]
            ),
        }
        return doc


class SnapshotStore:
    """Per-process map of the CURRENT snapshot per ontology.

    The read side is genuinely lock-free: ``get`` is a plain dict read
    of an immutable snapshot object (reference swaps are atomic under
    the GIL), so readers never contend with publishers, the scheduler,
    or each other.  ``_lock`` covers only the publishers' version
    bookkeeping; nothing is called while holding it."""

    def __init__(
        self,
        *,
        row_cache: int = 256,
        metrics=None,
        flight=None,
    ):
        self.row_cache = row_cache
        self.metrics = metrics
        self.flight = flight
        self._lock = threading.Lock()
        self._snaps: Dict[str, OntologySnapshot] = {}
        #: highest version ever published per oid (survives drop() so a
        #: re-adopt after migration cannot publish backwards)
        self._versions: Dict[str, int] = {}

    # ------------------------------------------------------------- write

    def publish_result(
        self, oid: str, result, *, at_least: int = 0
    ) -> OntologySnapshot:
        """Build a snapshot from a saturation result and swap it in.
        The version is ``max(previous + 1, at_least)`` — pass the
        classifier's increment counter as ``at_least`` so versions
        track increments and survive spill/restore/migration (the
        handoff texts replay to the same increment count)."""
        t0 = time.monotonic()
        with obs_trace.child_span(
            "query.publish", {"oid": oid}
        ):
            with self._lock:
                version = max(
                    self._versions.get(oid, 0) + 1, int(at_least)
                )
            snap = OntologySnapshot.from_result(
                oid, version, int(at_least), result,
                row_cache=self.row_cache,
            )
            if not self._swap(snap):
                # raced by a newer adopt for the same oid: newest wins
                # — report the installed snapshot's version instead
                snap = self._snaps.get(oid, snap)
        wall = time.monotonic() - t0
        if self.metrics is not None:
            self.metrics.observe("distel_query_publish_seconds", wall)
        if self.flight is not None:
            self.flight.record(
                "snapshot_publish",
                oid=oid,
                version=snap.version,
                bytes=snap.nbytes,
                wall_s=round(wall, 4),
            )
        return snap

    def adopt(self, snap: OntologySnapshot) -> bool:
        """Publish a snapshot built elsewhere (read-replica adoption
        from a peer's :meth:`OntologySnapshot.save` file).  Refused —
        returns False — when a newer version is already published
        (the check and the swap are ONE critical section: two racing
        adopts, or an adopt racing a commit publish, must never let
        the older snapshot clobber the newer one while the version
        floor stays high — the store would then 412 every watermarked
        read forever)."""
        if not self._swap(snap):
            return False
        if self.flight is not None:
            self.flight.record(
                "snapshot_adopt",
                oid=snap.oid,
                version=snap.version,
                bytes=snap.nbytes,
            )
        return True

    def seed_version(self, oid: str, version: int) -> None:
        """Raise the version floor without publishing — a migration
        target seeds the source's last version here so its own
        publishes continue the sequence (client read watermarks must
        survive the handoff)."""
        with self._lock:
            self._versions[oid] = max(
                self._versions.get(oid, 0), int(version)
            )

    def _swap(self, snap: OntologySnapshot) -> bool:
        """Atomically install ``snap`` unless a strictly newer version
        already holds the slot (newest wins under any interleaving)."""
        with self._lock:
            if snap.version < self._versions.get(snap.oid, 0):
                return False
            self._versions[snap.oid] = snap.version
            self._snaps[snap.oid] = snap
            return True

    def drop(self, oid: str) -> None:
        """Unpublish (migrate-out/export): later reads answer 404 so
        the router re-routes; the version floor survives so a
        re-adopted copy cannot publish backwards."""
        with self._lock:
            self._snaps.pop(oid, None)

    # -------------------------------------------------------------- read

    def get(
        self, oid: str, min_version: Optional[int] = None
    ) -> OntologySnapshot:
        snap = self._snaps.get(oid)  # atomic dict read — no lock
        if snap is None:
            raise SnapshotMiss(oid)
        if min_version is not None and snap.version < min_version:
            raise StaleSnapshot(oid, snap.version, min_version)
        return snap

    def ids(self) -> List[str]:
        return sorted(self._snaps)

    def stats(self) -> dict:
        snaps = list(self._snaps.values())  # atomic copy of refs
        return {
            "snapshots": len(snaps),
            "snapshot_bytes": sum(s.nbytes for s in snaps),
            "versions": {s.oid: s.version for s in snaps},
        }
