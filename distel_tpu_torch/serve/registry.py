"""Warm-program ontology registry over a tiered storage hierarchy.

One :class:`~distel_tpu.core.incremental.IncrementalClassifier` per
loaded ontology, kept *resident*: the compiled base program, the
persistent normalizer/indexer caches, and the device-resident packed
closure all survive across requests — the serving analog of the
reference's always-up Redis stores (SURVEY.md §5).  Under a
configurable memory budget entries move down a three-tier hierarchy
(the TPU-native answer to DistEL's L0 Redis-as-storage layer):

* **hot** — resident classifier (today's behavior);
* **warm** — host-RAM packed state only (``IncrementalClassifier.
  demote``: engine, compiled-program refs, and device arrays dropped;
  promoted back in milliseconds with NO frontend replay) — enabled by
  ``warm_budget_bytes`` > 0;
* **cold** — compressed ``.npz`` disk spill with an integrity
  checksum sidecar; restore replays the texts through the frontend
  (``IncrementalClassifier.restore``) and verifies the checksum.

Victim selection and prefetch are traffic-driven: a per-ontology
read/write EWMA (``serve/storage/tiers.TierTraffic``) cools the
quietest entry first and promotes the read-hottest non-resident entry
when budget headroom opens.

On every commit (load, applied delta, adopt, restore) the registry
additionally publishes an immutable versioned read snapshot into the
attached :class:`~distel_tpu.serve.query.SnapshotStore` (swap-on-
commit, under the entry lock so a publish can never interleave with an
export) — the query plane serves reads off it without ever touching
the scheduler lane or the entry lock.  Eviction demotes only the
WRITE-side state: the published snapshot stays readable while the
entry is warm or cold.

Concurrency contract: the scheduler serializes requests *per ontology*,
so an entry's classifier is only ever driven by one worker at a time;
the registry's own lock covers only the map/LRU bookkeeping, and
eviction skips entries whose per-entry lock is held (a busy ontology is
never spilled mid-request).

The port's copy of ``distel_tpu/serve/registry.py``.  What differs, and
why:

* ``OntologyRegistry(config, *, device=None, ...)`` resolves its device
  once (None = the first card; raises when there is none) and builds
  every classifier on it, through :meth:`OntologyRegistry._new_inc` and
  the cold restore.  Nothing falls back to the CPU: a request that fails
  on the card fails, and is counted, as in the reference.
* The per-request artifact attribution (the reference's
  ``_artifact_window``, which stamps farm hits onto a record) is left
  out: the port has no artifact farm (``core/artifacts.py`` waits for
  the graph-captured round), and with none installed the reference's
  window adds nothing to a record either.
* The warm view :meth:`OntologyRegistry._warm_result` wraps the
  demoted host state in the port's ``SaturationResult``, whose packed
  closure is a torch tensor.
* :meth:`OntologyRegistry.cohort_key` keeps the reference's rule; the
  port's engines have exact shapes (no ``_bucket``), so it answers None
  and the scheduler's cohort lane never forms.
  :meth:`OntologyRegistry.delta_cohort` raises ``NotImplementedError``.
* ``inc.last_compile`` is always None in the port (it compiles no
  programs), so the compile counters record nothing, as for a
  reference increment that compiled nothing.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Dict, List, Optional

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.obs import trace as obs_trace
from distel_tpu_torch.runtime.classifier import resolve_device
from distel_tpu_torch.serve.storage.tiers import TierTraffic


class UnknownOntology(KeyError):
    """No ontology registered under this id."""


class ColdSpillCorrupted(RuntimeError):
    """A cold spill failed its integrity checksum — the on-disk bytes
    are not the ones the registry wrote (bit rot, torn write, wrong
    file).  Restoring it would warm-start saturation from garbage and
    monotone EL+ would keep every wrong bit, so the restore refuses
    loudly instead."""


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Entry:
    __slots__ = (
        "oid", "inc", "warm_inc", "texts", "resident_bytes",
        "warm_bytes", "cold_bytes", "hot_bytes_estimate", "last_used",
        "spill_path", "spill_sha", "lock",
    )

    def __init__(self, oid: str):
        self.oid = oid
        self.inc = None  # IncrementalClassifier when hot (resident)
        self.warm_inc = None  # demoted classifier when warm
        self.texts: List[str] = []
        self.resident_bytes = 0
        self.warm_bytes = 0
        self.cold_bytes = 0
        #: resident footprint the entry had when it was last hot — the
        #: promotion cost estimate (cold_bytes is COMPRESSED, often
        #: 100x+ smaller than what a restore re-materializes)
        self.hot_bytes_estimate = 0
        self.last_used = time.monotonic()
        self.spill_path: Optional[str] = None
        self.spill_sha: Optional[str] = None
        self.lock = threading.RLock()


def _state_bytes(inc) -> int:
    """Resident footprint estimate: the packed closure pair (device or
    host).  The compiled program and index tables ride along uncounted —
    the closure dominates at serving scale."""
    state = inc._state
    if state is None:
        return 0
    return int(
        getattr(state[0], "nbytes", 0) + getattr(state[1], "nbytes", 0)
    )


class OntologyRegistry:
    def __init__(
        self,
        config: Optional[ClassifierConfig] = None,
        *,
        device=None,
        memory_budget_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
        metrics=None,
        fast_path_min_concepts: Optional[int] = None,
        flight=None,
        warm_budget_bytes: Optional[int] = None,
        query=None,
    ):
        self.config = config or ClassifierConfig()
        #: the device every classifier of this registry runs on
        self.device = resolve_device(device)
        self.memory_budget_bytes = memory_budget_bytes
        #: host-RAM warm-tier byte budget (0 = warm tier off: hot
        #: evictions spill straight to cold, the pre-tiering behavior);
        #: None falls back to the ``storage.warm.budget.mb`` knob
        if warm_budget_bytes is None:
            warm_budget_bytes = int(
                self.config.storage_warm_budget_mb * (1 << 20)
            )
        self.warm_budget_bytes = warm_budget_bytes
        #: optional :class:`~distel_tpu.serve.query.SnapshotStore` —
        #: when attached, every commit publishes a versioned read
        #: snapshot into it (the lock-free query plane)
        self.query = query
        #: per-ontology read/write EWMA driving victim selection and
        #: prefetch (leaf structure; only ever called lock-free or
        #: outside the registry/entry locks)
        self.traffic = TierTraffic(self.config.storage_ewma_halflife_s)
        self.spill_dir = spill_dir
        self.metrics = metrics
        #: optional :class:`~distel_tpu.obs.FlightRecorder` — the
        #: registry's state transitions (evict/restore/export/adopt)
        #: are control-plane events worth a causal record
        self.flight = flight
        #: ops override of the fast path's scale cutoff (None = the
        #: config knob ``fast_path_min_concepts`` — default 2048 now
        #: that bucketed delta programs made the steady state
        #: compile-free; a test sets 0 to force the fast path)
        self.fast_path_min_concepts = fast_path_min_concepts
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._seq = 0
        if memory_budget_bytes is not None and spill_dir is None:
            raise ValueError(
                "a memory budget needs a spill_dir to evict into"
            )
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)

    # ---------------------------------------------------------- helpers

    def _count(self, name: str, **labels) -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(name, labels or None)

    def _event(self, kind: str, **fields) -> None:
        if self.flight is not None:
            self.flight.record(kind, **fields)

    def _new_inc(self):
        from distel_tpu_torch.core.incremental import IncrementalClassifier

        inc = IncrementalClassifier(self.config, device=self.device)
        if self.fast_path_min_concepts is not None:
            inc._FAST_PATH_MIN_CONCEPTS = self.fast_path_min_concepts
        return inc

    def _entry(self, oid: str) -> _Entry:
        with self._lock:
            entry = self._entries.get(oid)
        if entry is None:
            raise UnknownOntology(oid)
        return entry

    def _check_live(self, entry: _Entry) -> None:
        """Re-check registration under ``entry.lock``: a writer that
        fetched the entry and then lost the lock race to an
        :meth:`export` must fail loudly instead of mutating a
        deregistered zombie (the ack would never reach the migrated
        copy).  The serve scheduler's per-ontology lane already
        serializes these; this keeps the registry safe on its own."""
        with self._lock:
            if self._entries.get(entry.oid) is not entry:
                raise UnknownOntology(entry.oid)

    def new_id(self) -> str:
        """Reserve an ontology id (the scheduler needs the key *before*
        the load executes, so per-key serialization covers the load
        itself)."""
        with self._lock:
            self._seq += 1
            return f"ont-{self._seq:04d}"

    # ------------------------------------------------------------- API

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
        resident = [e for e in entries if e.inc is not None]
        warm = [e for e in entries if e.inc is None and e.warm_inc]
        return {
            "ontologies": len(entries),
            "resident": len(resident),
            "warm": len(warm),
            "spilled": len(entries) - len(resident),
            "resident_bytes": sum(e.resident_bytes for e in resident),
            "memory_budget_bytes": self.memory_budget_bytes,
        }

    def tier_stats(self) -> dict:
        """Per-tier byte/count accounting — the ``distel_tier_*``
        gauge families on ``/metrics`` render from one call, so bytes
        and counts stay mutually consistent within a scrape."""
        with self._lock:
            entries = list(self._entries.values())
        resident = [e for e in entries if e.inc is not None]
        warm = [e for e in entries if e.inc is None and e.warm_inc]
        cold = [
            e for e in entries
            if e.inc is None and e.warm_inc is None and e.spill_path
        ]
        return {
            "resident_bytes": sum(e.resident_bytes for e in resident),
            "warm_bytes": sum(e.warm_bytes for e in warm),
            "cold_bytes": sum(e.cold_bytes for e in cold),
            "resident_ontologies": len(resident),
            "warm_ontologies": len(warm),
            "cold_ontologies": len(cold),
        }

    def note_read(self, oid: str) -> None:
        """Query-plane read hook: feeds the traffic EWMA that decides
        tier promotion — called lock-free off the read path."""
        self.traffic.note_read(oid)

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(
                e.resident_bytes
                for e in self._entries.values()
                if e.inc is not None
            )

    def load(self, oid: str, text: str) -> dict:
        """Load+classify a new ontology under a reserved id."""
        with self._lock:
            if oid in self._entries:
                raise ValueError(f"ontology id already loaded: {oid}")
            entry = self._entries[oid] = _Entry(oid)
        try:
            with entry.lock:
                inc = self._new_inc()
                result = inc.add_text(text)
                entry.inc = inc
                entry.texts.append(text)
                entry.resident_bytes = _state_bytes(inc)
                entry.last_used = time.monotonic()
                version = self._publish(oid, inc)
        except BaseException:
            # a failed load must not leave a zombie id behind (listed by
            # /healthz, un-restorable, growing the map on every retry)
            with self._lock:
                self._entries.pop(oid, None)
            raise
        self.traffic.note_write(oid)
        self._note_path(inc)
        self._maybe_evict(keep=oid)
        rec = dict(inc.history[-1])
        rec.update(
            id=oid,
            concepts=result.idx.n_concepts,
            links=result.idx.n_links,
            roles=result.idx.n_roles,
        )
        if version is not None:
            rec["version"] = version
        return rec

    def delta(self, oid: str, texts: List[str]) -> dict:
        """Apply one or more delta texts as ONE increment (the
        scheduler's batching path: deltas are order-dependent per
        ontology, and a coalesced batch saturates once — monotone EL+
        makes the merged batch's closure identical to applying them in
        sequence)."""
        from distel_tpu_torch.owl import loader as owl_loader

        entry = self._entry(oid)
        with entry.lock:
            self._check_live(entry)
            inc = self._resident(entry)
            text = "\n".join(texts)
            # parse FIRST (the common failure, and it mutates nothing),
            # then record the text BEFORE saturating: add_ontology
            # merges the batch into the accumulated corpus up front, so
            # if the saturation itself fails the classifier has still
            # ingested the axioms (the next successful increment
            # derives them) — texts must agree with the corpus or a
            # later spill/restore would silently replay a smaller
            # ontology than the one the closure answers for
            onto = owl_loader.load(text)
            entry.texts.append(text)
            inc.add_ontology(onto, source_text=text)
            rec = self._commit_delta(oid, entry, inc, len(texts))
        self.traffic.note_write(oid)
        self._note_path(inc)
        self._maybe_evict(keep=oid)
        return rec

    def retract(self, oid: str, text: str) -> dict:
        """Retract a previously-applied text and commit the DRed-repaired
        closure (``core/retract.py``).  Rides the scheduler's
        per-ontology lane like a delta but NEVER cohorts: retraction is
        submitted non-batchable (``kind="retract"``), so the cohort
        formation lane — which only groups batchable deltas — falls back
        solo by construction; the flight event says so loudly.

        The op-log entry (``{"op": "retract", "text": ...}``) is appended
        to ``entry.texts`` only after the repair commits: on a mid-repair
        failure the classifier's packed state is consumed (the next
        increment re-derives the survivors from scratch) while
        ``last_result`` still answers for the PRE-retract corpus the
        un-appended text log describes — spill/restore stays consistent
        either way.

        The repaired snapshot always publishes under a NEW version —
        bypassing the no-op republish skip on purpose: a repair can
        derive zero new bits yet still shrink ``original_classes``
        (dead concepts leave the taxonomy), which the skip's
        closure-only check cannot see.  Pre-repair versions keep
        serving reads until the swap; ``min_version`` semantics are
        unchanged."""
        from distel_tpu_torch.core.retract import RetractionError

        entry = self._entry(oid)
        t0 = time.monotonic()
        with entry.lock:
            self._check_live(entry)
            inc = self._resident(entry)
            try:
                with obs_trace.child_span(
                    "registry.retract", {"oid": oid}
                ):
                    inc.retract(text)
            except RetractionError as e:
                self._count("distel_retract_refused_total")
                self._event(
                    "retract_refused",
                    oid=oid,
                    reason=type(e).__name__,
                )
                raise
            entry.texts.append({"op": "retract", "text": text})
            entry.resident_bytes = _state_bytes(inc)
            entry.last_used = time.monotonic()
            version = None
            if self.query is not None and inc.last_result is not None:
                version = self.query.publish_result(
                    oid, inc.last_result, at_least=inc.increment
                ).version
            rec = dict(inc.history[-1])
            rec.update(
                id=oid,
                concepts=inc.last_result.idx.n_concepts,
            )
            if version is not None:
                rec["version"] = version
        wall = time.monotonic() - t0
        self.traffic.note_write(oid)
        self._count("distel_retract_total")
        if self.metrics is not None:
            self.metrics.observe("distel_retract_repair_seconds", wall)
        self._event(
            "retract",
            oid=oid,
            rows=rec.get("retracted_rows"),
            affected=rec.get("affected_concepts"),
            cohort="solo",  # retracts never form/join cohorts
            wall_s=round(wall, 4),
        )
        self._note_path(inc)
        self._maybe_evict(keep=oid)
        return rec

    def cohort_key(self, oid: str) -> Optional[str]:
        """Cohort-formation grouping proxy: the ontology's
        compiled BASE program's bucket signature, or None when it has
        no cohortable posture (unknown, not resident, no base program,
        mesh or exact-shape engine).  Deliberately LOCK-FREE and racy —
        the scheduler calls it while holding its own condition
        variable, and execution re-validates every member; a stale
        answer only costs a fallback, never correctness."""
        with self._lock:
            entry = self._entries.get(oid)
        if entry is None:
            return None
        inc = entry.inc  # unlocked read: grouping hint only
        if inc is None:
            return None
        base = inc._base_engine
        if (
            base is None
            or getattr(base, "mesh", None) is not None
            or not getattr(base, "_bucket", False)
        ):
            return None
        return base.bucket_signature

    def delta_cohort(self, items: List) -> Dict[str, object]:
        """The reference advances a cohort of same-bucket tenants under
        shared vmapped dispatches (``core/cohort.py``).  The port has no
        cohort plane yet (ROADMAP Queue 1, "The cohort plane"), and
        :meth:`cohort_key` never groups its exact-shape engines, so the
        scheduler never calls this."""
        raise NotImplementedError(
            "delta_cohort: distel_tpu_torch has no cohort plane yet "
            "(ROADMAP Queue 1, the cohort plane)"
        )

    def _commit_delta(self, oid, entry, inc, n_texts) -> dict:
        """Post-increment bookkeeping shared by the solo :meth:`delta`
        and every cohort member: byte accounting, snapshot publish, and
        the response record — ONE implementation so cohort-served and
        solo-served deltas can never drift apart in what they commit or
        report.  Caller holds ``entry.lock``."""
        entry.resident_bytes = _state_bytes(inc)
        entry.last_used = time.monotonic()
        version = self._publish(oid, inc)
        rec = dict(inc.history[-1])
        rec.update(
            id=oid,
            batched=n_texts,
            concepts=inc.last_result.idx.n_concepts,
        )
        if version is not None:
            rec["version"] = version
        return rec

    def classifier(self, oid: str):
        """The resident classifier for a query (restores from spill if
        evicted).  Caller must hold the scheduler's per-ontology
        serialization (queries ride the same lane as deltas)."""
        entry = self._entry(oid)
        with entry.lock:
            self._check_live(entry)
            inc = self._resident(entry)
            entry.last_used = time.monotonic()
            return inc

    # -------------------------------------------------- migration plane

    def export(self, oid: str) -> dict:
        """Migrate-out hook: spill the ontology's closure to
        ``spill_dir`` (the checkpoint ``.npz`` wire form), deregister
        the id, and return the handoff record a peer replica's
        :meth:`adopt` consumes — ``{"id", "texts", "spill"}``.

        Rides the scheduler's per-ontology lane like any other request,
        so it serializes AFTER every previously admitted request for
        this ontology: nothing in flight is dropped, and the spilled
        closure is the one those requests produced."""
        if not self.spill_dir:
            raise ValueError("export needs a spill_dir to snapshot into")
        entry = self._entry(oid)
        with entry.lock:
            # same zombie guard as the writers: two concurrent exports
            # (an operator driving a replica's /fleet/migrate directly
            # while the router rebalances the same oid) must not both
            # return a handoff — the loser sees UnknownOntology
            self._check_live(entry)
            version = None
            if self.query is not None:
                # unpublish BEFORE deregistering (still under the entry
                # lock, so no in-flight commit can republish): reads for
                # a migrated-out ontology must 404 so the router
                # re-routes to the adopting replica
                try:
                    version = self.query.get(oid).version
                except KeyError:
                    pass
                self.query.drop(oid)
            path = self._spill(entry)
            texts = list(entry.texts)
            sha = entry.spill_sha
            with self._lock:
                self._entries.pop(oid, None)
        self.traffic.forget(oid)
        self._count("distel_registry_exports_total")
        self._event("registry_export", oid=oid, spill=path)
        return {
            "id": oid, "texts": texts, "spill": path, "sha": sha,
            "version": version,
        }

    def adopt(
        self,
        oid: str,
        texts: List[str],
        spill_path: Optional[str] = None,
        warm: bool = True,
        min_version: Optional[int] = None,
        sha: Optional[str] = None,
    ) -> dict:
        """Migrate-in hook: register an ontology from a peer's
        :meth:`export` record.  With a ``spill_path`` the closure
        restores from the snapshot (frontend replay + warm-start — the
        answers are byte-identical to the source replica's); without one
        the texts re-classify from scratch (crash recovery: the router
        replays its journal when a replica died without spilling).

        ``warm=True`` restores eagerly so the handoff completes with a
        resident classifier; ``warm=False`` defers to the first request
        (the LRU lazy-restore path).

        ``min_version``: the source replica's last published snapshot
        version (the export record carries it) — seeds the query
        store's version floor so the adopted copy's snapshots continue
        the source's sequence and client read watermarks survive the
        migration.

        ``sha``: the export's in-band spill checksum — verification
        then doesn't depend on the ``.sha256`` sidecar having survived
        the shared spill dir."""
        if not texts:
            raise ValueError("adopt needs at least one ontology text")
        if min_version and self.query is not None:
            self.query.seed_version(oid, int(min_version))
        with self._lock:
            if oid in self._entries:
                raise ValueError(f"ontology id already loaded: {oid}")
            entry = self._entries[oid] = _Entry(oid)
        try:
            with entry.lock:
                if spill_path is not None:
                    entry.texts = list(texts)
                    entry.spill_path = spill_path
                    entry.spill_sha = sha
                    if warm:
                        self._resident(entry)
                else:
                    # crash-recovery replay: a pure-add log still joins
                    # into ONE increment (the historical fast path); a
                    # log with retraction markers ({"op": "retract"})
                    # must replay IN ORDER — a retract only resolves
                    # against the exact add text before it
                    inc = self._new_inc()
                    if not any(isinstance(op, dict) for op in texts):
                        inc.add_text("\n".join(texts))
                    else:
                        for op in texts:
                            if isinstance(op, dict):
                                if op.get("op") != "retract":
                                    raise ValueError(
                                        f"unknown op-log entry: {op!r}"
                                    )
                                inc.retract(op["text"])
                            else:
                                inc.add_text(op)
                    entry.inc = inc
                    entry.texts = list(texts)
                    entry.resident_bytes = _state_bytes(inc)
                    self._publish(oid, inc)
                entry.last_used = time.monotonic()
        except BaseException:
            # a failed adopt must not leave a zombie id behind
            with self._lock:
                self._entries.pop(oid, None)
            raise
        self._count("distel_registry_adoptions_total")
        self._event(
            "registry_adopt",
            oid=oid,
            restored_from=spill_path,
            resident=entry.inc is not None,
        )
        self._maybe_evict(keep=oid)
        return {
            "id": oid,
            "resident": entry.inc is not None,
            "restored_from": spill_path,
        }

    # ------------------------------------------------------ spill plane

    def _publish(self, oid: str, inc) -> Optional[int]:
        """Publish the committed closure as a versioned read snapshot
        (swap-on-commit).  Caller holds ``entry.lock`` — a publish must
        never interleave with an export's unpublish-and-deregister.

        No-op commits skip the rebuild: when the
        increment derived nothing new AND grew no concepts, the packed
        closure is bit-identical to the published snapshot's, so the
        O(closure) device→host fetch + snapshot build would produce
        the same bytes — the live snapshot is reused as-is (its
        version answers the caller's read-your-writes watermark, which
        an unchanged closure satisfies by construction)."""
        if self.query is None or inc.last_result is None:
            return None
        res = inc.last_result
        if res.derivations == 0:
            try:
                snap = self.query.get(oid)
            except KeyError:
                snap = None
            if (
                snap is not None
                and snap.n_concepts == res.idx.n_concepts
            ):
                self._count("distel_query_republish_skipped_total")
                return snap.version
        snap = self.query.publish_result(
            oid, res, at_least=inc.increment
        )
        return snap.version

    def _publish_if_missing(self, oid: str, inc) -> Optional[int]:
        """Restore/promote paths re-publish only when no snapshot is
        live OR the live one is behind this classifier's increment:
        eviction never unpublished (reads keep working while the
        write-side state is warm/cold), but a replica that adopts an
        ontology it previously held only a READ-ONLY copy of must
        supersede that older copy, or its reads would serve the stale
        version forever.  Caller holds ``entry.lock``."""
        if self.query is None:
            return None
        try:
            snap = self.query.get(oid)
            if snap.increment >= inc.increment:
                return snap.version
        except KeyError:
            pass
        return self._publish(oid, inc)

    def _resident(self, entry: _Entry, evict: bool = True):
        """Entry's classifier, promoted from the warm tier (host-RAM
        packed state, no frontend replay) or restored from the cold
        spill (checksum-verified, full text replay).  Caller holds
        ``entry.lock``.  ``evict=False`` defers the promote-time
        budget sweep to the caller — the cohort path holds SEVERAL
        entry locks at once, and this thread's own RLocks re-acquire,
        so an inline eviction could demote a co-held member."""
        if entry.inc is not None:
            return entry.inc
        t0 = time.monotonic()
        if entry.warm_inc is not None:
            # warm → hot: re-embed the retained host state under a
            # fresh (normally registry-cached) engine — one quiet
            # saturation pass, no parse/normalize/index
            with obs_trace.child_span(
                "registry.promote", {"oid": entry.oid}
            ):
                inc = entry.warm_inc
                entry.warm_inc = None
                inc.promote()
            entry.inc = inc
            entry.resident_bytes = _state_bytes(inc)
            entry.warm_bytes = 0
            wall = time.monotonic() - t0
            self._count("distel_tier_promotions_total", tier="warm")
            self._event(
                "tier_promote", oid=entry.oid, tier="warm",
                wall_s=round(wall, 4),
            )
            if self.metrics is not None:
                self.metrics.observe(
                    "distel_registry_promote_seconds", wall
                )
            self._note_compile(inc.last_compile)
            self._publish_if_missing(entry.oid, inc)
            if evict:
                self._maybe_evict(keep=entry.oid)
            return inc
        from distel_tpu_torch.core.incremental import IncrementalClassifier

        self._verify_spill(entry)
        with obs_trace.child_span(
            "registry.restore", {"oid": entry.oid}
        ):
            inc = IncrementalClassifier.restore(
                entry.texts, entry.spill_path, self.config,
                device=self.device,
            )
        if self.fast_path_min_concepts is not None:
            inc._FAST_PATH_MIN_CONCEPTS = self.fast_path_min_concepts
        entry.inc = inc
        entry.resident_bytes = _state_bytes(inc)
        self._count("distel_registry_restores_total")
        self._count("distel_tier_promotions_total", tier="cold")
        self._event(
            "registry_restore",
            oid=entry.oid,
            wall_s=round(time.monotonic() - t0, 4),
        )
        if self.metrics is not None:
            self.metrics.observe(
                "distel_registry_restore_seconds",
                time.monotonic() - t0,
            )
        # a warm-bucket restore shows up here as a program-cache hit
        # with compile ≈ 0 (the whole point of the warmup precompile)
        self._note_compile(inc.last_compile)
        self._publish_if_missing(entry.oid, inc)
        if evict:
            self._maybe_evict(keep=entry.oid)
        return inc

    def _verify_spill(self, entry: _Entry) -> None:
        """Integrity-check a cold spill against its checksum before
        restoring from it.  The expected digest comes from the entry
        (same-process respill) or the ``.sha256`` sidecar the spill
        writer left (cross-process adopt over the shared spill dir);
        spills from before the checksum era have neither and restore
        unverified (back-compat)."""
        if not entry.spill_path:
            return
        expected = entry.spill_sha
        if expected is None:
            sidecar = entry.spill_path + ".sha256"
            if os.path.exists(sidecar):
                with open(sidecar) as f:
                    expected = f.read().strip() or None
        if expected is None:
            return
        actual = _file_sha256(entry.spill_path)
        if actual != expected:
            self._event(
                "spill_corrupt", oid=entry.oid,
                spill=entry.spill_path,
                expected=expected[:16], actual=actual[:16],
            )
            raise ColdSpillCorrupted(
                f"cold spill {entry.spill_path!r} of {entry.oid!r} "
                f"failed its checksum (expected {expected[:16]}…, got "
                f"{actual[:16]}…) — refusing to warm-start from "
                "corrupted state"
            )

    def _spill_path(self, oid: str) -> str:
        return os.path.join(self.spill_dir, f"{oid}.snapshot.npz")

    def _warm_result(self, inc):
        """A :class:`SaturationResult`-shaped view over a DEMOTED
        classifier's host state, so a warm entry can spill to cold
        without promoting first.  Iteration/derivation counters are
        informational in the snapshot meta and not retained by the
        warm tier — restore re-derives its own."""
        import numpy as np
        import torch

        from distel_tpu_torch.core.engine import SaturationResult

        s, r = inc._state
        transposed = s.dtype == np.uint32
        return SaturationResult(
            # the port's results hold the packed closure as int32 tensors
            packed_s=torch.from_numpy(s.view(np.int32)) if transposed else s,
            packed_r=torch.from_numpy(r.view(np.int32)) if transposed else r,
            iterations=0,
            derivations=0,
            idx=inc._warm_idx,
            transposed=transposed,
            _s=None if transposed else s,
            _r=None if transposed else r,
        )

    def _spill(self, entry: _Entry) -> Optional[str]:
        """Demote the entry to the COLD tier: snapshot the closure
        (hot classifier or warm host state) to disk — compressed per
        ``storage.compress.spills`` — with a ``.sha256`` integrity
        sidecar, and drop every in-RAM copy.  Caller holds
        ``entry.lock``."""
        if entry.inc is None and entry.warm_inc is None:
            return entry.spill_path
        path = self._spill_path(entry.oid)
        compressed = bool(self.config.storage_compress_spills)
        t0 = time.monotonic()
        if entry.inc is not None:
            entry.inc.snapshot(path, compressed=compressed)
        else:
            from distel_tpu_torch.runtime.checkpoint import save_snapshot

            save_snapshot(
                path, self._warm_result(entry.warm_inc),
                compressed=compressed,
            )
        sha = _file_sha256(path)
        with open(path + ".sha256", "w") as f:
            f.write(sha + "\n")
        entry.spill_path = path
        entry.spill_sha = sha
        entry.cold_bytes = os.path.getsize(path)
        if entry.resident_bytes or entry.warm_bytes:
            entry.hot_bytes_estimate = (
                entry.resident_bytes or entry.warm_bytes
            )
        entry.inc = None
        entry.warm_inc = None
        entry.resident_bytes = 0
        entry.warm_bytes = 0
        # the satellite contract: written bytes + compression wall land
        # in the registry_spill event (zlib on a multi-GB closure is
        # minutes of single-core wall — the record must say who paid)
        self._event(
            "registry_spill",
            oid=entry.oid,
            spill=path,
            bytes=entry.cold_bytes,
            compressed=compressed,
            wall_s=round(time.monotonic() - t0, 4),
        )
        return path

    def _demote_warm(self, entry: _Entry) -> None:
        """Demote a hot entry to the WARM tier (host-RAM packed state,
        engine/programs/device arrays dropped).  Caller holds
        ``entry.lock``."""
        t0 = time.monotonic()
        inc = entry.inc
        entry.hot_bytes_estimate = entry.resident_bytes
        entry.warm_bytes = inc.demote()
        entry.warm_inc = inc
        entry.inc = None
        entry.resident_bytes = 0
        self._count("distel_tier_demotions_total", tier="warm")
        self._event(
            "tier_demote", oid=entry.oid, tier="warm",
            bytes=entry.warm_bytes,
            wall_s=round(time.monotonic() - t0, 4),
        )

    def _maybe_evict(self, keep: Optional[str] = None) -> None:
        """Demote entries down the tier ladder until each tier fits its
        budget: hot overflow cools to WARM (host-RAM packed state) when
        a warm budget is configured — else straight to COLD — and warm
        overflow spills to COLD.  The victim is the lowest-traffic
        entry by the read/write EWMA (``last_used`` breaks ties, the
        old LRU order).  Never evicts ``keep`` (the entry just
        touched) and never blocks on a busy entry's lock — a
        concurrent request beats a byte target."""
        if self.memory_budget_bytes is None:
            return
        while True:
            with self._lock:
                # total counts EVERY resident closure (keep included);
                # keep is only exempt from victim selection
                total = sum(
                    e.resident_bytes
                    for e in self._entries.values()
                    if e.inc is not None
                )
                victims = [
                    e
                    for e in self._entries.values()
                    if e.inc is not None and e.oid != keep
                ]
                if total <= self.memory_budget_bytes or not victims:
                    break
            victim = self._pick_victim(victims)
            if not victim.lock.acquire(blocking=False):
                return  # busy: let the in-flight request finish first
            try:
                if victim.inc is None:
                    continue  # raced with another evictor
                bytes_freed = victim.resident_bytes
                if self.warm_budget_bytes > 0:
                    self._demote_warm(victim)
                else:
                    self._spill(victim)
                self._count("distel_registry_evictions_total")
                self._event(
                    "registry_evict",
                    oid=victim.oid,
                    bytes=bytes_freed,
                    to="warm" if victim.warm_inc is not None else "cold",
                    spill=victim.spill_path,
                )
            finally:
                victim.lock.release()
        self._shed_warm(keep)

    def _pick_victim(self, victims: List[_Entry]) -> _Entry:
        """Lowest-traffic entry (EWMA scored OUTSIDE the registry
        lock — TierTraffic has its own leaf lock), last_used tiebreak."""
        scores = {e.oid: self.traffic.score(e.oid) for e in victims}
        return min(victims, key=lambda e: (scores[e.oid], e.last_used))

    def _shed_warm(self, keep: Optional[str] = None) -> None:
        """Spill warm-tier overflow to cold until the warm budget
        fits."""
        if self.warm_budget_bytes <= 0:
            return
        while True:
            with self._lock:
                warm = [
                    e
                    for e in self._entries.values()
                    if e.inc is None and e.warm_inc is not None
                ]
                total = sum(e.warm_bytes for e in warm)
                victims = [e for e in warm if e.oid != keep]
                if total <= self.warm_budget_bytes or not victims:
                    return
            victim = self._pick_victim(victims)
            if not victim.lock.acquire(blocking=False):
                return
            try:
                if victim.warm_inc is None:
                    continue  # raced: promoted or already spilled
                self._spill(victim)
                self._count(
                    "distel_tier_demotions_total", tier="cold"
                )
            finally:
                victim.lock.release()

    def maybe_prefetch(self) -> Optional[str]:
        """Traffic-driven promotion: bring the READ-hottest non-hot
        entry back to the hot set while byte headroom exists (warm
        entries promote in milliseconds; cold ones pay the full
        restore).  Called by the serve plane's background promoter
        thread and directly by tests.  Returns the promoted oid, or
        None when there is no headroom, no candidate, or the candidate
        is busy."""
        if self.memory_budget_bytes is None:
            return None
        with self._lock:
            hot_total = sum(
                e.resident_bytes
                for e in self._entries.values()
                if e.inc is not None
            )
            # promotion cost = what the entry RESIDENTLY weighed when
            # last hot (warm bytes track it closely; cold_bytes are
            # compressed — often 100x+ smaller than the restore would
            # re-materialize, so they must never size the decision).
            # An entry adopted cold into a fresh process has no
            # estimate yet and is skipped: its first demanded request
            # promotes it organically and records one.
            candidates = {
                e.oid: (e.hot_bytes_estimate or e.warm_bytes)
                for e in self._entries.values()
                if e.inc is None and (e.warm_inc or e.spill_path)
            }
        headroom = self.memory_budget_bytes - hot_total
        if headroom <= 0:
            return None
        candidates = {o: b for o, b in candidates.items() if b > 0}
        if not candidates:
            return None
        oid = self.traffic.hottest(candidates)
        if oid is None or candidates[oid] > headroom:
            return None
        entry = self._entries.get(oid)
        if entry is None:
            return None
        if not entry.lock.acquire(blocking=False):
            return None
        try:
            self._check_live(entry)
            if entry.inc is not None:
                return None  # promoted by a request meanwhile
            self._resident(entry)
            self._event("tier_prefetch", oid=oid)
            return oid
        except UnknownOntology:
            return None
        finally:
            entry.lock.release()

    def spill_all(self) -> List[str]:
        """Graceful-shutdown hook: snapshot every resident ontology so a
        restarted server restores instead of re-classifying.  Returns
        the spill paths written."""
        if not self.spill_dir:
            return []
        with self._lock:
            entries = list(self._entries.values())
        paths = []
        for entry in entries:
            with entry.lock:
                if entry.inc is None and entry.warm_inc is None:
                    continue
                paths.append(self._spill(entry))
                self._count("distel_registry_shutdown_spills_total")
                self._event(
                    "registry_shutdown_spill",
                    oid=entry.oid,
                    spill=entry.spill_path,
                )
        return paths

    # ---------------------------------------------------------- metrics

    def _note_path(self, inc) -> None:
        """Bump the fast-path / rebuild counters from the increment the
        classifier just recorded; fast-path increments additionally
        export the DELTA-program plane (per-delta compile seconds +
        delta-program registry hit/miss counts — the steady-state
        "compile-free increments" dashboards) and stamp the delta
        bucket signature onto the request's active classify span."""
        if not inc.history:
            return
        rec = inc.history[-1]
        path = rec.get("path")
        span = obs_trace.active_span()
        if span is not None and path is not None:
            span.set_attr("increment.path", path)
            if rec.get("delta_signature"):
                span.set_attr("delta.bucket", rec["delta_signature"])
                span.set_attr(
                    "delta.program_cache_hit",
                    bool(rec.get("program_cache_hit")),
                )
        if span is not None and rec.get("cohort_size"):
            span.set_attr("cohort.size", rec["cohort_size"])
            span.set_attr(
                "cohort.dispatches", rec.get("cohort_dispatches", 0)
            )
        if self.metrics is None:
            return
        if path in ("fast", "cohort"):
            if path == "cohort":
                # the cohort path IS the fast path (base program
                # reused, bucketed delta programs) executed jointly —
                # both counters move so the fast-path ratio dashboards
                # keep reading correctly
                self._count("distel_cohort_deltas_total")
            self._count("distel_deltas_fast_path_total")
            n = rec.get("delta_programs", 0)
            if n:
                hits = rec.get("delta_program_hits", 0)
                if hits:
                    self.metrics.counter_inc(
                        "distel_delta_program_cache_hits_total",
                        value=hits,
                    )
                if n - hits:
                    self.metrics.counter_inc(
                        "distel_delta_program_cache_misses_total",
                        value=n - hits,
                    )
            st = inc.last_compile
            if st is not None:
                self.metrics.observe(
                    "distel_delta_compile_seconds",
                    st.compile_s + st.trace_lower_s,
                )
        elif path == "rebuild":
            self._count("distel_saturation_rebuilds_total")
        self._note_compile(inc.last_compile)

    def _note_compile(self, st) -> None:
        """Export one increment's program-build telemetry
        (``CompileStats``): compile seconds, in-process program-registry
        hit/miss, persistent disk-cache hits — the counters the warmup
        precompile moves and the cold-start dashboards watch."""
        if st is None or self.metrics is None:
            return
        build_s = st.compile_s + st.trace_lower_s
        if build_s or st.program_cache_hit:
            self.metrics.observe("distel_compile_seconds", build_s)
        if st.program_cache_hit:
            self._count("distel_program_cache_hits_total")
        elif st.compile_s:
            self._count("distel_program_cache_misses_total")
        if st.persistent_cache_hits:
            self.metrics.counter_inc(
                "distel_persistent_cache_hits_total",
                value=st.persistent_cache_hits,
            )
