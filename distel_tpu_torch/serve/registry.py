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
* The warm view :meth:`OntologyRegistry._warm_result` wraps the
  demoted host state in the port's ``SaturationResult``, whose packed
  closure is a torch tensor.
* ``inc.last_compile`` is the port's program-build record (bucketed
  engines' ``CompileStats``: table build and CUDA-graph capture
  seconds, registry hits, the kernel libraries a build loaded), exported
  as the reference's compile, program-cache and persistent-cache
  counters.
* The memory budget counts the bytes the program registry holds on the
  registry's device (``core/bucketing.program_bytes``: the programs'
  tables and graph pools and each layout's state pair) beside the
  tenants' closures: programs outlive the tenants that built them.
  Over the budget, programs no live engine uses go first
  (``core/bucketing.drop_idle_programs``), then tenants; a tenant's
  eviction leaves its programs idle when no other tenant shares them,
  and the next pass drops them.
* A tenant that leaves the card (export, eviction, a failed load or
  adopt) frees its cached blocks on the card at once
  (:meth:`OntologyRegistry._release_card`): other replica processes
  share the card, and PyTorch's caching allocator would otherwise keep
  them reserved for this one.
* On a mesh (``mesh.devices`` or the coordinator keys) the registry is
  rank 0's, and every tenant's classifier shards over the mesh.  Every
  operation that touches the card or runs a collective — load, delta,
  retract, the promotion or restore behind :meth:`_resident`, demotion,
  spill, the idle-program drop — goes through the op stream
  (``serve/mesh_ops.py``): published to every other rank, whose
  follower registry (``follower=True``: no budget, no snapshot store)
  applies it in order (:meth:`OntologyRegistry.apply`).  The decisions
  (victims, prefetch targets, warm shedding) are rank 0's, from its own
  bytes; the ranks hold symmetric windows.  The cold tier is the
  gathered snapshot rank 0 writes; the warm tier keeps each rank's own
  window in host memory.  Only rank 0 holds a snapshot store.  The
  cohort lane and the fleet's migration plane do not run on a mesh.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.obs import trace as obs_trace
from distel_tpu_torch.runtime.classifier import PhaseTimer, resolve_device
from distel_tpu_torch.serve.storage.tiers import TierTraffic


class UnknownOntology(KeyError):
    """No ontology registered under this id."""


class ColdSpillCorrupted(RuntimeError):
    """A cold spill failed its integrity checksum — the on-disk bytes
    are not the ones the registry wrote (bit rot, torn write, wrong
    file).  Restoring it would warm-start saturation from garbage and
    monotone EL+ would keep every wrong bit, so the restore refuses
    loudly instead."""


def _artifact_window():
    """Per-request artifact attribution: snapshot the process-global
    farm aggregate before the work, and stamp the per-tier hit delta
    onto the response record after — the scheduler serializes writes
    per ontology, so the window is attributable in practice even
    though the aggregate is global."""
    from distel_tpu_torch.core.artifacts import ARTIFACT_EVENTS

    before = ARTIFACT_EVENTS.snapshot()

    def close(rec: dict) -> dict:
        after = ARTIFACT_EVENTS.snapshot()
        delta = {
            k: after[k] - before[k] for k in ("exe_hits", "hlo_hits")
        }
        if any(delta.values()):
            rec["artifact_hits"] = delta
        return rec

    return close


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
        follower: bool = False,
        mesh_timeout_s: Optional[float] = None,
        mesh_report: Optional[str] = None,
    ):
        self.config = config or ClassifierConfig()
        #: the device every classifier of this registry runs on
        self.device = resolve_device(device)
        if memory_budget_bytes is not None and spill_dir is None:
            raise ValueError(
                "a memory budget needs a spill_dir to evict into"
            )
        #: rank 0's op stream on a mesh (``serve/mesh_ops.OpStream``:
        #: started here, spawning the other ranks under ``mesh.devices``
        #: alone), None off a mesh and on a follower, which applies the
        #: stream's records (:meth:`apply`).  ``mesh_timeout_s``: the
        #: group's collective timeout; ``mesh_report``: what each rank
        #: answers after a write (``mesh_ops.REPORTS``)
        self.ops = None
        self.follower = follower
        if not follower and (self.config.mesh_devices
                             or self.config.coordinator_address):
            from distel_tpu_torch.serve.mesh_ops import OpStream

            self.ops = OpStream.start(
                self.config, self.device,
                registry_kw={"spill_dir": spill_dir,
                             "fast_path_min_concepts": fast_path_min_concepts},
                timeout_s=mesh_timeout_s, report=mesh_report,
            )
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

    def _release_card(self) -> None:
        """Free a departed tenant's cached card memory.  A
        tenant leaves the card on export, eviction (warm or cold) and
        deletion; its tensors are unreferenced by then, but PyTorch's
        caching allocator keeps their blocks reserved for this process.
        Other replica processes share the card, and the budget above
        counts only this registry's tenants, so the cached blocks are
        released to the card (``torch.cuda.empty_cache``).  Decisions, answers, counters and
        events do not change."""
        if self.device.type == "cuda":
            import torch

            with torch.cuda.device(self.device):
                torch.cuda.empty_cache()

    # ------------------------------------------------------------ mesh

    def serial(self):
        """The mesh lock (``OpStream.lock``): every public operation
        takes it before any entry lock, so the ops it publishes run in
        one order on every rank.  Nothing off a mesh."""
        return self.ops.lock if self.ops is not None else contextlib.nullcontext()

    def _card(self, op: str, oid: Optional[str], args: tuple, fn):
        """``fn()`` — the card half of ``op`` — here, and on a mesh on
        every rank too (published through the op stream; a follower's
        :meth:`apply` runs the same code)."""
        if self.ops is None:
            return fn()
        from distel_tpu_torch.serve.mesh_ops import op_report

        return self.ops.run(
            op, oid, args, fn,
            report=lambda: op_report(self, op, oid, self.ops.report),
        )

    def apply(self, op: str, oid: Optional[str], args: tuple) -> None:
        """A follower's half of an op rank 0 published: the same card
        work, on this rank's windows (its budget logic never runs:
        rank 0's decisions arrive as ops)."""
        if op == "load":
            self.load(oid, *args)
        elif op == "delta":
            self.delta(oid, *args)
        elif op == "retract":
            self.retract(oid, *args)
        elif op == "drop_programs":
            self._drop_idle_programs()
        elif op in ("resident", "demote", "spill"):
            entry = self._entry(oid)
            with entry.lock:
                if op == "resident":
                    self._promote_or_restore(entry)
                elif op == "demote":
                    self._demote_warm(entry)
                else:
                    self._spill(entry)
            self._release_card()
        else:
            raise ValueError(f"unknown op of the serve mesh: {op!r}")

    def close(self) -> Optional[List[dict]]:
        """Leave the mesh: publish ``close``, wait for every other rank
        to exit (``OpStream.close``) and return each rank's record (its
        collectives, launches, peak card bytes, op walls).  None off a
        mesh."""
        if self.ops is None:
            return None
        return self.ops.close(self.device)

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
        art = _artifact_window()

        def card():
            inc = self._new_inc()
            result = inc.add_text(text)
            entry.inc = inc
            entry.texts.append(text)
            entry.resident_bytes = _state_bytes(inc)
            entry.last_used = time.monotonic()
            return inc, result

        try:
            with self.serial(), entry.lock:
                inc, result = self._card("load", oid, (text,), card)
                version = self._publish(oid, inc)
        except BaseException:
            # a failed load must not leave a zombie id behind (listed by
            # /healthz, un-restorable, growing the map on every retry)
            with self._lock:
                self._entries.pop(oid, None)
            self._release_card()
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
        return art(rec)

    def delta(self, oid: str, texts: List[str]) -> dict:
        """Apply one or more delta texts as ONE increment (the
        scheduler's batching path: deltas are order-dependent per
        ontology, and a coalesced batch saturates once — monotone EL+
        makes the merged batch's closure identical to applying them in
        sequence)."""
        from distel_tpu_torch.owl import loader as owl_loader

        entry = self._entry(oid)
        art = _artifact_window()
        with self.serial(), entry.lock:
            self._check_live(entry)
            inc = self._resident(entry)
            text = "\n".join(texts)

            def card():
                # parse FIRST (the common failure, and it mutates
                # nothing), then record the text BEFORE saturating:
                # add_ontology merges the batch into the accumulated
                # corpus up front, so if the saturation itself fails the
                # classifier has still ingested the axioms (the next
                # successful increment derives them) — texts must agree
                # with the corpus or a later spill/restore would
                # silently replay a smaller ontology than the one the
                # closure answers for
                onto = owl_loader.load(text)
                entry.texts.append(text)
                inc.add_ontology(onto, source_text=text)

            self._card("delta", oid, (list(texts),), card)
            rec = self._commit_delta(oid, entry, inc, len(texts))
        self.traffic.note_write(oid)
        self._note_path(inc)
        self._maybe_evict(keep=oid)
        return art(rec)

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
        with self.serial(), entry.lock:
            self._check_live(entry)
            inc = self._resident(entry)

            def card():
                with obs_trace.child_span(
                    "registry.retract", {"oid": oid}
                ):
                    inc.retract(text)

            try:
                self._card("retract", oid, (text,), card)
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
            or base.mesh is not None
            or not getattr(base, "_bucket", False)
        ):
            return None
        return base.bucket_signature

    def delta_cohort(self, items: List) -> Dict[str, object]:
        """Apply one delta increment per ontology, advancing every
        cohort-compatible member under shared batched step programs
        (``core/cohort.py``) — one run of a cohort program per joint
        vote instead of one per tenant.  ``items``: ``(oid, texts)``
        pairs, each member one increment (the scheduler's per-lane
        coalescing already merged its texts).  Returns ``{oid: record |
        BaseException}`` — per-member failures (parse errors, unknown
        ids) never poison the cohort, and members whose plans cannot
        share a roster fall back to inline execution with the same
        records a solo :meth:`delta` would produce.

        Locking: every member's entry lock is acquired in SORTED oid
        order (two concurrent cohorts can never deadlock), and eviction
        is deferred to the end, outside the locks — the solo path's
        promote-time eviction could otherwise pick a co-held member as
        its victim and demote a classifier mid-cohort."""
        from distel_tpu_torch.core import cohort as cohort_mod
        from distel_tpu_torch.owl import loader as owl_loader

        self._refuse_mesh("the cohort lane")
        out: Dict[str, object] = {}
        entries = []
        for oid, texts in items:
            try:
                entries.append((oid, list(texts), self._entry(oid)))
            except UnknownOntology as e:
                out[oid] = e
        entries.sort(key=lambda t: t[0])
        acquired = []
        committed = []  # (oid, entry, inc) — publish/record done inside
        try:
            for _oid, _texts, entry in entries:
                entry.lock.acquire()
                acquired.append(entry)
            planned = []  # (oid, entry, inc, plan, batch, idx, n_texts)
            solo = []
            for oid, texts, entry in entries:
                try:
                    self._check_live(entry)
                    inc = self._resident(entry, evict=False)
                    text = "\n".join(texts)
                    # parse FIRST, record the text BEFORE saturating —
                    # the solo delta path's ingestion contract
                    onto = owl_loader.load(text)
                    entry.texts.append(text)
                    inc.last_compile = None
                    inc.last_delta_stats = None
                    inc.timer = PhaseTimer(inc.device)
                    with inc.timer.phase("ingest"):
                        idx, batch = inc._ingest(onto, source_text=text)
                    with inc.timer.phase("plan"):
                        plan = inc._delta_fast_plan(idx, cohort_shape=True)
                    rec = (oid, entry, inc, plan, batch, idx, len(texts))
                    if plan is not None and cohort_mod.delta_cohort_ready(
                        inc, plan
                    ):
                        planned.append(rec)
                    else:
                        solo.append(rec)
                except BaseException as e:  # noqa: BLE001 — per-member
                    out[oid] = e
            groups: Dict[tuple, List] = {}
            for rec in planned:
                groups.setdefault(rec[3].roster_key(), []).append(rec)
            # a group that does not fit the card (or the budget) splits
            # in halves down the rung ladder; a lone member runs solo
            pending = list(groups.values())
            while pending:
                grp = pending.pop()
                if len(grp) < 2:
                    solo.extend(grp)
                    continue
                if not self._run_cohort(grp, out, committed):
                    half = cohort_mod.cohort_rung(len(grp)) // 2
                    pending += [grp[i:i + half]
                                for i in range(0, len(grp), half)]
            for oid, entry, inc, plan, batch, idx, n in solo:
                try:
                    self._count("distel_cohort_fallback_total")
                    with inc.timer.phase("saturate"):
                        if plan is not None:
                            res = inc._execute_delta_plan(plan)
                            path = "fast"
                        else:
                            res = inc._full_rebuild(idx)
                            path = "rebuild"
                    inc._finish_increment(batch, res, path)
                    out[oid] = self._commit_delta(oid, entry, inc, n)
                    committed.append((oid, entry, inc))
                except BaseException as e:  # noqa: BLE001
                    out[oid] = e
        finally:
            for entry in reversed(acquired):
                entry.lock.release()
        for oid, _entry, inc in committed:
            self.traffic.note_write(oid)
            self._note_path(inc)
        self._maybe_evict()
        return out

    def _run_cohort(self, grp, out, committed) -> bool:
        """One cohort over ``grp``'s planned members (their entry locks
        held): executed, each member committed into ``out`` and
        ``committed``.  False when it does not fit (no state moved, its
        idle programs dropped); a failure is every member's answer."""
        from distel_tpu_torch.core import cohort as cohort_mod

        def spare():
            if self.memory_budget_bytes is None:
                return None
            return self.memory_budget_bytes - (self.resident_bytes()
                                               + self._program_bytes())

        fits = True
        try:
            timer = grp[0][2].timer
            with timer.phase("saturate"):
                cohort_mod.execute_delta_cohort(
                    [(inc, plan, batch)
                     for (_o, _e, inc, plan, batch, _i, _n) in grp],
                    spare_bytes=spare,
                )
            for member in grp[1:]:  # one joint run, every member's
                member[2].timer.phases["saturate"] = timer.phases["saturate"]
            self._count("distel_cohort_formed_total")
            for oid, entry, inc, _plan, _batch, _idx, n in grp:
                out[oid] = self._commit_delta(oid, entry, inc, n)
                committed.append((oid, entry, inc))
        except cohort_mod.CohortDoesNotFit:
            fits = False
        except BaseException as e:  # noqa: BLE001
            # a failed joint run replaces no member's closure: each
            # keeps its pre-delta state with its axioms ingested, which
            # its next increment derives — every member gets the error
            for oid, *_rest in grp:
                out[oid] = e
        if not fits:
            self._drop_idle_programs()
        return fits

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
        with self.serial(), entry.lock:
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
        self._refuse_mesh("the serve fleet (export)")
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
        self._release_card()
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
        self._refuse_mesh("the serve fleet (adopt)")
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
            self._release_card()
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
        so an inline eviction could demote a co-held member.  On a mesh
        the promotion or restore is one op of the stream, and the
        eviction sweep publishes its own after it."""
        if entry.inc is not None:
            return entry.inc
        inc = self._card("resident", entry.oid, (),
                         lambda: self._promote_or_restore(entry))
        if evict:
            self._maybe_evict(keep=entry.oid)
        return inc

    def _promote_or_restore(self, entry: _Entry):
        """The card half of :meth:`_resident`.  Caller holds
        ``entry.lock``."""
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

        s, r = inc.warm_closure()
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
        ``entry.lock``.  On a mesh every rank runs it: rank 0 writes the
        gathered closure and its sidecar, and a follower keeps the path
        (its restore verifies against the sidecar)."""
        if entry.inc is None and entry.warm_inc is None:
            return entry.spill_path
        path = self._spill_path(entry.oid)
        compressed = bool(self.config.storage_compress_spills)
        t0 = time.monotonic()
        if entry.inc is not None:
            entry.inc.snapshot(path, compressed=compressed)
        else:
            entry.warm_inc.snapshot(
                path, compressed=compressed,
                result=self._warm_result(entry.warm_inc),
            )
        sha = None
        if not self.follower:
            sha = _file_sha256(path)
            with open(path + ".sha256", "w") as f:
                f.write(sha + "\n")
            entry.cold_bytes = os.path.getsize(path)
        entry.spill_path = path
        entry.spill_sha = sha
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
        with self.serial():
            self._evict_to_budget(keep)

    def _evict_to_budget(self, keep: Optional[str]) -> None:
        while True:
            with self._lock:
                # total counts EVERY resident closure (keep included);
                # keep is only exempt from victim selection
                total = sum(
                    e.resident_bytes
                    for e in self._entries.values()
                    if e.inc is not None
                ) + self._program_bytes()
                victims = [
                    e
                    for e in self._entries.values()
                    if e.inc is not None and e.oid != keep
                ]
            if total <= self.memory_budget_bytes:
                break
            if self._drop_idle_programs():
                continue
            if not victims:
                break
            victim = self._pick_victim(victims)
            if not victim.lock.acquire(blocking=False):
                return  # busy: let the in-flight request finish first
            try:
                if victim.inc is None:
                    continue  # raced with another evictor
                bytes_freed = victim.resident_bytes
                if self.warm_budget_bytes > 0:
                    self._card("demote", victim.oid, (),
                               lambda: self._demote_warm(victim))
                else:
                    self._card("spill", victim.oid, (),
                               lambda: self._spill(victim))
                self._release_card()
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

    def _program_bytes(self) -> int:
        """Bytes the program registry holds on this registry's device."""
        from distel_tpu_torch.core.bucketing import program_bytes

        return program_bytes(self.device)

    def _drop_idle_programs(self) -> int:
        """Evict the registry's programs no live engine uses; their card
        blocks go back at once (on a mesh, on every rank)."""
        from distel_tpu_torch.core.bucketing import drop_idle_programs

        def card():
            n = drop_idle_programs(self.device)
            if n:
                self._release_card()
            return n

        if self.ops is not None and self._program_bytes() == 0:
            return 0  # the ranks hold the same programs: none to drop
        return self._card("drop_programs", None, (), card)

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
        with self.serial():
            self._shed_to_budget(keep)

    def _shed_to_budget(self, keep: Optional[str]) -> None:
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
                self._card("spill", victim.oid, (),
                           lambda: self._spill(victim))
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
        with self.serial():
            return self._prefetch()

    def _prefetch(self) -> Optional[str]:
        with self._lock:
            hot_total = sum(
                e.resident_bytes
                for e in self._entries.values()
                if e.inc is not None
            ) + self._program_bytes()
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
            with self.serial(), entry.lock:
                if entry.inc is None and entry.warm_inc is None:
                    continue
                paths.append(self._card("spill", entry.oid, (),
                                        lambda: self._spill(entry)))
                self._count("distel_registry_shutdown_spills_total")
                self._event(
                    "registry_shutdown_spill",
                    oid=entry.oid,
                    spill=entry.spill_path,
                )
        return paths

    def _refuse_mesh(self, plane: str) -> None:
        """The planes that do not run on a mesh refuse it by name."""
        if self.ops is not None or self.follower:
            from distel_tpu_torch.parallel.mesh import refuse_mesh

            refuse_mesh(self.config, plane)

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
