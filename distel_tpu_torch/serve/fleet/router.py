"""The fleet router: the one address clients talk to.

A thin, state-light tier in front of N shared-nothing replica processes
(the jax analog of the reference's cluster config + work stealer):

* **affinity placement** — every ontology pins to one replica (its warm
  bucket programs and device-resident closure live there); new loads
  land on the least-loaded healthy replica and the router mints the
  fleet-wide ids (replica-local counters would collide);
* **live migration** — admin- or rebalance-triggered: the router holds
  new requests for the ontology, waits out the in-flight ones, drives
  the source replica's ``/fleet/migrate`` (spill via the registry's
  checkpoint ``.npz`` wire) and the target's ``/fleet/adopt`` (restore),
  then releases the held requests at the new placement.  No request is
  dropped and answers are byte-identical regardless of placement;
* **health / eject-and-respawn** — a heartbeat thread polls every
  replica's ``/healthz``; past ``eject_failures`` consecutive misses the
  replica is ejected, the supervisor (when attached) respawns it, and
  the stranded ontologies are re-placed onto healthy replicas by
  replaying the router's text journal (the crash path has no spill to
  restore from — monotone EL+ makes the replayed closure identical);
* **queue-depth rebalance** — when one replica's scheduler depth
  diverges from the coolest replica's past ``depth_divergence``, the
  rebalance thread migrates the hot replica's least-recently-touched
  ontology to the cool one (work following state, the work-stealing
  analog);
* **aggregated /metrics** — every replica's page re-exported under a
  ``replica="<rid>"`` label next to the router's own counters.

The router holds no closure state: only the placement table and the
append-only text journal (what the reference keeps in its cluster
config + the axiom store).  It reuses :func:`serve.server.make_server`
— ``RouterApp`` satisfies the same ``dispatch``/``metrics`` surface as
``ServeApp``.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

from distel_tpu_torch.obs import trace as obs_trace
from distel_tpu_torch.obs.flight import FlightRecorder
from distel_tpu_torch.obs.trace import SpanRecorder
from distel_tpu_torch.serve.fleet.placement import (
    NoHealthyReplica,
    PlacementTable,
    ReplicaState,
)
from distel_tpu_torch.serve.metrics import Metrics, aggregate_expositions
from distel_tpu_torch.serve.server import (
    HTTPError,
    _dumps,
    _json_doc,
    debug_events_response,
    debug_trace_response,
    endpoint_label,
    match_route,
)

_ROUTES = (
    ("POST", re.compile(r"^/v1/ontologies/?$"), "load",
     "/v1/ontologies"),
    ("POST", re.compile(r"^/v1/ontologies/([^/]+)/deltas/?$"), "delta",
     "/v1/ontologies/{id}/deltas"),
    ("POST", re.compile(r"^/v1/ontologies/([^/]+)/retract/?$"), "retract",
     "/v1/ontologies/{id}/retract"),
    ("GET", re.compile(r"^/v1/ontologies/([^/]+)/subsumers/?$"),
     "proxy", "/v1/ontologies/{id}/subsumers"),
    ("GET", re.compile(r"^/v1/ontologies/([^/]+)/taxonomy/?$"),
     "proxy", "/v1/ontologies/{id}/taxonomy"),
    # snapshot reads fan out over the ontology's READ SET (primary +
    # adopted read replicas) — writes keep strict affinity
    ("GET",
     re.compile(
         r"^/v1/ontologies/([^/]+)/query/"
         r"(subsumed|subsumers|slice|version)/?$"
     ),
     "read", "/v1/ontologies/{id}/query/*"),
    ("GET", re.compile(r"^/healthz/?$"), "healthz", "/healthz"),
    ("GET", re.compile(r"^/metrics/?$"), "metrics", "/metrics"),
    ("POST", re.compile(r"^/fleet/migrate/?$"), "migrate",
     "/fleet/migrate"),
    ("POST", re.compile(r"^/fleet/replicate/?$"), "replicate",
     "/fleet/replicate"),
    ("GET", re.compile(r"^/fleet/status/?$"), "status", "/fleet/status"),
    ("GET", re.compile(r"^/debug/trace/?$"), "debug_trace",
     "/debug/trace"),
    ("GET", re.compile(r"^/debug/events/?$"), "debug_events",
     "/debug/events"),
)


class RouterApp:
    #: per-request series names the shared HTTP handler records under —
    #: distinct from the replica families the aggregated /metrics
    #: re-exports, so one scrape never sees a family twice
    REQUEST_METRIC = "distel_router_requests_total"
    REQUEST_SECONDS_METRIC = "distel_router_request_seconds"

    def __init__(
        self,
        replicas: List[Tuple[str, str]],
        *,
        supervisor=None,
        depth_divergence: int = 8,
        heartbeat_interval_s: float = 1.0,
        heartbeat_probe_timeout_s: float = 5.0,
        eject_failures: int = 3,
        rebalance_interval_s: float = 2.0,
        migration_hold_timeout_s: float = 120.0,
        proxy_timeout_s: float = 600.0,
        config=None,
    ):
        """``replicas``: ``[(rid, base_url), ...]`` — a static fleet
        (tests, external process manager); with a ``supervisor``
        (:class:`~distel_tpu.serve.fleet.supervisor.ReplicaSupervisor`)
        ejected replicas are respawned and re-registered.

        ``config``: an optional ``ClassifierConfig`` — only its
        ``obs_*`` knobs are read here (trace sampling/ring sizes; the
        replica-side knobs ride the replica processes' own configs)."""
        from distel_tpu_torch.config import ClassifierConfig

        cfg = config or ClassifierConfig()
        self.supervisor = supervisor
        #: request tracing (spans served by /debug/trace, stitched with
        #: the replicas' by trace_id) + the fleet flight recorder (the
        #: causal control-plane record served by /debug/events)
        self.tracer = SpanRecorder(
            service="router", **cfg.tracer_kwargs()
        )
        self.flight = FlightRecorder(
            capacity=cfg.obs_flight_capacity, service="router"
        )
        self.table = PlacementTable(depth_divergence=depth_divergence)
        for rid, url in replicas:
            self.table.add_replica(rid, url)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_probe_timeout_s = heartbeat_probe_timeout_s
        self.eject_failures = eject_failures
        self.rebalance_interval_s = rebalance_interval_s
        self.migration_hold_timeout_s = migration_hold_timeout_s
        self.proxy_timeout_s = proxy_timeout_s
        self.metrics = Metrics()
        self.started = time.time()
        self._seq = 0
        self._seq_lock = threading.Lock()
        #: oid → applied texts, in order (load first) — the replay
        #: source for crash recovery; appended only after the replica
        #: acknowledged the write
        self._journal: Dict[str, List[str]] = {}
        self._journal_lock = threading.Lock()
        # migration holds: requests for a migrating oid wait on the
        # condition instead of racing the handoff
        self._cv = threading.Condition()
        self._inflight: Dict[str, int] = {}
        self._migrating: set = set()
        # read fan-out: oid → replica ids holding an adopted READ-ONLY
        # snapshot (the primary is always implicitly in the read set);
        # a plain round-robin tick spreads reads across the set
        self._read_lock = threading.Lock()
        self._read_placement: Dict[str, List[str]] = {}
        self._read_rr: Dict[str, int] = {}
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        for name, help_text in (
            ("distel_router_requests_total",
             "router requests by endpoint and code"),
            ("distel_fleet_migrations_total",
             "live ontology migrations completed"),
            ("distel_fleet_migration_failures_total",
             "migrations that failed and rolled back"),
            ("distel_fleet_ejections_total",
             "replicas ejected after consecutive heartbeat failures"),
            ("distel_fleet_recoveries_total",
             "ontologies re-placed by journal replay after an ejection"),
            ("distel_router_proxy_errors_total",
             "requests that failed against an unreachable replica"),
            ("distel_router_reads_total",
             "snapshot reads routed, by target (primary vs read "
             "replica)"),
            ("distel_router_read_fallbacks_total",
             "fanned-out reads retried on the primary after a read "
             "replica answered 404/412/5xx"),
            ("distel_fleet_replications_total",
             "read-snapshot replications driven to a peer replica"),
        ):
            self.metrics.describe(name, help_text)
        self.metrics.describe(
            "distel_fleet_replicas_healthy", "healthy replicas"
        )
        self.metrics.gauge_fn(
            "distel_fleet_replicas_healthy",
            lambda: len(self.table.healthy_replicas()),
        )
        self.metrics.describe(
            "distel_fleet_ontologies", "ontologies placed on the fleet"
        )
        self.metrics.gauge_fn(
            "distel_fleet_ontologies",
            lambda: len(self.table.stats()["placement"]),
        )

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Start the heartbeat + rebalance threads (separate from
        construction so tests can drive the loops by hand)."""
        for target, name in (
            (self._heartbeat_loop, "distel-fleet-heartbeat"),
            (self._rebalance_loop, "distel-fleet-rebalance"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        for t in list(self._threads):
            t.join(timeout=10)

    # ------------------------------------------------------ id / journal

    def _new_id(self) -> str:
        with self._seq_lock:
            self._seq += 1
            return f"ont-{self._seq:04d}"

    def _journal_append(self, oid: str, text) -> None:
        """``text``: a plain add text, or a retraction op marker
        (``{"op": "retract", "text": ...}``) — the journal is an op
        log, replayed in order by adopt-from-journal recovery."""
        with self._journal_lock:
            self._journal.setdefault(oid, []).append(text)

    def _journal_texts(self, oid: str) -> List[str]:
        with self._journal_lock:
            return list(self._journal.get(oid, ()))

    # ----------------------------------------------------------- holds

    def _enter(self, oid: str) -> None:
        """Block while ``oid`` is migrating, then count this request
        in-flight (the migration path waits for the count to drain)."""
        deadline = time.monotonic() + self.migration_hold_timeout_s
        with self._cv:
            while oid in self._migrating:
                left = deadline - time.monotonic()
                if left <= 0 or self._stop.is_set():
                    raise HTTPError(
                        503, f"migration of {oid!r} outlasted the hold",
                        {"Retry-After": "1"},
                    )
                self._cv.wait(timeout=min(left, 1.0))
            self._inflight[oid] = self._inflight.get(oid, 0) + 1

    def _leave(self, oid: str) -> None:
        with self._cv:
            n = self._inflight.get(oid, 1) - 1
            if n <= 0:
                self._inflight.pop(oid, None)
            else:
                self._inflight[oid] = n
            self._cv.notify_all()

    # ------------------------------------------------------------ proxy

    def _forward(
        self,
        replica: ReplicaState,
        method: str,
        path: str,
        body: Optional[bytes],
        deadline_s: Optional[float],
    ):
        """One hop to a replica.  Non-2xx replica answers proxy through
        verbatim (they are the contract: 429/503/404 mean what they
        mean); transport failures mark the replica and answer 502."""
        req = urllib.request.Request(
            replica.url + path, data=body, method=method
        )
        if body is not None:
            req.add_header("Content-Type", "application/json")
        if deadline_s is not None:
            req.add_header("X-Distel-Deadline-S", str(deadline_s))
        timeout = (
            min(self.proxy_timeout_s, deadline_s + 5.0)
            if deadline_s is not None
            else self.proxy_timeout_s
        )
        with obs_trace.child_span(
            f"forward {replica.rid}",
            {"replica": replica.rid, "method": method, "path": path},
        ):
            # propagate the trace context FROM INSIDE the forward span
            # (now the active one) so the replica's server span parents
            # on this hop, not on the router's http span
            ctx = obs_trace.current_context()
            if ctx is not None:
                req.add_header(
                    obs_trace.TRACEPARENT_HEADER, ctx.to_traceparent()
                )
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return (
                        resp.status,
                        resp.headers.get(
                            "Content-Type", "application/json"
                        ),
                        resp.read(),
                    )
            except urllib.error.HTTPError as e:
                payload = e.read()
                raise HTTPError(
                    e.code,
                    _error_message(payload),
                    {k: v for k, v in e.headers.items()
                     if k.lower() == "retry-after"},
                )
            except (urllib.error.URLError, OSError, TimeoutError) as e:
                replica.note_failure()
                self.metrics.counter_inc(
                    "distel_router_proxy_errors_total"
                )
                raise HTTPError(
                    502, f"replica {replica.rid} unreachable: {e}"
                )

    # ------------------------------------------------------- HTTP plane

    def _endpoint_label(self, path: str) -> str:
        return endpoint_label(_ROUTES, path)

    def dispatch(self, method: str, path: str, query: dict, body: bytes,
                 deadline_s: Optional[float]):
        name, groups = match_route(_ROUTES, method, path)
        handler = getattr(self, f"_ep_{name}")
        return handler(*groups, query=query, body=body,
                       deadline_s=deadline_s, path=path)

    def _ep_load(self, *, query, body, deadline_s, path):
        doc = _json_doc(body)
        text = doc.get("text")
        if not isinstance(text, str) or not text.strip():
            raise HTTPError(400, 'body must be {"text": "<axioms>"}')
        oid = self._new_id()
        try:
            replica = self.table.place(oid)
        except NoHealthyReplica as e:
            raise HTTPError(503, str(e), {"Retry-After": "1"})
        self._enter(oid)
        try:
            payload = json.dumps({"id": oid, "text": text}).encode("utf-8")
            status, ctype, out = self._forward(
                replica, "POST", "/fleet/load", payload, deadline_s
            )
        except BaseException:
            self.table.drop(oid)
            raise
        finally:
            self._leave(oid)
        self._journal_append(oid, text)
        return status, ctype, out

    def _ep_delta(self, oid, *, query, body, deadline_s, path):
        doc = _json_doc(body)
        text = doc.get("text")
        if not isinstance(text, str) or not text.strip():
            raise HTTPError(400, 'body must be {"text": "<axioms>"}')
        status, ctype, out = self._proxy_oid(
            oid, "POST", path, body, deadline_s
        )
        self._journal_append(oid, text)
        return status, ctype, out

    def _ep_retract(self, oid, *, query, body, deadline_s, path):
        doc = _json_doc(body)
        text = doc.get("text")
        if not isinstance(text, str) or not text.strip():
            raise HTTPError(400, 'body must be {"text": "<axioms>"}')
        status, ctype, out = self._proxy_oid(
            oid, "POST", path, body, deadline_s
        )
        # journal the retraction as an op marker: crash-recovery replay
        # (adopt from journal) applies the log in order, so the retract
        # resolves against the adds before it
        self._journal_append(oid, {"op": "retract", "text": text})
        return status, ctype, out

    def _ep_proxy(self, oid, *, query, body, deadline_s, path):
        from urllib.parse import quote

        qs = "&".join(
            f"{k}={quote(str(v))}" for k, v in query.items()
        )
        full = path + ("?" + qs if qs else "")
        return self._proxy_oid(oid, "GET", full, None, deadline_s)

    def _proxy_oid(self, oid, method, path, body, deadline_s):
        self._enter(oid)
        try:
            replica = self.table.lookup(oid)
            if replica is None:
                raise HTTPError(404, f"unknown ontology {oid!r}")
            return self._forward(replica, method, path, body, deadline_s)
        finally:
            self._leave(oid)

    # ---------------------------------------------------- read fan-out

    def _read_set(self, oid: str, primary: ReplicaState
                  ) -> List[ReplicaState]:
        """Primary first, then every healthy read replica holding an
        adopted snapshot for ``oid``."""
        with self._read_lock:
            rids = list(self._read_placement.get(oid, ()))
        out = [primary]
        for rid in rids:
            try:
                st = self.table.replica(rid)
            except KeyError:
                continue
            if st.healthy and st.rid != primary.rid:
                out.append(st)
        return out

    def _ep_read(self, oid, op, *, query, body, deadline_s, path):
        """Fan a snapshot read out over the ontology's read set
        (round-robin).  A read replica that answers 404 (no snapshot),
        412 (lagging the caller's min_version watermark) or 5xx falls
        back to the primary — the caller sees one monotonic read
        stream, never the replica's lag.  Reads respect migration
        holds (``_enter``), so zero reads fail across a handoff."""
        from urllib.parse import quote

        qs = "&".join(
            f"{k}={quote(str(v))}" for k, v in query.items()
        )
        full = path + ("?" + qs if qs else "")
        self._enter(oid)
        try:
            primary = self.table.lookup(oid)
            if primary is None:
                raise HTTPError(404, f"unknown ontology {oid!r}")
            cands = self._read_set(oid, primary)
            with self._read_lock:
                tick = self._read_rr[oid] = (
                    self._read_rr.get(oid, 0) + 1
                )
            target = cands[tick % len(cands)]
            if target is not primary:
                try:
                    out = self._forward(
                        target, "GET", full, None, deadline_s
                    )
                    self.metrics.counter_inc(
                        "distel_router_reads_total",
                        {"target": "replica"},
                    )
                    return out
                except HTTPError as e:
                    if e.status not in (404, 412, 502, 503):
                        raise
                    self.metrics.counter_inc(
                        "distel_router_read_fallbacks_total"
                    )
            out = self._forward(primary, "GET", full, None, deadline_s)
            self.metrics.counter_inc(
                "distel_router_reads_total", {"target": "primary"}
            )
            return out
        finally:
            self._leave(oid)

    def _ep_replicate(self, *, query, body, deadline_s, path):
        doc = _json_doc(body)
        oid = doc.get("id")
        if not isinstance(oid, str) or not oid:
            raise HTTPError(400, "body needs \"id\"")
        rec = self.replicate(oid, dst_rid=doc.get("to"))
        return 200, "application/json", _dumps(rec)

    def replicate(self, oid: str, dst_rid: Optional[str] = None) -> dict:
        """Copy the ontology's current read snapshot onto a peer
        replica and add it to the read set — read QPS for the ontology
        then scales past its primary's capacity while writes keep
        strict affinity.  The copy is as-of NOW; later writes bump the
        primary's version and the replica serves the older version
        until the next replicate (lagging reads answer 412 against a
        caller watermark and fall back to the primary above)."""
        src = self.table.lookup(oid)
        if src is None:
            raise HTTPError(404, f"unknown ontology {oid!r}")
        dst = self._pick_destination(src, dst_rid)
        _, _, out = self._forward(
            src, "POST", "/fleet/snapshot",
            json.dumps({"id": oid}).encode("utf-8"), None,
        )
        rec = json.loads(out)
        try:
            self._forward(
                dst, "POST", "/fleet/adopt_snapshot",
                json.dumps(
                    {"id": oid, "path": rec["path"]}
                ).encode("utf-8"),
                None,
            )
        except HTTPError as e:
            if e.status != 409:
                raise
            # 409: the replica already holds this version or newer —
            # committed either way, keep it in the read set
        with self._read_lock:
            rids = self._read_placement.setdefault(oid, [])
            if dst.rid not in rids:
                rids.append(dst.rid)
        self.metrics.counter_inc("distel_fleet_replications_total")
        self.flight.record(
            "read_replicate", oid=oid, src=src.rid, dst=dst.rid,
            version=rec.get("version"),
        )
        return {
            "id": oid, "from": src.rid, "to": dst.rid,
            "version": rec.get("version"),
        }

    def _prune_read_replica(self, rid: str) -> None:
        """Drop a replica from every read set — its in-RAM snapshot
        store died with the process (ejection/respawn)."""
        with self._read_lock:
            for oid, rids in list(self._read_placement.items()):
                if rid in rids:
                    rids.remove(rid)
                if not rids:
                    self._read_placement.pop(oid, None)

    def _ep_healthz(self, *, query, body, deadline_s, path):
        stats = self.table.stats()
        doc = {
            "status": "ok" if self.table.healthy_replicas() else "degraded",
            "role": "router",
            "uptime_s": round(time.time() - self.started, 1),
            "replicas": stats["replicas"],
            "ontologies": stats["ontologies"],
            "migrating": sorted(self._migrating),
        }
        return 200, "application/json", _dumps(doc)

    def _fanout_get(self, path: str, parse):
        """Concurrent GET of ``path`` against every healthy replica
        with a short per-replica budget — a replica grinding an inline
        device program answers late, and serial waits would wedge the
        metrics/debug planes exactly when visibility matters most.
        ``parse(bytes)`` maps each body; a slow/dead/garbled replica is
        skipped, never fatal.  Returns ``[(rid, parsed), ...]``."""
        from concurrent.futures import ThreadPoolExecutor

        def fetch(st):
            try:
                req = urllib.request.Request(st.url + path)
                with urllib.request.urlopen(req, timeout=3) as resp:
                    return st.rid, parse(resp.read())
            except (urllib.error.URLError, OSError, TimeoutError,
                    ValueError):
                return st.rid, None

        live = self.table.healthy_replicas()
        if not live:
            return []
        with ThreadPoolExecutor(max_workers=len(live)) as pool:
            return [
                (rid, parsed)
                for rid, parsed in pool.map(fetch, live)
                if parsed is not None
            ]

    def _ep_metrics(self, *, query, body, deadline_s, path):
        pages = dict(
            self._fanout_get("/metrics", lambda b: b.decode("utf-8"))
        )
        text = self.metrics.render() + aggregate_expositions(pages)
        return 200, "text/plain; version=0.0.4", text.encode("utf-8")

    def _ep_status(self, *, query, body, deadline_s, path):
        with self._journal_lock:
            journal = {o: len(t) for o, t in self._journal.items()}
        doc = {
            **self.table.stats(),
            "journal_texts": journal,
            # the flight recorder's tail, inline — `cli fleet` and a
            # quick curl see the latest control-plane decisions without
            # a second round trip
            "recent_events": self.flight.events(limit=10),
        }
        return 200, "application/json", _dumps(doc)

    def _ep_debug_events(self, *, query, body, deadline_s, path):
        """Fleet flight-recorder events (``?kind=``, ``?rid=``,
        ``?oid=``, ``?limit=`` filters)."""
        return debug_events_response(
            self.flight, query, match_keys=("oid", "rid")
        )

    def _ep_debug_trace(self, *, query, body, deadline_s, path):
        """Recorded router spans; with ``?trace_id=`` the router also
        fetches that trace's spans from every healthy replica and
        STITCHES them into one view (they share the trace_id the
        traceparent header carried) — ``?stitch=0`` disables the
        fan-out, ``?format=chrome`` returns Perfetto-loadable Chrome
        trace-event JSON."""
        return debug_trace_response(
            self.tracer, query, stitch=self._replica_spans
        )

    def _replica_spans(self, trace_id: str) -> list:
        """Fetch one trace's spans from every healthy replica (same
        concurrent fan-out as the /metrics scrape)."""
        from urllib.parse import quote

        out = []
        for _rid, spans in self._fanout_get(
            "/debug/trace?trace_id=" + quote(trace_id),
            lambda b: json.loads(b).get("spans", []),
        ):
            out.extend(spans)
        return out

    def _ep_migrate(self, *, query, body, deadline_s, path):
        doc = _json_doc(body)
        oid = doc.get("id")
        if not isinstance(oid, str) or not oid:
            raise HTTPError(400, "body needs \"id\"")
        dst = doc.get("to")
        rec = self.migrate(oid, dst_rid=dst)
        return 200, "application/json", _dumps(rec)

    # -------------------------------------------------------- migration

    def migrate(self, oid: str, dst_rid: Optional[str] = None) -> dict:
        """Live-migrate one ontology.  Holds new requests, drains the
        in-flight ones, spills at the source, adopts at the target,
        re-pins, releases.  On an adopt failure the handoff record is
        re-adopted at the source (the spill file survives either way),
        so the ontology is never lost."""
        t0 = time.monotonic()
        with self._cv:
            if oid in self._migrating:
                raise HTTPError(409, f"{oid!r} is already migrating")
            src = self.table.lookup(oid)
            if src is None:
                raise HTTPError(404, f"unknown ontology {oid!r}")
            self._migrating.add(oid)
        self.flight.record("migrate_start", oid=oid, src=src.rid)
        try:
            # drain: every forwarded request for oid has returned
            deadline = time.monotonic() + self.migration_hold_timeout_s
            with self._cv:
                while self._inflight.get(oid, 0) > 0:
                    if time.monotonic() > deadline:
                        self.flight.record(
                            "migrate_failed", oid=oid, src=src.rid,
                            stage="drain",
                            error="in-flight requests never drained",
                        )
                        raise HTTPError(
                            503, f"in-flight requests for {oid!r} "
                            "never drained"
                        )
                    self._cv.wait(timeout=1.0)
            self.flight.record(
                "migrate_drain", oid=oid, src=src.rid,
                wall_s=round(time.monotonic() - t0, 4),
            )
            dst = self._pick_destination(src, dst_rid)
            # source: spill + deregister (rides the oid's scheduler
            # lane, so it serializes after everything already admitted)
            t_export = time.monotonic()
            try:
                _, _, out = self._forward(
                    src, "POST", "/fleet/migrate",
                    json.dumps({"id": oid}).encode("utf-8"), None,
                )
            except HTTPError as e:
                # a source that died under us: fall back to journal
                # replay onto a healthy replica (we hold the oid)
                self.flight.record(
                    "migrate_export_failed", oid=oid, src=src.rid,
                    error=str(e)[:200],
                )
                if not src.healthy and self._replay_onto_healthy(oid):
                    self.metrics.counter_inc(
                        "distel_fleet_recoveries_total"
                    )
                    self.flight.record(
                        "migrate_recovered", oid=oid, src=src.rid,
                        to=self.table.lookup(oid).rid,
                        wall_s=round(time.monotonic() - t0, 4),
                    )
                    return {
                        "id": oid,
                        "from": src.rid,
                        "to": self.table.lookup(oid).rid,
                        "recovered": True,
                        "wall_s": round(time.monotonic() - t0, 4),
                    }
                raise
            self.flight.record(
                "migrate_export", oid=oid, src=src.rid,
                wall_s=round(time.monotonic() - t_export, 4),
            )
            handoff = json.loads(out)
            adopt = json.dumps(
                {
                    "id": oid,
                    "texts": handoff["texts"],
                    "spill": handoff["spill"],
                    "warm": True,
                    # the source's last published snapshot version:
                    # seeds the target's version floor so client read
                    # watermarks survive the migration
                    "version": handoff.get("version"),
                    # in-band spill checksum: the adopting restore
                    # verifies even if the .sha256 sidecar got lost
                    "sha": handoff.get("sha"),
                }
            ).encode("utf-8")
            t_adopt = time.monotonic()
            try:
                self._forward(dst, "POST", "/fleet/adopt", adopt, None)
                self.flight.record(
                    "migrate_adopt", oid=oid, dst=dst.rid,
                    wall_s=round(time.monotonic() - t_adopt, 4),
                )
            except HTTPError as e:
                if e.status == 409:
                    # the destination already holds this id (a raced
                    # recovery replay landed first): its copy answers
                    # for the same acked corpus — commit to it and let
                    # the exported spill age out
                    self.flight.record(
                        "migrate_adopt", oid=oid, dst=dst.rid,
                        committed_409=True,
                        wall_s=round(time.monotonic() - t_adopt, 4),
                    )
                else:
                    # roll back: the spill restores at the source just
                    # as well — placement only commits on success
                    self.metrics.counter_inc(
                        "distel_fleet_migration_failures_total"
                    )
                    self.flight.record(
                        "migrate_adopt_failed", oid=oid, dst=dst.rid,
                        error=str(e)[:200],
                    )
                    try:
                        self._forward(
                            src, "POST", "/fleet/adopt", adopt, None
                        )
                        self.flight.record(
                            "migrate_rollback", oid=oid, src=src.rid
                        )
                    except HTTPError as rb:
                        # rollback refused too (src overloaded or gone):
                        # the oid is deregistered EVERYWHERE while the
                        # placement still points at src — journal
                        # replay is the remaining sound copy (we hold
                        # the oid's migration flag)
                        if rb.status == 409:
                            pass  # src still holds it after all
                        elif self._replay_onto_healthy(oid):
                            self.metrics.counter_inc(
                                "distel_fleet_recoveries_total"
                            )
                            self.flight.record(
                                "migrate_recovered", oid=oid,
                                src=src.rid,
                                to=self.table.lookup(oid).rid,
                                wall_s=round(
                                    time.monotonic() - t0, 4
                                ),
                            )
                            return {
                                "id": oid,
                                "from": src.rid,
                                "to": self.table.lookup(oid).rid,
                                "recovered": True,
                                "wall_s": round(
                                    time.monotonic() - t0, 4
                                ),
                            }
                        else:
                            raise
                    raise
            self.table.assign(oid, dst.rid)
            self.metrics.counter_inc("distel_fleet_migrations_total")
            wall_s = time.monotonic() - t0
            self.metrics.observe("distel_fleet_migration_seconds", wall_s)
            self.flight.record(
                "migrate_commit", oid=oid, src=src.rid, dst=dst.rid,
                wall_s=round(wall_s, 4),
            )
            return {
                "id": oid,
                "from": src.rid,
                "to": dst.rid,
                "wall_s": round(wall_s, 4),
            }
        finally:
            with self._cv:
                self._migrating.discard(oid)
                self._cv.notify_all()

    def _pick_destination(
        self, src: ReplicaState, dst_rid: Optional[str]
    ) -> ReplicaState:
        if dst_rid is not None:
            try:
                dst = self.table.replica(dst_rid)
            except KeyError:
                raise HTTPError(400, f"unknown replica {dst_rid!r}")
            if not dst.healthy:
                raise HTTPError(503, f"replica {dst_rid!r} is ejected")
            if dst.rid == src.rid:
                raise HTTPError(400, "source and destination coincide")
            return dst
        peers = [
            r for r in self.table.healthy_replicas() if r.rid != src.rid
        ]
        if not peers:
            raise HTTPError(503, "no healthy destination replica")
        return min(peers, key=lambda r: (r.queue_depth, r.resident, r.rid))

    # ----------------------------------------------- heartbeat / recovery

    def heartbeat_once(self) -> None:
        """One health sweep (the loop calls this; tests call it
        directly).

        Ejection distinguishes DEAD from BUSY: connection
        refused/reset (nothing listening) ejects after
        ``eject_failures`` consecutive misses, but probe TIMEOUTS
        alone never do — a replica grinding a long inline device
        program holds its GIL and answers /healthz late, and ejecting
        (then killing) it would destroy healthy warm state and
        un-acked work.  A truly wedged-but-listening process is
        surfaced by the supervisor's process liveness instead."""
        for st in self.table.replicas():
            if not st.healthy:
                continue
            was_f = st.consecutive_failures
            was_t = st.consecutive_timeouts
            try:
                req = urllib.request.Request(st.url + "/healthz")
                with urllib.request.urlopen(
                    req, timeout=self.heartbeat_probe_timeout_s
                ) as resp:
                    st.note_ok(json.loads(resp.read()))
            except (TimeoutError, ValueError):
                st.note_failure(timeout=True)
            except urllib.error.URLError as e:
                # urllib wraps socket.timeout in URLError.reason
                soft = isinstance(e.reason, TimeoutError)
                st.note_failure(timeout=soft)
            except OSError:
                st.note_failure()
            # flight-record the probe VERDICT transitions (not every ok
            # sweep): each miss with its busy-vs-dead reading, and the
            # recovery that reset a failure streak
            if st.consecutive_failures > was_f:
                self.flight.record(
                    "heartbeat_miss", rid=st.rid, verdict="dead",
                    consecutive=st.consecutive_failures,
                )
            elif st.consecutive_timeouts > was_t:
                self.flight.record(
                    "heartbeat_miss", rid=st.rid, verdict="busy",
                    consecutive=st.consecutive_timeouts,
                )
            elif was_f or was_t:
                self.flight.record(
                    "heartbeat_recovered", rid=st.rid,
                    after_failures=was_f, after_timeouts=was_t,
                )
            dead_process = (
                self.supervisor is not None
                and not self.supervisor.alive(st.rid)
            )
            if (
                st.consecutive_failures >= self.eject_failures
                or (dead_process and (st.consecutive_failures
                                      or st.consecutive_timeouts))
            ):
                self._eject(st)

    def _eject(self, st: ReplicaState) -> None:
        """Mark the replica out SYNCHRONOUSLY (no more placements or
        double-ejects), then respawn + journal-replay recovery on a
        worker thread — respawn waits out a jax import and a warm
        adopt re-classifies, and the heartbeat sweep must keep
        detecting OTHER replicas' failures meanwhile."""
        stranded = self.table.mark_ejected(st.rid)
        # its snapshot store dies with the process: stop fanning reads
        # at it (a respawned process comes back empty too)
        self._prune_read_replica(st.rid)
        self.metrics.counter_inc("distel_fleet_ejections_total")
        self.flight.record(
            "eject", rid=st.rid, stranded=list(stranded),
            consecutive_failures=st.consecutive_failures,
            consecutive_timeouts=st.consecutive_timeouts,
            dead_process=(
                self.supervisor is not None
                and not self.supervisor.alive(st.rid)
            ),
        )

        def _respawn_and_recover():
            if self.supervisor is not None:
                t0 = time.monotonic()
                try:
                    url = self.supervisor.respawn(st.rid)
                    self.table.mark_respawned(st.rid, url)
                    self.flight.record(
                        "respawn", rid=st.rid, url=url, ok=True,
                        wall_s=round(time.monotonic() - t0, 4),
                    )
                except Exception as e:
                    # stays ejected; recovery still re-places
                    self.flight.record(
                        "respawn", rid=st.rid, ok=False,
                        error=f"{type(e).__name__}: {e}"[:200],
                        wall_s=round(time.monotonic() - t0, 4),
                    )
            self._recover(stranded)

        t = threading.Thread(
            target=_respawn_and_recover,
            name=f"distel-fleet-eject-{st.rid}",
            daemon=True,
        )
        t.start()
        self._threads.append(t)

    def _recover(self, stranded: List[str]) -> None:
        """Re-place ontologies stranded by an ejection: replay the text
        journal onto a healthy replica (there is no spill to restore —
        the replica died unspilled; monotone EL+ re-derives the same
        closure from the same texts)."""
        for oid in stranded:
            with self._cv:
                if oid in self._migrating:
                    # an in-flight migration owns this oid: it either
                    # lands the state on a healthy replica or runs this
                    # same replay fallback itself — a second concurrent
                    # replay would race it for the placement
                    continue
                self._migrating.add(oid)
                # requests already in flight against the dead replica
                # will fail on their own; don't wait on them
                self._inflight.pop(oid, None)
            try:
                if self._replay_onto_healthy(oid):
                    self.metrics.counter_inc(
                        "distel_fleet_recoveries_total"
                    )
                    self.flight.record(
                        "recover", oid=oid,
                        to=self.table.lookup(oid).rid,
                        texts=len(self._journal_texts(oid)),
                    )
                else:
                    self.flight.record("recover_failed", oid=oid)
            finally:
                with self._cv:
                    self._migrating.discard(oid)
                    self._cv.notify_all()

    def _replay_onto_healthy(self, oid: str) -> bool:
        """Adopt ``oid`` onto the least-loaded healthy replica from the
        router's text journal.  Caller holds the oid's migration flag.
        Returns False (and drops the placement) only when no replica
        can take it."""
        texts = self._journal_texts(oid)
        if not texts:
            self.table.drop(oid)
            self.flight.record(
                "journal_replay", oid=oid, ok=False, reason="no journal"
            )
            return False
        try:
            dst = self.table.place(oid)
        except NoHealthyReplica:
            self.table.drop(oid)
            self.flight.record(
                "journal_replay", oid=oid, ok=False,
                reason="no healthy replica",
            )
            return False
        adopt = json.dumps(
            {"id": oid, "texts": texts, "warm": True}
        ).encode("utf-8")
        t0 = time.monotonic()
        try:
            self._forward(dst, "POST", "/fleet/adopt", adopt, None)
        except HTTPError as e:
            if e.status != 409:  # 409: dst already holds it — commit
                self.table.drop(oid)
                self.flight.record(
                    "journal_replay", oid=oid, dst=dst.rid, ok=False,
                    reason=str(e)[:200],
                )
                return False
        self.table.assign(oid, dst.rid)
        self.flight.record(
            "journal_replay", oid=oid, dst=dst.rid, ok=True,
            texts=len(texts),
            wall_s=round(time.monotonic() - t0, 4),
        )
        return True

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval_s):
            try:
                self.heartbeat_once()
            except Exception:
                continue  # the sweep must outlive any one bad replica

    # --------------------------------------------------------- rebalance

    def rebalance_once(self) -> Optional[dict]:
        """One rebalance decision+execution (loop calls this; tests and
        bench drive it directly).  Returns the migration record when one
        happened."""
        proposal = self.table.propose_migration()
        if proposal is None:
            return None
        oid, src, dst = proposal
        self.flight.record(
            "rebalance_proposal", oid=oid, src=src, dst=dst
        )
        try:
            return self.migrate(oid, dst_rid=dst)
        except HTTPError:
            return None  # racing admin migration / replica loss: skip

    def _rebalance_loop(self) -> None:
        while not self._stop.wait(self.rebalance_interval_s):
            try:
                self.rebalance_once()
            except Exception:
                continue


def _error_message(payload: bytes) -> str:
    try:
        doc = json.loads(payload.decode("utf-8"))
        if isinstance(doc, dict) and "error" in doc:
            return str(doc["error"])
    except (UnicodeDecodeError, json.JSONDecodeError):
        pass
    return payload.decode("utf-8", "replace") or "replica error"
