"""Fleet replica: a :class:`~distel_tpu.serve.server.ServeApp` with the
/fleet admin plane the router drives.

Admin endpoints (router-only — a fleet deployment firewalls them from
clients the same way the reference keeps Redis off the public net)::

    POST /fleet/load      {"id": ..., "text": ...}   load under a
                          ROUTER-minted id (fleet-wide uniqueness is the
                          router's job; replica-local new_id would
                          collide across shared-nothing processes)
    POST /fleet/migrate   {"id": ...}                migrate-out: spill
                          the closure, deregister, return the handoff
                          record {"id","texts","spill"}
    POST /fleet/adopt     {"id","texts","spill","warm"}  migrate-in:
                          register from a peer's handoff (restore from
                          the spill — byte-identical answers) or from
                          texts alone (journal-replay crash recovery)
    POST /fleet/snapshot  {"id"}                        write the
                          ontology's current READ snapshot to the
                          shared spill dir (read-replica handoff
                          artifact); returns {"id","version","path"}
    POST /fleet/adopt_snapshot {"id","path"}            publish a peer's
                          snapshot file into this replica's query store
                          as a READ-ONLY copy (no registry entry, no
                          write capability) — the router then fans
                          reads for the ontology out here

Load/migrate/adopt ride the scheduler's per-ontology lane, so a
migrate-out serializes after every previously admitted request for that
ontology — the spilled closure is exactly the state those requests
produced, and nothing in flight is dropped.  The two snapshot
endpoints deliberately do NOT: they only touch the lock-free snapshot
store (an immutable published view), so read replication never queues
behind classify traffic.  ``/healthz`` additionally reports the replica
id and the resident ontology ids (the router's placement recovery reads
them after a respawn).

The port's copy of ``distel_tpu/serve/fleet/replica.py``.  What
differs, and why: ``/fleet/adopt`` takes the router's journal as the
router writes it.  The router journals a retraction as an op marker
(``{"op": "retract", "text": ...}``) and replays the journal through
this endpoint after a crash, but the reference's check admits only
strings there, so a journal holding a retraction is refused with 400
and the tenant is dropped instead of recovered.  The copy admits the
marker (:func:`_is_journal_op`); the registry's ``adopt`` already
replays markers in order.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

from distel_tpu_torch.serve.query import OntologySnapshot, SnapshotMiss
from distel_tpu_torch.serve.server import HTTPError, ServeApp, _dumps, _json_doc

_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_FLEET_ROUTES = (
    ("POST", re.compile(r"^/fleet/load/?$"), "fleet_load",
     "/fleet/load"),
    ("POST", re.compile(r"^/fleet/migrate/?$"), "fleet_migrate",
     "/fleet/migrate"),
    ("POST", re.compile(r"^/fleet/adopt/?$"), "fleet_adopt",
     "/fleet/adopt"),
    ("POST", re.compile(r"^/fleet/snapshot/?$"), "fleet_snapshot",
     "/fleet/snapshot"),
    ("POST", re.compile(r"^/fleet/adopt_snapshot/?$"),
     "fleet_adopt_snapshot", "/fleet/adopt_snapshot"),
)


class ReplicaApp(ServeApp):
    ROUTES = _FLEET_ROUTES + ServeApp.ROUTES

    def __init__(self, *args, replica_id: str = "r0", **kw):
        super().__init__(*args, **kw)
        self.replica_id = replica_id
        # trace spans and flight events carry the replica identity —
        # the router's stitched /debug/trace labels each process track
        self.tracer.service = f"replica:{replica_id}"
        self.flight.service = f"replica:{replica_id}"
        self.metrics.describe(
            "distel_registry_exports_total",
            "ontologies migrated out (spill + deregister)",
        )
        self.metrics.describe(
            "distel_registry_adoptions_total",
            "ontologies migrated in (adopt from a peer's handoff)",
        )

    # ---------------------------------------------------- executor plane

    def _execute(self, key: str, kind: str, payloads: List):
        if kind == "migrate":
            rec = self.registry.export(key)
            # the per-increment taxonomy cache must leave with the
            # closure — a re-adopted id would otherwise answer from the
            # departed ontology's projection
            self._tax_cache.pop(key, None)
            return rec
        if kind == "adopt":
            doc = payloads[0]
            try:
                return self.registry.adopt(
                    key,
                    doc["texts"],
                    spill_path=doc.get("spill"),
                    warm=bool(doc.get("warm", True)),
                    min_version=doc.get("version"),
                    sha=doc.get("sha"),
                )
            except ValueError as e:
                if "already loaded" in str(e):
                    # 409, not 500: the router treats "the destination
                    # already holds this id" as a committed handoff
                    # (recovery/migration retry races land here)
                    raise HTTPError(409, str(e))
                raise
        return super()._execute(key, kind, payloads)

    # -------------------------------------------------------- HTTP plane

    @staticmethod
    def _fleet_id(doc: dict) -> str:
        oid = doc.get("id")
        if not isinstance(oid, str) or not _ID_RE.match(oid):
            raise HTTPError(400, "body needs a well-formed \"id\"")
        return oid

    def _ep_fleet_load(self, *, query, body, deadline_s):
        doc = _json_doc(body)
        oid = self._fleet_id(doc)
        text = doc.get("text")
        if not isinstance(text, str) or not text.strip():
            raise HTTPError(400, 'body must be {"id": ..., "text": ...}')
        rec = self._schedule(oid, "load", text, deadline_s)
        return 201, "application/json", _dumps(rec)

    def _ep_fleet_migrate(self, *, query, body, deadline_s):
        doc = _json_doc(body)
        oid = self._fleet_id(doc)
        rec = self._schedule(oid, "migrate", None, deadline_s)
        return 200, "application/json", _dumps(rec)

    def _ep_fleet_adopt(self, *, query, body, deadline_s):
        doc = _json_doc(body)
        oid = self._fleet_id(doc)
        texts = doc.get("texts")
        if (
            not isinstance(texts, list)
            or not texts
            or not all(_is_journal_op(t) for t in texts)
        ):
            raise HTTPError(400, 'body needs "texts": [str, ...]')
        rec = self._schedule(oid, "adopt", doc, deadline_s)
        return 200, "application/json", _dumps(rec)

    # ---------------------------------------- read-replica snapshot wire

    def _ep_fleet_snapshot(self, *, query, body, deadline_s):
        """Export the ontology's CURRENT read snapshot to the shared
        spill dir — the read-replication handoff.  Reads the lock-free
        store only (no scheduler, no entry lock): an in-flight delta
        simply means the file carries the previous version, which is
        exactly the snapshot contract."""
        doc = _json_doc(body)
        oid = self._fleet_id(doc)
        if self.query is None:
            raise HTTPError(404, "query plane disabled (query.enable)")
        if not self.registry.spill_dir:
            raise HTTPError(
                503, "snapshot export needs a spill_dir"
            )
        try:
            snap = self.query.get(oid)
        except SnapshotMiss:
            raise HTTPError(404, f"no snapshot for {oid!r}")
        path = os.path.join(
            self.registry.spill_dir, f"{oid}.query.npz"
        )
        # write-then-rename: a concurrent replicate for the same oid
        # (or a peer mid-np.load on the previous export) must never
        # observe a torn file — os.replace swaps complete files.  The
        # tmp name keeps the .npz suffix (savez appends it otherwise)
        tmp = os.path.join(
            self.registry.spill_dir,
            f"{oid}.query.tmp{os.getpid()}.npz",
        )
        try:
            nbytes = snap.save(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return 200, "application/json", _dumps(
            {
                "id": oid, "version": snap.version, "path": path,
                "bytes": nbytes,
            }
        )

    def _ep_fleet_adopt_snapshot(self, *, query, body, deadline_s):
        """Publish a peer's exported snapshot file into this replica's
        query store — a READ-ONLY copy (no registry entry: writes for
        the ontology still 404 here and stay with the primary).  A
        stale file (older than what this store already has) is refused
        with 409 so the router never steps a read replica backwards."""
        doc = _json_doc(body)
        oid = self._fleet_id(doc)
        path = doc.get("path")
        if not isinstance(path, str) or not path:
            raise HTTPError(400, 'body needs "path"')
        if self.query is None:
            raise HTTPError(404, "query plane disabled (query.enable)")
        try:
            snap = OntologySnapshot.load(
                path, row_cache=self.config.query_row_cache
            )
        except (OSError, KeyError, ValueError) as e:
            raise HTTPError(400, f"unreadable snapshot file: {e}")
        if snap.oid != oid:
            raise HTTPError(
                400,
                f"snapshot file is for {snap.oid!r}, not {oid!r}",
            )
        if not self.query.adopt(snap):
            raise HTTPError(
                409,
                f"store already holds {oid!r} newer than version "
                f"{snap.version}",
            )
        return 200, "application/json", _dumps(
            {"id": oid, "version": snap.version, "read_only": True}
        )

    def _ep_healthz(self, *, query, body, deadline_s):
        status, ctype, payload = super()._ep_healthz(
            query=query, body=body, deadline_s=deadline_s
        )
        import json

        doc = json.loads(payload)
        doc["replica_id"] = self.replica_id
        doc["ontology_ids"] = self.registry.ids()
        return status, ctype, _dumps(doc)


def _is_journal_op(op) -> bool:
    """An entry of the router's journal: an add text, or a retraction's
    op marker."""
    return isinstance(op, str) or (
        isinstance(op, dict)
        and op.get("op") == "retract"
        and isinstance(op.get("text"), str)
    )
