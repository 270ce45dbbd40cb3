"""The port's serve fleet against the reference's.

The reference's fleet tests (``tests/test_fleet.py``) run here on the
port's fleet with the same in-process rig — ``ReplicaApp``s on live
loopback HTTP servers behind a ``RouterApp`` — on ``device="cpu"``
(plain versions): placement, rebalance, ejection, aggregated
expositions, affinity, live migration under load, migration guards,
journal-replay recovery, rebalance migration, metric families and the
client's retry.

Then parity: the reference's in-process fleet (built with
``ClassifierConfig(shape_buckets=False)``, the exact-layout contract
the port's other parity tests hold it to) and the port's answer the
same requests — loads, deltas, a retraction, reads, a live migration, a
read replica, a killed replica recovered by replaying its journal
(retract marker included), the tracked trace with its ``migrate`` op —
and every answer, migrate and replicate record, flight event kind and
metric family must be equal, tolerance 0.  The reference's write
records carry its XLA program-build record, which the port (compiling
nothing) does not have; those keys and clock readings are set aside by
name.

Last, ``python -m distel_tpu_torch.cli fleet`` as a real process tree:
a SIGKILLed replica is respawned and its tenant recovered.

The port's runtime lockdep (``distel_tpu_torch/testing/lockdep.py``)
is armed for the whole module, as the reference's conftest arms its own
for ``test_fleet``: a lock-order inversion observed on any schedule
fails the test that closed the cycle.
"""

import contextlib
import json
import os
import re
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.serve.client import ServeClient as RefClient
from distel_tpu.serve.client import ServeError as RefServeError
from distel_tpu.serve.fleet.replica import ReplicaApp as RefReplicaApp
from distel_tpu.serve.fleet.router import RouterApp as RefRouterApp
from distel_tpu.serve.server import make_server as ref_make_server
from distel_tpu.serve.traces import replay_trace as ref_replay
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.serve.client import ServeClient, ServeError
from distel_tpu_torch.serve.fleet import supervisor as fleet_supervisor
from distel_tpu_torch.serve.fleet.placement import (
    NoHealthyReplica,
    PlacementTable,
)
from distel_tpu_torch.serve.fleet.replica import ReplicaApp
from distel_tpu_torch.serve.fleet.router import RouterApp
from distel_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
from distel_tpu_torch.serve.metrics import aggregate_expositions, relabel_sample
from distel_tpu_torch.serve.server import make_server
from distel_tpu_torch.serve.traces import load_trace, replay_trace
from distel_tpu_torch.testing import lockdep
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRACE = ROOT / "traces" / "mixed_add_retract_query.jsonl"

BASE = """
SubClassOf(A B)
SubClassOf(B C)
SubClassOf(C ObjectSomeValuesFrom(r D))
SubClassOf(ObjectSomeValuesFrom(r D) E)
SubClassOf(E F)
"""

DELTA = """
SubClassOf(New0 A)
SubClassOf(New0 ObjectSomeValuesFrom(r G))
SubClassOf(G D)
"""

ONTO_B = "SubClassOf(P Q)\nSubClassOf(Q S)\nSubClassOf(S ObjectSomeValuesFrom(r P))\n"
GONE = "SubClassOf(Gone0 A)\nSubClassOf(Gone0 ObjectSomeValuesFrom(r C))"
LATE = "SubClassOf(Late0 New0)"

#: the reference's per-increment XLA program-build record and its
#: delta-program registry's record, merged into its write records
#: (as ``tests/test_torch_serve.py`` sets them aside)
COMPILE_KEYS = {"bucket_signature", "program", "trace_lower_s", "compile_s",
                "program_cache_hit", "persistent_cache_hits",
                "persistent_cache_misses", "delta_signature",
                "delta_program_hits"}
#: answer fields that are clock readings
CLOCK_KEYS = {"published_unix", "wall_s", "uptime_s"}


# ------------------------------------------------------------- lockdep


@pytest.fixture(scope="module", autouse=True)
def _lockdep_armed():
    """Armed before any other fixture of the module builds a lock (the
    parity fleets are module-scoped); edges accumulate across the
    module's tests, so A->B in one test and B->A in a later one is an
    inversion too."""
    lockdep.enable()
    try:
        yield
    finally:
        lockdep.disable()


@pytest.fixture(autouse=True)
def _lockdep_guard():
    yield
    # fail the test on inversions its schedule didn't deadlock on
    lockdep.check()


# --------------------------------------------------------------- fixtures

PORT = {"replica": ReplicaApp, "router": RouterApp, "make_server": make_server,
        "client": ServeClient, "config": ClassifierConfig(shape_buckets=False),
        "kw": {"device": "cpu"}}
REF = {"replica": RefReplicaApp, "router": RefRouterApp,
       "make_server": ref_make_server, "client": RefClient,
       "config": RefConfig(shape_buckets=False), "kw": {}}


@contextlib.contextmanager
def fleet(tmp_path, n=2, replica_config=None, pkg=PORT, **router_kw):
    """An in-process fleet: n ReplicaApps on live HTTP servers behind a
    RouterApp (threads in one process — the correctness rig;
    ``cli fleet`` runs the real subprocess fleet).  ``pkg``: the port's
    classes (default, on the CPU) or the reference's."""
    spill = str(tmp_path / "spill")
    apps, servers, replicas = [], [], []
    for i in range(n):
        app = pkg["replica"](
            replica_config if replica_config is not None else pkg["config"],
            replica_id=f"r{i}", spill_dir=spill,
            fast_path_min_concepts=0, **pkg["kw"],
        )
        srv = pkg["make_server"](app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        apps.append(app)
        servers.append(srv)
        replicas.append(
            (f"r{i}", f"http://127.0.0.1:{srv.server_address[1]}")
        )
    router = pkg["router"](replicas, **router_kw)
    rsrv = pkg["make_server"](router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    client = pkg["client"](
        f"http://127.0.0.1:{rsrv.server_address[1]}", timeout=300
    )
    try:
        yield router, client, apps, servers
    finally:
        router.close()
        for s in servers + [rsrv]:
            s.shutdown()
            s.server_close()
        for a in apps:
            a.close(final_spill=False)


def _direct_taxonomy(texts):
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    inc = IncrementalClassifier(device="cpu")
    inc._FAST_PATH_MIN_CONCEPTS = 0
    for t in texts:
        if isinstance(t, dict):
            inc.retract(t["text"])
        else:
            inc.add_text(t)
    return extract_taxonomy(inc.last_result)


def _wait_for_recovery(router, n=1, timeout_s=120):
    deadline = time.monotonic() + timeout_s
    while router.metrics.counter_value("distel_fleet_recoveries_total") < n:
        assert time.monotonic() < deadline, "recovery never ran"
        time.sleep(0.05)


# ------------------------------------------------------ placement policy


def test_placement_least_loaded_and_affinity():
    t = PlacementTable(depth_divergence=4)
    t.add_replica("r0", "http://a")
    t.add_replica("r1", "http://b")
    t.replica("r0").queue_depth = 3
    first = t.place("o1")
    assert first.rid == "r1"  # least queue depth wins
    assert t.lookup("o1").rid == "r1"
    # placement counts toward load immediately: with equal depths the
    # resident tiebreak rotates a burst across replicas
    t.replica("r0").queue_depth = 0
    assert t.place("o2").rid == "r0"
    assert t.place("o3").rid == "r0"  # ties break toward the low rid
    assert t.place("o4").rid == "r1"  # r0 now carries more residents
    assert sorted(t.ontologies_on("r1")) == ["o1", "o4"]
    t.drop("o3")
    assert t.lookup("o3") is None


def test_placement_rebalance_proposal_and_ejection():
    t = PlacementTable(depth_divergence=4)
    t.add_replica("r0", "http://a")
    t.add_replica("r1", "http://b")
    t.assign("hot1", "r0")
    t.assign("hot2", "r0")
    t.lookup("hot1")  # hot2 is now least-recently-touched
    assert t.propose_migration() is None  # no divergence yet
    t.replica("r0").queue_depth = 9
    prop = t.propose_migration()
    assert prop == ("hot2", "r0", "r1")
    # single healthy replica → nothing to propose
    stranded = t.mark_ejected("r1")
    assert stranded == []
    assert t.propose_migration() is None
    stranded = t.mark_ejected("r0")
    assert sorted(stranded) == ["hot1", "hot2"]
    with pytest.raises(NoHealthyReplica):
        t.place("o9")
    t.mark_respawned("r0", "http://a2")
    assert t.place("o9").rid == "r0"
    assert t.replica("r0").url == "http://a2"


# --------------------------------------------------- metrics aggregation


def test_relabel_and_aggregate_expositions():
    assert (
        relabel_sample('m_total{kind="x"} 2', 'replica="r0"')
        == 'm_total{kind="x",replica="r0"} 2'
    )
    assert relabel_sample("m_total 2", 'replica="r1"') == (
        'm_total{replica="r1"} 2'
    )
    assert relabel_sample("# TYPE m_total counter", "x") == (
        "# TYPE m_total counter"
    )
    page = (
        "# HELP lat_seconds latency\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{le="+Inf"} 3\n'
        "lat_seconds_sum 0.5\n"
        "lat_seconds_count 3\n"
        "# TYPE up gauge\n"
        "up 1\n"
    )
    out = aggregate_expositions({"r0": page, "r1": page})
    # one family group: HELP/TYPE once, both replicas' samples under it
    assert out.count("# TYPE lat_seconds histogram") == 1
    assert 'lat_seconds_sum{replica="r0"} 0.5' in out
    assert 'lat_seconds_sum{replica="r1"} 0.5' in out
    assert 'lat_seconds_bucket{le="+Inf",replica="r1"} 3' in out
    assert out.count("# TYPE up gauge") == 1
    assert 'up{replica="r0"} 1' in out
    # samples of one family stay contiguous under their TYPE line
    type_at = out.index("# TYPE lat_seconds histogram")
    gauge_at = out.index("# TYPE up gauge")
    assert type_at < out.index('lat_seconds_sum{replica="r1"}') < gauge_at


# ------------------------------------------------- router end to end


def test_fleet_affinity_placement_and_parity(tmp_path):
    with fleet(tmp_path, n=2) as (router, client, apps, servers):
        oid_a = client.load(BASE)["id"]
        oid_b = client.load(ONTO_B)["id"]
        # affinity spread: two loads on an idle fleet land on distinct
        # replicas (least-loaded with the resident tiebreak)
        place = router.table.stats()["placement"]
        assert sorted(place) == sorted([oid_a, oid_b])
        assert place[oid_a] != place[oid_b]
        # answers ride the pinned replica and match a direct classifier
        got = client.subsumers(oid_a, "A")
        assert got["subsumers"] == _direct_taxonomy([BASE]).subsumers["A"]
        d = client.delta(oid_a, DELTA)
        assert d["id"] == oid_a and d["path"] == "fast"
        got = client.subsumers(oid_a, "New0")
        want = _direct_taxonomy([BASE, DELTA]).subsumers["New0"]
        assert got["subsumers"] == want
        # unknown ontology is a clean 404 at the router
        with pytest.raises(ServeError) as ei:
            client.taxonomy("ont-9999")
        assert ei.value.status == 404
        # router health reports both replicas after a heartbeat
        router.heartbeat_once()
        h = client.healthz()
        assert h["role"] == "router"
        assert len(h["replicas"]) == 2
        assert all(r["healthy"] for r in h["replicas"])
        # the replicas name themselves and their tenants, and run on
        # the device they were given
        for app in apps:
            assert app.registry.device.type == "cpu"


def test_fleet_live_migration_byte_identical_under_load(tmp_path):
    with fleet(tmp_path, n=2) as (router, client, apps, servers):
        oid = client.load(BASE)["id"]
        client.delta(oid, DELTA)
        src = router.table.lookup(oid).rid
        tax_before = json.dumps(client.taxonomy(oid), sort_keys=True)

        # concurrent clients hammer the ontology THROUGH the migration;
        # the router holds, never drops — zero failures, retries=0
        failures, answers = [], []
        stop = threading.Event()

        def hammer(k):
            i = 0
            while not stop.is_set():
                try:
                    if k % 2:
                        answers.append(
                            client.taxonomy(oid)["parents"]["A"]
                        )
                    else:
                        client.delta(
                            oid, f"SubClassOf(Load{k}x{i} A)"
                        )
                    i += 1
                except Exception as e:  # noqa: BLE001 — the assertion
                    failures.append(e)

        threads = [
            threading.Thread(target=hammer, args=(k,)) for k in range(4)
        ]
        for t in threads:
            t.start()
        time.sleep(0.3)
        rec = router.migrate(oid)
        assert rec["from"] == src and rec["to"] != src
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert failures == []
        assert answers and all(a == ["B"] for a in answers)
        # placement committed; the source replica no longer holds it
        assert router.table.lookup(oid).rid == rec["to"]
        src_app = apps[int(src[1:])]
        assert oid not in src_app.registry.ids()
        m = client.metrics_text()
        assert "distel_fleet_migrations_total" in m
        # a quiesced migration is byte-identical: migrate back with no
        # load and compare the full taxonomy documents
        tax_mid = json.dumps(client.taxonomy(oid), sort_keys=True)
        router.migrate(oid)
        tax_after = json.dumps(client.taxonomy(oid), sort_keys=True)
        assert tax_mid == tax_after
        assert json.loads(tax_after)["parents"]["A"] == (
            json.loads(tax_before)["parents"]["A"]
        )


def test_fleet_migration_guards(tmp_path):
    with fleet(tmp_path, n=2) as (router, client, apps, servers):
        oid = client.load(BASE)["id"]
        with pytest.raises(Exception) as ei:
            router.migrate("ont-9999")
        assert getattr(ei.value, "status", None) == 404
        src = router.table.lookup(oid).rid
        with pytest.raises(Exception) as ei:
            router.migrate(oid, dst_rid=src)
        assert getattr(ei.value, "status", None) == 400
        with pytest.raises(Exception) as ei:
            router.migrate(oid, dst_rid="r-nope")
        assert getattr(ei.value, "status", None) == 400
        # admin endpoint drives the same path
        rec = client._request(
            "POST", "/fleet/migrate", {"id": oid}
        )
        assert rec["from"] == src


def test_fleet_ejection_recovers_by_journal_replay(tmp_path):
    with fleet(
        tmp_path, n=2, eject_failures=2
    ) as (router, client, apps, servers):
        oid = client.load(BASE)["id"]
        client.delta(oid, DELTA)
        rid = router.table.lookup(oid).rid
        idx = int(rid[1:])
        # kill the pinned replica's HTTP plane (crash, no spill)
        servers[idx].shutdown()
        servers[idx].server_close()
        for _ in range(2):
            router.heartbeat_once()
        # ejected synchronously; recovery (journal replay) runs on a
        # worker thread so the heartbeat keeps sweeping — poll it
        assert not router.table.replica(rid).healthy
        _wait_for_recovery(router)
        survivor = router.table.lookup(oid)
        assert survivor is not None and survivor.rid != rid
        got = client.subsumers(oid, "New0")
        want = _direct_taxonomy([BASE, DELTA]).subsumers["New0"]
        assert got["subsumers"] == want
        assert (
            router.metrics.counter_value("distel_fleet_recoveries_total")
            == 1
        )
        assert (
            router.metrics.counter_value("distel_fleet_ejections_total")
            == 1
        )


def _answer(fn, *args):
    """A request's answer, or its refusal's status."""
    try:
        return fn(*args)
    except (ServeError, RefServeError) as e:
        return ("refused", e.status)


def _retraction_ops(client):
    oid = client.load(BASE)["id"]
    client.delta(oid, DELTA)
    client.delta(oid, GONE)
    rec = client.retract(oid, GONE)
    assert rec["path"] == "retract"
    client.delta(oid, LATE)
    return oid


def test_fleet_journal_replay_applies_a_retraction_in_order(tmp_path):
    """A journal holding a retract marker recovers through the
    registry's in-order replay: the recovered tenant answers as it did
    before the crash, as the reference's fleet answers the same requests
    (the reference's replica refuses a marker in ``/fleet/adopt``, so
    its own crash would drop the tenant: it is not killed here), and as
    a classify of the survivors."""
    with fleet(tmp_path / "ref", n=2, pkg=REF) as (router, client, *_):
        oid = _retraction_ops(client)
        want = {"taxonomy": _plain(client.taxonomy(oid))}
        for cls in ("A", "New0", "Late0", "G", "E", "Gone0"):
            want[cls] = _answer(client.subsumers, oid, cls)
    with fleet(
        tmp_path / "port", n=2, eject_failures=1
    ) as (router, client, apps, servers):
        oid = _retraction_ops(client)
        journal = router._journal_texts(oid)
        assert journal == [BASE, DELTA, GONE, {"op": "retract", "text": GONE},
                           LATE]
        before = client.taxonomy(oid)
        rid = router.table.lookup(oid).rid
        servers[int(rid[1:])].shutdown()
        servers[int(rid[1:])].server_close()
        router.heartbeat_once()
        _wait_for_recovery(router)
        assert router.table.lookup(oid).rid != rid
        after = client.taxonomy(oid)
        assert after == before == want["taxonomy"]
        survivors = _direct_taxonomy([BASE, DELTA, LATE])
        for cls in ("A", "New0", "Late0", "G", "E", "Gone0"):
            got = _answer(client.subsumers, oid, cls)
            assert got == want[cls], cls
            if cls != "Gone0":
                assert got["subsumers"] == survivors.subsumers[cls], cls
        # the retracted class is gone from the taxonomy after the replay
        assert want["Gone0"] == ("refused", 404)
        replays = router.flight.events(kind="journal_replay")
        assert [(e["ok"], e["texts"]) for e in replays] == [(True, 5)]
        assert router.flight.events(kind="recover")


def test_fleet_rebalance_migrates_off_hot_replica(tmp_path):
    with fleet(
        tmp_path, n=2, depth_divergence=2
    ) as (router, client, apps, servers):
        oid_a = client.load(BASE)["id"]
        rid = router.table.lookup(oid_a).rid
        # fake a diverged queue: the pinned replica reads hot
        router.table.replica(rid).queue_depth = 5
        rec = router.rebalance_once()
        assert rec is not None and rec["id"] == oid_a
        assert router.table.lookup(oid_a).rid != rid
        # balanced fleet: no further proposal
        router.table.replica(rid).queue_depth = 0
        assert router.rebalance_once() is None


def test_fleet_aggregated_metrics_families(tmp_path):
    with fleet(tmp_path, n=2) as (router, client, apps, servers):
        client.load(BASE)
        text = client.metrics_text()
        # router families present, once
        assert text.count("# TYPE distel_router_requests_total counter") == 1
        assert "distel_fleet_replicas_healthy 2" in text
        # replica families grouped: one TYPE line, per-replica samples
        assert text.count("# TYPE distel_requests_total counter") == 1
        assert 'replica="r0"' in text and 'replica="r1"' in text


def test_read_replica_answers_equal_the_primary(tmp_path):
    """A replicated tenant's snapshot reads fan out over primary and
    read replica (``distel_router_reads_total`` by target), and every
    fanned-out answer is the primary's."""
    with fleet(tmp_path, n=2) as (router, client, apps, servers):
        oid = client.load(BASE)["id"]
        client.delta(oid, DELTA)
        primary = router.table.lookup(oid).rid
        rec = router.replicate(oid)
        assert rec["from"] == primary and rec["to"] != primary
        want = [apps[int(primary[1:])].query.get(oid).subsumers(c)
                for c in ("A", "New0", "G")]
        for _ in range(3):
            got = [client.query_subsumers(oid, c)["subsumers"]
                   for c in ("A", "New0", "G")]
            assert got == want
        page = router.metrics.render()
        for target in ("primary", "replica"):
            n = re.search(
                r'distel_router_reads_total\{target="%s"\} (\d+)' % target, page)
            assert n and int(n.group(1)) > 0, target
        # the read replica holds a read-only copy: no registry entry
        assert oid not in apps[int(rec["to"][1:])].registry.ids()


# ------------------------------------------------- client retry/backoff


class _Flaky:
    """Stdlib handler stub: N rejections, then success."""

    def __init__(self, rejections, status=503, retry_after=None):
        self.left = rejections
        self.status = status
        self.retry_after = retry_after
        self.calls = 0

    def app(self):
        from http.server import BaseHTTPRequestHandler

        stub = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                stub.calls += 1
                if stub.left > 0:
                    stub.left -= 1
                    body = b'{"error": "try later"}'
                    self.send_response(stub.status)
                    if stub.retry_after is not None:
                        self.send_header(
                            "Retry-After", stub.retry_after
                        )
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header(
                        "Content-Type", "application/json"
                    )
                    self.end_headers()
                    self.wfile.write(body)
                    return
                body = b'{"status": "ok"}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(body)

        return H


@contextlib.contextmanager
def _flaky_server(stub):
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), stub.app())
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_retry_honors_retry_after_and_backoff():
    stub = _Flaky(rejections=2, status=503, retry_after="0.05")
    with _flaky_server(stub) as url:
        c = ServeClient(url, timeout=10, retries=3, backoff_s=0.01)
        t0 = time.monotonic()
        assert c.healthz()["status"] == "ok"
        # two Retry-After sleeps happened, bounded above by sanity
        assert 0.1 <= time.monotonic() - t0 < 5
        assert stub.calls == 3


def test_client_retry_opt_in_and_exhaustion():
    # default retries=0: first 429 surfaces immediately
    stub = _Flaky(rejections=1, status=429)
    with _flaky_server(stub) as url:
        c = ServeClient(url, timeout=10)
        with pytest.raises(ServeError) as ei:
            c.healthz()
        assert ei.value.status == 429
        assert stub.calls == 1
    # retries exhausted: the last rejection surfaces
    stub = _Flaky(rejections=5, status=503)
    with _flaky_server(stub) as url:
        c = ServeClient(url, timeout=10, retries=2, backoff_s=0.01)
        with pytest.raises(ServeError) as ei:
            c.healthz()
        assert ei.value.status == 503
        assert stub.calls == 3  # 1 + 2 retries
    # non-retryable statuses never retry
    stub = _Flaky(rejections=1, status=404)
    with _flaky_server(stub) as url:
        c = ServeClient(url, timeout=10, retries=3, backoff_s=0.01)
        with pytest.raises(ServeError) as ei:
            c.healthz()
        assert ei.value.status == 404
        assert stub.calls == 1


def test_client_retries_connection_errors():
    # nothing listening: retries happen, then the URLError surfaces
    import urllib.error

    c = ServeClient(
        "http://127.0.0.1:9", timeout=1, retries=1, backoff_s=0.01
    )
    t0 = time.monotonic()
    with pytest.raises(urllib.error.URLError):
        c.healthz()
    assert time.monotonic() - t0 < 30


# ------------------------------------------- parity with the reference


def _plain(doc):
    """An answer without the reference's compile record and clock
    readings (nested: the router's status embeds flight events)."""
    if isinstance(doc, dict):
        return {k: _plain(v) for k, v in doc.items()
                if k not in COMPILE_KEYS | CLOCK_KEYS}
    if isinstance(doc, list):
        return [_plain(v) for v in doc]
    return doc


def _series(metrics_text: str) -> set:
    """Metric family names with samples in a /metrics page."""
    names = set()
    for ln in metrics_text.splitlines():
        if ln and not ln.startswith("#"):
            name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", ln).group(0)
            names.add(re.sub(r"_(bucket|sum|count|max)$", "", name))
    return names


def _counters(text: str) -> dict:
    """The fleet's and router's counter samples of a metrics page, but
    ``distel_router_requests_total``, which the HTTP handler counts
    after it has answered (a scrape right after a request can miss it)."""
    out = {}
    for ln in text.splitlines():
        name, _, value = ln.rpartition(" ")
        if name.startswith(("distel_fleet_", "distel_router_")) and \
                "_total" in name and \
                not name.startswith("distel_router_requests_total"):
            out[name] = float(value)
    return out


#: flight-event fields that are clock readings, sequence numbers,
#: random trace ids, or a compressed spill's size (its metadata carries
#: a clock reading)
EVENT_CLOCK_KEYS = {"ts", "seq", "trace_id", "wall_s", "bytes"}


def _event(e: dict) -> dict:
    """A flight event without clock readings, with spill paths reduced
    to their file names (each package spills into its own directory)."""
    e = {k: v for k, v in e.items() if k not in EVENT_CLOCK_KEYS}
    for k in ("spill", "restored_from", "path"):
        if isinstance(e.get(k), str):
            e[k] = os.path.basename(e[k])
    return e


def _flight(app) -> list:
    return [_event(e) for e in app.flight.events()]


def _scenario(router, client, apps, servers):
    """The shared requests on three replicas: two tenants placed apart,
    a read replica of the second, a crash of the second's replica
    (recovered by journal replay), a live migration of the first and a
    retraction on it.  Every answer in order, then the router's and each
    replica's flight events and the router's and the aggregated
    /metrics."""
    out = []

    def rec(name, doc):
        out.append((name, _plain(doc)))
        return doc

    a = rec("load a", client.load(BASE))["id"]
    b = rec("load b", client.load(ONTO_B))["id"]
    rec("placement", router.table.stats()["placement"])
    rec("delta a", client.delta(a, DELTA))
    rec("subsumers", client.subsumers(a, "New0"))
    rec("taxonomy", client.taxonomy(a))
    rec("q_subsumers", client.query_subsumers(a, "New0"))
    rec("replicate b", router.replicate(b))
    for i in range(4):
        rec(f"fanned-out read {i}", client.query_subsumers(b, "P"))
    rec("delta b", client.delta(b, "SubClassOf(T P)"))
    rec("read after delta b", client.query_subsumers(b, "T"))
    rec("taxonomy b before kill", client.taxonomy(b))
    rid = router.table.lookup(b).rid
    servers[int(rid[1:])].shutdown()
    servers[int(rid[1:])].server_close()
    for _ in range(router.eject_failures):
        router.heartbeat_once()
    _wait_for_recovery(router)
    rec("placement after recovery", router.table.stats()["placement"])
    rec("taxonomy b after recovery", client.taxonomy(b))
    rec("subsumers b after recovery", client.subsumers(b, "T"))
    rec("read b after recovery", client.query_subsumers(b, "T"))
    rec("migrate a", router.migrate(a))
    rec("placement after migrate", router.table.stats()["placement"])
    rec("taxonomy after migrate", client.taxonomy(a))
    rec("version after migrate", client.snapshot_version(a))
    rec("delta gone", client.delta(a, GONE))
    rec("retract gone", client.retract(a, GONE))
    rec("delta late", client.delta(a, LATE))
    rec("taxonomy a", client.taxonomy(a))
    rec("subsumers late", client.subsumers(a, "Late0"))
    rec("journal a", router._journal_texts(a))
    rec("status", router.dispatch("GET", "/fleet/status", {}, b"", None)[2]
        .decode())
    flights = [_flight(router)] + [_flight(app) for app in apps]
    return out, flights, router.metrics.render(), client.metrics_text()


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The shared requests through the reference's fleet and the port's:
    ``(ref, port)``, each ``(answers, flight events, router metrics,
    aggregated /metrics)``."""
    runs = []
    for pkg in (REF, PORT):
        with fleet(tmp_path_factory.mktemp("fleet"), n=3, pkg=pkg,
                   eject_failures=2) as (router, client, apps, servers):
            runs.append(_scenario(router, client, apps, servers))
    return runs


def test_fleet_answers_equal_the_reference(parity):
    (ref, *_), (port, *_) = parity
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (name, r), (_, p) in zip(ref, port):
        if name == "status":
            r, p = json.loads(r), json.loads(p)
            for doc in (r, p):
                doc["recent_events"] = [_event(e) for e in doc["recent_events"]]
                for st in doc["replicas"]:
                    # each fleet's own loopback ports; and the load the
                    # ejecting sweep read off the replica probed after
                    # the dead one, which races the recovery's adopt
                    for k in ("url", "queue_depth", "resident", "spilled"):
                        st.pop(k)
        assert p == r, name
    answers = dict(port)
    assert answers["taxonomy b after recovery"] == answers["taxonomy b before kill"]
    assert answers["migrate a"]["from"] != answers["migrate a"]["to"]
    assert answers["journal a"][3] == {"op": "retract", "text": GONE}


def test_fleet_flight_events_equal_the_reference(parity):
    (_, ref, *_), (_, port, *_) = parity
    kinds = [[e["kind"] for e in f] for f in port]
    assert kinds == [[e["kind"] for e in f] for f in ref]
    for who, (r, p) in enumerate(zip(ref, port)):
        assert p == r, who
    router_kinds = set(kinds[0])
    for kind in ("migrate_start", "migrate_drain", "migrate_export",
                 "migrate_adopt", "migrate_commit", "read_replicate",
                 "heartbeat_miss", "eject", "journal_replay", "recover"):
        assert kind in router_kinds, kind


def test_fleet_router_counters_equal_the_reference(parity):
    (_, _, ref, _), (_, _, port, _) = parity
    assert _counters(port) == _counters(ref)
    counters = _counters(port)
    assert counters["distel_fleet_migrations_total"] == 1
    assert counters["distel_fleet_recoveries_total"] == 1
    assert counters["distel_fleet_ejections_total"] == 1
    assert counters["distel_fleet_replications_total"] == 1


def test_fleet_metric_families_are_the_reference_minus_not_yet_ported(parity):
    from distel_tpu_torch.serve.server import NOT_YET_PORTED

    (_, _, _, ref), (_, _, _, port) = parity
    ref_names, port_names = _series(ref), _series(port)
    # the reference's exact-shape replicas fill the compile series from
    # their XLA compiles; the port's exact-shape engines build no program;
    # the port's replicas sample the persistent-cache series from a
    # process aggregate (kernel libraries found built), always there
    exact_build = {"distel_compile_seconds", "distel_program_cache_misses_total"}
    process = {"distel_persistent_cache_hits_total"}
    assert port_names - process == \
        ref_names - set(NOT_YET_PORTED) - exact_build - process
    assert process <= port_names
    for name in ("distel_fleet_replicas_healthy", "distel_router_reads_total",
                 "distel_requests_total", "distel_registry_exports_total"):
        assert name in port_names, name
    # every replica's families ride under replica= (r1 survived the kill)
    assert 'distel_requests_total{' in port and 'replica="r' in port


def _trace_answers(pkg, tmp_path, migrate: bool):
    with fleet(tmp_path, n=2, pkg=pkg) as (router, client, apps, servers):
        answers = []
        for name in ("load", "delta", "retract", "taxonomy", "subsumers",
                     "query_subsumers", "snapshot_version"):
            fn = getattr(client, name)

            def call(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                answers.append((_name, _plain(out)))
                return out

            setattr(client, name, call)
        def moved(oid):
            answers.append(("migrate", oid))
            return router.migrate(oid)

        replay = ref_replay if pkg is REF else replay_trace
        rec = replay(load_trace(str(TRACE)), client,
                     migrate=moved if migrate else None)
        rec.pop("wall_s")
        return rec, answers, [e["kind"] for e in router.flight.events()]


def test_trace_replay_through_the_router_matches_reference(tmp_path):
    """The tracked trace through the port's fleet, its ``migrate`` op
    run (0 skipped), answers as the reference's fleet answers it.  The
    trace migrates a tenant whose history holds a retraction, whose
    handoff the reference's replica refuses (``/fleet/adopt`` admits
    strings only), so the reference replays it with the op skipped:
    where a tenant lives must not change an answer.  The one number a
    move changes is the moved tenant's snapshot version: the adopting
    replica publishes one more (as the reference's migration does, see
    ``test_fleet_answers_equal_the_reference``)."""
    rrec, rans, _ = _trace_answers(REF, tmp_path / "ref", migrate=False)
    prec, pans, pkinds = _trace_answers(PORT, tmp_path / "port", migrate=True)
    assert rrec["skipped_migrates"] == 1 and "migrate" not in rrec["ok"]
    assert prec["skipped_migrates"] == 0 and prec["failed_requests"] == 0
    assert prec["ok"].pop("migrate") == 1
    prec["skipped_migrates"] = 1
    assert prec == rrec
    at = pans.index(("migrate", prec["ontologies"]["onto-b"]))
    pans.pop(at)
    bumped = 0
    for name, doc in pans[at:]:
        if doc.get("id") == prec["ontologies"]["onto-b"] and "version" in doc:
            doc["version"] -= 1
            bumped += 1
    assert bumped == 1
    assert pans == rans
    assert len(pans) == 15
    assert [k for k in pkinds if k.startswith("migrate_")] == [
        "migrate_start", "migrate_drain", "migrate_export", "migrate_adopt",
        "migrate_commit"]


# ------------------------------------------------------ config and pins


def test_fleet_config_keys_parse(tmp_path):
    p = tmp_path / "c.properties"
    p.write_text("fleet.replicas = 3\nfleet.depth.divergence = 5\n"
                 "fleet.heartbeat.interval_s = 0.5\nfleet.eject.failures = 4\n"
                 "fleet.rebalance.interval_s = 7\n")
    fields = ("fleet_replicas", "fleet_depth_divergence",
              "fleet_heartbeat_interval_s", "fleet_eject_failures",
              "fleet_rebalance_interval_s")
    got, want = ClassifierConfig.from_properties(str(p)), \
        RefConfig.from_properties(str(p))
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field
    for field in fields:
        assert getattr(ClassifierConfig(), field) == getattr(RefConfig(), field)


def _strip_imports(text):
    return [ln for ln in text.splitlines()
            if not ln.lstrip().startswith(("from distel_tpu", "import distel_tpu"))]


def _without_port_note(text):
    """The module without its docstring's closing paragraph that says
    how the port's copy differs (from "The port's copy of" to the
    docstring's end)."""
    start = text.index("\nThe port's copy of ")
    end = text.index('"""', start)
    return text[:start] + text[end:]


def _lockdep_reference_form(port):
    return port.replace('os.sep + "distel_tpu_torch" + os.sep,',
                        'os.sep + "distel_tpu" + os.sep,')


#: the supervisor's adapted sentences, cut from both texts: what a
#: replica process holds (the opening paragraph), what its startup
#: costs (:meth:`start`) and the first line of ``_farm_args``' docstring
_SUPERVISOR_ADAPTED = [
    ("each its own Python interpreter", "\n\nThe supervisor owns"),
    ("Spawns are issued in parallel", "and awaited together."),
    ("The shared spill-dir artifact wire", ": when the farm"),
]


def _supervisor_sentences_cut(text):
    for start, end in _SUPERVISOR_ADAPTED:
        i = text.index(start)
        text = text[:i] + text[text.index(end, i):]
    return text


def _supervisor_reference_form(port):
    return _supervisor_sentences_cut(port).replace(
        '"distel_tpu_torch.cli", "serve",', '"distel_tpu.cli", "serve",')


def _replica_reference_form(port):
    port = port.replace("or not all(_is_journal_op(t) for t in texts)",
                        "or not all(isinstance(t, str) for t in texts)")
    return port[:port.index("\n\n\ndef _is_journal_op(op)")] + "\n"


@pytest.mark.parametrize("rel,to_ref,from_ref", [
    ("testing/lockdep.py", _lockdep_reference_form, lambda r: r),
    ("serve/fleet/supervisor.py", _supervisor_reference_form,
     _supervisor_sentences_cut),
    ("serve/fleet/replica.py", _replica_reference_form, lambda r: r),
], ids=["lockdep", "supervisor", "replica"])
def test_adapted_module_is_the_reference_but_its_named_lines(rel, to_ref, from_ref):
    """The adapted copies equal the reference's text but the lines their
    docstrings name: lockdep's tracked path, the supervisor's spawned
    module, the replica's check of a journal."""
    port = (ROOT / "distel_tpu_torch" / rel).read_text()
    ref = (ROOT / "distel_tpu" / rel).read_text()
    assert _strip_imports(to_ref(_without_port_note(port))) == \
        _strip_imports(from_ref(ref))
    assert to_ref(port) != port  # the adapted line is there


def test_supervisor_spawns_the_port_and_hands_no_farm_on(tmp_path, monkeypatch):
    """A replica is ``python -m distel_tpu_torch.cli serve`` with the
    caller's arguments (``--device`` among them); an artifact-farm
    manifest in the shared spill dir is handed on to every replica
    (``_farm_args``), and an explicit ``--artifacts-dir`` wins.  (The
    name is kept from when the port had no farm and handed none on.)"""
    farm = tmp_path / "spill" / "artifacts"
    farm.mkdir(parents=True)
    (farm / "manifest.json").write_text("{}")
    seen = []

    class _Proc:
        returncode = None

        def poll(self):
            return None

    def popen(argv, **kw):
        seen.append((argv, kw))
        return _Proc()

    monkeypatch.setattr(fleet_supervisor.subprocess, "Popen", popen)
    sup = ReplicaSupervisor(2, spill_dir=str(tmp_path / "spill"),
                            extra_args=["--device", "cpu"], env={"X": "1"})
    for rid in ("r0", "r1"):
        sup._spawn(rid)
    for (argv, kw), rid in zip(seen, ("r0", "r1")):
        assert argv[1:4] == ["-m", "distel_tpu_torch.cli", "serve"]
        assert argv[argv.index("--replica-id") + 1] == rid
        assert argv[-2:] == ["--device", "cpu"]
        assert argv[argv.index("--artifacts-dir") + 1] == str(farm)
        assert kw["env"] == {"X": "1"}
    explicit = ReplicaSupervisor(1, spill_dir=str(tmp_path / "spill"),
                                 extra_args=["--artifacts-dir", "other"])
    assert explicit._farm_args() == []


def test_lockdep_tracks_the_ports_locks():
    """The port's lockdep tracks locks the port allocates (the adapted
    path), and reports an inversion between two of them."""
    table = PlacementTable()
    assert isinstance(table._lock, lockdep._TrackedLock)
    assert table._lock._site.startswith("distel_tpu_torch/serve/fleet/placement.py:")
    first = threading.Lock()
    second = threading.Lock()   # another allocation site: another class
    assert isinstance(first, lockdep._TrackedLock)
    with first:
        with second:
            pass
    with second:
        with first:
            pass
    with pytest.raises(lockdep.LockOrderViolation, match="inversion"):
        lockdep.check()


# -------------------------------------------------- cli fleet, processes


@contextlib.contextmanager
def _time_limit(seconds):
    """Fail (not hang) a test whose process tree stops answering."""
    def _expired(signum, frame):
        raise TimeoutError(f"test ran past its {seconds} s limit")

    prev = signal.signal(signal.SIGALRM, _expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _children(pid):
    """{replica id: pid} of the fleet process's replica children."""
    out = {}
    for task in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{task}/children") as f:
                kids = f.read().split()
        except OSError:
            continue
        for kid in kids:
            try:
                with open(f"/proc/{kid}/cmdline", "rb") as f:
                    argv = f.read().decode().split("\0")
            except OSError:
                continue
            if "--replica-id" in argv:
                out[argv[argv.index("--replica-id") + 1]] = int(kid)
    return out


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def test_cli_fleet_survives_a_killed_replica(tmp_path):
    spill = tmp_path / "spill"
    replica_pids = set()
    proc = subprocess.Popen(
        [sys.executable, "-m", "distel_tpu_torch.cli", "fleet", "--replicas",
         "2", "--device", "cpu", "--port", "0", "--spill-dir", str(spill),
         "--fast-path-min-concepts", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        with _time_limit(240):
            ready, _, _ = select.select([proc.stdout], [], [], 180)
            assert ready, "cli fleet printed nothing in 180 s"
            doc = json.loads(proc.stdout.readline())
            assert doc["serving"] is True and doc["role"] == "fleet-router"
            assert [r["id"] for r in doc["replicas"]] == ["r0", "r1"]
            url = f"http://127.0.0.1:{doc['port']}"
            c = ServeClient(url, timeout=120)
            a = c.load(BASE)["id"]
            b = c.load(ONTO_B)["id"]
            c.delta(a, DELTA)
            want = {a: c.taxonomy(a), b: c.taxonomy(b)}
            status = _get(url + "/fleet/status")
            victim = status["placement"][a]
            pids = _children(proc.pid)
            replica_pids |= set(pids.values())
            assert sorted(pids) == ["r0", "r1"]
            os.kill(pids[victim], signal.SIGKILL)
            # the heartbeat ejects it, the supervisor respawns it, the
            # journal replays its tenant onto a healthy replica
            deadline = time.monotonic() + 150
            while True:
                assert time.monotonic() < deadline, "no recovery in 150 s"
                page = c.metrics_text()
                m = re.search(r"^distel_fleet_recoveries_total (\S+)$", page, re.M)
                health = _get(url + "/healthz")
                if m and float(m.group(1)) >= 1 and \
                        all(r["healthy"] for r in health["replicas"]):
                    break
                time.sleep(0.5)
            respawned = _children(proc.pid)
            replica_pids |= set(respawned.values())
            assert sorted(respawned) == ["r0", "r1"]
            assert respawned[victim] != pids[victim]
            for oid, tax in want.items():
                assert c.taxonomy(oid) == tax, oid
            assert c.subsumers(a, "New0")["subsumers"] == \
                _direct_taxonomy([BASE, DELTA]).subsumers["New0"]
            events = _get(url + "/debug/events?kind=respawn")["events"]
            assert events and events[-1]["ok"] is True
            proc.send_signal(signal.SIGTERM)
            tail, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        end = json.loads(tail.strip().splitlines()[-1])
        assert end["shutdown"] == "graceful" and end["replicas"] == 2
        assert (spill / "flight_router.jsonl").exists()
        assert (spill / "logs" / "r0.log").exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
        # a killed router leaves its replicas behind
        for pid in replica_pids:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
