"""The port's serve plane against the reference's.

Both packages' ``ServeApp`` answer the same requests in-process, behind
a live loopback HTTP server each: ``distel_tpu``'s with
``ClassifierConfig(shape_buckets=False)`` (the exact-layout contract
the port's other parity tests hold it to), ``distel_tpu_torch``'s with
the same and ``device="cpu"`` (plain versions).  Every answer must be
equal — taxonomies, subsumers, snapshot reads, versions, write records
— tolerance 0.  The write records also carry each package's own
program-build record (``COMPILE_KEYS``: the reference's exact engines
compile XLA programs, the port's build nothing); those keys are set
aside before comparing.

Also here: the registry's evict → warm → cold → restore churn against
the reference's, the query snapshot against the taxonomy, the refused
keys and flags, ``/metrics`` against the reference's series minus
``NOT_YET_PORTED``, the modules copied verbatim, concurrent tenants
against serial ones, and ``cli serve | query | trace`` end to end.
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
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.obs.flight import FlightRecorder as RefFlight
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from distel_tpu.serve.client import ServeClient as RefClient
from distel_tpu.serve.metrics import Metrics as RefMetrics
from distel_tpu.serve.query import OntologySnapshot as RefSnapshot
from distel_tpu.serve.query import SnapshotStore as RefStore
from distel_tpu.serve.registry import OntologyRegistry as RefRegistry
from distel_tpu.serve.server import ServeApp as RefApp
from distel_tpu.serve.server import make_server as ref_make_server
from distel_tpu.serve.traces import replay_trace as ref_replay
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu_torch.obs.flight import FlightRecorder
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from distel_tpu_torch.serve import server as serve_server
from distel_tpu_torch.serve.client import ServeClient
from distel_tpu_torch.serve.metrics import Metrics
from distel_tpu_torch.serve.query import OntologySnapshot, SnapshotStore
from distel_tpu_torch.serve.registry import OntologyRegistry
from distel_tpu_torch.serve.server import ServeApp, make_server
from distel_tpu_torch.serve.traces import load_trace, replay_trace
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TRACE = ROOT / "traces" / "mixed_add_retract_query.jsonl"
#: the reference's per-increment XLA program-build record
#: (``CompileStats.as_dict``) and its delta-program registry's record
#: (the bucket signature and registry hits of a fast-path delta),
#: merged into its write records
COMPILE_KEYS = {"bucket_signature", "program", "trace_lower_s", "compile_s",
                "program_cache_hit", "persistent_cache_hits",
                "persistent_cache_misses", "delta_signature",
                "delta_program_hits"}
#: answer fields that are wall-clock readings
CLOCK_KEYS = {"published_unix", "wall_s"}
#: the client calls a trace replay makes, whose answers are recorded
CALLS = ("load", "delta", "retract", "taxonomy", "subsumers",
         "query_subsumers", "snapshot_version")
#: what the port's serve plane leaves out, and the module each waits for
NOT_YET_PORTED: dict = {}
#: a series the port samples from a process aggregate, so it is always
#: there (kernel libraries found built); the reference's counts its XLA
#: disk-cache hits and appears once one happened
PROCESS_SERIES = {"distel_persistent_cache_hits_total"}
#: series the reference's exact-shape runs fill from their XLA compiles;
#: the port's exact-shape engines build no program, so its exact runs
#: record none (bucketed runs do: ``tests/test_torch_warmup.py``)
EXACT_BUILD_SERIES = {"distel_compile_seconds", "distel_program_cache_misses_total"}


def _plain(doc):
    """An answer without the reference's compile record and clock
    readings."""
    if isinstance(doc, dict):
        return {k: v for k, v in doc.items()
                if k not in COMPILE_KEYS | CLOCK_KEYS}
    return doc


@contextlib.contextmanager
def _serving(app, make, client_cls):
    server = make(app)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    client = client_cls(f"http://127.0.0.1:{server.server_address[1]}",
                        timeout=300)
    try:
        yield client
    finally:
        server.shutdown()
        server.server_close()
        app.close(final_spill=False)
        thread.join(timeout=10)
        assert not thread.is_alive()


def _recording(client):
    """Wrap ``client``'s request calls so every answer is kept, in order,
    on ``client.answers``."""
    client.answers = []
    for name in CALLS:
        fn = getattr(client, name)

        def call(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            client.answers.append((_name, out))
            return out

        setattr(client, name, call)
    return client


def _series(metrics_text: str) -> set:
    """Metric family names with samples in a /metrics page."""
    names = set()
    for ln in metrics_text.splitlines():
        if ln and not ln.startswith("#"):
            name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", ln).group(0)
            names.add(re.sub(r"_(bucket|sum|count|max)$", "", name))
    return names


def _replay(app, make, client_cls, replay):
    with _serving(app, make, client_cls) as client:
        _recording(client)
        rec = replay(load_trace(str(TRACE)), client)
        return rec, client.answers, client.metrics_text()


ENGINES = ("auto", "packed")


@pytest.fixture(scope="module", params=ENGINES)
def replays(request):
    """The tracked mixed trace replayed through both packages' serve
    apps on ``engine``: ``(ref, port)``, each ``(record, answers,
    metrics page)``."""
    engine = request.param
    ref = _replay(RefApp(RefConfig(shape_buckets=False, engine=engine)),
                  ref_make_server, RefClient, ref_replay)
    port = _replay(ServeApp(ClassifierConfig(engine=engine, shape_buckets=False),
                            device="cpu"),
                   make_server, ServeClient, replay_trace)
    return ref, port


def test_trace_replay_matches_reference(replays):
    (rrec, rans, _), (prec, pans, _) = replays
    assert prec["failed_requests"] == rrec["failed_requests"] == 0
    assert prec["skipped_migrates"] == rrec["skipped_migrates"] == 1
    assert {k: v for k, v in prec.items() if k != "wall_s"} == \
        {k: v for k, v in rrec.items() if k != "wall_s"}
    assert [n for n, _ in pans] == [n for n, _ in rans]
    assert len(pans) == 15
    for i, ((name, r), (_, p)) in enumerate(zip(rans, pans)):
        assert _plain(p) == _plain(r), (i, name)


def test_metrics_series_are_the_reference_minus_not_yet_ported(replays):
    (_, _, rmet), (_, _, pmet) = replays
    assert serve_server.NOT_YET_PORTED == NOT_YET_PORTED
    ref, port = _series(rmet), _series(pmet)
    assert port - PROCESS_SERIES == \
        ref - set(NOT_YET_PORTED) - EXACT_BUILD_SERIES - PROCESS_SERIES
    assert PROCESS_SERIES <= port
    assert "distel_requests_total" in port and "distel_retract_total" in port


def test_debug_runs_waits_for_the_ledger():
    """``/debug/runs`` serves the run ledger's telemetry: the
    reference's document shape.  (The name is kept from when the route
    answered 404 until the ledger was ported; the ledger is here now,
    so the route no longer waits for it.)"""
    app = ServeApp(device="cpu")
    try:
        status, _, body = app.dispatch("GET", "/debug/runs", {}, b"", None)
        doc = json.loads(body)
        assert status == 200 and set(doc) == {"service", "runs"}
        assert isinstance(doc["runs"], list)
        status, _, body = app.dispatch("GET", "/healthz", {}, b"", None)
        assert status == 200 and json.loads(body)["warmup_done"] is True
    finally:
        app.close(final_spill=False)


# ------------------------------------------------------ tiers and restore

def _without_ranges(text):
    """The SNOMED-shaped corpora carry one ``ObjectPropertyRange`` axiom,
    under which both packages refuse retraction."""
    return "".join(ln + "\n" for ln in text.splitlines()
                   if not ln.startswith("ObjectPropertyRange("))


TIER_BASE = snomed_shaped_ontology(n_classes=300, seed=3)
TIER_OTHER = _without_ranges(snomed_shaped_ontology(n_classes=200, seed=4))
TIER_DELTAS = ("SubClassOf(TierX Find3)\n",
               "SubClassOf(TierY ObjectSomeValuesFrom(attr1 Find5))\n")


def _churn(registry, metrics, flight):
    """Two tenants under a one-byte card budget: each write to one
    demotes the other (to the warm tier, or with no warm budget to a
    cold spill), and the next write to it promotes or restores it."""
    out = []
    a, b = registry.new_id(), registry.new_id()
    out.append(registry.load(a, TIER_BASE))
    out.append(registry.load(b, TIER_OTHER))
    out.append(registry.tier_stats())
    out.append(registry.delta(a, [TIER_DELTAS[0]]))      # promote / restore a
    out.append(registry.tier_stats())
    out.append(registry.delta(b, [TIER_DELTAS[1]]))      # promote / restore b
    out.append(registry.retract(b, TIER_DELTAS[1]))
    out.append(registry.delta(a, [TIER_DELTAS[1]]))
    out.append(registry.tier_stats())
    taxes = {}
    for oid in (a, b):
        inc = registry.classifier(oid)
        taxes[oid] = inc.last_result
    out.append(registry.spill_all())
    events = [(e["kind"], e.get("oid"), e.get("tier"), e.get("to"))
              for e in flight.events()]
    return out, taxes, events, _counters(metrics.render())


def _counters(text):
    """Every counter sample of a metrics page, but those of series the
    port leaves out, or fills only in bucketed runs."""
    out = {}
    for ln in text.splitlines():
        name, _, value = ln.rpartition(" ")
        if name.startswith("distel_") and "_total" in name and \
                name.split("{")[0] not in {*NOT_YET_PORTED, *EXACT_BUILD_SERIES,
                                           *PROCESS_SERIES}:
            out[name] = float(value)
    return out


@pytest.mark.parametrize("warm_mb", [64, 0], ids=["warm", "cold"])
def test_registry_tier_churn_matches_reference(tmp_path, warm_mb):
    runs = {}
    for who, Registry, Config, Met, Flight, Store, kw in (
        ("ref", RefRegistry, lambda: RefConfig(shape_buckets=False), RefMetrics,
         RefFlight, RefStore, {}),
        ("port", OntologyRegistry, lambda: ClassifierConfig(shape_buckets=False),
         Metrics, FlightRecorder, SnapshotStore, {"device": "cpu"}),
    ):
        metrics, flight = Met(), Flight(service="serve")
        registry = Registry(
            Config(), memory_budget_bytes=1, spill_dir=str(tmp_path / who),
            metrics=metrics, flight=flight, warm_budget_bytes=warm_mb << 20,
            fast_path_min_concepts=0, query=Store(), **kw)
        runs[who] = (_churn(registry, metrics, flight), registry)
    (rout, rres, rev, rcnt), ref_reg = runs["ref"]
    (pout, pres, pev, pcnt), port_reg = runs["port"]
    assert len(pout) == len(rout)
    for i, (r, p) in enumerate(zip(rout, pout)):
        if isinstance(r, list):   # spill paths: same names, other dirs
            assert [os.path.basename(x) for x in p] == \
                [os.path.basename(x) for x in r]
        elif "cold_bytes" in r:
            # a compressed spill's size moves with its metadata's clock
            # reading; the tiers' counts and the other bytes may not
            assert (p["cold_bytes"] > 0) == (r["cold_bytes"] > 0) == \
                (r["cold_ontologies"] > 0), i
            assert {**p, "cold_bytes": 0} == {**r, "cold_bytes": 0}, i
        else:
            assert _plain(p) == _plain(r), i
    assert pev == rev
    assert pcnt == rcnt
    want = ["warm", "warm"] if warm_mb else ["cold", "cold"]
    assert [e[3] for e in pev if e[0] == "registry_evict"][:2] == want
    kinds = {e[0] for e in pev}
    assert ("tier_promote" if warm_mb else "registry_restore") in kinds
    for oid in rres:
        assert _key(extract_taxonomy(pres[oid])) == _key(ref_taxonomy(rres[oid]))
        snap = port_reg.query.get(oid)
        ref_snap = ref_reg.query.get(oid)
        assert snap.version == ref_snap.version
        assert np.array_equal(snap.s_wire, ref_snap.s_wire)
    # the last state of tenant a equals a from-scratch classify
    batch = ELClassifier(ClassifierConfig(use_native_loader=False),
                         device="cpu").classify_text(
        TIER_BASE + "".join(TIER_DELTAS))
    assert _key(extract_taxonomy(pres["ont-0001"])) == _key(batch.taxonomy)


def _key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


@pytest.mark.parametrize("engine", ["rowpacked", "packed"])
def test_cold_spill_restores_after_a_warm_spill(tmp_path, engine):
    """A warm entry spilled to cold without promoting first (the warm
    view over the demoted host state: packed words, or the packed
    engine's x-major bools) restores to the same closure."""
    reg = OntologyRegistry(ClassifierConfig(engine=engine), device="cpu",
                           memory_budget_bytes=1,
                           spill_dir=str(tmp_path), warm_budget_bytes=1 << 30,
                           fast_path_min_concepts=0, query=SnapshotStore())
    a, b = reg.new_id(), reg.new_id()
    reg.load(a, TIER_BASE)
    before = reg.classifier(a).last_result.wire()
    reg.load(b, TIER_OTHER)                    # a -> warm
    assert reg.tier_stats()["warm_ontologies"] == 1
    reg.warm_budget_bytes = 1
    reg._shed_warm()                           # a -> cold, from the warm view
    assert reg.tier_stats()["cold_ontologies"] == 1
    after = reg.classifier(a).last_result.wire()
    assert all(np.array_equal(x, y) for x, y in zip(before, after))


# ------------------------------------------------------------ snapshots

SNAP_TEXTS = [snomed_shaped_ontology(n_classes=400, seed=7),
              "SubClassOf(SnapA Find2)\nSubClassOf(SnapA Find3)\n"
              "EquivalentClasses(SnapB Find2)\nDisjointClasses(SnapC Find4)\n"
              "SubClassOf(SnapC Find4)\n"]


def _port_inc():
    from distel_tpu_torch.core.incremental import IncrementalClassifier

    port = IncrementalClassifier(device="cpu")
    for t in SNAP_TEXTS:
        port.add_text(t)
    return port


def test_snapshot_answers_match_the_taxonomy():
    from distel_tpu.core.incremental import IncrementalClassifier as RefInc

    ref = RefInc(RefConfig(shape_buckets=False))
    for t in SNAP_TEXTS:
        ref.add_text(t)
    port = _port_inc()
    snap = OntologySnapshot.from_result("o", 1, port.increment, port.last_result)
    ref_snap = RefSnapshot.from_result("o", 1, ref.increment, ref.last_result)
    assert np.array_equal(snap.s_wire, ref_snap.s_wire)
    assert snap.sig_names == ref_snap.sig_names
    tax = extract_taxonomy(port.last_result)
    rng = np.random.default_rng(0)
    names = sorted(tax.subsumers)
    sample = sorted(set(rng.choice(names, 60, replace=False).tolist())
                    | {"SnapA", "SnapB", "SnapC", "Find2"})
    unsat = set(tax.unsatisfiable)
    assert "SnapC" in unsat
    for n in sample:
        assert snap.subsumers(n) == tax.subsumers[n] == ref_snap.subsumers(n), n
        assert snap.slice(n) == ref_snap.slice(n), n
        assert set(snap.equivalents(n)) - {n} == \
            set(tax.equivalents.get(n, [])) - {n} or n in unsat, n
        for m in sample[:12]:
            want = n == m or n in unsat or m in tax.subsumers[n] or \
                m in tax.equivalents.get(n, [])
            assert snap.is_subsumed(n, m) == want == ref_snap.is_subsumed(n, m)


def test_snapshot_is_a_copy_of_the_state():
    """A published snapshot is frozen: the next increment's in-place
    writes on the CPU state never reach it."""
    port = _port_inc()
    snap = OntologySnapshot.from_result("o", 1, 1, port.last_result)
    held = snap.s_wire.copy()
    port.add_text("SubClassOf(Find2 Later)\n")
    assert np.array_equal(snap.s_wire, held)


# --------------------------------------------------------------- refusals

#: keys of paths the serve plane does not have (``fused.rounds.k`` > 1
#: runs the fused window since it was ported: ``tests/test_torch_fused.py``;
#: ``artifacts.dir`` parses since the farm was ported:
#: ``tests/test_torch_artifacts.py``; ``ServeApp`` serves on a mesh since
#: the serve mesh was ported, ``tests/test_torch_serve_mesh.py``, and a
#: serve fleet replica, which has no mesh mode, refuses the mesh keys)
REFUSED_KEYS = {"mesh.devices": "2", "coordinator.address": "host:1234"}


@pytest.mark.parametrize("key", sorted(REFUSED_KEYS))
def test_refused_config_keys_raise(tmp_path, key):
    p = tmp_path / "c.properties"
    p.write_text(f"{key} = {REFUSED_KEYS[key]}\n")
    with pytest.raises(NotImplementedError,
                       match=f"the serve fleet does not run.*{re.escape(key)}"):
        cli.main(["serve", "--device", "cpu", "--replica-id", "r0", "--spill-dir",
                  str(tmp_path / "spill"), "--config", str(p)])


def test_serve_config_keys_parse(tmp_path):
    p = tmp_path / "c.properties"
    p.write_text("obs.enable = false\nobs.sample_rate = 0.5\n"
                 "obs.ring.capacity = 16\nobs.flight.capacity = 32\n"
                 "query.enable = false\nquery.row.cache = 8\n"
                 "cohort.enable = false\ncohort.max_size = 4\n"
                 "cohort.max_wait_ms = 5\nstorage.compress.spills = false\n"
                 "storage.warm.budget.mb = 12\n"
                 "storage.ewma.halflife_s = 9\n"
                 "storage.prefetch.interval_s = 0\n")
    got = ClassifierConfig.from_properties(str(p))
    want = RefConfig.from_properties(str(p))
    for field in ("obs_enable", "obs_sample_rate", "obs_ring_capacity",
                  "obs_flight_capacity", "query_enable", "query_row_cache",
                  "cohort_enable", "cohort_max_size", "cohort_max_wait_ms",
                  "storage_compress_spills", "storage_warm_budget_mb",
                  "storage_ewma_halflife_s", "storage_prefetch_interval_s"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.tracer_kwargs() == want.tracer_kwargs()
    defaults, ref_defaults = ClassifierConfig(), RefConfig()
    for field in ("obs_enable", "query_enable", "query_row_cache",
                  "storage_warm_budget_mb", "storage_prefetch_interval_s",
                  "cohort_max_size"):
        assert getattr(defaults, field) == getattr(ref_defaults, field), field


def test_warmup_paths_are_refused():
    """The startup warmup is ported (``runtime/warmup.py``): a warmup
    path it cannot read is refused by the warmup thread — counted on
    ``distel_warmup_errors_total``, as the reference counts it — and the
    app serves all the same."""
    app = ServeApp(device="cpu", warmup_paths=["no-such-dir/a.ofn"])
    try:
        assert app.warmup_wait(60)
        _, _, page = app.dispatch("GET", "/metrics", {}, b"", None)
        assert "distel_warmup_errors_total 1" in page.decode()
        status, _, _ = app.dispatch("GET", "/healthz", {}, b"", None)
        assert status == 200
    finally:
        app.close(final_spill=False)


#: the farm's flags are ported: under ``--artifacts-require`` a farm
#: that is not there is refused before anything binds or starts
REFUSED_FLAGS = [["--warmup", "a.ofn", "--artifacts-dir", "no-such-farm",
                  "--artifacts-require"],
                 ["--artifacts-dir", "no-such-farm", "--artifacts-require"],
                 ["--artifacts-require", "--artifacts-dir", "no-such-farm"]]


@pytest.mark.parametrize("flag", REFUSED_FLAGS, ids=lambda f: f[0])
def test_refused_serve_flags_raise(flag):
    """``cli serve --artifacts-require`` with no farm raises before it
    binds.  (The name is kept from when the port refused the farm's
    flags.)"""
    from distel_tpu_torch.core.artifacts import ArtifactError

    with pytest.raises(ArtifactError, match="no artifact manifest"):
        cli.main(["serve", "--device", "cpu", "--port", "0", *flag])


@pytest.mark.parametrize("flag", REFUSED_FLAGS, ids=lambda f: f[0])
def test_refused_fleet_flags_raise(flag, tmp_path):
    """``cli fleet --artifacts-require`` with no farm raises before it
    starts a replica.  (The name is kept from when the port refused the
    farm's flags.)"""
    from distel_tpu_torch.core.artifacts import ArtifactError

    with pytest.raises(ArtifactError, match="no artifact manifest"):
        cli.main(["fleet", "--device", "cpu", "--spill-dir", str(tmp_path),
                  *flag])
    assert not (tmp_path / "logs").exists()


def test_serve_replica_id_needs_a_spill_dir(capsys):
    """``serve --replica-id`` runs a fleet replica, whose handoffs spill
    through ``--spill-dir``: without one it exits 2, as the
    reference's does."""
    assert cli.main(["serve", "--device", "cpu", "--replica-id", "r0"]) == 2
    assert "--spill-dir" in capsys.readouterr().err


def test_cohort_lane_never_forms_on_exact_engines():
    """An exact-shape base has no cohort key, and ``delta_cohort``
    answers such a member through the solo fallback (counted), as the
    reference's registry does."""
    from distel_tpu_torch.serve.metrics import Metrics

    metrics = Metrics()
    reg = OntologyRegistry(ClassifierConfig(shape_buckets=False), device="cpu",
                           metrics=metrics, fast_path_min_concepts=0)
    oid = reg.new_id()
    reg.load(oid, TIER_OTHER)
    assert reg.cohort_key(oid) is None
    out = reg.delta_cohort([(oid, ["SubClassOf(Q Find1)"])])
    assert out[oid]["path"] == "fast", out[oid]
    assert metrics.counter_value("distel_cohort_fallback_total") == 1
    assert metrics.counter_value("distel_cohort_formed_total") == 0


# ------------------------------------------------- threads and the CLI


@pytest.fixture
def lockdep_armed():
    """The port's runtime lockdep, armed as the reference's conftest arms
    its own for ``test_serve_concurrency``: a lock-order inversion
    observed on any schedule fails the test."""
    from distel_tpu_torch.testing import lockdep

    lockdep.enable()
    try:
        yield
        lockdep.check()
    finally:
        lockdep.disable()


def test_concurrent_tenants_equal_serial_requests(lockdep_armed):
    """Two tenants' deltas and reads from eight client threads through
    four workers answer as the same requests one at a time (under the
    port's runtime lockdep)."""
    texts = {"a": snomed_shaped_ontology(n_classes=300, seed=11),
             "b": snomed_shaped_ontology(n_classes=250, seed=12)}
    deltas = {k: [f"SubClassOf(Conc{k}{i} Find{i + 2})\n" for i in range(4)]
              for k in texts}

    def serve(concurrent):
        app = ServeApp(device="cpu", workers=4, max_batch=1,
                       fast_path_min_concepts=0)
        with _serving(app, make_server, ServeClient) as c:
            ids = {k: c.load(t)["id"] for k, t in texts.items()}
            jobs = [(k, d) for k in texts for d in deltas[k]]
            errors = []

            def send(k, d):
                try:
                    c.delta(ids[k], d)
                    c.query_subsumers(ids[k], "Find2")
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            if concurrent:
                old = sys.getswitchinterval()
                sys.setswitchinterval(1e-5)
                try:
                    threads = [threading.Thread(target=send, args=j) for j in jobs]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=120)
                        assert not t.is_alive()
                finally:
                    sys.setswitchinterval(old)
            else:
                for j in jobs:
                    send(*j)
            assert not errors
            return {k: c.taxonomy(oid) for k, oid in ids.items()}

    serial, concurrent = serve(False), serve(True)
    for k in texts:
        for part in ("parents", "equivalents", "unsatisfiable"):
            assert concurrent[k][part] == serial[k][part], (k, part)


@pytest.mark.parametrize("drop", ["demote", "drop_base_program"])
def test_dropped_engines_go_without_a_collection(drop):
    """An evicted tenant's engine (and its tables on the card) is freed
    when the classifier lets go of it, with the cyclic garbage collector
    off: no reference cycle holds it until a collection."""
    import gc
    import weakref

    from distel_tpu_torch.core.incremental import IncrementalClassifier

    inc = IncrementalClassifier(device="cpu")
    inc.add_text(TIER_OTHER)
    engine = weakref.ref(inc._base_engine)
    state = weakref.ref(inc._state[0])
    gc.disable()
    try:
        getattr(inc, drop)()
        assert engine() is None
        if drop == "demote":
            assert state() is None
    finally:
        gc.enable()


def test_launch_counts_lose_nothing_across_threads():
    """Scheduler workers launch from several threads: the launch counts
    are locked read-modify-writes."""
    from distel_tpu_torch.ops import bitmatmul

    bitmatmul.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            bitmatmul._count_launch("packed_cols_dense") for _ in range(20000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert bitmatmul.LAUNCHES["packed_cols_dense"] == 8 * 20000
    bitmatmul.reset_launches()


def _post(url, doc):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_cli_serve_query_trace_and_graceful_spill(tmp_path):
    spill = tmp_path / "spill"
    proc = subprocess.Popen(
        [sys.executable, "-m", "distel_tpu_torch.cli", "serve", "--port", "0",
         "--device", "cpu", "--spill-dir", str(spill)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120)
        assert ready, "cli serve printed nothing in 120 s"
        line = proc.stdout.readline()
        doc = json.loads(line)
        assert doc["serving"] is True
        url = f"http://127.0.0.1:{doc['port']}"
        rec = _post(url + "/v1/ontologies",
                    {"text": "SubClassOf(A B)\nSubClassOf(B C)\n"})
        oid = rec["id"]
        _post(url + f"/v1/ontologies/{oid}/deltas", {"text": "SubClassOf(D A)"})
        out = subprocess.run(
            [sys.executable, "-m", "distel_tpu_torch.cli", "query", oid,
             "subsumers", "D", "--url", url],
            cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
        got = json.loads(out.stdout)
        assert got["subsumers"] == ["A", "B", "C"] and got["version"] == 2
        trace = tmp_path / "t.json"
        out = subprocess.run(
            [sys.executable, "-m", "distel_tpu_torch.cli", "trace", "--format",
             "chrome", "-o", str(trace), "--url", url],
            cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
        assert json.loads(out.stdout)["records"] > 0
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert "http /v1/ontologies/{id}/deltas" in names
        proc.send_signal(signal.SIGTERM)
        tail, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        end = json.loads(tail.strip().splitlines()[-1])
        assert end["shutdown"] == "graceful"
        assert [os.path.basename(p) for p in end["spilled"]] == \
            [f"{oid}.snapshot.npz"]
        assert (spill / f"{oid}.snapshot.npz.sha256").exists()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


# ------------------------------------------------------ verbatim copies

#: modules copied from the reference with no import line of either
#: package: equal to it byte for byte (the others are pinned by
#: ``tests/test_torch_frontend.py::test_module_is_a_copy_apart_from_imports``)
IMPORT_FREE_COPIES = ("obs/trace.py", "serve/metrics.py", "serve/storage/tiers.py",
                      "serve/fleet/placement.py")


@pytest.mark.parametrize("rel", IMPORT_FREE_COPIES)
def test_import_free_module_is_a_copy(rel):
    port = (ROOT / "distel_tpu_torch" / rel).read_text()
    assert "distel_tpu." not in "\n".join(
        ln for ln in port.splitlines() if ln.lstrip().startswith(("from ", "import ")))
    assert port == (ROOT / "distel_tpu" / rel).read_text()
