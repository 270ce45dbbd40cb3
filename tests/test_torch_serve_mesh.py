"""The port's serve plane on a mesh against the reference's, on the CPU.

The reference's ``ServeApp`` on a mesh is one process whose tenants
shard over the virtual CPU mesh ``tests/conftest.py`` forces.  The
port's is rank 0 of a gloo group (``serve/mesh_ops.py``): its registry
publishes every card-touching operation to the other ranks, which apply
it in order.  ``ServeApp(ClassifierConfig(mesh_devices=n), device=
"cpu")`` spawns the n - 1 other ranks itself; ``mesh_report="state"``
makes every rank answer each write with its tenant's history record and
live S and R, which the op log keeps.

The traffic (``_traffic``) is the incremental parity traffic at 600
classes, through ``dispatch``: a SNOMED-shaped base without its range
axiom, a class-only, a link and a role delta, the retraction of the
class-only delta, reads after every write (the taxonomy, subsumers
through the scheduler and through the snapshot plane), then a second
tenant under a one-byte card budget: one eviction to the warm tier and a
promotion, then (warm budget one byte) evictions to the cold tier and
restores, some of them behind a read.  Every answer, every committed
history record and S and R over the live universe on every rank, and
the tier decisions are held, tolerance 0, to the reference's
``ServeApp``: on a mesh of the same size for the exact layout
(``shape_buckets = false``), solo for the bucketed default (the
reference's bucketed mesh run takes 12 iterations for the role delta
where its solo run and the port's mesh run take 14; ``ROADMAP.md``,
Reference caveats).

Also here: two tenants' writes from two threads equal serial ones; a
prefetch promotes a warm tenant on every rank; a follower killed mid-traffic fails the next write with 503 naming the
mesh and turns ``/healthz`` to 503, and rank 0 commits nothing alone;
an idle mesh outlives its collective timeout; ``cli serve`` with
``mesh.devices = 2`` (and with the coordinator keys) over loopback HTTP
answers as solo ``cli serve``, and on SIGTERM every rank exits 0 with
the gathered snapshots in the spill dir; the fleet refuses a mesh
config by name.  Each launch's collectives are bounded by ``TIMEOUT_S``.
"""

import json
import os
import re
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.serve.server import ServeApp as RefApp
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu_torch.runtime.checkpoint import load_snapshot
from distel_tpu_torch.serve.server import HTTPError, ServeApp
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
#: the collective timeout of every launch here: a hang fails a test
#: well inside the suite's clock
TIMEOUT_S = 60.0


def _without_ranges(text):
    return "".join(ln + "\n" for ln in text.splitlines()
                   if not ln.startswith("ObjectPropertyRange("))


BASE = _without_ranges(snomed_shaped_ontology(n_classes=600))
OTHER = _without_ranges(snomed_shaped_ontology(n_classes=200, seed=4))
_FINDS = sorted(set(re.findall(r"\bFind\d+\b", BASE)), key=lambda s: int(s[4:]))
_ROLES = sorted(set(re.findall(r"\battr\d+\b", BASE)), key=lambda s: int(s[4:]))
CLASS_DELTA = "\n".join(
    f"SubClassOf(IncDelta{i} {_FINDS[(i * 7) % len(_FINDS)]})" for i in range(20))
LINK_DELTA = (
    "SubObjectPropertyOf(incNewRole attr0)\n"
    + "\n".join(f"SubClassOf(IncR{i} ObjectSomeValuesFrom(incNewRole "
                f"{_FINDS[(i * 11) % len(_FINDS)]}))" for i in range(10))
    + f"\nSubClassOf(ObjectSomeValuesFrom(incNewRole {_FINDS[11]}) IncRoleHit)"
)
ROLE_DELTA = f"SubObjectPropertyOf({_ROLES[1]} {_ROLES[2]})"
OTHER_DELTA = "SubClassOf(TierX ObjectSomeValuesFrom(attr1 Find5))"
LATE_DELTA = "SubClassOf(TierY Find3)"

#: the reference's program-build record and the clock readings in its
#: answers (as ``tests/test_torch_serve.py`` sets them aside); a delta
#: signature also names the mesh
UNSTABLE = {"bucket_signature", "program", "trace_lower_s", "compile_s",
            "program_cache_hit", "persistent_cache_hits",
            "persistent_cache_misses", "delta_signature",
            "delta_program_hits", "published_unix", "wall_s", "uptime_s"}
#: flight events of the tier ladder
TIER_EVENTS = {"registry_evict", "tier_demote", "tier_promote",
               "registry_restore", "registry_spill"}

#: layout -> (config, mesh sizes, whether the reference runs on a mesh
#: of the same size; else solo)
LAYOUTS = {
    "exact": ({"shape_buckets": False}, (2, 4), True),
    "bucketed": ({}, (2,), False),
}
CASES = [(lay, n) for lay, (_c, sizes, _m) in LAYOUTS.items() for n in sizes]
CASE_IDS = [f"{lay}-{n}" for lay, n in CASES]
#: the cases that run the second tenant and the tier ladder (the 4-mesh
#: runs the first tenant's traffic alone, to keep the file's clock)
TIER_CASES = [(lay, n) for lay, n in CASES if n == 2]
#: requests of the first tenant's traffic, and of all of it
N_FIRST, N_ALL = 17, 36


def _plain(doc):
    if isinstance(doc, dict):
        return {k: _plain(v) for k, v in doc.items() if k not in UNSTABLE}
    return doc


def _dispatch(app, method, path, text=None, **query):
    body = json.dumps({"text": text}).encode() if text is not None else b""
    status, _, raw = app.dispatch(method, path, query, body, None)
    return status, json.loads(raw)


def _budgets(tmp, name):
    return dict(memory_budget_bytes=1, warm_budget_bytes=1 << 30,
                spill_dir=str(tmp / name), fast_path_min_concepts=0)


def _traffic(app, commits, tiers=True):
    """Drive ``app`` through the module's traffic (``tiers``: the second
    tenant and the tier ladder too); after each request ``commits(app)``
    reads what it committed.  Returns the answers and the commits, one
    list a request."""
    answers, per_request = [], []

    def call(method, path, text=None, **query):
        status, doc = _dispatch(app, method, path, text, **query)
        answers.append((method, path, status, _plain(doc)))
        per_request.append(commits(app))
        return doc

    def reads(oid):
        call("GET", f"/v1/ontologies/{oid}/taxonomy")
        call("GET", f"/v1/ontologies/{oid}/subsumers", **{"class": "Find5"})
        call("GET", f"/v1/ontologies/{oid}/query/subsumers", **{"class": "Find5"})

    a = call("POST", "/v1/ontologies", BASE)["id"]
    for kind, text in (("deltas", CLASS_DELTA), ("deltas", LINK_DELTA),
                       ("deltas", ROLE_DELTA), ("retract", CLASS_DELTA)):
        call("POST", f"/v1/ontologies/{a}/{kind}", text)
        reads(a)
    if not tiers:
        return answers, per_request
    b = call("POST", "/v1/ontologies", OTHER)["id"]          # a -> warm
    reads(b)
    call("GET", f"/v1/ontologies/{a}/taxonomy")               # a promoted, b -> warm
    app.registry.warm_budget_bytes = 1                        # a demotion goes on to cold
    call("POST", f"/v1/ontologies/{b}/deltas", OTHER_DELTA)   # b promoted, a -> cold
    reads(b)
    call("GET", f"/v1/ontologies/{a}/taxonomy")               # a restored, b -> cold
    call("POST", f"/v1/ontologies/{a}/deltas", LATE_DELTA)
    reads(a)
    call("POST", f"/v1/ontologies/{b}/retract", OTHER_DELTA)  # b restored, a -> cold
    reads(b)
    call("GET", "/healthz")
    return answers, per_request


def _history(rec):
    """A history record; a restore's names its spill by file name (the
    runs spill into directories of their own)."""
    rec = _plain(dict(rec))
    if "restored_from" in rec:
        rec["restored_from"] = os.path.basename(rec["restored_from"])
    return rec


def _closure(inc):
    res = inc.last_result
    n, nl = res.idx.n_concepts, res.idx.n_links
    return {"history": _history(inc.history[-1]),
            "s": np.asarray(res.s)[:n, :n].copy(),
            "r": np.asarray(res.r)[:n, :nl].copy()}


def _ref_commits():
    """The reference's commits of one request: each tenant whose
    classifier is new or has a new history record, with its closure."""
    seen = {}

    def commits(app):
        out = {}
        for oid, entry in sorted(app.registry._entries.items()):
            inc = entry.inc
            if inc is None or not inc.history:
                continue
            key = (id(inc), len(inc.history))
            if seen.get(oid) != key:
                seen[oid] = key
                out[oid] = [_closure(inc)]
        return out

    return commits


def _port_commits():
    """The port's commits of one request, from rank 0's op log: per
    tenant, every committed operation's answer of every rank (rank 0
    first), the last of them being the one the reference's scan sees."""
    at = [0]

    def commits(app):
        log = app.registry.ops.log
        out = {}
        for rec in log[at[0]:]:
            if rec["ranks"][0].get("history") is not None:
                out.setdefault(rec["oid"], []).append(
                    [{"history": _history(r["history"]), "s": r["s"], "r": r["r"]}
                     for r in rec["ranks"]])
        at[0] = len(log)
        return out

    return commits


def _tier_events(app):
    return [(e["kind"], e.get("oid"), e.get("tier"), e.get("to"))
            for e in app.flight.events() if e["kind"] in TIER_EVENTS]


_RUNS = {}


def _ref_run(layout, n, tmp):
    on_mesh = LAYOUTS[layout][2]
    key = ("ref", layout, n if on_mesh else None)
    if key not in _RUNS:
        cfg = RefConfig(mesh_devices=n if on_mesh else 0,
                        storage_prefetch_interval_s=0, **LAYOUTS[layout][0])
        app = RefApp(cfg, **_budgets(tmp, "-".join(map(str, key))))
        try:
            answers, commits = _traffic(app, _ref_commits(), n == 2)
            _RUNS[key] = (answers, commits, _tier_events(app))
        finally:
            app.close(final_spill=False)
    return _RUNS[key]


def _port_run(layout, n, tmp):
    key = ("port", layout, n)
    if key not in _RUNS:
        cfg = ClassifierConfig(mesh_devices=n, storage_prefetch_interval_s=0,
                               **LAYOUTS[layout][0])
        app = ServeApp(cfg, device="cpu", mesh_timeout_s=TIMEOUT_S,
                       mesh_report="state", **_budgets(tmp, f"port-{layout}-{n}"))
        try:
            answers, commits = _traffic(app, _port_commits(), n == 2)
            events, log = _tier_events(app), list(app.registry.ops.log)
        finally:
            app.close(final_spill=False)
        _RUNS[key] = (answers, commits, events, log, app.mesh_ranks)
    return _RUNS[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    return lambda who, layout, n: (_ref_run if who == "ref" else _port_run)(
        layout, n, tmp)


@pytest.mark.parametrize("layout,n", CASES, ids=CASE_IDS)
def test_serve_mesh_answers_match_reference(runs, layout, n):
    """Every answer — write records, taxonomies, subsumers, snapshot
    reads, ``/healthz``'s counts — equals the reference's."""
    want = runs("ref", layout, n)[0]
    got = runs("port", layout, n)[0]
    assert len(got) == len(want) == (N_ALL if n == 2 else N_FIRST)
    for i, ((m, p, st, doc), (wm, wp, wst, wdoc)) in enumerate(zip(got, want)):
        assert (m, p, st) == (wm, wp, wst), i
        if p == "/healthz":
            mesh = doc.pop("mesh")
            assert mesh == {"size": n, "ops": mesh["ops"], "broken": None}
        assert doc == wdoc, (i, p)


@pytest.mark.parametrize("layout,n", CASES, ids=CASE_IDS)
def test_serve_mesh_every_rank_holds_the_reference_closure(runs, layout, n):
    """After every request, each tenant it committed: every rank's
    history record, S and R equal rank 0's for every committed
    operation, and the last one's equal the reference's."""
    want = runs("ref", layout, n)[1]
    got = runs("port", layout, n)[1]
    assert len(got) == len(want)
    checked = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for oid, ops in g.items():
            for ranks in ops:
                assert len(ranks) == n
                for r in ranks[1:]:
                    assert r["history"] == ranks[0]["history"], (i, oid)
                    assert np.array_equal(r["s"], ranks[0]["s"]), (i, oid)
                    assert np.array_equal(r["r"], ranks[0]["r"]), (i, oid)
            last, ref = ops[-1][0], w[oid][0]
            assert last["history"] == ref["history"], (i, oid)
            assert np.array_equal(last["s"], ref["s"]), (i, oid)
            assert np.array_equal(last["r"], ref["r"]), (i, oid)
            checked += 1
    assert checked == (11 if n == 2 else 5)


@pytest.mark.parametrize("layout,n", TIER_CASES,
                         ids=[f"{lay}-{n}" for lay, n in TIER_CASES])
def test_serve_mesh_tier_decisions_match_reference(runs, layout, n):
    """Rank 0's evictions, promotions, spills and restores are the
    reference's, and each reached every rank as an op of the stream
    (reads that restore a tenant included); every rank closed cleanly."""
    _answers, _commits, want = runs("ref", layout, n)
    _answers, _commits, got, log, ranks = runs("port", layout, n)
    assert got == want
    kinds = {e[0] for e in got}
    assert {"tier_demote", "tier_promote", "registry_spill",
            "registry_restore"} <= kinds
    ops = [(rec["op"], rec["oid"]) for rec in log]
    assert ("resident", "ont-0001") in ops and ("demote", "ont-0002") in ops
    assert ("spill", "ont-0001") in ops
    assert [rec["seq"] for rec in log] == list(range(1, len(log) + 1))
    for rec in log:
        assert [r["rank"] for r in rec["ranks"]] == list(range(n))
        assert all(r["ok"] for r in rec["ranks"]), rec["op"]
    assert [r["rank"] for r in ranks] == list(range(n))
    for r in ranks[1:]:
        assert r["exitcode"] == 0 and "error" not in r
        assert [w[:3] for w in r["walls"]] == [w[:3] for w in ranks[0]["walls"]]
        assert r["collectives"]["total"]["calls"] == \
            ranks[0]["collectives"]["total"]["calls"] > 0


# ------------------------------------------------------- threads and faults


def _mesh_app(tmp_path, n=2, **kw):
    kw.setdefault("mesh_timeout_s", TIMEOUT_S)
    return ServeApp(ClassifierConfig(mesh_devices=n, shape_buckets=False,
                                     storage_prefetch_interval_s=0),
                    device="cpu", fast_path_min_concepts=0,
                    spill_dir=str(tmp_path / "spill"), **kw)


TENANTS = {"a": OTHER,
           "b": _without_ranges(snomed_shaped_ontology(n_classes=250, seed=12))}
WRITES = {k: [f"SubClassOf(Conc{k}{i} Find{i + 2})" for i in range(3)]
          for k in TENANTS}


def test_two_tenants_from_two_threads_equal_serial(tmp_path):
    """Two tenants' writes and reads from two threads through two
    workers, on a 2-mesh, answer as the same requests one at a time;
    every rank ends on rank 0's closure of each tenant."""
    def serve(concurrent):
        app = _mesh_app(tmp_path / str(concurrent), workers=2, max_batch=1,
                        mesh_report="digest")
        try:
            ids = {k: _dispatch(app, "POST", "/v1/ontologies", t)[1]["id"]
                   for k, t in TENANTS.items()}
            errors = []

            def send(k):
                try:
                    for d in WRITES[k]:
                        _dispatch(app, "POST", f"/v1/ontologies/{ids[k]}/deltas", d)
                        _dispatch(app, "GET", f"/v1/ontologies/{ids[k]}/subsumers",
                                  **{"class": "Find2"})
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=send, args=(k,)) for k in TENANTS]
            for t in threads:
                t.start()
                if not concurrent:
                    t.join()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
            assert not errors
            taxes = {k: _dispatch(app, "GET", f"/v1/ontologies/{oid}/taxonomy")[1]
                     for k, oid in ids.items()}
            log = list(app.registry.ops.log)
        finally:
            app.close(final_spill=False)
        for rec in log:
            digests = {r.get("digest") for r in rec["ranks"]}
            assert len(digests) == 1, rec["op"]
        return taxes

    serial, concurrent = serve(False), serve(True)
    assert concurrent == serial


def test_prefetch_reaches_every_rank(tmp_path):
    """The registry's prefetch (the promoter thread's call) promotes a
    warm tenant through the op stream: rank 0 decides, every rank
    promotes, and the next write finds it resident on both."""
    from distel_tpu_torch.serve.registry import OntologyRegistry

    reg = OntologyRegistry(
        ClassifierConfig(mesh_devices=2, shape_buckets=False), device="cpu",
        memory_budget_bytes=1, warm_budget_bytes=1 << 30,
        spill_dir=str(tmp_path / "spill"), fast_path_min_concepts=0,
        mesh_timeout_s=TIMEOUT_S, mesh_report="digest")
    try:
        a, b = reg.new_id(), reg.new_id()
        reg.load(a, OTHER)
        reg.load(b, TENANTS["b"])                     # a -> warm
        assert reg.tier_stats()["warm_ontologies"] == 1
        reg.memory_budget_bytes = 1 << 40
        reg.note_read(a)
        assert reg.maybe_prefetch() == a
        reg.delta(a, [OTHER_DELTA])
        log = list(reg.ops.log)
    finally:
        ranks = reg.close()
    # (the idle-program drops between them depend on the programs other
    # tests left in the process)
    ops = [(rec["op"], rec["oid"]) for rec in log if rec["op"] != "drop_programs"]
    assert ops[ops.index(("demote", a)):] == [("demote", a), ("resident", a),
                                             ("delta", a)]
    for rec in log:
        assert all(r["ok"] for r in rec["ranks"])
        assert len({r.get("digest") for r in rec["ranks"]}) == 1, rec["op"]
    assert ranks[1]["exitcode"] == 0


def test_dead_follower_fails_writes_and_health(tmp_path):
    """A follower killed mid-traffic: the next write answers 503 naming
    the mesh within the collective timeout, ``/healthz`` answers 503,
    every later write 503; rank 0 committed nothing alone (the snapshot
    version stands, nothing is spilled at close), and reads of the
    committed snapshot still answer."""
    app = _mesh_app(tmp_path)
    try:
        oid = _dispatch(app, "POST", "/v1/ontologies", OTHER)[1]["id"]
        before = _dispatch(app, "GET", f"/v1/ontologies/{oid}/query/subsumers",
                           **{"class": "Find5"})
        app.registry.ops._procs[0].kill()
        t0 = time.monotonic()
        with pytest.raises(HTTPError) as e:
            _dispatch(app, "POST", f"/v1/ontologies/{oid}/deltas", OTHER_DELTA)
        assert time.monotonic() - t0 < TIMEOUT_S
        assert e.value.status == 503 and "mesh" in e.value.message
        status, health = _dispatch(app, "GET", "/healthz")
        assert status == 503 and health["status"] == "mesh-broken"
        assert "rank 1" in health["mesh"]["broken"]
        for path, text in ((f"/v1/ontologies/{oid}/deltas", LATE_DELTA),
                           (f"/v1/ontologies/{oid}/retract", OTHER_DELTA),
                           ("/v1/ontologies", OTHER)):
            with pytest.raises(HTTPError) as e:
                _dispatch(app, "POST", path, text)
            assert e.value.status == 503 and "mesh" in e.value.message
        after = _dispatch(app, "GET", f"/v1/ontologies/{oid}/query/subsumers",
                          **{"class": "Find5"})
        assert after == before and after[1]["version"] == 1
    finally:
        spilled = app.close(final_spill=True)
    assert spilled == []
    assert not list((tmp_path / "spill").glob("*.npz"))
    assert app.mesh_ranks[1]["error"]


def test_idle_mesh_outlives_its_collective_timeout(tmp_path):
    """A follower waits on the op stream with no deadline: after an idle
    spell longer than the group's collective timeout the next write is
    served by every rank."""
    app = _mesh_app(tmp_path, mesh_timeout_s=8.0, mesh_report="digest")
    try:
        oid = _dispatch(app, "POST", "/v1/ontologies", OTHER)[1]["id"]
        time.sleep(10.0)
        status, rec = _dispatch(app, "POST", f"/v1/ontologies/{oid}/deltas",
                                OTHER_DELTA)
        assert status == 200 and rec["version"] == 2
        assert _dispatch(app, "GET", "/healthz")[0] == 200
        last = app.registry.ops.log[-1]
        assert last["op"] == "delta"
        assert last["ranks"][0]["digest"] == last["ranks"][1]["digest"]
    finally:
        app.close(final_spill=False)
    assert app.mesh_ranks[1]["exitcode"] == 0


# ------------------------------------------------------------------ the CLI


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _serve(args, cwd=ROOT):
    return subprocess.Popen(
        [sys.executable, "-m", "distel_tpu_torch.cli", "serve", "--port", "0",
         "--device", "cpu", "--fast-path-min-concepts", "0", *args],
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})


def _serving_url(proc):
    ready, _, _ = select.select([proc.stdout], [], [], 180)
    assert ready, "cli serve printed nothing in 180 s"
    doc = json.loads(proc.stdout.readline())
    assert doc["serving"] is True
    return f"http://127.0.0.1:{doc['port']}", doc


def _cli_traffic(url):
    out = []
    oid = _post(url + "/v1/ontologies", {"text": OTHER})["id"]
    out.append(_get(url + f"/v1/ontologies/{oid}/taxonomy"))
    for kind, text in (("deltas", OTHER_DELTA), ("deltas", LATE_DELTA),
                       ("retract", OTHER_DELTA)):
        out.append(_post(url + f"/v1/ontologies/{oid}/{kind}", {"text": text}))
        out.append(_get(url + f"/v1/ontologies/{oid}/taxonomy"))
        out.append(_get(url + f"/v1/ontologies/{oid}/query/subsumers?class=Find5"))
    return oid, [_plain(d) for d in out]


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    tail, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err
    return json.loads(tail.strip().splitlines()[-1])


def _snapshot(path):
    return [np.asarray(x) for x in load_snapshot(str(path))[:2]]


def test_cli_serve_on_a_mesh_answers_as_solo(tmp_path):
    """``cli serve --config`` with ``mesh.devices = 2``: the serving
    line comes once both ranks joined, every answer over loopback HTTP
    equals solo ``cli serve``'s, and on SIGTERM both ranks exit 0 with
    the gathered snapshot in the spill dir (rank 0 writes it), equal to
    the solo spill."""
    runs = {}
    for name, keys in (("solo", ""), ("mesh", "mesh.devices = 2\n")):
        props = tmp_path / f"{name}.properties"
        props.write_text(keys + "shape.buckets = false\n")
        spill = tmp_path / name
        proc = _serve(["--spill-dir", str(spill), "--config", str(props)])
        try:
            url, line = _serving_url(proc)
            oid, answers = _cli_traffic(url)
            end = _stop(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        runs[name] = (line, answers, end, spill / f"{oid}.snapshot.npz")
    (sline, solo, send, spath), (mline, mesh, mend, mpath) = runs.values()
    assert mline["mesh"] == {"size": 2, "backend": "gloo"} and "mesh" not in sline
    assert mesh == solo
    assert [os.path.basename(p) for p in mend["spilled"]] == \
        [os.path.basename(p) for p in send["spilled"]] == [mpath.name]
    info = mend.pop("mesh")
    assert info["broken"] is None and info["size"] == 2
    assert [r["rank"] for r in info["ranks"]] == [0, 1]
    assert info["ranks"][1]["exitcode"] == 0
    assert info["log"][-1]["op"] == "spill"
    for got, want in zip(_snapshot(mpath), _snapshot(spath)):
        assert np.array_equal(got, want)
    assert (mpath.parent / (mpath.name + ".sha256")).exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_under_the_coordinator_keys(tmp_path):
    """Under the coordinator keys each rank is started by hand:
    ``process.id = 0`` serves HTTP, ``process.id = 1`` follows and, at
    rank 0's graceful close, prints its close record and exits 0."""
    port = _free_port()
    procs = []
    for rank in (1, 0):
        props = tmp_path / f"rank{rank}.properties"
        props.write_text(f"coordinator.address = 127.0.0.1:{port}\n"
                         f"num.processes = 2\nprocess.id = {rank}\n"
                         "shape.buckets = false\n")
        procs.append(_serve(["--spill-dir", str(tmp_path / "spill"),
                             "--config", str(props)]))
    follower, leader = procs
    try:
        url, line = _serving_url(leader)
        assert line["mesh"]["size"] == 2
        oid = _post(url + "/v1/ontologies", {"text": OTHER})["id"]
        rec = _post(url + f"/v1/ontologies/{oid}/deltas", {"text": OTHER_DELTA})
        assert rec["version"] == 2
        assert _get(url + "/healthz")["mesh"]["broken"] is None
        end = _stop(leader)
        out, err = follower.communicate(timeout=120)
        assert follower.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert end["mesh"]["ranks"][1]["rank"] == 1
    rank1 = json.loads(out.strip().splitlines()[-1])["mesh_rank"]
    assert rank1["rank"] == 1 and [w[1] for w in rank1["walls"]] == \
        ["load", "delta", "spill"]


MESH_KEYS = {"mesh.devices": "2", "coordinator.address": "127.0.0.1:1"}


@pytest.mark.parametrize("key", sorted(MESH_KEYS))
@pytest.mark.parametrize("entry", ["serve --replica-id", "fleet"])
def test_the_fleet_refuses_a_mesh_config(tmp_path, key, entry):
    """A fleet replica and the fleet's router refuse a mesh config by
    name, before anything joins or spawns."""
    props = tmp_path / "c.properties"
    props.write_text(f"{key} = {MESH_KEYS[key]}\n")
    argv = (["serve", "--device", "cpu", "--replica-id", "r0", "--spill-dir",
             str(tmp_path / "spill")] if entry != "fleet" else
            ["fleet", "--device", "cpu", "--spill-dir", str(tmp_path / "spill")])
    with pytest.raises(NotImplementedError,
                       match=f"the serve fleet does not run on a mesh.*{re.escape(key)}"):
        cli.main([*argv, "--config", str(props)])
