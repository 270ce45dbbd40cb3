"""The port's mesh plane against the reference's sharded engines.

The reference shards over the 8-device virtual CPU mesh that
``tests/conftest.py`` forces (``jax.sharding.Mesh`` of the first n
devices); the port's mesh of n is n gloo ranks on this host
(``distel_tpu_torch.testing.cpumesh.cpu_mesh_run``), each holding one
shard, and its mesh of one is the in-process mesh ``mesh.devices = 1``
gives.  All of a mesh size's port runs go through one launch
(``tests/torch_mesh_ranks.py`` is what the ranks run: the port only),
so a size costs one spawn.  Every rank's result is held to rank 0's,
and rank 0's, tolerance 0 (the data are bits), to the reference's run
on a mesh of the same size: the packed S and R (both gathered whole),
``derivations``, ``iterations``, the layout ``(nc, nl, unroll)`` and the
taxonomy — for the row-packed engine exact and bucketed, the packed and
the dense engine; the public step round by round; the observed dense
rounds, observer events included; gated chunks with their per-round
gate counts; the hybrid saturator (CR5, and CR1 with CR6, on the host)
against the reference's with a mesh.  Then the rest of the plane: each
rank holds its shard only, the config keys parse to the reference's
fields, ``build_mesh`` refuses what the reference refuses and runs on
the card unless given ``device="cpu"``, a failing rank fails the launch,
``cli classify --mesh 2`` equals ``cli classify``, ``cli partition``
ignores the mesh keys as the reference does, and two processes joined
by the coordinator keys over TCP loopback report one closure.  Serve
and the cohort refuse a mesh; the incremental plane and the hybrid run
on one.  The sharded sparse tier and fused window have their own files
(``tests/test_torch_sharded_adaptive.py``, ``tests/test_torch_fused.py``),
and so does the incremental plane on a mesh
(``tests/test_torch_incremental_mesh.py``).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.engine import SaturationEngine as RefDense
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.packed_engine import PackedSaturationEngine as RefPacked
from distel_tpu.runtime.classifier import make_engine as ref_make_engine
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu.owl import parser
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.parallel.mesh import RankFailed, build_mesh
from distel_tpu_torch.testing.cpumesh import cpu_mesh_run

import torch_mesh_ranks as ranks
from test_packed_engine import BOTTOM_ONTO
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
#: a hang in a collective fails the launch well inside the suite's clock
TIMEOUT_S = 120.0

CORPORA = {
    "snomed": snomed_shaped_ontology(n_classes=600),
    "bottom": BOTTOM_ONTO,
}
SIZES = (1, 2, 4)

#: (name, engine, corpus, port kwargs, reference factory)
SATURATE = {
    "rowpacked-exact": ("rowpacked", {}, lambda idx, m: RefEngine(
        idx, mesh=m, bucket=False, use_pallas=False)),
    "rowpacked-bucketed": ("rowpacked", {"bucket": True}, lambda idx, m: RefEngine(
        idx, mesh=m, bucket=True)),
    "rowpacked-gated": ("rowpacked", {"gate_chunks": True}, lambda idx, m: RefEngine(
        idx, mesh=m, bucket=False, use_pallas=False, gate_chunks=True)),
    "packed": ("packed", {}, lambda idx, m: RefPacked(idx, mesh=m, use_pallas=False)),
    "dense": ("dense", {}, lambda idx, m: RefDense(idx, mesh=m)),
}
STEP_ROUNDS = 3

#: the hybrid's cases: corpus -> the rules routed to the host
HYBRID = {"bottom": {"CR5": "host"}, "snomed": {"CR1": "host", "CR6": "host"}}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _ref_mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("c",))


def _jobs(n):
    jobs = []
    for mode, (engine, kw, _ref) in SATURATE.items():
        for corpus, text in CORPORA.items():
            if mode == "rowpacked-gated" and corpus != "snomed":
                continue
            jobs.append({"name": f"{mode}/{corpus}", "kind": "saturate",
                         "engine": engine, "kw": kw, "text": text})
    jobs.append({"name": "steps", "kind": "steps", "text": BOTTOM_ONTO,
                 "rounds": STEP_ROUNDS})
    jobs.append({"name": "observed", "kind": "observed",
                 "text": CORPORA["snomed"]})
    if n <= 2:
        jobs += [{"name": f"hybrid/{corpus}", "kind": "hybrid",
                  "text": CORPORA[corpus], "backends": backends}
                 for corpus, backends in HYBRID.items()]
    if n > 1:
        jobs += [{"name": f"refusal/{k}", "kind": "refusal", "n": k}
                 for k in (n - 1, n + 1)]
    return jobs


_PORT = {}
_REF = {}


def port_run(n):
    """Every rank's results of the mesh of ``n`` (one launch a size)."""
    if n not in _PORT:
        if n == 1:
            _PORT[n] = [ranks.run_jobs(torch.device("cpu"), _jobs(1))]
        elif n == 8:
            job = [j for j in _jobs(8) if j["name"] == "rowpacked-exact/snomed"]
            _PORT[n] = cpu_mesh_run(8, ranks.run_jobs, job, timeout_s=TIMEOUT_S)
        else:
            _PORT[n] = cpu_mesh_run(n, ranks.run_jobs, _jobs(n), timeout_s=TIMEOUT_S)
        for r, out in enumerate(_PORT[n]):
            assert out["_mesh"] == (n, r)
    return _PORT[n]


def ref_run(mode, corpus, n):
    key = (mode, corpus, n)
    if key not in _REF:
        idx = _index(CORPORA[corpus])
        eng = SATURATE[mode][2](idx, _ref_mesh(n))
        res = eng.saturate()
        _REF[key] = (eng, res)
    return _REF[key]


def _wire(res, x_major=False):
    if x_major:
        return np.asarray(res.s), np.asarray(res.r)
    return (np.asarray(res.packed_s).astype(np.uint32),
            np.asarray(res.packed_r).astype(np.uint32))


def _same_on_every_rank(outs, name, keys):
    for out in outs[1:]:
        for k in keys:
            a, b = outs[0][name][k], out[name][k]
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), (name, k)
            else:
                assert a == b, (name, k)


def _assert_closure(got, res, real_rows=False, x_major=False):
    """``real_rows``: bucketed layouts, whose pad segments differ by
    design (the reference ORs the dead concept row's bit into the dead
    link row, the port writes nothing there): the concepts' and links'
    rows only, as ``tests/test_torch_bucketing.py`` holds them.
    ``x_major``: the dense engine, compared unpacked (the reference packs
    it x-major, the port subsumer-major)."""
    s, r = _wire(res, x_major)
    if real_rows:
        idx = res.idx
        s, r = s[: idx.n_concepts], r[: idx.n_links]
        got = dict(got, s=got["s"][: idx.n_concepts], r=got["r"][: idx.n_links])
    assert np.array_equal(got["s"], s)
    assert np.array_equal(got["r"], r)
    assert got["derivations"] == res.derivations
    assert got["iterations"] == res.iterations
    assert got["converged"]


CASES = [(mode, corpus, n) for mode in SATURATE for corpus in CORPORA
         for n in SIZES if not (mode == "rowpacked-gated" and corpus != "snomed")]
CASES.append(("rowpacked-exact", "snomed", 8))


@pytest.mark.parametrize("mode,corpus,n", CASES,
                         ids=[f"{m}-{c}-{n}" for m, c, n in CASES])
def test_sharded_run_matches_reference(mode, corpus, n):
    """S, R, derivations, iterations, the layout and the taxonomy equal
    the reference's sharded run on a mesh of the same size; every rank
    gathers the same closure (and, gated, took the same gates)."""
    outs = port_run(n)
    name = f"{mode}/{corpus}"
    _same_on_every_rank(outs, name, ("s", "r", "derivations", "iterations",
                                     "gate_rounds", "tax"))
    got = outs[0][name]
    eng, res = ref_run(mode, corpus, n)
    _assert_closure(got, res, real_rows=mode == "rowpacked-bucketed",
                    x_major=mode == "dense")
    assert got["tax"] == ranks.tax_key(ref_taxonomy(res))
    if SATURATE[mode][0] == "rowpacked":
        assert got["layout"] == (eng.nc, eng.nl, eng.unroll)
    else:
        assert got["layout"][:2] == (eng.nc, eng.nl)
    if mode == "rowpacked-gated":
        # the gates are the solo engine's, round for round
        solo = port_run(1)[0][name]["gate_rounds"]
        assert got["gate_rounds"] == solo and len(solo) == res.iterations


@pytest.mark.parametrize("n", SIZES)
def test_public_step_round_by_round(n):
    """The public step on a mesh: each round's gathered state equals the
    reference's sharded step's, and every rank's."""
    outs = port_run(n)
    _same_on_every_rank(outs, "steps", ())
    for out in outs[1:]:
        for (a_s, a_r, a_c), (b_s, b_r, b_c) in zip(outs[0]["steps"]["rounds"],
                                                   out["steps"]["rounds"]):
            assert np.array_equal(a_s, b_s) and np.array_equal(a_r, b_r)
            assert a_c == b_c
    ref = RefEngine(_index(BOTTOM_ONTO), mesh=_ref_mesh(n), bucket=False,
                    use_pallas=False)
    sp, rp = ref.initial_state()
    for s, r, _changed in outs[0]["steps"]["rounds"]:
        sp, rp = ref.step(sp, rp)[:2]
        assert np.array_equal(s, np.asarray(sp).astype(np.uint32))
        assert np.array_equal(r, np.asarray(rp).astype(np.uint32))


@pytest.mark.parametrize("n", SIZES)
def test_observed_dense_rounds(n):
    """``saturate_observed`` on a mesh (dense rounds): the observer's
    events and the closure are the reference's sharded observed run's."""
    outs = port_run(n)
    _same_on_every_rank(outs, "observed", ("s", "r", "events", "derivations"))
    events = []
    res = RefEngine(_index(CORPORA["snomed"]), mesh=_ref_mesh(n)).saturate_observed(
        observer=lambda it, d, ch: events.append((it, d, bool(ch))))
    got = outs[0]["observed"]
    _assert_closure(got, res)
    assert got["events"] == events


@pytest.mark.parametrize("engine,n", [(e, n) for e in ("rowpacked", "packed", "dense")
                                      for n in (2, 4)])
def test_state_is_sharded(engine, n):
    """Each rank holds its shard only: ``[nc, wc/n]`` words of every row
    (row-packed), ``nc/n`` rows (packed), ``nc/n`` concept columns
    (dense)."""
    mode = {"rowpacked": "rowpacked-exact"}.get(engine, engine)
    got = port_run(n)[0][f"{mode}/bottom"]
    nc, nl = got["layout"][:2]
    want = {
        "rowpacked": [[nc, nc // 32 // n], [nl, nc // 32 // n]],
        "packed": [[nc // n, nc // 32], [nc // n, nl // 32]],
        "dense": [[nc, nc // n], [nl, nc // n]],
    }[engine]
    assert got["state_shapes"] == want


@pytest.mark.parametrize("n", (2, 4))
def test_build_mesh_refuses_partial_and_oversized(n):
    """Inside a group of n ranks a mesh of n - 1 is a partial mesh and
    one of n + 1 would need a rank to hold two shards: both refused, on
    every rank."""
    for out in port_run(n):
        assert "partial mesh" in out[f"refusal/{n - 1}"]["error"]
        assert "one rank is one shard" in out[f"refusal/{n + 1}"]["error"]


def test_build_mesh_outside_a_group():
    """A mesh of one is in-process; a larger one needs ranks and says
    how to get them."""
    m = build_mesh(1, device="cpu")
    assert (m.size, m.rank, m.group) == (1, 0, None)
    assert m.shape == {"c": 1}
    with pytest.raises(ValueError, match="launch_local"):
        build_mesh(2, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the host without a card")
def test_mesh_defaults_to_the_card():
    """``build_mesh`` and ``setup`` run on the card unless given
    ``device="cpu"``: with no card and no device they raise, as the
    engines do (a CPU mesh would also join gloo where NCCL was meant)."""
    from distel_tpu_torch.parallel.mesh import setup

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_mesh(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        setup(ClassifierConfig(mesh_devices=1))
    assert setup(ClassifierConfig(mesh_devices=1), device="cpu").device.type == "cpu"
    # a config that names no mesh builds nothing and reads no device
    assert setup(ClassifierConfig()) is None


@pytest.mark.parametrize(
    "lines,size",
    [("mesh.devices = 4", 4), ("NODES_LIST = node1,node2", 2),
     ("mesh.devices = 1", 1), ("NODES_LIST = node1", 1),
     ("mesh.devices = 0\nNODES_LIST = ", 0)],
)
def test_mesh_keys_parse_as_the_reference(tmp_path, lines, size):
    props = tmp_path / "c.properties"
    props.write_text(lines + "\n")
    got = ClassifierConfig.from_properties(str(props))
    want = RefConfig.from_properties(str(props))
    assert got.mesh_devices == want.mesh_devices == size


def test_coordinator_keys_parse_as_the_reference(tmp_path):
    props = tmp_path / "c.properties"
    props.write_text("coordinator.address = 127.0.0.1:1234\n"
                     "num.processes = 2\nprocess.id = 1\n")
    got = ClassifierConfig.from_properties(str(props))
    want = RefConfig.from_properties(str(props))
    for field in ("coordinator_address", "num_processes", "process_id"):
        assert getattr(got, field) == getattr(want, field)


def test_failing_rank_fails_the_launch():
    with pytest.raises(RankFailed, match="rank one fails on purpose"):
        cpu_mesh_run(2, ranks.fail_on_rank_one, timeout_s=TIMEOUT_S)


def _cli(*args, env=None, **kw):
    return subprocess.run(
        [sys.executable, "-m", "distel_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600,
        env=env, **kw,
    )


def test_cli_classify_mesh_matches_classify(tmp_path):
    """``cli classify --mesh 2`` (two gloo ranks, the default config:
    bucketed, native load plane) prints the solo classify's summary,
    writes its taxonomy, and each rank reports the same closure."""
    onto = tmp_path / "s.ofn"
    onto.write_text(CORPORA["snomed"])
    solo = _cli("classify", str(onto), "--device", "cpu", "-o", str(tmp_path / "a.txt"))
    mesh = _cli("classify", str(onto), "--device", "cpu", "--mesh", "2",
                "-o", str(tmp_path / "b.txt"))
    assert solo.returncode == 0, solo.stderr
    assert mesh.returncode == 0, mesh.stderr
    a = json.loads(solo.stdout[: solo.stdout.rindex("}") + 1])
    b = json.loads(mesh.stdout[: mesh.stdout.rindex("}") + 1])
    for key in ("concepts", "links", "iterations", "derivations", "unsatisfiable"):
        assert a[key] == b[key], key
    recs = b["mesh"]["ranks"]
    assert [r["rank"] for r in recs] == [0, 1]
    assert recs[0]["closure_sha256"] == recs[1]["closure_sha256"]
    assert recs[0]["collectives"]["total"]["calls"] > 0
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_coordinator_keys_join_two_processes(tmp_path):
    """Two ``cli classify`` processes configured by the coordinator keys
    (TCP loopback) are one mesh: both report the same closure digest,
    rank 0 the summary — the counterpart of ``tests/test_multihost.py``
    (which skips on this jax pin)."""
    onto = tmp_path / "s.ofn"
    onto.write_text(CORPORA["bottom"])
    port = _free_port()
    procs = []
    for rank in (0, 1):
        props = tmp_path / f"r{rank}.properties"
        props.write_text(f"coordinator.address = 127.0.0.1:{port}\n"
                         f"num.processes = 2\nprocess.id = {rank}\n")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "distel_tpu_torch.cli", "classify", str(onto),
             "--device", "cpu", "--config", str(props)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT)))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    summary = json.loads(outs[0][0])
    other = json.loads(outs[1][0])["mesh_rank"]
    assert summary["mesh"]["size"] == 2
    assert summary["mesh"]["ranks"][0]["closure_sha256"] == other["closure_sha256"]
    assert other["rank"] == 1
    solo = ranks.run_jobs(torch.device("cpu"), [
        {"name": "x", "kind": "saturate", "engine": "rowpacked",
         "kw": {"bucket": True}, "text": CORPORA["bottom"]}])["x"]
    assert summary["derivations"] == solo["derivations"]
    assert summary["iterations"] == solo["iterations"]


@pytest.mark.parametrize("plane", ["incremental", "serve", "hybrid", "cohort"])
def test_planes_without_a_sharded_mode_refuse_a_mesh(plane):
    """The cohort has no sharded mode: it refuses a mesh config by name
    rather than run each rank alone (the reference's cohort refuses a
    mesh engine too: ``cohort_ready``).  The incremental plane, serve
    and the hybrid run on a mesh (of one here) and equal their solo
    runs.  (The name is kept from when serve refused a mesh too.)"""
    cfg = ClassifierConfig(mesh_devices=1)
    if plane == "incremental":
        from distel_tpu_torch.core.incremental import IncrementalClassifier

        text = CORPORA["snomed"]
        runs = []
        for c in (cfg, ClassifierConfig()):
            inc = IncrementalClassifier(c, device="cpu")
            res = inc.add_text(text)
            runs.append((inc, res))
        (mesh_inc, mesh_res), (solo_inc, solo_res) = runs
        assert mesh_inc._mesh.size == 1 and solo_inc._mesh is None
        assert mesh_inc._base_engine.mesh is mesh_inc._mesh
        assert mesh_res.live_digest() == solo_res.live_digest()
        assert (mesh_res.iterations, mesh_res.derivations) == \
            (solo_res.iterations, solo_res.derivations)
    elif plane == "serve":
        # serve runs on a mesh since its op stream was ported
        # (tests/test_torch_serve_mesh.py); a mesh of one needs no stream
        from distel_tpu_torch.serve.registry import OntologyRegistry

        digests = []
        for c in (cfg, ClassifierConfig()):
            reg = OntologyRegistry(c, device="cpu")
            assert reg.ops is None and reg.close() is None
            oid = reg.new_id()
            reg.load(oid, CORPORA["snomed"])
            digests.append(reg.classifier(oid).last_result.live_digest())
        assert reg.classifier(oid)._mesh is None
        assert digests[0] == digests[1]
    elif plane == "hybrid":
        from distel_tpu_torch.runtime.classifier import make_engine

        cfg.rule_backends = {"CR5": "host"}
        idx = _index(BOTTOM_ONTO)
        hyb = make_engine(cfg, idx, "cpu", mesh=build_mesh(1, device="cpu"))
        assert hyb.engine.mesh is not None
        got = hyb.saturate()
        want = make_engine(cfg, idx, "cpu").saturate()
        assert got.live_digest() == want.live_digest()
        assert (got.iterations, got.derivations) == (want.iterations, want.derivations)
    else:
        from distel_tpu_torch.core.cohort import cohort_ready
        from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

        idx = _index(BOTTOM_ONTO)
        assert cohort_ready(RowPackedSaturationEngine(idx, device="cpu", bucket=True))
        assert not cohort_ready(RowPackedSaturationEngine(
            idx, device="cpu", bucket=True, mesh=build_mesh(1, device="cpu")))


def test_observed_mesh_refuses_the_sparse_tier():
    """On a mesh the live-tile CR6 is off, with the reference's reason;
    the sparse tier and the fused window run (they refused a mesh before
    they were sharded) and retire the solo run's rounds."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    idx = _index(BOTTOM_ONTO)
    eng = RowPackedSaturationEngine(idx, device="cpu", unroll=1,
                                    mesh=build_mesh(1, device="cpu"),
                                    cr6_tiles={"enable": True})
    # the live-tile CR6 stays off on a mesh, as the reference's
    assert eng.cr6_tiles_stats == {"active": False, "reason": "mesh"}
    solo = RowPackedSaturationEngine(idx, device="cpu", unroll=1)
    forced = {"density_threshold": 1.1, "hysteresis_rounds": 1}
    for kw in (dict(sparse_tail=forced), dict(sparse_tail=forced,
                                               fused_rounds={"rounds": 4})):
        got = eng.saturate_observed(**kw)
        tiers = [st.tier for st in eng.frontier_rounds]
        want = solo.saturate_observed(**kw)
        assert tiers == [st.tier for st in solo.frontier_rounds]
        assert "sparse" in tiers
        assert got.live_digest() == want.live_digest()
        assert (got.iterations, got.derivations) == (want.iterations, want.derivations)
    assert eng.fused_run_stats["windows"]


@pytest.mark.parametrize("corpus", list(HYBRID))
@pytest.mark.parametrize("n", (1, 2))
def test_hybrid_on_a_mesh_matches_reference(corpus, n):
    """The hybrid saturator on a mesh: the row-packed engine runs the
    device rules on each rank's window, the host pass runs on the
    gathered closure; S, R, iterations, derivations and the taxonomy
    equal the reference's ``HybridSaturator`` with a mesh, on every
    rank."""
    outs = port_run(n)
    name = f"hybrid/{corpus}"
    _same_on_every_rank(outs, name, ("s", "r", "derivations", "iterations", "tax"))
    ref = ref_make_engine(RefConfig(rule_backends=dict(HYBRID[corpus])),
                          _index(CORPORA[corpus]), mesh=_ref_mesh(n))
    res = ref.saturate()
    got = outs[0][name]
    _assert_closure(got, res)
    assert got["tax"] == ranks.tax_key(ref_taxonomy(res))
    if n > 1:
        assert got["shards"][0][1] == got["s"].shape[1] // n


def test_cli_partition_ignores_the_mesh_keys(tmp_path):
    """``cli partition`` does not thread the mesh keys, as the
    reference's (its batched group is one program): with ``mesh.devices
    = 2`` in its config it prints what it prints without them."""
    onto = tmp_path / "s.ofn"
    onto.write_text(CORPORA["snomed"])
    props = tmp_path / "m.properties"
    props.write_text("mesh.devices = 2\n")
    runs = [_cli("partition", str(onto), "--device", "cpu", *extra)
            for extra in ((), ("--config", str(props)))]
    docs = []
    for run in runs:
        assert run.returncode == 0, run.stderr
        doc = json.loads(run.stdout[run.stdout.index("{"):])
        doc.pop("wall_s", None)
        docs.append(doc)
    assert docs[0] == docs[1]
