"""The artifact farm of the port (``distel_tpu_torch/core/artifacts.py``)
on the CPU, against the reference's contract (``tests/test_artifacts.py``).

A farm is baked once per module on the CPU (the store as the
``PROGRAMS`` sink while a warmup and a classify of the reference's
``BASE`` / ``DELTA`` build the roster); consumers — a fresh subprocess,
and in-process installs over a cleared registry — load and apply the
delta with ``compile_s == 0.0``, counted exe hits, and the taxonomy the
reference computes for the same text.  Then the rejections (corrupt
spec, foreign backend or torch, tampered manifest, missing manifest),
the re-bake, the keys, and what is the port's own: the spec round trip,
the fused window at the ``"hlo-cache"`` tier, the kernel-library tier
with stand-in bytes (no ``nvcc`` here), the config keys, the fleet
supervisor's wire and ``/metrics``.  Every assertion rides the counted
``ARTIFACT_EVENTS`` aggregate, never a wall clock.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import artifacts, bucketing
from distel_tpu_torch.core.artifacts import (
    ARTIFACT_EVENTS,
    ArtifactError,
    ArtifactStore,
)
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.core.program_cache import PROGRAMS
from distel_tpu_torch.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu_torch.ops import build
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from distel_tpu_torch.runtime.warmup import warmup_texts
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

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

#: the fast path on the toy corpus, as the reference's tests force it
CFG = dict(fast_path_min_concepts=0)


def _digest(result) -> str:
    tax = extract_taxonomy(result)
    return json.dumps({c: sorted(s) for c, s in tax.subsumers.items()},
                      sort_keys=True)


def _classify():
    inc = IncrementalClassifier(ClassifierConfig(**CFG), device="cpu")
    inc.add_text(BASE)
    inc.add_text(DELTA)
    return inc


@pytest.fixture(scope="module")
def reference_digest():
    """The reference's taxonomy of BASE + DELTA, the oracle of every
    consumer here."""
    from distel_tpu.core.incremental import IncrementalClassifier as RefInc
    from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_tax

    inc = RefInc()
    inc._FAST_PATH_MIN_CONCEPTS = 0
    inc.add_text(BASE)
    inc.add_text(DELTA)
    tax = ref_tax(inc.last_result)
    return json.dumps({c: sorted(s) for c, s in tax.subsumers.items()},
                      sort_keys=True)


@pytest.fixture(scope="module")
def farm(tmp_path_factory):
    """Bake the BASE/DELTA roster on the CPU: ``(root, digest)``, the
    digest of the baseline classify (no farm installed)."""
    root = str(tmp_path_factory.mktemp("farm"))
    store = ArtifactStore(root, writable=True, device="cpu")
    PROGRAMS.clear()
    PROGRAMS.artifact_sink = store
    try:
        warmup_texts([BASE], ClassifierConfig(**CFG), parallel=False,
                     device="cpu")
        baseline = _digest(_classify().last_result)
    finally:
        PROGRAMS.artifact_sink = None
    assert store.written > 0
    store.flush()
    return root, baseline


@pytest.fixture(autouse=True)
def _detached():
    """Every test starts and ends with no farm attached and a clean
    event aggregate: these are process globals."""
    artifacts.uninstall()
    ARTIFACT_EVENTS.reset()
    yield
    artifacts.uninstall()
    ARTIFACT_EVENTS.reset()
    PROGRAMS.artifact_sink = None


# ------------------------------------------------------- cross-process

_CONSUMER = r"""
import json, sys
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import artifacts
from distel_tpu_torch.core.artifacts import ARTIFACT_EVENTS
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

rec = artifacts.install(sys.argv[1], require=True, device="cpu")
inc = IncrementalClassifier(ClassifierConfig(fast_path_min_concepts=0),
                            device="cpu")
inc.add_text(%r)
load = dict(inc.history[-1])
inc.add_text(%r)
delta = dict(inc.history[-1])
tax = extract_taxonomy(inc.last_result)
print(json.dumps({
    "install": rec,
    "load_compile_s": load["compile_s"],
    "delta_compile_s": delta["compile_s"],
    "delta_path": delta["path"],
    "events": ARTIFACT_EVENTS.snapshot(),
    "digest": json.dumps(
        {c: sorted(s) for c, s in tax.subsumers.items()}, sort_keys=True),
}))
""" % (BASE, DELTA)


def test_cross_process_reuse_compiles_nothing(farm, reference_digest):
    """A fresh process installing the farm serves the load and the
    first delta with ``compile_s == 0.0``, counted exe hits, no miss and
    no rejection, and the reference's taxonomy."""
    root, baseline = farm
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _CONSUMER, root],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.splitlines()[-1])
    assert doc["install"]["installed"] is True
    assert doc["install"]["programs_built"] == doc["install"]["exe"] > 0
    assert doc["install"]["nvcc_runs"] == 0
    assert doc["load_compile_s"] == 0.0
    assert doc["delta_compile_s"] == 0.0
    assert doc["delta_path"] == "fast"
    ev = doc["events"]
    assert ev["exe_hits"] > 0, ev
    assert ev["rejected"] == 0 and ev["misses"] == 0, ev
    assert doc["digest"] == baseline == reference_digest


# -------------------------------------------------- in-process install

def test_installed_farm_serves_cleared_registry(farm):
    root, baseline = farm
    PROGRAMS.clear()
    rec = artifacts.install(root, require=True, device="cpu")
    assert rec["installed"] is True
    inc = _classify()
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["exe_hits"] > 0 and ev["rejected"] == 0
    assert inc.history[0]["compile_s"] == 0.0
    assert inc.history[-1]["compile_s"] == 0.0
    assert inc.history[0]["program_cache_hit"] is True
    assert _digest(inc.last_result) == baseline


def test_handed_over_program_then_evicted_is_a_miss(farm):
    """The store hands a program over once and drops it: once the
    registry has evicted it, the key is a miss and builds from the
    engine's tables (a build ``load`` never does)."""
    root, baseline = farm
    PROGRAMS.clear()
    artifacts.install(root, require=True, device="cpu")
    _classify()
    hits = ARTIFACT_EVENTS.snapshot()["exe_hits"]
    PROGRAMS.clear()
    inc = _classify()
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["exe_hits"] == hits and ev["misses"] > 0
    assert inc.history[0]["program_cache_hit"] is False
    assert _digest(inc.last_result) == baseline


def test_held_programs_are_counted_and_dropped(farm):
    """Programs a farm holds are device memory: ``program_bytes``
    counts them and ``drop_idle_programs`` drops them."""
    root, _ = farm
    PROGRAMS.clear()
    assert bucketing.program_bytes("cpu") == 0
    rec = artifacts.install(root, require=True, device="cpu")
    held = bucketing.program_bytes("cpu")
    assert held > 0 and held >= sum(p["bytes"] for p in rec["programs"])
    assert bucketing.drop_idle_programs("cpu") == rec["programs_built"]
    assert bucketing.program_bytes("cpu") == 0
    _classify()
    assert ARTIFACT_EVENTS.snapshot()["exe_hits"] == 0


# --------------------------------------------------------- rejections

def _flip_a_byte(path: str) -> None:
    with open(path, "r+b") as f:
        blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        f.seek(0)
        f.write(blob)


def test_corrupt_artifact_falls_back_to_loud_compile(farm, tmp_path):
    """Flipped bytes in every spec: install rejects each on its sha256
    (a warning and a counted rejection), the classify builds from the
    engine's tables to the same closure; under ``require`` the install
    raises naming the checksum."""
    root, baseline = farm
    bad = str(tmp_path / "bad-farm")
    shutil.copytree(root, bad)
    exe_dir = os.path.join(bad, "exe")
    for name in os.listdir(exe_dir):
        _flip_a_byte(os.path.join(exe_dir, name))
    with pytest.raises(ArtifactError, match="sha256"):
        artifacts.install(bad, require=True, device="cpu")
    ARTIFACT_EVENTS.reset()
    PROGRAMS.clear()
    with pytest.warns(RuntimeWarning, match="rejecting artifact"):
        rec = artifacts.install(bad, device="cpu")
    assert rec["installed"] is True and rec["programs_built"] == 0
    inc = _classify()
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["rejected"] == rec["exe"] > 0 and ev["exe_hits"] == 0
    assert inc.history[0]["program_cache_hit"] is False
    assert _digest(inc.last_result) == baseline


def _rewrite_manifest(root: str, dest: str, **overrides) -> None:
    shutil.copytree(root, dest)
    mpath = os.path.join(dest, artifacts.MANIFEST_NAME)
    with open(mpath, "r", encoding="utf-8") as f:
        doc = json.load(f)
    doc.update(overrides)
    doc["checksum"] = artifacts._manifest_digest(doc)
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(doc, f)


def test_wrong_backend_manifest_refused(farm, tmp_path):
    root, _ = farm
    bad = str(tmp_path / "cuda-farm")
    _rewrite_manifest(root, bad, backend="cuda")
    with pytest.warns(RuntimeWarning, match="backend"):
        rec = artifacts.install(bad, device="cpu")
    assert rec["installed"] is False and "backend" in rec["reason"]
    assert ARTIFACT_EVENTS.snapshot()["rejected"] == 1
    # the process keeps building as if no farm existed
    assert PROGRAMS.artifact_source is None
    with pytest.raises(ArtifactError):
        artifacts.install(bad, require=True, device="cpu")


def test_wrong_torch_version_manifest_refused(farm, tmp_path):
    root, _ = farm
    bad = str(tmp_path / "pin-farm")
    _rewrite_manifest(root, bad, torch_version="0.0.1")
    with pytest.warns(RuntimeWarning, match="torch_version"):
        rec = artifacts.install(bad, device="cpu")
    assert rec["installed"] is False and "torch_version" in rec["reason"]
    assert PROGRAMS.artifact_source is None


def test_tampered_manifest_checksum_refused(farm, tmp_path):
    """A manifest whose body no longer matches its whole-file digest is
    untrusted wholesale: nothing in it installs."""
    root, _ = farm
    bad = str(tmp_path / "tampered-farm")
    shutil.copytree(root, bad)
    mpath = os.path.join(bad, artifacts.MANIFEST_NAME)
    with open(mpath, "r", encoding="utf-8") as f:
        doc = json.load(f)
    doc["n_devices"] = 999  # checksum left stale
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    with pytest.raises(ArtifactError, match="checksum"):
        ArtifactStore(bad)
    with pytest.warns(RuntimeWarning, match="NOT installed"):
        rec = artifacts.install(bad, device="cpu")
    assert rec["installed"] is False
    assert ARTIFACT_EVENTS.snapshot()["rejected"] == 1


def test_missing_manifest_refused(tmp_path):
    with pytest.raises(ArtifactError, match="farm-build"):
        ArtifactStore(str(tmp_path / "nowhere"))
    with pytest.raises(ArtifactError, match="farm-build"):
        artifacts.install(str(tmp_path / "nowhere"), require=True,
                          device="cpu")


def test_spec_whose_signature_does_not_recompute_is_rejected(farm, tmp_path):
    """A spec edited (and re-checksummed) so that its structure no
    longer recomputes the key it was filed under is rejected."""
    root, _ = farm
    bad = str(tmp_path / "edited-farm")
    shutil.copytree(root, bad)
    mpath = os.path.join(bad, artifacts.MANIFEST_NAME)
    with open(mpath, encoding="utf-8") as f:
        doc = json.load(f)
    aid, ent = next((a, e) for a, e in sorted(doc["artifacts"].items())
                    if e["tier"] == "exe")
    spath = os.path.join(bad, ent["file"])
    with open(spath, encoding="utf-8") as f:
        spec = json.load(f)
    spec["struct"]["unroll"] += 1
    blob = json.dumps(spec, sort_keys=True).encode()
    with open(spath, "wb") as f:
        f.write(blob)
    ent["sha256"] = artifacts._sha256_bytes(blob)
    doc["checksum"] = artifacts._manifest_digest(doc)
    with open(mpath, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    with pytest.raises(ArtifactError, match="does not recompute"):
        artifacts.install(bad, require=True, device="cpu")
    ARTIFACT_EVENTS.reset()
    with pytest.warns(RuntimeWarning, match="does not recompute"):
        rec = artifacts.install(bad, device="cpu")
    assert rec["programs_built"] == rec["exe"] - 1
    assert ARTIFACT_EVENTS.snapshot()["rejected"] == 1


# -------------------------------------------------------- idempotence

def test_rebake_writes_nothing(farm):
    """A second bake over the same roster: the farm's programs are
    built from their specs and handed over, the sink records nothing,
    the manifest bytes do not change."""
    root, _ = farm
    mpath = os.path.join(root, artifacts.MANIFEST_NAME)
    with open(mpath, "rb") as f:
        before = f.read()
    store = ArtifactStore(root, writable=True)
    PROGRAMS.clear()
    store.build_programs("cpu")
    PROGRAMS.artifact_source = store
    PROGRAMS.artifact_sink = store
    try:
        warmup_texts([BASE], ClassifierConfig(**CFG), parallel=False,
                     device="cpu")
        _classify()
    finally:
        PROGRAMS.artifact_sink = None
        PROGRAMS.artifact_source = None
    assert store.written == 0
    assert store.flush() is False
    with open(mpath, "rb") as f:
        assert f.read() == before
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["serialized"] == 0 and ev["exe_hits"] > 0


def test_cli_farm_build_is_idempotent(tmp_path, capsys):
    base, delta = tmp_path / "base.ofn", tmp_path / "delta.ofn"
    base.write_text(BASE)
    delta.write_text(DELTA)
    out = str(tmp_path / "farm")
    argv = ["farm-build", str(base), "--out", out, "--delta", str(delta),
            "--device", "cpu", "--serial"]
    PROGRAMS.clear()
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert first["manifest_written"] is True and first["written"] > 0
    assert first["kernels"] == 0 and first["nvcc"] is None  # a CPU bake
    replay = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert not replay
    PROGRAMS.clear()
    assert cli.main(argv) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    second = lines[-1]
    assert second["manifest_written"] is False and second["written"] == 0
    assert second["exe"] == first["exe"]
    assert [r["path"] for r in lines if r.get("profile") == "delta-replay"] \
        == ["fast"]
    # a farm of another environment is refused, not extended
    _rewrite_manifest(out, str(tmp_path / "other"), torch_version="0.0.1")
    assert cli.main(["farm-build", str(base), "--out",
                     str(tmp_path / "other"), "--device", "cpu"]) == 3


# -------------------------------------------------------------- units

def test_artifact_id_is_stable_and_keyed_on_the_whole_key():
    k1 = ("b4096x2240-abc", "run", 10000)
    assert artifacts.artifact_id(k1) == artifacts.artifact_id(k1)
    assert artifacts.artifact_id(k1) != artifacts.artifact_id(
        ("b4096x2240-abc", "run", 20000)
    )


def test_describe_key_extracts_reporting_fields():
    d = artifacts.describe_key(("b1-x", "fused", (4, 128, 0, 0)))
    assert d["bucket_signature"] == "b1-x"
    assert d["kind"] == "fused" and d["fused_k"] == 4
    d = artifacts.describe_key(("b1-x", "sparse", (256, 0, 0)))
    assert d["rung"] == [256, 0, 0]
    # the port's fused key: (signature, "fused", K, capacities, digest)
    d = artifacts.describe_key(("b1-x", "fused", 8, (64, 128), "abc"))
    assert d["kind"] == "fused" and d["fused_k"] == 8


# ------------------------------------------------------ the spec tier

CORPORA = {"toy": BASE, "snomed-300": snomed_shaped_ontology(n_classes=300),
           "chain-200": chain_tailed_ontology(200, 8)}


def _bucketed(text, **kw):
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    idx = ELClassifier(device="cpu").classify_text(text).idx
    return RowPackedSaturationEngine(idx, device="cpu", bucket=True, **kw)


def _run(prog, engine) -> tuple:
    """``prog`` over ``engine``'s tables from the fresh initial state:
    every group's flags, then S and R."""
    pair = prog.pair
    with pair.lock:
        prog.load(engine._btables)
        engine._fill_initial(pair.sp, pair.rp)
        prog.ms.fill_(True)
        prog.dl.copy_(prog.T["dl_valid"])
        flags = []
        while True:
            f = prog.run()
            flags.append(f.tolist())
            if not f[0]:
                break
        return flags, pair.sp.clone(), pair.rp.clone()


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_spec_round_trip_recomputes_the_key_and_runs_the_same(corpus):
    """``program_spec`` → JSON → ``from_spec`` gives the signature the
    program was filed under, and its run equals the engine-built
    program's, group for group, in S and R."""
    PROGRAMS.clear()
    engine = _bucketed(CORPORA[corpus])
    prog = engine._bucket_program()
    spec = json.loads(json.dumps(bucketing.program_spec(prog)))
    back = bucketing.BucketProgram.from_spec(spec, "cpu")
    assert back.struct == prog.struct
    assert bucketing.shape_signature(back.struct, back.shapes) == \
        engine.bucket_signature
    assert back.nbytes == prog.nbytes
    want, got = _run(prog, engine), _run(back, engine)
    assert got[0] == want[0] and len(want[0]) > 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


#: the sparse tier on every round (the reference test's strictest
#: selection), under which the fused windows run
FORCED = {"density_threshold": 1.1, "hysteresis_rounds": 1,
          "capacity_buckets": 12}


def test_fused_window_is_recorded_at_the_hlo_cache_tier(tmp_path):
    """A bucketed engine's fused window is keyed by content: the bake
    records its key with no file, and a consumer's lookup counts an
    ``hlo_hit`` and builds the window from the engine's tables — round
    for round the closure of the baked run."""
    text = chain_tailed_ontology(200, 8)
    store = ArtifactStore(str(tmp_path / "farm"), writable=True, device="cpu")
    PROGRAMS.clear()
    PROGRAMS.artifact_sink = store
    try:
        eng = _bucketed(text, unroll=1)
        want = eng.saturate_observed(fused_rounds={"rounds": 4},
                                     sparse_tail=FORCED)
    finally:
        PROGRAMS.artifact_sink = None
    store.flush()
    fused = [e for e in store._doc["artifacts"].values()
             if e.get("kind") == "fused"]
    assert fused and all(e["tier"] == "hlo-cache" and e["file"] is None
                         and "content" in e["reason"] for e in fused)
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["unserializable"] == len(fused) and ev["serialized"] >= 1
    PROGRAMS.clear()
    ARTIFACT_EVENTS.reset()
    artifacts.install(str(tmp_path / "farm"), require=True, device="cpu")
    eng = _bucketed(text, unroll=1)
    got = eng.saturate_observed(fused_rounds={"rounds": 4},
                                sparse_tail=FORCED)
    ev = ARTIFACT_EVENTS.snapshot()
    assert ev["hlo_hits"] == len(fused) and ev["rejected"] == 0
    assert got.derivations == want.derivations
    assert torch.equal(got.packed_s, want.packed_s)
    assert torch.equal(got.packed_r, want.packed_r)


# --------------------------------------------------- the library tier

@pytest.fixture
def stand_in_libraries(tmp_path, monkeypatch):
    """A bake's build directory holding a stand-in library of every
    kernel source (no ``nvcc`` here), and a farm that adopted them."""
    bake_dir = tmp_path / "bake-build"
    monkeypatch.setenv("DISTEL_TORCH_BUILD_DIR", str(bake_dir))
    monkeypatch.setattr(build, "nvcc_release",
                        lambda: "Cuda compilation tools, release 0.0 (stand-in)")
    for i, name in enumerate(build.sources()):
        path = Path(build.lib_path(name))
        path.write_bytes(bytes([i]) * 4096)
        Path(str(path) + ".ptxas.txt").write_text(f"ptxas info {name}\n")
    store = ArtifactStore(str(tmp_path / "farm"), writable=True, device="cpu")
    ARTIFACT_EVENTS.reset()
    assert store.adopt_libraries() == len(build.sources())
    assert store.adopt_libraries() == 0  # already recorded
    assert store.flush()
    consumer = tmp_path / "consumer-build"
    monkeypatch.setenv("DISTEL_TORCH_BUILD_DIR", str(consumer))
    return tmp_path / "farm", consumer


@pytest.mark.parametrize("fault", ["none", "bytes", "name", "missing"])
def test_library_tier_with_stand_in_bytes(stand_in_libraries, fault):
    """Adopted libraries are copied and checksummed; a consumer copies
    each verified one into its build directory under this checkout's
    name, where ``ops/build`` finds it without ``nvcc`` (a counted
    persistent-cache hit).  Tampered bytes, a library built from
    another source, or a missing file are rejected (counted; raised
    under ``require``), and the kernel would build with ``nvcc``."""
    farm, consumer = stand_in_libraries
    store = ArtifactStore(str(farm))
    assert store.stats()["kernels"] == len(build.sources())
    assert "stand-in" in store.stats()["nvcc"]
    ARTIFACT_EVENTS.reset()
    name = build.sources()[0]
    ent = store._doc["kernels"][name]
    if fault == "bytes":
        _flip_a_byte(str(farm / ent["file"]))
    elif fault == "name":
        ent["file"] = ent["file"].replace(name, name + "x")
    elif fault == "missing":
        os.remove(farm / ent["file"])
    if fault == "none":
        assert store.install_libraries(require=True) == build.sources()
        before = build.CACHE_EVENTS.snapshot()
        for n in build.sources():
            assert build._compile(n) == 0.0  # found: nvcc never runs
        after = build.CACHE_EVENTS.snapshot()
        assert after["hits"] - before["hits"] == len(build.sources())
        assert after["misses"] == before["misses"]
        for n in build.sources():
            src = farm / store._doc["kernels"][n]["file"]
            assert Path(build.lib_path(n)).read_bytes() == src.read_bytes()
        assert ARTIFACT_EVENTS.snapshot()["rejected"] == 0
        return
    with pytest.raises(ArtifactError, match="rejecting kernel library"):
        store.install_libraries(require=True)
    with pytest.warns(RuntimeWarning, match="nvcc at first use"):
        got = store.install_libraries()
    assert got == [n for n in build.sources() if n != name]
    assert not os.path.exists(build.lib_path(name))
    assert ARTIFACT_EVENTS.snapshot()["rejected"] == 2


def test_a_cpu_bake_ships_no_library(farm):
    store = ArtifactStore(farm[0])
    assert store.stats()["kernels"] == 0 and store._doc["nvcc"] is None


# ----------------------------------------------------- config and cli

def test_config_parses_the_farm_keys(tmp_path):
    from distel_tpu.config import ClassifierConfig as RefConfig

    p = tmp_path / "c.properties"
    p.write_text("artifacts.dir = /srv/farm\nartifacts.require = true\n"
                 "compile.cache.dir = /srv/kernels\n")
    got = ClassifierConfig.from_properties(str(p))
    want = RefConfig.from_properties(str(p))
    for field in ("artifacts_dir", "artifacts_require", "compile_cache_dir"):
        assert getattr(got, field) == getattr(want, field), field
    defaults, ref_defaults = ClassifierConfig(), RefConfig()
    for field in ("artifacts_dir", "artifacts_require", "compile_cache_dir"):
        assert getattr(defaults, field) == getattr(ref_defaults, field), field


def test_compile_cache_dir_is_the_build_dir(tmp_path, monkeypatch):
    """``compile.cache.dir`` points the kernel build directory (before
    any install copies libraries there); ``DISTEL_TORCH_BUILD_DIR``
    still wins."""
    monkeypatch.delenv("DISTEL_TORCH_BUILD_DIR", raising=False)
    default = build.build_dir()
    try:
        assert artifacts.install_from_config(
            ClassifierConfig(compile_cache_dir=str(tmp_path / "k"))) is None
        assert build.build_dir() == str(tmp_path / "k")
        monkeypatch.setenv("DISTEL_TORCH_BUILD_DIR", str(tmp_path / "env"))
        assert build.build_dir() == str(tmp_path / "env")
    finally:
        build.set_cache_dir(None)
    monkeypatch.delenv("DISTEL_TORCH_BUILD_DIR")
    assert build.build_dir() == default


def test_cli_classify_installs_the_farm(farm, tmp_path, capsys):
    root, _ = farm
    onto = tmp_path / "base.ofn"
    onto.write_text(BASE)
    PROGRAMS.clear()
    assert cli.main(["classify", str(onto), "--device", "cpu",
                     "--artifacts-dir", root]) == 0
    out = capsys.readouterr().out
    rec = json.loads(out.splitlines()[0])["artifacts"]
    assert rec["installed"] is True and rec["programs_built"] > 0


@pytest.mark.parametrize("where", ["spill", "explicit", "none"])
def test_supervisor_hands_the_farm_on(tmp_path, where):
    """``_farm_args``: a manifest at ``<spill_dir>/artifacts`` reaches
    every spawned and respawned replica; an explicit ``--artifacts-dir``
    wins; no manifest, no flag."""
    from distel_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

    spill = tmp_path / "spill"
    if where != "none":
        (spill / "artifacts").mkdir(parents=True)
        (spill / "artifacts" / "manifest.json").write_text("{}")
    extra = ["--artifacts-dir", "mine"] if where == "explicit" else []
    sup = ReplicaSupervisor(1, spill_dir=str(spill), extra_args=extra)
    want = {"spill": ["--artifacts-dir", str(spill / "artifacts")],
            "explicit": [], "none": []}[where]
    assert sup._farm_args() == want


# -------------------------------------------------------------- serve

SERIES = ("distel_artifact_exe_hits_total", "distel_artifact_hlo_hits_total",
          "distel_artifact_misses_total", "distel_artifact_rejected_total",
          "distel_persistent_cache_hits_total")


def _metric(page: str, name: str) -> float:
    return float(re.search(rf"^{name} (\S+)$", page, re.M).group(1))


def test_serve_app_installs_and_stamps_artifact_hits(farm):
    """``ServeApp`` installs the config's farm before its registry: the
    load and the first delta build nothing (exe hits stamped on the
    records), and ``/metrics`` shows the five series."""
    from distel_tpu_torch.serve import server as serve_server
    from distel_tpu_torch.serve.server import ServeApp

    root, baseline = farm
    PROGRAMS.clear()
    app = ServeApp(ClassifierConfig(artifacts_dir=root, artifacts_require=True,
                                    **CFG), device="cpu")
    try:
        assert app.artifacts_install["installed"] is True
        status, _, body = app.dispatch(
            "POST", "/v1/ontologies", {}, json.dumps({"text": BASE}).encode(),
            None)
        load = json.loads(body)
        assert status == 201, load
        status, _, body = app.dispatch(
            "POST", f"/v1/ontologies/{load['id']}/deltas", {},
            json.dumps({"text": DELTA}).encode(), None)
        delta = json.loads(body)
        for rec in (load, delta):
            assert rec["compile_s"] == 0.0, rec
            assert rec["artifact_hits"]["exe_hits"] > 0, rec
        assert delta["path"] == "fast"
        assert _digest(app.registry.classifier(load["id"]).last_result) \
            == baseline
        _, _, page = app.dispatch("GET", "/metrics", {}, b"", None)
        page = page.decode()
        for name in SERIES:
            assert re.search(rf"^# HELP {name} ", page, re.M), name
        assert _metric(page, "distel_artifact_exe_hits_total") > 0
        assert _metric(page, "distel_artifact_rejected_total") == 0
        assert not set(SERIES) & set(serve_server.NOT_YET_PORTED)
    finally:
        app.close(final_spill=False)


def test_serve_refuses_a_corrupt_farm_under_require(farm, tmp_path):
    """``--artifacts-require`` on a farm with a flipped spec byte raises
    before anything binds, naming the checksum; without it the app
    serves, the rejection counted and the program built."""
    from distel_tpu_torch.serve.server import ServeApp

    root, baseline = farm
    bad = tmp_path / "bad"
    shutil.copytree(root, bad)
    _flip_a_byte(str(next((bad / "exe").iterdir())))
    with pytest.raises(ArtifactError, match="sha256"):
        cli.main(["serve", "--device", "cpu", "--port", "0",
                  "--artifacts-dir", str(bad), "--artifacts-require"])
    ARTIFACT_EVENTS.reset()
    PROGRAMS.clear()
    with pytest.warns(RuntimeWarning, match="rejecting artifact"):
        app = ServeApp(ClassifierConfig(artifacts_dir=str(bad), **CFG),
                       device="cpu")
    try:
        status, _, body = app.dispatch(
            "POST", "/v1/ontologies", {}, json.dumps({"text": BASE}).encode(),
            None)
        assert status == 201
        app.dispatch("POST", f"/v1/ontologies/{json.loads(body)['id']}/deltas",
                     {}, json.dumps({"text": DELTA}).encode(), None)
        assert ARTIFACT_EVENTS.snapshot()["rejected"] == 1
        inc = app.registry.classifier(json.loads(body)["id"])
        assert _digest(inc.last_result) == baseline
    finally:
        app.close(final_spill=False)


def test_persistent_cache_counters_read_the_library_aggregate(tmp_path,
                                                              monkeypatch):
    """``CompileStats``' persistent-cache counters are the kernel
    libraries a build loaded, read from ``ops/build.CACHE_EVENTS``."""
    from distel_tpu_torch.runtime.instrumentation import (
        CompileStats,
        library_loads,
    )

    monkeypatch.setenv("DISTEL_TORCH_BUILD_DIR", str(tmp_path))
    name = build.sources()[0]
    Path(build.lib_path(name)).write_bytes(b"\0" * 16)
    stats = CompileStats()
    with library_loads(stats):
        assert build._compile(name) == 0.0
    assert (stats.persistent_cache_hits, stats.persistent_cache_misses) == (1, 0)
    assert np.all(np.array(list(build.CACHE_EVENTS.snapshot().values())) >= 0)


def test_farm_records_and_installs_cohort_programs(tmp_path):
    """A bake under ``cohort.warm.sizes`` records each cohort program at
    the ``"exe"`` tier as the solo program's spec plus its rung (and the
    budget its key holds); a consumer builds it at install, and the
    first cohort of two tenants is handed the programs: ``compile_s``
    0.0, exe hits, each member's closure the one the bake's process
    computes."""
    from distel_tpu_torch.core import cohort
    from distel_tpu_torch.owl import loader

    cfg = ClassifierConfig(cohort_warm_sizes="2", **CFG)
    root = str(tmp_path / "farm")
    store = ArtifactStore(root, writable=True, device="cpu")
    PROGRAMS.clear()
    PROGRAMS.artifact_sink = store
    try:
        warmup_texts([BASE], cfg, parallel=False, device="cpu")
    finally:
        PROGRAMS.artifact_sink = None
    store.flush()
    doc = json.loads((tmp_path / "farm" / artifacts.MANIFEST_NAME).read_text())
    ents = [e for e in doc["artifacts"].values() if e.get("kind") == "cohort_run"]
    assert len(ents) == 3 and {e["rung"] for e in ents} == {2}
    assert all(e["tier"] == "exe" for e in ents)
    for e in ents:
        spec = json.loads((tmp_path / "farm" / e["file"]).read_text())
        assert spec["cohort"]["rung"] == 2
        assert set(spec) == {"format", "struct", "tables", "cohort"}

    def cohort_run():
        members = []
        for delta in ("SubClassOf(Q0 A)", "SubClassOf(Q1 ObjectSomeValuesFrom(r C))"):
            inc = IncrementalClassifier(cfg, device="cpu")
            inc.add_text(BASE)
            idx, batch = inc._ingest(loader.load(delta))
            members.append((inc, inc._delta_fast_plan(idx, cohort_shape=True),
                            batch))
        return members, cohort.execute_delta_cohort(members)

    _m, want = cohort_run()
    PROGRAMS.clear()
    rec = artifacts.install(root, require=True, device="cpu")
    assert sum(1 for p in rec["programs"] if p.get("rung") == 2) == 3
    ARTIFACT_EVENTS.reset()
    members, got = cohort_run()
    assert ARTIFACT_EVENTS.snapshot()["exe_hits"] >= 3
    for (inc, _plan, _batch), g, w in zip(members, got, want):
        st = inc.last_compile
        assert st.program_cache_hit is True and st.compile_s == 0.0
        assert torch.equal(g.packed_s, w.packed_s)
        assert torch.equal(g.packed_r, w.packed_r)
