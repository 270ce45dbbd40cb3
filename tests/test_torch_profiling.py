"""The measurement plane against the reference: ``runtime/profiling.py``
(``profile_saturation``, the split of a trace by rule scope), ``cli
profile``, ``cli bench``, the one-shot ``classify()``,
``RowPackedSaturationEngine.step_cost_model()`` and the launch guard's
card basis (``obs/h100_basis.jsonl``).

The reference's ``profile_saturation`` reads an xplane capture through
``xprof``, which this host lacks, so the port's profile is held to the
reference's ``saturate`` on the same index (iterations, derivations),
to its phase tokens (``_phase_of``) and to the keys of its result; the
split itself is unit-tested on synthetic trace events, a CUDA graph
replay among them.  ``classify()`` and ``cli bench`` are held to the
reference's; ``step_cost_model()`` to the reference's three figures in
exact layout (window CR6 exactly; live-tile CR6, which the reference
runs only in its scanned formulation, apart from that formulation's
CR4 charge), and a bucketed engine's figures to its padded plane.
The repair of the port's reference fixture is checked last.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

from distel_tpu import cli as ref_cli
from distel_tpu.core.indexing import index_ontology as ref_index
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize as ref_normalize
from distel_tpu.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu.owl import parser as ref_parser
from distel_tpu.runtime import classifier as ref_classifier
from distel_tpu.runtime import profiling as ref_profiling
from distel_tpu_torch import cli
from distel_tpu_torch.core.indexing import index_ontology
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.obs import costmodel
from distel_tpu_torch.owl import parser
from distel_tpu_torch.runtime import classifier
from distel_tpu_torch.runtime import profiling
from distel_tpu_torch.runtime.instrumentation import STEP_RULE_EVENTS
from test_runtime import ONTO
from torch_ref_registry import empty_reference_registry
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.ofn"))
#: the tracked basis of the launch guard
CARD_BASIS = str(ROOT / "distel_tpu_torch" / "obs" / "h100_basis.jsonl")

#: every phase the reference's split can name (its own function)
REF_PHASES = {ref_profiling._phase_of(f"a/{t}/b", "") for t in ref_profiling._PHASE_TOKENS} \
    | {ref_profiling._phase_of("", "all-reduce"), ref_profiling._phase_of("", "")}


@pytest.fixture(autouse=True, scope="module")
def step_rule_events_as_found():
    """The profiles here record into the process-wide
    ``STEP_RULE_EVENTS``, whose split the serve plane exports
    (``distel_step_rule_seconds``): the module leaves it as it found it,
    for the port's serve and fleet tests that compare ``/metrics``
    families with the reference's in the same process."""
    with STEP_RULE_EVENTS._lock:
        found = (dict(STEP_RULE_EVENTS.per_rule), STEP_RULE_EVENTS.captures,
                 STEP_RULE_EVENTS.source)
    yield
    with STEP_RULE_EVENTS._lock:
        (STEP_RULE_EVENTS.per_rule, STEP_RULE_EVENTS.captures,
         STEP_RULE_EVENTS.source) = found


def _both(text):
    ridx = ref_index(ref_normalize(ref_parser.parse(text)))
    pidx = index_ontology(normalize(parser.parse(text)))
    return ridx, pidx


def _check_profile(prof, iterations):
    assert set(prof["phases_s"]) <= REF_PHASES
    assert set(prof["per_step_s"]) == set(prof["phases_s"])
    for k, v in prof["phases_s"].items():
        # per step = whole run / iterations, at the reference's roundings
        assert abs(prof["per_step_s"][k] * iterations - v) <= 5e-6 * iterations + 5e-5
    assert abs(sum(prof["phases_s"].values()) - prof["device_total_s"]) \
        <= 5e-4 + 5e-5 * len(prof["phases_s"])
    assert 0 < prof["device_total_s"] <= prof["wall_s"]
    assert prof["device"] == {"platform": "cpu"} and prof["captured"] is False


@pytest.mark.parametrize(
    "text", [pytest.param(p.read_text(), id=p.stem) for p in GOLDEN]
    + [pytest.param(snomed_shaped_ontology(n_classes=300), id="snomed-300")])
def test_profile_matches_reference_saturate(text):
    ridx, pidx = _both(text)
    want = RefEngine(ridx).saturate()
    prof = profiling.profile_saturation(RowPackedSaturationEngine(pidx, device="cpu"))
    assert (prof["iterations"], prof["derivations"]) == (want.iterations, want.derivations)
    _check_profile(prof, prof["iterations"])


@pytest.mark.parametrize("bucket", [True, False])
def test_profile_names_the_rules_and_records_step_rule_events(bucket):
    """On the SNOMED shape every rule family shows in the split, the
    engine's cost model rides along, and the split's per-step figures
    land in ``STEP_RULE_EVENTS`` (the serve plane's
    ``distel_step_rule_seconds``), as the reference feeds it."""
    _ridx, pidx = _both(snomed_shaped_ontology(n_classes=300))
    engine = RowPackedSaturationEngine(pidx, device="cpu", bucket=bucket)
    before = STEP_RULE_EVENTS.snapshot()["captures"]
    prof = profiling.profile_saturation(engine)
    snap = STEP_RULE_EVENTS.snapshot()
    assert snap["captures"] == before + 1 and snap["source"] == "profile_saturation"
    assert {"cr1", "cr3", "cr4", "cr6", "frontier"} <= set(prof["phases_s"])
    for rule in ("cr1", "cr4", "cr6"):
        assert snap["per_rule"][rule] == prof["per_step_s"][rule]
    assert prof["step_cost"] == engine.step_cost_model()
    assert prof["kernels_s"] and all(k.startswith("aten::") for k in prof["kernels_s"])


# ------------------------------------------------ the split, synthetic


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _card_trace():
    """A step: cr4 (a bit-table kernel inside it), an NCCL all-reduce in
    the fold, a kernel outside any scope, then one graph replay of three
    device events (the middle one a copy node run as a kernel)."""
    return [
        _x("user_annotation", "cr4", 0, 100),
        _x("user_annotation", "bit_table", 10, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 2, correlation=2),
        _x("user_annotation", "frontier", 110, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 115, 2, correlation=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 150, 2, correlation=4),
        _x("user_annotation", "step", 200, 50),
        _x("cuda_runtime", "cudaGraphLaunch", 210, 5, correlation=5),
        _x("kernel", "bit_lookup", 20, 3.0, tid=7, correlation=1),
        _x("kernel", "packed_cols_dense", 45, 7.0, tid=7, correlation=2),
        _x("kernel", "ncclDevKernel_AllReduce", 120, 2.0, tid=7, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 152, 1.0, tid=7, correlation=4),
        _x("kernel", "gather", 300, 4.0, tid=7, correlation=5),
        _x("kernel", "copy_kernel", 305, 1.0, tid=7, correlation=5),
        _x("kernel", "packed_cols_list_n", 310, 5.0, tid=7, correlation=5),
    ]


LABELS = [("gather", "cr1", "kernel"), ("Memcpy DtoD", "cr1", "gpu_memcpy"),
          ("packed_cols_list_n", "cr6", "kernel")]


def test_phase_split_attributes_launches_and_replays():
    split = profiling.phase_split(_card_trace(), "cuda", LABELS)
    got = {k: round(v * 1e6, 6) for k, v in split["phases"].items()}
    assert got == {"bit_table_psum": 3.0, "cr4": 7.0, "vote_psum": 2.0,
                   "other": 1.0, "cr1": 5.0, "cr6": 5.0}
    assert split["graph_replays"] == 1 and split["device_events"] == 7
    assert abs(split["device_total_s"] - 23e-6) < 1e-12
    assert round(split["kernels"]["packed_cols_list_n"] * 1e6, 6) == 5.0


def test_phase_split_refuses_a_replay_it_cannot_label():
    with pytest.raises(RuntimeError, match="cannot be split by rule"):
        profiling.phase_split(_card_trace(), "cuda", None)
    wrong = [("gather", "cr1", "kernel"), ("x", "cr1", "gpu_memcpy"),
             ("packed_cols_dense", "cr6", "kernel")]
    with pytest.raises(RuntimeError, match="first differing event 2"):
        profiling.phase_split(_card_trace(), "cuda", wrong)


def test_group_labels_follow_launch_order():
    """An eager group's labels: its device events in launch order, each
    with the scope around its launch (the cr4 scope's launches, then the
    frontier's)."""
    trace = [e for e in _card_trace() if e["args"].get("correlation") != 5
             and e["name"] != "step"]
    assert profiling.group_labels(trace) == [
        ("bit_lookup", "bit_table_psum", "kernel"),
        ("packed_cols_dense", "cr4", "kernel"),
        ("ncclDevKernel_AllReduce", "vote_psum", "kernel"),
        ("Memcpy DtoH", "other", "gpu_memcpy"),
    ]


def test_phase_split_on_the_cpu_counts_outermost_operators():
    trace = [
        _x("user_annotation", "cr2", 0, 50),
        _x("cpu_op", "aten::index", 5, 20),
        _x("cpu_op", "aten::empty", 6, 2),
        _x("cpu_op", "aten::mm", 60, 10),
    ]
    split = profiling.phase_split(trace, "cpu")
    assert {k: round(v * 1e6, 6) for k, v in split["phases"].items()} == \
        {"cr2": 20.0, "other": 10.0}
    assert set(split["kernels"]) == {"aten::index", "aten::mm"}


# ------------------------------------------------ cli profile / bench


def _ref_profile_keys():
    """The keys of the reference's ``profile_saturation`` result."""
    tree = ast.parse(Path(ref_profiling.__file__).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "profile_saturation")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def test_cli_profile_keys_cover_the_reference(tmp_path, capsys):
    onto = tmp_path / "o.ofn"
    onto.write_text(ONTO)
    traces = tmp_path / "traces"
    assert cli.main(["profile", str(onto), "--warm", "--device", "cpu",
                     "--trace-dir", str(traces)]) == 0
    prof = json.loads(capsys.readouterr().out)
    want = _ref_profile_keys()
    assert {"phases_s", "per_step_s", "device_total_s", "wall_s", "host_gap_s",
            "iterations", "derivations"} == want
    assert want | {"device", "captured", "kernels_s", "trace_dir"} <= set(prof)
    assert (traces / "saturate.trace.json").exists()
    ridx, _ = _both(ONTO)
    want_run = RefEngine(ridx).saturate()
    assert (prof["iterations"], prof["derivations"]) == \
        (want_run.iterations, want_run.derivations)


def _profile(tmp_path, capsys, keys=""):
    """``cli profile --device cpu --config`` with ``keys``: its record,
    and whether a process group was left joined."""
    import torch.distributed as dist

    onto = tmp_path / "o.ofn"
    onto.write_text(ONTO)
    props = tmp_path / "c.properties"
    props.write_text(keys)
    assert cli.main(["profile", str(onto), "--config", str(props),
                     "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out), dist.is_initialized()


def test_cli_profile_refuses_a_mesh_config(tmp_path, capsys):
    """As the reference's ``cmd_profile``, ``cli profile`` profiles one
    device: the coordinator keys are ignored (no group is joined, the
    coordinator is never dialled) and the profile is the solo one.  (The
    name is kept from when the port refused a mesh config here.)"""
    solo, _ = _profile(tmp_path, capsys)
    got, joined = _profile(
        tmp_path, capsys,
        "coordinator.address = 127.0.0.1:1\nnum.processes = 2\nprocess.id = 0\n")
    assert not joined
    assert (got["iterations"], got["derivations"]) == \
        (solo["iterations"], solo["derivations"])


def test_cli_profile_with_mesh_devices_profiles_one_device(tmp_path, capsys):
    """``mesh.devices = 2`` in ``cli profile``'s config gives the
    iterations and derivations of the same call without the key (the
    reference's ``make_engine(cfg, idx)`` builds no mesh), and starts no
    process group."""
    solo, _ = _profile(tmp_path, capsys)
    got, joined = _profile(tmp_path, capsys, "mesh.devices = 2\n")
    assert not joined
    assert (got["iterations"], got["derivations"]) == \
        (solo["iterations"], solo["derivations"])
    ridx, _ = _both(ONTO)
    want = RefEngine(ridx).saturate()
    assert (got["iterations"], got["derivations"]) == \
        (want.iterations, want.derivations)


def test_cli_bench_engine_bakeoff_matches_reference(tmp_path, capsys):
    """``tests/test_runtime.py::test_cli_bench_engine_bakeoff`` on the
    port: the same engine set, the same derivations on every engine, and
    the reference's (and the oracle's closure size)."""
    onto = tmp_path / "o.ofn"
    onto.write_text(ONTO)
    argv = ["bench", str(onto), "--engines", "all,oracle", "--repeats", "1"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got["engines"]) == set(want["engines"]) == \
        {"rowpacked", "packed", "dense", "oracle"}
    derivs = {got["engines"][e]["derivations"] for e in ("rowpacked", "packed", "dense")}
    assert derivs == {want["engines"]["rowpacked"]["derivations"]}
    assert got["engines"]["oracle"]["closure_size"] == want["engines"]["oracle"]["closure_size"]
    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]


# ------------------------------------------------ classify()


@pytest.mark.parametrize("form", ["text", "path"])
def test_classify_matches_reference_classify(tmp_path, form):
    text = snomed_shaped_ontology(n_classes=400, seed=5)
    arg = text
    if form == "path":
        arg = str(tmp_path / "o.ofn")
        Path(arg).write_text(text)
    want = ref_classifier.classify(arg)
    got = classifier.classify(arg, device="cpu")
    assert got.taxonomy.parents == want.taxonomy.parents
    assert got.taxonomy.equivalents == want.taxonomy.equivalents
    assert got.taxonomy.subsumers == want.taxonomy.subsumers
    assert (got.result.derivations, got.result.iterations) == \
        (want.result.derivations, want.result.iterations)


# ------------------------------------------------ step_cost_model()


@pytest.mark.parametrize("n", [300, 1500])
def test_step_cost_model_matches_reference_with_window_cr6(n):
    ridx, pidx = _both(snomed_shaped_ontology(n_classes=n, seed=42))
    off = {"enable": False}
    want = RefEngine(ridx, bucket=False, cr6_tiles=off).step_cost_model()
    got = RowPackedSaturationEngine(pidx, device="cpu", bucket=False,
                                    cr6_tiles=off).step_cost_model()
    assert got == want


def _scan_charge(d, w4):
    """The reference's card-traffic charge of one scanned CR4/CR6 table
    (its padded slots, source gathers and deferred write groups)."""
    out = d["nch"] * d["T"] * d["lcn"] * w4 + d["nch"] * d["rk"] * w4
    for _g0, _g1, plan, _rows in d["groups"]:
        out += 2 * plan.n_targets * w4 + 2 * plan.k * w4
    return out


def _window_charge(engine, w4):
    """The same table in window form: each chunk's live windows, its
    source gather and its target RMW."""
    return sum((len(c.windows) * engine.lc4 + int(c.src.shape[0])
                + 2 * c.piece.n_targets) * w4 for c in engine._chunks4)


@pytest.mark.parametrize("n", [600, 1500])
def test_step_cost_model_matches_reference_with_live_tiles(n):
    """Live-tile CR6: the reference engages it only in its scanned
    formulation (``scan_chunks=True``), where its CR4 is charged as a
    scanned table; the port runs CR4 on windows.  The MAC figures are
    equal; the bytes differ by exactly that CR4 charge."""
    ridx, pidx = _both(snomed_shaped_ontology(n_classes=n, seed=42))
    tiles = {"density_threshold": 100.0}
    ref = RefEngine(ridx, bucket=False, scan_chunks=True, cr6_tiles=tiles)
    port = RowPackedSaturationEngine(pidx, device="cpu", bucket=False, cr6_tiles=tiles)
    assert port.cr6_tiles_stats["active"] and ref._tiles6 is not None
    want, got = ref.step_cost_model(), port.step_cost_model()
    assert got["mm_dense_equiv_macs"] == want["mm_dense_equiv_macs"]
    assert got["mm_live_macs"] == want["mm_live_macs"]
    w4 = 4 * port.wc
    assert got["hbm_bytes"] == (want["hbm_bytes"] - _scan_charge(ref._scan4, w4)
                                + _window_charge(port, w4))
    assert got["mm_live_macs"] < RowPackedSaturationEngine(
        pidx, device="cpu", bucket=False, cr6_tiles={"enable": False},
    ).step_cost_model()["mm_live_macs"]


def test_step_cost_model_of_a_bucketed_engine_charges_its_padded_plane():
    """A bucketed engine's step launches every window slot of its rung
    over every chunk's padded rows: its figures charge that plane (the
    named difference from the exact plan), never less than exact."""
    _ridx, pidx = _both(snomed_shaped_ontology(n_classes=1500, seed=42))
    exact = RowPackedSaturationEngine(pidx, device="cpu", bucket=False).step_cost_model()
    eng = RowPackedSaturationEngine(pidx, device="cpu", bucket=True)
    got = eng.step_cost_model()
    s = eng._bstruct
    planes = [rs for rs in (s.cr4, s.cr6) if rs is not None]
    assert planes
    assert got["mm_live_macs"] == sum(
        rs.chunks * rs.slots * rs.rows * rs.length for rs in planes) * eng.nc
    assert got["mm_dense_equiv_macs"] == sum(rs.chunks * rs.rows for rs in planes) \
        * eng.nl * eng.nc
    for k in ("hbm_bytes", "mm_dense_equiv_macs", "mm_live_macs"):
        assert got[k] >= exact[k]


# ------------------------------------------------ the guard's card basis


def test_launch_guard_fits_the_card_basis_and_refuses_a_small_budget(monkeypatch):
    monkeypatch.delenv("DISTEL_COSTMODEL_BASIS", raising=False)
    assert CARD_BASIS in costmodel.default_basis_paths(str(ROOT / "no-such-root"))
    recs = [json.loads(ln) for ln in Path(CARD_BASIS).read_text().splitlines()]
    assert recs and all(r["card"]["name"].startswith("NVIDIA H100")
                        and r["card"]["power_limit"] for r in recs)
    sizes = {r["corpus"]["n_classes"] for r in recs}
    assert 64000 in sizes and len(sizes) >= 2
    model = costmodel.fit_from_paths([CARD_BASIS], shards=1)
    assert model is not None and len(model.describe(64000)["basis"]) == len(sizes)
    predicted = costmodel.guard_launch(model, 88000, 0.0)["predicted_total_s"]
    assert predicted > 0
    assert costmodel.guard_launch(model, 88000, predicted / 10)["allowed"] is False
    assert costmodel.guard_launch(model, 88000, predicted * 10)["allowed"] is True


def test_cli_classify_refuses_on_the_card_basis(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DISTEL_COSTMODEL_BASIS", raising=False)
    onto = tmp_path / "o.ofn"
    onto.write_text("\n".join(f"SubClassOf(C{i} C{i // 2})" for i in range(1, 40000)))
    assert cli.main(["classify", str(onto), "--budget-s", "0", "--device", "cpu"]) == 3
    out = capsys.readouterr()
    guard = json.loads(next(ln for ln in out.out.splitlines()
                            if "launch_guard" in ln))["launch_guard"]
    assert guard["allowed"] is False
    assert any("h100_basis.jsonl" in b["source"] for b in guard["basis"])


# ------------------------------------------------ the fixture's repair


def test_reference_runs_start_from_an_empty_registry():
    """A reference program left in the process-wide registry by another
    test file (here: a stale object under every key a reference classify
    builds) breaks the next reference run that hits it — the fault of
    ``tests/test_artifacts.py``'s farm before ``tests/test_torch_warmup.
    py`` under the old fixture, which kept the programs it found.  Under
    :func:`empty_reference_registry` the run starts empty and passes,
    and what was found is back afterwards."""
    from distel_tpu.core.program_cache import PROGRAMS
    from distel_tpu.runtime.classifier import ELClassifier as RefClassifier

    text = snomed_shaped_ontology(n_classes=200, seed=3)
    with empty_reference_registry():
        want = RefClassifier().classify_text(text).result.derivations
        keys = list(PROGRAMS._programs)
    assert keys and not set(keys) & set(PROGRAMS._programs)

    class Stale:
        def __call__(self, *a, **k):
            raise RuntimeError("a stale program from another test file")

        def __getattr__(self, name):
            raise RuntimeError("a stale program from another test file")

    with empty_reference_registry():
        for k in keys:
            PROGRAMS._programs[k] = Stale()
        # the old fixture's state: the stale programs are found and hit
        with pytest.raises(Exception):
            RefClassifier().classify_text(text)
        with empty_reference_registry():
            assert RefClassifier().classify_text(text).result.derivations == want
        assert all(isinstance(PROGRAMS._programs[k], Stale) for k in keys)
