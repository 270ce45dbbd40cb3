"""Warmup: ``runtime/warmup.py``, ``ServeApp(warmup_paths=...)``,
``cli warmup`` and ``/metrics``, against the reference's.

``warmup_paths`` on both profiles builds a sample corpus's programs
into ``core/program_cache.PROGRAMS``; its records carry the reference's
keys, the artifact farm's attribution among them, and a same-bucket
classify or serve load afterwards builds nothing.  The serve plane's
background warmup moves the reference's warmup and program-cache
series, and ``/metrics`` names every series the reference's serve app
names, the artifact farm's five among them.
"""

import json
import re

import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.runtime import warmup as ref_warmup
from distel_tpu.serve.server import ServeApp as RefApp
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.program_cache import PROGRAMS
from distel_tpu_torch.runtime import warmup
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.serve import server as serve_server
from distel_tpu_torch.serve.server import ServeApp
from test_bucketing import _same_bucket_pair
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ARTIFACT_SERIES = {
    "distel_artifact_exe_hits_total", "distel_artifact_hlo_hits_total",
    "distel_artifact_misses_total", "distel_artifact_rejected_total",
    "distel_persistent_cache_hits_total",
}
#: record keys of the warmup that name the artifact farm
ARTIFACT_KEYS = {"artifact_exe_hits", "artifact_hlo_hits",
                 "artifact_serialized", "artifact_unserializable"}


@pytest.fixture()
def pair(tmp_path):
    ta, tb = _same_bucket_pair()
    pa, pb = tmp_path / "a.ofn", tmp_path / "b.ofn"
    pa.write_text(ta)
    pb.write_text(tb)
    return str(pa), str(pb)


@pytest.mark.parametrize("profile", ["serve", "classify"])
def test_warmup_paths_builds_the_bucket(pair, profile):
    pa, pb = pair
    cfg = ClassifierConfig(fast_path_min_concepts=0)
    PROGRAMS.clear()
    recs = warmup.warmup_paths([pa], cfg, profile=profile, device="cpu")
    ref_recs = ref_warmup.warmup_paths([pa], RefConfig(fast_path_min_concepts=0),
                                       profile=profile)
    assert set(recs[0]) == set(ref_recs[0])
    assert ARTIFACT_KEYS <= set(recs[0])
    rec = recs[0]
    assert rec["file"] == pa and rec["profile"] == profile
    assert rec["program_cache_hit"] is False and rec["trace_lower_s"] > 0
    assert rec["delta_programs"] == (4 if profile == "serve" else 0)
    # warming the same bucket again builds nothing
    again = warmup.warmup_paths([pb], cfg, profile=profile, device="cpu")[0]
    assert again["bucket_signature"] == rec["bucket_signature"]
    assert again["program_cache_hit"] is True
    assert again["compile_s"] == 0.0 == again["trace_lower_s"]
    if profile == "classify":
        with open(pb) as f:
            res = ELClassifier(cfg, device="cpu").classify_text(f.read())
        assert res.compile_stats.program_cache_hit
        assert res.compile_stats.compile_s == 0.0


def test_serve_background_warmup_makes_load_build_nothing(pair):
    pa, pb = pair
    PROGRAMS.clear()
    app = ServeApp(ClassifierConfig(fast_path_min_concepts=0), device="cpu",
                   warmup_paths=[pa])
    try:
        assert app.warmup_wait(120)
        status, _, body = app.dispatch("GET", "/healthz", {}, b"", None)
        assert json.loads(body)["warmup_done"] is True
        with open(pb) as f:
            status, _, body = app.dispatch(
                "POST", "/v1/ontologies", {}, json.dumps({"text": f.read()}).encode(),
                None,
            )
        doc = json.loads(body)
        assert status == 201, doc
        assert doc["program_cache_hit"] is True and doc["compile_s"] == 0.0, doc
        # the first delta of the warmed bucket builds nothing either
        status, _, body = app.dispatch(
            "POST", f"/v1/ontologies/{doc['id']}/deltas", {},
            json.dumps({"text": "SubClassOf(NewW C0)"}).encode(), None,
        )
        delta = json.loads(body)
        assert delta["path"] == "fast" and delta["compile_s"] == 0.0, delta
        assert delta["delta_program_hits"] == delta["delta_programs"] > 0, delta
        _, _, page = app.dispatch("GET", "/metrics", {}, b"", None)
        page = page.decode()
        assert re.search(r"^distel_warmup_done 1", page, re.M)
        assert re.search(r"^distel_warmup_programs_total 1", page, re.M)
        assert re.search(r"^distel_program_cache_hits_total 2", page, re.M)
        assert re.search(r"^distel_delta_program_cache_hits_total", page, re.M)
        assert re.search(r"^distel_delta_compile_seconds", page, re.M)
        assert "distel_warmup_errors_total" not in page
    finally:
        app.close(final_spill=False)


def test_serve_warmup_error_is_counted_not_fatal(tmp_path):
    app = ServeApp(device="cpu", warmup_paths=[str(tmp_path / "missing.ofn")])
    try:
        assert app.warmup_wait(60)
        _, _, page = app.dispatch("GET", "/metrics", {}, b"", None)
        assert re.search(r"^distel_warmup_errors_total 1", page.decode(), re.M)
        assert re.search(r"^distel_warmup_done 1", page.decode(), re.M)
    finally:
        app.close(final_spill=False)


def _names(app):
    """Every metric family a serve app describes (its HELP lines)."""
    _, _, page = app.dispatch("GET", "/metrics", {}, b"", None)
    return set(re.findall(r"^# HELP (\S+)", page.decode(), re.M))


def test_metrics_names_are_the_reference_minus_the_farm():
    """The port's ``/metrics`` names every series the reference's does,
    the farm's five among them.  (The name is kept from when the farm's
    series were not ported.)"""
    ref = RefApp(RefConfig())
    port = ServeApp(device="cpu")
    try:
        want, got = _names(ref), _names(port)
    finally:
        ref.close(final_spill=False)
        port.close(final_spill=False)
    assert not set(serve_server.NOT_YET_PORTED) & ARTIFACT_SERIES
    # the persistent-cache series is the port's process aggregate (kernel
    # libraries found built), always there; the reference's appears
    # once an XLA disk-cache hit happened
    process = {"distel_persistent_cache_hits_total"}
    assert got - process == want - process and ARTIFACT_SERIES <= got
    assert "distel_program_cache_evictions_total" in got


def test_cli_warmup(pair, capsys):
    pa, pb = pair
    PROGRAMS.clear()
    assert cli.main(["warmup", pa, pb, "--device", "cpu", "--serial",
                     "--profile", "classify"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["file"] for r in lines[:2]] == [pa, pb]
    assert lines[1]["program_cache_hit"] is True
    assert lines[2]["warmed_buckets"] == 1 and lines[2]["corpora"] == 2
    # a farm that is not there: refused under --artifacts-require, and
    # without it warned about while the corpora warm all the same
    from distel_tpu_torch.core.artifacts import ArtifactError

    with pytest.raises(ArtifactError, match="no artifact manifest"):
        cli.main(["warmup", pa, "--device", "cpu", "--artifacts-dir",
                  "no-such-farm", "--artifacts-require"])
    with pytest.warns(RuntimeWarning, match="NOT installed"):
        assert cli.main(["warmup", pa, "--device", "cpu", "--artifacts-dir",
                         "no-such-farm"]) == 0


def test_cli_fleet_passes_warmup_to_its_replicas(monkeypatch, tmp_path):
    """``cli fleet --warmup`` hands the sample corpora to every replica's
    ``cli serve`` (the supervisor's extra arguments), as the reference's
    fleet does."""
    from distel_tpu_torch.serve.fleet import supervisor

    seen = {}

    class Stub:
        def __init__(self, n, *, spill_dir, extra_args, **kw):
            seen.update(n=n, extra=list(extra_args))

        def start(self):
            raise RuntimeError("stub: no replica is started")

        def stop(self, graceful=True):
            seen["stopped"] = graceful

    monkeypatch.setattr(supervisor, "ReplicaSupervisor", Stub)
    rc = cli.main(["fleet", "--replicas", "2", "--device", "cpu",
                   "--spill-dir", str(tmp_path), "--warmup", "a.ofn", "b.ofn"])
    assert rc == 1 and seen["n"] == 2 and seen["stopped"] is False
    i = seen["extra"].index("--warmup")
    assert seen["extra"][i:i + 3] == ["--warmup", "a.ofn", "b.ofn"]


def test_cli_warmup_builds_the_cohort_programs(tmp_path, capsys):
    """``cohort.warm.sizes`` in the ``--config`` of ``cli warmup``: the
    canonical delta roster's cohort programs (mixed delta, cross, base)
    are built at the sizes' rungs, so the process's first cohort of two
    same-bucket tenants builds nothing (``compile_s`` 0.0, registry
    hits)."""
    from distel_tpu_torch.core import cohort
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.owl import loader

    base = "\n".join([f"SubClassOf(W{i} W{i + 1})" for i in range(8)]
                     + ["SubClassOf(W1 ObjectSomeValuesFrom(r W3))",
                        "SubObjectPropertyOf(ObjectPropertyChain(r r) r)"])
    path = tmp_path / "base.ofn"
    path.write_text(base)
    props = tmp_path / "c.properties"
    props.write_text("cohort.warm.sizes = 2, 3\nfast.path.min.concepts = 0\n")
    PROGRAMS.clear()
    assert cli.main(["warmup", str(path), "--device", "cpu", "--config",
                     str(props)]) == 0
    capsys.readouterr()
    rungs = sorted(k[3] for k in PROGRAMS._programs if k[1] == "cohort_run")
    assert rungs == [2, 2, 2, 4, 4, 4]
    cfg = ClassifierConfig.from_properties(str(props))
    members = []
    for delta in ("SubClassOf(Nx W2)", "SubClassOf(W5 ObjectSomeValuesFrom(r W0))"):
        inc = IncrementalClassifier(cfg, device="cpu")
        inc.add_text(base)
        idx, batch = inc._ingest(loader.load(delta))
        members.append((inc, inc._delta_fast_plan(idx, cohort_shape=True), batch))
    cohort.execute_delta_cohort(members)
    for inc, _plan, _batch in members:
        st = inc.last_compile
        assert st.program_cache_hit is True and st.compile_s == 0.0, st.as_dict()
        assert inc.history[-1]["path"] == "cohort"
