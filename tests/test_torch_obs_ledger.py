"""The port's run ledger, cost model, progress plane and their wiring.

``obs/ledger.py``, ``obs/costmodel.py`` and ``runtime/progress.py`` are
pinned copies of the reference's: equal apart from import lines and one
listed adaptation each (the ledger's card-memory reading, the cost
model's default calibration basis; progress has none).  The reference's
``tests/test_run_ledger.py`` cases that need no probe script run here
against the port's modules; then the wiring the port adds around them:
the observed rebuild behind ``obs.ledger.enable``, a traced rebuild
under ``obs.trace_rounds`` (one span event a retired round, the
reference's), ``/debug/runs`` and the ``distel_run_*`` gauges on
``ServeApp``, ``cli runs`` and ``classify --budget-s``, and the config
keys against the reference's parsing.
"""

import ast
import json
import os
from pathlib import Path

import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.obs.trace import SpanRecorder as RefRecorder
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.frontend.ontology_tools import chain_tailed_ontology
from distel_tpu_torch.obs import costmodel as cm
from distel_tpu_torch.obs import ledger as lg
from distel_tpu_torch.obs.trace import SpanRecorder
from distel_tpu_torch.serve.server import ServeApp
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

#: each pinned copy, with the top-level functions its adaptation
#: replaces (their bodies differ from the reference's; the rest of the
#: module may differ in import lines only)
PINNED = {
    "obs/ledger.py": ("device_peak_mb",),
    "obs/costmodel.py": ("default_basis_paths",),
    "runtime/progress.py": (),
}


def _without(path, names):
    """Module text lines without its import lines of either package
    and without the named top-level functions."""
    text = path.read_text()
    drop = set()
    for node in ast.parse(text).body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [
        ln for i, ln in enumerate(text.splitlines(), start=1)
        if i not in drop
        and not ln.lstrip().startswith(("from distel_tpu", "import distel_tpu"))
    ]


@pytest.mark.parametrize("rel", sorted(PINNED))
def test_module_is_a_copy_but_for_its_adaptation(rel):
    port, ref = ROOT / "distel_tpu_torch" / rel, ROOT / "distel_tpu" / rel
    assert _without(port, PINNED[rel]) == _without(ref, PINNED[rel])
    imports = [ln.strip() for ln in port.read_text().splitlines()
               if ln.lstrip().startswith(("from distel_tpu", "import distel_tpu"))]
    assert all(ln.startswith("from distel_tpu_torch.") for ln in imports)
    if not PINNED[rel]:
        assert port.read_text() == ref.read_text()


def test_adapted_functions():
    """The two adaptations: the card's peak reads torch's allocator
    (None without a card, as the reference's CPU backend answers), and
    the default basis is the port's own ledgers under ``runs/``."""
    if not torch.cuda.is_available():
        assert lg.device_peak_mb() is None
    assert cm.default_basis_paths(str(ROOT / "no-such-root")) == []


# ------------------------------------------------------ writer / reader


def test_ledger_round_trip_and_torn_final_line(tmp_path):
    p = str(tmp_path / "a.ledger.jsonl")
    led = lg.RunLedger(p, "r1")
    led.open_run(meta={"n_classes": 10}, budget_s=60.0)
    led.round(round=1, iteration=1, derivations=5, derivations_total=5,
              elapsed_s=0.1)
    led.snapshot(path="s.npz", iteration_total=1)
    led.close_run("converged", iterations=1, wall_s=0.2)
    led.close()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"ev": "round", "ro')
    recs = lg.read_ledger(p, strict=True)
    assert [r["ev"] for r in recs] == ["open", "round", "snapshot", "close"]
    assert [r["seq"] for r in recs] == [1, 2, 3, 4]
    assert recs[0]["budget_s"] == 60.0


def test_ledger_rejects_malformed_mid_file_line(tmp_path):
    p = str(tmp_path / "b.ledger.jsonl")
    with open(p, "w", encoding="utf-8") as f:
        f.write('{"ev": "open", "run_id": "x", "chain_run_id": "x"}\n')
        f.write("garbage not json\n")
        f.write('{"ev": "close", "run_id": "x", "chain_run_id": "x"}\n')
    with pytest.raises(lg.LedgerCorrupt):
        lg.read_ledger(p, strict=True)
    assert len(lg.read_ledger(p, strict=False)) == 2


def _rec(ev, run="r1", **kw):
    return {"ev": ev, "run_id": run, "chain_run_id": "c", **kw}


def test_validate_chain_monotone_rounds_and_crash_form():
    ok = [_rec("open"), _rec("round", round=2), _rec("round", round=4),
          _rec("close", status="converged")]
    s = lg.validate_chain(ok)
    assert s["rounds"] == 2 and s["converged"] and s["crashed_runs"] == 0
    bad = [_rec("open"), _rec("round", round=4), _rec("round", round=4)]
    with pytest.raises(ValueError, match="monotone"):
        lg.validate_chain(bad)
    killed = [
        _rec("open"), _rec("round", round=2), _rec("snapshot"),
        _rec("open", run="r2"), _rec("round", run="r2", round=4),
        _rec("close", run="r2", status="converged"),
    ]
    s = lg.validate_chain(killed)
    assert s["runs"] == 2 and s["crashed_runs"] == 1
    assert s["closed_runs"] == 1 and s["converged"]
    with pytest.raises(ValueError, match="start with an open"):
        lg.validate_chain([_rec("round", round=1)])


def test_validate_chain_supersedes_crashed_tail_overlap():
    overlap = [
        _rec("open"),
        _rec("round", round=1, derivations_total=10, elapsed_s=1.0),
        _rec("snapshot"),
        _rec("round", round=2, derivations_total=30, elapsed_s=2.0),
        _rec("round", round=3, derivations_total=50, elapsed_s=3.0),
        _rec("open", run="r2"),
        _rec("round", run="r2", round=2, derivations_total=31),
        _rec("round", run="r2", round=3, derivations_total=52),
        _rec("round", run="r2", round=4, derivations_total=60),
        _rec("close", run="r2", status="converged", wall_s=4.0),
    ]
    s = lg.validate_chain(overlap)
    assert s["runs"] == 2 and s["crashed_runs"] == 1
    assert s["rounds"] == 4 and s["last_round"] == 4 and s["converged"]
    rep = lg.report_chain(overlap)
    assert [c["derivations_total"] for c in rep["curve"]] == [10, 31, 52, 60]
    assert rep["wall_s"] == pytest.approx(7.0)
    closed_overlap = [
        _rec("open"), _rec("round", round=2),
        _rec("close", status="converged"),
        _rec("open", run="r2"), _rec("round", run="r2", round=2),
    ]
    with pytest.raises(ValueError, match="monotone"):
        lg.validate_chain(closed_overlap)


# -------------------------------------------------------- the observer


def test_ledger_observer_round_records(tmp_path):
    from distel_tpu_torch.runtime.instrumentation import FrontierStats

    p = str(tmp_path / "c.ledger.jsonl")
    led = lg.RunLedger(p, "rx")
    led.open_run(meta={"n_classes": 100})
    tele = lg.RunTelemetry()
    obs = lg.LedgerObserver(led, telemetry=tele, track_device_mem=False)
    st = FrontierStats(iteration=2, tier="sparse", density=0.01,
                       rows_touched=7, derivations=50, dispatch_s=0.01,
                       retire_s=0.02, inflight=1)
    obs.frontier_observer(st)
    obs.observer(2, 150, True)
    obs.observer(4, 175, True)
    obs.close("converged", iterations=4, derivations=175)
    led.close()
    recs = lg.read_ledger(p)
    r1, r2 = [r for r in recs if r["ev"] == "round"]
    assert r1["round"] == 2 and r1["derivations"] == 150
    assert r1["tier"] == "sparse" and r1["inflight"] == 1
    assert r1["host_mb"] > 0
    assert r2["derivations"] == 25 and "tier" not in r2
    assert recs[-1]["ev"] == "close" and recs[-1]["status"] == "converged"
    g = tele.gauges()
    assert g["distel_run_round"] == 0.0 and g["distel_run_stall"] == 0.0


def test_ledger_observer_resume_accounting(tmp_path):
    p = str(tmp_path / "d.ledger.jsonl")
    led = lg.RunLedger(p, "r2", chain_run_id="chain0")
    led.open_run()
    obs = lg.LedgerObserver(led, base_iters=10, base_derivs=1000,
                            telemetry=None, track_device_mem=False)
    obs.observer(2, 40, True)
    led.close()
    rec = [r for r in lg.read_ledger(p) if r["ev"] == "round"][0]
    assert rec["round"] == 12 and rec["derivations_total"] == 1040
    assert rec["derivations"] == 40 and rec["chain_run_id"] == "chain0"


def test_rule_seconds_stamped_from_step_rule_events(tmp_path):
    import distel_tpu_torch.runtime.instrumentation as instr

    p = str(tmp_path / "e.ledger.jsonl")
    led = lg.RunLedger(p, "r3")
    led.open_run()
    obs = lg.LedgerObserver(led, telemetry=None, track_device_mem=False)
    agg = instr.StepRuleAggregate()
    agg.record({"cr6": 0.4, "cr1": 0.1}, source="test")
    old = instr.STEP_RULE_EVENTS
    instr.STEP_RULE_EVENTS = agg
    try:
        obs.observer(2, 10, True)
    finally:
        instr.STEP_RULE_EVENTS = old
    led.close()
    rec = [r for r in lg.read_ledger(p) if r["ev"] == "round"][0]
    assert rec["rule_seconds"] == {"cr6": 0.4, "cr1": 0.1}


def test_budget_exhaustion_raises_and_flags(tmp_path):
    p = str(tmp_path / "f.ledger.jsonl")
    led = lg.RunLedger(p, "r4")
    led.open_run(budget_s=0.0)
    obs = lg.LedgerObserver(led, budget_s=0.0, telemetry=None,
                            track_device_mem=False)
    with pytest.raises(lg.BudgetExhausted):
        obs.observer(2, 10, True)
    assert obs.budget_exhausted
    rounds = [r for r in lg.read_ledger(p) if r["ev"] == "round"]
    assert len(rounds) == 1 and rounds[0]["budget_remaining_s"] <= 0
    led2 = lg.RunLedger(str(tmp_path / "g.ledger.jsonl"), "r5")
    led2.open_run(budget_s=0.0)
    obs2 = lg.LedgerObserver(led2, budget_s=0.0, telemetry=None,
                             track_device_mem=False, raise_on_budget=False)
    obs2.observer(2, 10, True)
    assert obs2.budget_exhausted
    obs3 = lg.LedgerObserver(
        lg.RunLedger(str(tmp_path / "h.ledger.jsonl"), "r6"),
        budget_s=0.0, telemetry=None, track_device_mem=False,
    )
    obs3.observer(2, 10, False)
    assert not obs3.budget_exhausted


# -------------------------------------------------------------- watchdog


def test_watchdog_stall_fires_once_and_rearms(tmp_path):
    led = lg.RunLedger(str(tmp_path / "w.ledger.jsonl"), "w1")
    wd = lg.StallWatchdog(ledger=led, stall_rounds=2)
    assert wd.observe(1, 100, True, 1.0) == []
    assert wd.observe(2, 0, True, 1.0) == []
    assert [f["anomaly"] for f in wd.observe(3, 0, True, 1.0)] == ["stall"]
    assert wd.stalled
    assert wd.observe(4, 0, True, 1.0) == []
    assert wd.observe(5, 10, True, 1.0) == []
    assert not wd.stalled
    assert wd.observe(6, 0, True, 1.0) == []
    assert [f["anomaly"] for f in wd.observe(7, 0, True, 1.0)] == ["stall"]
    assert lg.StallWatchdog(stall_rounds=1).observe(1, 0, False, 1.0) == []


def test_watchdog_round_wall_regression_and_memory_growth():
    from distel_tpu_torch.obs.flight import FlightRecorder

    wd = lg.StallWatchdog(wall_factor=4.0, min_median_s=0.05)
    for i in range(4):
        assert wd.observe(i, 10, True, 1.0) == []
    fired = wd.observe(5, 10, True, 5.0)
    assert [f["anomaly"] for f in fired] == ["round_wall_regression"]
    flight = FlightRecorder(service="t")
    wd = lg.StallWatchdog(flight=flight, mem_rounds=3)
    fired = []
    for i, mb in enumerate((100, 110, 120, 130, 140)):
        fired += wd.observe(i, 10, True, 1.0, host_mb=mb)
    assert [f["anomaly"] for f in fired] == ["memory_growth"]
    assert [e["kind"] for e in flight.events()] == ["run_anomaly"]


# ------------------------------------------------------------ reporting


def _synthetic_chain(tmp_path):
    p = str(tmp_path / "chain.ledger.jsonl")
    led = lg.RunLedger(p, "s1", chain_run_id="c1")
    led.open_run(
        meta={"n_classes": 500},
        predicted={"predicted_wall_s": 12.0, "predicted_rounds": 4},
    )
    for i, (tot, rules) in enumerate(
        [(100, {"cr6": 0.6, "cr1": 0.2}), (150, {"cr6": 0.6, "cr1": 0.2}),
         (175, None), (175, None)], start=1,
    ):
        kw = {"round": i, "iteration": i, "derivations_total": tot,
              "elapsed_s": float(i), "eta_s": 4.0 - i}
        if rules:
            kw["rule_seconds"] = rules
        led.round(**kw)
    led.close_run(
        "converged", iterations=4, wall_s=10.0,
        eta_final={"predicted_tail_s": 1.0, "actual_tail_s": 2.0,
                   "error_s": -1.0},
    )
    led.close()
    return p


def test_report_chain_rule_shares_curve_and_prediction_error(tmp_path):
    rep = lg.report_chain(
        lg.chains(lg.read_ledger(_synthetic_chain(tmp_path)))["c1"]
    )
    assert rep["rounds"] == 4 and rep["derivations_total"] == 175
    assert [c["derivations_total"] for c in rep["curve"]] == [100, 150, 175, 175]
    assert rep["rule_shares"] == {"cr6": 0.75, "cr1": 0.25}
    assert rep["launch_prediction"]["error"] == pytest.approx(0.2)


def test_cli_runs_list_report_and_watch(tmp_path, capsys):
    p = _synthetic_chain(tmp_path)
    assert cli.main(["runs", "list", p]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["chains"][0]["chain_run_id"] == "c1"
    assert doc["chains"][0]["rounds"] == 4
    assert cli.main(["runs", "report", p, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["rounds"] == 4 and rep["converged"]
    assert cli.main(["runs", "report", p]) == 0
    text = capsys.readouterr().out
    assert "launch prediction" in text and "rule shares" in text
    assert cli.main(
        ["runs", "watch", p, "--interval", "0.01", "--iterations", "2"]
    ) == 0
    assert len(capsys.readouterr().out.strip().splitlines()) == 6


def test_cli_classify_budget_guard_refuses_zero_budget(tmp_path, capsys):
    """``classify --budget-s 0`` runs the guard (a falsy-zero skip would
    launch unguarded) and refuses with rc 3 against a basis of one
    executed ledgered run; with an empty basis it allows the launch and
    says so, as the reference does."""
    basis = str(tmp_path / "basis.ledger.jsonl")
    led = lg.RunLedger(basis, "b1")
    led.open_run(meta={"n_classes": 1000, "n_shards": 1})
    for i in range(1, 6):
        led.round(round=i, iteration=i, derivations_total=10 * i,
                  elapsed_s=float(i), round_wall_s=1.0)
    led.close_run("converged", iterations=5, wall_s=5.0)
    led.close()
    onto = tmp_path / "o.ofn"
    onto.write_text("\n".join(f"SubClassOf(C{i} C{i // 2})" for i in range(1, 2000)))
    rc = cli.main(["classify", str(onto), "--budget-s", "0",
                   "--model-from", basis, "--device", "cpu"])
    assert rc == 3
    out = capsys.readouterr()
    guard = json.loads(
        next(ln for ln in out.out.splitlines() if "launch_guard" in ln)
    )["launch_guard"]
    assert guard["allowed"] is False and guard["fits"] is False
    assert guard["basis"] and "refusing launch" in out.err
    empty = cm.guard_launch(cm.fit_from_paths([]), 2000, 0.0)
    assert empty["allowed"] is True
    assert "no executed observations" in empty["reason"]


# ----------------------------------------------- serve + rebuild plane

REBUILD_TEXT = (
    "SubClassOf(A B)\nSubClassOf(B C)\n"
    "SubClassOf(C ObjectSomeValuesFrom(r D))\n"
    "SubClassOf(ObjectSomeValuesFrom(r D) E)\n"
)


def test_rebuild_path_emits_ledger_behind_knob(tmp_path):
    d = str(tmp_path / "runs")
    inc = IncrementalClassifier(
        ClassifierConfig(obs_ledger=True, obs_ledger_dir=d), device="cpu"
    )
    inc.add_text(REBUILD_TEXT)
    files = [f for f in os.listdir(d) if f.endswith(".ledger.jsonl")]
    assert len(files) == 1
    recs = lg.read_ledger(os.path.join(d, files[0]))
    by_chain = lg.chains(recs)
    s = lg.validate_chain(next(iter(by_chain.values())))
    assert s["runs"] == 1 and s["closed_runs"] == 1
    assert s["converged"] and s["rounds"] == len(inc._base_engine.frontier_rounds)
    assert recs[-1]["iterations"] == inc.history[-1]["iterations"]
    cal = cm.load_ledger_observations(os.path.join(d, files[0]))
    assert len(cal) == 1 and cal[0].kind == "exec"
    assert cal[0].n == recs[0]["meta"]["n_classes"] > 0
    d2 = str(tmp_path / "runs2")
    inc2 = IncrementalClassifier(
        ClassifierConfig(obs_ledger=False, obs_ledger_dir=d2), device="cpu"
    )
    inc2.add_text("SubClassOf(A B)\n")
    assert not os.path.exists(d2)
    assert not inc2._base_engine.frontier_rounds


def test_ledgered_rebuild_matches_unobserved(tmp_path):
    """The observed rebuild's closure and derivations are the
    unobserved rebuild's, with the controller forced onto the sparse
    tier (threshold 1.1, hysteresis 1); its iterations count a sparse
    round as one, as the reference's controller does."""
    text = chain_tailed_ontology(400, 12)
    results = []
    for ledger in (True, False):
        cfg = ClassifierConfig(obs_ledger=ledger,
                               obs_ledger_dir=str(tmp_path / "runs"),
                               sparse_density_threshold=1.1,
                               sparse_hysteresis_rounds=1)
        inc = IncrementalClassifier(cfg, device="cpu")
        res = inc.add_text(text)
        results.append((res.derivations, res.wire()[0].tobytes(),
                        res.wire()[1].tobytes()))
        if ledger:
            rounds = inc._base_engine.frontier_rounds
            assert "sparse" in {st.tier for st in rounds}
            assert res.iterations == rounds[-1].iteration
    assert results[0] == results[1]


def _round_events(spans):
    return [
        {k: v for k, v in e["attrs"].items() if k not in ("dispatch_s", "retire_s")}
        for s in spans for e in s["events"] if e["name"] == "saturation.round"
    ]


def test_traced_rebuild_carries_one_round_event_a_round():
    """A sampled request under ``obs.trace_rounds``: the rebuild runs
    observed and its span carries one ``saturation.round`` event per
    retired round, equal (less the host walls) to the reference's."""
    text = chain_tailed_ontology(400, 12)
    rec = SpanRecorder(service="t")
    inc = IncrementalClassifier(ClassifierConfig(obs_trace_rounds=True),
                                device="cpu")
    with rec.span("root"):
        inc.add_text(text)
    got = _round_events(rec.spans())
    assert len(got) == len(inc._base_engine.frontier_rounds) > 0
    ref_rec = RefRecorder(service="t")
    ref = RefInc(RefConfig(obs_trace_rounds=True))
    with ref_rec.span("root"):
        ref.add_text(text)
    assert got == _round_events(ref_rec.spans())
    # an unsampled carrier pays no observed loop
    inc2 = IncrementalClassifier(ClassifierConfig(obs_trace_rounds=True),
                                 device="cpu")
    with SpanRecorder(service="t", sample_rate=0.0).span("root"):
        inc2.add_text(text)
    assert not inc2._base_engine.frontier_rounds


def test_debug_runs_endpoint_and_run_gauges(tmp_path):
    app = ServeApp(device="cpu")
    try:
        led = lg.RunLedger(str(tmp_path / "t.ledger.jsonl"), "tele-port")
        obs = lg.LedgerObserver(led, track_device_mem=False)
        try:
            obs.observer(2, 99, True)
            page = app.dispatch("GET", "/metrics", {}, b"", None)[2].decode()
            line = next(ln for ln in page.splitlines()
                        if ln.startswith("distel_run_round "))
            assert float(line.split()[-1]) == 2.0
            assert "distel_run_derivation_rate" in page
            status, _, body = app.dispatch("GET", "/debug/runs", {}, b"", None)
            runs = json.loads(body)["runs"]
            mine = [r for r in runs if r["run_id"] == "tele-port"]
            assert status == 200 and mine[0]["status"] == "running"
            status, _, body = app.dispatch(
                "GET", "/debug/runs", {"limit": "1"}, b"", None
            )
            assert len(json.loads(body)["runs"]) == 1
        finally:
            obs.close("converged")
            led.close()
        assert lg.RUN_EVENTS.gauges()["distel_run_round"] == 0.0
        assert [r["status"] for r in lg.RUN_EVENTS.runs()
                if r["run_id"] == "tele-port"] == ["converged"]
    finally:
        app.close(final_spill=False)


# -------------------------------------------------------------- config

KEYS = (
    "sparse_tail.enable = false\nsparse_tail.density_threshold = 0.2\n"
    "sparse_tail.capacity_buckets = 12\nsparse_tail.hysteresis_rounds = 3\n"
    "pipeline.enable = false\npipeline.depth = 4\n"
    "obs.trace_rounds = true\nobs.ledger.enable = true\n"
    "obs.ledger.dir = /tmp/led\nfused.rounds.k = 8\n"
    "fused.rounds.adaptive = true\n"
)
FIELDS = ("sparse_tail", "sparse_density_threshold", "sparse_capacity_buckets",
          "sparse_hysteresis_rounds", "pipeline", "pipeline_depth",
          "obs_trace_rounds", "obs_ledger", "obs_ledger_dir", "fused_rounds",
          "fused_rounds_k", "fused_rounds_adaptive")


@pytest.mark.parametrize("text", [KEYS, ""], ids=["set", "defaults"])
def test_observed_config_keys_parse_as_the_reference(tmp_path, text):
    p = tmp_path / "c.properties"
    p.write_text(text)
    got, want = ClassifierConfig.from_properties(str(p)), \
        RefConfig.from_properties(str(p))
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.sparse_tail_config() == want.sparse_tail_config()
    assert got.pipeline_config() == want.pipeline_config()
    assert got.fused_rounds_config() == want.fused_rounds_config()


#: ledger round-record keys that are host walls, clocks or readings
VOLATILE = {"ts", "run_id", "chain_run_id", "round_wall_s", "elapsed_s",
            "dispatch_s", "retire_s", "eta_s", "host_mb"}


def test_fused_rounds_k_reaches_engine_and_ledger(tmp_path):
    """``fused.rounds.k = 4`` read from a properties file reaches the
    rebuild's engine, and the ledgered CPU rebuild runs in windows of
    four: its round records (one a window) carry ``rounds_in_window`` >
    1 and equal the reference's, less walls and host readings."""
    text = chain_tailed_ontology(400, 12)
    got = {}
    for name, cfg_cls, inc_cls, kw in (
        ("port", ClassifierConfig, IncrementalClassifier, {"device": "cpu"}),
        ("ref", RefConfig, RefInc, {}),
    ):
        p = tmp_path / f"{name}.properties"
        d = tmp_path / name
        p.write_text(f"obs.ledger.enable = true\nobs.ledger.dir = {d}\n"
                     "fused.rounds.k = 4\n")
        inc = inc_cls(cfg_cls.from_properties(str(p)), **kw)
        inc.add_text(text)
        assert inc._base_engine._fused_cfg == {
            "enable": True, "rounds": 4, "adaptive": False,
        }
        (f,) = [x for x in os.listdir(d) if x.endswith(".ledger.jsonl")]
        got[name] = [
            {k: v for k, v in r.items() if k not in VOLATILE}
            for r in lg.read_ledger(str(d / f)) if r["ev"] == "round"
        ]
    assert got["port"] == got["ref"]
    assert max(r["rounds_in_window"] for r in got["port"]) > 1
    # the reference ignores K with the fused rounds off; so does the port
    p = tmp_path / "off.properties"
    p.write_text("fused.rounds.k = 4\nfused.rounds.enable = false\n")
    assert ClassifierConfig.from_properties(str(p)).fused_rounds_config() \
        is None
