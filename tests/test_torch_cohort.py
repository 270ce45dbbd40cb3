"""The port's cohort plane (``distel_tpu_torch/core/cohort.py``): N
same-bucket tenants' deltas advanced by one batched step program a vote.

The reference's ``tests/test_cohort.py``, ported: every cohort member's
packed S and R, ``derivations``, ``iterations``, history record and
taxonomy equal the solo execution (``_execute_delta_plan``) of the same
canonical plan, at sizes 2, 3 (rung 4, one pad lane), 4 and 8, with
class-only, link and mixed members converging at different depths —
tolerance 0: the data are bits.  At size 2 the cohort is also held, by
name, to the reference's own ``execute_delta_cohort`` over the same
texts (the reference's bucketed classifier: a cohort needs one).  The
dispatch tally (``COHORT_EVENTS``) is counted, not inferred: a cohort
vote is one ``record_cohort`` and moves ``solo_dispatches`` by 0, and a
solo bucketed delta moves ``solo_dispatches`` as the reference's does.
On the CPU every batched window slot runs the kernels' plain version
(``plain_packed_cols_rows_batched``); the kernels themselves run in
``tests/test_torch_cuda.py``.
"""

import threading

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core import cohort as ref_cohort
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.owl import loader as ref_loader
from distel_tpu.runtime.instrumentation import COHORT_EVENTS as REF_EVENTS
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import bucketing, cohort
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.core.program_cache import PROGRAMS
from distel_tpu_torch.owl import loader
from distel_tpu_torch.runtime.instrumentation import COHORT_EVENTS
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores
torch.set_num_threads(2)

#: the history keys a cohort member shares with its solo run (the path,
#: the program-build record and the cohort's own keys differ by design)
HISTORY_KEYS = ("increment", "batch_axioms", "iterations", "new_derivations",
                "delta_bucketed", "delta_signature")


def _mk_base(p):
    """One small per-tenant base, the same SHAPE across prefixes (one
    bucket), with chains so CR3/CR4/CR6 structure exists."""
    return (
        f"SubClassOf({p}A {p}B)\nSubClassOf({p}B {p}C)\n"
        f"SubClassOf({p}C ObjectSomeValuesFrom(r {p}D))\n"
        f"SubClassOf(ObjectSomeValuesFrom(r {p}D) {p}E)\n"
        f"SubClassOf({p}E {p}F)\n"
        f"SubObjectPropertyOf(ObjectPropertyChain(r r) r)\n"
    )


def _mk_delta(p, kind, depth=1):
    """Deltas by kind; ``depth`` sets how many rounds a member needs, so
    cohort members converge apart."""
    if kind == "class":
        lines = [f"SubClassOf({p}N0 {p}A)"] + [
            f"SubClassOf({p}N{i} {p}N{i - 1})" for i in range(1, depth)
        ]
        return "\n".join(lines) + "\n"
    if kind == "link":
        return f"SubClassOf({p}L ObjectSomeValuesFrom(r {p}B))\n"
    if kind == "mixed":
        return (_mk_delta(p, "class", depth)
                + f"SubClassOf({p}ML ObjectSomeValuesFrom(r {p}C))\n")
    raise ValueError(kind)


def _tenants(n):
    """(prefix, kind, depth) per tenant: kinds cycle, depths 1/3/5."""
    kinds = ["class", "link", "mixed"]
    return [(f"T{i}", kinds[i % 3], 1 + (i % 3) * 2) for i in range(n)]


def _inc(text, **cfg):
    inc = IncrementalClassifier(
        ClassifierConfig(fast_path_min_concepts=0, **cfg), device="cpu"
    )
    inc.add_text(text)
    return inc


def _member(p, kind, depth=1, **cfg):
    """A tenant's classifier with its delta ingested and planned in the
    canonical cohort shape (not executed)."""
    inc = _inc(_mk_base(p), **cfg)
    idx, batch = inc._ingest(loader.load(_mk_delta(p, kind, depth)))
    plan = inc._delta_fast_plan(idx, cohort_shape=True)
    assert plan is not None and cohort.delta_cohort_ready(inc, plan)
    return inc, plan, batch


def _tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


@pytest.fixture(scope="module")
def solo():
    """Each of 8 tenants' canonical plan executed solo."""
    out = {}
    for p, kind, depth in _tenants(8):
        inc, plan, batch = _member(p, kind, depth)
        res = inc._execute_delta_plan(plan)
        inc._finish_increment(batch, res, "fast")
        out[p] = (res, dict(inc.history[-1]), _tax_key(extract_taxonomy(res)))
    return out


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("size", [2, 3, 4, 8])
def test_cohort_parity_vs_solo(solo, size):
    """Every member equals its solo execution: S, R, derivations,
    iterations, history record and taxonomy, byte for byte; one roster
    key over mixed kinds; one cohort dispatch a vote, none solo."""
    spec = _tenants(size)
    members = [_member(p, kind, depth) for p, kind, depth in spec]
    assert len({plan.roster_key() for _i, plan, _b in members}) == 1
    before = COHORT_EVENTS.snapshot()
    results = cohort.execute_delta_cohort(members)
    after = COHORT_EVENTS.snapshot()
    votes = after["cohort_dispatches"] - before["cohort_dispatches"]
    assert votes >= len(members[0][1].engines)
    assert after["solo_dispatches"] == before["solo_dispatches"]
    assert (after["cohort_tenant_votes"] - before["cohort_tenant_votes"]
            <= votes * size)
    assert after["cohort_deltas"] - before["cohort_deltas"] == size
    iters = set()
    for (p, _kind, _depth), r, (inc, _plan, _b) in zip(spec, results, members):
        want, rec, tax = solo[p]
        assert torch.equal(r.packed_s, want.packed_s), f"{size}, {p}: S"
        assert torch.equal(r.packed_r, want.packed_r), f"{size}, {p}: R"
        assert r.derivations == want.derivations
        assert r.iterations == want.iterations
        got = inc.history[-1]
        assert {k: got.get(k) for k in HISTORY_KEYS} == \
            {k: rec.get(k) for k in HISTORY_KEYS}
        assert got["path"] == "cohort"
        assert (got["cohort_size"], got["cohort_rung"],
                got["cohort_dispatches"]) == (size, cohort.cohort_rung(size),
                                              votes)
        assert _tax_key(extract_taxonomy(r)) == tax
        assert (inc.last_cohort["votes"], inc.last_cohort["rung"],
                len(inc.last_cohort["vote_walls_s"])) == \
            (votes, cohort.cohort_rung(size), votes)
        iters.add(r.iterations)
    if size >= 3:  # a depth-5 mixed member joins from size 3
        assert len(iters) > 1, "members should converge at different depths"


def test_cohort_equals_the_reference_cohort():
    """Two tenants (class-only, deep; link) through the port's cohort and
    the reference's ``execute_delta_cohort`` (bucketed): closures by
    name, derivations and iterations equal."""
    spec = [("Xa", "class", 3), ("Xb", "link", 1)]
    ref_members = []
    for p, kind, depth in spec:
        inc = RefInc(RefConfig(fast_path_min_concepts=0))
        inc.add_text(_mk_base(p))
        idx, batch = inc._ingest(ref_loader.load(_mk_delta(p, kind, depth)))
        plan = inc._delta_fast_plan(idx, cohort_shape=True)
        assert ref_cohort.delta_cohort_ready(inc, plan)
        ref_members.append((inc, plan, batch))
    ref_before = REF_EVENTS.snapshot()
    ref_results = ref_cohort.execute_delta_cohort(ref_members)
    ref_votes = (REF_EVENTS.snapshot()["cohort_dispatches"]
                 - ref_before["cohort_dispatches"])
    members = [_member(p, kind, depth) for p, kind, depth in spec]
    before = COHORT_EVENTS.snapshot()
    results = cohort.execute_delta_cohort(members)
    votes = (COHORT_EVENTS.snapshot()["cohort_dispatches"]
             - before["cohort_dispatches"])
    assert votes == ref_votes
    for want, got in zip(ref_results, results):
        ri, pi = want.idx, got.idx
        assert ri.concept_names == pi.concept_names
        n, nl = ri.n_concepts, ri.n_links
        assert np.array_equal(np.asarray(want.s)[:n, :n], got.s[:n, :n])
        assert np.array_equal(np.asarray(want.r)[:n, :nl], got.r[:n, :nl])
        assert got.derivations == want.derivations
        assert got.iterations == want.iterations


def test_dispatch_tally_counts_like_the_reference():
    """The solo half of the tally: one solo bucketed delta moves
    ``solo_dispatches`` by the same amount in both packages (one a
    vote), and no cohort counter."""
    ref = RefInc(RefConfig(fast_path_min_concepts=0))
    ref.add_text(_mk_base("Da"))
    port = _inc(_mk_base("Da"))
    for inc, events, load in ((ref, REF_EVENTS, ref_loader.load),
                              (port, COHORT_EVENTS, loader.load)):
        before = events.snapshot()
        inc.add_ontology(load(_mk_delta("Da", "mixed", 2)))
        after = events.snapshot()
        assert inc.history[-1]["path"] == "fast"
        inc._moved = {k: after[k] - before[k] for k in after
                      if k not in ("last_size", "last_rung")}
    assert port._moved == ref._moved
    assert port._moved["solo_dispatches"] >= 3
    assert port._moved["cohort_dispatches"] == 0


def test_second_same_shape_cohort_is_compile_free():
    """The second cohort of the same shape is all registry hits —
    ``compile_s`` 0.0 — and still one dispatch a vote, none solo."""
    incs = [_inc(_mk_base(p)) for p in ("Sa", "Sb")]

    def run(round_no):
        members = []
        for inc, p in zip(incs, ("Sa", "Sb")):
            idx, batch = inc._ingest(
                loader.load(f"SubClassOf({p}R{round_no} {p}A)\n"))
            members.append((inc, inc._delta_fast_plan(idx, cohort_shape=True),
                            batch))
        cohort.execute_delta_cohort(members)
        return [inc.last_compile for inc in incs]

    run(0)
    before = COHORT_EVENTS.snapshot()
    stats = run(1)
    after = COHORT_EVENTS.snapshot()
    for st in stats:
        assert st.program_cache_hit is True
        assert st.compile_s == 0.0
        assert st.trace_lower_s == 0.0
    for inc in incs:
        rec = inc.history[-1]
        assert rec["path"] == "cohort"
        assert rec["delta_program_hits"] == rec["delta_programs"]
    assert after["solo_dispatches"] == before["solo_dispatches"]
    assert after["cohort_dispatches"] > before["cohort_dispatches"]


def test_warmup_covers_first_cohort():
    """``cohort.warm.sizes``: after ``warm_delta_programs`` even the
    FIRST cohort builds nothing."""
    from distel_tpu_torch.core.incremental import warm_delta_programs

    cfg = ClassifierConfig(fast_path_min_concepts=0, cohort_warm_sizes="2")
    warm = _inc(_mk_base("Wm"), cohort_warm_sizes="2")
    recs = warm_delta_programs(cfg, warm._base_engine, warm._base_idx)
    assert {r["program"] for r in recs if r["program"].startswith("cohort[")} \
        == {"cohort[delta[mixed]x2]", "cohort[crossx2]", "cohort[basex2]"}
    members = [_member(p, "link") for p in ("Wx", "Wy")]
    cohort.execute_delta_cohort(members)
    st = members[0][0].last_compile
    assert st.program_cache_hit is True, st.as_dict()
    assert st.compile_s == 0.0, st.as_dict()


def test_cohort_programs_are_counted_and_dropped():
    """A cohort program and its stacked state pair count in
    ``program_bytes``; no engine holds it, so ``drop_idle_programs``
    frees it between cohorts."""
    PROGRAMS.clear()
    members = [_member(p, kind) for p, kind in (("Ma", "class"), ("Mb", "link"))]
    cohort.execute_delta_cohort(members)
    progs = [p for p in PROGRAMS._programs.values()
             if isinstance(p, cohort.CohortProgram)]
    assert progs and all(p.rung == 2 for p in progs)
    pair = progs[0].pair
    assert tuple(pair.sp.shape[:1]) == (2,)
    own = sum(p.nbytes for p in progs)
    total = bucketing.program_bytes("cpu")
    assert total >= own + pair.nbytes
    dropped = bucketing.drop_idle_programs("cpu")
    assert dropped >= len(progs)
    assert not any(isinstance(p, cohort.CohortProgram)
                   for p in PROGRAMS._programs.values())
    assert bucketing.program_bytes("cpu") <= total - own - pair.nbytes


# ------------------------------------------------- registry cohort path


def test_registry_delta_cohort_matches_solo_and_counts():
    """``delta_cohort`` advances both members under one roster, answers
    as solo deltas do, and moves the cohort counters; a member whose
    text fails to parse fails alone, and the survivor takes the solo
    fallback."""
    from distel_tpu_torch.serve.metrics import Metrics
    from distel_tpu_torch.serve.registry import OntologyRegistry

    metrics = Metrics()
    reg = OntologyRegistry(ClassifierConfig(), device="cpu", metrics=metrics,
                           fast_path_min_concepts=0)
    oa, ob = reg.new_id(), reg.new_id()
    reg.load(oa, _mk_base("Ra"))
    reg.load(ob, _mk_base("Rb"))
    assert reg.cohort_key(oa) == reg.cohort_key(ob) is not None
    out = reg.delta_cohort([(oa, [_mk_delta("Ra", "class", 2)]),
                            (ob, [_mk_delta("Rb", "link")])])
    assert out[oa]["path"] == "cohort", out[oa]
    assert out[ob]["path"] == "cohort", out[ob]
    assert out[oa]["cohort_size"] == 2
    assert metrics.counter_value("distel_cohort_formed_total") == 1
    assert metrics.counter_value("distel_cohort_deltas_total") == 2
    solo = _inc(_mk_base("Ra"))
    solo.add_ontology(loader.load(_mk_delta("Ra", "class", 2)))
    assert (extract_taxonomy(solo.last_result).parents
            == extract_taxonomy(reg.classifier(oa).last_result).parents)
    out = reg.delta_cohort([(oa, ["SubClassOf(RaOk RaA)"]),
                            (ob, ["NotAnAxiom((("])])
    assert isinstance(out[ob], BaseException), out[ob]
    assert not isinstance(out[oa], BaseException)
    assert out[oa]["id"] == oa
    assert metrics.counter_value("distel_cohort_fallback_total") >= 1


# ----------------------------------------------- scheduler formation


class _StubScheduler:
    """RequestScheduler with stub executors — formation logic only."""

    def __init__(self, sig_of, max_size=4, wait_s=0.2, workers=2):
        from distel_tpu_torch.serve.scheduler import RequestScheduler

        self.calls = []
        self.cohort_calls = []
        self._lock = threading.Lock()

        def execute(key, kind, payloads):
            with self._lock:
                self.calls.append((key, kind, list(payloads)))
            return {"key": key, "solo": True}

        def execute_cohort(members):
            with self._lock:
                self.cohort_calls.append([(k, list(p)) for k, p in members])
            return {k: {"key": k, "cohort": len(members)} for k, _p in members}

        self.sched = RequestScheduler(
            execute, workers=workers, cohort_key=sig_of,
            execute_cohort=execute_cohort, cohort_max_size=max_size,
            cohort_max_wait_s=wait_s,
        )


def test_scheduler_forms_cohort_across_lanes():
    stub = _StubScheduler(lambda key: "sigX", max_size=4)
    try:
        reqs = [stub.sched.submit(f"k{i}", "delta", f"p{i}", batchable=True)
                for i in range(3)]
        outs = [r.wait(10) for r in reqs]
        assert all(o["cohort"] == 3 for o in outs), outs
        assert len(stub.cohort_calls) == 1
        assert sorted(k for k, _p in stub.cohort_calls[0]) == ["k0", "k1", "k2"]
        assert stub.calls == []
    finally:
        stub.sched.close()


def test_scheduler_cohort_respects_max_size_and_signature():
    sigs = {"a": "s1", "b": "s1", "c": "s2", "d": "s1"}
    stub = _StubScheduler(sigs.get, max_size=2, wait_s=0.3)
    try:
        reqs = {k: stub.sched.submit(k, "delta", k, batchable=True)
                for k in ("a", "b", "c", "d")}
        outs = {k: r.wait(10) for k, r in reqs.items()}
        assert outs["c"] == {"key": "c", "solo": True}
        assert all(len(call) <= 2 for call in stub.cohort_calls)
        assert sum(1 for k in ("a", "b", "d")
                   if outs[k].get("cohort", 0) >= 2) >= 2, outs
    finally:
        stub.sched.close()


def test_scheduler_cohort_disabled_runs_inline():
    stub = _StubScheduler(lambda key: None)
    try:
        reqs = [stub.sched.submit(f"k{i}", "delta", f"p{i}", batchable=True)
                for i in range(3)]
        for r in reqs:
            assert r.wait(10)["solo"] is True
        assert stub.cohort_calls == []
    finally:
        stub.sched.close()


def test_scheduler_cohort_preserves_lane_serialization():
    """Two queued deltas on ONE lane coalesce into that member's batch
    (admission order kept); a cohort spans lanes."""
    stub = _StubScheduler(lambda key: "sig", max_size=4, wait_s=0.3)
    try:
        r1 = stub.sched.submit("a", "delta", "a1", batchable=True)
        r2 = stub.sched.submit("a", "delta", "a2", batchable=True)
        r3 = stub.sched.submit("b", "delta", "b1", batchable=True)
        for r in (r1, r2, r3):
            r.wait(10)
        by_key = dict(m for call in stub.cohort_calls for m in call)
        if "a" in by_key:
            assert by_key["a"] == ["a1", "a2"]
    finally:
        stub.sched.close()


# ------------------------------------------------------- satellites


def test_warmup_roster_drift_zero_builds_after_warmup():
    """``warm_delta_programs`` mirrors the fast path's rule selection:
    after a serve warmup of one sample corpus, each canonical delta kind
    through a fresh classifier builds no step program."""
    from distel_tpu_torch.runtime.warmup import warmup_text

    cfg = ClassifierConfig(fast_path_min_concepts=0)
    PROGRAMS.clear()
    rec = warmup_text(_mk_base("Wd"), cfg, profile="serve", device="cpu")
    assert rec["delta_programs"] > 0
    keys_before = set(PROGRAMS._programs)
    for kind in ("class", "link", "mixed"):
        p = f"Wd{kind[:2].capitalize()}"
        inc = _inc(_mk_base(p))
        inc.add_ontology(loader.load(_mk_delta(p, kind)))
        assert inc.history[-1]["path"] == "fast"
        assert inc.last_compile.program_cache_hit is True, (
            kind, inc.last_compile.as_dict())
        assert inc.last_compile.compile_s == 0.0, kind
    built = [k for k in set(PROGRAMS._programs) - keys_before
             if isinstance(k, tuple) and len(k) >= 2
             and k[1] in ("step", "cohort_run")]
    assert built == [], built


def test_noop_commit_reuses_published_snapshot():
    """An increment that derives nothing new does not rebuild the read
    snapshot; a deriving commit publishes a new one."""
    from distel_tpu_torch.serve.metrics import Metrics
    from distel_tpu_torch.serve.query import SnapshotStore
    from distel_tpu_torch.serve.registry import OntologyRegistry

    metrics = Metrics()
    reg = OntologyRegistry(ClassifierConfig(), device="cpu", metrics=metrics,
                           fast_path_min_concepts=0, query=SnapshotStore())
    oid = reg.new_id()
    reg.load(oid, _mk_base("Np"))
    snap1 = reg.query.get(oid)
    rec = reg.delta(oid, ["SubClassOf(NpNew NpA)"])
    snap2 = reg.query.get(oid)
    assert snap2 is not snap1
    assert rec["version"] == snap2.version > snap1.version
    rec = reg.delta(oid, ["SubClassOf(NpA NpB)"])
    assert rec["new_derivations"] == 0
    assert reg.query.get(oid) is snap2
    assert rec["version"] == snap2.version
    assert metrics.counter_value("distel_query_republish_skipped_total") == 1
    rec = reg.delta(oid, ["SubClassOf(NpNew2 NpNew)"])
    snap4 = reg.query.get(oid)
    assert snap4 is not snap2 and snap4.version > snap2.version
    assert rec["version"] == snap4.version


def test_families_past_the_floor_rung_take_their_own_keys():
    """The reference's canonical rule: an absent family rides ONE inert
    replay row, so class-only, link and mixed deltas share a roster key
    while each family stays within the seg-OR ladder's floor rung (8
    rows a level) — and their cohort equals each plan's solo run —
    while 10 rows a family put the three kinds on three keys."""
    base = "\n".join(
        [f"SubClassOf(K{i} K{i + 1})" for i in range(24)]
        + [f"SubClassOf(K{i} ObjectSomeValuesFrom(r K{i + 1}))"
           for i in range(24)]
        + ["SubObjectPropertyOf(ObjectPropertyChain(r r) r)"])

    def deltas(rows):
        out = {
            "class": "\n".join(f"SubClassOf(Nc{i} K{i})" for i in range(rows)),
            "link": "\n".join(f"SubClassOf(K{i + 2} ObjectSomeValuesFrom(r K{i}))"
                              for i in range(rows)),
        }
        out["both"] = out["class"] + "\n" + out["link"]
        return out

    def member(text):
        inc = _inc(base)
        idx, batch = inc._ingest(loader.load(text))
        return inc, inc._delta_fast_plan(idx, cohort_shape=True), batch

    past = [member(t) for t in deltas(10).values()]
    assert len({plan.roster_key() for _i, plan, _b in past}) == 3
    members = [member(t) for t in deltas(8).values()]
    assert len({plan.roster_key() for _i, plan, _b in members}) == 1
    twins = [member(t) for t in deltas(8).values()]
    results = cohort.execute_delta_cohort(members)
    for (inc, plan, _batch), got in zip(twins, results):
        want = inc._execute_delta_plan(plan)
        assert torch.equal(got.packed_s, want.packed_s)
        assert torch.equal(got.packed_r, want.packed_r)
        assert got.derivations == want.derivations
        assert got.iterations == want.iterations


# ------------------------------------------------ memory and failure


def test_cohort_that_does_not_fit_moves_no_state(solo):
    """A cohort whose copied-out closures pass the spare bytes raises
    ``CohortDoesNotFit`` before any state moves: each member keeps its
    closure, and its plan then runs solo to the solo answer."""
    members = [_member(p, kind, depth) for p, kind, depth in _tenants(2)]
    held = [inc._state for inc, _p, _b in members]
    before = COHORT_EVENTS.snapshot()
    with pytest.raises(cohort.CohortDoesNotFit):
        cohort.execute_delta_cohort(members, spare_bytes=lambda: 0)
    assert COHORT_EVENTS.snapshot()["cohort_dispatches"] == \
        before["cohort_dispatches"]
    for (inc, plan, _b), state, (p, _k, _d) in zip(members, held, _tenants(2)):
        assert inc._state is state
        res = inc._execute_delta_plan(plan)
        assert torch.equal(res.packed_s, solo[p][0].packed_s)
        assert torch.equal(res.packed_r, solo[p][0].packed_r)


def test_failed_cohort_keeps_each_members_closure(monkeypatch):
    """A vote that fails replaces no member's closure: each keeps its
    pre-delta state with the delta's axioms ingested, and its next
    increment's fast path derives both deltas to the closure of a
    tenant that ran them one by one."""
    members = [_member(p, kind, 3) for p, kind in (("F0", "class"),
                                                  ("F1", "mixed"))]
    held = [inc._state for inc, _p, _b in members]

    def broken(prog, live, budget):
        raise RuntimeError("vote failed")

    monkeypatch.setattr(cohort, "_run_vote", broken)
    with pytest.raises(RuntimeError, match="vote failed"):
        cohort.execute_delta_cohort(members)
    monkeypatch.undo()
    for (inc, _plan, _b), state, (p, kind) in zip(
            members, held, (("F0", "class"), ("F1", "mixed"))):
        assert inc._state is state
        inc.add_text(f"SubClassOf({p}Next {p}N2)")
        assert inc.history[-1]["path"] == "fast"
        ref = _inc(_mk_base(p))
        ref.add_text(_mk_delta(p, kind, 3))
        ref.add_text(f"SubClassOf({p}Next {p}N2)")
        assert torch.equal(inc.last_result.packed_s, ref.last_result.packed_s)
        assert torch.equal(inc.last_result.packed_r, ref.last_result.packed_r)
        assert (_tax_key(extract_taxonomy(inc.last_result))
                == _tax_key(extract_taxonomy(ref.last_result)))


def test_registry_splits_a_cohort_that_does_not_fit(monkeypatch):
    """With room for the closures of 2.5 lanes, a group of four splits
    into two cohorts of two (rung 2), each member answering as its solo
    delta would."""
    from distel_tpu_torch.serve.metrics import Metrics
    from distel_tpu_torch.serve.registry import OntologyRegistry

    metrics = Metrics()
    reg = OntologyRegistry(ClassifierConfig(), device="cpu", metrics=metrics,
                           fast_path_min_concepts=0)
    spec = _tenants(4)
    oids = {}
    for p, _kind, _depth in spec:
        oids[p] = reg.new_id()
        reg.load(oids[p], _mk_base(p))
    lane = sum(t.numel() * t.element_size()
               for t in reg.classifier(oids["T0"])._state)
    monkeypatch.setattr(cohort, "free_bytes", lambda device: int(2.5 * lane))
    out = reg.delta_cohort([(oids[p], [_mk_delta(p, kind, depth)])
                            for p, kind, depth in spec])
    assert metrics.counter_value("distel_cohort_formed_total") == 2
    assert metrics.counter_value("distel_cohort_fallback_total") == 0
    for p, kind, depth in spec:
        rec = out[oids[p]]
        assert rec["path"] == "cohort" and rec["cohort_size"] == 2, rec
        ref = _inc(_mk_base(p))
        ref.add_text(_mk_delta(p, kind, depth))
        assert (_tax_key(extract_taxonomy(reg.classifier(oids[p]).last_result))
                == _tax_key(extract_taxonomy(ref.last_result)))
