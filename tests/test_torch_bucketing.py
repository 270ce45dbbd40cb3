"""Shape buckets: the port's bucketed engines against the reference's.

The reference's ``tests/test_bucketing.py`` and
``tests/test_delta_bucketing.py`` on both packages, at the size those
tests run.  Both packages' row-packed engines run with ``bucket=True``
(the reference's default through ``shape_buckets``) on the same
``IndexedOntology``, the port on its plain versions on the CPU, and are
held, tolerance 0, to each other: the layout ``(nc, nl)``, S and R over
the real rows, derivations, iterations and the taxonomy; the dead rows
(the last concept and link row, which the quantized plans' pads aim at)
hold no bit in a live column after saturation.  The port's bucketed run
is also held round for round to its exact-mode run (gate counts
included), since its plan is the exact-mode plan with the gates on the
device.  Program sharing is the port's own registry,
``core/program_cache.PROGRAMS`` (a pinned copy): a second engine of one
bucket is a counted hit that builds nothing.  The reference's
persistent-cache test has no counterpart (there is no disk cache of
graphs); in its place, a cleared registry rebuilds and counts a miss.
The observed and fused runs and the snapshot round trips close the
file.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core import program_cache as ref_program_cache
from distel_tpu.core.incremental import IncrementalClassifier as RefIncremental
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu.ops.bitpack import SegmentedRowOr as RefSegOr
from distel_tpu.owl import parser
from distel_tpu.runtime import checkpoint as ref_checkpoint
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import program_cache
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.core.packed_engine import PackedSaturationEngine
from distel_tpu_torch.core.program_cache import PROGRAMS, bucket_dim
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.ops.bitpack import SegmentedRowOr
from distel_tpu_torch.runtime import checkpoint
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from test_bucketing import _same_bucket_pair
from test_delta_bucketing import _DELTAS, _mk_base
from test_packed_engine import BOTTOM_ONTO
from test_rowpacked_engine import _REBIND_BASE
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)
sys.setrecursionlimit(10_000)


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _port(idx, **kw):
    return RowPackedSaturationEngine(idx, device="cpu", **kw)


def _wire(res):
    if isinstance(res.packed_s, torch.Tensor):
        return res.wire()
    return (np.asarray(res.packed_s).astype(np.uint32),
            np.asarray(res.packed_r).astype(np.uint32))


def _tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def _assert_real_rows_equal(idx, got, want, derivations=True):
    (gs, gr), (ws, wr) = _wire(got), _wire(want)
    nw = min(gs.shape[1], ws.shape[1])
    assert np.array_equal(gs[: idx.n_concepts, :nw], ws[: idx.n_concepts, :nw])
    assert np.array_equal(gr[: idx.n_links, :nw], wr[: idx.n_links, :nw])
    if derivations:
        assert got.derivations == want.derivations


def _assert_dead_rows_clean(engine, res):
    s, r = _wire(res)
    live = engine._wmask_np
    assert not (s[engine._dead_c] & live).any()
    assert not r[engine._dead_l].any()


# ------------------------------------------------------- closure parity


@pytest.mark.parametrize(
    "text,diff_oracle",
    [(BOTTOM_ONTO, True), (snomed_shaped_ontology(n_classes=600), False)],
    ids=["bottom", "snomed-shaped"],
)
def test_bucketed_closure_matches_exact(text, diff_oracle):
    norm = normalize(parser.parse(text))
    idx = index_ontology(norm)
    ref = RefEngine(idx, bucket=True)
    want = ref.saturate()
    eng = _port(idx, bucket=True)
    got = eng.saturate()
    exact = _port(idx)
    ex = exact.saturate()
    assert (eng.nc, eng.nl, eng.unroll) == (ref.nc, ref.nl, ref.unroll)
    assert got.iterations == want.iterations == ex.iterations
    _assert_real_rows_equal(idx, got, want)
    _assert_real_rows_equal(idx, got, ex)
    assert eng.gate_rounds == exact.gate_rounds
    assert _tax_key(extract_taxonomy(got)) == _tax_key(ref_taxonomy(want))
    _assert_dead_rows_clean(eng, got)
    if diff_oracle:
        from distel_tpu_torch.frontend.normalizer import normalize as port_norm
        from distel_tpu_torch.owl import parser as port_parser
        from distel_tpu_torch.testing.differential import diff_engine_vs_oracle

        report = diff_engine_vs_oracle(port_norm(port_parser.parse(text)), got)
        assert report.ok(), report.summary()


def test_bucketed_resume_from_snapshot_state():
    idx = _index(BOTTOM_ONTO)
    first = _port(idx, bucket=True).saturate()
    resumed = _port(idx, bucket=True).saturate(
        initial=(first.packed_s, first.packed_r)
    )
    assert resumed.derivations == 0
    _assert_real_rows_equal(idx, resumed, first, derivations=False)




# ------------------------------------------- cross-ontology program reuse


def test_same_bucket_different_ontology_shares_program():
    """The reference's same-bucket pair: both packages put the two
    ontologies in one bucket, and the port's second engine is a registry
    hit that builds nothing yet computes its own closure."""
    ta, tb = _same_bucket_pair()
    ia, ib = _index(ta), _index(tb)
    ra, rb = RefEngine(ia, bucket=True), RefEngine(ib, bucket=True)
    assert ra.bucket_signature == rb.bucket_signature
    PROGRAMS.clear()
    ea, eb = _port(ia, bucket=True), _port(ib, bucket=True)
    assert ea.bucket_signature == eb.bucket_signature
    res_a = ea.saturate()
    assert not ea.compile_stats.program_cache_hit
    assert ea.compile_stats.trace_lower_s > 0.0
    res_b = eb.saturate()
    st = eb.compile_stats
    assert st.program_cache_hit and st.compile_s == 0.0 == st.trace_lower_s
    assert PROGRAMS.stats()["hits"] == 1 and PROGRAMS.stats()["misses"] == 1
    for idx, ref, res in ((ia, ra, res_a), (ib, rb, res_b)):
        want = ref.saturate()
        assert res.iterations == want.iterations
        _assert_real_rows_equal(idx, res, want)


def test_cleared_registry_rebuilds_and_counts_a_miss():
    """No disk cache of graphs: after ``PROGRAMS.clear()`` a same-bucket
    engine builds its program again (a counted miss) and gives the same
    closure."""
    ta, tb = _same_bucket_pair()
    ia, ib = _index(ta), _index(tb)
    PROGRAMS.clear()
    _port(ia, bucket=True).precompile(programs=("run",))
    PROGRAMS.clear()
    eb = _port(ib, bucket=True)
    got = eb.saturate()
    assert not eb.compile_stats.program_cache_hit
    assert PROGRAMS.stats() == {"programs": 1, "capacity": PROGRAMS.capacity,
                                "hits": 0, "misses": 1, "evictions": 0}
    assert eb.compile_stats.persistent_cache_hits == 0
    _assert_real_rows_equal(ib, got, _port(ib).saturate())


def test_evicted_program_is_looked_up_again():
    """An engine holds its program weakly: once the registry drops it,
    the next run builds it again instead of keeping it alive."""
    idx = _index(_same_bucket_pair()[0])
    PROGRAMS.clear()
    eng = _port(idx, bucket=True)
    first = eng.saturate()
    PROGRAMS.clear()
    assert eng._prog_ref() is None
    again = eng.saturate()
    assert PROGRAMS.stats()["misses"] == 1
    _assert_real_rows_equal(idx, again, first)


def test_memory_budget_drops_idle_programs_before_tenants(tmp_path):
    """The serve registry's memory budget counts the programs' bytes on
    its device.  Over the budget, a program no live engine uses goes
    before any tenant; a tenant's eviction leaves its program idle, and
    the same pass drops it."""
    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.serve.query import SnapshotStore
    from distel_tpu_torch.serve.registry import OntologyRegistry

    PROGRAMS.clear()
    reg = OntologyRegistry(ClassifierConfig(), device="cpu",
                           memory_budget_bytes=1 << 40, spill_dir=str(tmp_path),
                           fast_path_min_concepts=0, query=SnapshotStore())
    a, b = reg.new_id(), reg.new_id()
    reg.load(a, _same_bucket_pair()[0])
    reg.load(b, snomed_shaped_ontology(n_classes=300, seed=5))
    sig = {o: reg._entries[o].inc._base_engine.bucket_signature for o in (a, b)}
    assert sig[a] != sig[b]
    warmed = _port(_index(snomed_shaped_ontology(n_classes=600, seed=9)),
                   bucket=True)
    warmed.precompile(programs=("run",))
    idle_sig = warmed.bucket_signature
    del warmed

    def held():
        return {k[0] for k in PROGRAMS._programs}

    assert held() == {sig[a], sig[b], idle_sig}
    total = reg.resident_bytes() + bucketing.program_bytes("cpu")
    reg.memory_budget_bytes = total - 1
    reg._maybe_evict()
    assert reg.tier_stats()["resident_ontologies"] == 2
    assert held() == {sig[a], sig[b]}
    assert PROGRAMS.stats()["evictions"] == 1
    assert reg.resident_bytes() + bucketing.program_bytes("cpu") < total

    reg.memory_budget_bytes = 1
    reg._maybe_evict(keep=b)
    assert reg._entries[a].inc is None and reg._entries[b].inc is not None
    assert held() == {sig[b]}
    assert PROGRAMS.stats()["evictions"] == 2


# ------------------------------------------------ plan canonicalization


def test_quantized_segor_matches_reference():
    rng = np.random.default_rng(3)
    qn = lambda n: bucket_dim(n, 2.0, floor=8)  # noqa: E731
    for trial in range(20):
        n_state = int(rng.integers(4, 30))
        k = int(rng.integers(1, 80))
        targets = rng.integers(0, n_state - 1, size=k)
        plan = SegmentedRowOr.quantized(targets, qn, n_state - 1, k)
        want = RefSegOr.quantized(targets, qn, n_state - 1, k)
        assert np.array_equal(plan.order, want.order)
        assert np.array_equal(plan.targets, want.targets)
        assert plan.structure() == want.structure()
        rows = rng.integers(0, 2**32, size=(k, 3), dtype=np.uint32)
        state = rng.integers(0, 2**32, size=(n_state, 3), dtype=np.uint32)
        # pad slot k gathers the dead row itself: a self-loop
        srcs = np.vstack([rows, state[n_state - 1 : n_state]])
        st = torch.from_numpy(state.view(np.int32).copy())
        red = plan.reduce(torch.from_numpy(srcs.view(np.int32))[plan.order])
        plan.write(st, red)
        expect = state.copy()
        for t, row in zip(targets, rows):
            expect[t] |= row
        assert (st.numpy().view(np.uint32) == expect).all(), trial


def test_quantized_segor_structure_collides_across_wirings():
    qn = lambda n: bucket_dim(n, 2.0, floor=8)  # noqa: E731
    a = np.repeat(np.arange(40), 2)
    b = np.repeat(np.arange(100, 140)[::-1], 2)
    pa = SegmentedRowOr.quantized(a, qn, 999, len(a))
    pb = SegmentedRowOr.quantized(b, qn, 999, len(b))
    assert pa.structure() == pb.structure()
    assert pa.structure() == RefSegOr.quantized(a, qn, 999, len(a)).structure()


def test_bucket_dim_is_the_pinned_ladder():
    """The port's ``bucket_dim`` is the reference's (the module is a
    pinned copy), and the sparse tier's capacity rungs — the ratio-2
    family, floor 64 — are the power-of-two rungs they were."""
    for ratio in (1.25, 1.5, 2.0):
        for floor in (1, 8, 32):
            for n in list(range(0, 300)) + [1000, 4097, 88_526, 10**6]:
                assert bucket_dim(n, ratio, floor) == \
                    ref_program_cache.bucket_dim(n, ratio, floor)
    with pytest.raises(ValueError, match="ratio must be > 1"):
        bucket_dim(5, 1.0)
    cfg = RowPackedSaturationEngine._normalize_sparse_cfg(True)
    for n in (0, 1, 64, 65, 1000, 8192, 8193):
        rung = 64
        while rung < max(n, 1):
            rung *= 2
        got = RowPackedSaturationEngine._sparse_rung(cfg, n, 64)
        assert got == (rung if rung <= 64 << 7 else None)
    assert program_cache.signature_of((1, 2), "b") == \
        ref_program_cache.signature_of((1, 2), "b")


def test_bucketed_rebind_role_closure_matches_fresh():
    """A grown closure reaches the shared program as table content: the
    rebind keeps the signature, and the resumed run equals a fresh one
    (and the reference's fresh bucketed run)."""
    idx_old = _index(_REBIND_BASE)
    idx_new = _index(_REBIND_BASE + "SubObjectPropertyOf(r s)\n")
    kw = dict(bucket=True, window_headroom=2)
    fresh = _port(idx_new, **kw).saturate()
    eng = _port(idx_old, **kw)
    before = eng.saturate()
    sig0 = eng.bucket_signature
    assert eng.rebind_role_closure(idx_new.role_closure)
    assert eng.bucket_signature == sig0
    resumed = eng.saturate(initial=(before.packed_s, before.packed_r))
    assert all(np.array_equal(a, b) for a, b in zip(_wire(resumed), _wire(fresh)))
    _assert_real_rows_equal(idx_new, fresh, RefEngine(idx_new, **kw).saturate())


# ------------------------------------------------- bucketed delta plane


def _fast(pkg_cls, cfg_cls, **kw):
    cfg = cfg_cls(fast_path_min_concepts=0, use_native_loader=False, **kw)
    if pkg_cls is IncrementalClassifier:
        return pkg_cls(cfg, device="cpu")
    return pkg_cls(cfg)


def _sub_map(res, idx):
    return {
        idx.concept_names[x]: {
            idx.concept_names[i] for i in res.subsumers(x) if i < idx.n_concepts
        }
        for x in range(idx.n_concepts)
    }


def _inc_map(inc):
    r = inc.last_result
    return _sub_map(r, r.idx)


_DELTA_KEYS = ("path", "delta_bucketed", "delta_programs")


@pytest.mark.parametrize("kind", sorted(_DELTAS))
def test_bucketed_delta_matches_reference(kind):
    base, delta = _mk_base(), _DELTAS[kind]
    port = _fast(IncrementalClassifier, ClassifierConfig)
    ref = _fast(RefIncremental, RefConfig)
    for inc in (port, ref):
        inc.add_text(base)
    base_engine = port._base_engine
    for inc in (port, ref):
        inc.add_text(delta)
    got, want = port.history[-1], ref.history[-1]
    assert got["path"] == "fast" and got["delta_bucketed"] is True, got
    assert port._base_engine is base_engine
    assert {k: got[k] for k in _DELTA_KEYS} == {k: want[k] for k in _DELTA_KEYS}
    batch = _index(base + delta)
    assert _inc_map(port) == _inc_map(ref) == _sub_map(
        _port(batch).saturate(), batch
    )


def test_bucketed_vs_exact_delta_same_closure(monkeypatch):
    base = _mk_base()
    delta = _DELTAS["link-creating"] + _DELTAS["class-only"]
    maps = {}
    for hatch in (True, False):
        inc = _fast(IncrementalClassifier, ClassifierConfig)
        inc.add_text(base)
        if hatch:
            monkeypatch.setenv("DISTEL_EXACT_DELTA_PROGRAMS", "1")
        else:
            monkeypatch.delenv("DISTEL_EXACT_DELTA_PROGRAMS", raising=False)
        inc.add_text(delta)
        rec = inc.history[-1]
        assert rec["path"] == "fast" and rec["delta_bucketed"] is (not hatch)
        maps[hatch] = _inc_map(inc)
    assert maps[True] == maps[False]


def test_second_same_bucket_delta_hits_registry():
    inc = _fast(IncrementalClassifier, ClassifierConfig)
    inc.add_text(_mk_base())
    inc.add_text("SubClassOf(Steady0 A)\n")
    assert inc.history[-1]["delta_programs"] > 0
    inc.add_text("SubClassOf(Steady1 A)\n")
    rec = inc.history[-1]
    assert rec["path"] == "fast" and rec["program_cache_hit"] is True, rec
    assert rec["delta_program_hits"] == rec["delta_programs"] > 0, rec
    assert rec["compile_s"] == 0.0 and rec["trace_lower_s"] == 0.0, rec


def test_same_bucket_delta_shared_across_ontologies():
    inc_a = _fast(IncrementalClassifier, ClassifierConfig)
    inc_a.add_text(_mk_base("P"))
    inc_a.add_text("SubClassOf(PNew PA)\n")
    sig_a = inc_a.history[-1]["delta_signature"]
    assert sig_a
    inc_b = _fast(IncrementalClassifier, ClassifierConfig)
    inc_b.add_text(_mk_base("Q"))
    inc_b.add_text("SubClassOf(QNew QA)\n")
    rec = inc_b.history[-1]
    assert rec["delta_signature"] == sig_a
    assert rec["program_cache_hit"] is True and rec["compile_s"] == 0.0, rec
    batch = _index(_mk_base("Q") + "SubClassOf(QNew QA)\n")
    assert _inc_map(inc_b) == _sub_map(_port(batch).saturate(), batch)


def test_link_capacity_edge_falls_back_exact():
    """A delta filling the base's last link row leaves no dead row for
    the pads: the delta runs exact-shape engines on both packages."""
    base = _mk_base()
    port = _fast(IncrementalClassifier, ClassifierConfig)
    ref = _fast(RefIncremental, RefConfig)
    for inc in (port, ref):
        inc._LINK_PAD = 0
        inc.add_text(base)
    nl, n0 = port._base_engine.nl, port._base_idx.n_links
    assert nl == ref._base_engine.nl == 32
    delta = "".join(
        f"SubClassOf(Fill{k} ObjectSomeValuesFrom(r Mk{k}))\n"
        for k in range(nl - n0)
    )
    for inc in (port, ref):
        inc.add_text(delta)
        assert inc.last_result.idx.n_links == nl
        rec = inc.history[-1]
        assert rec["path"] == "fast" and rec["delta_bucketed"] is False, rec
    batch = _index(base + delta)
    assert _inc_map(port) == _inc_map(ref) == _sub_map(
        _port(batch).saturate(), batch
    )


def test_fast_path_threshold_is_a_config_knob(tmp_path):
    assert ClassifierConfig().fast_path_min_concepts == 2_048
    p = tmp_path / "t.properties"
    p.write_text("fast.path.min.concepts = 7\nbucket.ratio = 1.5\n")
    cfg = ClassifierConfig.from_properties(str(p))
    assert (cfg.fast_path_min_concepts, cfg.bucket_ratio) == (7, 1.5)
    assert IncrementalClassifier(cfg, device="cpu")._FAST_PATH_MIN_CONCEPTS == 7
    inc = IncrementalClassifier(ClassifierConfig(), device="cpu")
    inc.add_text("SubClassOf(A B)\n")
    inc.add_text("SubClassOf(C A)\n")
    assert inc.history[-1]["path"] == "rebuild"
    inc = _fast(IncrementalClassifier, ClassifierConfig)
    inc.add_text("SubClassOf(A B)\n")
    inc.add_text("SubClassOf(C A)\n")
    assert inc.history[-1]["path"] == "fast"


def test_warmup_covers_first_delta_after_clear():
    """After ``PROGRAMS.clear()`` and ``warmup_text`` (serve profile) on
    a sample corpus, a fresh classifier's rebuild and its first
    class-only and link-creating deltas all build nothing."""
    from distel_tpu_torch.runtime import warmup

    cfg = ClassifierConfig(fast_path_min_concepts=0)
    PROGRAMS.clear()
    rec = warmup.warmup_text(_mk_base("W"), cfg, profile="serve", device="cpu")
    assert rec["delta_programs"] >= 3, rec
    inc = IncrementalClassifier(cfg, device="cpu")
    inc.add_text(_mk_base("W"))
    assert inc.history[-1]["program_cache_hit"] is True
    inc.add_text("SubClassOf(WNew WA)\n")
    h = inc.history[-1]
    assert h["program_cache_hit"] is True and h["compile_s"] == 0.0, h
    inc.add_text("SubClassOf(WL ObjectSomeValuesFrom(r WB))\n")
    h = inc.history[-1]
    assert h["program_cache_hit"] is True and h["compile_s"] == 0.0, h
    assert h["delta_program_hits"] == h["delta_programs"] == 2, h


# ------------------------------------------- observed and fused runs


ALL_SPARSE = {"density_threshold": 1.1, "hysteresis_rounds": 1}


@pytest.fixture(scope="module")
def tail_idx():
    return _index(chain_tailed_ontology(400, 12)
                  + "\nDisjointClasses(TailChain3 TailChain7)")


def _observed(engine, sparse, fused=None):
    obs = []
    res = engine.saturate_observed(
        observer=lambda it, d, ch: obs.append((it, d, ch)),
        sparse_tail=sparse, fused_rounds=fused, pipeline={"enable": False},
    )
    stats = [(s.iteration, s.tier, s.density, s.rows_touched, s.total_rows,
              s.derivations, s.overflow) for s in engine.frontier_rounds]
    return obs, stats, res


@pytest.mark.parametrize("sparse", [ALL_SPARSE, True], ids=["forced", "default"])
def test_bucketed_observed_matches_exact(tail_idx, sparse):
    want = _observed(_port(tail_idx, unroll=1), sparse)
    got = _observed(_port(tail_idx, unroll=1, bucket=True), sparse)
    assert got[:2] == want[:2]
    assert got[2].iterations == want[2].iterations
    _assert_real_rows_equal(tail_idx, got[2], want[2])


@pytest.mark.parametrize("sparse", [ALL_SPARSE, True], ids=["forced", "default"])
@pytest.mark.parametrize("k", [2, 4])
def test_bucketed_fused_matches_exact(tail_idx, sparse, k):
    """The window round for round against the exact per-round run; a
    second engine of the same corpus replays the first one's windows
    (registry hits that build nothing)."""
    want = _observed(_port(tail_idx, unroll=1), sparse)
    first = _port(tail_idx, unroll=1, bucket=True)
    got = _observed(first, sparse, {"rounds": k})
    assert got[:2] == want[:2]
    _assert_real_rows_equal(tail_idx, got[2], want[2])
    second = _port(tail_idx, unroll=1, bucket=True)
    again = _observed(second, sparse, {"rounds": k})
    assert again[:2] == want[:2]
    st = second.compile_stats
    assert st.program_cache_hit and st.compile_s == 0.0 == st.trace_lower_s


# ------------------------------------------- layouts, config, snapshots


def test_packed_engine_shape_only_bucketing():
    from distel_tpu.core.packed_engine import PackedSaturationEngine as RefPacked

    idx = _index(snomed_shaped_ontology(n_classes=300))
    got = PackedSaturationEngine(idx, device="cpu", bucket=True).saturate()
    ref_eng = RefPacked(idx, bucket=True, use_pallas=False)
    eng = PackedSaturationEngine(idx, device="cpu", bucket=True)
    assert (eng.nc, eng.nl) == (ref_eng.nc, ref_eng.nl)
    want = ref_eng.saturate()
    assert (got.iterations, got.derivations) == (want.iterations, want.derivations)
    assert _tax_key(extract_taxonomy(got)) == _tax_key(ref_taxonomy(want))


def test_config_buckets_by_default(tmp_path):
    cfg = ClassifierConfig()
    assert cfg.shape_buckets is True and cfg.bucket_ratio == 1.25
    p = tmp_path / "b.properties"
    p.write_text("shape.buckets = false\nbucket.ratio = 2.0\n")
    cfg = ClassifierConfig.from_properties(str(p))
    assert (cfg.shape_buckets, cfg.bucket_ratio) == (False, 2.0)
    p.write_text("bucket.ratio = 1.0\n")
    with pytest.raises(ValueError, match="bucket ratio must be > 1"):
        ClassifierConfig.from_properties(str(p))
    # the artifact farm's keys parse since the farm is ported
    p.write_text("compile.cache.dir = /tmp/x\nartifacts.dir = /tmp/y\n"
                 "artifacts.require = true\n")
    cfg = ClassifierConfig.from_properties(str(p))
    assert (cfg.compile_cache_dir, cfg.artifacts_dir, cfg.artifacts_require) \
        == ("/tmp/x", "/tmp/y", True)


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_bucketed_snapshot_round_trip(tmp_path, direction):
    """A bucketed run's v2 snapshot resumes on the other package's
    bucketed engine with nothing left to derive."""
    text = snomed_shaped_ontology(n_classes=300)
    idx = _index(text)
    path = str(tmp_path / "snap.npz")
    if direction == "port_to_ref":
        res = _port(idx, bucket=True).saturate()
        checkpoint.save_snapshot(path, res)
        state, _ = ref_checkpoint.load_snapshot_state(path, idx=idx, unpack=False)
        resumed = RefEngine(idx, bucket=True).saturate(initial=state)
    else:
        res = RefEngine(idx, bucket=True).saturate()
        ref_checkpoint.save_snapshot(path, res)
        state, _ = checkpoint.load_snapshot_state(path, idx=idx, unpack=False)
        resumed = _port(idx, bucket=True).saturate(initial=state)
    assert resumed.derivations == 0
    _assert_real_rows_equal(idx, resumed, res, derivations=False)


def test_classify_result_carries_compile_stats():
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = (Path(__file__).parent / "golden" / "01-atomic-transitivity.ofn").read_text()
    PROGRAMS.clear()
    first = ELClassifier(device="cpu").classify_text(text)
    again = ELClassifier(device="cpu").classify_text(text)
    assert "compile" in first.timer.phases
    assert first.compile_stats.bucket_signature.startswith("b")
    assert not first.compile_stats.program_cache_hit
    assert again.compile_stats.program_cache_hit
    assert again.compile_stats.compile_s == 0.0
