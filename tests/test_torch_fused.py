"""The port's fused K-round window against the reference's, on the CPU.

Both packages' row-packed engines run ``saturate_observed`` with
``fused_rounds={"rounds": K}`` on the reference test's corpus (the
chain-tailed GALEN shape with ``DisjointClasses(TailChain3 TailChain7)``,
so CR5 runs): the reference with ``tests/test_torch_observed.py``'s
``REF_KW`` (its scanned formulation, one row chunk a write group), both
at ``unroll=1``, the port on its plain versions, where the window's body
runs eagerly under the guard that refuses every host sync a card's
capture would refuse.  Each port run is held, tolerance 0, to the
reference's run of the same configuration and to the port's own
per-round run: the observer's ``(iteration, derivations, changed)``
sequence, every ``FrontierStats`` less its walls (``rounds_in_window``
included), and S, R, iterations and derivations.  These are the
reference's ``tests/test_fused_rounds.py`` cases; its two mesh tests
(``:309-340``) are ``test_fused_mesh_matches_reference`` and
``test_fused_mesh_pipelined``: the reference on its virtual CPU mesh of
1, 2 and 4 devices, the port on as many gloo ranks
(``tests/torch_mesh_ranks.py``, one launch a size, bounded by
``MESH_TIMEOUT_S``), every rank held to the reference's run on the mesh
and to the port's per-round run (the sharded sparse tier itself is
``tests/test_torch_sharded_adaptive.py``).  Then the pieces: the exact
density cutoff, the card round plan against the host selection, the
compaction against the host's workspaces, and the window's refusal of a
host sync.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu.owl import parser
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.ops.nosync import NoHostReads
from distel_tpu_torch.runtime.classifier import make_engine
from distel_tpu_torch.runtime.instrumentation import DISPATCH_EVENTS
from distel_tpu_torch.testing.cpumesh import cpu_mesh_run

import torch_mesh_ranks as ranks
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

GOLDEN = sorted((Path(__file__).parent / "golden").glob("*.ofn"))
REF_KW = dict(bucket=False, use_pallas=False, scan_chunks=True,
              scan_group_bytes=1)
ALL_SPARSE = {"density_threshold": 1.1, "hysteresis_rounds": 1}
ALL_DENSE = {"density_threshold": 0.0, "hysteresis_rounds": 1}
OVERFLOW = {**ALL_SPARSE, "capacity_buckets": 1, "capacity_floor": 8}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


@pytest.fixture(scope="module")
def galen_idx():
    text = chain_tailed_ontology(400, 12)
    return _index(text + "\nDisjointClasses(TailChain3 TailChain7)")


@pytest.fixture(scope="module")
def ref(galen_idx):
    """The shared reference engine (its compiled programs are cached on
    the engine)."""
    return RefEngine(galen_idx, unroll=1, **REF_KW)


def _stat(st):
    return (st.iteration, st.tier, st.density, st.rows_touched,
            st.total_rows, st.derivations, st.overflow, st.inflight,
            st.rounds_in_window)


def _run(engine, sparse, fused=None, depth=1):
    obs = []
    res = engine.saturate_observed(
        observer=lambda it, d, ch: obs.append((it, d, ch)),
        sparse_tail=sparse, fused_rounds=fused,
        pipeline={"enable": depth > 1, "depth": depth},
    )
    return obs, [_stat(s) for s in engine.frontier_rounds], res


def _port(idx, sparse, fused=None, depth=1):
    return _run(RowPackedSaturationEngine(idx, device="cpu", unroll=1),
                sparse, fused, depth)


def _closure(res):
    if isinstance(res.packed_s, torch.Tensor):
        return res.wire()
    return (np.asarray(res.packed_s).astype(np.uint32),
            np.asarray(res.packed_r).astype(np.uint32))


def _assert_same(got, want):
    (gobs, gst, gres), (wobs, wst, wres) = got, want
    assert gobs == wobs
    assert gst == wst
    assert (gres.iterations, gres.derivations, gres.converged) == \
        (wres.iterations, wres.derivations, wres.converged)
    (gs, gr), (ws, wr) = _closure(gres), _closure(wres)
    nl = gr.shape[0]
    assert np.array_equal(gs, ws)
    assert np.array_equal(gr, wr[:nl]) and not wr[nl:].any()


def _per_round(st):
    """A run's round records less what the window changes: the
    occupancy and the window size."""
    return [s[:7] for s in st]


def _dispatch_delta():
    before = DISPATCH_EVENTS.snapshot()

    def delta():
        after = DISPATCH_EVENTS.snapshot()
        return {k: after[k] - before[k] for k in before
                if k != "last_window_rounds"}

    return delta


# ------------------------------------------------------- K = 1


def test_k1_routes_through_per_round_controller(galen_idx, ref):
    """K = 1 is the per-round controller: the run without fused rounds,
    no window dispatched, every round a window of one."""
    base = _port(galen_idx, ALL_SPARSE)
    delta = _dispatch_delta()
    eng = RowPackedSaturationEngine(galen_idx, device="cpu", unroll=1)
    got = _run(eng, ALL_SPARSE, {"rounds": 1})
    assert delta()["fused_windows"] == 0
    _assert_same(got, base)
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": 1}))
    assert all(st.rounds_in_window == 1 for st in eng.frontier_rounds)


@pytest.mark.parametrize("sparse,depth", [(ALL_DENSE, 1), (ALL_SPARSE, 3)],
                         ids=["dense-depth1", "sparse-depth3"])
def test_k1_dense_and_pipelined_identity(galen_idx, ref, sparse, depth):
    got = _port(galen_idx, sparse, {"rounds": 1}, depth)
    _assert_same(got, _port(galen_idx, sparse, None, depth))
    _assert_same(got, _run(ref, sparse, {"rounds": 1}, depth))


def test_k1_adaptive_routes_per_round(galen_idx, ref):
    delta = _dispatch_delta()
    got = _port(galen_idx, ALL_SPARSE, {"rounds": 1, "adaptive": True})
    assert delta()["fused_windows"] == 0
    _assert_same(got, _port(galen_idx, ALL_SPARSE))
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": 1, "adaptive": True}))


# ------------------------------------------------------- K > 1


@pytest.mark.parametrize("k", (2, 4))
def test_fused_sparse_interleave_matches_per_round(galen_idx, ref, k):
    """All-sparse windows retire the per-round controller's rounds and
    closure, K rounds a dispatch, and the reference's fused run record
    for record; the collapse is counted."""
    base = _port(galen_idx, ALL_SPARSE)
    delta = _dispatch_delta()
    eng = RowPackedSaturationEngine(galen_idx, device="cpu", unroll=1)
    got = _run(eng, ALL_SPARSE, {"rounds": k})
    d = delta()
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": k}))
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])
    assert d["fused_windows"] >= 1
    assert d["fused_rounds_retired"] >= d["fused_windows"]
    per_round = d["dense_dispatches"] + d["sparse_dispatches"]
    assert per_round + d["fused_windows"] < len(base[1])
    riws = [st.rounds_in_window for st in eng.frontier_rounds]
    assert max(riws) == k and len(riws) == len(got[0])
    # one host read of the flags a window, against one a round
    assert eng.host_reads["flags"] == d["fused_windows"]


@pytest.mark.parametrize("k", (2, 4))
def test_fused_dense_only_matches_per_round(galen_idx, ref, k):
    got = _port(galen_idx, ALL_DENSE, {"rounds": k})
    _assert_same(got, _run(ref, ALL_DENSE, {"rounds": k}))
    base = _port(galen_idx, ALL_DENSE)
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])
    assert {s[1] for s in got[1]} <= {"dense", "idle"}


def test_fused_overflow_falls_out_to_host(galen_idx, ref):
    """A one-rung workspace of 8 rows: busy rounds fall out of the
    window unrun and replay on the host path, dense with the overflow
    flag, as the per-round controller runs them."""
    eng = RowPackedSaturationEngine(galen_idx, device="cpu", unroll=1)
    got = _run(eng, OVERFLOW, {"rounds": 4})
    _assert_same(got, _run(ref, OVERFLOW, {"rounds": 4}))
    base = _port(galen_idx, OVERFLOW)
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])
    riws = [st.rounds_in_window for st in eng.frontier_rounds]
    assert 1 in riws and max(riws) > 1
    assert any(s[6] for s in got[1])


@pytest.mark.parametrize("depth", (2, 3))
def test_fused_pipelined_matches_per_round(galen_idx, ref, depth):
    """Windows in flight, each chained on the previous one's carries:
    the per-round controller's rounds and the reference's pipelined
    fused run."""
    got = _port(galen_idx, ALL_SPARSE, {"rounds": 4}, depth)
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": 4}, depth))
    base = _port(galen_idx, ALL_SPARSE)
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])


def test_fused_default_controller_matches_reference(galen_idx, ref):
    """The default controller (threshold 0.05, hysteresis 2): dense
    rounds, then the sparse tail, in windows of 4."""
    got = _port(galen_idx, True, {"rounds": 4})
    _assert_same(got, _run(ref, True, {"rounds": 4}))
    assert {"dense", "sparse"} <= {s[1] for s in got[1]}


def test_k_adaptive_no_shrink_without_decay(galen_idx, ref):
    """The chain tail derives one fact a round: no geometric decay, so
    the adaptive K keeps windows of 4."""
    fixed = _port(galen_idx, ALL_SPARSE, {"rounds": 4})
    got = _port(galen_idx, ALL_SPARSE, {"rounds": 4, "adaptive": True})
    _assert_same(got, fixed)
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": 4, "adaptive": True}))


def test_k_adaptive_shrinks_windows_byte_identically(galen_idx, ref,
                                                     monkeypatch):
    """With the port's decay estimate forced to one round left every
    window shrinks to the K = 2 floor; only the window edges move."""
    from distel_tpu.obs import costmodel as ref_cm
    from distel_tpu_torch.obs import costmodel

    base = _port(galen_idx, ALL_SPARSE)
    monkeypatch.setattr(costmodel, "geometric_tail_remaining",
                        lambda deltas: 1)
    monkeypatch.setattr(ref_cm, "geometric_tail_remaining", lambda deltas: 1)
    delta = _dispatch_delta()
    eng = RowPackedSaturationEngine(galen_idx, device="cpu", unroll=1)
    got = _run(eng, ALL_SPARSE, {"rounds": 8, "adaptive": True})
    assert delta()["fused_windows"] >= 1
    _assert_same(got, _run(ref, ALL_SPARSE, {"rounds": 8, "adaptive": True}))
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])
    assert max(st.rounds_in_window for st in eng.frontier_rounds) <= 2


# ------------------------------------------------------- on a mesh

#: a hang in a collective fails the launch well inside the suite's clock
MESH_TIMEOUT_S = 120.0
GALEN_TEXT = chain_tailed_ontology(400, 12) + "\nDisjointClasses(TailChain3 TailChain7)"


def _mesh_cases(n):
    """name -> (engine kwargs, saturate_observed kwargs) of the mesh of
    ``n``: K = 2 and 4 at depth 1; at two shards K = 4 at depth 2 and
    K = 4 on a bucketed engine (its windows come from the registry)."""
    cases = {f"k{k}": ({}, dict(sparse_tail=ALL_SPARSE, fused_rounds={"rounds": k},
                                pipeline={"enable": False}))
             for k in (2, 4)}
    if n == 2:
        cases["k4-depth2"] = ({}, dict(sparse_tail=ALL_SPARSE,
                                       fused_rounds={"rounds": 4},
                                       pipeline={"enable": True, "depth": 2}))
        cases["k4-bucketed"] = ({"bucket": True}, cases["k4"][1])
    return cases


_MESH = {}


def mesh_run(n):
    """Every rank's fused runs on the mesh of ``n`` (one launch)."""
    if n not in _MESH:
        jobs = [{"name": name, "kind": "adaptive", "text": GALEN_TEXT,
                 "kw": {"unroll": 1, **kw}, "observe": obs}
                for name, (kw, obs) in _mesh_cases(n).items()]
        if n == 1:
            _MESH[n] = [ranks.run_jobs(torch.device("cpu"), jobs)]
        else:
            _MESH[n] = cpu_mesh_run(n, ranks.run_jobs, jobs,
                                    timeout_s=MESH_TIMEOUT_S)
    return _MESH[n]


def _ref_mesh_run(idx, n, obs):
    import jax

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("c",))
    return _run(RefEngine(idx, unroll=1, mesh=mesh, **REF_KW), obs["sparse_tail"],
                obs["fused_rounds"], obs["pipeline"].get("depth", 1)
                if obs["pipeline"]["enable"] else 1)


def _assert_rank(got, want, base):
    """One rank's run against the reference's on the mesh (``want``)
    and the port's per-round run (``base``)."""
    wobs, wst, wres = want
    assert got["events"] == wobs
    assert got["stats"] == wst
    assert (got["iterations"], got["derivations"], got["converged"]) == \
        (wres.iterations, wres.derivations, wres.converged)
    ws, wr = _closure(wres)
    assert np.array_equal(got["s"], ws) and np.array_equal(got["r"], wr)
    assert got["events"] == base[0]
    assert [s[:7] for s in got["stats"]] == _per_round(base[1])


@pytest.mark.parametrize("k", (2, 4))
@pytest.mark.parametrize("shards", (1, 2, 4))
def test_fused_mesh_matches_reference(galen_idx, shards, k):
    """Sharded fused windows (each round's fold inside the window) retire
    the per-round controller's rounds and closure on every rank, record
    for record the reference's sharded fused run, at 1, 2 and 4 shards;
    more than one rank runs the window uncaptured."""
    name = f"k{k}"
    obs = _mesh_cases(shards)[name][1]
    want = _ref_mesh_run(galen_idx, shards, obs)
    base = _port(galen_idx, ALL_SPARSE)
    for out in mesh_run(shards):
        got = out[name]
        _assert_rank(got, want, base)
        assert got["fused"]["windows"] and max(got["fused"]["windows"]) == k
        # one flag read a window, as off a mesh
        assert got["host_reads"]["flags"] == len(got["fused"]["windows"])
        if shards > 1:
            assert got["collectives"] > 0


def test_fused_mesh_pipelined(galen_idx):
    """Two shards, K = 4, windows under speculative dispatch (depth 2)."""
    obs = _mesh_cases(2)["k4-depth2"][1]
    want = _ref_mesh_run(galen_idx, 2, obs)
    base = _port(galen_idx, ALL_SPARSE)
    for out in mesh_run(2):
        _assert_rank(out["k4-depth2"], want, base)


def test_fused_mesh_bucketed_engine(galen_idx):
    """Two shards, K = 4, on bucketed engines (windows from the program
    registry, keyed by the sharded signature): the exact engine's
    rounds, and its closure over the real rows."""
    for out in mesh_run(2):
        got, exact = out["k4-bucketed"], out["k4"]
        assert got["events"] == exact["events"]
        assert got["stats"] == exact["stats"]
        n, nl = galen_idx.n_concepts, galen_idx.n_links
        assert np.array_equal(got["s"][:n, : exact["s"].shape[1]], exact["s"][:n])
        assert np.array_equal(got["r"][:nl, : exact["r"].shape[1]], exact["r"][:nl])


def test_fused_snomed_matches_reference():
    """A SNOMED-shaped corpus (CR4 and CR6 on many row chunks), forced
    onto the sparse tier, in windows of 4."""
    idx = _index(snomed_shaped_ontology(n_classes=2000))
    got = _port(idx, ALL_SPARSE, {"rounds": 4})
    _assert_same(got, _run(RefEngine(idx, unroll=1, **REF_KW), ALL_SPARSE,
                           {"rounds": 4}))
    base = _port(idx, ALL_SPARSE)
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_fused_matches_per_round(path):
    """Every golden fixture (every rule, ⊥ propagation) in windows of
    3, forced onto the sparse tier: the port's per-round run, which
    ``tests/test_torch_observed.py`` holds to the reference."""
    idx = _index(path.read_text())
    got = _port(idx, ALL_SPARSE, {"rounds": 3})
    base = _port(idx, ALL_SPARSE)
    assert got[0] == base[0] and _per_round(got[1]) == _per_round(base[1])
    assert np.array_equal(got[2].wire()[0], base[2].wire()[0])
    assert np.array_equal(got[2].wire()[1], base[2].wire()[1])


# ------------------------------------------------------- config


def test_fused_config_normalization():
    for raw in (None, True, False, {"rounds": 4}, {"rounds": 4, "adaptive": True},
                {"enable": False, "rounds": 4}, {"rounds": 1}):
        assert RowPackedSaturationEngine._normalize_fused_cfg(raw) == \
            RefEngine._normalize_fused_cfg(raw)
    for bad in ({"rounds": 0}, {"bogus": 1}):
        with pytest.raises(ValueError, match="fused_rounds"):
            RowPackedSaturationEngine._normalize_fused_cfg(bad)


def test_fused_k_ladder():
    for k in (1, 2, 3, 4, 8, 16):
        for adaptive in (False, True):
            assert RowPackedSaturationEngine._fused_k_ladder(k, adaptive) == \
                RefEngine._fused_k_ladder(k, adaptive)
    assert RowPackedSaturationEngine._fused_k_ladder(8, True) == [8, 4, 2]


def test_fused_config_reaches_engine_through_make_engine(galen_idx, tmp_path):
    props = tmp_path / "distel.properties"
    props.write_text("fused.rounds.enable = true\nfused.rounds.k = 4\n"
                     "fused.rounds.adaptive = true\n")
    cfg = ClassifierConfig.from_properties(str(props))
    want = RefConfig.from_properties(str(props)).fused_rounds_config()
    assert cfg.fused_rounds_config() == want == {
        "enable": True, "rounds": 4, "adaptive": True,
    }
    engine = make_engine(cfg, galen_idx, "cpu")
    assert engine._fused_cfg == want and engine._fused_eligible()
    props.write_text("fused.rounds.enable = false\nfused.rounds.k = 4\n")
    off = ClassifierConfig.from_properties(str(props))
    assert off.fused_rounds_config() is None
    assert RefConfig.from_properties(str(props)).fused_rounds_config() is None
    assert not make_engine(off, galen_idx, "cpu")._fused_eligible()


# ------------------------------------------------------- the pieces


@pytest.mark.parametrize("total", [1, 3, 7, 20, 101, 1000, 4097, 123_457])
def test_fused_below_cutoff_matches_reference(total):
    fake = types.SimpleNamespace(_sp_total_rows=total)
    for thr in (0.0, 1e-9, 0.001, 0.01, 0.05, 0.1, 1 / 3, 0.5, 0.999, 1.0,
                1.1, 2.0):
        got = RowPackedSaturationEngine._fused_below_cutoff(fake, thr)
        assert got == RefEngine._fused_below_cutoff(fake, thr), (total, thr)
        # the exact form of the host's test
        assert all((r / total < thr) == (r <= got)
                   for r in range(0, 2 * total + 3))


CORPORA = {
    "chain-tailed": lambda: chain_tailed_ontology(400, 12)
    + "\nDisjointClasses(TailChain3 TailChain7)",
    "snomed-2k": lambda: snomed_shaped_ontology(n_classes=2000),
}


def _frontiers(eng, seed):
    """Seeded random frontiers ``(s_chg, dirty_l)`` from empty to full."""
    rng = np.random.default_rng(seed)
    out = [(np.zeros(eng.nc, bool), np.zeros(eng.n_lchunks, bool)),
           (np.ones(eng.nc, bool), np.ones(eng.n_lchunks, bool))]
    for p in (0.001, 0.01, 0.1, 0.5):
        for q in (0.0, 0.3, 1.0):
            out.append((rng.random(eng.nc) < p, rng.random(eng.n_lchunks) < q))
    return out


@pytest.mark.parametrize("name", list(CORPORA))
def test_round_plan_dev_matches_host_selection(name):
    """The card round plan selects, from the same carries, exactly the
    rows, counts and ``run5`` of the host's ``_sparse_round_plan``."""
    eng = RowPackedSaturationEngine(_index(CORPORA[name]()), device="cpu")
    cfg = eng._normalize_sparse_cfg({"capacity_buckets": 30})
    for s_chg, dirty_l in _frontiers(eng, 7):
        rows, _den, meas, _over = eng._sparse_round_plan(
            cfg, s_chg, dirty_l, bool(dirty_l.any())
        )
        with NoHostReads():
            plan = eng._round_plan_dev(torch.from_numpy(s_chg),
                                       torch.from_numpy(dirty_l))
        assert int(plan["rows"]) == rows
        for key in ("1", "2", "3", "4", "6"):
            if "act" + key in plan:
                act = np.flatnonzero(plan["act" + key].numpy())
                assert np.array_equal(act, meas["act" + key]), key
                assert int(plan["n" + key]) == len(act)
            else:
                assert len(meas["act" + key]) == 0
        if eng._bottom:
            assert bool(plan["run5"]) == meas["run5"]


@pytest.mark.parametrize("name", list(CORPORA))
def test_compaction_matches_host_workspaces(name):
    """The card compaction gives the host selection in ascending order
    in the workspace's first slots, and pad slots index 0, invalid and
    with no source change; per write piece, its selected rows' count
    and first slot."""
    eng = RowPackedSaturationEngine(_index(CORPORA[name]()), device="cpu")
    cfg = eng._normalize_sparse_cfg({"capacity_buckets": 30})
    ft = eng._fused_tables()
    for s_chg, dirty_l in _frontiers(eng, 11):
        _rows, _den, meas, _over = eng._sparse_round_plan(
            cfg, s_chg, dirty_l, bool(dirty_l.any())
        )
        with NoHostReads():
            plan = eng._round_plan_dev(torch.from_numpy(s_chg),
                                       torch.from_numpy(dirty_l))
        n = {k: int(plan["n" + k]) for k in "12346"}
        caps = (max(n["1"], n["2"], n["3"]) + 5, n["4"] + 5, n["6"] + 5)
        with NoHostReads():
            sa = eng._fused_sparse_args_dev(plan, caps)
        tabs = {"1": eng._sp_nf1, "2": eng._sp_nf2, "3": eng._sp_nf3}
        for key, tab in tabs.items():
            if "rows" + key not in sa:
                continue
            act = meas["act" + key]
            n = len(act)
            valid = sa["val" + key].numpy()
            assert valid[:n].all() and not valid[n:].any()
            for col, got in enumerate(sa["rows" + key]):
                got = got.numpy()
                assert np.array_equal(got[:n], tab[act, col])
                assert not got[n:].any()
        for key, cap in (("4", caps[1]), ("6", caps[2])):
            if "sel" + key not in sa:
                continue
            act, fd = meas["act" + key], meas["fd" + key]
            n = len(act)
            sel, fdw = sa["sel" + key].numpy(), sa["fd" + key].numpy()
            assert len(sel) == cap
            assert np.array_equal(sel[:n], act) and not sel[n:].any()
            assert np.array_equal(fdw[:n], fd[act]) and not fdw[n:].any()
            pieces = ft["pieces" + key]
            cnt, start = sa["cnt" + key].numpy(), sa["start" + key].numpy()
            for pi, (_g, _c, r0, r1) in enumerate(pieces):
                inside = (act >= r0) & (act < r1)
                assert cnt[pi] == inside.sum()
                if inside.any():
                    assert start[pi] == int(np.flatnonzero(inside)[0])


def test_window_refuses_a_host_sync(galen_idx, monkeypatch):
    """A read of the device inside the window's body fails the run, on
    the CPU as a card's capture would: nothing falls back."""
    eng = RowPackedSaturationEngine(galen_idx, device="cpu", unroll=1)
    real = eng._round_plan_dev

    def reading(ms, dl):
        plan = real(ms, dl)
        plan["rows"] = plan["rows"] + int(plan["rows"].item()) * 0
        return plan

    monkeypatch.setattr(eng, "_round_plan_dev", reading)
    with pytest.raises(RuntimeError, match="reads the device back"):
        eng.saturate_observed(sparse_tail=ALL_SPARSE,
                              fused_rounds={"rounds": 4})
    mask = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="reads the device back"):
        with NoHostReads():
            torch.arange(4)[mask]


@pytest.mark.parametrize("seed", range(4))
def test_seg_or_write_matches_sequential_writes(seed):
    """The window's duplicate-safe row write against one write a row in
    order (the reference's ``write_seq``): the state, the rows marked
    changed and the live bits gained, with repeated targets, pad slots
    (0 contributions) and a segment bound of the longest target run."""
    rng = np.random.default_rng(seed)
    eng = RowPackedSaturationEngine(_index(CORPORA["chain-tailed"]()),
                                    device="cpu")
    rows, w = eng.nc, eng.wc
    state0 = torch.from_numpy(
        rng.integers(0, 2**32, (rows, w), dtype=np.uint64)
        .astype(np.uint32).view(np.int32) & (rng.random((rows, w)) < 0.3)
    )
    n, n_valid = 64, int(rng.integers(0, 64))
    tgt = torch.from_numpy(rng.integers(0, 12, n))
    valid = torch.arange(n) < n_valid
    x = torch.from_numpy(
        rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
        .view(np.int32)
    ) * valid.to(torch.int32)[:, None]
    most = int(np.unique(tgt[:n_valid].numpy(), return_counts=True)[1].max()) \
        if n_valid else 1
    got, mask = state0.clone(), torch.zeros(rows, dtype=torch.bool)
    with NoHostReads():
        delta = eng._seg_or_write(got, eng._seg_plan_dev(tgt, valid), x,
                                  slice(None), mask, most)
    want, want_mask, want_delta = state0.clone(), np.zeros(rows, bool), 0
    live = eng._wmask.numpy().view(np.uint32)
    for i in range(n_valid):
        t = int(tgt[i])
        old = want[t].numpy().view(np.uint32).copy()
        new = old | x[i].numpy().view(np.uint32)
        gained = new & ~old
        want[t] = torch.from_numpy(new.view(np.int32))
        want_mask[t] |= bool(gained.any())
        want_delta += int(np.unpackbits((gained & live).view(np.uint8)).sum())
    assert torch.equal(got, want)
    assert np.array_equal(mask.numpy(), want_mask)
    assert int(delta) == want_delta
