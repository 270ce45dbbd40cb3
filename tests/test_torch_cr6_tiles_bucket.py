"""The live-tile CR6 under shape buckets: the port's bucketed tiled
engine against the reference's (``bucket=True, cr6_tiles=...``).

The reference runs on the CPU as ``tests/test_cr6_tiles.py``
runs it; the port runs its plain versions on the CPU.  Tolerance 0: the
data are bits.  Held here:

* the schedule builder's bucket half (``n_rows``, ``pad_target``,
  ``q1``, ``qn``): every array, the tile rungs and the write groups'
  row-tile ranges equal to the reference's on the same inputs, and
  each group writing the same real rows into the same targets (the
  port's bucketed writes gather no pad slot);
* round for round, the bucketed program's S and R (real rows), its
  change flag, and the port's public ``step()`` of the same engine,
  against the reference's bucketed tiled ``_step`` and the port's exact
  window engine; the program's gate counts against the public step's
  (the reference keeps none), and iterations and derivations against
  the reference's bucketed run;
* the density rule's fallback to windows under buckets (and a
  ``link_window`` engine taking tiles whatever the density);
* two same-bucket tiled engines sharing one program, which a window
  engine does not share, and the program surviving a spec round trip;
* a rebind refitting within the schedule's slots, and refusing on
  overflow;
* the delta fast path and the cohort over tiled cross programs;
* ``step_cost_model()`` under tiles;
* the tile decisions at 3,500 and 16,000 classes beside the
  reference's.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.cr6_tiles import build_cr6_tile_schedule as ref_schedule
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu.owl import parser
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import bucketing, cohort
from distel_tpu_torch.core.cr6_tiles import build_cr6_tile_schedule
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.core.program_cache import PROGRAMS, bucket_dim
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.owl import loader
from test_cr6_tiles import _REBIND_BASE, _chain_bucket_pair, _random_chain_text
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores
torch.set_num_threads(2)

#: tiles forced on (the density fallback has its own test)
TILES_ON = {"density_threshold": 100.0}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _port(idx, **kw):
    return RowPackedSaturationEngine(idx, device="cpu", **kw)


def _words(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def _equal_real(idx, got, want, what):
    (gs, gr), (ws, wr) = (tuple(_words(t) for t in p) for p in (got, want))
    nw = min(gs.shape[1], ws.shape[1])
    assert np.array_equal(gs[: idx.n_concepts, :nw],
                          ws[: idx.n_concepts, :nw]), f"{what}: S"
    assert np.array_equal(gr[: idx.n_links, :nw],
                          wr[: idx.n_links, :nw]), f"{what}: R"


def _run_program(prog, engine, rounds=None):
    """``engine``'s tables through ``prog`` from the initial state, the
    loop of ``_saturate_bucketed`` (budget-free); with ``rounds`` a
    callback after each group.  Returns the final ``(sp, rp)``."""
    with prog.pair.lock:
        prog.load(engine.bucket_tables())
        engine._fill_initial(prog.pair.sp, prog.pair.rp)
        prog.ms.fill_(True)
        prog.dl.copy_(prog.T["dl_valid"])
        while True:
            flags = prog.run()
            if rounds is not None:
                rounds(flags, prog.pair.sp, prog.pair.rp)
            if not flags[0]:
                return prog.pair.sp.clone(), prog.pair.rp.clone()


# --------------------------------------------------------- schedule pins


def _schedule_case(seed):
    rng = np.random.default_rng(seed)
    n_roles, nl = 6, 160
    n = int(rng.integers(20, 300))
    n_links = int(rng.integers(10, 150))
    tab_roles = np.sort(rng.integers(0, n_roles, n))
    link_roles = np.full(nl, n_roles)
    link_roles[:n_links] = rng.integers(0, n_roles, n_links)
    h = np.eye(n_roles, dtype=np.int8)
    for r in range(1, n_roles):
        if rng.random() < 0.5:
            h[r, rng.integers(0, r)] = 1
    m6 = rng.integers(0, 2, (n, n_roles + 1)).astype(np.int8)
    n_rows = bucket_dim(n, 1.25)
    kw = dict(
        lc=32, n_lchunks=5, tile_m=int(rng.choice([8, 16, 64])), tile_l=32,
        group_bounds=[0, n_rows] if seed % 2 else [0, n // 2, n_rows],
        n_rows=n_rows, dead_link=nl - 1, pad_target=nl - 1,
        q1=lambda x: bucket_dim(x, 1.25, floor=1),
        qn=lambda x: bucket_dim(x, 2.0, floor=8),
        tile_headroom=int(seed % 3 == 1),
        link_window=(3, 60) if seed % 3 == 0 else None,
    )
    args = (tab_roles, rng.integers(0, n_links, n), rng.integers(0, n_links, n))
    return args, m6, link_roles, h, kw


def _written(group, real_rows) -> dict:
    """What a write group ORs: target -> the real output rows (of
    ``real_rows``) its segment gathers; segments of no real row (pad
    slots, pad segments) write nothing under OR and are left out."""
    _rt0, _rt1, plan, order, targets = group
    out, pos, seg = {}, 0, 0
    for blen, nseg in plan.structure()[2]:
        for _ in range(nseg):
            rows = set(order[pos:pos + blen].tolist()) & real_rows
            if rows:
                out.setdefault(int(targets[seg]), set()).update(rows)
            pos, seg = pos + blen, seg + 1
    return out


@pytest.mark.parametrize("seed", range(6))
def test_bucket_schedule_pins_the_reference(seed):
    """``build_cr6_tile_schedule`` with ``q1``/``qn``/``n_rows``/
    ``pad_target`` against the reference's on the same tables: every
    array, the statistics, the tile rungs and the write groups'
    row-tile ranges; each group ORs the same real rows into the same
    targets as the reference's, through a quantized plan that gathers
    no pad slot."""
    args, m6, link_roles, h, kw = _schedule_case(seed)
    got = build_cr6_tile_schedule(*args, link_roles, h, **kw)
    want = ref_schedule(*args, m6, link_roles, h, **kw)
    for name in ("rows", "fdx", "tids", "tval"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    m6_pad = np.concatenate([m6, np.zeros((1, m6.shape[1]), np.int8)])
    assert np.array_equal(m6_pad[got.mrow_ids], want.mrows)
    assert got.stats == want.stats
    gp, wp = got.signature_parts(), want.signature_parts()
    assert gp[:4] == wp[:4]
    assert [g[:2] for g in gp[4]] == [w[:2] for w in wp[4]]
    assert got.n_rt == kw["q1"](max(len(want.spans), 1))
    n_real = len(args[0])
    for g, w in zip(got.groups, want.groups):
        rt0, rt1 = g[:2]
        real = {(rt - rt0) * got.tile_m + i
                for rt in range(rt0, min(rt1, len(got.spans)))
                for i in range(max(min(got.spans[rt][1], n_real) - got.spans[rt][0], 0))}
        assert _written(g, real) == _written(w, real)
        # the port's plan gathers real rows and the one all-zero row
        # past the group's output, nothing else
        pad = (rt1 - rt0) * got.tile_m
        assert set(g[3].tolist()) <= real | {pad}


# ------------------------------------------------------ round for round

ROUND_CORPORA = {
    "snomed-600": lambda: snomed_shaped_ontology(n_classes=600),
    "random-chain-0": lambda: _random_chain_text(0),
    "random-chain-1": lambda: _random_chain_text(1),
    "random-chain-2": lambda: _random_chain_text(2),
    "snomed-3500": lambda: snomed_shaped_ontology(n_classes=3500, seed=42),
}


@pytest.mark.parametrize("name", sorted(ROUND_CORPORA))
def test_bucketed_tiled_rounds_match_reference(name):
    """Per round: the program's S and R, and the public step's, equal the
    reference's bucketed tiled ``_step`` on the real rows, and the exact
    window engine's (the tile write groups are the window plan's
    chunks); the change flags agree; the program's gate counts equal the
    public step's (link tiles under ``cr6_tiles``) and the window
    engine's CR4 counts; iterations and derivations equal the
    reference's bucketed run."""
    idx = _index(ROUND_CORPORA[name]())
    # the smoke's cut corpus takes tiles at the default threshold
    tiles = TILES_ON if name != "snomed-3500" else {"density_threshold": 0.5}
    ref = RefEngine(idx, bucket=True, unroll=1, cr6_tiles=tiles)
    port = _port(idx, bucket=True, unroll=1, cr6_tiles=tiles)
    windows = _port(idx, unroll=1, cr6_tiles={"enable": False})
    assert ref._tiles6 is not None
    assert port.cr6_tiles_stats["active"] and port._bstruct.cr6 is None
    ts = port._bstruct.cr6t
    want = ref._tiles6.signature_parts()
    assert (ts.tile_m, ts.tile_l, ts.n_rt, ts.nt) == want[:4]
    assert [g[:2] for g in ts.groups] == [w[:2] for w in want[4]]
    assert (port.nc, port.nl) == (ref.nc, ref.nl)
    step = jax.jit(lambda sp, rp, d: ref._step(sp, rp, ref._masks, None, d))
    state = {"ref": (*ref.initial_state(), ref.initial_dirty()),
             "pub": (*port.initial_state(), None),
             "win": (*windows.initial_state(), None), "gates": []}
    start = state["ref"][:2]

    def check(flags, sp, rp):
        rs, rr, dirty = state["ref"]
        rs, rr, ch, dirty = step(rs, rr, dirty)
        state["ref"] = (rs, rr, dirty)
        state["pub"] = port.step(*state["pub"])
        state["win"] = windows.step(*state["win"])
        gates = port.gate_rounds[-1]
        state["gates"].append(gates)
        n = len(state["gates"])
        _equal_real(idx, (sp, rp), (rs, rr), f"program, round {n}")
        _equal_real(idx, state["pub"][:2], (rs, rr), f"step, round {n}")
        _equal_real(idx, state["win"][:2], (rs, rr), f"windows, round {n}")
        assert bool(flags[0]) == bool(ch) == state["pub"][2].changed
        assert [int(flags[1]), int(flags[2])] == gates["cr4"] == \
            windows.gate_rounds[-1]["cr4"]
        assert [int(flags[3]), int(flags[4])] == gates["cr6_tiles"]
        assert gates["cr6"] == [0, 0]

    prog = port._bucket_program()
    _run_program(prog, port, check)
    res = port.saturate()
    assert res.iterations == len(state["gates"])
    assert port.gate_rounds == state["gates"]
    wmask = ref._wmask.astype(np.uint32)
    end = state["ref"][:2]

    def live(s, r):
        return sum(int(np.unpackbits((_words(x) & wmask).view(np.uint8)).sum())
                   for x in (s, r))

    assert res.derivations == live(*end) - live(*start)
    _equal_real(idx, (res.packed_s, res.packed_r), end, "saturate")


# ------------------------------------------------------ density fallback


def test_density_fallback_to_windows_under_buckets():
    """Past the threshold a bucketed engine keeps the window formulation
    (its ``RuleStruct``, reason in the stats), with the density taken
    against the bucketed window plane; a ``link_window`` engine takes
    tiles at the same threshold; both closures equal the tiled one."""
    idx = _index(snomed_shaped_ontology(n_classes=600))
    eng = _port(idx, bucket=True, cr6_tiles={"density_threshold": 1e-9})
    st = eng.cr6_tiles_stats
    assert eng._tiles6 is None and not st["active"]
    assert st["reason"] == "density above threshold"
    rs = eng._bstruct.cr6
    assert eng._bstruct.cr6t is None and rs is not None
    assert st["window_slot_rows"] == rs.chunks * rs.slots * rs.length * rs.rows
    assert st["tile_slot_rows"] == st["occupied_slots"] * st["tile_m"]
    cross = _port(idx, bucket=True, link_window=(0, idx.n_links),
                  cr6_tiles={"density_threshold": 1e-9})
    assert cross.cr6_tiles_stats["active"] and cross._bstruct.cr6t is not None
    tiled = _port(idx, bucket=True, cr6_tiles=TILES_ON).saturate()
    for res in (eng.saturate(), cross.saturate()):
        assert res.iterations == tiled.iterations
        _equal_real(idx, (res.packed_s, res.packed_r),
                    (tiled.packed_s, tiled.packed_r), "fallback")


# ------------------------------------------------------- program sharing


def test_same_bucket_tiled_engines_share_program():
    """The reference's same-bucket chain pair: one signature on both
    packages, the port's second engine a registry hit that computes its
    own closure (equal to its window engine's and the reference's); a
    window engine of the same ontology keys another program; the program
    rebuilt from its JSON spec gives the same closure."""
    ta, tb = _chain_bucket_pair()
    ia, ib = _index(ta), _index(tb)
    ra = RefEngine(ia, unroll=1, bucket=True, cr6_tiles=TILES_ON)
    rb = RefEngine(ib, unroll=1, bucket=True, cr6_tiles=TILES_ON)
    assert ra.bucket_signature == rb.bucket_signature
    PROGRAMS.clear()
    ea = _port(ia, unroll=1, bucket=True, cr6_tiles=TILES_ON)
    eb = _port(ib, unroll=1, bucket=True, cr6_tiles=TILES_ON)
    assert ea._bstruct.cr6t is not None
    assert ea.bucket_signature == eb.bucket_signature
    win = _port(ia, unroll=1, bucket=True, cr6_tiles={"enable": False})
    assert win.bucket_signature != ea.bucket_signature
    res_a, res_b = ea.saturate(), eb.saturate()
    assert eb.compile_stats.program_cache_hit
    assert PROGRAMS.stats()["misses"] == 1
    for idx, ref, res in ((ia, ra, res_a), (ib, rb, res_b)):
        want = ref.saturate()
        assert res.iterations == want.iterations
        assert res.derivations == want.derivations
        _equal_real(idx, (res.packed_s, res.packed_r),
                    (want.packed_s, want.packed_r), "shared")
        w = _port(idx, unroll=1, bucket=True,
                  cr6_tiles={"enable": False}).saturate()
        _equal_real(idx, (res.packed_s, res.packed_r),
                    (w.packed_s, w.packed_r), "windows")
    spec = json.loads(json.dumps(bucketing.program_spec(eb._prog_ref())))
    struct, shapes = bucketing.spec_parts(spec)
    assert struct == eb._bstruct
    assert bucketing.shape_signature(struct, shapes) == eb.bucket_signature
    prog = bucketing.BucketProgram.from_spec(spec, "cpu")
    got = _run_program(prog, eb)
    _equal_real(ib, got, (res_b.packed_s, res_b.packed_r), "from spec")


# ---------------------------------------------------------------- rebind


def test_bucketed_rebind_refits_within_slots():
    """A closure growth that fits the schedule's link-tile slots rebinds
    in place (same signature, same program) and the resumed run equals
    a fresh engine on the grown closure and the reference's."""
    idx_old = _index(_REBIND_BASE)
    idx_new = _index(_REBIND_BASE + "SubObjectPropertyOf(q r)\n")
    kw = dict(bucket=True, window_headroom=2, cr6_tiles=TILES_ON)
    eng = _port(idx_old, **kw)
    assert eng._tiles6 is not None
    before = eng.saturate()
    sig, nt = eng.bucket_signature, eng._tiles6.nt
    assert eng.rebind_role_closure(idx_new.role_closure)
    assert eng.bucket_signature == sig and eng._tiles6.nt == nt
    assert eng.bucket_tables()["t6tval"].sum() > 0
    resumed = eng.saturate(initial=(before.packed_s, before.packed_r))
    fresh = _port(idx_new, **kw).saturate()
    _equal_real(idx_new, (resumed.packed_s, resumed.packed_r),
                (fresh.packed_s, fresh.packed_r), "rebind")
    want = RefEngine(idx_new, **kw).saturate()
    _equal_real(idx_new, (fresh.packed_s, fresh.packed_r),
                (want.packed_s, want.packed_r), "reference")


def test_bucketed_rebind_refuses_on_slot_overflow():
    """No reserve slots and narrow link tiles: the grown live set needs
    more link tiles than the schedule holds, the rebind refuses and the
    engine keeps its schedule and tables (the reference refuses too)."""
    idx_old = _index(_REBIND_BASE)
    idx_new = _index(_REBIND_BASE + "SubObjectPropertyOf(q r)\n")
    kw = dict(bucket=True, window_headroom=0,
              cr6_tiles={"density_threshold": 100.0, "tile_l": 32})
    ref = RefEngine(idx_old, **kw)
    eng = _port(idx_old, **kw)
    before, tabs = eng._tiles6, eng.bucket_tables()
    assert before.nt == ref._tiles6.nt
    assert not ref.rebind_role_closure(idx_new.role_closure)
    assert not eng.rebind_role_closure(idx_new.role_closure)
    assert eng._tiles6 is before and eng.bucket_tables() is tabs


# ------------------------------------------------------------ delta plane

_DELTA_BASE = snomed_shaped_ontology(n_classes=300)
_DELTA = "\n".join(
    f"SubClassOf(DD{i} ObjectSomeValuesFrom(attr1 Find{i}))" for i in range(6)
) + "\n"


def test_delta_fast_path_with_tiled_cross_equals_rebuild():
    """A link-creating delta over a chain base through the bucketed fast
    path: the cross program is tiled (whatever its density) and is the
    one ``warm_delta_programs`` built ahead of it (a registry hit), and
    the closure equals a from-scratch classify of base + delta and the
    reference's incremental run."""
    from distel_tpu_torch.core.incremental import warm_delta_programs

    cfg = ClassifierConfig(fast_path_min_concepts=0, use_native_loader=False)
    inc = IncrementalClassifier(cfg, device="cpu")
    inc.add_text(_DELTA_BASE)
    warmed = {r["program"]: r["bucket_signature"] for r in warm_delta_programs(
        cfg, inc._base_engine, inc._base_idx, cohort_sizes=[])}
    idx, batch = inc._ingest(loader.load(_DELTA))
    plan = inc._delta_fast_plan(idx)
    assert plan is not None and plan.bucketed and len(plan.engines) == 3
    cross = plan.engines[1]
    assert cross._link_window is not None
    assert cross.cr6_tiles_stats["active"] and cross._bstruct.cr6t is not None
    assert cross.bucket_signature == warmed["cross"]
    res = inc._execute_delta_plan(plan)
    assert cross.compile_stats.program_cache_hit
    inc._finish_increment(batch, res, "fast")
    ref = RefInc(RefConfig(fast_path_min_concepts=0))
    ref.add_text(_DELTA_BASE)
    want = ref.add_text(_DELTA)
    assert ref.history[-1]["path"] == "fast"
    full = _index(_DELTA_BASE + _DELTA)
    names = full.concept_names

    def by_name(r):
        ci = r.idx
        return {ci.concept_names[x]: {ci.concept_names[i] for i in r.subsumers(x)
                                      if i < ci.n_concepts}
                for x in range(ci.n_concepts)}

    got = by_name(inc.last_result)
    assert got == by_name(want)
    scratch = _port(full).saturate()
    assert got == {names[x]: {names[i] for i in scratch.subsumers(x)
                              if i < full.n_concepts}
                   for x in range(full.n_concepts)}


def _cohort_member(p, kind):
    base = (f"SubClassOf({p}A {p}B)\n"
            f"SubClassOf({p}C ObjectSomeValuesFrom(r {p}D))\n"
            f"SubClassOf({p}D ObjectSomeValuesFrom(s {p}E))\n"
            f"SubClassOf(ObjectSomeValuesFrom(r {p}E) {p}F)\n"
            "SubObjectPropertyOf(ObjectPropertyChain(r s) r)\n")
    delta = {"link": f"SubClassOf({p}L ObjectSomeValuesFrom(s {p}B))\n",
             "mixed": (f"SubClassOf({p}N {p}A)\n"
                       f"SubClassOf({p}M ObjectSomeValuesFrom(r {p}C))\n")}[kind]
    inc = IncrementalClassifier(ClassifierConfig(fast_path_min_concepts=0),
                                device="cpu")
    inc.add_text(base)
    idx, batch = inc._ingest(loader.load(delta))
    plan = inc._delta_fast_plan(idx, cohort_shape=True)
    assert plan is not None and cohort.delta_cohort_ready(inc, plan)
    return inc, plan, batch


def test_cohort_of_tiled_cross_programs_equals_solo():
    """Members whose roster holds a tiled cross program form one cohort;
    each member's S, R, derivations and iterations equal its solo run
    of the same plan; the base signature (the registry's cohort key)
    carries the tile structure."""
    spec = [("Ta", "link"), ("Tb", "mixed"), ("Tc", "link")]
    solo = []
    for p, kind in spec:
        inc, plan, batch = _cohort_member(p, kind)
        solo.append(inc._execute_delta_plan(plan))
    members = [_cohort_member(p, kind) for p, kind in spec]
    assert len({plan.roster_key() for _i, plan, _b in members}) == 1
    tiled = [e for e in members[0][1].engines
             if e._bstruct is not None and e._bstruct.cr6t is not None]
    assert tiled, "no tiled program in the roster"
    results = cohort.execute_delta_cohort(members)
    for got, want in zip(results, solo):
        assert torch.equal(got.packed_s, want.packed_s)
        assert torch.equal(got.packed_r, want.packed_r)
        assert (got.derivations, got.iterations) == \
            (want.derivations, want.iterations)
    base = members[0][0]._base_engine
    assert base._bstruct.cr6t is not None
    win = _port(base.idx, bucket=True, cr6_tiles={"enable": False},
                state_dims=(base.nc, base.nl), l_chunk=base.lc)
    assert win.bucket_signature != base.bucket_signature


# ------------------------------------------------------------ cost model


def test_cost_model_accounts_tiles():
    """Under buckets the tiled engine's dense-equivalent figure is the
    window engine's (the padded window plane) and its live MACs are the
    occupied slots', fewer than the window plane's; its card bytes
    charge the padded tile plane."""
    idx = _index(snomed_shaped_ontology(n_classes=600))
    e_w = _port(idx, unroll=1, bucket=True, cr6_tiles={"enable": False})
    e_t = _port(idx, unroll=1, bucket=True, cr6_tiles=TILES_ON)
    c_w, c_t = e_w.step_cost_model(), e_t.step_cost_model()
    assert c_t["mm_dense_equiv_macs"] == c_w["mm_dense_equiv_macs"]
    assert c_t["mm_live_macs"] < c_w["mm_live_macs"]
    t = e_t._tiles6
    assert c_t["mm_live_macs"] - c_w["mm_live_macs"] == (
        t.stats["occupied_slots"] * t.tile_m * e_t.nc
        - _window_live_macs(e_w))
    assert c_t["hbm_bytes"] >= t.n_rt * t.nt * t.tile_l * 4 * e_t.wc
    st = e_t.plan_stats()
    assert st["cr6_tile_rungs"] == [t.n_rt, t.nt] and st["cr6_row_tiles"] == t.n_rt


def _window_live_macs(engine):
    rs = engine._bstruct.cr6
    return rs.chunks * rs.slots * rs.rows * rs.length * engine.nc


# ------------------------------------------------------------- decisions

#: per size, whether each engine takes tiles at the default config, and
#: the window slot rows its density divides by (the tile slot rows are
#: the same on all four)
DECISIONS = {
    3500: {"port_exact": (True, 8_218_368), "port_bucket": (True, 9_665_792),
           "ref_exact": (True, 8_218_368), "ref_bucket": (True, 9_665_792),
           "tile_slot_rows": 1_216_512},
    # the port's window volume counts the rows its windows hold (exact)
    # or the bucketed step's rung plane (buckets); the reference charges
    # each window its scanned slab's height: 2.3x to 3.5x larger, tiles
    16000: {"port_exact": (False, 13_254_912),
            "port_bucket": (False, 18_192_000),
            "ref_exact": (True, 45_990_432), "ref_bucket": (True, 41_187_840),
            "tile_slot_rows": 15_788_544},
}


@pytest.mark.parametrize("n_classes", sorted(DECISIONS))
def test_tile_decisions_beside_the_reference(n_classes):
    """The default config's tile decision at two sizes of the smoke's
    corpus, on both packages and both modes (engine construction only).
    At 3,500 classes the four agree, the port's bucketed window plane
    equal to the reference's.  At 16,000 they decide apart on the same
    tile volume: the port's exact denominator is the rows its windows
    hold and its bucketed one the rung window plane its step launches
    (densities 1.1911 and 0.8679: windows), the reference's charge
    every window its scanned slab's height (0.3433 and 0.3833:
    tiles)."""
    idx = _index(snomed_shaped_ontology(n_classes=n_classes, seed=42))
    cfg = {"density_threshold": 0.5}
    engines = {
        "port_exact": _port(idx, cr6_tiles=cfg),
        "port_bucket": _port(idx, bucket=True, cr6_tiles=cfg),
        "ref_exact": RefEngine(idx, bucket=False, scan_chunks=True,
                               cr6_tiles=cfg),
        "ref_bucket": RefEngine(idx, bucket=True, cr6_tiles=cfg),
    }
    want = DECISIONS[n_classes]
    for name, eng in engines.items():
        st = eng.cr6_tiles_stats
        assert (st["active"], st["window_slot_rows"]) == want[name], name
        assert st["tile_slot_rows"] == want["tile_slot_rows"], name


# ------------------------------------------------------------- profiling


def test_profile_splits_the_tile_slot_by_rule():
    """A bucketed tiled engine's profile: the tile contraction under
    ``cr6`` and its bit tables under ``bit_table`` (the split's
    ``bit_table_psum``); the split's iterations and derivations are the
    run's, and the gate counts land under ``cr6_tiles``."""
    from distel_tpu_torch.runtime.profiling import profile_saturation

    idx = _index(snomed_shaped_ontology(n_classes=300))
    eng = _port(idx, bucket=True, cr6_tiles=TILES_ON)
    want = eng.saturate()
    tiles = eng.gate_totals()["cr6_tiles"]
    assert tiles["contracted"] > 0 and eng.gate_totals()["cr6"]["contracted"] == 0
    prof = profile_saturation(eng)
    assert (prof["iterations"], prof["derivations"]) == \
        (want.iterations, want.derivations)
    assert prof["phases_s"].get("cr6", 0) > 0
    assert prof["phases_s"].get("bit_table_psum", 0) > 0
