"""The port's incremental plane against the reference's.

The same axiom texts go through ``distel_tpu``'s
``IncrementalClassifier(ClassifierConfig(shape_buckets=False))`` (the
exact-layout contract the reference's own path tests pin) and
``distel_tpu_torch``'s ``IncrementalClassifier(device="cpu")``.  After
every increment the history record (``path``, ``iterations``,
``new_derivations``, ``batch_axioms``), whether the base engine is the
one before, S and R by name and the taxonomy must be equal — tolerance
0: the data are bits.  The scenarios are the reference's
(``tests/test_runtime.py``, ``tests/test_cr6_tiles.py``,
``tests/test_rowpacked_engine.py``) at their sizes; the last state is
also held to a from-scratch classify of the concatenated texts.
"""

import json

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.cr6_tiles import build_cr6_tile_schedule as ref_schedule
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.core.indexing import index_ontology as ref_index
from distel_tpu.core.rowpacked_engine import (
    RowPackedSaturationEngine as RefEngine,
)
from distel_tpu.frontend.normalizer import normalize as ref_normalize
from distel_tpu.owl import parser as ref_parser
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from distel_tpu_torch import cli
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.cr6_tiles import build_cr6_tile_schedule
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.core.indexing import index_ontology
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu_torch.owl import loader
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores
torch.set_num_threads(2)

HISTORY_KEYS = ("path", "iterations", "new_derivations", "batch_axioms")
TILES_ON = {"enable": True, "tile_m": 512, "tile_l": 256,
            "density_threshold": 100.0}


def _tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def _assert_same_closure(ref_res, port_res):
    """S and R of two results equal by name, over the live universe."""
    ri, pi = ref_res.idx, port_res.idx
    assert ri.concept_names == pi.concept_names
    assert ri.role_names == pi.role_names
    assert np.array_equal(np.asarray(ri.links), np.asarray(pi.links))
    n, nl = ri.n_concepts, ri.n_links
    assert np.array_equal(np.asarray(ref_res.s)[:n, :n], port_res.s[:n, :n])
    assert np.array_equal(np.asarray(ref_res.r)[:n, :nl], port_res.r[:n, :nl])


def _assert_same_step(ref, port, ref_res, port_res, reused):
    for key in HISTORY_KEYS:
        if key in ref.history[-1]:
            assert port.history[-1][key] == ref.history[-1][key], key
    assert port.history[-1]["path"] == ref.history[-1]["path"]
    assert reused[0] == reused[1], "base-engine reuse differs"
    _assert_same_closure(ref_res, port_res)
    assert _tax_key(extract_taxonomy(port_res)) == _tax_key(ref_taxonomy(ref_res))


def _pair(ref_cfg=None, port_cfg=None, fast_min=0, **attrs):
    ref = RefInc(ref_cfg or RefConfig(shape_buckets=False))
    # exact shapes, as the reference's (the compared states' layouts)
    port = IncrementalClassifier(port_cfg or ClassifierConfig(shape_buckets=False),
                                 device="cpu")
    for inc in (ref, port):
        if fast_min is not None:
            inc._FAST_PATH_MIN_CONCEPTS = fast_min
        for k, v in attrs.items():
            setattr(inc, k, v)
    return ref, port


def run_both(texts, **kw):
    """Feed ``texts`` to both packages one increment at a time, holding
    each step to the reference; returns ``(ref, port)``."""
    ref, port = _pair(**kw)
    for text in texts:
        rb, pb = ref._base_engine, port._base_engine
        rr = ref.add_text(text)
        pr = port.add_text(text)
        reused = (rb is not None and ref._base_engine is rb,
                  pb is not None and port._base_engine is pb)
        _assert_same_step(ref, port, rr, pr, reused)
    return ref, port


def _assert_batch(port, texts):
    """The port's incremental taxonomy equals its one-shot classify of
    the concatenated texts."""
    batch = ELClassifier(
        ClassifierConfig(use_native_loader=False), device="cpu"
    ).classify_text("".join(t if t.endswith("\n") else t + "\n" for t in texts))
    assert _tax_key(extract_taxonomy(port.last_result)) == _tax_key(batch.taxonomy)


def _subsumers(port, name):
    return set(extract_taxonomy(port.last_result).subsumers[name])


def _check(texts, paths, **kw):
    ref, port = run_both(texts, **kw)
    assert [h["path"] for h in port.history] == paths
    _assert_batch(port, texts)
    return port


# ------------------------------------------------ class-only and link deltas


def test_class_only_and_new_role_deltas_take_the_fast_path():
    """``test_incremental_delta_fast_path_matches_batch``: a class-only
    delta (with delta-side CR5) and a link delta of a fresh role, both
    on the fast path over the 600-class SNOMED-shaped base."""
    texts = [
        snomed_shaped_ontology(n_classes=600),
        "SubClassOf(Extra0 Find3)\n"
        "SubClassOf(Extra1 ObjectIntersectionOf(Find3 Find5))\n"
        "SubClassOf(ObjectIntersectionOf(Find3 Find5) ExtraBoth)\n"
        "DisjointClasses(Extra2 Find3)\nSubClassOf(Extra2 Find3)\n",
        "SubClassOf(Extra3 ObjectSomeValuesFrom(brandNewRole Find9))\n",
    ]
    port = _check(texts, ["rebuild", "fast", "fast"])
    assert "owl:Nothing" in _subsumers(port, "Extra2") or (
        "Extra2" in extract_taxonomy(port.last_result).unsatisfiable
    )


def test_multi_round_alternation():
    port = _check([
        "SubClassOf(A B)\nSubClassOf(B C)\n"
        "SubClassOf(C ObjectSomeValuesFrom(r D))\n"
        "SubClassOf(ObjectSomeValuesFrom(r D) E)\nSubClassOf(E F)\n",
        "SubClassOf(New0 A)\n"
        "SubClassOf(ObjectIntersectionOf(F C) NewBoth)\n"
        "SubClassOf(NewBoth NewTop)\n",
    ], ["rebuild", "fast"])
    assert {"A", "B", "C", "E", "F", "NewBoth", "NewTop"} <= _subsumers(port, "New0")


def test_nf4_delta_sorting_into_the_prefix():
    base = (
        "SubClassOf(Seed ObjectSomeValuesFrom(zRole Mid))\n"
        "SubClassOf(ObjectSomeValuesFrom(zRole Mid) ZTarget)\n"
        "SubClassOf(Other ObjectSomeValuesFrom(aRole Filler))\n"
        "SubClassOf(Filler FillerSup)\n"
    )
    delta = "SubClassOf(ObjectSomeValuesFrom(aRole Filler) ATarget)\n"
    ref, port = run_both([base, delta])
    b_idx = index_ontology(normalize(loader.load(base)))
    assert not np.array_equal(port.last_result.idx.nf4[: len(b_idx.nf4)], b_idx.nf4)
    assert [h["path"] for h in port.history] == ["rebuild", "fast"]
    assert "ATarget" in _subsumers(port, "Other")


LINK_CASES = {
    "cross_term": ([
        "SubClassOf(ObjectSomeValuesFrom(r OldFiller) Target)\n"
        "SubClassOf(Target TargetSup)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(r PadFiller))\n"
        "SubClassOf(OldFiller OldFillerSup)\n",
        "SubClassOf(Someone ObjectSomeValuesFrom(r OldFiller))\n",
    ], "Someone", {"Target", "TargetSup"}),
    "chain_growth": ([
        "SubObjectPropertyOf(ObjectPropertyChain(r s) t)\n"
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(t D) ChainHit)\n"
        "SubClassOf(B BSup)\n",
        "SubClassOf(B ObjectSomeValuesFrom(s D))\n",
    ], "A", {"ChainHit"}),
    "cr5_over_new_link": ([
        "DisjointClasses(D1 D2)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(r PadFiller))\n"
        "SubClassOf(D1 D1Sup)\n",
        "SubClassOf(NewX ObjectSomeValuesFrom(r BadFiller))\n"
        "SubClassOf(BadFiller D1)\nSubClassOf(BadFiller D2)\n",
    ], None, None),
}


@pytest.mark.parametrize("case", sorted(LINK_CASES))
def test_link_deltas(case):
    texts, probe, want = LINK_CASES[case]
    port = _check(texts, ["rebuild", "fast"])
    if probe is not None:
        assert want <= _subsumers(port, probe)
    else:
        assert {"NewX", "BadFiller"} <= set(
            extract_taxonomy(port.last_result).unsatisfiable
        )


def test_link_delta_overflowing_the_pad_rebuilds():
    port = _check([
        "SubClassOf(Pad ObjectSomeValuesFrom(r PadFiller))\n",
        "\n".join(f"SubClassOf(L{i} ObjectSomeValuesFrom(r F{i}))" for i in range(40)),
    ], ["rebuild", "rebuild"], _LINK_PAD=0)
    assert port._LINK_PAD == 0


# --------------------------------------------------------------- role deltas

ROLE_CASES = {
    "new_subrole": ([
        "SubClassOf(ObjectSomeValuesFrom(oldR OldFiller) SuperHit)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(oldR PadFiller))\n"
        "SubClassOf(OldFiller OFSup)\n",
        "SubObjectPropertyOf(newR oldR)\n"
        "SubClassOf(X ObjectSomeValuesFrom(newR OldFiller))\n"
        "SubClassOf(ObjectSomeValuesFrom(newR OldFiller) NewHit)\n",
    ], "fast", "X", {"SuperHit", "NewHit"}),
    "new_superrole": ([
        "SubClassOf(A ObjectSomeValuesFrom(oldR B))\nSubClassOf(B BSup)\n",
        "SubObjectPropertyOf(oldR newR)\n"
        "SubClassOf(ObjectSomeValuesFrom(newR B) UpHit)\n",
    ], "fast", "A", {"UpHit"}),
    "new_chain": ([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(t D) ChainHit)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(t PadF))\n"
        "SubClassOf(B BSup)\n",
        "SubObjectPropertyOf(ObjectPropertyChain(r newS) t)\n"
        "SubClassOf(B ObjectSomeValuesFrom(newS D))\n",
    ], "fast", "A", {"ChainHit"}),
    "hierarchy_change": ([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(s B) SHit)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(s PadF))\n"
        "SubClassOf(B BSup)\n",
        "SubObjectPropertyOf(r s)\n",
    ], "fast", "A", {"SHit"}),
    "old_pair_through_new_role": ([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(s B) SHit)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(s PadF))\n",
        "SubObjectPropertyOf(r newMid)\nSubObjectPropertyOf(newMid s)\n",
    ], "fast", "A", {"SHit"}),
    "rebind_refusal_rebuilds": ([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(s B) SHit)\n"
        "SubClassOf(B BSup)\n",
        "SubObjectPropertyOf(r s)\n",
    ], "rebuild", "A", {"SHit"}),
    "closure_change_with_chain_growth": ([
        "SubObjectPropertyOf(ObjectPropertyChain(t s) u)\n"
        "SubClassOf(A ObjectSomeValuesFrom(t M))\n"
        "SubClassOf(M ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(s PadF))\n"
        "SubClassOf(ObjectSomeValuesFrom(u B) UHit)\n"
        "SubClassOf(Pad2 ObjectSomeValuesFrom(u PadG))\n",
        "SubObjectPropertyOf(r s)\n",
    ], "fast", "A", {"UHit"}),
}


@pytest.mark.parametrize("case", sorted(ROLE_CASES))
def test_role_deltas(case):
    texts, path, probe, want = ROLE_CASES[case]
    port = _check(texts, ["rebuild", path])
    assert want <= _subsumers(port, probe)


RANGE_CASES = {
    "range_applies_to_later_batch": ([
        "ObjectPropertyRange(r RangeD)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(r PadF))\n"
        "SubClassOf(ObjectSomeValuesFrom(r RangeD) RHit)\n",
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n",
    ], "A", "RHit", True),
    "late_range_retrofits_old_rows": ([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r RangeD) RHit)\n"
        "SubClassOf(B BSup)\n",
        "ObjectPropertyRange(r RangeD)\n",
    ], "A", "RHit", True),
    "late_range_via_new_hierarchy_edge": ([
        "ObjectPropertyRange(s RangeD)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(s PadF))\n"
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r RangeD) RHit)\n",
        "SubObjectPropertyOf(r s)\n",
    ], "A", "RHit", True),
    "range_gensym_no_cross_batch_collision": ([
        "ObjectPropertyRange(r RangeD)\n"
        "SubClassOf(Pad ObjectSomeValuesFrom(r PadF))\n"
        "SubClassOf(ObjectSomeValuesFrom(r PadF) PadHit)\n",
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n",
    ], "A", "PadHit", False),
}


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_range_deltas(case):
    texts, probe, name, present = RANGE_CASES[case]
    ref, port = run_both(texts)
    _assert_batch(port, texts)
    assert (name in _subsumers(port, probe)) == present


# ---------------------------------------------------- other engines, config


@pytest.mark.parametrize("what", ["packed", "dense", "host_cr5"])
def test_other_engines_rebuild_every_increment(what):
    """The packed and dense engines, and the hybrid (``backend.CR5 =
    host``), are never a fast-path base: each increment rebuilds, as the
    reference's do."""
    if what == "host_cr5":
        rc = RefConfig(shape_buckets=False, rule_backends={"CR5": "host"})
        pc = ClassifierConfig(rule_backends={"CR5": "host"})
    else:
        rc = RefConfig(shape_buckets=False, engine=what)
        pc = ClassifierConfig(engine=what)
    texts = [
        "SubClassOf(A ObjectSomeValuesFrom(r B))\nDisjointClasses(B C)\n"
        "SubClassOf(ObjectSomeValuesFrom(r D) Hit)\n",
        "SubClassOf(B D)\n",
        "SubClassOf(E ObjectSomeValuesFrom(r C))\nSubClassOf(C B)\n",
    ]
    port = _check(texts, ["rebuild"] * 3, ref_cfg=rc, port_cfg=pc)
    assert port._base_engine is None


def test_fast_path_floor_from_config(tmp_path):
    """``fast.path.min.concepts`` parses as the reference's, and the
    floor sends a small base down the rebuild path."""
    from distel_tpu.config import ClassifierConfig as RC

    props = tmp_path / "p.properties"
    props.write_text("fast.path.min.concepts = 7\n")
    assert ClassifierConfig.from_properties(str(props)).fast_path_min_concepts == 7
    assert RC.from_properties(str(props)).fast_path_min_concepts == 7
    assert ClassifierConfig().fast_path_min_concepts == RC().fast_path_min_concepts
    texts = ["SubClassOf(A B)\nSubClassOf(B C)\n", "SubClassOf(D A)\n"]
    _check(texts, ["rebuild", "rebuild"], fast_min=None)


def test_demote_promote():
    ref, port = run_both([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r B) C)\n",
    ])
    assert port.demote() == ref.demote()
    rr, pr = ref.promote(), port.promote()
    assert port.history[-1] == {k: ref.history[-1][k] for k in port.history[-1]}
    assert port.history[-1]["path"] == "promote"
    _assert_same_closure(rr, pr)
    rr, pr = ref.add_text("SubClassOf(D A)\n"), port.add_text("SubClassOf(D A)\n")
    _assert_same_step(ref, port, rr, pr, (True, True))


# ------------------------------------------------- snapshots across packages


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshots_cross_packages(tmp_path, direction):
    texts = [
        "SubObjectPropertyOf(ObjectPropertyChain(r s) r)\n"
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r C) Hit)\n",
        "SubClassOf(B ObjectSomeValuesFrom(s C))\nSubClassOf(C D)\n",
    ]
    ref, port = run_both(texts)
    path = str(tmp_path / "snap.npz")
    if direction == "ref_to_port":
        ref.snapshot(path)
        back = IncrementalClassifier.restore(texts, path, device="cpu")
        want = ref
    else:
        port.snapshot(path)
        back = RefInc.restore(texts, path, RefConfig(shape_buckets=False))
        want = port
    assert back.history[-1]["path"] == "restore"
    assert back.history[-1]["new_derivations"] == 0
    if direction == "ref_to_port":
        _assert_same_closure(want.last_result, back.last_result)
    else:
        _assert_same_closure(back.last_result, want.last_result)
    # the restored classifier takes further deltas like the original
    for inc in (want, back):
        inc._FAST_PATH_MIN_CONCEPTS = 0
    a = want.add_text("SubClassOf(E A)\n")
    b = back.add_text("SubClassOf(E A)\n")
    assert want.history[-1]["path"] == back.history[-1]["path"] == "fast"
    if direction == "ref_to_port":
        _assert_same_closure(a, b)
    else:
        _assert_same_closure(b, a)


# --------------------------------------------------------------- cli stream


def test_cli_stream_matches_reference(tmp_path, capsys):
    from distel_tpu import cli as ref_cli

    files = []
    for i, text in enumerate([
        "SubClassOf(A ObjectSomeValuesFrom(r B))\nSubClassOf(B C)\n",
        "SubClassOf(ObjectSomeValuesFrom(r C) Hit)\n",
        "SubClassOf(D A)\n",
    ]):
        f = tmp_path / f"f{i}.ofn"
        f.write_text(text)
        files.append(str(f))
    props = tmp_path / "p.properties"
    props.write_text("fast.path.min.concepts = 0\nshape.buckets = false\n")
    port_props = tmp_path / "q.properties"
    port_props.write_text("fast.path.min.concepts = 0\nshape.buckets = false\n")
    prefix = str(tmp_path / "snap")
    assert cli.main(["stream", *files, "--config", str(port_props),
                     "--device", "cpu", "--snapshot-prefix", prefix]) == 0
    port_out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert ref_cli.main(["stream", *files, "--config", str(props)]) == 0
    ref_out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert len(port_out) == len(ref_out) == 4
    # each package's program-build record is its own (the reference's
    # exact-shape engines compile, the port's build nothing)
    build = {"bucket_signature", "program", "trace_lower_s", "compile_s",
             "program_cache_hit", "persistent_cache_hits", "persistent_cache_misses",
             "delta_signature"}
    for p, r in zip(port_out, ref_out):
        shared = set(p) & set(r) - {"wall_s"} - build
        assert shared >= ({"path", "iterations", "new_derivations", "file"}
                          if "file" in p else {"increments", "total_derivations"})
        assert {k: p[k] for k in shared} == {k: r[k] for k in shared}
    assert [p["path"] for p in port_out[:3]] == ["rebuild", "fast", "fast"]
    assert (tmp_path / "snap.0000.npz").exists()


# ----------------------------------------- rebind_role_closure and tile re-fit

_REBIND_BASE = (
    "SubClassOf(A0 ObjectSomeValuesFrom(r B0))\n"
    "SubClassOf(A1 ObjectSomeValuesFrom(r B1))\n"
    "SubClassOf(C ObjectSomeValuesFrom(s D))\n"
    "SubClassOf(ObjectSomeValuesFrom(s B0) SHit)\n"
    "SubClassOf(ObjectSomeValuesFrom(s D) DHit)\n"
    "SubClassOf(B0 B0Sup)\n"
)


def _both_idx(text):
    return (ref_index(ref_normalize(ref_parser.parse(text))),
            index_ontology(normalize(loader.load(text))))


def test_rebind_role_closure_matches_fresh():
    (_r, old), (ref_new, new) = _both_idx(_REBIND_BASE), _both_idx(
        _REBIND_BASE + "SubObjectPropertyOf(r s)\n")
    fresh = RowPackedSaturationEngine(new, device="cpu", window_headroom=2).saturate()
    ref_fresh = RefEngine(ref_new, window_headroom=2).saturate()
    eng = RowPackedSaturationEngine(old, device="cpu", window_headroom=2)
    before = eng.saturate()
    assert eng.rebind_role_closure(new.role_closure)
    resumed = eng.saturate(initial=(before.packed_s, before.packed_r))
    cold = eng.saturate()
    for res in (resumed, cold):
        for x, y in zip(res.wire(), fresh.wire()):
            assert np.array_equal(x, y)
    _assert_same_closure(ref_fresh, resumed)


def test_rebind_refuses_non_superset_shape_and_revived_chunk():
    _r, idx = _both_idx(_REBIND_BASE)
    eng = RowPackedSaturationEngine(idx, device="cpu")
    assert not eng.rebind_role_closure(idx.role_closure[:-1, :-1])
    shrunk = idx.role_closure.copy()
    off = np.argwhere(shrunk & ~np.eye(len(shrunk), dtype=bool))
    if len(off):
        shrunk[tuple(off[0])] = 0
        assert not eng.rebind_role_closure(shrunk)
    assert eng.rebind_role_closure(idx.role_closure)
    base = (
        "SubClassOf(A0 ObjectSomeValuesFrom(r B0))\n"
        "SubClassOf(ObjectSomeValuesFrom(s B0) SHit)\n"
        "SubClassOf(B0 B0Sup)\n"
    )
    (ref_old, old), (ref_new, new) = _both_idx(base), _both_idx(
        base + "SubObjectPropertyOf(r s)\n")
    eng = RowPackedSaturationEngine(old, device="cpu", window_headroom=2)
    ref_eng = RefEngine(ref_old, window_headroom=2)
    before = eng.idx.role_closure.copy()
    chunks = eng._chunks4
    assert not eng.rebind_role_closure(new.role_closure)
    assert not ref_eng.rebind_role_closure(ref_new.role_closure)
    assert np.array_equal(eng.idx.role_closure, before)
    assert eng._chunks4 is chunks


_TILE_BASE = (
    "SubObjectPropertyOf(ObjectPropertyChain(r s) r)\n"
    + "\n".join(f"SubClassOf(A{i} ObjectSomeValuesFrom(r B{i}))" for i in range(4))
    + "\n"
    + "\n".join(f"SubClassOf(B{i} ObjectSomeValuesFrom(s C{i}))" for i in range(4))
    + "\n"
    + "\n".join(f"SubClassOf(D{i} ObjectSomeValuesFrom(q E{i}))" for i in range(40))
    + "\nSubClassOf(ObjectSomeValuesFrom(r C3) RHit)\n"
)


@pytest.mark.parametrize("tile_l,headroom", [(256, 2), (32, 0)])
def test_tile_refit_matches_reference(tile_l, headroom):
    """``build_cr6_tile_schedule(h_override=, fit_schedule=)`` against
    the reference's on the same tables: the same live slots after a
    ``q ⊑ r`` closure growth, or None from both when the grown live set
    overflows the schedule's link tiles."""
    (r_old, old), (r_new, new) = _both_idx(_TILE_BASE), _both_idx(
        _TILE_BASE + "SubObjectPropertyOf(q r)\n")
    cp = old.chain_pairs
    n_roles = old.role_closure.shape[0]
    nl = max(((old.n_links + 31) // 32) * 32, 32)
    link_roles = np.full(nl, n_roles, np.int64)
    link_roles[: old.n_links] = old.links[:, 0]
    m6 = np.zeros((len(cp), n_roles + 1), np.int8)
    kw = dict(lc=nl, n_lchunks=1, tile_m=8, tile_l=tile_l,
              group_bounds=[0, len(cp)], dead_link=nl - 1)
    port0 = build_cr6_tile_schedule(cp[:, 0], cp[:, 1], cp[:, 2], link_roles,
                                    old.role_closure, tile_headroom=headroom, **kw)
    ref0 = ref_schedule(cp[:, 0], cp[:, 1], cp[:, 2], m6, link_roles,
                        old.role_closure, pad_target=0, tile_headroom=headroom, **kw)
    port1 = build_cr6_tile_schedule(
        cp[:, 0], cp[:, 1], cp[:, 2], link_roles, old.role_closure,
        h_override=new.role_closure, fit_schedule=port0, **kw)
    ref1 = ref_schedule(
        cp[:, 0], cp[:, 1], cp[:, 2], m6, link_roles, old.role_closure,
        pad_target=0, h_override=new.role_closure, fit_schedule=ref0, **kw)
    assert (port1 is None) == (ref1 is None)
    if port1 is not None:
        assert np.array_equal(port1.tids, ref1.tids)
        assert np.array_equal(port1.tval, ref1.tval)
        assert port1.groups is port0.groups
        assert port1.stats["live_links"] > port0.stats["live_links"]
    else:
        assert tile_l == 32 and headroom == 0


def test_rebind_refits_tiles_and_refuses_on_overflow():
    """The engine's rebind with the live-tile CR6: within the slots it
    re-derives as a fresh engine on the grown closure (and as the
    reference's); with no spare link tiles it refuses, untouched."""
    (_r, old), (ref_new, new) = _both_idx(_TILE_BASE), _both_idx(
        _TILE_BASE + "SubObjectPropertyOf(q r)\n")
    eng = RowPackedSaturationEngine(old, device="cpu", window_headroom=2,
                                    cr6_tiles=TILES_ON)
    assert eng._tiles6 is not None
    before = eng.saturate()
    assert eng.rebind_role_closure(new.role_closure)
    res = eng.saturate(initial=(before.packed_s, before.packed_r))
    fresh = RowPackedSaturationEngine(new, device="cpu", cr6_tiles=TILES_ON).saturate()
    for x, y in zip(res.wire(), fresh.wire()):
        assert np.array_equal(x, y)
    _assert_same_closure(RefEngine(ref_new).saturate(), res)
    tight = RowPackedSaturationEngine(
        old, device="cpu", window_headroom=0,
        cr6_tiles={"density_threshold": 100.0, "tile_l": 32, "tile_m": 8},
    )
    assert tight._tiles6.nt == max(tight._t6["n_tiles"])  # no spare tiles
    sched, t6 = tight._tiles6, tight._t6
    assert not tight.rebind_role_closure(new.role_closure)
    assert tight._tiles6 is sched and tight._t6 is t6
    assert np.array_equal(tight.idx.role_closure, old.role_closure)


def test_cross_engine_link_window_takes_tiles():
    """A link-window engine contracts only its window's links, and with
    tiles configured takes the live-tile CR6 whatever its density."""
    _r, idx = _both_idx(_TILE_BASE)
    w = (idx.n_links - 2, idx.n_links)
    eng = RowPackedSaturationEngine(
        idx, device="cpu", link_window=w,
        cr6_tiles={"enable": True, "density_threshold": 0.0},
    )
    assert eng._tiles6 is not None
    live = np.concatenate(eng._tiles6.live_per_span)
    assert ((live >= w[0]) & (live < w[1])).all()
    for c in eng._chunks4:
        for off, end, _c0, _c1 in c.windows:
            assert off < w[1] and end > w[0]


@pytest.mark.parametrize("device", ["cpu", "cpu:0"])
def test_reservations_and_device_embed(device, monkeypatch):
    """``min_concepts`` / ``min_links_pad`` give the reference's layout,
    ``init_total`` skips the count, and tensors on the engine's device
    embed there into fresh tensors, never through the host — also when
    the engine's device names an index its tensors do not report (as
    ``"cuda"`` and a card's ``cuda:0``)."""
    text = "SubClassOf(A ObjectSomeValuesFrom(r B))\nSubClassOf(B C)\n"
    r_idx, idx = _both_idx(text)
    kw = dict(min_concepts=idx.n_concepts + 2048, min_links_pad=idx.n_links + 2048,
              pad_multiple=2048)
    eng = RowPackedSaturationEngine(idx, device=device, **kw)
    ref = RefEngine(r_idx, **kw)
    assert (eng.nc, eng.nl) == (ref.nc, ref.nl)
    res = eng.saturate()

    def no_host(*_a, **_k):
        raise AssertionError("the embed copied the state to the host")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", no_host)
        m.setattr(torch.Tensor, "numpy", no_host)
        sp, rp = eng.embed_state(res.packed_s, res.packed_r)
    assert sp is not res.packed_s and torch.equal(sp, res.packed_s)
    host = eng.embed_state(*res.wire())
    assert torch.equal(host[0], sp) and torch.equal(host[1], rp)
    again = eng.saturate(initial=(res.packed_s, res.packed_r), init_total=0)
    assert again.derivations == eng.count_live_bits(again.packed_s, again.packed_r)
