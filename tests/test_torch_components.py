"""The port's component plane (``core/components.py``,
``frontend/partition_text.py``, ``cli partition``) against the JAX
package's.

* The reference's own tests (``tests/test_components.py``) run on the
  port's modules on the CPU, the port's monolithic row-packed engine
  the oracle.
* Parity: the same seeded corpora through both packages'
  ``partition_index`` give the same components (tables and global
  maps); ``saturate_components`` gives the same counters, per group
  too; and every copy's packed S and R equal the reference's word for
  word.  The reference keeps a batched group's closures inside its
  jitted loop, so the test wraps ``jax.jit`` while the reference runs
  and keeps the state its loop returns (the program is unchanged).
  The tolerance is zero: the data are bits.
* The budget rounds down to ``unroll`` in a batched group, a group
  that does not converge raises the reference's message, and
  ``warm_timing`` runs a second fixed point.
* ``cli partition`` prints the reference's JSON, bar ``wall_s``, at the
  text level, at the index level and on the text fallback.
* The host half and the text partitioner are the reference's source.
"""

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
from distel_tpu import cli as ref_cli
from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core import components as ref_comp
from distel_tpu.core.indexing import index_ontology as ref_index
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize as ref_normalize
from distel_tpu.frontend.ontology_tools import multiply_ontology as ref_multiply
from distel_tpu.owl import parser as ref_parser
from distel_tpu_torch import cli
from distel_tpu_torch.config import MULTI_PROCESS_KEYS, ClassifierConfig
from distel_tpu_torch.core import components as comp
from distel_tpu_torch.core.components import (
    BatchedSuperstep,
    partition_index,
    saturate_components,
    saturate_isomorphic,
)
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, index_ontology
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.frontend.ontology_tools import (
    multiply_ontology,
    synthetic_ontology,
)
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES,
    packed_cols_dense_batched,
    plain_packed_cols,
    plain_packed_cols_batched,
)
from distel_tpu_torch.owl import parser
from distel_tpu_torch.owl import syntax as S
from distel_tpu_torch.owl.writer import axiom_to_str
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GALEN = str(ROOT / "tests" / "corpora" / "galen_module_jia.owl")
SMALL = synthetic_ontology(n_classes=60, n_anatomy=20, n_locations=15,
                           n_definitions=8)
#: a second, non-isomorphic corpus (singleton components beside the copies)
OTHER = synthetic_ontology(n_classes=40, n_anatomy=10, n_locations=8,
                           n_definitions=5, seed=3)
IDX_ARRAYS = ("nf1", "nf2", "nf3", "nf4", "links", "chain_pairs",
              "role_closure", "original_classes")
IDX_SCALARS = ("n_concepts", "n_roles", "concept_names", "concept_ids",
               "role_names", "role_ids", "has_bottom_axioms")


def _small_onto():
    return parser.parse(SMALL)


def _cpu(**kw):
    return RowPackedSaturationEngine(kw.pop("idx"), device="cpu", **kw)


def _ofn(onto) -> str:
    return "\n".join(
        axiom_to_str(a) for a in onto.axioms
        if not isinstance(a, S.UnsupportedAxiom)
    )


@pytest.fixture(scope="module")
def multiplied():
    onto = multiply_ontology(_small_onto(), 5)
    norm = normalize(onto)
    idx = index_ontology(norm)
    return norm, idx


# ------------------------------------------- the reference's tests, ported


def test_partition_finds_copies(multiplied):
    _, idx = multiplied
    comps = partition_index(idx)
    # five renamed copies => at least five components, grouped into as
    # many isomorphism classes as one copy has (copies are identical)
    assert len(comps) >= 5
    sigs = {c.signature() for c in comps}
    assert len(sigs) * 5 <= len(comps) or len(sigs) < len(comps)
    # every global concept lands in exactly one component
    seen = np.concatenate([c.global_concepts for c in comps])
    assert len(seen) == len(set(seen.tolist()))
    # ⊤/⊥ never appear in a component's global map
    assert TOP_ID not in seen and BOTTOM_ID not in seen


def test_batched_equals_monolithic(multiplied):
    _, idx = multiplied
    whole = _cpu(idx=idx).saturate()
    comps = partition_index(idx)
    agg = saturate_components(comps, device="cpu")
    assert agg["derivations"] == whole.derivations
    assert agg["n_components"] == len(comps)
    assert any(g["batch"] > 1 for g in agg["groups"])


def test_component_closure_matches_restriction(multiplied):
    """Classify one component alone; its S rows must equal the whole
    corpus's closure restricted to the component's concepts."""
    _, idx = multiplied
    whole = _cpu(idx=idx).saturate()
    comp0 = partition_index(idx)[0]
    res = _cpu(idx=comp0.idx).saturate()
    g = comp0.global_concepts
    n_local = comp0.idx.n_concepts
    s_local = res.s[:n_local, :n_local]
    gset = set(g.tolist())
    for a_loc in range(2, n_local):
        mapped = {
            int(g[i - 2]) if i >= 2 else int(i)
            for i in np.nonzero(s_local[a_loc])[0]
        }
        subs_global = {
            int(i)
            for i in np.nonzero(whole.s[g[a_loc - 2], : idx.n_concepts])[0]
            if i in (TOP_ID, BOTTOM_ID) or i in gset
        }
        assert mapped == subs_global


def test_bottom_stays_component_local():
    base = _small_onto()
    onto = multiply_ontology(base, 3)
    # poison copy 0 only: a disjointness that fires
    a = S.Class(sorted(c.iri for c in base.classes())[0] + "__copy0")
    onto.add(S.SubClassOf(a, S.OWL_NOTHING))
    idx = index_ontology(normalize(onto))
    whole = _cpu(idx=idx).saturate()
    agg = saturate_components(partition_index(idx), device="cpu")
    assert agg["derivations"] == whole.derivations
    # the poisoned copy is no longer isomorphic to the clean ones
    assert agg["n_groups"] >= 2


def test_top_bottom_row_forces_fallback():
    onto = _small_onto()
    onto.add(S.SubClassOf(S.OWL_THING, S.OWL_NOTHING))  # global poison
    idx = index_ontology(normalize(onto))
    comps = partition_index(idx)
    assert len(comps) == 1
    assert comps[0].idx is idx  # unpartitioned fallback


def test_top_lhs_row_forces_fallback():
    """⊤ ⊑ B fires on EVERY concept column — the partitioner must
    refuse to split; the result must still match the monolithic closure
    through the fallback."""
    onto = multiply_ontology(_small_onto(), 3)
    b = sorted(c.iri for c in onto.classes())[0]
    onto.add(S.SubClassOf(S.OWL_THING, S.Class(b)))
    idx = index_ontology(normalize(onto))
    comps = partition_index(idx)
    assert len(comps) == 1 and comps[0].idx is idx
    whole = _cpu(idx=idx).saturate()
    agg = saturate_components(comps, device="cpu")
    assert agg["derivations"] == whole.derivations


def test_text_partition_groups_copies():
    """n renamed copies collapse to ONE canonical group whose batched
    execution matches the monolithic closure."""
    from distel_tpu_torch.frontend.partition_text import partition_ofn_text

    onto = multiply_ontology(_small_onto(), 6)
    parts = partition_ofn_text(_ofn(onto))
    assert not parts.fallback
    assert sum(c for _, c in parts.groups) >= 6
    whole = _cpu(idx=index_ontology(normalize(onto))).saturate()
    total = 0
    for rep_text, count in parts.groups:
        ridx = index_ontology(normalize(parser.parse(rep_text)))
        total += saturate_isomorphic(ridx, count, device="cpu")["derivations"]
    assert total == whole.derivations


def test_text_partition_top_lhs_fallback():
    from distel_tpu_torch.frontend.partition_text import partition_ofn_text

    parts = partition_ofn_text("SubClassOf(owl:Thing B)\nSubClassOf(C D)")
    assert parts.fallback
    assert len(parts.groups) == 1
    assert partition_ofn_text(
        "EquivalentClasses(B owl:Thing)\nSubClassOf(C D)"
    ).fallback
    assert partition_ofn_text("HasKey(A r)\nSubClassOf(C D)").fallback
    ok = partition_ofn_text("SubClassOf(A owl:Thing)\nSubClassOf(C D)")
    assert not ok.fallback and len(ok.groups) == 2


def test_chain_target_role_stays_with_component():
    text = (
        "SubClassOf(A ObjectSomeValuesFrom(r owl:Thing))\n"
        "SubObjectPropertyOf(ObjectPropertyChain(r r) t)\n"
        "SubClassOf(X Y)"  # second, disjoint component
    )
    idx = index_ontology(normalize(parser.parse(text)))
    comps = partition_index(idx)
    for c in comps:
        assert (c.idx.chain_pairs >= 0).all()
        assert (c.idx.links >= 0).all()
    whole = _cpu(idx=idx).saturate()
    agg = saturate_components(comps, device="cpu")
    assert agg["derivations"] == whole.derivations


def test_partition_roles_only_corpus():
    idx = index_ontology(normalize(parser.parse("SubObjectPropertyOf(r s)")))
    assert partition_index(idx) == []


def test_cli_partition_subcommand(tmp_path, capsys):
    onto = multiply_ontology(_small_onto(), 4)
    f = tmp_path / "x4.ofn"
    f.write_text(_ofn(onto))
    assert cli.main(["partition", str(f), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["level"] == "text" and not out["text_fallback"]
    assert out["n_components"] >= 4
    whole = _cpu(idx=index_ontology(normalize(onto))).saturate()
    assert out["derivations"] == whole.derivations


def test_with_names_false_skips_tables(multiplied):
    _, idx = multiplied
    comps = partition_index(idx, with_names=False)
    assert comps and comps[0].idx.concept_names == []
    agg = saturate_components(comps, device="cpu")
    whole = _cpu(idx=idx).saturate()
    assert agg["derivations"] == whole.derivations


# ------------------------------------------------ parity with the reference


def _both_indexes(corpus: str):
    """The same corpus indexed by both packages: five copies of the
    small corpus, or (``mixed``) three copies beside a non-isomorphic
    corpus and a two-class one (singleton components)."""
    def build(pars, mult, norm, index, cls):
        onto = mult(pars.parse(SMALL), 5 if corpus == "copies" else 3)
        if corpus == "mixed":
            for ax in pars.parse(OTHER).axioms:
                onto.add(ax)
            onto.add(cls.SubClassOf(cls.Class("LoneX"), cls.Class("LoneY")))
        return index(norm(onto))

    from distel_tpu.owl import syntax as RS

    port = build(parser, multiply_ontology, normalize, index_ontology, S)
    ref = build(ref_parser, ref_multiply, ref_normalize, ref_index, RS)
    return port, ref


class _KeepRunState:
    """While active, ``jax.jit`` of a function named ``run`` (the
    reference's batched loop in ``_run_group``) keeps the packed S and
    R its calls return, in call order."""

    def __init__(self):
        self.states = []
        self._jit = jax.jit

    def __enter__(self):
        keep, real = self, self._jit

        def jit(fn, *a, **k):
            f = real(fn, *a, **k)
            if getattr(fn, "__name__", "") != "run":
                return f

            def wrapped(*args):
                out = f(*args)
                keep.states.append((np.asarray(out[0]), np.asarray(out[1])))
                return out
            return wrapped

        jax.jit = jit
        return self

    def __exit__(self, *exc):
        jax.jit = self._jit


def _same_idx(a, b):
    for k in IDX_ARRAYS:
        assert np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k))), k
    for k in IDX_SCALARS:
        assert getattr(a, k) == getattr(b, k), k


def _words(t):
    return np.asarray(t).astype(np.uint32)


@pytest.mark.parametrize("corpus", ["copies", "mixed"])
def test_components_and_closures_match_reference(corpus):
    idx, ridx = _both_indexes(corpus)
    comps, rcomps = partition_index(idx), ref_comp.partition_index(ridx)
    assert len(comps) == len(rcomps)
    for c, rc in zip(comps, rcomps):
        _same_idx(c.idx, rc.idx)
        assert np.array_equal(c.global_concepts, rc.global_concepts)
        assert c.signature() == rc.signature()
    before = dict(LAUNCHES)
    agg = saturate_components(comps, device="cpu", keep_state=True)
    assert dict(LAUNCHES) == before      # the CPU runs the plain versions
    with _KeepRunState() as kept:
        ragg = ref_comp.saturate_components(rcomps)
    for k in ("n_components", "n_groups", "derivations", "iterations_max"):
        assert agg[k] == ragg[k], k
    assert len(agg["groups"]) == len(ragg["groups"])
    batched = iter(kept.states)
    singles = 0
    # groups come in the first-appearance order of their signatures
    reps = {}
    for rc in rcomps:
        reps.setdefault(rc.signature(), rc.idx)
    assert len(reps) == len(agg["groups"])
    for g, rg, rep in zip(agg["groups"], ragg["groups"], reps.values()):
        for k in ("batch", "n_concepts_each", "n_links_each", "iterations",
                  "derivations"):
            assert g[k] == rg[k], k
        s, r = g["packed_s"], g["packed_r"]
        assert s.shape[0] == r.shape[0] == g["batch"]
        if g["batch"] > 1:
            want_s, want_r = next(batched)
        else:
            # a singleton runs the engine's own fixed point in both
            res = RefEngine(rep).saturate()
            want_s = _words(res.packed_s)[None]
            want_r = _words(res.packed_r)[None]
            singles += 1
        assert np.array_equal(s.numpy().view(np.uint32), _words(want_s))
        assert np.array_equal(r.numpy().view(np.uint32), _words(want_r))
    assert next(batched, None) is None
    assert any(g["batch"] > 1 for g in agg["groups"])
    if corpus == "mixed":
        assert singles >= 2


def test_budget_rounds_down_to_unroll():
    """A batched group's budget is ``max_iters - max_iters % unroll``
    (the reference's), where the engine's own fixed point rounds up:
    the copies converge at 10 iterations (unroll 2), so a budget of 9
    fails the batch and not the engine, and 11 runs it to 10."""
    idx, ridx = _both_indexes("copies")
    rep = partition_index(idx)[0].idx
    rrep = ref_comp.partition_index(ridx)[0].idx
    ok = saturate_isomorphic(rep, 3, max_iters=11, device="cpu")
    rok = ref_comp.saturate_isomorphic(rrep, 3, max_iters=11)
    assert ok["iterations"] == rok["iterations"] == 10
    assert ok["derivations"] == rok["derivations"]
    assert _cpu(idx=rep).saturate(9).iterations == 10      # rounds up
    with pytest.raises(RuntimeError) as got:
        saturate_isomorphic(rep, 3, max_iters=9, device="cpu")
    with pytest.raises(RuntimeError) as want:
        ref_comp.saturate_isomorphic(rrep, 3, max_iters=9)
    assert str(got.value) == str(want.value)
    assert "did not converge within 8 iterations" in str(got.value)


def test_unconverged_group_raises_reference_message():
    idx, ridx = _both_indexes("copies")
    rep = partition_index(idx)[0].idx
    rrep = ref_comp.partition_index(ridx)[0].idx
    with pytest.raises(RuntimeError) as got:
        saturate_isomorphic(rep, 4, max_iters=4, device="cpu")
    with pytest.raises(RuntimeError) as want:
        ref_comp.saturate_isomorphic(rrep, 4, max_iters=4)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("component group (B=4, nc=")


def test_warm_timing_runs_a_second_fixed_point():
    idx, ridx = _both_indexes("copies")
    rep = partition_index(idx)[0].idx
    rrep = ref_comp.partition_index(ridx)[0].idx
    got = saturate_isomorphic(rep, 3, warm_timing=True, device="cpu")
    want = ref_comp.saturate_isomorphic(rrep, 3, warm_timing=True)
    assert set(got) == set(want)
    assert "wall_warm_s" in got and got["wall_warm_s"] >= 0
    for k in ("batch", "n_concepts_each", "n_links_each", "iterations",
              "derivations"):
        assert got[k] == want[k], k
    calls = []
    real = BatchedSuperstep.initial_state

    def counting(self):
        calls.append(1)
        return real(self)

    BatchedSuperstep.initial_state = counting
    try:
        saturate_isomorphic(rep, 3, warm_timing=True, device="cpu")
        assert len(calls) == 2
        saturate_isomorphic(rep, 3, device="cpu")
        assert len(calls) == 3
    finally:
        BatchedSuperstep.initial_state = real


def test_batched_step_matches_engine_steps():
    """Every copy of a batched step equals the engine's own step, round
    for round (their frontiers too)."""
    idx, _ = _both_indexes("copies")
    rep = partition_index(idx)[0].idx
    eng = RowPackedSaturationEngine(rep, device="cpu", gate_chunks=False)
    batch = BatchedSuperstep(eng, 3)
    state = batch.initial_state()
    sp, rp = eng.initial_state()
    fr = bfr = None
    for _ in range(12):
        sp, rp, fr = eng.step(sp, rp, fr)
        bfr = batch.step(state, bfr)
        bs, br = batch.split(state)
        for k in range(3):
            assert torch.equal(bs[k], sp) and torch.equal(br[k], rp)
            assert np.array_equal(bfr.dirty_l_dev[k].numpy(), fr.dirty_l)
            assert np.array_equal(bfr.f4_dev[k].numpy(), fr.f4)
        assert bfr.changed == fr.changed


def test_live_tile_cr6_refused_in_a_batch():
    idx, _ = _both_indexes("copies")
    rep = partition_index(idx)[0].idx
    eng = RowPackedSaturationEngine(rep, device="cpu",
                                    cr6_tiles={"density_threshold": 100.0})
    if eng._t6 is None:
        pytest.fail("the corpus has no chain axioms to tile")
    with pytest.raises(ValueError, match="live-tile CR6"):
        BatchedSuperstep(eng, 2)


# ------------------------------------------------------------ cli partition


def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    wall = out.pop("wall_s")
    assert wall >= 0
    return out


@pytest.mark.parametrize("case", ["text", "galen_ofn", "galen_rdfxml",
                                  "owlxml", "fallback"])
def test_cli_partition_matches_reference(case, tmp_path, capsys):
    """Text level: the multiplied corpus and GALEN written as OFN; index
    level: GALEN as the RDF/XML it ships in and the multiplied corpus as
    OWL/XML; the fallback: a ⊤-LHS row."""
    from distel_tpu_torch.owl import owlxml, rdfxml

    path = tmp_path / "corpus"
    if case == "text":
        path.write_text(_ofn(multiply_ontology(_small_onto(), 4)))
    elif case == "galen_ofn":
        path.write_text(_ofn(rdfxml.parse_file(GALEN)))
    elif case == "galen_rdfxml":
        path = Path(GALEN)
    elif case == "owlxml":
        owlxml.write_file(multiply_ontology(_small_onto(), 3), str(path))
    else:
        onto = multiply_ontology(_small_onto(), 3)
        onto.add(S.SubClassOf(S.OWL_THING, S.Class("Findings")))
        path.write_text(_ofn(onto))
    got = _cli_json(cli.main, ["partition", str(path), "--device", "cpu"], capsys)
    want = _cli_json(ref_cli.main, ["partition", str(path)], capsys)
    assert got == want
    level = {"text": "text", "galen_ofn": "text", "fallback": "index"}
    assert got["level"] == level.get(case, "index")
    if case == "fallback":
        assert got["text_fallback"] and got["n_components"] == 1
    if case in ("text", "owlxml"):
        assert got["n_components"] > got["n_groups"]


def test_cli_partition_reads_max_iterations(tmp_path, capsys):
    """``max.iterations`` from --config reaches the batched budget (a
    budget below the copies' fixed point raises in both packages)."""
    f = tmp_path / "x3.ofn"
    f.write_text(_ofn(multiply_ontology(_small_onto(), 3)))
    props = tmp_path / "p.properties"
    props.write_text("max.iterations = 3\nmatmul.dtype = int8\n")
    with pytest.raises(RuntimeError) as got:
        cli.main(["partition", str(f), "--config", str(props), "--device", "cpu"])
    with pytest.raises(RuntimeError) as want:
        ref_cli.main(["partition", str(f), "--config", str(props)])
    assert str(got.value) == str(want.value)
    capsys.readouterr()


def test_cli_partition_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f = tmp_path / "a.ofn"
    f.write_text("SubClassOf(A B)")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(["partition", str(f)])


# --------------------------------------------------- the plain batched product


@pytest.mark.parametrize("nb,m,l,w,density", [
    (1, 1, 1, 1, 1.0), (5, 37, 70, 5, 0.2), (3, 64, 64, 8, 0.05),
    (4, 130, 96, 9, 0.0), (2, 10, 300, 3, 0.5),
])
def test_plain_batched_equals_a_loop_of_plain(nb, m, l, w, density):
    rng = np.random.default_rng(nb * 1000 + m)
    a = torch.from_numpy((rng.random((nb, m, l)) < density).astype(np.int8))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, (nb, l, w), dtype=np.int64)
                         .astype(np.int32))
    c0 = torch.from_numpy(rng.integers(-2**31, 2**31, (nb, m, w), dtype=np.int64)
                          .astype(np.int32))
    want = torch.stack([plain_packed_cols(a[k], b[k]) for k in range(nb)])
    assert torch.equal(plain_packed_cols_batched(a, b), want)
    want_acc = torch.stack([plain_packed_cols(a[k], b[k], c0[k].clone())
                            for k in range(nb)])
    assert torch.equal(plain_packed_cols_batched(a, b, c0.clone()), want_acc)
    # the wrapper on CPU tensors: the plain version, no launch counted
    before = dict(LAUNCHES)
    assert torch.equal(packed_cols_dense_batched(a, b), want)
    assert dict(LAUNCHES) == before


def test_batched_wrapper_reads_strided_copies():
    """B may be a window of a batched state: each copy's rows
    contiguous, the copies strided."""
    rng = np.random.default_rng(7)
    state = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 40, 4), dtype=np.int64)
                             .astype(np.int32))
    a = torch.from_numpy((rng.random((3, 6, 16)) < 0.3).astype(np.int8))
    b = state[:, 20:36]
    want = torch.stack([plain_packed_cols(a[k], b[k].contiguous()) for k in range(3)])
    assert torch.equal(packed_cols_dense_batched(a, b), want)
    with pytest.raises(ValueError, match="got A"):
        packed_cols_dense_batched(a, b[:, :8])
    # an out inside the strided span of B (past its first numel words)
    inside = state.view(-1)[300:372].view(3, 6, 4)
    with pytest.raises(ValueError, match="overlap"):
        packed_cols_dense_batched(a, b, out=inside)


# ------------------------------------------------------------ pins and keys


def test_partition_text_is_a_copy():
    """The text partitioner imports nothing of either package: the
    port's copy is the reference's byte for byte."""
    rel = Path("frontend") / "partition_text.py"
    assert (ROOT / "distel_tpu_torch" / rel).read_bytes() == \
        (ROOT / "distel_tpu" / rel).read_bytes()


@pytest.mark.parametrize("name", ["Component", "_group_slices", "partition_index"])
def test_host_half_is_a_copy(name):
    assert inspect.getsource(getattr(comp, name)) == \
        inspect.getsource(getattr(ref_comp, name))


@pytest.mark.parametrize("key,value", [
    ("coordinator.address", "localhost:1234"),
    ("num.processes", "2"),
    ("process.id", "0"),
])
def test_multi_process_keys_refused_by_name(key, value, tmp_path, capsys):
    """Each multi-controller key parses to the reference's field (the
    port joins a process group with them, ``parallel/mesh.py``).  The
    component plane has no sharded mode and, as the reference's ``cli
    partition``, does not thread the mesh keys: given a coordinator it
    runs as it does without one (it refused it by name before; the
    test keeps its name); the other two keys alone join nothing, in
    both packages."""
    from distel_tpu_torch import cli
    from distel_tpu_torch.parallel.mesh import setup

    props = tmp_path / "p.properties"
    props.write_text(f"{key} = {value}\n")
    ref = RefConfig.from_properties(str(props))
    attr = {"coordinator.address": "coordinator_address",
            "num.processes": "num_processes", "process.id": "process_id"}[key]
    assert str(getattr(ref, attr)) == value
    assert key in MULTI_PROCESS_KEYS
    cfg = ClassifierConfig.from_properties(str(props))
    assert getattr(cfg, attr) == getattr(ref, attr)
    if key == "coordinator.address":
        onto = tmp_path / "o.ofn"
        onto.write_text("SubClassOf(A B)\n")
        docs = []
        for extra in (["--config", str(props)], []):
            assert cli.main(["partition", str(onto), "--device", "cpu",
                             *extra]) == 0
            doc = json.loads(capsys.readouterr().out)
            doc.pop("wall_s")
            docs.append(doc)
        assert docs[0] == docs[1]
    else:
        assert setup(cfg) is None
