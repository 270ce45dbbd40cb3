"""The port's packed engine against the reference packed engine.

Both run on the same index (the reference's; the frontend tests pin the
port's index equal to it), the reference as
``PackedSaturationEngine(idx, use_pallas=False)`` (its XLA contract of
``_andor_kernel``) and the port on ``device="cpu"``, where its
``packed_andor`` plans take their plain PyTorch version.  ``packed_s``,
``packed_r`` (x-major, bit for bit), ``iterations`` (both round up to
the same ``unroll``) and ``derivations`` must be equal.  The two
engines lay B out in different bit orders, so plans are never compared
here: only closures.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.core.engine import SaturationEngine as RefDense
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.packed_engine import PackedSaturationEngine as RefPacked
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    snomed_shaped_ontology,
    synthetic_ontology,
)
from distel_tpu.owl import parser
from distel_tpu_torch.core.packed_engine import PackedSaturationEngine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.ops.bitmatmul import LAUNCHES
from distel_tpu_torch.runtime.checkpoint import state_from_reference
from test_packed_engine import BOTTOM_ONTO
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden"

CORPORA = {
    "bottom": lambda: BOTTOM_ONTO,
    "synthetic": lambda: synthetic_ontology(
        n_classes=300, n_anatomy=50, n_locations=35, n_definitions=20
    ),
    "snomed": lambda: snomed_shaped_ontology(n_classes=400, seed=5),
    "no-links": lambda: "SubClassOf(A B)\nSubClassOf(B C)",
    "links-no-chains": lambda: (
        "SubClassOf(A ObjectSomeValuesFrom(r B))\n"
        "SubClassOf(ObjectSomeValuesFrom(r B) C)\nSubClassOf(C D)"
    ),
    "bottom-chain": lambda: (GOLDEN / "19-bottom-chain.ofn").read_text(),
}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


@pytest.fixture(scope="module")
def indexes():
    return {name: _index(make()) for name, make in CORPORA.items()}


def _assert_same(ref_res, port_res):
    s, r = port_res.wire()
    assert not port_res.transposed
    assert np.array_equal(np.asarray(ref_res.packed_s).astype(np.uint32), s)
    assert np.array_equal(np.asarray(ref_res.packed_r).astype(np.uint32), r)
    assert ref_res.iterations == port_res.iterations
    assert ref_res.derivations == port_res.derivations
    assert port_res.converged


#: temporary budgets that split each corpus's step into a few to a few
#: dozen row chunks (the wider corpora need more bytes per row)
CHUNK_BUDGET = {"synthetic": 1 << 17, "snomed": 1 << 17}


@pytest.mark.parametrize("chunked", [False, True], ids=["one-chunk", "chunks"])
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_engine_matches_reference(indexes, corpus, chunked):
    """Every rule (CR1-CR6, ⊥, domain/range, chains) and the empty-plan
    guards; a tiny temporary budget splits the step into many row
    chunks and must not move a bit."""
    idx = indexes[corpus]
    budget = CHUNK_BUDGET.get(corpus, 1 << 12) if chunked else None
    port = PackedSaturationEngine(idx, device="cpu", temp_budget_bytes=budget)
    if chunked:
        assert port.plan_stats()["chunks"] > 1
    before = dict(LAUNCHES)
    _assert_same(RefPacked(idx, use_pallas=False).saturate(), port.saturate())
    assert dict(LAUNCHES) == before      # CPU: the plain version, no launch


def test_nf4_without_links_derives_only_what_the_rules_derive():
    """∃r.A ⊑ B axioms with no links: CR4 cannot fire.  The port leaves
    their targets out of its scatter and equals the reference's dense
    engine (and the oracle's closure); the reference packed engine
    broadcasts its one CR1 source column onto the nf4 target here and
    derives A ⊑ Animal, which no rule entails."""
    idx = _index(
        "SubClassOf(ObjectSomeValuesFrom(hasParent Animal) Animal)\n"
        "SubClassOf(A B)"
    )
    assert idx.n_links == 0 and len(idx.nf4) > 0
    got = PackedSaturationEngine(idx, device="cpu").saturate()
    dense = RefDense(idx).saturate()
    n, nl = idx.n_concepts, idx.n_links
    assert (got.s[:n, :n] == dense.s[:n, :n]).all()
    assert (got.r[:n, :nl] == dense.r[:n, :nl]).all()
    assert got.derivations == dense.derivations
    assert got.iterations == dense.iterations
    a, b, animal = (idx.concept_ids[x] for x in ("A", "B", "Animal"))
    assert got.subsumers(a) >= {b} and animal not in got.subsumers(a)


@pytest.mark.parametrize("k", [0, 1, 3])
def test_step_parity_from_the_reference_state(indexes, k):
    """The reference's state after k steps, carried across, goes through
    one port step to the reference's state after k + 1."""
    idx = indexes["bottom"]
    ref = RefPacked(idx, use_pallas=False)
    sp, rp = ref.initial_state()
    for _ in range(k):
        sp, rp = ref.step(sp, rp)
    want = ref.step(sp, rp)
    port = PackedSaturationEngine(idx, device="cpu", temp_budget_bytes=1 << 12)
    got_s, got_r, changed = port.step(
        *state_from_reference(np.asarray(sp), np.asarray(rp), "cpu")
    )
    assert np.array_equal(got_s.numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(got_r.numpy().view(np.uint32), np.asarray(want[1]))
    moved = not (np.array_equal(np.asarray(sp), np.asarray(want[0]))
                 and np.array_equal(np.asarray(rp), np.asarray(want[1])))
    assert bool(changed) == moved


@pytest.mark.parametrize("corpus", ["bottom", "snomed", "bottom-chain"])
def test_packed_equals_rowpacked(indexes, corpus):
    """The port's two engines give the same x-major closure, padded rows
    and columns included, and the same derivation count."""
    idx = indexes[corpus]
    packed = PackedSaturationEngine(idx, device="cpu").saturate()
    row = RowPackedSaturationEngine(idx, device="cpu").saturate()
    assert row.transposed and not packed.transposed
    assert packed.s.shape == row.s.shape and packed.r.shape == row.r.shape
    assert (packed.s == row.s).all() and (packed.r == row.r).all()
    assert packed.derivations == row.derivations


def test_resume_and_partial_runs(indexes):
    idx = indexes["snomed"]
    eng = PackedSaturationEngine(idx, device="cpu")
    full = eng.saturate()
    again = eng.saturate(initial=(full.s, full.r))
    assert again.derivations == 0 and again.iterations == eng.unroll
    assert (again.s == full.s).all()
    part = eng.saturate(2, allow_incomplete=True)
    assert not part.converged and part.iterations == 4     # rounded to unroll
    with pytest.raises(RuntimeError, match="did not converge"):
        eng.saturate(2)
    ref = RefPacked(idx, use_pallas=False)
    ref_part = ref.saturate(2, allow_incomplete=True)
    _ = ref_part.s
    resumed = eng.saturate(initial=(part.s, part.r))
    _assert_same(ref.saturate(initial=(ref_part.s, ref_part.r)), resumed)
    assert (resumed.s == full.s).all() and (resumed.r == full.r).all()


def test_refusals(indexes):
    idx = indexes["bottom"]
    eng = PackedSaturationEngine(idx, device="cpu")
    res = eng.saturate()
    with pytest.raises(TypeError, match="unpack=True"):
        eng.embed_state(*res.wire())
    with pytest.raises(TypeError, match="unpack=True"):
        eng.embed_state(res.packed_s, res.packed_r)
    big = np.zeros((eng.nc + 32, eng.nc + 32), bool)
    with pytest.raises(ValueError, match="exceeds"):
        eng.embed_state(big, np.zeros((eng.nc, eng.nl), bool))
    # the row-sharded mode takes a parallel.mesh.Mesh, nothing else
    with pytest.raises(TypeError, match="mesh"):
        PackedSaturationEngine(idx, device="cpu", mesh=object())
    # bucket=True is the reference's shape-only bucketing now (no refusal)
    bucketed = PackedSaturationEngine(idx, device="cpu", bucket=True)
    assert bucketed.nc > idx.n_concepts and bucketed.nl > idx.n_links
    assert not PackedSaturationEngine.accepts_wire_state
    assert RowPackedSaturationEngine.accepts_wire_state
    assert isinstance(res.packed_s, torch.Tensor) and res.packed_s.dtype == torch.int32
