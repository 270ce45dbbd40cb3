"""The port's row-packed engine against the reference engine.

Both run on the same index (the reference's; the frontend tests pin the
port's index equal to it), the reference as
``RowPackedSaturationEngine(idx, bucket=False, use_pallas=False)`` and
the port on ``device="cpu"``, where its packed-columns plans take their
plain PyTorch version.  ``packed_s``, ``packed_r`` and ``derivations``
must be equal bit for bit.

Both engines are built with ``unroll=1`` (one convergence check a
step), so the iteration count is not rounded up to an unroll multiple
(``tests/test_torch_classify.py`` holds the default unroll to the
reference's).  Both engines gate their windows
on the frontier, and at their default budgets both plan one chunk a
rule over one L-chunk here, so the iteration counts agree too, and the tests hold
them equal (``tests/test_torch_gating.py`` holds every round equal).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu.owl import parser
from distel_tpu_torch.core import rowpacked_engine as port_engine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.ops.bitmatmul import LAUNCHES
from distel_tpu_torch.runtime.checkpoint import state_from_reference
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden"
#: force-active live-tile CR6 (the density fallback is its own case)
TILES_ON = {"density_threshold": 100.0}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _assert_same(ref_res, port_res):
    s, r = port_res.wire()
    assert np.array_equal(np.asarray(ref_res.packed_s).astype(np.uint32), s)
    assert np.array_equal(np.asarray(ref_res.packed_r).astype(np.uint32), r)
    assert ref_res.derivations == port_res.derivations
    assert port_res.converged
    assert ref_res.iterations == port_res.iterations


@pytest.fixture(scope="module")
def snomed_idx():
    return _index(snomed_shaped_ontology(n_classes=600))


@pytest.fixture(scope="module")
def chain_idx():
    return _index(chain_tailed_ontology(400, 12))


@pytest.mark.parametrize("tiles", [None, TILES_ON], ids=["windows", "tiles"])
@pytest.mark.parametrize("corpus", ["snomed_idx", "chain_idx"])
def test_engine_matches_reference(corpus, tiles, request):
    """CR6 through the live-tile schedule in both engines (``TILES_ON``
    forces it in the reference's scanned formulation) and through the
    window formulation in both."""
    idx = request.getfixturevalue(corpus)
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1,
                    scan_chunks=tiles is not None, cr6_tiles=tiles)
    assert (ref._tiles6 is not None) == (tiles is not None)
    port = RowPackedSaturationEngine(idx, device="cpu", unroll=1,
                                     cr6_tiles=tiles)
    assert (port._tiles6 is not None) == (tiles is not None)
    before = dict(LAUNCHES)
    _assert_same(ref.saturate(), port.saturate())
    # on the CPU the plans take their plain version: no kernel launch
    assert dict(LAUNCHES) == before


def test_density_fallback_keeps_windows(snomed_idx):
    """The default threshold leaves this corpus on the window
    formulation, with the decision recorded, and the closure unchanged."""
    port = RowPackedSaturationEngine(
        snomed_idx, device="cpu", unroll=1, cr6_tiles={"enable": True}
    )
    assert port._tiles6 is None
    assert port.cr6_tiles_stats["reason"] == "density above threshold"
    ref = RefEngine(snomed_idx, bucket=False, use_pallas=False, unroll=1)
    _assert_same(ref.saturate(), port.saturate())


@pytest.mark.parametrize(
    "name", ["10-bottom", "11-disjoint", "19-bottom-chain", "21-range-bottom"]
)
def test_bottom_propagation_matches_reference(name):
    """CR5: ⊥ reaches back along existential links (a fixture without
    links needs no CR5: ⊥ arrives through CR1/CR2 alone)."""
    idx = _index((GOLDEN / f"{name}.ofn").read_text())
    assert idx.has_bottom_axioms
    port = RowPackedSaturationEngine(idx, device="cpu", unroll=1)
    assert port._bottom == (idx.n_links > 0)
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1)
    res = port.saturate()
    _assert_same(ref.saturate(), res)
    assert res.unsatisfiable()


def test_pallas_interpret_is_the_oracle():
    """The reference with its Pallas kernel bodies run by the
    interpreter, at a tiny size, equals the port's plain version."""
    text = snomed_shaped_ontology(n_classes=120, seed=3)
    idx = _index(text)
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1,
                    mm_opts={"use_xla": False, "interpret": True})
    port = RowPackedSaturationEngine(idx, device="cpu", unroll=1)
    _assert_same(ref.saturate(), port.saturate())


def test_small_temp_budget_chunks_identically(chain_idx):
    """A tiny temporary budget forces many word blocks, row chunks and
    short windows; the closure does not move."""
    ref = RefEngine(chain_idx, bucket=False, use_pallas=False, unroll=1)
    port = RowPackedSaturationEngine(chain_idx, device="cpu", unroll=1,
                                     temp_budget_bytes=1 << 12)
    stats = port.plan_stats()
    assert stats["word_block"] < stats["wc"]
    _assert_same(ref.saturate(), port.saturate())


@pytest.mark.parametrize("tiles", [None, TILES_ON], ids=["windows", "tiles"])
@pytest.mark.parametrize("corpus", ["snomed_idx", "chain_idx"])
def test_many_windows_accumulate_in_place(corpus, tiles, request, monkeypatch):
    """A small temporary budget cuts CR4/CR6 into many short windows (or
    link tiles), each ORed into one accumulator in place (``out=``); the
    closure equals the reference's bit for bit."""
    idx = request.getfixturevalue(corpus)
    calls = {"fresh": 0, "accumulate": 0}
    orig = bitmatmul.PackedColsMatmulPlan.__call__

    def spy(plan, a, b, out=None):
        calls["accumulate" if out is not None else "fresh"] += 1
        return orig(plan, a, b, out)

    monkeypatch.setattr(bitmatmul.PackedColsMatmulPlan, "__call__", spy)
    port = RowPackedSaturationEngine(idx, device="cpu", unroll=1,
                                     cr6_tiles=tiles,
                                     temp_budget_bytes=1 << 10)
    stats = port.plan_stats()
    assert (stats["cr4_windows"] + stats["cr6_windows"]
            > stats["cr4_chunks"] + stats["cr6_chunks"])
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1,
                    scan_chunks=tiles is not None, cr6_tiles=tiles)
    _assert_same(ref.saturate(), port.saturate())
    assert calls["accumulate"] > 0


def test_rule_subset_and_unknown_rule(chain_idx):
    ref = RefEngine(chain_idx, bucket=False, use_pallas=False, unroll=1,
                    rules=frozenset({"CR1", "CR2"}))
    port = RowPackedSaturationEngine(chain_idx, device="cpu", unroll=1,
                                     rules=frozenset({"CR1", "CR2"}))
    _assert_same(ref.saturate(), port.saturate())
    with pytest.raises(ValueError, match="unknown rules"):
        RowPackedSaturationEngine(chain_idx, device="cpu", rules={"CR9"})


def test_resume_from_reference_partial_state(snomed_idx):
    """A reference run cut after two rounds, carried across with
    ``state_from_reference``, finishes to the reference's full closure,
    and counts the derivations the reference counts when it resumes
    from the same state (both count from the embedded state)."""
    ref = RefEngine(snomed_idx, bucket=False, use_pallas=False, unroll=1)
    full = ref.saturate()
    part = ref.saturate(2, allow_incomplete=True)
    assert not part.converged
    packed = (np.asarray(part.packed_s), np.asarray(part.packed_r))
    port = RowPackedSaturationEngine(snomed_idx, device="cpu", unroll=1)
    res = port.saturate(initial=state_from_reference(*packed, "cpu"))
    s, r = res.wire()
    assert np.array_equal(np.asarray(full.packed_s).astype(np.uint32), s)
    assert np.array_equal(np.asarray(full.packed_r).astype(np.uint32), r)
    _assert_same(ref.saturate(initial=packed), res)
    assert res.iterations < full.iterations


def test_incomplete_run_raises_unless_allowed(chain_idx):
    port = RowPackedSaturationEngine(chain_idx, device="cpu")
    with pytest.raises(RuntimeError, match="did not converge"):
        port.saturate(2)
    res = port.saturate(2, allow_incomplete=True)
    assert not res.converged and res.iterations == 2


def test_cuda_temp_budget_is_sized_for_the_card(monkeypatch):
    """2 GiB on an 80 GB card (1/32 of it, clamped), 256 MiB on the CPU."""

    class Props:
        total_memory = 80 * (1 << 30)

    monkeypatch.setattr(
        port_engine.torch.cuda, "get_device_properties", lambda d: Props
    )
    import torch

    assert port_engine.default_temp_budget(torch.device("cuda")) == 2 << 30
    assert port_engine.default_temp_budget(torch.device("cpu")) == 256 << 20


def test_live_tile_write_groups_stay_within_the_budget():
    """Many short role runs (renamed copies of the OpenGALEN module)
    make many padded row tiles; the live-tile CR6 cuts its deferred
    write groups so no group's [tiles × tile_m, wc] output passes the
    temporary budget; the closure and the iteration count are those of
    the reference's live-tile CR6 with the same ``unroll``."""
    from distel_tpu.frontend.ontology_tools import multiply_ontology
    from distel_tpu.owl import rdfxml

    galen = rdfxml.parse_file(str(GOLDEN.parent / "corpora" / "galen_module_jia.owl"))
    idx = index_ontology(normalize(multiply_ontology(galen, 12, crossed=True)))
    budget = 1 << 20
    port = RowPackedSaturationEngine(idx, device="cpu", cr6_tiles=TILES_ON,
                                     temp_budget_bytes=budget, unroll=2)
    assert port._tiles6 is not None
    groups = port._t6["groups"]
    tile_rows = [(rt1 - rt0) * port._tiles6.tile_m for rt0, rt1, _p, _o in groups]
    assert len(groups) > 1
    assert max(tile_rows) * 4 * port.wc <= budget
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=2,
                    scan_chunks=True, cr6_tiles=TILES_ON)
    assert ref._tiles6 is not None
    _assert_same(ref.saturate(), port.saturate())
