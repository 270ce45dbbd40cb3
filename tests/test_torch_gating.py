"""Frontier gating of the port's row-packed engine, round by round.

The reference engine's ``_step`` carries its frontier (the changed S
rows, the per-L-chunk R dirty flags, the rule-gate flags) from step to
step; the port carries the same frontier as host flags.  With the same
chunk plan — both engines at their defaults, or both given the same
``l_chunk`` / ``l_chunk_cr4`` — every round's S and R, the changed flag
and the per-L-chunk dirty flags must be equal, bit for bit, in the
window formulation (the reference unrolled) and in the live-tile CR6
(the reference scanned, ``scan_chunks=True``).  Both engines run on
this host's CPU (the reference with ``use_pallas=False``, the port's
plans on their plain version), both at ``unroll=1``.
"""

import random
from pathlib import Path

import jax
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
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.ops import bitmatmul
from test_engine_dense import _random_ontology
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)

GOLDEN = sorted((Path(__file__).parent / "golden").glob("*.ofn"))
#: the live-tile CR6, forced on, with small tiles so row tiles are many
TILES = {"density_threshold": 100.0, "tile_m": 16, "tile_l": 32}

#: (reference kwargs, port kwargs) of each chunk plan under test
MODES = {
    "windows": ({}, {}),
    "windows-lc64": ({"l_chunk": 64}, {"l_chunk": 64}),
    "windows-lc128-cr4-64": ({"l_chunk": 128, "l_chunk_cr4": 64},
                             {"l_chunk": 128, "l_chunk_cr4": 64}),
    "tiles-lc64": ({"l_chunk": 64, "scan_chunks": True, "cr6_tiles": TILES},
                   {"l_chunk": 64, "cr6_tiles": TILES}),
    "cr5-gate-lc64": ({"l_chunk": 64, "gate_chunks": True},
                      {"l_chunk": 64, "gate_chunks": True}),
    # the reference's scanned formulation with one chunk a write group:
    # the target the port's step meets round by round (its default
    # grouping may write several chunks at once), at the default plans
    "scanned-g1": ({"scan_chunks": True, "scan_group_bytes": 1}, {}),
}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _random_text(seed, bottom=False):
    rng = random.Random(seed * 104729 + 3)
    text = _random_ontology(rng, n_classes=40, n_roles=4, n_axioms=90)
    if bottom:
        text += "\nDisjointClasses(C1 C2)\nSubClassOf(C3 ObjectIntersectionOf(C1 C2))"
    return text


CORPORA = {
    "snomed-2k": lambda: snomed_shaped_ontology(n_classes=2000),
    "chain-tailed": lambda: chain_tailed_ontology(400, 12),
    "random-0": lambda: _random_text(0),
    "random-1": lambda: _random_text(1),
    "random-bottom-2": lambda: _random_text(2, bottom=True),
    "random-bottom-3": lambda: _random_text(3, bottom=True),
}


@pytest.fixture(scope="module")
def corpus_idx():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _index(CORPORA[name]())
        return cache[name]

    return get


def run_both_per_round(idx, mode):
    """Step both engines from the initial state until a step changes
    nothing, holding every round equal; returns (rounds, port engine,
    reference engine)."""
    rkw, pkw = MODES[mode]
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1, **rkw)
    port = RowPackedSaturationEngine(idx, device="cpu", unroll=1, **pkw)
    if "cr6_tiles" in pkw:
        assert (ref._tiles6 is None) == (port._tiles6 is None)
    assert (port.lc, port.n_lchunks) == (ref.lc, ref.n_lchunks)
    step = jax.jit(lambda sp, rp, d: ref._step(sp, rp, ref._masks, None, d))
    rs, rr = ref.initial_state()
    dirty = ref.initial_dirty()
    ps, pr = port.initial_state()
    fr = None
    rounds = 0
    while True:
        rs, rr, ch, dirty = step(rs, rr, dirty)
        ps, pr, fr = port.step(ps, pr, fr)
        rounds += 1
        want_s = np.asarray(rs).astype(np.uint32)
        want_r = np.asarray(rr).astype(np.uint32)
        got_s = ps.numpy().view(np.uint32)
        got_r = pr.numpy().view(np.uint32)
        assert np.array_equal(got_s, want_s), f"S differs in round {rounds}"
        nl = got_r.shape[0]
        assert np.array_equal(got_r, want_r[:nl]), f"R differs in round {rounds}"
        assert not want_r[nl:].any()
        assert fr.changed == bool(ch), f"changed differs in round {rounds}"
        assert np.array_equal(fr.dirty_l, np.asarray(dirty[1])), rounds
        if not fr.changed:
            return rounds, port, ref
        assert rounds < 200


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_per_round_matches_reference(corpus, mode, corpus_idx):
    rounds, port, ref = run_both_per_round(corpus_idx(corpus), mode)
    res = ref.saturate()
    assert res.iterations == rounds
    got = port.saturate()
    assert got.iterations == rounds and got.derivations == res.derivations


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_per_round_matches_reference(path):
    idx = _index(path.read_text())
    mode = "cr5-gate-lc64" if idx.has_bottom_axioms else "windows"
    rounds, port, ref = run_both_per_round(idx, mode)
    res, got = ref.saturate(), port.saturate()
    assert got.iterations == res.iterations == rounds
    assert got.derivations == res.derivations
    s, r = got.wire()
    assert np.array_equal(s, np.asarray(res.packed_s).astype(np.uint32))


@pytest.mark.parametrize(
    "text",
    [lambda: chain_tailed_ontology(4000, 28)]
    + [lambda p=p: p.read_text() for p in GOLDEN],
    ids=["chain-tailed-4000"] + [p.stem for p in GOLDEN],
)
def test_scanned_one_chunk_a_group_per_round(text):
    """The port's gated step against the reference's scanned
    formulation with one chunk a write group, at both engines' default
    chunk plans: every round equal (the target the observed controller's
    per-round records are held to)."""
    idx = _index(text())
    rounds, port, ref = run_both_per_round(idx, "scanned-g1")
    assert ref._scan_mode or not (len(idx.nf4) or len(idx.chain_pairs))
    assert rounds >= 1


def _plan_calls(monkeypatch):
    calls = {"n": 0}
    orig = bitmatmul.PackedColsMatmulPlan.__call__

    def spy(plan, a, b, out=None):
        calls["n"] += 1
        return orig(plan, a, b, out)

    monkeypatch.setattr(bitmatmul.PackedColsMatmulPlan, "__call__", spy)
    return calls


@pytest.mark.parametrize("mode", ["windows-lc64", "tiles-lc64"])
def test_windows_are_skipped_on_a_multi_round_corpus(mode, corpus_idx,
                                                     monkeypatch):
    """On the 2k corpus over many L-chunks, gating skips windows (or
    link tiles) in later rounds: every round accounts for each window
    of the plan as contracted or skipped, the products run equal the
    windows counted as contracted, and the closure and derivations are
    the reference's."""
    idx = corpus_idx("snomed-2k")
    rkw, pkw = MODES[mode]
    calls = _plan_calls(monkeypatch)
    gated = RowPackedSaturationEngine(idx, device="cpu", **pkw)
    res = gated.saturate()
    tot = gated.gate_totals()
    assert res.iterations > 3
    ran = sum(v["contracted"] for k, v in tot.items() if k != "cr5")
    skipped = sum(v["skipped"] for k, v in tot.items() if k != "cr5")
    assert skipped > 0 and calls["n"] == ran
    assert len(gated.gate_rounds) == res.iterations
    st = gated.plan_stats()
    per_round = st["cr4_windows"] + st["cr6_windows"] + st["cr6_link_tiles"]
    assert ran + skipped == per_round * res.iterations
    ref = RefEngine(idx, bucket=False, use_pallas=False, unroll=1, **rkw)
    want = ref.saturate()
    assert res.derivations == want.derivations
    assert np.array_equal(res.wire()[0], np.asarray(want.packed_s).astype(np.uint32))


@pytest.mark.parametrize("mode", ["windows-lc64", "tiles-lc64", "cr5-gate-lc64"])
def test_clean_frontier_launches_nothing(mode, monkeypatch):
    """A step from the fixed point with the frontier the last step left
    (nothing changed) contracts no window and no tile, runs no gated
    CR5, changes nothing and reports nothing changed."""
    idx = _index((Path(__file__).parent / "golden" / "19-bottom-chain.ofn")
                 .read_text() + "\n" + chain_tailed_ontology(60, 6))
    port = RowPackedSaturationEngine(idx, device="cpu", **MODES[mode][1])
    sp, rp = port.initial_state()
    fr = None
    while fr is None or fr.changed:
        sp, rp, fr = port.step(sp, rp, fr)
    assert not (fr.dirty_l.any() or fr.f4.any() or fr.f6.any() or fr.fd6.any())
    calls = _plan_calls(monkeypatch)
    before = (sp.clone(), rp.clone())
    sp, rp, again = port.step(sp, rp, fr)
    assert calls["n"] == 0 and not again.changed
    assert torch.equal(sp, before[0]) and torch.equal(rp, before[1])
    last = port.gate_rounds[-1]
    assert last["cr4"][0] == last["cr6"][0] == last["cr6_tiles"][0] == 0
    if mode == "cr5-gate-lc64":
        assert port._bottom and last["cr5"] is False
