"""The port's observed fixed point against the reference's, round by round.

Both packages' row-packed engines run ``saturate_observed`` on this
host's CPU on the same corpora: the reference with ``bucket=False,
use_pallas=False, scan_chunks=True, scan_group_bytes=1`` (its scanned
formulation, which its sparse tier rides, with one row chunk a write
group: the grouping the port's dense step writes in, so every round's
state is comparable — ``tests/test_torch_gating.py`` pins the steps
themselves), the port on its plain versions.  Per run, everything must
be equal, tolerance 0:

* the observer's ``(iteration, derivations, changed)`` sequence;
* every round's ``FrontierStats`` less its host walls (tier, density,
  rows touched, derivations, overflow, pipeline occupancy), and so the
  tier string;
* the final packed S and R, iterations, derivations and convergence.

Configurations: the default controller; the forced tier (threshold
1.1, hysteresis 1 — every round after the first eligible); overflow (a
one-rung workspace of 8 rows); pipeline depths 1, 2 (the default) and
4; a
``state_observer`` (which forces depth 1; every round's state is held
equal too); a warm start from a mid-run state.  The goldens run the
forced configuration.  The dense engine's observed run is held to its
``saturate``.  Reference engines are shared per corpus (their compiled
programs are cached on the engine).
"""

import hashlib
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
from distel_tpu_torch.core.engine import SaturationEngine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.runtime.instrumentation import DISPATCH_EVENTS
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

GOLDEN = sorted((Path(__file__).parent / "golden").glob("*.ofn"))
REF_KW = dict(bucket=False, use_pallas=False, scan_chunks=True,
              scan_group_bytes=1)
FORCED = {"density_threshold": 1.1, "hysteresis_rounds": 1}

CORPORA = {
    "chain-tailed-400": lambda: chain_tailed_ontology(400, 12),
    "chain-tailed-4000": lambda: chain_tailed_ontology(4000, 28),
    "snomed-2k": lambda: snomed_shaped_ontology(n_classes=2000),
}

#: saturate_observed kwargs of each configuration (both packages);
#: "default" runs the default pipeline, depth 2
CONFIGS = {
    "default": dict(sparse_tail=True),
    "forced": dict(sparse_tail=FORCED),
    "overflow": dict(sparse_tail={**FORCED, "capacity_buckets": 1,
                                  "capacity_floor": 8}),
    "depth1": dict(sparse_tail=True, pipeline={"depth": 1}),
    "depth4": dict(sparse_tail=True, pipeline={"depth": 4}),
    "dense-only": dict(sparse_tail={"enable": False}),
}


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


@pytest.fixture(scope="module")
def corpus():
    """name -> (index, the shared reference engine)."""
    cache = {}

    def get(name):
        if name not in cache:
            idx = _index(CORPORA[name]())
            cache[name] = (idx, RefEngine(idx, **REF_KW))
        return cache[name]

    return get


def _stat(st):
    return (st.iteration, st.tier, st.density, st.rows_touched,
            st.total_rows, st.derivations, st.overflow, st.inflight,
            st.rounds_in_window)


def _digest(s, r, nl):
    """One round's state as a digest: packed S and R's first ``nl``
    rows, as uint32 words (the reference's R may carry padded rows)."""
    s = np.ascontiguousarray(np.asarray(s).astype(np.uint32))
    r = np.ascontiguousarray(np.asarray(r).astype(np.uint32)[:nl])
    return hashlib.sha1(s.tobytes() + r.tobytes()).hexdigest()


def _observed(engine, nl, with_states=False, **kw):
    obs, states = [], []
    if with_states:
        def state_observer(it, d, ch, s, r):
            if isinstance(s, torch.Tensor):
                s, r = s.numpy().view(np.uint32), r.numpy().view(np.uint32)
            states.append((it, _digest(s, r, nl)))

        kw["state_observer"] = state_observer
    res = engine.saturate_observed(
        observer=lambda it, d, ch: obs.append((it, d, ch)), **kw
    )
    return obs, [_stat(s) for s in engine.frontier_rounds], states, res


def _assert_same_run(got, want, nl):
    (pobs, pst, pstates, pres), (robs, rst, rstates, rres) = got, want
    assert pobs == robs
    assert "".join(s[1][0] for s in pst) == "".join(s[1][0] for s in rst)
    assert pst == rst
    assert pstates == rstates
    assert (pres.iterations, pres.derivations, pres.converged) == \
        (rres.iterations, rres.derivations, rres.converged)
    s, r = pres.wire()
    want_s = np.asarray(rres.packed_s).astype(np.uint32)
    want_r = np.asarray(rres.packed_r).astype(np.uint32)
    assert np.array_equal(s, want_s)
    assert np.array_equal(r, want_r[:nl]) and not want_r[nl:].any()


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("name", list(CORPORA))
def test_observed_run_matches_reference(name, config, corpus):
    idx, ref = corpus(name)
    port = RowPackedSaturationEngine(idx, device="cpu")
    assert port.unroll == ref.unroll
    before = DISPATCH_EVENTS.snapshot()
    got = _observed(port, port.nl, **CONFIGS[config])
    after = DISPATCH_EVENTS.snapshot()
    want = _observed(ref, port.nl, **CONFIGS[config])
    _assert_same_run(got, want, port.nl)
    tiers = [s[1] for s in got[1]]
    if config == "forced":
        assert tiers[0] == "dense" and "sparse" in tiers
    if config == "overflow":
        # busy rounds overflow the one 8-row rung and run dense
        assert any(s[6] and s[1] == "dense" for s in got[1])
    if config == "dense-only":
        assert set(tiers) == {"dense"} and {s[2] for s in got[1]} == {1.0}
    # the dispatch counters count what ran (other tests' runs may land
    # in between only if run concurrently, which the file never does)
    assert after["sparse_dispatches"] - before["sparse_dispatches"] == \
        tiers.count("sparse")
    assert after["dense_dispatches"] - before["dense_dispatches"] >= \
        tiers.count("dense")


@pytest.mark.parametrize("name", list(CORPORA))
def test_state_observer_forces_depth_one(name, corpus):
    """A ``state_observer`` sees every round's live state — equal in
    both packages round by round — and forces the synchronous loop
    (no round is dispatched while another is in flight)."""
    idx, ref = corpus(name)
    port = RowPackedSaturationEngine(idx, device="cpu")
    kw = dict(sparse_tail=True, pipeline={"depth": 4})
    got = _observed(port, port.nl, with_states=True, **kw)
    want = _observed(ref, port.nl, with_states=True, **kw)
    _assert_same_run(got, want, port.nl)
    assert got[2] and all(s[7] == 0 for s in got[1])


@pytest.mark.parametrize("name", list(CORPORA))
def test_warm_start_matches_reference(name, corpus):
    """``initial=`` a mid-run state (the port's round-2 state of a
    dense-only run, as wire words): both packages' observed runs from
    it agree round by round."""
    idx, ref = corpus(name)
    port = RowPackedSaturationEngine(idx, device="cpu")
    mid = {}

    def grab(it, d, ch, s, r):
        if not mid:
            mid["s"] = s.numpy().view(np.uint32).copy()
            mid["r"] = r.numpy().view(np.uint32).copy()

    port.saturate_observed(sparse_tail=False, state_observer=grab)
    init = (mid["s"], mid["r"])
    kw = dict(sparse_tail=True, initial=init)
    got = _observed(RowPackedSaturationEngine(idx, device="cpu"), port.nl, **kw)
    want = _observed(ref, port.nl, **kw)
    _assert_same_run(got, want, port.nl)
    full = RowPackedSaturationEngine(idx, device="cpu").saturate()
    assert np.array_equal(got[3].wire()[0], full.wire()[0])


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_forced_matches_reference(path):
    idx = _index(path.read_text())
    port = RowPackedSaturationEngine(idx, device="cpu")
    ref = RefEngine(idx, **REF_KW)
    got = _observed(port, port.nl, sparse_tail=FORCED)
    want = _observed(ref, port.nl, sparse_tail=FORCED)
    _assert_same_run(got, want, port.nl)
    full = port.saturate()
    assert np.array_equal(got[3].wire()[0], full.wire()[0])
    assert got[3].derivations == full.derivations


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("name", ["chain-tailed-400", "snomed-2k"])
def test_dense_engine_observed_equals_saturate(name, depth, corpus):
    idx, _ref = corpus(name)
    eng = SaturationEngine(idx, device="cpu")
    obs = []
    got = eng.saturate_observed(
        observer=lambda *a: obs.append(a), pipeline_depth=depth
    )
    want = SaturationEngine(idx, device="cpu").saturate()
    assert (got.iterations, got.derivations, got.converged) == \
        (want.iterations, want.derivations, want.converged)
    assert torch.equal(got.packed_s, want.packed_s)
    assert torch.equal(got.packed_r, want.packed_r)
    assert [it for it, _d, _c in obs] == list(
        range(eng.unroll, got.iterations + 1, eng.unroll)
    )
    assert obs[-1] == (got.iterations, got.derivations, False)


def test_fused_rounds_above_one_run_windows(corpus):
    """``fused_rounds`` K > 1 runs the fused window (held to the
    reference in ``tests/test_torch_fused.py``); degenerate values raise
    at build and per call, as the reference's do."""
    idx, ref = corpus("chain-tailed-400")
    port = RowPackedSaturationEngine(idx, device="cpu",
                                     fused_rounds={"rounds": 4})
    before = DISPATCH_EVENTS.snapshot()["fused_windows"]
    got = _observed(port, port.nl, sparse_tail=True)
    assert DISPATCH_EVENTS.snapshot()["fused_windows"] > before
    want = _observed(ref, port.nl, sparse_tail=True,
                     fused_rounds={"rounds": 4})
    _assert_same_run(got, want, port.nl)
    for bad in ({"rounds": 0}, {"nope": 1}):
        with pytest.raises(ValueError, match="fused_rounds"):
            RowPackedSaturationEngine(idx, device="cpu", fused_rounds=bad)
        with pytest.raises(ValueError, match="fused_rounds"):
            port.saturate_observed(fused_rounds=bad)


@pytest.mark.parametrize("bad", [{"capacity_buckets": 0},
                                 {"capacity_floor": 0},
                                 {"hysteresis_rounds": 0},
                                 {"nope": 1}])
def test_degenerate_sparse_cfg_rejected_at_build(bad, corpus):
    idx, _ref = corpus("chain-tailed-400")
    with pytest.raises(ValueError, match="sparse_tail"):
        RowPackedSaturationEngine(idx, device="cpu", sparse_tail=bad)
    with pytest.raises(ValueError, match="sparse_tail"):
        RefEngine(idx, bucket=False, use_pallas=False, sparse_tail=bad)


@pytest.mark.parametrize("floor", [8, 32, 64])
def test_capacity_rungs_are_the_references(floor):
    """The ladder the sparse tier's capacity rungs ride (the port's
    ``bucket_dim``, now the pinned copy of the reference's
    ``core/program_cache.py``) is the reference's ratio-2 ladder."""
    from distel_tpu.core.program_cache import bucket_dim as ref_bucket_dim
    from distel_tpu_torch.core.rowpacked_engine import bucket_dim

    for n in [-3, 0, 1, floor - 1, floor, floor + 1, 3 * floor,
              1000, 8191, 8192, 8193, 131_072, 200_000]:
        assert bucket_dim(n, 2.0, floor=floor) == ref_bucket_dim(
            n, 2.0, floor=floor
        ), n
