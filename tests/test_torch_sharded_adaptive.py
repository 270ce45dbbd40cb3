"""The port's sharded sparse tier and its pipelined controller against
the reference's, on the CPU.

The reference's ``tests/test_sharded_adaptive.py`` cases at mesh sizes
1, 2 and 4: the chain-tailed GALEN shape with ``DisjointClasses(
TailChain3 TailChain7)`` (so CR5 runs in the sparse rounds), dense-only
at pipeline depth 2, and every post-warmup round forced sparse at
depths 1, 2 and 4.  The reference runs on the virtual CPU mesh that
``tests/conftest.py`` forces, with ``tests/test_torch_observed.py``'s
``REF_KW`` (its scanned formulation, one row chunk a write group: the
grouping the port's step writes in) and ``unroll=1``; the port runs its
plain versions on n gloo ranks (``testing/cpumesh.py``), all of a
size's runs in one launch (``tests/torch_mesh_ranks.py``), a size's
launch bounded by ``TIMEOUT_S``.  Held equal, tolerance 0 (the data are
bits), on every rank: the observer's ``(iteration, derivations,
changed)`` sequence, every ``FrontierStats`` less its walls, the
gathered S and R, iterations and derivations.  Each rank's state is
its word window only, and the sparse tier really ran.
"""

import numpy as np
import pytest
import torch

import jax
from distel_tpu.core.indexing import index_ontology
from distel_tpu.core.rowpacked_engine import RowPackedSaturationEngine as RefEngine
from distel_tpu.frontend.normalizer import normalize
from distel_tpu.frontend.ontology_tools import chain_tailed_ontology
from distel_tpu.owl import parser
from distel_tpu_torch.testing.cpumesh import cpu_mesh_run

import torch_mesh_ranks as ranks
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

#: a hang in a collective fails the launch well inside the suite's clock
TIMEOUT_S = 120.0
TEXT = chain_tailed_ontology(400, 12) + "\nDisjointClasses(TailChain3 TailChain7)"
REF_KW = dict(bucket=False, use_pallas=False, scan_chunks=True,
              scan_group_bytes=1)
ALL_SPARSE = {"density_threshold": 1.1, "hysteresis_rounds": 1}
SIZES = (1, 2, 4)

#: name -> saturate_observed kwargs (both packages)
CASES = {
    "dense-only-d2": dict(sparse_tail={"enable": False},
                          pipeline={"enable": True, "depth": 2}),
    **{f"sparse-d{d}": dict(sparse_tail=ALL_SPARSE,
                            pipeline={"enable": d > 1, "depth": d})
       for d in (1, 2, 4)},
}

_PORT = {}
_REF = {}


def port_run(n):
    """Every rank's results of the mesh of ``n`` (one launch a size)."""
    if n not in _PORT:
        jobs = [{"name": name, "kind": "adaptive", "text": TEXT,
                 "kw": {"unroll": 1}, "observe": kw}
                for name, kw in CASES.items()]
        if n == 1:
            _PORT[n] = [ranks.run_jobs(torch.device("cpu"), jobs)]
        else:
            _PORT[n] = cpu_mesh_run(n, ranks.run_jobs, jobs, timeout_s=TIMEOUT_S)
        for r, out in enumerate(_PORT[n]):
            assert out["_mesh"] == (n, r)
    return _PORT[n]


def ref_run(name, n):
    key = (name, n)
    if key not in _REF:
        idx = index_ontology(normalize(parser.parse(TEXT)))
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("c",))
        eng = RefEngine(idx, unroll=1, mesh=mesh, **REF_KW)
        events = []
        res = eng.saturate_observed(
            observer=lambda it, d, ch: events.append((it, d, bool(ch))),
            **CASES[name])
        _REF[key] = {
            "events": events,
            "stats": [ranks.frontier_stat(st) for st in eng.frontier_rounds],
            "s": np.asarray(res.packed_s).astype(np.uint32),
            "r": np.asarray(res.packed_r).astype(np.uint32),
            "iterations": res.iterations, "derivations": res.derivations,
            "unsat": len(res.unsatisfiable()),
        }
    return _REF[key]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_controller_matches_reference(name, n):
    """Every rank retires the reference's sharded run round for round
    and lands its closure."""
    want = ref_run(name, n)
    for out in port_run(n):
        got = out[name]
        assert got["events"] == want["events"]
        assert got["stats"] == want["stats"]
        assert np.array_equal(got["s"], want["s"])
        assert np.array_equal(got["r"], want["r"])
        assert (got["iterations"], got["derivations"]) == \
            (want["iterations"], want["derivations"])
        assert got["converged"]
    # the fixture's disjointness fired: CR5 runs in every compared run
    assert want["unsat"] > 0


@pytest.mark.parametrize("n", SIZES)
def test_sharded_sparse_tier_runs(n):
    """The forced runs run the sparse tier on the mesh (no silent dense
    fallback), with the tiers of the solo run, at every depth."""
    solo = port_run(1)[0]
    for out in port_run(n):
        for d in (1, 2, 4):
            tiers = [st[1] for st in out[f"sparse-d{d}"]["stats"]]
            assert tiers.count("sparse") >= 3
            assert tiers == [st[1] for st in solo[f"sparse-d{d}"]["stats"]]


@pytest.mark.parametrize("n", (2, 4))
def test_sharded_sparse_state_is_the_rank_window(n):
    """Each rank's state stays its word window through the sparse
    rounds — ``[nc, wc/n]`` words at base ``rank · wc/n`` — and its
    rounds exchange (the gathered closure is whole on every rank)."""
    for r, out in enumerate(port_run(n)):
        got = out["sparse-d1"]
        nc, words = got["s"].shape
        wl = words // n
        assert got["shard_shapes"][0] == [nc, wl]
        assert got["shard_shapes"][1][1] == wl
        assert got["window"] == (wl, r * wl)
        assert got["collectives"] > 0
