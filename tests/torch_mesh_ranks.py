"""What each rank of ``tests/test_torch_mesh.py``'s meshes runs.

The ranks are spawned processes (``distel_tpu_torch.parallel.mesh.
launch_local``), so this module imports the port only: no JAX, no test
module.  :func:`run_jobs` runs a list of jobs on one mesh — the group's
ranks inside a launch, a mesh of one in the calling process otherwise —
and returns plain data (numpy arrays, ints, lists) for the parent to
hold against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from distel_tpu_torch.core.engine import SaturationEngine
from distel_tpu_torch.core.indexing import index_ontology
from distel_tpu_torch.core.packed_engine import PackedSaturationEngine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import normalize
from distel_tpu_torch.owl import parser
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.parallel.mesh import build_mesh
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

ENGINES = {
    "rowpacked": RowPackedSaturationEngine,
    "packed": PackedSaturationEngine,
    "dense": SaturationEngine,
}


def tax_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def _index(text):
    return index_ontology(normalize(parser.parse(text)))


def _closure(res, x_major=False) -> dict:
    """The closure as plain data: the packed wire pair, or (``x_major``:
    the dense engine, whose reference packs x-major) the unpacked
    ``[x, a]`` / ``[x, l]`` views."""
    s, r = (res.s, res.r) if x_major else res.wire()
    return {"s": s, "r": r, "iterations": res.iterations,
            "derivations": res.derivations, "converged": res.converged}


def _saturate(mesh, device, job) -> dict:
    eng = ENGINES[job["engine"]](_index(job["text"]), device=device, mesh=mesh,
                                 **job.get("kw", {}))
    sp, rp = eng.initial_state()
    res = eng.saturate()
    out = _closure(res, x_major=job["engine"] == "dense")
    out.update(
        tax=tax_key(extract_taxonomy(res)),
        layout=(eng.nc, eng.nl, eng.unroll),
        state_shapes=[list(sp.shape), list(rp.shape)],
        gate_rounds=getattr(eng, "gate_rounds", None),
    )
    return out


def _steps(mesh, device, job) -> dict:
    """``rounds`` public steps from the initial state, each gathered."""
    eng = RowPackedSaturationEngine(_index(job["text"]), device=device,
                                    mesh=mesh, **job.get("kw", {}))
    sp, rp = eng.initial_state()
    fr, rounds = None, []
    for _ in range(job["rounds"]):
        sp, rp, fr = eng.step(sp, rp, fr)
        s, r = eng.gather_state(sp, rp)
        rounds.append((s.numpy().view(np.uint32).copy(),
                       r.numpy().view(np.uint32).copy(), bool(fr.changed)))
    return {"rounds": rounds}


def _observed(mesh, device, job) -> dict:
    eng = RowPackedSaturationEngine(_index(job["text"]), device=device,
                                    mesh=mesh, **job.get("kw", {}))
    events = []
    res = eng.saturate_observed(
        observer=lambda it, d, ch: events.append((it, d, bool(ch))))
    out = _closure(res)
    out["events"] = events
    return out


def frontier_stat(st) -> tuple:
    """A round's :class:`FrontierStats` less its host walls."""
    return (st.iteration, st.tier, st.density, st.rows_touched,
            st.total_rows, st.derivations, st.overflow, st.inflight,
            st.rounds_in_window)


def _adaptive(mesh, device, job) -> dict:
    """``saturate_observed`` with ``job["observe"]`` (the sparse tier, the
    pipeline, the fused window): the observer's events, each round's
    :class:`FrontierStats` less its walls, the closure, the rank's
    shard shapes, its collectives and the fused run's windows."""
    from distel_tpu_torch.parallel.shard_compat import COLLECTIVES

    eng = RowPackedSaturationEngine(_index(job["text"]), device=device,
                                    mesh=mesh, **job.get("kw", {}))
    events = []
    COLLECTIVES.reset()
    bitmatmul.reset_launches()
    res = eng.saturate_observed(
        observer=lambda it, d, ch: events.append((it, d, bool(ch))),
        **job["observe"])
    out = _closure(res)
    out.update(
        events=events,
        stats=[frontier_stat(st) for st in eng.frontier_rounds],
        shard_shapes=([list(t.shape) for t in res.shards]
                      if res.shards is not None else None),
        window=(eng.wl, eng.word_base),
        collectives=COLLECTIVES.snapshot()["total"]["calls"],
        fused=dict(eng.fused_run_stats),
        captured=sum(1 for w in eng.fused_window_stats() if w["captured_ops"]),
        host_reads=dict(eng.host_reads),
        launches={k: v for k, v in bitmatmul.LAUNCHES.items() if v},
    )
    return out


def _incremental(mesh, device, job) -> dict:
    """``job["steps"]`` (``("add" | "retract", text)``) through an
    ``IncrementalClassifier`` on the mesh (``mesh.devices`` of the
    group's size), then a snapshot (rank 0 writes ``job["snapshot"]``)
    and a restore from it on the mesh: per step the history record, the
    live closure (S and R over the live rows, x-major) and the taxonomy,
    and whether the engine in use holds the rank's window only."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.incremental import IncrementalClassifier

    cfg = ClassifierConfig(mesh_devices=mesh.size, **job.get("config", {}))
    inc = IncrementalClassifier(cfg, device=device)
    inc._FAST_PATH_MIN_CONCEPTS = 0
    steps = []

    def record(res, rec):
        n, nl = res.idx.n_concepts, res.idx.n_links
        eng = inc._base_engine
        return {
            "history": {k: rec[k] for k in INC_KEYS if k in rec},
            "s": res.s[:n, :n].copy(), "r": res.r[:n, :nl].copy(),
            "tax": tax_key(extract_taxonomy(res)),
            "window": ((eng.wl, eng.word_base, eng.n_shards)
                       if eng is not None else None),
            "shards": ([list(t.shape) for t in res.shards]
                       if res.shards is not None else None),
        }

    for op, text in job["steps"]:
        res = inc.add_text(text) if op == "add" else inc.retract(text)
        steps.append(record(res, inc.history[-1]))
    inc.snapshot(job["snapshot"])
    texts = [t if op == "add" else {"op": "retract", "text": t}
             for op, t in job["steps"]]
    back = IncrementalClassifier.restore(texts, job["snapshot"], cfg,
                                         device=device)
    return {"steps": steps,
            "restore": record(back.last_result, back.history[-1]),
            "mesh_size": inc._mesh.size}


#: history keys held equal across runs (the build records' signatures
#: key on the mesh)
INC_KEYS = ("path", "iterations", "new_derivations", "batch_axioms",
            "retracted_rows", "affected_concepts", "delta_bucketed",
            "delta_programs")


def _hybrid(mesh, device, job) -> dict:
    """The hybrid saturator (``backend.CRn = host``) through
    ``make_engine`` on the mesh: the closure, iterations, derivations and
    the taxonomy."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.runtime.classifier import make_engine

    cfg = ClassifierConfig(rule_backends=dict(job["backends"]))
    eng = make_engine(cfg, _index(job["text"]), device, mesh=mesh)
    res = eng.saturate()
    out = _closure(res)
    out.update(tax=tax_key(extract_taxonomy(res)),
               shards=([list(t.shape) for t in res.shards]
                       if res.shards is not None else None))
    return out


def _refusal(mesh, device, job) -> dict:
    """The error a call inside the group raises (None if it does not)."""
    try:
        build_mesh(job["n"], device=device)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


KINDS = {"saturate": _saturate, "steps": _steps, "observed": _observed,
         "adaptive": _adaptive, "incremental": _incremental,
         "hybrid": _hybrid, "refusal": _refusal}


def run_jobs(device, jobs) -> dict:
    """Run ``jobs`` (dicts with ``name`` and ``kind``) on the mesh of
    this process's group (a mesh of one outside a group); returns
    ``{name: result}`` and the mesh's size and rank."""
    torch.manual_seed(0)
    mesh = build_mesh(device=device)
    out = {"_mesh": (mesh.size, mesh.rank)}
    for job in jobs:
        out[job["name"]] = KINDS[job["kind"]](mesh, device, job)
    return out


def fail_on_rank_one(device):
    """A rank that raises: rank 1 before its first collective."""
    mesh = build_mesh(device=device)
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    t = torch.zeros(1)
    from distel_tpu_torch.parallel.shard_compat import psum_

    psum_(t, mesh)
    return mesh.rank
