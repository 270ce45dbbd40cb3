"""The port's incremental plane on a mesh against the reference's, on
the CPU, and ``cli stream`` on a mesh.

The traffic of ``tests/torch_incremental_parity.py`` at a small size: a
SNOMED-shaped base without its range axiom (retraction is refused under
one, in both packages), a class-only delta, a link delta (a new subrole
with ∃-assertions over it), a role delta between two base roles (a
rebind of the base engine), the retraction of the class-only delta, and
a snapshot restored.  The port runs ``IncrementalClassifier(
ClassifierConfig(mesh_devices=n))`` on n gloo ranks (one launch a size,
``tests/torch_mesh_ranks.py``, bounded by ``TIMEOUT_S``); every rank's
every step — the history record (``path``, iterations, derivations,
rows), S and R over the live universe, the taxonomy — is held, tolerance
0, to the reference's ``IncrementalClassifier`` with a mesh of the same
size on the virtual CPU mesh ``tests/conftest.py`` forces.  The exact
layout (``shape_buckets = false``, the contract the incremental parity
tests pin) runs at mesh sizes 1, 2 and 4.  The default, bucketed layout
is held to the reference's solo run: the reference's bucketed mesh run
takes 12 iterations for the role delta where its solo run takes 14
(``ROADMAP.md``, Reference caveats), and the port takes 14 on the mesh
as solo.  Then the snapshot a mesh's rank 0 wrote restores solo, and
``cli stream`` with ``mesh.devices = 2`` prints what ``cli stream``
prints.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu.config import ClassifierConfig as RefConfig
from distel_tpu.core.incremental import IncrementalClassifier as RefInc
from distel_tpu.frontend.ontology_tools import snomed_shaped_ontology
from distel_tpu.runtime.taxonomy import extract_taxonomy as ref_taxonomy
from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
from distel_tpu_torch.testing.cpumesh import cpu_mesh_run

import torch_mesh_ranks as ranks
from torch_ref_registry import reference_registry_as_found  # noqa: F401 (a fixture)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
#: a hang in a collective fails the launch well inside the suite's clock
TIMEOUT_S = 120.0

BASE = "\n".join(
    ln for ln in snomed_shaped_ontology(n_classes=600).splitlines()
    if not ln.startswith("ObjectPropertyRange(")
) + "\n"
_FINDS = sorted(set(re.findall(r"\bFind\d+\b", BASE)), key=lambda s: int(s[4:]))
_ROLES = sorted(set(re.findall(r"\battr\d+\b", BASE)), key=lambda s: int(s[4:]))
CLASS_DELTA = "\n".join(
    f"SubClassOf(IncDelta{i} {_FINDS[(i * 7) % len(_FINDS)]})" for i in range(20))
LINK_DELTA = (
    "SubObjectPropertyOf(incNewRole attr0)\n"
    + "\n".join(f"SubClassOf(IncR{i} ObjectSomeValuesFrom(incNewRole "
                f"{_FINDS[(i * 11) % len(_FINDS)]}))" for i in range(10))
    + f"\nSubClassOf(ObjectSomeValuesFrom(incNewRole {_FINDS[11]}) IncRoleHit)"
)
ROLE_DELTA = f"SubObjectPropertyOf({_ROLES[1]} {_ROLES[2]})"
STEPS = [("add", BASE), ("add", CLASS_DELTA), ("add", LINK_DELTA),
         ("add", ROLE_DELTA), ("retract", CLASS_DELTA)]
STEP_NAMES = ["base", "class-only", "link", "role", "retract", "restore"]

#: layout -> (port config, mesh sizes, the reference's mesh size or None
#: for its solo run)
LAYOUTS = {
    "exact": ({"shape_buckets": False}, (1, 2, 4), "mesh"),
    "bucketed": ({}, (2,), None),
}

_PORT = {}
_REF = {}


def _jobs(n, tmp):
    return [{"name": layout, "kind": "incremental", "steps": STEPS,
             "config": cfg, "snapshot": str(tmp / f"{layout}-{n}.npz")}
            for layout, (cfg, sizes, _ref) in LAYOUTS.items() if n in sizes]


def port_run(n, tmp_path_factory):
    if n not in _PORT:
        tmp = tmp_path_factory.mktemp(f"mesh{n}")
        jobs = _jobs(n, tmp)
        if n == 1:
            _PORT[n] = [ranks.run_jobs(torch.device("cpu"), jobs)]
        else:
            _PORT[n] = cpu_mesh_run(n, ranks.run_jobs, jobs, timeout_s=TIMEOUT_S)
        _PORT[n][0]["_tmp"] = tmp
    return _PORT[n]


def ref_run(layout, n, tmp_path_factory):
    """The reference's steps, snapshot and restore: on a mesh of ``n``,
    or (``n`` None) solo."""
    key = (layout, n)
    if key not in _REF:
        cfg = RefConfig(mesh_devices=n or 0,
                        shape_buckets=LAYOUTS[layout][0].get("shape_buckets", True))
        inc = RefInc(cfg)
        inc._FAST_PATH_MIN_CONCEPTS = 0
        out = []

        def record(res, rec):
            n_c, n_l = res.idx.n_concepts, res.idx.n_links
            return {"history": {k: rec[k] for k in ranks.INC_KEYS if k in rec},
                    "s": np.asarray(res.s)[:n_c, :n_c].copy(),
                    "r": np.asarray(res.r)[:n_c, :n_l].copy(),
                    "tax": ranks.tax_key(ref_taxonomy(res))}

        for op, text in STEPS:
            res = inc.add_text(text) if op == "add" else inc.retract(text)
            out.append(record(res, inc.history[-1]))
        path = tmp_path_factory.mktemp("ref") / "snap.npz"
        inc.snapshot(str(path))
        texts = [t if op == "add" else {"op": "retract", "text": t}
                 for op, t in STEPS]
        back = RefInc.restore(texts, str(path), cfg)
        out.append(record(back.last_result, back.history[-1]))
        _REF[key] = out
    return _REF[key]


def _assert_step(got, want):
    for k, v in want["history"].items():
        if k in got["history"]:
            assert got["history"][k] == v, k
    assert got["history"]["path"] == want["history"]["path"]
    assert np.array_equal(got["s"], want["s"])
    assert np.array_equal(got["r"], want["r"])
    assert got["tax"] == want["tax"]


CASES = [(layout, n, i) for layout, (_c, sizes, _r) in LAYOUTS.items()
         for n in sizes for i in range(len(STEP_NAMES))]


@pytest.mark.parametrize("layout,n,step", CASES,
                         ids=[f"{lay}-{n}-{STEP_NAMES[i]}" for lay, n, i in CASES])
def test_incremental_mesh_step_matches_reference(layout, n, step,
                                                 tmp_path_factory):
    """Every rank's step equals the reference's step (on a mesh of the
    same size, or solo: see the module docstring); the engines hold the
    rank's word window, and the delta's round-robin hands windows from
    engine to engine."""
    want = ref_run(layout, n if LAYOUTS[layout][2] == "mesh" else None,
                   tmp_path_factory)[step]
    outs = port_run(n, tmp_path_factory)
    for r, out in enumerate(outs):
        rec = out[layout]
        assert rec["mesh_size"] == n
        got = rec["steps"][step] if step < len(STEPS) else rec["restore"]
        _assert_step(got, want)
        wl, base, shards = got["window"]
        assert shards == n and base == r * wl
        if n > 1:
            assert got["shards"][0][1] == wl


@pytest.mark.parametrize("layout,n", [(lay, n) for lay, (_c, sizes, _r) in LAYOUTS.items()
                                      for n in sizes if n > 1])
def test_mesh_snapshot_restores_solo(layout, n, tmp_path_factory):
    """The snapshot rank 0 of a mesh wrote (the gathered closure)
    restores in a solo classifier to the reference's restore."""
    outs = port_run(n, tmp_path_factory)
    snap = outs[0]["_tmp"] / f"{layout}-{n}.npz"
    texts = [t if op == "add" else {"op": "retract", "text": t} for op, t in STEPS]
    inc = IncrementalClassifier.restore(
        texts, str(snap), ClassifierConfig(**LAYOUTS[layout][0]), device="cpu")
    res = inc.last_result
    n_c, n_l = res.idx.n_concepts, res.idx.n_links
    got = {"history": {k: inc.history[-1][k] for k in ranks.INC_KEYS
                       if k in inc.history[-1]},
           "s": res.s[:n_c, :n_c], "r": res.r[:n_c, :n_l],
           "tax": ranks.tax_key(extract_taxonomy(res))}
    _assert_step(got, ref_run(layout, n if LAYOUTS[layout][2] == "mesh" else None,
                              tmp_path_factory)[-1])


#: history keys of a build record, which name the mesh in the signature
#: or are walls
UNSTABLE_KEYS = {"wall_s", "bucket_signature", "delta_signature",
                 "trace_lower_s", "compile_s"}


def _stream(tmp_path, *extra):
    files = []
    for name, text in (("base", BASE), ("d1", CLASS_DELTA), ("d2", LINK_DELTA),
                       ("d3", ROLE_DELTA)):
        path = tmp_path / f"{name}.ofn"
        path.write_text(text)
        files.append(str(path))
    props = tmp_path / "fast.properties"
    props.write_text("fast.path.min.concepts = 0\n" + "".join(extra))
    proc = subprocess.run(
        [sys.executable, "-m", "distel_tpu_torch.cli", "stream", *files,
         "--retract", files[1], "--device", "cpu", "--config", str(props)],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600,
    )
    assert proc.returncode == 0, proc.stderr
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_cli_stream_on_a_mesh_prints_what_stream_prints(tmp_path):
    """``cli stream`` with ``mesh.devices = 2`` (two gloo ranks, the
    default bucketed config) prints the solo stream's records, one a
    step, the retraction included, and its totals; the totals carry each
    rank's record, and every rank saw the same closure and taxonomy at
    every step."""
    for name in ("solo", "mesh"):
        (tmp_path / name).mkdir()
    solo = _stream(tmp_path / "solo")
    mesh = _stream(tmp_path / "mesh", "mesh.devices = 2\n")
    assert len(solo) == len(mesh) == 6
    for a, b in zip(solo[:-1], mesh[:-1]):
        assert Path(a.pop("file")).name == Path(b.pop("file")).name
        assert {k: v for k, v in a.items() if k not in UNSTABLE_KEYS} == \
            {k: v for k, v in b.items() if k not in UNSTABLE_KEYS}
    assert [r["path"] for r in solo[:-1]] == ["rebuild", "fast", "fast", "fast",
                                             "retract"]
    totals = dict(mesh[-1])
    info = totals.pop("mesh")
    assert totals == solo[-1]
    recs = info["ranks"]
    assert info["size"] == 2 and [r["rank"] for r in recs] == [0, 1]
    for k in ("closure_sha256", "taxonomy_sha256", "path", "iterations"):
        assert [s[k] for s in recs[0]["steps"]] == [s[k] for s in recs[1]["steps"]]
    assert recs[0]["collectives"]["total"]["calls"] > 0
