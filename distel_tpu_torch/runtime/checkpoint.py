"""Snapshot / resume of the saturation state (the v2 wire form).

A snapshot is an ``.npz`` holding the row-packed engine's packed state
verbatim (``s_wire``/``r_wire``: subsumer-major uint32 rows) plus the
entity tables — the same file format ``distel_tpu/runtime/checkpoint.py``
writes for its row-packed results, so either package resumes from a
snapshot the other wrote.  The older v1 form (x-major ``np.packbits``
squares of the dense reference engine) is not read by the port.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.core.indexing import IndexedOntology


def save_snapshot(
    path: str,
    result: SaturationResult,
    compressed: bool = True,
    extra_meta: Optional[dict] = None,
) -> None:
    """Write ``result``'s closure as a v2 snapshot.  ``extra_meta``:
    JSON-serializable fields merged into the ``meta`` record."""
    _savez = np.savez_compressed if compressed else np.savez
    idx = result.idx
    meta = {"time": time.time(), "converged": result.converged}
    if extra_meta:
        meta.update(extra_meta)
    s_wire, r_wire = result.wire()
    _savez(
        path,
        s_wire=s_wire,
        r_wire=r_wire,
        n_concepts=np.int64(idx.n_concepts),
        n_links=np.int64(idx.n_links),
        iterations=np.int64(result.iterations),
        derivations=np.int64(result.derivations),
        concept_names=np.array(idx.concept_names, dtype=object),
        role_names=np.array(idx.role_names, dtype=object),
        links=idx.links,
        meta=np.array([json.dumps(meta)], dtype=object),
    )


def _info(z) -> dict:
    return {
        "iterations": int(z["iterations"]),
        "derivations": int(z["derivations"]),
        "concept_names": list(z["concept_names"]),
        "role_names": list(z["role_names"]),
        "links": z["links"],
        "meta": json.loads(str(z["meta"][0])),
    }


def load_snapshot_state(
    path: str, idx: Optional[IndexedOntology] = None
) -> Tuple[Tuple[np.ndarray, np.ndarray], dict]:
    """Resume-oriented load: ``(state, info)`` where ``state`` is the
    wire-packed uint32 pair that feeds ``engine.saturate(initial=
    state)``.  Pass ``idx`` (the index the resuming engine was built
    from) to remap the state BY NAME onto that index's ids; omitting it
    is only sound when resuming against the numbering the snapshot was
    taken under."""
    z = np.load(path, allow_pickle=True)
    if "s_wire" not in z:
        raise ValueError(
            f"{path}: not a v2 (row-packed wire) snapshot; distel_tpu_torch "
            "reads only the v2 form"
        )
    state, info = (z["s_wire"], z["r_wire"]), _info(z)
    if idx is not None:
        state = align_snapshot_state(state, info, idx)
    return state, info


def state_from_reference(
    packed_s: np.ndarray, packed_r: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference row-packed engine's packed state (uint32 arrays,
    e.g. ``np.asarray(result.packed_s)``) as this port's int32 state
    tensors on ``device``, bit for bit."""
    def one(a):
        a = np.array(a, np.uint32, order="C")   # a writable copy
        return torch.from_numpy(a.view(np.int32)).to(device)

    return one(packed_s), one(packed_r)


def align_snapshot_state(
    state: Tuple[np.ndarray, np.ndarray], info: dict, idx: IndexedOntology
) -> Tuple[np.ndarray, np.ndarray]:
    """Remap a loaded wire-packed snapshot onto ``idx``'s numbering.

    Matching is by *name*: concepts via ``concept_names``, links via
    (role name, filler name).  Entities absent from ``idx`` are dropped;
    when the old numbering is a prefix of the new one this is a no-copy
    identity.  Generated names (gensyms, aux concepts, chain roles)
    depend on the load history, so outside the identity case they are
    dropped rather than matched — a warm start may be any sound subset
    of a closure."""
    old_cnames = list(info["concept_names"])
    old_rnames = list(info["role_names"])
    old_links = np.asarray(info["links"])
    cmap_raw = np.asarray(
        [idx.concept_ids.get(nm, -1) for nm in old_cnames], np.int64
    )
    new_link_ids = {(int(r), int(f)): i for i, (r, f) in enumerate(idx.links)}
    rmap_raw = np.asarray(
        [idx.role_ids.get(nm, -1) for nm in old_rnames], np.int64
    )
    if (cmap_raw == np.arange(len(old_cnames))).all():
        lmap_id = _link_map(old_links, rmap_raw, cmap_raw, new_link_ids)
        if (lmap_id == np.arange(len(old_links))).all():
            return state
    cmap = cmap_raw.copy()
    for i, nm in enumerate(old_cnames):
        if nm.startswith(("distel:gensym#", "distel:aux#")):
            cmap[i] = -1
    rmap = rmap_raw.copy()
    for i, nm in enumerate(old_rnames):
        if nm.startswith("distel:genrole#"):
            rmap[i] = -1
    lmap = _link_map(old_links, rmap, cmap, new_link_ids)
    n_old = len(old_cnames)
    s, r = np.asarray(state[0]), np.asarray(state[1])
    return (
        _remap_packed(s, cmap, cmap, idx.n_concepts, n_old),
        _remap_packed(r, lmap, cmap, idx.n_links, n_old),
    )


def _link_map(old_links, rmap, cmap, new_link_ids) -> np.ndarray:
    """old link id → new link id via (mapped role, mapped filler)."""
    lmap = np.full(len(old_links), -1, np.int64)
    for i, (r, f) in enumerate(old_links):
        nr = rmap[r]
        nf = cmap[f]
        if nr >= 0 and nf >= 0:
            lmap[i] = new_link_ids.get((int(nr), int(nf)), -1)
    return lmap


def _remap_packed(p, row_map, bit_map, n_new_rows, n_old_bits, block=4096):
    """Remap a wire-packed [row, xw] uint32 array: row i → row_map[i],
    bit x → bit_map[x] (negatives dropped), in row blocks."""
    n_new_bits = int(bit_map.max()) + 1 if (bit_map >= 0).any() else 1
    out_w = (n_new_bits + 31) // 32
    out = np.zeros((n_new_rows, out_w), np.uint32)
    valid_bits = np.nonzero(bit_map[: min(n_old_bits, p.shape[1] * 32)] >= 0)[0]
    tgt_bits = bit_map[valid_bits]
    pad_bits = out_w * 32
    for i0 in range(0, min(p.shape[0], len(row_map)), block):
        rows = p[i0 : i0 + block]
        rmap = row_map[i0 : i0 + block]
        keep = np.nonzero((rmap >= 0) & (rmap < n_new_rows))[0]
        if not len(keep):
            continue
        bits = np.unpackbits(rows[keep].view(np.uint8), axis=1, bitorder="little")
        blk = np.zeros((len(keep), pad_bits), np.uint8)
        blk[:, tgt_bits] = bits[:, valid_bits]
        packed = np.packbits(blk, axis=1, bitorder="little")
        out[rmap[keep]] = np.ascontiguousarray(packed).view(np.uint32)
    return out
