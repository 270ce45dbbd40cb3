"""Snapshot / resume of the saturation state, in the two forms
``distel_tpu/runtime/checkpoint.py`` writes, so either package resumes
from a snapshot the other wrote:

* **v2** (row-packed results, ``transposed=True``): the packed state
  verbatim (``s_wire``/``r_wire``: subsumer-major uint32 rows) — saving
  never densifies the square;
* **v1** (x-major results: the packed engine's): the live S square and
  the R rows as ``np.packbits`` bytes (``s_packed``/``r_packed``, with
  ``s_cols``/``r_cols``), readable with plain numpy.

Both carry the entity tables, so a resume realigns the state by name.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.engine import SaturationResult, _unpack_bits_host
from distel_tpu_torch.core.indexing import IndexedOntology


def save_snapshot(
    path: str,
    result: SaturationResult,
    compressed: bool = True,
    extra_meta: Optional[dict] = None,
) -> None:
    """Write ``result``'s closure: v2 for a transposed (row-packed)
    result, v1 for an x-major one.  ``extra_meta``: JSON-serializable
    fields merged into the ``meta`` record."""
    _savez = np.savez_compressed if compressed else np.savez
    idx = result.idx
    meta = {"time": time.time(), "converged": result.converged}
    if extra_meta:
        meta.update(extra_meta)
    common = dict(
        iterations=np.int64(result.iterations),
        derivations=np.int64(result.derivations),
        concept_names=np.array(idx.concept_names, dtype=object),
        role_names=np.array(idx.role_names, dtype=object),
        links=idx.links,
        meta=np.array([json.dumps(meta)], dtype=object),
    )
    if result.transposed:
        s_wire, r_wire = result.wire()
        _savez(
            path,
            s_wire=s_wire,
            r_wire=r_wire,
            n_concepts=np.int64(idx.n_concepts),
            n_links=np.int64(idx.n_links),
            **common,
        )
        return
    # v1: padded rows/columns sliced away, np.packbits layout
    n = idx.n_concepts
    s = result.s[:n, :n]
    r = result.r[:n]
    _savez(
        path,
        s_packed=np.packbits(s, axis=1),
        r_packed=np.packbits(r, axis=1),
        s_cols=np.int64(s.shape[1]),
        r_cols=np.int64(r.shape[1]),
        **common,
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
    path: str,
    unpack: bool = False,
    idx: Optional[IndexedOntology] = None,
) -> Tuple[Tuple[np.ndarray, np.ndarray], dict]:
    """Resume-oriented load: ``(state, info)`` where ``state`` feeds
    ``engine.saturate(initial=state)``.  For a v2 snapshot the default
    is the wire-packed uint32 pair, which only the row-packed engine
    takes; ``unpack=True`` (and every v1 snapshot) gives the x-major
    bool pair that both engines take.  Pass ``idx`` (the index the
    resuming engine was built from) to remap the state BY NAME onto that
    index's ids; omitting it is only sound when resuming against the
    numbering the snapshot was taken under."""
    z = np.load(path, allow_pickle=True)
    if "s_wire" in z and not unpack:
        state, info = (z["s_wire"], z["r_wire"]), _info(z)
    else:
        s, r, info = _load_unpacked(z)
        state = (s, r)
    if idx is not None:
        state = align_snapshot_state(state, info, idx)
    return state, info


def _load_unpacked(z) -> Tuple[np.ndarray, np.ndarray, dict]:
    if "s_wire" in z:
        # v2: unpack the wire rows and present the x-major live view
        n = int(z["n_concepts"])
        nl = int(z["n_links"])
        st = _unpack_bits_host(z["s_wire"], n)
        rt = _unpack_bits_host(z["r_wire"], n)
        return st[:n].T.copy(), rt[:nl].T.copy(), _info(z)
    s_cols = int(z["s_cols"])
    r_cols = int(z["r_cols"])
    s = np.unpackbits(z["s_packed"], axis=1)[:, :s_cols].astype(bool)
    r = np.unpackbits(z["r_packed"], axis=1)[:, :r_cols].astype(bool)
    return s, r, _info(z)


def load_snapshot(path: str) -> Tuple[np.ndarray, np.ndarray, dict]:
    """``(S, R, info)``: unpacked x-major bool arrays over the logical
    (unpadded) universe, and the names, links and counters."""
    return _load_unpacked(np.load(path, allow_pickle=True))


def state_from_reference(
    packed_s: np.ndarray, packed_r: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A reference engine's packed state (uint32 arrays, e.g.
    ``np.asarray(result.packed_s)``) as this port's int32 state tensors
    on ``device``, bit for bit: the row-packed engine's transposed
    state for the port's row-packed engine, and the packed engine's
    x-major ``packed_s``/``packed_r`` for the port's packed engine (the
    two engines pad their axes as the reference's do, so the shapes
    line up)."""
    def one(a):
        a = np.array(a, np.uint32, order="C")   # a writable copy
        return torch.from_numpy(a.view(np.int32)).to(device)

    return one(packed_s), one(packed_r)


def align_snapshot_state(
    state: Tuple[np.ndarray, np.ndarray], info: dict, idx: IndexedOntology
) -> Tuple[np.ndarray, np.ndarray]:
    """Remap a loaded snapshot (wire-packed uint32, or x-major bool)
    onto ``idx``'s numbering.

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
    if s.dtype == np.uint32:
        return (
            _remap_packed(s, cmap, cmap, idx.n_concepts, n_old),
            _remap_packed(r, lmap, cmap, idx.n_links, n_old),
        )
    # x-major bool [x, a] / [x, l]
    vx = np.nonzero(cmap >= 0)[0]
    s_new = np.zeros((idx.n_concepts, idx.n_concepts), bool)
    s_new[np.ix_(cmap[vx], cmap[vx])] = s[np.ix_(vx, vx)]
    vl = np.nonzero(lmap >= 0)[0]
    r_new = np.zeros((idx.n_concepts, idx.n_links), bool)
    if len(vl):
        r_new[np.ix_(cmap[vx], lmap[vl])] = r[np.ix_(vx, vl)]
    return s_new, r_new


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


class Snapshotter:
    """Timed snapshot hook — the ResultSnapshotter cadence
    (``misc/ResultSnapshotter.java:23-25``: every 2 min over a window):
    call ``maybe_snapshot`` between incremental batches."""

    def __init__(self, path_prefix: str, interval_s: float = 120.0):
        self.path_prefix = path_prefix
        self.interval_s = interval_s
        self._last = 0.0
        self.count = 0

    def maybe_snapshot(self, result: SaturationResult) -> Optional[str]:
        now = time.time()
        if now - self._last < self.interval_s:
            return None
        self._last = now
        path = f"{self.path_prefix}.{self.count:04d}.npz"
        save_snapshot(path, result)
        self.count += 1
        return path
