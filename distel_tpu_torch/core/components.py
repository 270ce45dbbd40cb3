"""Connected-component partitioning + batched saturation.

The port of ``distel_tpu/core/components.py``, the weak-scaling path.
The reference's evaluation multiplies a corpus into n disjoint renamed
copies (``samples/OntologyMultiplier.java:32-88``) and classifies the
union.  A packed state is quadratic in concepts, so the union hits a
representational wall long before 10M axioms — but its closure is
block-diagonal: concepts of different components never subsume each
other, and links never cross components.

So the corpus is **partitioned at index time and the fixed point is
batched**.  :func:`partition_index` finds connected components of the
axiom-interaction graph (concepts ∪ roles; ⊤/⊥ excluded — they belong
to every component and would glue the universe together).
:func:`saturate_components` groups components whose indexed tensors are
bit-identical after local re-indexing (the multiplied-corpus case:
isomorphic copies), plans ONE engine per group, and runs the whole
group as a leading batch axis over the engine's superstep
(:class:`BatchedSuperstep`) — every copy's fixed point is executed on
the card (state, rule applications, convergence flags per copy; no
result-level deduplication), with per-group state ``[B, nc + nl, wc]``
LINEAR in the number of copies.

Soundness: EL+ saturation never derives a fact whose participants span
two components (every rule's premises share a concept or a link, links
are component-local, and role hierarchy/chains were unioned into the
component graph), so the per-component closures ARE the closure of the
union restricted to each block.

:class:`Component`, :func:`_group_slices` and :func:`partition_index`
are the reference's, line for line (numpy and scipy only; the tests pin
them to its source).  What differs in the execution half, and why:

* The reference vmaps its jitted superstep; here
  :class:`BatchedSuperstep` runs the row-packed engine's plan with a
  leading copy axis: CR1-CR3 as the engine's seg-OR plans, CR4 and CR6
  as its row chunks and live windows, CR5, then one fold, each over all
  copies at once.  The CR4/CR6 products go through one launch of
  ``packed_cols_dense_batched`` a window (the dense route's kernel with
  a grid axis over the copies), where the reference turns its Pallas
  kernels off under vmap.
* Windows are gated as the reference's vmapped step gates them (it
  turns chunk gating off there): a window contracts for a copy when an
  R row of an L-chunk it overlaps, or a source row of its chunk,
  changed in that copy's last step; the copies' union decides whether
  it launches at all, and the others' operand rows are zeroed.  CR5
  runs every step.  So every copy's per-round states, and the group's iteration
  count, are the reference's.
* The live-tile CR6 has no batched form: an ``engine_kw`` that turns
  it on for a group of B > 1 raises.
* The entry points take ``device=`` (None = the first card; raises
  without one) and ``keep_state=`` (each group's entry then carries its
  copies' closures as ``packed_s`` [B, nc, wc] and ``packed_r`` [B, nl,
  wc] on the device; a singleton group's with B = 1).
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from distel_tpu_torch.core.engine import fresh_init_total, popcount_rows
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology
from distel_tpu_torch.ops.bitmatmul import packed_cols_dense_batched
from distel_tpu_torch.ops.bitpack import or_reduce, or_reduce_any


@dataclass
class Component:
    """One block of the partition: a self-contained IndexedOntology plus
    the map from local concept ids (2, 3, ...; 0=⊥, 1=⊤) back to the
    global index."""

    idx: IndexedOntology
    global_concepts: np.ndarray  # [nc_local - 2] int64: local id-2 -> global

    def signature(self) -> bytes:
        """Isomorphism key: components with equal signatures have
        bit-identical indexed tensors and can share one compiled
        engine (the multiplied-corpus case)."""
        i = self.idx
        parts = [
            np.asarray(
                [i.n_concepts, i.n_roles, int(i.has_bottom_axioms)], np.int64
            ).tobytes()
        ]
        for a in (i.nf1, i.nf2, i.nf3, i.nf4, i.links, i.chain_pairs,
                  i.role_closure.astype(np.int8)):
            parts.append(np.ascontiguousarray(a).tobytes())
        return hashlib.sha256(b"|".join(parts)).digest()


def _group_slices(rank: np.ndarray, n_groups: int):
    """(order, starts): ``order`` sorts ids by group rank (stable);
    ``starts[g]:starts[g+1]`` slices group g's ids out of ``order``."""
    order = np.argsort(rank, kind="stable")
    counts = np.bincount(rank, minlength=n_groups)
    starts = np.zeros(n_groups + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts


def partition_index(
    idx: IndexedOntology, *, with_names: bool = True
) -> List[Component]:
    """Split an indexed ontology into interaction components.

    Nodes are concepts and roles (roles offset by ``n_concepts``); every
    axiom row unions its participants; the role closure unions related
    roles.  ⊤ and ⊥ are excluded (every component re-creates its own ids
    0/1); concepts touched by no axiom form singleton components only if
    they are original classes (pure helper ids are dropped).
    ``with_names=False`` skips per-component name tables — the
    weak-scaling path over millions of concepts, where 65k dicts of
    name→id would dwarf the tensors."""
    n, r = idx.n_concepts, idx.n_roles
    roff = n

    def live_edges(*cols):
        """Pairwise edges between every two LIVE participants of each
        row.  A participant is a concept column ("c": ⊤/⊥ are NOT live —
        they belong to every component) or a role column ("r": always
        live, offset by ``roff``).  Pairwise-over-live matters: a
        domain-shaped row like nf4 (r, ⊤, b) must still tie b to r —
        chaining adjacent columns and dropping ⊤-edges afterwards would
        silently disconnect b from the component whose links fire it
        (observed: Disease split from its partonomy copy)."""
        prepped = []
        for arr, kind in cols:
            if kind == "r":
                prepped.append((arr + roff, np.ones(len(arr), bool)))
            else:
                prepped.append(
                    (arr, (arr != TOP_ID) & (arr != BOTTOM_ID))
                )
        out = []
        for i in range(len(prepped)):
            for j in range(i + 1, len(prepped)):
                u, ul = prepped[i]
                v, vl = prepped[j]
                m = ul & vl
                if m.any():
                    out.append(np.stack([u[m], v[m]], axis=1))
        return out

    edges: List[np.ndarray] = []
    if len(idx.nf1):
        edges += live_edges((idx.nf1[:, 0], "c"), (idx.nf1[:, 1], "c"))
    if len(idx.nf2):
        edges += live_edges(
            (idx.nf2[:, 0], "c"), (idx.nf2[:, 1], "c"), (idx.nf2[:, 2], "c")
        )
    if len(idx.nf3):
        edges += live_edges(
            (idx.nf3[:, 0], "c"),
            (idx.links[idx.nf3[:, 1], 0], "r"),
            (idx.links[idx.nf3[:, 1], 1], "c"),
        )
    if len(idx.nf4):
        edges += live_edges(
            (idx.nf4[:, 0], "r"), (idx.nf4[:, 1], "c"), (idx.nf4[:, 2], "c")
        )
    if len(idx.links):
        edges += live_edges(
            (idx.links[:, 0], "r"), (idx.links[:, 1], "c")
        )
    if len(idx.chain_pairs):
        # first-leg role ↔ second-leg link role ↔ TARGET link role: the
        # target matters when the produced link's filler is ⊤ (no
        # links-table edge ties its role to anything — a chain like
        # r∘r ⊑ t over ∃r.⊤ would otherwise leave t unassigned and the
        # remapped chain_pairs row indexing a dropped link)
        edges += live_edges(
            (idx.chain_pairs[:, 0], "r"),
            (idx.links[idx.chain_pairs[:, 1], 0], "r"),
            (idx.links[idx.chain_pairs[:, 2], 0], "r"),
        )
    hr, hc = np.nonzero(idx.role_closure)
    keep = hr != hc
    if keep.any():
        edges.append(np.stack([hr[keep] + roff, hc[keep] + roff], axis=1))

    total = n + r
    e = (
        np.concatenate(edges, axis=0).astype(np.int64)
        if edges
        else np.zeros((0, 2), np.int64)
    )

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix(
        (np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(total, total)
    )
    _, labels = connected_components(adj, directed=False)

    # ---- per-row component labels (vectorized) -----------------------
    def row_labels(tab, concept_cols, role_cols=()):
        """Component label per row via its first participant that is not
        ⊤/⊥ (whose labels are singleton glue, not components).  Roles
        are never ⊤/⊥, so a role column is a safe base; rows whose every
        participant is ⊤/⊥ (e.g. ⊤ ⊑ ⊥) have no home component — the
        caller falls back to whole-corpus classification."""
        if tab is None or not len(tab):
            return None
        lab = np.full(len(tab), -1, np.int64)
        for j in role_cols:
            lab = labels[tab[:, j] + roff].astype(np.int64)
        for j in reversed(concept_cols):
            c = tab[:, j]
            live_c = (c != TOP_ID) & (c != BOTTOM_ID)
            lab = np.where(live_c, labels[c], lab)
        return lab

    row_labs = {
        "nf1": row_labels(idx.nf1, (0, 1)),
        "nf2": row_labels(idx.nf2, (0, 1, 2)),
        "nf3": (
            labels[idx.links[idx.nf3[:, 1], 0] + roff].astype(np.int64)
            if len(idx.nf3) else None
        ),
        "nf4": row_labels(idx.nf4, (1, 2), role_cols=(0,)),
    }
    link_lab = (
        labels[idx.links[:, 0] + roff].astype(np.int64)
        if len(idx.links) else None
    )
    cp_lab = (
        labels[idx.links[idx.chain_pairs[:, 1], 0] + roff].astype(np.int64)
        if len(idx.chain_pairs) else None
    )
    # GLOBAL rows make the partition unsound — classify unpartitioned
    # (identity map: local concept ids ARE global ones, ⊥=0/⊤=1):
    # * a row purely over ⊤/⊥ (label -1) belongs to every component;
    # * an nf1/nf3 row whose LHS is ⊤ fires on EVERY concept column
    #   (S_T[⊤] is all-ones), and one whose LHS is ⊥ fires on every
    #   unsatisfiable column — conclusions land in components that
    #   never see the row.  (nf2/nf4 stay sound when at least ONE
    #   operand is a live anchor premise confining the rule's columns
    #   to the anchor's component — nf4 additionally anchors through
    #   its role's union-find edges; an nf2 row with BOTH operands
    #   ⊤/⊥ has no anchor and fires globally, so it is flagged below
    #   regardless of its conclusion column.  The in-repo normalizer
    #   never emits such a row, but partition_index accepts any
    #   IndexedOntology — native loader, snapshots.)
    unsound = any(
        lab_vec is not None and (lab_vec < 0).any()
        for lab_vec in (row_labs["nf1"], row_labs["nf2"])
    )
    for tab in (idx.nf1, idx.nf3):
        if len(tab) and np.isin(tab[:, 0], (TOP_ID, BOTTOM_ID)).any():
            unsound = True
    if len(idx.nf2) and (
        np.isin(idx.nf2[:, 0], (TOP_ID, BOTTOM_ID))
        & np.isin(idx.nf2[:, 1], (TOP_ID, BOTTOM_ID))
    ).any():
        unsound = True
    if unsound:
        return [Component(idx=idx, global_concepts=np.arange(2, n))]

    # ---- component ranks in copy order (first concept appearance) ----
    live_c = np.ones(n, bool)
    live_c[[TOP_ID, BOTTOM_ID]] = False
    original = np.zeros(n, bool)
    if len(idx.original_classes):
        original[idx.original_classes] = True
    # a concept with axioms is always kept; an isolated one only if it
    # is an original named class (helpers with no axioms are padding)
    touched = np.zeros(total, bool)
    if len(e):
        touched[e[:, 0]] = True
        touched[e[:, 1]] = True
    for key, tab in (("nf1", idx.nf1), ("nf2", idx.nf2)):
        if row_labs[key] is not None:
            for j in range(tab.shape[1]):
                touched[tab[:, j]] = True
    keep_c = live_c & (touched[:n] | original)

    cids = np.flatnonzero(keep_c)
    clabs = labels[cids].astype(np.int64)
    uniq, first_pos, inv = np.unique(
        clabs, return_index=True, return_inverse=True
    )
    rank_of_uniq = np.argsort(np.argsort(first_pos, kind="stable"))
    crank = rank_of_uniq[inv]  # component rank per kept concept
    n_comp = len(uniq)

    if n_comp == 0:
        return []  # nothing but ⊤/⊥ and dropped helpers

    def rank_of(lab_vec):
        """Component rank per label (-1 = label has no kept component);
        vectorized via searchsorted over the sorted unique labels."""
        pos = np.searchsorted(uniq, lab_vec)
        pos = np.clip(pos, 0, len(uniq) - 1)
        ok = uniq[pos] == lab_vec
        return np.where(ok, rank_of_uniq[pos], -1)

    # local concept ids: 2 + position within component (global order)
    corder, cstarts = _group_slices(crank, n_comp)
    local_c = np.full(n, -1, np.int64)
    local_c[BOTTOM_ID] = BOTTOM_ID
    local_c[TOP_ID] = TOP_ID
    pos = np.empty(len(cids), np.int64)
    pos[corder] = np.arange(len(cids)) - np.repeat(
        cstarts[:-1], np.diff(cstarts)
    )
    local_c[cids] = 2 + pos

    # roles grouped by the same ranks (roles in no kept component drop)
    rids = np.arange(r)
    rrank_all = rank_of(labels[roff + rids].astype(np.int64))
    rids = rids[rrank_all >= 0]
    rrank = rrank_all[rrank_all >= 0]
    rorder, rstarts = _group_slices(rrank, n_comp)
    local_r = np.full(r, -1, np.int64)
    rpos = np.empty(len(rids), np.int64)
    rpos[rorder] = np.arange(len(rids)) - np.repeat(
        rstarts[:-1], np.diff(rstarts)
    )
    local_r[rids] = rpos

    # links grouped likewise
    if link_lab is not None:
        lrank = rank_of(link_lab)
        lkeep = lrank >= 0
        lids = np.flatnonzero(lkeep)
        lorder, lstarts = _group_slices(lrank[lkeep], n_comp)
        local_l = np.full(idx.n_links, -1, np.int64)
        lpos = np.empty(len(lids), np.int64)
        lpos[lorder] = np.arange(len(lids)) - np.repeat(
            lstarts[:-1], np.diff(lstarts)
        )
        local_l[lids] = lpos
    else:
        lids = np.zeros(0, np.int64)
        lorder = np.zeros(0, np.int64)
        lstarts = np.zeros(n_comp + 1, np.int64)
        local_l = np.zeros(0, np.int64)

    # rows grouped per table
    def table_slices(tab, lab_vec):
        if lab_vec is None:
            return None
        rrank_ = rank_of(lab_vec)
        kept = rrank_ >= 0
        ids = np.flatnonzero(kept)
        order, starts = _group_slices(rrank_[kept], n_comp)
        return tab, ids, order, starts

    tslices = {
        "nf1": table_slices(idx.nf1, row_labs["nf1"]),
        "nf2": table_slices(idx.nf2, row_labs["nf2"]),
        "nf3": table_slices(idx.nf3, row_labs["nf3"]),
        "nf4": table_slices(idx.nf4, row_labs["nf4"]),
        "cp": table_slices(idx.chain_pairs, cp_lab),
    }

    def comp_rows(key, k):
        ts = tslices[key]
        if ts is None:
            return None
        tab, ids, order, starts = ts
        return tab[ids[order[starts[k] : starts[k + 1]]]]

    out: List[Component] = []
    empty2 = np.zeros((0, 2), np.int32)
    empty3 = np.zeros((0, 3), np.int32)
    for k in range(n_comp):
        gcon = cids[corder[cstarts[k] : cstarts[k + 1]]]
        groles = rids[rorder[rstarts[k] : rstarts[k + 1]]]
        glinks = lids[lorder[lstarts[k] : lstarts[k + 1]]]

        def remap(tab, spec):
            if tab is None or not len(tab):
                return (empty3 if len(spec) == 3 else empty2)
            cols = []
            for j, kind in enumerate(spec):
                src = tab[:, j]
                cols.append(
                    local_c[src] if kind == "c"
                    else local_r[src] if kind == "r"
                    else local_l[src]
                )
            return np.stack(cols, axis=1).astype(np.int32)

        nf1 = remap(comp_rows("nf1", k), "cc")
        nf2 = remap(comp_rows("nf2", k), "ccc")
        nf3 = remap(comp_rows("nf3", k), "cl")
        nf4 = remap(comp_rows("nf4", k), "rcc")
        chain_pairs = remap(comp_rows("cp", k), "rll")
        links = (
            np.stack(
                [local_r[idx.links[glinks, 0]], local_c[idx.links[glinks, 1]]],
                axis=1,
            ).astype(np.int32)
            if len(glinks)
            else empty2
        )
        closure = (
            np.ascontiguousarray(idx.role_closure[np.ix_(groles, groles)])
            if len(groles)
            else np.zeros((1, 1), idx.role_closure.dtype)
        )
        has_bottom = bool(
            (len(nf1) and (nf1[:, 1] == BOTTOM_ID).any())
            or (len(nf2) and (nf2[:, 2] == BOTTOM_ID).any())
            or (len(nf4) and (nf4[:, 2] == BOTTOM_ID).any())
        )
        orig_local = 2 + np.flatnonzero(original[gcon])
        if with_names:
            names = (
                [idx.concept_names[BOTTOM_ID], idx.concept_names[TOP_ID]]
                + [idx.concept_names[g] for g in gcon]
            )
            rnames = [idx.role_names[g] for g in groles]
            cid_map = {nm: i for i, nm in enumerate(names)}
            rid_map = {nm: i for i, nm in enumerate(rnames)}
        else:
            names, rnames, cid_map, rid_map = [], [], {}, {}
        sub = IndexedOntology(
            n_concepts=2 + len(gcon),
            n_roles=max(len(groles), 1),
            concept_names=names,
            concept_ids=cid_map,
            role_names=rnames,
            role_ids=rid_map,
            nf1=nf1,
            nf2=nf2,
            nf3=nf3,
            nf4=nf4,
            links=links,
            chain_pairs=chain_pairs,
            role_closure=closure,
            original_classes=orig_local.astype(np.int32),
            has_bottom_axioms=has_bottom,
        )
        out.append(Component(idx=sub, global_concepts=gcon.astype(np.int64)))
    return out



def saturate_isomorphic(
    idx: IndexedOntology,
    batch: int,
    *,
    max_iters: int = 10_000,
    engine_kw: Optional[dict] = None,
    warm_timing: bool = False,
    device=None,
    keep_state: bool = False,
) -> dict:
    """Run ``batch`` copies of one component's fixed point as a batch —
    the execution half of the weak-scaling path, used when the grouping
    happened upstream (``frontend/partition_text.py`` discovers
    isomorphic copies at the text level, before any global index
    exists).  Same counters as one ``saturate_components`` group."""
    comps = [Component(idx=idx, global_concepts=np.zeros(0, np.int64))]
    agg = saturate_components(
        comps, max_iters=max_iters, engine_kw=engine_kw, _batch=batch,
        warm_timing=warm_timing, device=device, keep_state=keep_state,
    )
    return agg["groups"][0] | {"wall_s": agg["wall_s"]}


def saturate_components(
    components: List[Component],
    *,
    max_iters: int = 10_000,
    engine_kw: Optional[dict] = None,
    warm_timing: bool = False,
    _batch: Optional[int] = None,
    device=None,
    keep_state: bool = False,
) -> dict:
    """Classify every component, batching isomorphic ones through one
    planned batched fixed point.  Returns aggregate counters plus the
    per-group breakdown; with ``keep_state`` each group's entry also
    holds its copies' closures on the device (``packed_s[i]`` is copy
    i's)."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.runtime.classifier import resolve_device

    dev = resolve_device(device)
    groups: Dict[bytes, List[Component]] = {}
    for c in components:
        groups.setdefault(c.signature(), []).append(c)

    total_derivations = 0
    total_iters_max = 0
    total_warm = 0.0
    report: List[dict] = []
    wall0 = time.time()
    for comps in groups.values():
        rep = comps[0].idx
        B = _batch if _batch is not None else len(comps)
        engine = RowPackedSaturationEngine(rep, device=dev, **(engine_kw or {}))
        state = None
        if B == 1:
            # singleton group — including the unpartitioned fallback
            # where the "component" is the entire corpus: run the
            # engine's normal fixed point (frontier gating, both kernel
            # routes, the automatic chunk gating)
            t0 = time.time()
            res = engine.saturate(max_iters)
            wall = time.time() - t0
            warm = None
            if warm_timing:
                t0 = time.time()
                res = engine.saturate(max_iters)
                warm = time.time() - t0
            it, derivs = res.iterations, int(res.derivations)
            if keep_state:
                state = (res.packed_s[None], res.packed_r[None])
            del res
        else:
            it, derivs, wall, warm, state = _run_group(
                engine, rep, B, max_iters, warm_timing, keep_state,
            )
        total_derivations += int(derivs)
        total_iters_max = max(total_iters_max, int(it))
        entry = {
            "batch": B,
            "n_concepts_each": rep.n_concepts,
            "n_links_each": rep.n_links,
            "iterations": int(it),
            "derivations": int(derivs),
            "wall_s": round(wall, 3),
        }
        if warm is not None:
            total_warm += warm
            entry["wall_warm_s"] = round(warm, 3)
        if keep_state:
            entry["packed_s"], entry["packed_r"] = state
        report.append(entry)
    return {
        "n_components": len(components),
        "n_groups": len(groups),
        "derivations": int(total_derivations),
        "iterations_max": total_iters_max,
        "wall_s": round(time.time() - wall0, 3),
        "wall_warm_s": round(total_warm, 3),
        "groups": report,
    }


def _run_group(engine, rep, B, max_iters, warm_timing, keep_state=False):
    """The batched execution of one isomorphism group: B copies of
    ``rep``'s fixed point as a leading axis over the engine's superstep.
    Returns ``(iterations, derivations, wall_s, warm_s_or_None,
    state)``; ``state`` is ``(packed_s, packed_r)`` of the first run
    with ``keep_state``, else None."""
    batch = BatchedSuperstep(engine, B)
    budget = max_iters - max_iters % engine.unroll

    def run():
        state = batch.initial_state()
        it, fr, changed = 0, None, True
        while changed and it < budget:
            changed = False
            for _ in range(engine.unroll):
                fr = batch.step(state, fr)
                changed |= fr.changed
            it += engine.unroll
        return state, it, changed, batch.live_bits(state)

    t0 = time.time()
    state, it, changed, bits = run()
    wall = time.time() - t0  # includes the kernels' first build
    if changed:
        # mirror the monolithic engines' contract: never report a
        # truncated closure as a result
        raise RuntimeError(
            f"component group (B={B}, nc={rep.n_concepts}) did not "
            f"converge within {budget} iterations"
        )
    kept = batch.split(state) if keep_state else None
    del state
    warm = None
    if warm_timing:
        # opt-in second run (the weak-scaling bench's steady-state
        # wall); library callers pay for ONE fixed point
        t0 = time.time()
        again = run()
        del again
        warm = time.time() - t0
    derivs = bits - B * fresh_init_total(rep)
    return int(it), int(derivs), wall, warm, kept


class BatchFrontier(NamedTuple):
    """What changed in the last batched step: per copy on the device
    (the operands' row masks read them), and the copies' union on the
    host (which windows launch at all)."""

    changed: bool             # some copy changed
    dirty_l: np.ndarray       # [n_lchunks] some copy's L-chunk changed
    f4: np.ndarray            # [CR4 chunks] some copy's source S row did
    f6: np.ndarray            # [CR6 chunks] some copy's source L-chunk did
    dirty_l_dev: torch.Tensor  # [B, n_lchunks]
    f4_dev: torch.Tensor      # [B, CR4 chunks]
    f6_dev: torch.Tensor      # [B, CR6 chunks]


class BatchedSuperstep:
    """B copies of one row-packed engine's plan, stepped together.

    The state is one ``[B, nc + nl, wc]`` int32 tensor on the engine's
    device: each copy's S rows, then its R rows, in the engine's
    transposed packed layout.  :meth:`step` is the engine's
    :meth:`~distel_tpu_torch.core.rowpacked_engine.RowPackedSaturationEngine.step`
    with a leading copy axis — CR1, CR2, CR3 over word blocks, CR4 and
    CR6 over the engine's row chunks and live windows (one
    ``packed_cols_dense_batched`` launch a window for all copies), CR5,
    then one fold — in place.  The engine's own methods are untouched."""

    def __init__(self, engine, batch: int):
        if engine._t6 is not None:
            raise ValueError(
                "the live-tile CR6 has no batched form: build the group's "
                "engine without cr6_tiles"
            )
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.engine = engine
        self.B = int(batch)
        e = engine
        # word blocks of CR1-CR3 sized for the whole batch, so the
        # gathered [B, k, bw] temporaries stay within the engine's
        # budget down to one word a block (blocks are column-local:
        # any width gives the same words)
        emission = max(e._p1.k, 2 * e._p2.k, e._p3.k, 1)
        bw = max(min(e.temp_budget_bytes // (4 * emission * self.B), e.wc), 1)
        n_blocks = -(-e.wc // bw)
        self._bw = -(-e.wc // n_blocks)

    def initial_state(self) -> torch.Tensor:
        """Every copy at S(X) = {X, ⊤}, R empty."""
        e = self.engine
        sp0, rp0 = e.initial_state()
        state = torch.empty(
            (self.B, e.nc + e.nl, e.wc), dtype=torch.int32, device=e.device
        )
        state[:, : e.nc] = sp0
        state[:, e.nc :] = rp0
        return state

    def split(self, state: torch.Tensor):
        """``(packed_s [B, nc, wc], packed_r [B, nl, wc])`` views."""
        nc = self.engine.nc
        return state[:, :nc], state[:, nc:]

    def live_bits(self, state: torch.Tensor) -> int:
        """Live-column bits of every copy's S and R, summed on the host."""
        e = self.engine
        rows = state.view(-1, e.wc)
        return int(popcount_rows(rows, e._wmask, block=1 << 20).sum())

    def initial_frontier(self) -> BatchFrontier:
        e = self.engine
        n_l, n4, n6, _n_rt = e._flag_sizes
        dev = e.device

        def ones(n):
            return torch.ones((self.B, n), dtype=torch.bool, device=dev)

        return BatchFrontier(
            True, np.ones(n_l, bool), np.ones(n4, bool), np.ones(n6, bool),
            ones(n_l), ones(n4), ones(n6),
        )

    # ------------------------------------------------------------- rules

    @staticmethod
    def _reduce(plan, rows: torch.Tensor) -> torch.Tensor:
        """:meth:`SegmentedRowOr.reduce` over [B, k, w] rows (gathered
        through the plan's order) → [B, n_targets, w]."""
        nb, _k, w = rows.shape
        outs, pos = [], 0
        for blen, nseg in plan._buckets:
            chunk = rows[:, pos : pos + nseg * blen]
            pos += nseg * blen
            if blen == 1:
                outs.append(chunk)
            else:
                outs.append(or_reduce(chunk.reshape(nb, nseg, blen, w), 2))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    @staticmethod
    def _write(plan, state: torch.Tensor, red: torch.Tensor,
               cols=slice(None)) -> torch.Tensor:
        """:meth:`SegmentedRowOr.write` with a leading copy axis, in
        place; returns the per-copy change vector [B, n_targets]."""
        t = plan.device_targets(state.device)
        old = state[:, t, cols]
        merged = old | red
        state[:, t, cols] = merged
        return (merged != old).any(dim=2)

    def _row_rules(self, sp, rp, s_cvs, r_cvs):
        e = self.engine
        cv = [None, None, None]
        for off in range(0, e.wc, self._bw):
            blk = slice(off, min(off + self._bw, e.wc))
            for i, (plan, srcs, target) in enumerate((
                (e._p1, (e._src1,), sp),            # CR1: a ⊑ b
                (e._p2, (e._src2a, e._src2b), sp),  # CR2: a1 ⊓ a2 ⊑ b
                (e._p3, (e._src3,), rp),            # CR3: a ⊑ ∃link
            )):
                if not plan.k:
                    continue
                g = sp[:, srcs[0], blk]
                if len(srcs) == 2:
                    g = g & sp[:, srcs[1], blk]
                c = self._write(plan, target, self._reduce(plan, g), blk)
                cv[i] = c if cv[i] is None else cv[i] | c
        for plan, c, out in ((e._p1, cv[0], s_cvs), (e._p2, cv[1], s_cvs),
                             (e._p3, cv[2], r_cvs)):
            if c is not None:
                out.append((plan.device_targets(sp.device), c))

    def _contract_rule(self, chunks, f_host, f_dev, bits_state, rp, target,
                       fr, cvs):
        """One CR4/CR6 rule: per row chunk, its live windows against R
        for every copy, ORed over the windows, then the chunk's seg-OR
        write.  A window launches when some copy needs it; a copy that
        does not gets an all-zero operand (its product is empty), as
        the reference's vmapped step zeroes it."""
        e = self.engine
        dl, dl_dev = fr.dirty_l, fr.dirty_l_dev
        for ci, chunk in enumerate(chunks):
            rows = acc = None
            for off, end, c0, c1 in chunk.windows:
                if not (f_host[ci] or dl[c0] or dl[c1]):
                    continue
                if rows is None:
                    rows = bits_state[:, chunk.src]          # [B, rk, wc]
                fil = e._fillers[off:end]
                f = ((rows[:, :, fil >> 5] >> (fil & 31).to(torch.int32))
                     & 1).to(torch.int8)                     # [B, rk, l]
                live = f_dev[:, ci] | dl_dev[:, c0] | dl_dev[:, c1]
                w = (chunk.mask[:, e._link_roles[off:end]][None] * f
                     * live.to(torch.int8)[:, None, None])
                acc = packed_cols_dense_batched(
                    w.contiguous(), rp[:, off:end], out=acc
                )
            if acc is None:
                continue
            piece = chunk.piece
            red = self._reduce(piece, acc[:, chunk.order])
            cvs.append((piece.device_targets(target.device),
                        self._write(piece, target, red)))

    def _cr5(self, sp, rp, s_cvs):
        """⊥ back-propagation per copy: the OR of the R rows whose
        filler is unsatisfiable, into the ⊥ row."""
        e = self.engine
        fil = e._fillers
        bot = sp[:, BOTTOM_ID]                               # [B, wc]
        botf = ((bot[:, fil >> 5] >> (fil & 31).to(torch.int32)) & 1).bool()
        red = or_reduce_any(torch.where(botf[:, :, None], rp, 0), 1)
        old = bot.clone()
        sp[:, BOTTOM_ID] |= red
        s_cvs.append((
            torch.full((1,), BOTTOM_ID, dtype=torch.int64, device=sp.device),
            (sp[:, BOTTOM_ID] != old).any(dim=1)[:, None],
        ))

    def _fold(self, s_cvs, r_cvs) -> BatchFrontier:
        """Per copy, the next step's frontier from this step's change
        vectors (one indexed OR a state matrix, the per-chunk
        reductions), then one copy of the copies' union to the host."""
        e = self.engine
        dev, nb = e.device, self.B

        def mask(cvs, n):
            m = torch.zeros((nb, n), dtype=torch.int32, device=dev)
            if cvs:
                t = torch.cat([t for t, _ in cvs])
                v = torch.cat([c for _, c in cvs], dim=1).to(torch.int32)
                m.index_add_(1, t, v)
            return m > 0

        def per_chunk(src, csr, n):
            ids, seg = csr
            out = torch.zeros((nb, n), dtype=torch.int32, device=dev)
            if ids.numel():
                out.index_add_(1, seg, src[:, ids].to(torch.int32))
            return out > 0

        n_l, n4, n6, _n_rt = e._flag_sizes
        mask_s = mask(s_cvs, e.nc)
        dirty_l = mask(r_cvs, e._grid_end).view(nb, n_l, e.lc).any(dim=2)
        f4 = per_chunk(mask_s, e._f4_csr, n4)
        f6 = per_chunk(dirty_l, e._f6_csr, n6)
        changed = mask_s.any() | dirty_l.any()
        flags = torch.cat([
            changed[None], dirty_l.any(dim=0), f4.any(dim=0), f6.any(dim=0),
        ]).cpu().numpy()
        o = np.cumsum([1, n_l, n4, n6])
        return BatchFrontier(
            bool(flags[0]), flags[o[0]:o[1]], flags[o[1]:o[2]],
            flags[o[2]:o[3]], dirty_l, f4, f6,
        )

    def step(self, state: torch.Tensor,
             frontier: Optional[BatchFrontier] = None) -> BatchFrontier:
        """One superstep of every copy, in place: CR1, CR2, CR3, CR4,
        CR6, CR5, the windows gated on ``frontier`` (None = everything
        dirty, as on a first step).  Returns the next frontier;
        ``.changed`` says whether any copy changed."""
        e = self.engine
        fr = self.initial_frontier() if frontier is None else frontier
        sp, rp = self.split(state)
        s_cvs, r_cvs = [], []
        if e._p1.k or e._p2.k or e._p3.k:
            self._row_rules(sp, rp, s_cvs, r_cvs)
        if e._chunks4:
            self._contract_rule(e._chunks4, fr.f4, fr.f4_dev, sp, rp, sp,
                                fr, s_cvs)
        if e._chunks6:
            self._contract_rule(e._chunks6, fr.f6, fr.f6_dev, rp, rp, rp,
                                fr, r_cvs)
        if e._bottom:
            self._cr5(sp, rp, s_cvs)
        return self._fold(s_cvs, r_cvs)
