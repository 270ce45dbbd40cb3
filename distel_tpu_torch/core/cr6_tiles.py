"""CR6 live-tile schedule: the structure-packed role-chain join.

The role-sorted ``chain_pairs`` table splits into **role-run row tiles**
(≤ ``tile_m`` rows, runs merged only while the merged tile's rows ×
union-live-links MAC volume stays near the parts' sum), so each row
tile's rows agree about which links can satisfy them.  Each row tile's
live links — links whose role is a transitive subrole of some row's
chain role — are **packed densely into ``tile_l``-slot link tiles**, and
the contraction runs ``[tile_m, tile_l] ⊙ [tile_l, W]`` only over
occupied tiles.  The outputs flow into deferred segmented-OR write
groups over row-tile ranges.

A copy of ``distel_tpu/core/cr6_tiles.py``'s exact-mode schedule
builder (numpy), apart from the factored mask: the reference copies
each row tile's mask rows into a padded [n_rt, tile_m, n_roles + 1]
table, the port keeps only each slot's row id into the unpadded mask
table (short role runs pad most slots, and the padded copy grows with
roles × row tiles).  The closure re-fit (``h_override`` with
``fit_schedule``) is the reference's; the shape-bucketed variant is not
part of the port yet.  :func:`make_tile_matmul` forces the tile-skipping
kernel on, as the reference does: the per-slot liveness zeroes whole
dead tiles, and skipping them is the point of the formulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.ops.bitpack import SegmentedRowOr

#: default knobs (mirrored by ``ClassifierConfig.cr6_tiles_*``)
TILE_DEFAULTS = {
    "enable": True,
    "tile_m": 512,
    "tile_l": 256,
    "density_threshold": 0.5,
}

#: occupancy-histogram bin edges (fraction of a link tile's slots
#: holding live links)
OCCUPANCY_BINS = (0.25, 0.5, 0.75, 1.0)


@dataclass
class Cr6TileSchedule:
    """One engine's static live-tile schedule (host arrays).

    Shapes: ``n_rt`` row tiles of ``tile_m`` rows; ``nt`` link tiles of
    ``tile_l`` slots per row tile (padded entries inert)."""

    tile_m: int
    tile_l: int
    n_rt: int
    nt: int
    #: [n_rt, tile_m] int32 — l2 (second-leg) R-row ids, padded dead
    rows: np.ndarray
    #: [n_rt, tile_m] int32 — each slot's row of the factored mask
    #: table (pad = the table's length: an all-zero row appended there)
    mrow_ids: np.ndarray
    #: [n_rt, tile_m] int32 — per-row dirty-chunk source (l2 // lc; pad
    #: = n_lchunks), kept for parity with the reference schedule
    fdx: np.ndarray
    #: [n_rt, nt, tile_l] int32 — live link ids (padded dead)
    tids: np.ndarray
    #: [n_rt, nt, tile_l] bool — slot validity (False = padding)
    tval: np.ndarray
    #: [(rt0, rt1, SegmentedRowOr, order_np, targets_np)] — deferred
    #: write groups over row-tile ranges
    groups: List[tuple]
    #: row spans [(a0, a1, roles)] per row tile
    spans: List[tuple]
    #: live link ids per row tile (pre-padding)
    live_per_span: List[np.ndarray]
    #: schedule statistics (occupancy histogram, MAC volumes)
    stats: dict = field(default_factory=dict)


def _role_run_spans(
    tab_roles: np.ndarray,
    bounds: List[int],
    tile_m: int,
    live_count,
) -> List[Tuple[int, int]]:
    """Row spans of the role-sorted table: split at the write-group
    ``bounds`` and at role-run boundaries, then greedily re-merged while
    the merged span's rows × union-live MAC volume stays within 1.25x of
    the parts' sum and under ``tile_m`` rows."""
    n = len(tab_roles)
    spans: List[Tuple[int, int]] = []
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        b1r = min(b1, n)
        if b0 >= b1r:
            continue
        seg = tab_roles[b0:b1r]
        starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]]) + b0
        ends = np.r_[starts[1:], b1r]
        pieces = []
        for s, e in zip(starts, ends):
            for o in range(s, e, tile_m):
                pieces.append((o, min(o + tile_m, e)))
        cur = None
        for s, e in pieces:
            macs = (e - s) * live_count(tab_roles[s:e])
            if cur is None:
                cur = [s, e, macs]
                continue
            nrows = e - cur[0]
            nmacs = nrows * live_count(tab_roles[cur[0]:e])
            if nrows <= tile_m and nmacs <= 1.25 * (cur[2] + macs):
                cur[1], cur[2] = e, cur[2] + macs
            else:
                spans.append((cur[0], cur[1]))
                cur = [s, e, macs]
        if cur is not None:
            spans.append((cur[0], cur[1]))
    return spans


def build_cr6_tile_schedule(
    tab_roles: np.ndarray,
    l2_rows: np.ndarray,
    targets: np.ndarray,
    link_roles: np.ndarray,
    role_closure: np.ndarray,
    *,
    lc: int,
    n_lchunks: int,
    tile_m: int,
    tile_l: int,
    group_bounds: List[int],
    link_window: Optional[Tuple[int, int]] = None,
    dead_link: int,
    pad_target: int = 0,
    tile_headroom: int = 0,
    h_override: Optional[np.ndarray] = None,
    fit_schedule: Optional["Cr6TileSchedule"] = None,
) -> Optional[Cr6TileSchedule]:
    """Build (or re-fit) the live-tile schedule for one CR6 table.

    ``group_bounds``: ROW indices of the deferred write-group boundaries
    (``[0, ..., n_rows]``) — row tiles never straddle one.  An all-inert
    schedule (zero live links anywhere) comes back with ``nt`` slots all
    invalid.  ``h_override``: recompute liveness under a GROWN role
    closure (``rebind_role_closure``); with ``fit_schedule`` (the
    schedule being re-bound) its spans, slot counts and write groups are
    kept, and None comes back when a row tile needs more link tiles than
    the schedule has."""
    h = np.asarray(
        role_closure if h_override is None else h_override
    ).astype(bool)
    n_real = n_grid = len(tab_roles)
    link_roles = np.asarray(link_roles)

    def live_links(roles) -> np.ndarray:
        roles = np.unique(np.asarray(roles))
        roles = roles[roles < h.shape[1]]
        if roles.size == 0:
            return np.zeros(0, np.int64)
        rel = np.flatnonzero(h[:, roles].any(axis=1))
        live = np.flatnonzero(np.isin(link_roles, rel))
        if link_window is not None:
            w0, w1 = link_window
            live = live[(live >= w0) & (live < w1)]
        return live

    bounds = sorted({0, n_grid, *(min(b, n_grid) for b in group_bounds)})
    if fit_schedule is None:
        live_count = (
            (lambda r: 0)
            if link_window is not None
            else (lambda r: len(live_links(r)))
        )
        spans = _role_run_spans(tab_roles, bounds, tile_m, live_count)
        spans = [(a0, a1, np.unique(tab_roles[a0:a1])) for a0, a1 in spans]
    else:
        spans = fit_schedule.spans

    live_per_span = [live_links(roles) for _a0, _a1, roles in spans]
    max_tiles = max(
        [-(-len(lv) // tile_l) for lv in live_per_span], default=0
    )
    if fit_schedule is not None:
        nt = fit_schedule.nt
        if max_tiles > nt:
            return None  # the grown closure overflows the schedule's slots
    else:
        nt = max_tiles + int(tile_headroom)
    n_rt = len(spans)

    rows = np.full((n_rt, tile_m), dead_link, np.int32)
    mrow_ids = np.full((n_rt, tile_m), n_real, np.int32)
    fdx = np.full((n_rt, tile_m), n_lchunks, np.int32)
    tgt = np.full((n_rt, tile_m), pad_target, np.int64)
    tids = np.full((n_rt, nt, tile_l), dead_link, np.int32)
    tval = np.zeros((n_rt, nt, tile_l), bool)
    occupancy = []
    for i, ((a0, a1, _roles), lv) in enumerate(zip(spans, live_per_span)):
        k = a1 - a0
        if k > 0:
            rows[i, :k] = l2_rows[a0:a1]
            mrow_ids[i, :k] = np.arange(a0, a1)
            fdx[i, :k] = l2_rows[a0:a1] // lc
            tgt[i, :k] = targets[a0:a1]
        for t in range(-(-len(lv) // tile_l)):
            seg = lv[t * tile_l : (t + 1) * tile_l]
            tids[i, t, : len(seg)] = seg
            tval[i, t, : len(seg)] = True
            occupancy.append(len(seg) / tile_l)

    total_live = int(sum(len(lv) for lv in live_per_span))
    occupied_slots = int(tval.sum())
    hist = [0] * len(OCCUPANCY_BINS)
    for o in occupancy:
        for bi, edge in enumerate(OCCUPANCY_BINS):
            if o <= edge:
                hist[bi] += 1
                break
    stats = {
        "tile_m": tile_m,
        "tile_l": tile_l,
        "n_row_tiles": int(n_rt),
        "n_link_tiles": int(nt),
        "live_links": total_live,
        "occupied_slots": occupied_slots,
        "tile_macs": occupied_slots * tile_m,
        "occupancy_histogram": {
            f"<= {edge}": hist[bi] for bi, edge in enumerate(OCCUPANCY_BINS)
        },
        "mean_occupancy": (
            round(float(np.mean(occupancy)), 4) if occupancy else 0.0
        ),
    }

    # deferred write groups over the group-bound row ranges; pad
    # row-tile slots target ``pad_target`` with all-zero outputs (a
    # no-op under OR).  A re-fit keeps the schedule's groups: the
    # closure changes liveness and masks, never rows or targets
    groups = fit_schedule.groups if fit_schedule is not None else []
    span_starts = [a0 for a0, _a1, _r in spans] + [n_grid]
    for b0, b1 in zip(bounds[:-1], bounds[1:]) if fit_schedule is None else ():
        rt0 = int(np.searchsorted(span_starts, b0))
        rt1 = max(int(np.searchsorted(span_starts, b1)), rt0)
        if rt1 == rt0 and b1 > b0:
            continue  # bound past every span (no tiles)
        rt1 = min(rt1, n_rt)
        plan = SegmentedRowOr(tgt[rt0:rt1].reshape(-1))
        groups.append(
            (
                rt0, rt1, plan,
                plan.order.astype(np.int32),
                plan.targets.astype(np.int32),
            )
        )
    return Cr6TileSchedule(
        tile_m=tile_m,
        tile_l=tile_l,
        n_rt=int(n_rt),
        nt=int(nt),
        rows=rows,
        mrow_ids=mrow_ids,
        fdx=fdx,
        tids=tids,
        tval=tval,
        groups=groups,
        spans=spans,
        live_per_span=live_per_span,
        stats=stats,
    )


def make_tile_matmul(tile_m: int, tile_l: int, words: int) -> PackedColsMatmulPlan:
    """The one per-tile contraction plan a tile schedule runs under:
    ``[tile_m, tile_l] ⊙ [tile_l, words]`` in the packed-columns AND-OR
    semiring.  The reference forces its tile-skipping kernel here; on the
    card the plan's auto rule picks the route, as for every other plan
    (at the 8k tile shape the dense kernel measured faster)."""
    return PackedColsMatmulPlan(tile_m, tile_l, words)
