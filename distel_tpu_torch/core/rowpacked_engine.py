"""Row-packed saturation engine: transposed, scatter-free, frontier-gated.

The port of ``distel_tpu/core/rowpacked_engine.py``'s exact-shape,
single-device path.  The state is stored **transposed and packed**:

    S_T [a, xw]  int32 — bit x of word xw set iff a ∈ S(x)
    R_T [l, xw]  int32 — bit x set iff (x, filler(l)) ∈ R(role(l))

(int32 words carry the uint32 bit pattern), and every completion rule
writes whole rows:

  CR1  S_T[b]  ∨= S_T[a]                       row gather + seg-OR
  CR2  S_T[b]  ∨= S_T[a1] ∧ S_T[a2]            two gathers + seg-OR
  CR3  R_T[l]  ∨= S_T[a]                       row gather + seg-OR
  CR4  S_T[b_j] ∨= W[j,:] ⊙ R_T                packed-columns kernel
         W[j,l] = H[role(l), s_j] ∧ S_T[a_j, bit filler(l)]
  CR6  R_T[lt_p] ∨= D[p,:] ⊙ R_T               packed-columns kernel
         D[p,l] = H[role(l), r_p] ∧ R_T[l2_p, bit filler(l)]
  CR5  S_T[⊥]  ∨= OR_l botf(l) ? R_T[l]        masked packed OR-reduce

in that order within a step.  The role hierarchy never materializes:
the closure masks are FACTORED (``m[j, ρ] = H[ρ, s_j]``, gathered per
link through its role), and each CR4/CR6 row chunk contracts only the
link windows whose roles can satisfy it (static live windows; chunks
cut at role runs once the tables are big enough for that to pay, as in
the reference).  CR6 runs the live-tile schedule (``core/cr6_tiles.py``)
when its live structure is sparse enough.

**Frontier gating** (the reference's two-sided semi-naive join): every
writer returns its per-target change vector, and after each step one
device fold turns them into the frontier of the next step — the
changed S rows, and per L-chunk (``lc`` links of the link axis) whether
an R row in it changed.  A CR4/CR6 window contracts only when an R row
of an L-chunk it overlaps, or a bit-table source row of its chunk (S
rows ``a_j`` for CR4, the L-chunks of the rows ``l2_p`` for CR6),
changed in the last step; a live-tile slot likewise; with chunk gating
(``gate_chunks``) CR5 runs only when R or the ⊥ row changed.  Skipping
only delays derivations (every rule is a monotone OR, and the loop
stops only after a step that changed nothing), and the per-round states
equal the reference's ``_step`` with its dirty carry when both engines
run the same chunk plan.  The flags reach the host in one small copy
per round, which replaces the convergence read: a window whose inputs
are clean launches nothing.

What differs from the reference, and why:

* The fixed point is a host loop with one flag read per step; there is
  no ``lax.while_loop`` to compile.  It keeps the reference's ``unroll``
  semantics: steps run in groups of ``unroll``, the loop stops only
  after a whole group changed nothing, and ``iterations`` counts whole
  groups against a budget of ``max_iters`` rounded up to ``unroll``.
  A clean step inside a group contracts nothing (its frontier is
  clean).  PyTorch runs eagerly, so there is no scan mode: chunks are a
  Python loop.
* The fold ORs each writer's change vector into the frontier masks by
  an indexed write (targets are unique within a writer); the reference's
  layered permutation gathers exist only because a scatter serialises
  on the TPU.
* Rows are written in place (the state is the largest tensor of a run).
* The link axis is never evened out to the window grid: windows that
  run past its end are cut short (the reference pads the axis with
  inert links instead), so ``nl`` never exceeds the reference engine's
  and snapshots interchange both ways.
* Temporaries are sized against the device's memory (an 80 GB H100)
  rather than the 16 GB v5e the reference's thresholds were measured on
  — see ``core/engine.py``'s :func:`default_temp_budget`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.cr6_tiles import (
    TILE_DEFAULTS,
    build_cr6_tile_schedule,
    make_tile_matmul,
)
from distel_tpu_torch.core.engine import (
    SaturationResult,
    _host_bit_total,
    _pad_up,
    default_temp_budget,
    fresh_init_total,
    live_bits,
)
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology
from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.ops.bitpack import (
    SegmentedRowOr,
    bit_lookup,
    bit_lookup_from,
    or_reduce_any,
)

#: chunk-count ceiling of the role-aware CR4/CR6 chunking: each chunk
#: costs a few launches per live window per round, so merging relaxes
#: (wider waste factors) until the count fits
MAX_ROLE_CHUNKS = 256

#: dense contraction volume (table rows × nl × nc) from which CR4/CR6
#: chunks cut at role runs and windows resolve the link table's role
#: runs — the reference's threshold: below it the whole table is one
#: row-budget chunk over budget-sized windows
ROLE_SPLIT_MIN_VOLUME = 5e11

#: the reference's automatic chunk gating (which adds the CR5 gate):
#: from this many padded concepts, up to :data:`GATE_MAX_STATE_BYTES`
GATE_MIN_CONCEPTS = 32_768
GATE_MAX_STATE_BYTES = 5 << 29

#: the reference's automatic ``unroll`` on one device: 2 steps a group
#: up to this much packed state, 1 past it
UNROLL2_MAX_STATE_BYTES = 9 << 29


def _factored_closure_tables(h, nf4_roles, chain_roles):
    """``(m4, m6)``: ``h`` extended with one all-zero SENTINEL role row
    (padded links carry the sentinel id, so their mask column is dead),
    gathered per table row: ``m4[j, ρ] = H[ρ, s_j]``, ``m6[p, ρ] =
    H[ρ, r_p]``.  None roles (rule off) give an empty table."""
    n_roles = h.shape[0]
    h2 = np.zeros((n_roles + 1, n_roles), np.int8)
    h2[:n_roles] = h

    def tab(roles):
        if roles is None:
            return np.zeros((0, n_roles + 1), np.int8)
        return np.ascontiguousarray(h2[:, roles].T)

    return tab(nf4_roles), tab(chain_roles)


def _tile_group_bounds(tab_roles: np.ndarray, tile_m: int,
                       max_tiles: int) -> List[int]:
    """Write-group bounds (table rows) of the live-tile CR6 such that no
    group holds more than ``max_tiles`` row tiles, so its deferred
    [tiles × tile_m, wc] output stays within the temporary budget.  A
    row tile never spans two role runs' pieces of ``tile_m`` rows
    (merging only lowers the count), so counting pieces bounds the
    tiles; bounds fall on piece starts, where the schedule cuts too.
    Many short role runs (each a padded tile) make many groups."""
    n = len(tab_roles)
    starts = np.flatnonzero(np.r_[True, tab_roles[1:] != tab_roles[:-1]])
    ends = np.r_[starts[1:], n]
    bounds, tiles = [0], 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        for o in range(s, e, tile_m):
            if tiles == max_tiles:
                bounds.append(o)
                tiles = 0
            tiles += 1
    return bounds + [n]


class _Chunk(NamedTuple):
    """One CR4/CR6 row chunk of the window formulation."""

    src: torch.Tensor        # [rk] bit-table source rows (a_j / l2_p)
    mask: torch.Tensor       # [rk, n_roles + 1] factored mask rows
    piece: SegmentedRowOr    # the chunk's write plan over its targets
    order: torch.Tensor      # the plan's emission order
    #: live windows ``(off, end, c0, c1)``: links [off, end) and the
    #: first and last L-chunk the (uncut) window overlaps
    windows: List[Tuple[int, int, int, int]]


@dataclass
class Frontier:
    """What changed in the last step, as the next step reads it (host
    flags; ``dirty_l_dev`` is the device copy the live-tile slots read,
    with a trailing always-False slot)."""

    changed: bool
    dirty_l: np.ndarray      # [n_lchunks] an R row of the L-chunk changed
    f4: np.ndarray           # [CR4 chunks] a source S row changed
    f6: np.ndarray           # [CR6 chunks] an L-chunk of a source row did
    fd6: np.ndarray          # [CR6 row tiles] same, per live-tile row tile
    cr5: bool                # R or the ⊥ row changed
    dirty_l_dev: torch.Tensor


class RowPackedSaturationEngine:
    """Compiles an indexed ontology into plans over transposed
    row-packed state on ``device``; :meth:`saturate` runs the fixed
    point.  API mirrors the reference engine: ``initial_state`` /
    ``step`` / ``saturate`` / ``embed_state``."""

    #: :meth:`embed_state` takes the packed transposed (v2 wire) form
    accepts_wire_state = True

    def __init__(
        self,
        idx: IndexedOntology,
        *,
        device="cuda",
        pad_multiple: int = 128,
        temp_budget_bytes: Optional[int] = None,
        rules: Optional[frozenset] = None,
        cr6_tiles: Optional[dict] = None,
        l_chunk: Optional[int] = None,
        l_chunk_cr4: Optional[int] = None,
        gate_chunks: Optional[bool] = None,
        unroll: Optional[int] = None,
        min_concepts: int = 0,
        min_links_pad: int = 0,
        link_window: Optional[Tuple[int, int]] = None,
        window_headroom: int = 0,
    ):
        """``rules``: subset of {"CR1".."CR6"} this engine applies (None
        = all).  ``cr6_tiles``: live-tile CR6 config (None = off; keys
        ``enable``, ``tile_m``, ``tile_l``, ``density_threshold``).
        ``l_chunk`` / ``l_chunk_cr4``: the L-chunk length (the frontier's
        granularity on the link axis and CR6's window length) and CR4's
        window length (at most ``l_chunk``), as the reference's knobs of
        the same names; None = from the temporary budget.
        ``gate_chunks``: gate CR5 on its inputs' change (None = the
        reference's rule: from 32,768 padded concepts up to 2.5 GiB of
        packed state).  ``unroll``: steps per convergence check (None =
        the reference's rule: 2 up to 4.5 GiB of packed state, else 1).

        The incremental plane's hooks (``core/incremental.py``), with
        the reference's names and meanings: ``min_concepts`` /
        ``min_links_pad`` reserve concept lanes and link rows past the
        corpus (a later delta's concepts and links park there; the link
        axis is never evened out, so ``l_chunk`` cannot move ``nl``);
        ``link_window=(w0, w1)`` restricts CR4/CR6 to links in
        ``[w0, w1)`` (the cross program of a link-creating delta; row
        rules and CR5 are unaffected, and with tiles configured CR6
        takes the live-tile schedule whatever its density);
        ``window_headroom``: live-window slots reserved per CR4/CR6
        chunk (and link tiles per row tile) for
        :meth:`rebind_role_closure`."""
        if rules is not None:
            unknown = set(rules) - {f"CR{i}" for i in range(1, 7)}
            if unknown:
                raise ValueError(f"unknown rules: {sorted(unknown)}")
        self.idx = idx
        self.device = torch.device(device)
        if temp_budget_bytes is None:
            temp_budget_bytes = default_temp_budget(self.device)
        self.temp_budget_bytes = int(temp_budget_bytes)
        pad_multiple = _pad_up(max(pad_multiple, 32), 32)
        self.nc = _pad_up(
            _pad_up(max(idx.n_concepts, min_concepts, 2), pad_multiple), 32
        )
        self.nl = max(_pad_up(idx.n_links, 32), 32, _pad_up(min_links_pad, 32))
        self._link_window = link_window
        self._window_headroom = int(window_headroom)
        self.wc = self.nc // 32
        dev = self.device
        state_bytes = (self.nc + self.nl) * self.wc * 4
        if unroll is None:
            unroll = 1 if state_bytes > UNROLL2_MAX_STATE_BYTES else 2
        self.unroll = max(int(unroll), 1)
        if gate_chunks is None:
            gate_chunks = (
                self.nc >= GATE_MIN_CONCEPTS
                and state_bytes <= GATE_MAX_STATE_BYTES
            )
        self._gate_cr5 = bool(gate_chunks)

        def on(rule: str) -> bool:
            return rules is None or rule in rules

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        empty2 = np.zeros((0, 2), np.int64)
        empty3 = np.zeros((0, 3), np.int64)

        # ---- CR1-CR3: seg-OR plans, sources permuted into plan order
        def rule_plan(tab, tgt_col, src_cols):
            plan = SegmentedRowOr(tab[:, tgt_col])
            return (plan, *[i64(tab[plan.order, c]) for c in src_cols])

        nf1 = idx.nf1 if on("CR1") else empty2
        self._p1, self._src1 = rule_plan(nf1, 1, (0,))
        nf2 = idx.nf2 if on("CR2") else empty3
        self._p2, self._src2a, self._src2b = rule_plan(nf2, 2, (0, 1))
        nf3 = idx.nf3 if on("CR3") else empty2
        self._p3, self._src3 = rule_plan(nf3, 1, (0,))
        # word-block sweep: each of CR1-CR3 is column-local (word w of a
        # target row depends only on word w of its sources), so blocks of
        # bw words bound the gathered [k, bw] temporaries
        emission_max = max(self._p1.k, 2 * self._p2.k, self._p3.k, 1)
        bw = max(min(self.temp_budget_bytes // (4 * emission_max), self.wc), 1)
        n_blocks = -(-self.wc // bw)
        self._bw = -(-self.wc // n_blocks)          # even the blocks out

        # ---- link tables: padded links get filler ⊤ (never ⊥, whose
        # CR5 mask bit is set) and the sentinel role (dead mask column)
        h = idx.role_closure
        n_roles = h.shape[0]
        fillers = np.full(self.nl, TOP_ID, np.int64)
        link_roles = np.full(self.nl, n_roles, np.int64)
        if idx.n_links:
            fillers[: idx.n_links] = idx.links[:, 1]
            link_roles[: idx.n_links] = idx.links[:, 0]
        self._fillers_np, self._link_roles_np = fillers, link_roles
        self._fillers, self._link_roles = i64(fillers), i64(link_roles)

        self._has4 = bool(len(idx.nf4) and idx.n_links and on("CR4"))
        self._has6 = bool(len(idx.chain_pairs) and idx.n_links and on("CR6"))
        self._bottom = bool(idx.has_bottom_axioms and idx.n_links and on("CR5"))
        m4, m6 = _factored_closure_tables(
            h,
            idx.nf4[:, 0] if self._has4 else None,
            idx.chain_pairs[:, 0] if self._has6 else None,
        )

        # ---- CR4/CR6 row chunks.  Chunk rows are bounded so one
        # chunk's packed output [rk, wc] fits the budget.  Once a table's
        # dense contraction is big enough for pruning to pay (the
        # reference's threshold), chunks cut at role-run boundaries (the
        # tables arrive role-sorted), so each chunk's live link set stays
        # small; runs merge greedily while the merged (rows × live links)
        # volume stays within ``waste`` of the parts' sum.
        mm_rows = max(self.temp_budget_bytes // (4 * self.wc), 1)
        link_cnt = (
            np.bincount(idx.links[:, 0], minlength=n_roles)
            if idx.n_links
            else np.zeros(n_roles, np.int64)
        )
        rows_max = max(
            len(idx.nf4) if self._has4 else 0,
            len(idx.chain_pairs) if self._has6 else 0,
        )
        big_tables = rows_max * self.nl * self.nc >= ROLE_SPLIT_MIN_VOLUME

        def role_chunks(tab_roles):
            n = len(tab_roles)
            if n == 0:
                return []
            if not big_tables:
                return [(o, min(o + mm_rows, n)) for o in range(0, n, mm_rows)]
            starts = np.flatnonzero(np.r_[True, tab_roles[1:] != tab_roles[:-1]])
            ends = np.r_[starts[1:], n]
            pieces = []
            for s, e in zip(starts, ends):
                rho = int(tab_roles[s])
                for o in range(s, e, mm_rows):
                    pieces.append((o, min(o + mm_rows, e), rho))

            def greedy(waste):
                out, cur = [], None
                for s, e, rho in pieces:
                    rset = h[:, rho] > 0
                    rmacs = (e - s) * int(link_cnt[rset].sum())
                    if cur is None:
                        cur = [s, e, rset.copy(), rmacs]
                        continue
                    nrows = e - cur[0]
                    nset = cur[2] | rset
                    nmacs = nrows * int(link_cnt[nset].sum())
                    if nrows <= mm_rows and nmacs <= waste * (cur[3] + rmacs):
                        cur[1], cur[2], cur[3] = e, nset, cur[3] + rmacs
                    else:
                        out.append((cur[0], cur[1]))
                        cur = [s, e, rset.copy(), rmacs]
                out.append((cur[0], cur[1]))
                return out

            for waste in (1.25, 2.0, 4.0, float("inf")):
                spans = greedy(waste)
                if len(spans) <= MAX_ROLE_CHUNKS:
                    break
            return spans

        spans4 = role_chunks(idx.nf4[:, 0]) if self._has4 else []
        spans6 = role_chunks(idx.chain_pairs[:, 0]) if self._has6 else []
        max_rk = max([a1 - a0 for a0, a1 in spans4 + spans6], default=1)

        # ---- the L-chunk grid: the [rk, lc] int8 operand within half the
        # budget and, with big tables, no longer than the link table's
        # mean role run (with a 256 floor), so windows resolve role runs;
        # then evened out over the chunk count as the reference does.
        # The grid may end past nl: windows there are cut at nl.
        if l_chunk is not None:
            lc = min(_pad_up(max(l_chunk, 32), 32), self.nl)
        else:
            lc = min(
                _pad_up(max(self.temp_budget_bytes // 2 // max_rk, 32), 32),
                self.nl,
            )
            if big_tables:
                n_link_roles = max(
                    len(np.unique(idx.links[:, 0])) if idx.n_links else 1, 1
                )
                lc = min(lc, max(_pad_up(-(-self.nl // n_link_roles), 32), 256))
        self.n_lchunks = -(-self.nl // lc)
        lc = _pad_up(-(-self.nl // self.n_lchunks), 32)
        self.lc = lc
        self._grid_end = self.n_lchunks * lc
        # CR4's windows may be finer; the frontier grid stays lc (a
        # window no wider than one L-chunk overlaps at most two)
        self.lc4 = (
            lc if l_chunk_cr4 is None
            else min(_pad_up(max(l_chunk_cr4, 32), 32), lc)
        )

        def live_windows(role_list, lcn):
            return self._live_windows(role_list, lcn, h)

        self._plans: dict = {}
        plan = self._plan

        def window_spans(spans, tab, lcn):
            """Each span's live windows, kept ``(a0, a1, windows)``, and
            the roles of the spans with none (dropped from the plan)."""
            kept, dropped = [], []
            for a0, a1 in spans:
                wins = live_windows(tab[a0:a1, 0], lcn)
                if wins is None:
                    dropped.append(np.unique(tab[a0:a1, 0]))
                else:
                    kept.append((a0, a1, wins))
            return kept, dropped

        def build_chunks(kept, tab, src_col, mask_tab):
            out = []
            for a0, a1, wins in kept:
                piece = SegmentedRowOr(tab[a0:a1, 2])
                out.append(_Chunk(
                    i64(tab[a0:a1, src_col]),
                    torch.as_tensor(mask_tab[a0:a1]).to(dev),
                    piece,
                    i64(piece.order),
                    wins,
                ))
            return out

        def slots(kept, dropped):
            """What :meth:`rebind_role_closure` may grow into: each kept
            span's window slots (its build-time windows plus the
            headroom), and the dropped spans' roles."""
            hw = self._window_headroom
            return [(a0, a1, len(w) + hw) for a0, a1, w in kept], dropped

        kept4, dropped4 = (
            window_spans(spans4, idx.nf4, self.lc4) if self._has4 else ([], [])
        )
        self._chunks4 = build_chunks(kept4, idx.nf4, 1, m4)
        self._slots4 = slots(kept4, dropped4)

        # ---- CR6: live-tile schedule when its live structure is sparse
        # enough (a link-window engine's always), else the same
        # role-chunked window formulation as CR4.  The window structure
        # is recorded either way: a rebind refuses where the reference's
        # window program would
        self._tiles6 = None
        self.cr6_tiles_stats = {"active": False, "reason": "off"}
        tcfg = self._normalize_cr6_tiles_cfg(cr6_tiles)
        self._chunks6 = []
        kept6, dropped6 = (
            window_spans(spans6, idx.chain_pairs, lc) if self._has6 else ([], [])
        )
        self._slots6 = slots(kept6, dropped6)
        if self._has6:
            cp = idx.chain_pairs
            if tcfg is not None:
                tm_eff = max(min(tcfg["tile_m"], _pad_up(len(cp), 8)), 8)
                sched = build_cr6_tile_schedule(
                    cp[:, 0], cp[:, 1], cp[:, 2], link_roles, h,
                    lc=lc, n_lchunks=self.n_lchunks,
                    tile_m=tm_eff, tile_l=tcfg["tile_l"],
                    group_bounds=_tile_group_bounds(
                        cp[:, 0], tm_eff, max(mm_rows // tm_eff, 1)
                    ),
                    link_window=link_window,
                    dead_link=self.nl - 1,
                    tile_headroom=self._window_headroom,
                )
                window_macs = sum(len(w) * lc * (a1 - a0) for a0, a1, w in kept6)
                tile_macs = sched.stats["occupied_slots"] * sched.tile_m
                density = tile_macs / max(float(window_macs), 1.0)
                self.cr6_tiles_stats = {
                    "active": (density <= tcfg["density_threshold"]
                               or link_window is not None),
                    "density": round(density, 4),
                    "window_slot_rows": window_macs,
                    "tile_slot_rows": tile_macs,
                    **sched.stats,
                }
                if self.cr6_tiles_stats["active"]:
                    self._tiles6 = sched
                else:
                    self.cr6_tiles_stats["reason"] = "density above threshold"
            if self._tiles6 is None:
                self._chunks6 = build_chunks(kept6, cp, 1, m6)
        self._t6 = None
        if self._tiles6 is not None:
            self._t6 = self._tile_tables(self._tiles6, m6)

        # ---- frontier reductions: per chunk, which frontier entries its
        # bit table reads (CSR: entry ids and their chunk), reduced on
        # the device so the host copy stays n_chunks + n_lchunks flags
        def csr(sets):
            ids = [np.asarray(s, np.int64) for s in sets]
            seg = [np.full(len(s), i, np.int64) for i, s in enumerate(ids)]
            cat = np.concatenate(ids) if ids else np.zeros(0, np.int64)
            segs = np.concatenate(seg) if seg else np.zeros(0, np.int64)
            return i64(cat), i64(segs)

        self._f4_csr = csr(
            np.unique(idx.nf4[a0:a1, 1]) for a0, a1, _w in kept4
        )
        self._f6_csr = csr(
            np.unique(idx.chain_pairs[a0:a1, 1] // lc)
            for a0, a1, _w in (kept6 if self._chunks6 else ())
        )
        n_rt = self._tiles6.n_rt if self._tiles6 is not None else 0
        self._flag_sizes = (
            self.n_lchunks, len(self._chunks4), len(self._chunks6), n_rt,
        )

        # live-column word mask: bits for x < n_concepts only
        wmask = np.zeros(self.wc, np.uint32)
        full, rem = divmod(idx.n_concepts, 32)
        wmask[:full] = 0xFFFFFFFF
        if rem:
            wmask[full] = (1 << rem) - 1
        self._wmask = torch.as_tensor(wmask.view(np.int32)).to(dev)
        #: per-rule wall seconds accumulated by :meth:`saturate` when
        #: ``profile=True`` (synchronised timings, for breakdowns only)
        self.rule_seconds: dict = {}
        #: per-round gating counts of the last :meth:`saturate`:
        #: ``{"cr4": [run, skipped], "cr6": [...], "cr6_tiles": [...],
        #: "cr5": ran}`` (windows, or link tiles for the live-tile CR6)
        self.gate_rounds: list = []

    def _plan(self, m, l) -> PackedColsMatmulPlan:
        """The product plan of an [m, l] operand against the state's
        words, one per shape (a method, not a closure over ``self``: a
        reference cycle would keep the engine's tables on the card past
        the last reference until a garbage collection)."""
        key = (m, l)
        if key not in self._plans:
            self._plans[key] = PackedColsMatmulPlan(
                m, l, self.wc, temp_budget_bytes=self.temp_budget_bytes
            )
        return self._plans[key]

    def _live_windows(self, role_list, lcn, h):
        """Static live windows ``[(off, end, c0, c1)]`` covering the
        links (inside the link window, if any) whose role is a
        (transitive) subrole under closure ``h`` of some role in
        ``role_list``; None when no link can satisfy them.  Window edges
        may include off-role links (their factored-mask entries are 0);
        the tail window clamps to the grid end (re-deriving earlier
        links is idempotent under OR) and is cut at nl."""
        croles = np.unique(role_list)
        rel = np.flatnonzero(h[:, croles].any(axis=1))
        live = np.flatnonzero(np.isin(self._link_roles_np, rel))
        if self._link_window is not None:
            w0, w1 = self._link_window
            live = live[(live >= w0) & (live < w1)]
        if live.size == 0:
            return None
        lc = self.lc
        wins = []
        i = 0
        while i < live.size:
            off = min(int(live[i]), self._grid_end - lcn)
            wins.append((
                off,
                min(off + lcn, self.nl),
                off // lc,
                min((off + lcn - 1) // lc, self.n_lchunks - 1),
            ))
            i = int(np.searchsorted(live, off + lcn))
        return wins

    def _tile_tables(self, t, m6: np.ndarray, mm=None) -> dict:
        """The live-tile CR6 schedule ``t`` as device tables, over the
        factored mask table ``m6``."""
        dev, lc = self.device, self.lc

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        n_tiles = [-(-len(lv) // t.tile_l) for lv in t.live_per_span]
        # per (row tile, link tile): the L-chunks its valid slots read,
        # for the host's launch decision
        tile_lchunks = [
            [np.unique(t.tids[rt, k][t.tval[rt, k]] // lc)
             for k in range(n_tiles[rt])]
            for rt in range(t.n_rt)
        ]
        return {
            "rows": i64(t.rows),
            # the factored mask rows, one all-zero row for pad slots
            "mask": torch.as_tensor(
                np.concatenate([m6, np.zeros((1, m6.shape[1]), np.int8)])
            ).to(dev),
            "mrow_ids": i64(t.mrow_ids),
            "tids": i64(t.tids),
            "tval": torch.as_tensor(t.tval).to(dev),
            "tchunk": i64(t.tids // lc),
            "fdx": i64(t.fdx),
            "n_tiles": n_tiles,
            "lchunks": tile_lchunks,
            "groups": [
                (rt0, rt1, p, i64(order)) for rt0, rt1, p, order, _tg in t.groups
            ],
            "mm": mm or make_tile_matmul(t.tile_m, t.tile_l, self.wc),
        }

    def plan_stats(self) -> dict:
        """Static plan sizes: state layout, rule table sizes, and the
        CR4/CR6 contraction structure (chunks, windows, tiles)."""
        t6 = self._t6["n_tiles"] if self._t6 is not None else []
        return {
            "nc": self.nc,
            "nl": self.nl,
            "wc": self.wc,
            "lc": self.lc,
            "lc4": self.lc4,
            "n_lchunks": self.n_lchunks,
            "word_block": self._bw,
            "seg_or_rows": [self._p1.k, self._p2.k, self._p3.k],
            "cr4_chunks": len(self._chunks4),
            "cr4_windows": sum(len(c.windows) for c in self._chunks4),
            "cr6_chunks": len(self._chunks6),
            "cr6_windows": sum(len(c.windows) for c in self._chunks6),
            "cr6_row_tiles": len(t6),
            "cr6_link_tiles": sum(t6),
            "cr6_tiles": self.cr6_tiles_stats.get("active", False),
            "cr5_gate": self._gate_cr5,
            "temp_budget_bytes": self.temp_budget_bytes,
        }

    def gate_totals(self) -> dict:
        """:attr:`gate_rounds` summed over the rounds of the last run."""
        out = {"cr4": [0, 0], "cr6": [0, 0], "cr6_tiles": [0, 0], "cr5": [0, 0]}
        for rnd in self.gate_rounds:
            for k in ("cr4", "cr6", "cr6_tiles"):
                out[k][0] += rnd[k][0]
                out[k][1] += rnd[k][1]
            if rnd["cr5"] is not None:
                out["cr5"][0 if rnd["cr5"] else 1] += 1
        return {k: {"contracted": v[0], "skipped": v[1]} for k, v in out.items()}

    @classmethod
    def _normalize_cr6_tiles_cfg(cls, raw) -> Optional[dict]:
        if raw is None:
            return None
        unknown = set(raw) - set(TILE_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown cr6_tiles keys: {sorted(unknown)}")
        cfg = {**TILE_DEFAULTS, **raw}
        if not cfg["enable"]:
            return None
        if cfg["tile_m"] < 1 or cfg["tile_l"] < 1:
            raise ValueError(f"cr6_tiles tile sizes must be >= 1: {cfg}")
        return cfg

    # ------------------------------------------------------------- state

    def _init_rows(self) -> np.ndarray:
        rows = np.arange(self.nc)
        sp = np.zeros((self.nc, self.wc), np.uint32)
        sp[rows, rows >> 5] = np.uint32(1) << (rows & 31).astype(np.uint32)
        sp[TOP_ID, :] = np.uint32(0xFFFFFFFF)
        return sp

    def _to_state(self, sp: np.ndarray, rp: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(sp).view(np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(rp).view(np.int32)).to(self.device),
        )

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """S(X) = {X, ⊤}, R empty: the diagonal plus a full ⊤ row —
        padded x columns evolve inertly and are masked from counts."""
        return self._to_state(
            self._init_rows(), np.zeros((self.nl, self.wc), np.uint32)
        )

    def initial_frontier(self) -> Frontier:
        """Everything dirty: every rule runs on the first step (and on
        the first step of a resume)."""
        n_l, n4, n6, n_rt = self._flag_sizes
        dl = torch.ones(n_l + 1, dtype=torch.bool, device=self.device)
        dl[n_l] = False
        return Frontier(
            True, np.ones(n_l, bool), np.ones(n4, bool), np.ones(n6, bool),
            np.ones(n_rt, bool), True, dl,
        )

    def embed_state(self, s_old, r_old, *, allow_shrink: bool = False):
        """Embed a previous closure into this engine's (possibly larger)
        arrays — the resume path.  Accepts the *packed transposed* wire
        form (uint32 numpy or int32 tensors, e.g. a snapshot's
        ``s_wire``/``r_wire`` or a result's ``packed_s``/``packed_r``)
        or *unpacked x-major* bool arrays.  Rows and words past this
        engine's arrays must be empty padding unless ``allow_shrink``.
        Packed-row reuse is sound because concept ids are append-only.
        Int32 tensors on this engine's device embed on the device (the
        incremental plane's path: the closure never visits the host);
        the result is always a fresh pair, never the caller's tensors."""
        if (
            isinstance(s_old, torch.Tensor)
            and self._on_device(s_old)
            and s_old.dtype == torch.int32
        ):
            return self._embed_device(s_old, r_old, allow_shrink)
        if isinstance(s_old, torch.Tensor):
            s_old = s_old.detach().cpu().numpy().view(np.uint32)
            r_old = r_old.detach().cpu().numpy().view(np.uint32)
        s_old, r_old = np.asarray(s_old), np.asarray(r_old)
        if s_old.dtype != np.uint32:
            s_old, r_old = self._pack_x_major(s_old, r_old)
        if not allow_shrink:
            for name, old, (nr, nw) in (
                ("S", s_old, (self.nc, self.wc)),
                ("R", r_old, (self.nl, self.wc)),
            ):
                if old[nr:].any() or old[:, nw:].any():
                    raise ValueError(
                        f"embed_state: old {name} state {old.shape} holds "
                        f"bits past this engine's [{nr}, {nw}] arrays; "
                        "realign the snapshot by name "
                        "(load_snapshot_state(path, idx=engine.idx)) or "
                        "pass allow_shrink=True to clip deliberately"
                    )
        sp = self._init_rows()
        na, nw = min(s_old.shape[0], self.nc), min(s_old.shape[1], self.wc)
        sp[:na, :nw] |= s_old[:na, :nw]
        rp = np.zeros((self.nl, self.wc), np.uint32)
        nlr, nwr = min(r_old.shape[0], self.nl), min(r_old.shape[1], self.wc)
        rp[:nlr, :nwr] = r_old[:nlr, :nwr]
        return self._to_state(sp, rp)

    def _on_device(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies on this engine's device (an engine built
        for ``"cuda"`` runs on the current card, and its tensors report
        that card's index)."""
        dev = t.device
        if dev.type != self.device.type:
            return False
        want = self.device.index
        if want is None and dev.type == "cuda":
            want = torch.cuda.current_device()
        return want is None or dev.index in (want, None)

    def _embed_device(self, s_old, r_old, allow_shrink: bool):
        """:meth:`embed_state` for device tensors: the S(X)={X,⊤} init
        built on the device, the old words ORed (S) or copied (R) in.
        Bits past this engine's arrays are checked only when the old
        arrays are larger (one scalar read)."""
        if not allow_shrink:
            for name, old, (nr, nw) in (
                ("S", s_old, (self.nc, self.wc)),
                ("R", r_old, (self.nl, self.wc)),
            ):
                if old.shape[0] > nr or old.shape[1] > nw:
                    if bool(old[nr:].any()) or bool(old[:, nw:].any()):
                        raise ValueError(
                            f"embed_state: old {name} state {tuple(old.shape)} "
                            f"holds bits past this engine's [{nr}, {nw}] arrays"
                        )
        dev = self.device
        rows = torch.arange(self.nc, device=dev)
        bit = torch.from_numpy(
            (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
        ).to(dev)
        sp = torch.zeros((self.nc, self.wc), dtype=torch.int32, device=dev)
        sp[rows, rows >> 5] = bit[rows & 31]
        sp[TOP_ID] = -1
        na, nw = min(s_old.shape[0], self.nc), min(s_old.shape[1], self.wc)
        sp[:na, :nw] |= s_old[:na, :nw]
        rp = torch.zeros((self.nl, self.wc), dtype=torch.int32, device=dev)
        nlr, nwr = min(r_old.shape[0], self.nl), min(r_old.shape[1], self.wc)
        rp[:nlr, :nwr] = r_old[:nlr, :nwr]
        return sp, rp

    @staticmethod
    def _pack_x_major(s: np.ndarray, r: np.ndarray):
        """x-major bool [x, a] / [x, l] → transposed uint32 wire rows."""
        def pack_rows(m: np.ndarray) -> np.ndarray:
            pad = (-m.shape[1]) % 32
            if pad:
                m = np.pad(m, ((0, 0), (0, pad)))
            b = np.packbits(np.asarray(m, bool), axis=1, bitorder="little")
            return np.ascontiguousarray(b).view(np.uint32)

        return pack_rows(s.T), pack_rows(r.T)

    # ------------------------------------------------------------- rules

    def _timed(self, name, fn, *args):
        if not self._profile:
            return fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.rule_seconds[name] = (
            self.rule_seconds.get(name, 0.0) + time.perf_counter() - t0
        )
        return out

    def _row_rules(self, sp, rp, s_cvs, r_cvs):
        """CR1, CR2, CR3 swept over word blocks of the state; each
        rule's change vector is the OR over its blocks."""
        cv = [None, None, None]
        for off in range(0, self.wc, self._bw):
            blk = slice(off, min(off + self._bw, self.wc))
            if self._p1.k:  # CR1: a ⊑ b
                red = self._p1.reduce(sp[self._src1, blk])
                c = self._p1.write(sp, red, blk, track="rows")
                cv[0] = c if cv[0] is None else cv[0] | c
            if self._p2.k:  # CR2: a1 ⊓ a2 ⊑ b
                red = self._p2.reduce(sp[self._src2a, blk] & sp[self._src2b, blk])
                c = self._p2.write(sp, red, blk, track="rows")
                cv[1] = c if cv[1] is None else cv[1] | c
            if self._p3.k:  # CR3: a ⊑ ∃link — reads S, writes R
                red = self._p3.reduce(sp[self._src3, blk])
                c = self._p3.write(rp, red, blk, track="rows")
                cv[2] = c if cv[2] is None else cv[2] | c
        for plan, c, out in (
            (self._p1, cv[0], s_cvs), (self._p2, cv[1], s_cvs),
            (self._p3, cv[2], r_cvs),
        ):
            if c is not None:
                out.append((plan.device_targets(sp.device), c))

    def _contract_chunk(self, bits_state, rp, chunk, live):
        """One CR4/CR6 row chunk: its packed [rk, wc] AND-OR product,
        OR-accumulated over its live windows (a window of R_T rows is a
        contiguous slice — no copy): the first live window writes the
        accumulator, every later one ORs into it in place.  None when
        no window is live (nothing launches)."""
        rk = chunk.src.shape[0]
        subt = None
        acc = None
        for (off, end, _c0, _c1), run in zip(chunk.windows, live):
            if not run:
                continue
            if subt is None:
                subt = bits_state[chunk.src].T.contiguous()   # [wc, rk]
            f = bit_lookup_from(
                subt, self._fillers[off:end], dtype=torch.int8
            )                                              # [l, rk]
            w = chunk.mask[:, self._link_roles[off:end]] * f.T
            acc = self._plan(rk, end - off)(w.contiguous(), rp[off:end], out=acc)
        return acc

    def _window_live(self, chunk, f, fr):
        dl = fr.dirty_l
        return [bool(f or dl[c0] or dl[c1]) for _o, _e, c0, c1 in chunk.windows]

    def _contract_rule(self, chunks, flags, bits_state, rp, target, fr, cvs,
                       counts):
        for chunk, f in zip(chunks, flags):
            live = self._window_live(chunk, f, fr)
            n_run = sum(live)
            counts[0] += n_run
            counts[1] += len(live) - n_run
            out = self._contract_chunk(bits_state, rp, chunk, live)
            if out is None:
                continue
            piece = chunk.piece
            cv = piece.write(target, piece.reduce(out[chunk.order]), track="rows")
            cvs.append((piece.device_targets(target.device), cv))

    def _cr4(self, sp, rp, fr, s_cvs, counts):
        self._contract_rule(self._chunks4, fr.f4, sp, rp, sp, fr, s_cvs, counts)

    def _cr6_windows(self, rp, fr, r_cvs, counts):
        self._contract_rule(self._chunks6, fr.f6, rp, rp, rp, fr, r_cvs, counts)

    def _cr6_tiles(self, rp, fr, r_cvs, counts):
        """Live-tile CR6: role-run row tiles contract only their densely
        packed live links — the [tile_m, tile_l] operand is (factored
        mask ∧ bit table ∧ slot liveness) against the gathered R rows.
        A slot is live when its link's L-chunk or an L-chunk of its row
        tile's source rows changed; a link tile with no live slot, and a
        row tile with no live link tile, launch nothing."""
        t6 = self._t6
        mm = t6["mm"]
        dl = fr.dirty_l
        for rt0, rt1, plan, order in t6["groups"]:
            outs, any_live = [], False
            for rt in range(rt0, rt1):
                fd = bool(fr.fd6[rt])
                tiles = [
                    k for k in range(t6["n_tiles"][rt])
                    if fd or dl[t6["lchunks"][rt][k]].any()
                ]
                counts[0] += len(tiles)
                counts[1] += t6["n_tiles"][rt] - len(tiles)
                acc = torch.zeros(
                    (mm.m, self.wc), dtype=torch.int32, device=rp.device
                )
                if tiles:
                    any_live = True
                    subt = rp[t6["rows"][rt]].T.contiguous()   # [wc, tile_m]
                for k in tiles:
                    ids = t6["tids"][rt, k]
                    live = t6["tval"][rt, k]
                    if not fd:
                        live = live & fr.dirty_l_dev[t6["tchunk"][rt, k]]
                    f = bit_lookup_from(
                        subt, self._fillers[ids], dtype=torch.int8
                    )                                      # [tile_l, tile_m]
                    w = (
                        t6["mask"][
                            t6["mrow_ids"][rt][:, None],
                            self._link_roles[ids][None, :],
                        ]
                        * f.T
                        * live.to(torch.int8)[None, :]
                    )
                    mm(w.contiguous(), rp[ids], out=acc)
                outs.append(acc)
            if not any_live:
                continue
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            cv = plan.write(rp, plan.reduce(out[order]), track="rows")
            r_cvs.append((plan.device_targets(rp.device), cv))

    def _cr5(self, sp, rp, s_cvs):
        """⊥ back-propagation: OR of the R rows whose filler is
        unsatisfiable, into the ⊥ row (in row blocks, so the masked copy
        stays bounded)."""
        botf = bit_lookup(
            sp, np.full(1, BOTTOM_ID), self._fillers, dtype=torch.bool
        )[:, 0]                                            # [nl]
        blk = max(self.temp_budget_bytes // (4 * self.wc), 1)
        red = torch.zeros(self.wc, dtype=torch.int32, device=sp.device)
        for i in range(0, self.nl, blk):
            masked = torch.where(botf[i : i + blk, None], rp[i : i + blk], 0)
            red |= or_reduce_any(masked, 0)
        old = sp[BOTTOM_ID].clone()
        sp[BOTTOM_ID] |= red
        s_cvs.append((
            torch.full((1,), BOTTOM_ID, dtype=torch.int64, device=sp.device),
            (sp[BOTTOM_ID] != old).any()[None],
        ))

    def _fold(self, s_cvs, r_cvs) -> Frontier:
        """The next step's frontier from this step's change vectors: one
        indexed OR a state matrix (targets are unique within a writer,
        and the order of writers does not matter for an OR), the per-
        chunk reductions on the device, and one copy of every flag to
        the host."""
        dev = self.device

        def mask(cvs, n):
            m = torch.zeros(n, dtype=torch.int32, device=dev)
            if cvs:
                t = torch.cat([t for t, _ in cvs])
                v = torch.cat([c for _, c in cvs]).to(torch.int32)
                m.index_add_(0, t, v)
            return m > 0

        def per_chunk(src, csr, n):
            ids, seg = csr
            out = torch.zeros(n, dtype=torch.int32, device=dev)
            if ids.numel():
                out.index_add_(0, seg, src[ids].to(torch.int32))
            return out > 0

        n_l, n4, n6, n_rt = self._flag_sizes
        mask_s = mask(s_cvs, self.nc)
        mask_r = mask(r_cvs, self._grid_end)
        dirty_l = mask_r.view(n_l, self.lc).any(dim=1)
        any_r = dirty_l.any()
        dl_ext = torch.cat([dirty_l, dirty_l.new_zeros(1)])
        parts = [
            (mask_s.any() | any_r)[None],
            dirty_l,
            per_chunk(mask_s, self._f4_csr, n4),
            per_chunk(dirty_l, self._f6_csr, n6),
        ]
        if n_rt:
            parts.append(dl_ext[self._t6["fdx"]].any(dim=1))
        parts.append((any_r | mask_s[BOTTOM_ID])[None])
        flags = torch.cat(parts).cpu().numpy()
        o = np.cumsum([1, n_l, n4, n6, n_rt])
        return Frontier(
            bool(flags[0]), flags[o[0]:o[1]], flags[o[1]:o[2]],
            flags[o[2]:o[3]], flags[o[3]:o[4]], bool(flags[o[4]]), dl_ext,
        )

    def step(self, sp: torch.Tensor, rp: torch.Tensor,
             frontier: Optional[Frontier] = None):
        """One superstep, in place: CR1, CR2, CR3, CR4, CR6, CR5, gated
        on ``frontier`` (None = everything dirty, as on a first step).
        Returns ``(sp, rp, frontier_next)``; ``frontier_next.changed``
        says whether any bit changed."""
        fr = self.initial_frontier() if frontier is None else frontier
        s_cvs, r_cvs = [], []
        rnd = {"cr4": [0, 0], "cr6": [0, 0], "cr6_tiles": [0, 0], "cr5": None}
        if self._p1.k or self._p2.k or self._p3.k:
            self._timed("cr1-3", self._row_rules, sp, rp, s_cvs, r_cvs)
        if self._chunks4:
            self._timed("cr4", self._cr4, sp, rp, fr, s_cvs, rnd["cr4"])
        if self._t6 is not None:
            self._timed("cr6", self._cr6_tiles, rp, fr, r_cvs, rnd["cr6_tiles"])
        elif self._chunks6:
            self._timed("cr6", self._cr6_windows, rp, fr, r_cvs, rnd["cr6"])
        if self._bottom:
            run = fr.cr5 or not self._gate_cr5
            rnd["cr5"] = run
            if run:
                self._timed("cr5", self._cr5, sp, rp, s_cvs)
        nxt = self._timed("read", self._fold, s_cvs, r_cvs)
        self.gate_rounds.append(rnd)
        return sp, rp, nxt

    _profile = False

    def rebind_role_closure(self, new_closure) -> bool:
        """Swap in a grown role closure: the factored masks, each
        chunk's live windows and the live-tile schedule are recomputed
        under ``new_closure``; chunks, write plans and frontier maps
        stay.  The caller re-enters the fixed point from the old state,
        a sound warm start because the closure only grew.

        Returns False, leaving the engine untouched, where the
        reference's unrolled program refuses: the closure is not a
        superset or has another shape, a span dropped at build (no live
        window) comes alive, or a span needs more windows than its
        build-time ones plus ``window_headroom`` — and, with the
        live-tile CR6, where the reference's tile re-fit refuses: a row
        tile needs more link tiles than the schedule has.  The port has
        no compiled program and could always rebind; refusing where the
        reference does keeps the incremental plane's ``path`` and
        ``iterations`` the reference's."""
        import dataclasses

        idx = self.idx
        h_old = np.asarray(idx.role_closure)
        h_new = np.asarray(new_closure, dtype=h_old.dtype)
        if h_new.shape != h_old.shape:
            return False
        ob, nb = h_old.astype(bool), h_new.astype(bool)
        if np.any(ob & ~nb):
            return False
        if np.array_equal(ob, nb):
            return True
        m4, m6 = _factored_closure_tables(
            h_new,
            idx.nf4[:, 0] if self._has4 else None,
            idx.chain_pairs[:, 0] if self._has6 else None,
        )
        windows = {}
        for key, (kept, dropped), tab, lcn in (
            ("cr4", self._slots4, idx.nf4, self.lc4),
            ("cr6", self._slots6, idx.chain_pairs, self.lc),
        ):
            for roles in dropped:
                if self._live_windows(roles, lcn, h_new) is not None:
                    return False        # a dead span came alive
            wins = []
            for a0, a1, n_slots in kept:
                w = self._live_windows(tab[a0:a1, 0], lcn, h_new) or []
                if len(w) > n_slots:
                    return False        # window slots exhausted
                wins.append((a0, a1, w))
            windows[key] = wins
        tiles6 = None
        if self._tiles6 is not None:
            cp = idx.chain_pairs
            t = self._tiles6
            tiles6 = build_cr6_tile_schedule(
                cp[:, 0], cp[:, 1], cp[:, 2], self._link_roles_np, h_old,
                lc=self.lc, n_lchunks=self.n_lchunks,
                tile_m=t.tile_m, tile_l=t.tile_l, group_bounds=[],
                link_window=self._link_window, dead_link=self.nl - 1,
                h_override=h_new, fit_schedule=t,
            )
            if tiles6 is None:
                return False            # link-tile slots exhausted
        # ---- every check passed: swap
        dev = self.device

        def rechunk(chunks, wins, m):
            return [
                c._replace(mask=torch.as_tensor(m[a0:a1]).to(dev), windows=w)
                for c, (a0, a1, w) in zip(chunks, wins)
            ]

        self._chunks4 = rechunk(self._chunks4, windows["cr4"], m4)
        if self._chunks6:
            self._chunks6 = rechunk(self._chunks6, windows["cr6"], m6)
        if tiles6 is not None:
            self._tiles6 = tiles6
            self._t6 = self._tile_tables(tiles6, m6, mm=self._t6["mm"])
            self.cr6_tiles_stats = dict(self.cr6_tiles_stats, **tiles6.stats)
        self.idx = dataclasses.replace(idx, role_closure=h_new)
        return True

    def count_live_bits(self, sp, rp) -> int:
        return _host_bit_total(live_bits(sp, rp, self._wmask))

    # -------------------------------------------------------- fixed point

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
        profile: bool = False,
        init_total: Optional[int] = None,
    ) -> SaturationResult:
        """Groups of ``unroll`` supersteps (one host read of the
        device's frontier flags a step) until a group changes nothing or
        the budget — ``max_iters`` rounded up to ``unroll`` — is spent.
        ``initial``: a previous closure for :meth:`embed_state` (its
        first step runs everything).  ``profile``: accumulate
        synchronised walls of each rule group, the initial state, the
        per-step frontier fold and read and the final bit count into
        :attr:`rule_seconds` (slower; for breakdowns only).
        ``init_total``: with ``initial``, skip the initial live-bit
        count and take this value (the incremental round-robin, which
        recounts under the full universe at the end); the result's
        ``derivations`` then means something only to that caller."""
        budget = _pad_up(max_iters, self.unroll)
        self._profile = bool(profile)
        self.gate_rounds = []
        try:
            if initial is None:
                sp, rp = self._timed("init", self.initial_state)
                init_total = fresh_init_total(self.idx)
            else:
                sp, rp = self._timed("init", self.embed_state, *initial)
                initial = None  # the embed copied it
                if init_total is None:
                    init_total = self.count_live_bits(sp, rp)
            it, fr, changed = 0, None, True
            while changed and it < budget:
                changed = False
                for _ in range(self.unroll):
                    sp, rp, fr = self.step(sp, rp, fr)
                    changed |= fr.changed
                it += self.unroll
            total = self._timed("count", self.count_live_bits, sp, rp)
        finally:
            self._profile = False
        converged = not changed
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        return SaturationResult(
            packed_s=sp,
            packed_r=rp,
            iterations=it,
            derivations=total - init_total,
            idx=self.idx,
            converged=converged,
        )
