"""Row-packed saturation engine: transposed, scatter-free.

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
link windows whose roles can satisfy it (role-aware chunking + static
live windows).  CR6 runs the live-tile schedule (``core/cr6_tiles.py``)
when its live structure is sparse enough.

What differs from the reference, and why:

* The fixed point is a host loop with one convergence read per round;
  there is no ``lax.while_loop`` to compile.  PyTorch runs eagerly, so
  there is no scan mode and no unrolled-chunk mode either: chunks are a
  Python loop.
* No frontier gating: every live window is contracted every round.
  Gating only delays derivations (every rule is a monotone OR), so the
  closure and the derivation count are unchanged; the iteration count
  can differ from the reference's.
* Rows are written in place (the state is the largest tensor of a run).
* Temporaries are sized against the device's memory (an 80 GB H100)
  rather than the 16 GB v5e the reference's thresholds were measured on
  — see ``core/engine.py``'s :func:`default_temp_budget`.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

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
    ):
        """``rules``: subset of {"CR1".."CR6"} this engine applies (None
        = all).  ``cr6_tiles``: live-tile CR6 config
        (None = off; keys ``enable``, ``tile_m``, ``tile_l``,
        ``density_threshold``)."""
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
        self.nc = _pad_up(_pad_up(max(idx.n_concepts, 2), pad_multiple), 32)
        # the link axis is never evened out to a window grid (windows
        # clamp at the tail instead), so nl never exceeds the reference
        # engine's and snapshots interchange both ways
        self.nl = max(_pad_up(idx.n_links, 32), 32)
        self.wc = self.nc // 32
        dev = self.device

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

        # ---- role-aware row chunking for CR4/CR6: the tables arrive
        # role-sorted, so chunks cut at role-run boundaries keep each
        # chunk's live link set small; runs merge greedily while the
        # merged (rows × live links) volume stays within ``waste`` of the
        # parts' sum.  Chunk rows are bounded so one chunk's packed
        # output [rk, wc] fits the budget.
        mm_rows = max(self.temp_budget_bytes // (4 * self.wc), 1)
        link_cnt = (
            np.bincount(idx.links[:, 0], minlength=n_roles)
            if idx.n_links
            else np.zeros(n_roles, np.int64)
        )

        def role_chunks(tab_roles):
            n = len(tab_roles)
            if n == 0:
                return []
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
        # window length: the [rk, lc] int8 operand within half the
        # budget, and no longer than the link table's mean role run (with
        # a 256 floor), so windows resolve role runs
        n_link_roles = max(
            len(np.unique(idx.links[:, 0])) if idx.n_links else 1, 1
        )
        lc = min(
            _pad_up(max(self.temp_budget_bytes // 2 // max_rk, 32), 32),
            max(_pad_up(-(-self.nl // n_link_roles), 32), 256),
            self.nl,
        )
        self.lc = lc

        def live_windows(role_list):
            """Static window offsets covering the links whose role is a
            (transitive) subrole of some role in ``role_list``; None
            when no link can satisfy them.  Window edges may include
            off-role links (their factored-mask entries are 0) and the
            tail window clamps to ``nl - lc`` (re-deriving earlier links
            is idempotent under OR)."""
            croles = np.unique(role_list)
            rel = np.flatnonzero(h[:, croles].any(axis=1))
            live = np.flatnonzero(np.isin(link_roles, rel))
            if live.size == 0:
                return None
            offs = []
            i = 0
            while i < live.size:
                off = min(int(live[i]), self.nl - lc)
                offs.append(off)
                i = int(np.searchsorted(live, off + lc))
            return offs

        self._plans: dict = {}

        def plan(m, l):
            key = (m, l)
            if key not in self._plans:
                self._plans[key] = PackedColsMatmulPlan(
                    m, l, self.wc, temp_budget_bytes=self.temp_budget_bytes
                )
            return self._plans[key]

        def build_chunks(spans, tab, src_col, mask_tab):
            """[(src rows, mask rows, seg-OR piece, windows, plan)] —
            chunks with no live window are dropped outright."""
            out = []
            for a0, a1 in spans:
                wins = live_windows(tab[a0:a1, 0])
                if wins is None:
                    continue
                piece = SegmentedRowOr(tab[a0:a1, 2])
                out.append(
                    (
                        i64(tab[a0:a1, src_col]),
                        torch.as_tensor(mask_tab[a0:a1]).to(dev),
                        piece,
                        i64(piece.order),
                        wins,
                        plan(a1 - a0, lc),
                    )
                )
            return out

        self._chunks4 = build_chunks(spans4, idx.nf4, 1, m4) if self._has4 else []

        # ---- CR6: live-tile schedule when its live structure is sparse
        # enough, else the same role-chunked window formulation as CR4
        self._tiles6 = None
        self.cr6_tiles_stats = {"active": False, "reason": "off"}
        tcfg = self._normalize_cr6_tiles_cfg(cr6_tiles)
        self._chunks6 = []
        if self._has6:
            cp = idx.chain_pairs
            if tcfg is not None:
                tm_eff = max(min(tcfg["tile_m"], _pad_up(len(cp), 8)), 8)
                # write groups bound the deferred [rows, wc] output
                g_rows = max(mm_rows // tm_eff, 1) * tm_eff
                sched = build_cr6_tile_schedule(
                    cp[:, 0], cp[:, 1], cp[:, 2], m6, link_roles, h,
                    lc=lc, n_lchunks=-(-self.nl // lc),
                    tile_m=tm_eff, tile_l=tcfg["tile_l"],
                    group_bounds=list(range(0, len(cp), g_rows)) + [len(cp)],
                    dead_link=self.nl - 1,
                )
                window_macs = sum(
                    len(live_windows(cp[a0:a1, 0]) or ()) * lc * (a1 - a0)
                    for a0, a1 in spans6
                )
                tile_macs = sched.stats["occupied_slots"] * sched.tile_m
                density = tile_macs / max(float(window_macs), 1.0)
                self.cr6_tiles_stats = {
                    "active": density <= tcfg["density_threshold"],
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
                self._chunks6 = build_chunks(spans6, cp, 1, m6)
        if self._tiles6 is not None:
            t = self._tiles6
            n_tiles = [-(-len(lv) // t.tile_l) for lv in t.live_per_span]
            self._t6 = {
                "rows": torch.as_tensor(t.rows.astype(np.int64)).to(dev),
                "mrows": torch.as_tensor(t.mrows).to(dev),
                "tids": torch.as_tensor(t.tids.astype(np.int64)).to(dev),
                "tval": torch.as_tensor(t.tval.astype(np.int8)).to(dev),
                "n_tiles": n_tiles,
                "groups": [
                    (rt0, rt1, p, i64(order))
                    for rt0, rt1, p, order, _tg in t.groups
                ],
                "mm": make_tile_matmul(t.tile_m, t.tile_l, self.wc),
            }

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

    def plan_stats(self) -> dict:
        """Static plan sizes: state layout, rule table sizes, and the
        CR4/CR6 contraction structure (chunks, windows, tiles)."""
        t6 = self._t6["n_tiles"] if self._tiles6 is not None else []
        return {
            "nc": self.nc,
            "nl": self.nl,
            "wc": self.wc,
            "lc": self.lc,
            "word_block": self._bw,
            "seg_or_rows": [self._p1.k, self._p2.k, self._p3.k],
            "cr4_chunks": len(self._chunks4),
            "cr4_windows": sum(len(c[4]) for c in self._chunks4),
            "cr6_chunks": len(self._chunks6),
            "cr6_windows": sum(len(c[4]) for c in self._chunks6),
            "cr6_row_tiles": len(t6),
            "cr6_link_tiles": sum(t6),
            "cr6_tiles": self.cr6_tiles_stats.get("active", False),
            "temp_budget_bytes": self.temp_budget_bytes,
        }

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

    def embed_state(self, s_old, r_old, *, allow_shrink: bool = False):
        """Embed a previous closure into this engine's (possibly larger)
        arrays — the resume path.  Accepts the *packed transposed* wire
        form (uint32 numpy or int32 tensors, e.g. a snapshot's
        ``s_wire``/``r_wire`` or a result's ``packed_s``/``packed_r``)
        or *unpacked x-major* bool arrays.  Rows and words past this
        engine's arrays must be empty padding unless ``allow_shrink``.
        Packed-row reuse is sound because concept ids are append-only."""
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

    @staticmethod
    def _pack_x_major(s: np.ndarray, r: np.ndarray):
        """x-major bool [x, a] / [x, l] → transposed uint32 wire rows."""
        def pack_rows(m: np.ndarray) -> np.ndarray:
            pad = (-m.shape[1]) % 32
            if pad:
                m = np.pad(m, ((0, 0), (0, pad)))
            b = np.packbits(m.astype(bool), axis=1, bitorder="little")
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

    def _row_rules(self, sp, rp, changed):
        """CR1, CR2, CR3 swept over word blocks of the state."""
        for off in range(0, self.wc, self._bw):
            blk = slice(off, min(off + self._bw, self.wc))
            if self._p1.k:  # CR1: a ⊑ b
                red = self._p1.reduce(sp[self._src1, blk])
                changed |= self._p1.write(sp, red, blk)
            if self._p2.k:  # CR2: a1 ⊓ a2 ⊑ b
                red = self._p2.reduce(sp[self._src2a, blk] & sp[self._src2b, blk])
                changed |= self._p2.write(sp, red, blk)
            if self._p3.k:  # CR3: a ⊑ ∃link — reads S, writes R
                red = self._p3.reduce(sp[self._src3, blk])
                changed |= self._p3.write(rp, red, blk)
        return changed

    def _contract_chunk(self, bits_state, rp, chunk):
        """One CR4/CR6 row chunk: its packed [rk, wc] AND-OR product,
        OR-accumulated over its live windows (a window of R_T rows is a
        contiguous slice — no copy): the first window writes the
        accumulator, every later one ORs into it in place."""
        src_rows, mask_rows, _piece, _order, wins, mm = chunk
        lc = self.lc
        subt = bits_state[src_rows].T.contiguous()         # [wc, rk]
        acc = None
        for off in wins:
            f = bit_lookup_from(
                subt, self._fillers[off : off + lc], dtype=torch.int8
            )                                              # [lc, rk]
            w = mask_rows[:, self._link_roles[off : off + lc]] * f.T
            acc = mm(w.contiguous(), rp[off : off + lc], out=acc)
        return acc

    def _cr4(self, sp, rp, changed):
        for chunk in self._chunks4:
            out = self._contract_chunk(sp, rp, chunk)
            piece, order = chunk[2], chunk[3]
            changed |= piece.write(sp, piece.reduce(out[order]))
        return changed

    def _cr6_windows(self, rp, changed):
        for chunk in self._chunks6:
            out = self._contract_chunk(rp, rp, chunk)
            piece, order = chunk[2], chunk[3]
            changed |= piece.write(rp, piece.reduce(out[order]))
        return changed

    def _cr6_tiles(self, rp, changed):
        """Live-tile CR6: role-run row tiles contract only their densely
        packed live links — the [tile_m, tile_l] operand is (factored
        mask ∧ bit table ∧ slot validity) against the gathered R rows."""
        t6 = self._t6
        mm = t6["mm"]
        for rt0, rt1, plan, order in t6["groups"]:
            outs = []
            for rt in range(rt0, rt1):
                subt = rp[t6["rows"][rt]].T.contiguous()   # [wc, tile_m]
                acc = torch.zeros(
                    (mm.m, self.wc), dtype=torch.int32, device=rp.device
                )
                for k in range(t6["n_tiles"][rt]):
                    ids = t6["tids"][rt, k]
                    f = bit_lookup_from(
                        subt, self._fillers[ids], dtype=torch.int8
                    )                                      # [tile_l, tile_m]
                    w = (
                        t6["mrows"][rt][:, self._link_roles[ids]]
                        * f.T
                        * t6["tval"][rt, k][None, :]
                    )
                    mm(w.contiguous(), rp[ids], out=acc)
                outs.append(acc)
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            changed |= plan.write(rp, plan.reduce(out[order]))
        return changed

    def _cr5(self, sp, rp, changed):
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
        return changed | (sp[BOTTOM_ID] != old).any()

    def step(self, sp: torch.Tensor, rp: torch.Tensor):
        """One superstep, in place: CR1, CR2, CR3, CR4, CR6, CR5.
        Returns ``(sp, rp, changed)`` with ``changed`` a 0-d bool tensor
        on the device (no host synchronisation)."""
        changed = torch.zeros((), dtype=torch.bool, device=sp.device)
        if self._p1.k or self._p2.k or self._p3.k:
            changed = self._timed("cr1-3", self._row_rules, sp, rp, changed)
        if self._chunks4:
            changed = self._timed("cr4", self._cr4, sp, rp, changed)
        if self._tiles6 is not None:
            changed = self._timed("cr6", self._cr6_tiles, rp, changed)
        elif self._chunks6:
            changed = self._timed("cr6", self._cr6_windows, rp, changed)
        if self._bottom:
            changed = self._timed("cr5", self._cr5, sp, rp, changed)
        return sp, rp, changed

    _profile = False

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
    ) -> SaturationResult:
        """Run supersteps until one changes nothing (one host read of
        the device's change flag per round) or ``max_iters`` rounds
        ran.  ``initial``: a previous closure for :meth:`embed_state`.
        ``profile``: accumulate synchronised walls of each rule group,
        the initial state, the per-round change-flag read and the final
        bit count into :attr:`rule_seconds` (slower; for breakdowns
        only)."""
        self._profile = bool(profile)
        try:
            if initial is None:
                sp, rp = self._timed("init", self.initial_state)
                init_total = fresh_init_total(self.idx)
            else:
                sp, rp = self._timed("init", self.embed_state, *initial)
                init_total = self.count_live_bits(sp, rp)
            it, changed = 0, True
            while changed and it < max_iters:
                sp, rp, ch = self.step(sp, rp)
                it += 1
                changed = self._timed("read", bool, ch)
            total = self._timed("count", self.count_live_bits, sp, rp)
        finally:
            self._profile = False
        converged = not changed
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {max_iters} iterations"
            )
        return SaturationResult(
            packed_s=sp,
            packed_r=rp,
            iterations=it,
            derivations=total - init_total,
            idx=self.idx,
            converged=converged,
        )
