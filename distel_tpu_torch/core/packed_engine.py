"""Bit-packed saturation engine: EL+ completion on x-major packed state.

The port of ``distel_tpu/core/packed_engine.py``'s single-device path.
The state is stored **x-major and packed**:

    S [x, aw]  int32 — bit a of word aw set iff a ∈ S(x)
    R [x, lw]  int32 — bit l set iff (x, filler(l)) ∈ R(role(l))

(int32 words carrying the uint32 bit pattern).  The rules, in the
reference's order within a step:

  CR1  S[:, b]  ∨= S[:, a]                     column gather → ColumnScatter
  CR2  S[:, b]  ∨= S[:, a1] ∧ S[:, a2]         column gathers → ColumnScatter
  CR3  R[:, l]  ∨= S[:, a]                     column gather → ColumnScatter
  CR4  S[:, b_j] ∨= (R ⊙ W)[:, j]              ``PackedMatmulPlan`` kernels
         W[k, j] = M4[k, j] ∧ S[filler(k), a_j]
  CR6  R[:, lt_p] ∨= (R ⊙ D)[:, p]             ``PackedMatmulPlan`` kernels
         D[k, p] = M6[k, p] ∧ R[filler(k), l2_p]
  CR5  S[:, ⊥]  ∨= any(R[x] ∧ botf)            one AND + any per row

where ``M4[k, j] = H[role(k), s_j]`` and ``M6[k, p] = H[role(k), r_p]``
are the static closure masks over the link rows k, laid out in the
product plan's ``bit_order``.

What differs from the reference, and why:

* The step runs in **row chunks**, written in place.  Every rule reads
  only its own row of S and R plus the distinct-filler rows (the W/D
  operands and CR5's ⊥ mask), and those are gathered from the pre-step
  state before the chunk loop — so chunking is exact.  It bounds the
  column gathers (at full width a whole-state CR1 gather is 7.6 GB of
  bytes), the scatters' temporaries and the CR4/CR6 outputs by
  :func:`~distel_tpu_torch.core.engine.default_temp_budget`.
* On a card, CR4 and CR6 share one listing of the chunk's R
  (``packed_andor_list``): both contract the same rows over the same
  k_p link rows, so the set bits are found once per chunk and step.
* The fixed point is a host loop with ``unroll`` semantics kept: one
  change check per group of ``unroll`` steps, ``iterations`` a multiple
  of ``unroll`` — the reference's ``lax.while_loop`` count, exactly.
* ``bucket=True`` is the reference's shape-only bucketing (the layout
  on the ladder).
* With nf4 axioms but no links, CR4 cannot fire, and this engine leaves
  their targets out of the S scatter.  The reference keeps them in its
  scatter plan with no matching source columns, which JAX broadcasts
  (a single CR1 source column is ORed into the nf4 targets too) or
  refuses; this engine derives only what the rules derive.

**Sharded execution** (``mesh=``, the reference's): S and R rows are
sharded over the concept axis, ``rows_per_shard`` rows a rank (the
concept padding multiplies by the mesh size).  Every rule reads its own
row, so all of a step is rank-local (the listing, both products, the
scatters, CR5's AND) but the distinct-filler rows the operands W, D and
CR5's mask are built from: each of them lives on one rank, so a masked
gather and a sum across the ranks is the row exchange
(:meth:`_filler_rows`).  The group's change vote is reduced across the
ranks, and so are the live bits.  The result is gathered on every rank.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.engine import (
    SaturationResult,
    _host_bit_total,
    _pad_up,
    check_embed_fits,
    default_temp_budget,
    fresh_init_total,
    popcount_rows,
)
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology
from distel_tpu_torch.ops.bitmatmul import PackedMatmulPlan
from distel_tpu_torch.parallel.shard_compat import (
    all_gather_rows,
    mesh_size,
    por_,
    psum_,
)
from distel_tpu_torch.ops.bitpack import (
    ColumnScatter,
    gather_bit_columns,
    gather_bit_matrix,
    pack_bool_columns,
)


class PackedSaturationEngine:
    """Compiles an indexed ontology into plans over x-major packed state
    on ``device``; :meth:`saturate` runs the fixed point.  API mirrors
    the reference engine: ``initial_state`` / ``step`` / ``saturate`` /
    ``embed_state``."""

    #: :meth:`embed_state` takes unpacked bool state only
    accepts_wire_state = False

    def __init__(
        self,
        idx: IndexedOntology,
        *,
        device="cuda",
        pad_multiple: int = 128,
        unroll: int = 4,
        mesh=None,
        bucket: bool = False,
        bucket_ratio: float = 1.25,
        temp_budget_bytes: Optional[int] = None,
    ):
        """``bucket``: the reference's shape-only bucketing — the concept
        and link padding ride the row-packed engine's ladder
        (``core/program_cache.bucket_dim``, ``bucket_ratio`` steps) with
        one row past the corpus, so the state layout is a rung's and
        checkpoints interchange with a bucketed run of the same corpus;
        the plans stay this corpus's (nothing is shared across
        ontologies).  ``mesh``: a :class:`~distel_tpu_torch.parallel.mesh.
        Mesh` to shard the rows over (see the module docstring)."""
        from distel_tpu_torch.core.program_cache import bucket_dim
        from distel_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {mesh!r}")
        self.mesh = mesh
        self.n_shards = mesh_size(mesh)
        self.idx = idx
        self.device = dev = torch.device(device)
        self.unroll = max(int(unroll), 1)
        if temp_budget_bytes is None:
            temp_budget_bytes = default_temp_budget(dev)
        self.temp_budget_bytes = int(temp_budget_bytes)
        pad_multiple = _pad_up(max(pad_multiple, 32), 32) * self.n_shards
        base_c = max(idx.n_concepts, 2)
        base_l = idx.n_links
        if bucket:
            base_c = bucket_dim(base_c + 1, bucket_ratio)
            base_l = bucket_dim(base_l + 1, bucket_ratio)
        self.nc = _pad_up(base_c, pad_multiple)
        self.nl = max(_pad_up(base_l, 32), 32)
        self.wc = self.nc // 32
        self.wl = self.nl // 32
        #: the rows a rank holds, and its first
        self.rows_per_shard = self.nc // self.n_shards
        self.row0 = (mesh.rank if mesh is not None else 0) * self.rows_per_shard

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        k4 = len(idx.nf4)
        p6 = len(idx.chain_pairs)
        # CR4/CR6 can only fire over existing links
        self._has4 = bool(k4 and idx.n_links)
        self._has6 = bool(p6 and idx.n_links)
        self._bottom = bool(idx.has_bottom_axioms and idx.n_links)
        #: product plans by (rule, chunk rows)
        self._plans: dict = {}
        # the plans' shared contraction order over the link rows
        order = PackedMatmulPlan(0, self.wl, 0).bit_order
        self.k_p = len(order)

        h = idx.role_closure
        link_roles = idx.links[:, 0] if idx.n_links else np.zeros(0, np.int64)
        fillers = np.zeros(self.nl, np.int64)
        if idx.n_links:
            fillers[: idx.n_links] = idx.links[:, 1]
        # the distinct filler universe: the only rows any rule reads
        # outside its own row.  dindex maps concept id → its position.
        dfill = (
            np.unique(idx.links[:, 1]) if idx.n_links else np.zeros(0, np.int64)
        )
        dindex = np.zeros(self.nc, np.int64)
        dindex[dfill] = np.arange(len(dfill))
        self._dfill = i64(dfill)

        # static per-rule tables in the plans' bit_order
        valid = order < idx.n_links
        f = np.where(valid, fillers[np.minimum(order, self.nl - 1)], 0)
        roles = np.where(
            valid, link_roles[np.minimum(order, max(idx.n_links - 1, 0))], 0
        ) if idx.n_links else np.zeros(len(order), np.int64)
        #: distinct-filler row of each link row k, in bit_order (W and D)
        self._drows = i64(dindex[f])
        h_dev = torch.as_tensor(h != 0).to(dev)

        def mask(rule_roles):
            """[k_p, n_p] int8: valid(k) ∧ H[role(k), rule_roles[j]],
            zero past n (built on the device in row blocks)."""
            n_p = PackedMatmulPlan(0, self.wl, len(rule_roles)).n_p
            m = torch.zeros((self.k_p, n_p), dtype=torch.int8, device=dev)
            cols = i64(rule_roles)
            rr, vv = i64(roles), torch.as_tensor(valid).to(dev)
            kb = max(self.temp_budget_bytes // max(h.shape[0] + n_p, 1), 1)
            for k0 in range(0, self.k_p, kb):
                k1 = min(k0 + kb, self.k_p)
                blk = h_dev[rr[k0:k1]][:, cols] & vv[k0:k1, None]
                m[k0:k1, : len(rule_roles)] = blk.view(torch.int8)
            return m

        if self._has4:
            self._m4 = mask(idx.nf4[:, 0])
            self._cols4 = i64(idx.nf4[:, 1])
        if self._has6:
            self._m6 = mask(idx.chain_pairs[:, 0])
            self._cols6 = i64(idx.chain_pairs[:, 1])
        # distinct-row position of every (plain-layout) link filler, for ⊥
        self._dplain = i64(dindex[fillers])

        # the rules' source columns
        self._c1 = i64(idx.nf1[:, 0])
        self._c2a, self._c2b = i64(idx.nf2[:, 0]), i64(idx.nf2[:, 1])
        self._c3 = i64(idx.nf3[:, 0])

        # scatter plans: one per state matrix, combining every rule that
        # writes it, targets in the order the step lists its sources
        s_targets = [idx.nf1[:, 1], idx.nf2[:, 2]]
        if self._has4:
            s_targets.append(idx.nf4[:, 2])
        if self._bottom:
            s_targets.append(np.array([BOTTOM_ID]))
        self._s_scatter = ColumnScatter(np.concatenate(s_targets), self.wc)
        r_targets = [idx.nf3[:, 1]]
        if self._has6:
            r_targets.append(idx.chain_pairs[:, 2])
        self._r_scatter = ColumnScatter(np.concatenate(r_targets), self.wl)

        # row chunk: every temporary of one chunk within the budget — the
        # held source columns (a byte each), plus the larger of one byte
        # gather and the scatter's (sources concatenated and gathered
        # into fold order, folded; the 32-slot grid, the packing's two
        # int64 temporaries; the words)
        n4 = PackedMatmulPlan(0, self.wl, k4).n_p if self._has4 else 0
        n6 = PackedMatmulPlan(0, self.wl, p6).n_p if self._has6 else 0
        widths = [len(idx.nf1), len(idx.nf2), len(idx.nf3), n4, n6, 1]
        k_src = max(self._s_scatter.n_sources, self._r_scatter.n_sources)
        touched = max(len(self._s_scatter.touched), len(self._r_scatter.touched))
        per_row = (
            sum(widths)
            + max(max(widths), 3 * k_src + 112 * touched)
            + 4 * self.wl                                  # CR5's AND
        )
        self.chunk_rows = int(min(max(self.temp_budget_bytes // per_row, 1),
                                  self.rows_per_shard))
        #: per-part wall seconds accumulated by :meth:`saturate` when
        #: ``profile=True`` (synchronised timings, for breakdowns only)
        self.rule_seconds: dict = {}

    _profile = False

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

    # ------------------------------------------------------------- plans

    def _plan(self, rule: str, rows: int) -> PackedMatmulPlan:
        key = (rule, rows)
        if key not in self._plans:
            n = len(self.idx.nf4) if rule == "cr4" else len(self.idx.chain_pairs)
            self._plans[key] = PackedMatmulPlan(
                rows, self.wl, n, temp_budget_bytes=self.temp_budget_bytes
            )
        return self._plans[key]

    def _mm(self, rule: str, a: torch.Tensor, b: torch.Tensor,
            lists) -> torch.Tensor:
        return self._plan(rule, a.shape[0])(a, b, lists=lists)

    def _list_rows(self, rpc: torch.Tensor):
        """One listing of the chunk's R rows for CR4 and CR6 on a card.
        None on the CPU, whose plain product needs none, and when the
        lists would pass the budget (each product then lists its own row
        slabs)."""
        if rpc.device.type != "cuda":
            return None
        plan = self._plan("cr4" if self._has4 else "cr6", rpc.shape[0])
        if len(plan.slabs(rpc.device)) > 1:
            return None
        return plan.list_rows(rpc, self.k_p)

    def plan_stats(self) -> dict:
        return {
            "nc": self.nc,
            "nl": self.nl,
            "k_p": self.k_p,
            "chunk_rows": self.chunk_rows,
            "chunks": -(-self.rows_per_shard // self.chunk_rows),
            "n_shards": self.n_shards,
            "cr4_columns": len(self.idx.nf4) if self._has4 else 0,
            "cr6_columns": len(self.idx.chain_pairs) if self._has6 else 0,
            "distinct_fillers": int(self._dfill.numel()),
            "temp_budget_bytes": self.temp_budget_bytes,
        }

    # ------------------------------------------------------------- state

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """S(X) = {X, ⊤}, R empty — the packed form of the reference's
        init (``init/AxiomLoader.java:1237-1245``); on a mesh, the rank's
        rows of it."""
        dev = self.device
        n = self.rows_per_shard
        rows = torch.arange(self.row0, self.row0 + n, device=dev)
        sp = torch.zeros((n, self.wc), dtype=torch.int32, device=dev)
        one = torch.ones((), dtype=torch.int32, device=dev)
        sp[rows - self.row0, rows >> 5] = one << (rows & 31).to(torch.int32)
        sp[:, TOP_ID >> 5] |= 1 << (TOP_ID & 31)
        rp = torch.zeros((n, self.wl), dtype=torch.int32, device=dev)
        return sp, rp

    def embed_state(self, s_old, r_old, *, allow_shrink: bool = False):
        """Embed an *unpacked* x-major bool state (e.g. a v1 snapshot, or
        ``load_snapshot_state(path, unpack=True)``) into this engine's
        packed tensors — the resume path.  Packed wire state is refused,
        as the reference refuses it."""
        if isinstance(s_old, torch.Tensor) or np.asarray(s_old).dtype == np.uint32:
            raise TypeError(
                "packed state is only understood by the row-packed engine; "
                "pass unpacked bool arrays (e.g. "
                "load_snapshot_state(path, unpack=True))"
            )
        s_old = np.asarray(s_old, bool)
        r_old = np.asarray(r_old, bool)
        check_embed_fits(
            allow_shrink,
            concepts=(s_old.shape[0], self.nc),
            subsumers=(s_old.shape[1], self.nc),
            link_rows=(r_old.shape[0], self.nc),
            links=(r_old.shape[1], self.nl),
        )
        nn = min(s_old.shape[0], self.nc)
        sc, rc = min(s_old.shape[1], self.nc), min(r_old.shape[1], self.nl)
        sp = np.zeros((self.nc, self.wc), np.uint32)
        rp = np.zeros((self.nc, self.wl), np.uint32)
        block = 4096
        for x0 in range(0, self.nc, block):
            x1 = min(x0 + block, self.nc)
            s = np.zeros((x1 - x0, self.nc), bool)
            s[np.arange(x1 - x0), np.arange(x0, x1)] = True
            s[:, TOP_ID] = True
            r = np.zeros((x1 - x0, self.nl), bool)
            if x0 < nn:
                e = min(x1, nn)
                s[: e - x0, :sc] |= s_old[x0:e, :sc]
                r[: e - x0, :rc] = r_old[x0:e, :rc]
            sp[x0:x1] = np.packbits(s, axis=1, bitorder="little").view(np.uint32)
            rp[x0:x1] = np.packbits(r, axis=1, bitorder="little").view(np.uint32)
        rows = slice(self.row0, self.row0 + self.rows_per_shard)
        return (
            torch.from_numpy(np.ascontiguousarray(sp[rows]).view(np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(rp[rows]).view(np.int32)).to(self.device),
        )

    # ------------------------------------------------------------- rules

    def _operand(self, mask, rows, cols) -> torch.Tensor:
        """``mask ∧ bits`` [k_p, n_p] int8 with ``bits[k, j] =
        bit(rows[self._drows[k]], cols[j])``, gathered in link-row blocks (a
        block's row gather, byte gather and AND within the budget)."""
        n = cols.numel()
        out = torch.zeros_like(mask)
        kb = max(self.temp_budget_bytes // (2 * n + 4 * rows.shape[1] + 1), 1)
        for k0 in range(0, self.k_p, kb):
            k1 = min(k0 + kb, self.k_p)
            bits = gather_bit_matrix(rows, self._drows[k0:k1], cols)
            out[k0:k1, :n] = mask[k0:k1, :n] & bits.view(torch.int8)
        return out

    def step(self, sp: torch.Tensor, rp: torch.Tensor):
        """One superstep, in place, in row chunks: CR1, CR2, CR3, CR4,
        CR6, CR5 (the sources of every rule read the pre-step state; the
        two scatters then write each chunk).  Returns ``(sp, rp,
        changed)`` with ``changed`` a 0-d bool tensor on the device."""
        changed = torch.zeros((), dtype=torch.bool, device=sp.device)
        w4, d6, botf = self._timed("operands", self._operands, sp, rp)
        # one listing serves both products: they contract k_p rows each
        assert all(t.shape[0] == self.k_p for t in (w4, d6) if t is not None)
        for x0 in range(0, sp.shape[0], self.chunk_rows):
            spc = sp[x0 : x0 + self.chunk_rows]
            rpc = rp[x0 : x0 + self.chunk_rows]
            s_src, r_src = self._timed("cr1-3", self._row_sources, spc)
            lists = None
            if w4 is not None or d6 is not None:
                lists = self._timed("list", self._list_rows, rpc)
            if w4 is not None:                                              # CR4
                s_src.append(self._timed("cr4", self._mm, "cr4", rpc, w4, lists))
            if d6 is not None:                                              # CR6
                r_src.append(self._timed("cr6", self._mm, "cr6", rpc, d6, lists))
            if botf is not None:                                            # CR5
                s_src.append(self._timed("cr5", self._cr5, rpc, botf))
            changed |= self._timed("scatter", self._s_scatter.apply_, spc, s_src)
            changed |= self._timed("scatter", self._r_scatter.apply_, rpc, r_src)
        return sp, rp, changed

    def _filler_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The distinct-filler rows of ``x`` (the rank's rows on a mesh),
        whole on every rank: the only rows any rule reads outside its
        own.  Each lives on one rank, so a masked gather and a sum across
        the ranks is the exchange (gloo's reduce of card tensors beat a
        gather staged through the host with two ranks on one H100 at the
        64k corpus: 8.4 GB in 18.9 s against 5.2 GB in 22.5 s a rank)."""
        if self.n_shards == 1:
            return x[self._dfill]
        local = self._dfill - self.row0
        ok = (local >= 0) & (local < self.rows_per_shard)
        part = torch.where(ok[:, None], x[local.clamp(0, self.rows_per_shard - 1)], 0)
        return psum_(part, self.mesh)

    def _operands(self, sp, rp):
        """The per-step operands every chunk shares, from the pre-step
        filler rows: CR4's W, CR6's D and CR5's packed ⊥-filler mask."""
        sf_rows = self._filler_rows(sp) if (self._has4 or self._bottom) else None
        w4 = d6 = botf = None
        if self._has4:
            w4 = self._operand(self._m4, sf_rows, self._cols4)
        if self._has6:
            d6 = self._operand(self._m6, self._filler_rows(rp), self._cols6)
        if self._bottom:
            botd = gather_bit_columns(sf_rows, np.full(1, BOTTOM_ID))[:, 0]
            botf = pack_bool_columns(botd[self._dplain][None, :])[0]   # [wl]
        return w4, d6, botf

    def _row_sources(self, spc):
        """CR1 and CR2's S sources and CR3's R source of one chunk."""
        s_src = [
            gather_bit_columns(spc, self._c1),                              # CR1
            gather_bit_columns(spc, self._c2a)
            & gather_bit_columns(spc, self._c2b),                           # CR2
        ]
        return s_src, [gather_bit_columns(spc, self._c3)]                   # CR3

    @staticmethod
    def _cr5(rpc, botf):
        return (rpc & botf).ne(0).any(dim=1, keepdim=True)

    def count_live_bits(self, sp, rp) -> int:
        """Set bits of the live rows (x < n_concepts) of S and R (on a
        mesh, summed over the ranks' rows)."""
        n = min(max(self.idx.n_concepts - self.row0, 0), sp.shape[0])
        if self.n_shards == 1:
            return _host_bit_total(popcount_rows(sp[:n])) + _host_bit_total(
                popcount_rows(rp[:n])
            )
        part = (popcount_rows(sp[:n]).sum() + popcount_rows(rp[:n]).sum()).reshape(1)
        return int(psum_(part, self.mesh).item())

    def gather_state(self, sp, rp):
        """The whole x-major pair on every rank from the ranks' rows (every
        rank must call it); off a mesh ``(sp, rp)``."""
        return all_gather_rows(sp, self.mesh), all_gather_rows(rp, self.mesh)

    # -------------------------------------------------------- fixed point

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
        profile: bool = False,
    ) -> SaturationResult:
        """Groups of ``unroll`` supersteps until a group changes nothing
        (one host read of the device's change flag per group) or the
        budget — ``max_iters`` rounded up to ``unroll`` — is spent.
        ``initial``: a previous x-major bool closure for
        :meth:`embed_state`.  ``profile``: accumulate synchronised walls
        of each part of the step, the initial state, the change-flag
        reads and the final bit count into :attr:`rule_seconds`."""
        budget = _pad_up(max_iters, self.unroll)
        self._profile = bool(profile)
        try:
            if initial is None:
                sp, rp = self._timed("init", self.initial_state)
                init_total = fresh_init_total(self.idx)
            else:
                sp, rp = self._timed("init", self.embed_state, *initial)
                init_total = self.count_live_bits(sp, rp)
            it, changed = 0, True
            while changed and it < budget:
                group = torch.zeros((), dtype=torch.bool, device=sp.device)
                for _ in range(self.unroll):
                    sp, rp, ch = self.step(sp, rp)
                    group |= ch
                it += self.unroll
                changed = self._timed("read", bool, por_(group, self.mesh))
            total = self._timed("count", self.count_live_bits, sp, rp)
        finally:
            self._profile = False
        converged = not changed
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        full_s, full_r = self.gather_state(sp, rp)
        return SaturationResult(
            packed_s=full_s,
            packed_r=full_r,
            iterations=it,
            derivations=total - init_total,
            idx=self.idx,
            converged=converged,
            transposed=False,
            shards=(sp, rp) if self.n_shards > 1 else None,
        )
