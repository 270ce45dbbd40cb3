"""The dense engine, saturation results, and what the engines share.

The port of ``distel_tpu/core/engine.py``: the dense
:class:`SaturationEngine` (``engine="dense"``), :class:`SaturationResult`
in either state layout, the padding helper, the live-bit accounting
behind ``derivations``, the resume guard :func:`check_embed_fits`,
:func:`default_temp_budget`, the one rule that sizes the packed
engines' temporaries, and :func:`observed_loop`, the superstep/observer
protocol both engines' ``saturate_observed`` share.

State layouts, as int32 words carrying the uint32 bit pattern:

* transposed, subsumer-major (``core/rowpacked_engine.py``):
  ``S_T [a, xw]`` — bit x of word xw set iff a ∈ S(x);
  ``R_T [l, xw]`` — bit x set iff (x, filler(l)) ∈ R(role(l));
* x-major (``core/packed_engine.py``): ``S [x, aw]`` — bit a of word aw
  set iff a ∈ S(x); ``R [x, lw]`` — bit l set iff (x, filler(l)) ∈
  R(role(l)).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Set, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology
from distel_tpu_torch.parallel.shard_compat import (
    all_gather_words,
    mesh_size,
    por_,
    por_bits,
    psum_,
)
from distel_tpu_torch.runtime.instrumentation import DISPATCH_EVENTS


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _unpack_bits_host(p: np.ndarray, m: int) -> np.ndarray:
    """uint32 [N, W] words → bool [N, m], little-endian bit order."""
    b = np.unpackbits(
        np.ascontiguousarray(p).view(np.uint8), axis=1, bitorder="little"
    )
    return b[:, :m].view(np.bool_)


def _host_bit_total(bits) -> int:
    """Sum per-row popcounts in int64 on the host."""
    if isinstance(bits, torch.Tensor):
        bits = bits.detach().cpu().numpy()
    return int(np.asarray(bits, np.int64).sum())


def fresh_init_total(idx: IndexedOntology) -> int:
    """Live bits of the S(X)={X,⊤} initial state: one diagonal bit per
    live concept plus the full ⊤ row, overlapping at (⊤, ⊤)."""
    return 2 * idx.n_concepts - 1


def default_temp_budget(device: torch.device) -> int:
    """Bytes one rule's temporaries may take.  On a card: 1/32 of its
    memory, clamped to [64 MiB, 2 GiB] — 2 GiB on an 80 GB H100, where
    the 64k-class state is under 2 GB, so a few live temporaries of
    this size leave most of the card free.  On the CPU: 256 MiB, which
    keeps the CPU tests' working sets small."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(min(max(total // 32, 64 << 20), 2 << 30))
    return 256 << 20


def check_embed_fits(allow_shrink: bool, **dims: Tuple[int, int]) -> None:
    """Refuse to silently clip a shrinking universe on resume.

    ``dims`` maps an axis name to ``(old, new)``; any ``old > new`` means
    the caller is embedding a state whose universe exceeds this engine's.
    Concept ids are append-only, so that only happens on a mismatched
    snapshot, and clipping would warm-start from a silently truncated
    closure.  Name-realign instead (``load_snapshot_state(..., idx=idx)``)
    or opt in explicitly."""
    if allow_shrink:
        return
    over = {k: v for k, v in dims.items() if v[0] > v[1]}
    if over:
        detail = ", ".join(f"{k}: {o} > {n}" for k, (o, n) in over.items())
        raise ValueError(
            f"embed_state: old state exceeds this engine's universe "
            f"({detail}); realign the snapshot by name "
            f"(load_snapshot_state(path, idx=engine.idx)) or pass "
            f"allow_shrink=True to clip deliberately"
        )


def popcount_rows(p: torch.Tensor, wmask: Optional[torch.Tensor] = None,
                  block: int = 8192) -> torch.Tensor:
    """Per-row popcount of ``p & wmask`` (of all of ``p`` when ``wmask``
    is None) [N] int64, in row blocks so the int64 working copy stays
    bounded (SWAR popcount on the 32-bit word held in int64 — torch has
    no popcount op)."""
    out = []
    for i in range(0, p.shape[0], block):
        q = p[i : i + block]
        if wmask is not None:
            q = q & wmask[None, :]
        q = q.to(torch.int64) & 0xFFFFFFFF
        q = q - ((q >> 1) & 0x55555555)
        q = (q & 0x33333333) + ((q >> 2) & 0x33333333)
        q = (q + (q >> 4)) & 0x0F0F0F0F
        q = ((q * 0x01010101) & 0xFFFFFFFF) >> 24
        out.append(q.sum(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=p.device)
    return torch.cat(out)


def live_bits(sp: torch.Tensor, rp: torch.Tensor, wmask: torch.Tensor):
    """Per-row popcount over live x columns, [nc + nl] int64, on the
    state's device.  ``wmask`` [wc] int32 keeps bits x < n_concepts."""
    return torch.cat([popcount_rows(sp, wmask), popcount_rows(rp, wmask)])


def to_host(x):
    """A round's observables on the host: tensors become Python scalars
    (0-d) or numpy arrays; anything else passes through.  The one
    blocking read of a round, the counterpart of the reference's
    ``fetch_global``."""
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.item() if x.dim() == 0 else x.numpy()
    return x


def observed_loop(
    observe_step, s, r, init_total: int, unroll: int, budget: int, observer,
    state_observer=None, pipeline_depth: int = 1, round_stats=None,
):
    """Shared superstep/observer protocol of both engines'
    ``saturate_observed``: run ``observe_step`` (returning
    ``(s, r, changed, live_bits)``) until convergence or budget, calling
    ``observer(iteration, derivations, changed)`` after each round.

    ``pipeline_depth > 1`` runs the loop PIPELINED: up to ``depth``
    rounds are dispatched before the oldest round's ``changed``/``bits``
    fold is retired from the in-flight queue.  Each round runs on the
    calling thread when it is dispatched (its launches are queued on the
    card's stream); only the host read of its observables waits for the
    retire.  The retired sequence (per-round totals, observer calls,
    the final state) equals the synchronous loop's: the same steps run
    in the same order, only the host-side fetch is deferred.  On
    convergence at round N, the ≤depth-1 speculatively dispatched extra
    rounds are no-ops at the fixed point (every rule is a monotone OR):
    they are dropped unretired and excluded from iteration/derivation
    accounting.

    ``state_observer(iteration, derivations, changed, s, r)`` — if given
    — additionally receives the live state after each round, so a long
    run can snapshot mid-flight; the callback runs synchronously between
    rounds.  The engines step in place, so a speculative round would
    already have rewritten the state the callback reads: a
    ``state_observer`` forces ``pipeline_depth`` to 1.

    ``round_stats(iteration, delta, changed, dispatch_s, retire_s,
    inflight)`` — if given — is called once per RETIRED round with the
    round's derivation delta and its host-time split (``inflight`` is
    the queue occupancy when the round was dispatched; 0 means it was
    dispatched synchronously), before ``observer``.

    The state arrives in the calling engine's working layout — packed
    transposed int32 words from ``RowPackedSaturationEngine``, unpacked
    transposed bool from the dense :class:`SaturationEngine` — so a
    snapshot callback is engine-specific."""
    depth = max(int(pipeline_depth), 1)
    if state_observer is not None:
        depth = 1
    iteration, converged, total = 0, False, init_total
    dispatched = 0
    pending = deque()  # (iteration_after, (changed, bits), dispatch_s)
    while True:
        # keep the queue full: dispatch until it holds ``depth`` rounds
        # (depth 1 == the synchronous loop)
        while dispatched < budget and len(pending) < depth:
            t0 = time.perf_counter()
            s, r, changed_dev, bits = observe_step(s, r)
            dispatch_s = time.perf_counter() - t0
            dispatched += unroll
            DISPATCH_EVENTS.record_dense()
            pending.append((dispatched, (changed_dev, bits), dispatch_s))
        if not pending:
            break  # budget exhausted without convergence
        it_after, handle, dispatch_s = pending.popleft()
        inflight = len(pending)
        t0 = time.perf_counter()
        changed, bits_host = to_host(handle)
        retire_s = time.perf_counter() - t0
        prev_total = total
        total = _host_bit_total(bits_host)
        iteration = it_after
        if round_stats is not None:
            round_stats(
                iteration, total - prev_total, bool(changed),
                dispatch_s, retire_s, inflight,
            )
        if observer is not None:
            observer(iteration, total - init_total, bool(changed))
        if state_observer is not None:
            state_observer(
                iteration, total - init_total, bool(changed), s, r
            )
        if not changed:
            converged = True
            break
    return s, r, iteration, total, converged


@dataclass
class SaturationResult:
    """Result of a saturation run.  ``packed_s``/``packed_r`` stay on the
    device they were computed on (int32 tensors with uint32 bits).

    ``transposed=True`` marks row-packed-engine results, whose packed
    tensors are subsumer-major ([a, xw] / [l, xw]); ``transposed=False``
    marks packed-engine results, which are x-major ([x, aw] / [x, lw]).
    ``s``/``r`` copy to the host, unpack lazily on first access, and
    always present the x-major [x, a] / [x, l] view.

    A sharded run (``mesh=``) gathers the whole closure into
    ``packed_s``/``packed_r`` on every rank and keeps the rank's own
    shards of the state in ``shards``."""

    packed_s: torch.Tensor
    packed_r: torch.Tensor
    iterations: int
    derivations: int
    idx: IndexedOntology
    converged: bool = True
    transposed: bool = True
    #: ``(S shard, R shard)`` of this rank after a sharded run, else None
    shards: Optional[tuple] = field(default=None, repr=False)
    _s: Optional[np.ndarray] = field(default=None, repr=False)
    _r: Optional[np.ndarray] = field(default=None, repr=False)

    def wire(self):
        """``(packed_s, packed_r)`` as host uint32 arrays in this
        result's own layout, bit-identical to the reference engine's
        ``packed_s``/``packed_r`` (for a transposed result, the v2
        snapshot's wire form)."""
        return (
            self.packed_s.detach().cpu().numpy().view(np.uint32),
            self.packed_r.detach().cpu().numpy().view(np.uint32),
        )

    def live_digest(self) -> str:
        """sha256 of the closure's live part in this result's packed
        layout: the rows and words of the real concepts (and, for R, the
        real links' rows or bits), the last word masked to them — equal
        for equal closures whatever their padding (a mesh pads the
        concept axis to its multiple)."""
        import hashlib

        n, nl = self.idx.n_concepts, self.idx.n_links
        s, r = self.wire()
        if self.transposed:
            parts = ((s[:n], n), (r[:nl], n))
        else:
            parts = ((s[:n], n), (r[:n], nl))
        h = hashlib.sha256()
        for p, bits in parts:
            words = p[:, : -(-bits // 32)].copy()
            if bits % 32:
                words[:, -1] &= np.uint32((1 << (bits % 32)) - 1)
            h.update(np.ascontiguousarray(words).tobytes())
        return h.hexdigest()

    def _x_major(self, p: np.ndarray) -> np.ndarray:
        u = _unpack_bits_host(p, p.shape[1] * 32)
        return u.T if self.transposed else u

    @property
    def s(self) -> np.ndarray:
        if self._s is None:
            self._s = self._x_major(self.wire()[0])
        return self._s

    @property
    def r(self) -> np.ndarray:
        if self._r is None:
            self._r = self._x_major(self.wire()[1])
        return self._r

    def subsumers(self, concept_id: int) -> Set[int]:
        return set(np.nonzero(self.s[concept_id])[0].tolist())

    def unsatisfiable(self) -> Set[int]:
        col = self.s[: self.idx.n_concepts, BOTTOM_ID]
        return set(np.nonzero(col)[0].tolist())


class SaturationEngine:
    """The dense engine: the port of ``distel_tpu/core/engine.py``'s
    ``SaturationEngine``, EL+ completion as boolean tensor algebra over
    unpacked state on ``device``.

    The state is stored subsumer-major, one bool per bit, so every rule
    writes whole rows (the transpose of the reference's S [x, a] and
    R [x, l]; each rule is the same relation):

      S_T [a, x]  bool — a ∈ S(x)
      R_T [l, x]  bool — (x, filler(l)) ∈ R(role(l))

      CR1  S_T[b] ∨= S_T[a]                 seg-OR row write
      CR2  S_T[b] ∨= S_T[a1] ∧ S_T[a2]
      CR3  R_T[l] ∨= S_T[a]
      CR4  S_T[b_j] ∨= (Wᵀ ⊙ R_T)[j]          Wᵀ[j, l] = H[role(l), s_j]
                                             ∧ a_j ∈ S(filler(l))
      CR6  R_T[lt_p] ∨= (Dᵀ ⊙ R_T)[p]         Dᵀ[p, l] = H[role(l), r_p]
                                             ∧ (filler(l), filler(l2_p)) ∈ R
      CR5  S_T[⊥] ∨= botf ⊙ R_T             botf[l] = ⊥ ∈ S(filler(l))

    in that order, each rule reading the state its predecessors left
    (every axiom of one rule reads the state before that rule's write,
    as the reference's scatter-max does).  The AND-OR products are
    plain matmuls tested ``> 0``, as in the reference (no kernel): in
    bfloat16 on a card (nonnegative terms, so any positive sum stays
    positive under rounding) and float32 on the CPU (exact below 2^24
    terms).  The result is packed in the row-packed engine's transposed
    layout.  Steps run in groups of ``unroll`` (the reference's default
    of 4) with one convergence read a group, so ``iterations`` and the
    ``max_iters`` budget are the reference's.

    On a mesh (``mesh=``) the concept axis x — the reference's sharded
    rows, the columns here — is sharded, padded to the mesh multiple.
    The reference leaves the collectives to GSPMD; here they are
    written out: the rules read other ranks' columns only at the link
    fillers (CR4's and CR6's bit tables, CR5's ⊥ mask), so those
    columns are exchanged (:meth:`_filler_cols`), and the group's change
    vote and the live bits are reduced.  The result is gathered on
    every rank."""

    #: :meth:`embed_state` takes unpacked x-major bool state
    accepts_wire_state = False

    def __init__(self, idx: IndexedOntology, *, device="cuda",
                 pad_multiple: int = 128, unroll: int = 4, mesh=None):
        from distel_tpu_torch.ops.bitpack import SegmentedRowOr
        from distel_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {mesh!r}")
        self.mesh = mesh
        self.n_shards = mesh_size(mesh)
        self.idx = idx
        self.unroll = max(int(unroll), 1)
        self.device = dev = torch.device(device)
        self.nc = _pad_up(max(idx.n_concepts, 2),
                          _pad_up(max(pad_multiple, 32), 32) * self.n_shards)
        #: the concept columns a rank holds, and its first
        self.cols_per_shard = self.nc // self.n_shards
        self.col0 = (mesh.rank if mesh is not None else 0) * self.cols_per_shard
        self.nl = max(_pad_up(idx.n_links, 32), 32)
        self._dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        def plan(tab, tgt_col, src_cols):
            p = SegmentedRowOr(tab[:, tgt_col])
            return (p, *[i64(tab[p.order, c]) for c in src_cols])

        self._p1, self._src1 = plan(idx.nf1, 1, (0,))
        self._p2, self._src2a, self._src2b = plan(idx.nf2, 2, (0, 1))
        self._p3, self._src3 = plan(idx.nf3, 1, (0,))
        # fillers of every (padded) link; padded links point at ⊥'s row
        # but have all-False mask entries, so they never fire
        fillers = np.zeros(self.nl, np.int64)
        h = idx.role_closure
        link_roles = idx.links[:, 0] if idx.n_links else np.zeros(0, np.int64)
        if idx.n_links:
            fillers[: idx.n_links] = idx.links[:, 1]
        self._fillers = i64(fillers)

        def closure_mask(roles):
            """[rows, nl]: H[role(l), roles[j]] (the reference's M4/M6,
            transposed)."""
            m = np.zeros((len(roles), self.nl), bool)
            if len(roles) and idx.n_links:
                m[:, : idx.n_links] = h[link_roles][:, roles].T
            return torch.as_tensor(m).to(dev)

        self._has4 = bool(len(idx.nf4))
        if self._has4:
            self._p4, self._a4 = plan(idx.nf4, 2, (1,))
            self._m4 = closure_mask(idx.nf4[self._p4.order, 0])
        self._has6 = bool(len(idx.chain_pairs))
        if self._has6:
            self._p6, self._l2 = plan(idx.chain_pairs, 2, (1,))
            self._m6 = closure_mask(idx.chain_pairs[self._p6.order, 0])
        self._bottom = bool(idx.has_bottom_axioms and idx.n_links)

    # ------------------------------------------------------------ state

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """S(X) = {X, ⊤} for every concept; R empty (on a mesh, the
        rank's columns of them)."""
        n, x0 = self.cols_per_shard, self.col0
        s = torch.zeros((self.nc, n), dtype=torch.bool, device=self.device)
        x = torch.arange(n, device=self.device)
        s[x + x0, x] = True
        s[TOP_ID, :] = True
        r = torch.zeros((self.nl, n), dtype=torch.bool, device=self.device)
        return s, r

    def embed_state(self, s_old, r_old, *, allow_shrink: bool = False):
        """Embed a previous saturated state, given x-major as the
        reference's (``s_old`` [x, a], ``r_old`` [x, l] bool), into this
        engine's padded arrays; new rows get the S(X)={X,⊤} init."""
        s_old, r_old = np.asarray(s_old), np.asarray(r_old)
        if s_old.dtype == np.uint32:
            raise TypeError(
                "packed transposed state (uint32) is only understood by "
                "the row-packed engine; pass unpacked bool arrays (e.g. "
                "load_snapshot_state(path, unpack=True))"
            )
        no, lo = s_old.shape[0], r_old.shape[1]
        check_embed_fits(
            allow_shrink,
            concepts=(no, self.nc),
            subsumers=(s_old.shape[1], self.nc),
            link_rows=(r_old.shape[0], self.nc),
            links=(lo, self.nl),
        )
        s = np.eye(self.nc, dtype=bool)
        s[:, TOP_ID] = True
        nn = min(no, self.nc)
        na = min(s_old.shape[1], self.nc)
        s[:nn, :na] |= s_old[:nn, :na].astype(bool)
        r = np.zeros((self.nc, self.nl), dtype=bool)
        r[:nn, : min(lo, self.nl)] = r_old[:nn, : min(lo, self.nl)]
        x = slice(self.col0, self.col0 + self.cols_per_shard)
        return (
            torch.as_tensor(np.ascontiguousarray(s[x].T)).to(self.device),
            torch.as_tensor(np.ascontiguousarray(r[x].T)).to(self.device),
        )

    # ------------------------------------------------------------- rules

    def _andor(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """AND-OR semiring product of bool matrices: a matmul, ``> 0``."""
        return (a.to(self._dtype) @ b.to(self._dtype)) > 0

    def _filler_cols(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows[:, filler(l)]`` for every link l [k, nl]: on a mesh each
        rank reads the fillers in its columns and the parts are ORed
        across the ranks (each column lives on one rank)."""
        if self.n_shards == 1:
            return rows[:, self._fillers]
        local = self._fillers - self.col0
        ok = (local >= 0) & (local < self.cols_per_shard)
        part = rows[:, local.clamp(0, self.cols_per_shard - 1)] & ok[None, :]
        return por_bits(part, self.mesh)

    def step(self, s: torch.Tensor, r: torch.Tensor):
        """One superstep in place: CR1, CR2, CR3, CR4, CR6, CR5.
        Returns ``(s, r, changed)`` with ``changed`` a 0-d bool tensor
        on the device (this rank's columns' change on a mesh)."""
        ch = torch.zeros((), dtype=torch.bool, device=s.device)
        if self._p1.k:
            ch |= self._p1.write(s, self._p1.reduce(s[self._src1]))
        if self._p2.k:
            red = self._p2.reduce(s[self._src2a] & s[self._src2b])
            ch |= self._p2.write(s, red)
        if self._p3.k:
            ch |= self._p3.write(r, self._p3.reduce(s[self._src3]))
        if self._has4:
            w = self._m4 & self._filler_cols(s[self._a4])       # [k4, nl]
            ch |= self._p4.write(s, self._p4.reduce(self._andor(w, r)))
        if self._has6:
            d = self._m6 & self._filler_cols(r[self._l2])       # [p6, nl]
            ch |= self._p6.write(r, self._p6.reduce(self._andor(d, r)))
        if self._bottom:
            botf = self._filler_cols(s[BOTTOM_ID][None])[0]      # [nl]
            new = self._andor(botf[None, :], r)[0]
            ch |= (new & ~s[BOTTOM_ID]).any()
            s[BOTTOM_ID] |= new
        return s, r, ch

    def _live_bits(self, s, r) -> torch.Tensor:
        """Live bits (columns x < n_concepts), a 1-element tensor on the
        device, summed over the ranks on a mesh."""
        n = min(max(self.idx.n_concepts - self.col0, 0), self.cols_per_shard)
        return psum_((s[:, :n].sum() + r[:, :n].sum()).reshape(1), self.mesh)

    def count_live_bits(self, s, r) -> int:
        return int(self._live_bits(s, r).item())

    def _observe_round(self, s, r):
        """One round of :meth:`saturate_observed`: ``unroll`` supersteps
        plus the live-bit count, both left on the device."""
        changed = torch.zeros((), dtype=torch.bool, device=s.device)
        for _ in range(self.unroll):
            s, r, ch = self.step(s, r)
            changed |= ch
        return s, r, por_(changed, self.mesh), self._live_bits(s, r)[0]

    def _result(self, s, r, iterations, derivations, converged):
        """The packed closure, gathered on every rank on a mesh (the
        rank's packed columns in ``shards``)."""
        from distel_tpu_torch.ops.bitpack import pack_bool_columns

        ps, pr = pack_bool_columns(s), pack_bool_columns(r)
        return SaturationResult(
            packed_s=all_gather_words(ps, self.mesh),
            packed_r=all_gather_words(pr, self.mesh),
            iterations=iterations,
            derivations=derivations,
            idx=self.idx,
            converged=converged,
            shards=(ps, pr) if self.n_shards > 1 else None,
        )

    def saturate_observed(
        self,
        max_iters: int = 10_000,
        *,
        observer=None,
        state_observer=None,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
        pipeline_depth: int = 1,
    ) -> "SaturationResult":
        """Fixed point with per-superstep observation (the reference's
        progress plane).  ``observer`` is called after every round of
        ``unroll`` supersteps with ``(iteration, derivations_so_far,
        changed)``; ``state_observer`` also gets the live (unpacked,
        transposed) state.  With ``pipeline_depth > 1`` up to that many
        rounds are in flight before their host folds retire (see
        :func:`observed_loop`).  The rounds are :meth:`saturate`'s, so
        the closure, ``iterations`` and ``derivations`` are too."""
        if initial is None:
            s, r = self.initial_state()
        else:
            s, r = self.embed_state(*initial)
        init_total = self.count_live_bits(s, r)
        budget = _pad_up(max_iters, self.unroll)
        s, r, iteration, total, converged = observed_loop(
            self._observe_round, s, r, init_total, self.unroll, budget,
            observer, state_observer=state_observer,
            pipeline_depth=pipeline_depth,
        )
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        return self._result(s, r, iteration, total - init_total, converged)

    # -------------------------------------------------------- fixed point

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
    ) -> "SaturationResult":
        """Groups of ``unroll`` supersteps until a group changes
        nothing (one host read a group) or the budget — ``max_iters``
        rounded up to ``unroll`` — is spent.  ``initial``: a previous
        closure for :meth:`embed_state`."""
        budget = _pad_up(max_iters, self.unroll)
        if initial is None:
            s, r = self.initial_state()
            init_total = fresh_init_total(self.idx)
        else:
            s, r = self.embed_state(*initial)
            init_total = self.count_live_bits(s, r)
        it, changed = 0, True
        while changed and it < budget:
            group = torch.zeros((), dtype=torch.bool, device=s.device)
            for _ in range(self.unroll):
                s, r, ch = self.step(s, r)
                group |= ch
            it += self.unroll
            changed = bool(por_(group, self.mesh))
        if changed and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        total = self.count_live_bits(s, r)
        return self._result(s, r, it, total - init_total, not changed)
