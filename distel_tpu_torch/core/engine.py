"""The dense engine, saturation results, and what the engines share.

The port of ``distel_tpu/core/engine.py``: the dense
:class:`SaturationEngine` (``engine="dense"``), :class:`SaturationResult`
in either state layout, the padding helper, the live-bit accounting
behind ``derivations``, the resume guard :func:`check_embed_fits`, and
:func:`default_temp_budget`, the one rule that sizes the packed
engines' temporaries.

State layouts, as int32 words carrying the uint32 bit pattern:

* transposed, subsumer-major (``core/rowpacked_engine.py``):
  ``S_T [a, xw]`` — bit x of word xw set iff a ∈ S(x);
  ``R_T [l, xw]`` — bit x set iff (x, filler(l)) ∈ R(role(l));
* x-major (``core/packed_engine.py``): ``S [x, aw]`` — bit a of word aw
  set iff a ∈ S(x); ``R [x, lw]`` — bit l set iff (x, filler(l)) ∈
  R(role(l)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Set, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology


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


@dataclass
class SaturationResult:
    """Result of a saturation run.  ``packed_s``/``packed_r`` stay on the
    device they were computed on (int32 tensors with uint32 bits).

    ``transposed=True`` marks row-packed-engine results, whose packed
    tensors are subsumer-major ([a, xw] / [l, xw]); ``transposed=False``
    marks packed-engine results, which are x-major ([x, aw] / [x, lw]).
    ``s``/``r`` copy to the host, unpack lazily on first access, and
    always present the x-major [x, a] / [x, l] view."""

    packed_s: torch.Tensor
    packed_r: torch.Tensor
    iterations: int
    derivations: int
    idx: IndexedOntology
    converged: bool = True
    transposed: bool = True
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
    layout.  One convergence read a step: the iteration count is the
    reference's at ``unroll=1``."""

    #: :meth:`embed_state` takes unpacked x-major bool state
    accepts_wire_state = False

    def __init__(self, idx: IndexedOntology, *, device="cuda",
                 pad_multiple: int = 128):
        from distel_tpu_torch.ops.bitpack import SegmentedRowOr

        self.idx = idx
        self.device = dev = torch.device(device)
        self.nc = _pad_up(max(idx.n_concepts, 2), _pad_up(max(pad_multiple, 32), 32))
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
        """S(X) = {X, ⊤} for every concept; R empty."""
        s = torch.eye(self.nc, dtype=torch.bool, device=self.device)
        s[TOP_ID, :] = True
        r = torch.zeros((self.nl, self.nc), dtype=torch.bool, device=self.device)
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
        return (
            torch.as_tensor(np.ascontiguousarray(s.T)).to(self.device),
            torch.as_tensor(np.ascontiguousarray(r.T)).to(self.device),
        )

    # ------------------------------------------------------------- rules

    def _andor(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """AND-OR semiring product of bool matrices: a matmul, ``> 0``."""
        return (a.to(self._dtype) @ b.to(self._dtype)) > 0

    def step(self, s: torch.Tensor, r: torch.Tensor):
        """One superstep in place: CR1, CR2, CR3, CR4, CR6, CR5.
        Returns ``(s, r, changed)`` with ``changed`` a 0-d bool tensor
        on the device."""
        ch = torch.zeros((), dtype=torch.bool, device=s.device)
        if self._p1.k:
            ch |= self._p1.write(s, self._p1.reduce(s[self._src1]))
        if self._p2.k:
            red = self._p2.reduce(s[self._src2a] & s[self._src2b])
            ch |= self._p2.write(s, red)
        if self._p3.k:
            ch |= self._p3.write(r, self._p3.reduce(s[self._src3]))
        if self._has4:
            w = self._m4 & s[self._a4][:, self._fillers]        # [k4, nl]
            ch |= self._p4.write(s, self._p4.reduce(self._andor(w, r)))
        if self._has6:
            d = self._m6 & r[self._l2][:, self._fillers]        # [p6, nl]
            ch |= self._p6.write(r, self._p6.reduce(self._andor(d, r)))
        if self._bottom:
            botf = s[BOTTOM_ID, self._fillers]                   # [nl]
            new = self._andor(botf[None, :], r)[0]
            ch |= (new & ~s[BOTTOM_ID]).any()
            s[BOTTOM_ID] |= new
        return s, r, ch

    def count_live_bits(self, s, r) -> int:
        n = self.idx.n_concepts
        return int(s[:, :n].sum()) + int(r[:, :n].sum())

    # -------------------------------------------------------- fixed point

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
    ) -> "SaturationResult":
        """Run supersteps until one changes nothing (one host read a
        step) or ``max_iters`` ran.  ``initial``: a previous closure for
        :meth:`embed_state`."""
        from distel_tpu_torch.ops.bitpack import pack_bool_columns

        if initial is None:
            s, r = self.initial_state()
            init_total = fresh_init_total(self.idx)
        else:
            s, r = self.embed_state(*initial)
            init_total = self.count_live_bits(s, r)
        it, changed = 0, True
        while changed and it < max_iters:
            s, r, ch = self.step(s, r)
            it += 1
            changed = bool(ch)
        if changed and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {max_iters} iterations"
            )
        total = self.count_live_bits(s, r)
        return SaturationResult(
            packed_s=pack_bool_columns(s),
            packed_r=pack_bool_columns(r),
            iterations=it,
            derivations=total - init_total,
            idx=self.idx,
            converged=not changed,
        )
