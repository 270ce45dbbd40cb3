"""Saturation results and what the engines share.

The port's counterpart of what its engines need from
``distel_tpu/core/engine.py``: :class:`SaturationResult` in either state
layout, the padding helper, the live-bit accounting behind
``derivations``, the resume guard :func:`check_embed_fits`, and
:func:`default_temp_budget`, the one rule that sizes both engines'
temporaries.

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

from distel_tpu_torch.core.indexing import BOTTOM_ID, IndexedOntology


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
