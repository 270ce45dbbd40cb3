"""Saturation results and the derivation accounting shared by engines.

The port's counterpart of what the row-packed path needs from
``distel_tpu/core/engine.py``: :class:`SaturationResult` with the
transposed wire form, the padding helper, and the live-bit accounting
behind ``derivations``.

State layout (see ``core/rowpacked_engine.py``):

    S_T [a, xw]  — bit x of word xw set iff a ∈ S(x)
    R_T [l, xw]  — bit x set iff (x, filler(l)) ∈ R(role(l))

stored as int32 words carrying the uint32 bit pattern.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Set

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


def popcount_rows(p: torch.Tensor, wmask: torch.Tensor,
                  block: int = 8192) -> torch.Tensor:
    """Per-row popcount of ``p & wmask`` [N] int64, in row blocks so the
    int64 working copy stays bounded (SWAR popcount on the 32-bit word
    held in int64 — torch has no popcount op)."""
    out = []
    for i in range(0, p.shape[0], block):
        q = (p[i : i + block] & wmask[None, :]).to(torch.int64) & 0xFFFFFFFF
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
    device they were computed on (int32 tensors with uint32 bits) and
    are subsumer-major ([a, xw] / [l, xw]); ``s``/``r`` copy to the host,
    unpack lazily on first access, and present the x-major [x, a] /
    [x, l] view."""

    packed_s: torch.Tensor
    packed_r: torch.Tensor
    iterations: int
    derivations: int
    idx: IndexedOntology
    converged: bool = True
    _s: Optional[np.ndarray] = field(default=None, repr=False)
    _r: Optional[np.ndarray] = field(default=None, repr=False)

    def wire(self):
        """``(s_wire, r_wire)`` as host uint32 arrays — the snapshot
        form, bit-identical to the reference engine's ``packed_s``/
        ``packed_r``."""
        return (
            self.packed_s.detach().cpu().numpy().view(np.uint32),
            self.packed_r.detach().cpu().numpy().view(np.uint32),
        )

    @property
    def s(self) -> np.ndarray:
        if self._s is None:
            ps, _ = self.wire()
            self._s = _unpack_bits_host(ps, ps.shape[1] * 32).T
        return self._s

    @property
    def r(self) -> np.ndarray:
        if self._r is None:
            _, pr = self.wire()
            self._r = _unpack_bits_host(pr, pr.shape[1] * 32).T
        return self._r

    def subsumers(self, concept_id: int) -> Set[int]:
        return set(np.nonzero(self.s[concept_id])[0].tolist())

    def unsatisfiable(self) -> Set[int]:
        col = self.s[: self.idx.n_concepts, BOTTOM_ID]
        return set(np.nonzero(col)[0].tolist())
