"""Bitset primitives: boolean matrices packed 32 columns to a 32-bit word.

Layout (the "standard" layout, shared with ``core/engine.py``'s wire
form): logical column ``c`` lives in word ``c >> 5``, bit ``c & 31``
(little-endian within the word).

Words are stored as ``torch.int32`` carrying the uint32 bit pattern:
PyTorch has no shifts for ``torch.uint32`` on every backend, while
``(w >> p) & 1`` is exact on int32 for every ``p`` up to 31 (the
arithmetic shift's sign fill is masked away).  Cross into numpy with
``.numpy().view(np.uint32)``.  The column gathers and
:func:`pack_bool_columns` also read words as their four little-endian
bytes (the byte order of every host and card PyTorch runs on), where
logical column ``c`` is bit ``c & 7`` of byte ``c >> 3``.

All functions take and return tensors on the caller's device; none of
them synchronises with the device.
"""

from __future__ import annotations

import numpy as np
import torch

_ONE = 1


def to_words(a: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy words → int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(a, np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device, copy=True)


def from_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor words → uint32 numpy array with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def pack_bool_columns(x: torch.Tensor) -> torch.Tensor:
    """bool [N, M] (M % 32 == 0) → int32 [N, M/32], standard layout.

    Eight bools at a time: their bytes, read as one little-endian int64,
    hold bit j at bit 8j; three shift-ORs (by 7, 14, 28) gather the
    eight bits into the low byte, so the low bytes of four such int64s
    are one word.  Bit 63 is never set, so the arithmetic shifts fill
    with zeros.  Seven elementwise passes instead of 32 strided ones."""
    n, m = x.shape
    if x.numel() == 0:
        return torch.zeros((n, m // 32), dtype=torch.int32, device=x.device)
    q = x.contiguous().view(torch.uint8).view(torch.int64)
    q = q | (q >> 7)
    q |= q >> 14
    q |= q >> 28
    return q.to(torch.uint8).view(torch.int32).reshape(n, m // 32)


def unpack_words(p: torch.Tensor, m: int, dtype=torch.bool) -> torch.Tensor:
    """int32 [N, W] → ``dtype`` [N, m] (m <= 32*W), standard layout."""
    shifts = torch.arange(32, dtype=torch.int32, device=p.device)
    bits = ((p[:, :, None] >> shifts) & _ONE).to(dtype)
    return bits.reshape(p.shape[0], -1)[:, :m]


def unpack_words_planes(p: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """int32 [N, W] → ``dtype`` [N, 32*W] in **bit-plane-major** order:
    output position ``pl*W + w`` holds bit ``pl`` of word ``w`` (logical
    column ``32*w + pl``).  Each plane narrows to ``dtype`` at once, so
    no [N, W, 32] int32 intermediate exists."""
    return torch.cat([((p >> pl) & _ONE).to(dtype) for pl in range(32)], dim=1)


def pack_planes(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`unpack_words_planes`: bool/int [N, 32*W] in
    bit-plane-major order → int32 [N, W]."""
    n, m = bits.shape
    w = m // 32
    out = torch.zeros((n, w), dtype=torch.int32, device=bits.device)
    for pl in range(32):
        out |= bits[:, pl * w : (pl + 1) * w].to(torch.int32) << pl
    return out


def bit_lookup_from(subt: torch.Tensor, cols, *, dtype=torch.bool) -> torch.Tensor:
    """``out[j, i] = bit(subt[cols[j] >> 5, i] >> (cols[j] & 31))`` —
    the column-lookup half of :func:`bit_lookup` over a precomputed
    transposed row gather ``subt`` [W, R]."""
    cols = torch.as_tensor(cols).to(device=subt.device, dtype=torch.int64)
    words = subt[cols >> 5]                               # [C, R] row gather
    shifts = (cols & 31).to(torch.int32)[:, None]
    return ((words >> shifts) & _ONE).to(dtype)


def bit_lookup(p: torch.Tensor, rows, cols, *, dtype=torch.bool) -> torch.Tensor:
    """``out[j, i] = bit(p[rows[i], cols[j]])`` — TRANSPOSED output
    [len(cols), len(rows)] in ``dtype``: contiguous row gather →
    transpose → row gather on the word axis → per-row shift, linear in
    the output size."""
    rows = torch.as_tensor(rows).to(device=p.device, dtype=torch.int64)
    n_cols = len(cols)
    if rows.numel() == 0 or n_cols == 0:
        return torch.zeros((n_cols, rows.numel()), dtype=dtype, device=p.device)
    return bit_lookup_from(p[rows].T, cols, dtype=dtype)


def _index(ix, device) -> torch.Tensor:
    return torch.as_tensor(ix).to(device=device, dtype=torch.int64)


def _byte_bits(p: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """bool [N, len(cols)]: logical columns ``cols`` of packed ``p``,
    read through ``p``'s bytes.  Words are little-endian, so column c is
    bit ``c & 7`` of byte ``c >> 3`` of the row: one uint8 gather,
    shifted and masked in place, is the only [N, len(cols)]
    intermediate, and its 0/1 bytes are the bool result."""
    b = p.contiguous().view(torch.uint8)[:, cols >> 3]
    b.bitwise_right_shift_((cols & 7).to(torch.uint8)).bitwise_and_(_ONE)
    return b.view(torch.bool)


def gather_bit_columns(p: torch.Tensor, cols) -> torch.Tensor:
    """Logical columns ``cols`` of packed ``p`` [N, W] → bool
    [N, len(cols)] (``cols``: numpy or an int64 tensor on ``p``'s
    device)."""
    cols = _index(cols, p.device)
    if cols.numel() == 0:
        return torch.zeros((p.shape[0], 0), dtype=torch.bool, device=p.device)
    return _byte_bits(p, cols)


def gather_bit_matrix(p: torch.Tensor, rows, cols) -> torch.Tensor:
    """``out[i, j] = bit(p[rows[i], cols[j]])`` → bool [len(rows),
    len(cols)]: a row gather, then a one-index byte gather along the
    rows.  (A single two-index gather would broadcast its index tensors
    to the [len(rows), len(cols)] output in int64 — 16 bytes of index
    for every output bit.)"""
    rows, cols = _index(rows, p.device), _index(cols, p.device)
    if rows.numel() == 0 or cols.numel() == 0:
        return torch.zeros(
            (rows.numel(), cols.numel()), dtype=torch.bool, device=p.device
        )
    return _byte_bits(p[rows], cols)


class ColumnScatter:
    """Static plan for OR-scattering source bit columns into packed
    columns (the port of the reference's ``ColumnScatter``).

    ``targets[j]`` (with repeats: many axioms share a superclass) is the
    logical column that source column ``j`` ORs into.  The plan keeps
    the distinct targets ``d_cols`` (with ``inv: j → d``, as the
    reference's), the touched words, and two static gathers:

    * the OR-fold of repeated targets — :class:`SegmentedRowOr`'s plan
      applied to columns: sources gathered segment by segment, each
      segment padded to a power of two with repeats of its own members,
      then one ``any`` per bucket of equal padded length;
    * the grid — 32 slots per touched word, each slot gathering its
      folded target column or an all-zero column.

    The grid is packed by the shift-ORs of :func:`pack_bool_columns`,
    so no word is ever formed by an addition that could carry into bit
    31, and no step scatters or accumulates (on a card those are the
    slow, index-materialising operations).
    """

    def __init__(self, targets: np.ndarray, n_words: int):
        targets = np.asarray(targets, np.int64)
        if len(targets) and not 0 <= targets.min() <= targets.max() < 32 * n_words:
            raise ValueError(f"ColumnScatter targets outside {n_words} words")
        self.n_sources = len(targets)
        self.d_cols, self.inv = np.unique(targets, return_inverse=True)
        self.touched = np.unique(self.d_cols >> 5)
        seg = SegmentedRowOr(targets)
        self._buckets = seg._buckets
        folded = seg.targets                 # distinct targets, fold order
        slots = np.searchsorted(self.touched, folded >> 5) * 32 + (folded & 31)
        self._grid_src = np.full(len(self.touched) * 32, len(folded), np.int64)
        self._grid_src[slots] = np.arange(len(folded))
        self._order = seg.order
        self._dev_cache: dict = {}

    @property
    def n_distinct(self) -> int:
        return len(self.d_cols)

    def _dev(self, device):
        key = str(device)
        if key not in self._dev_cache:
            self._dev_cache[key] = tuple(
                _index(a, device)
                for a in (self._order, self._grid_src, self.touched)
            )
        return self._dev_cache[key]

    def updates(self, sources) -> torch.Tensor:
        """OR-words [N, len(touched)] int32 of ``sources``: a bool or
        0/1 int8 [N, K] tensor, or a list of them whose columns,
        concatenated, follow the plan's targets."""
        if isinstance(sources, torch.Tensor):
            sources = [sources]
        width = sum(s.shape[1] for s in sources)
        if width != self.n_sources:
            raise ValueError(
                f"ColumnScatter has {self.n_sources} targets, got "
                f"{width} source columns"
            )
        sources = [s if s.dtype == torch.bool else s.view(torch.bool)
                   for s in sources]
        order, grid_src, _ = self._dev(sources[0].device)
        src = torch.cat(sources, dim=1) if len(sources) > 1 else sources[0]
        folded = self._fold(src[:, order])
        del src
        return pack_bool_columns(folded[:, grid_src])

    def _fold(self, g: torch.Tensor) -> torch.Tensor:
        """bool [N, n_distinct + 1]: the sources in fold order ``g``
        ORed within each target's segment, then one all-zero column."""
        n = g.shape[0]
        parts, pos = [], 0
        for blen, nseg in self._buckets:
            blk = g[:, pos : pos + nseg * blen]
            pos += nseg * blen
            parts.append(blk if blen == 1 else blk.reshape(n, nseg, blen).any(dim=2))
        parts.append(torch.zeros((n, 1), dtype=torch.bool, device=g.device))
        return torch.cat(parts, dim=1)

    def apply(self, packed: torch.Tensor, sources) -> torch.Tensor:
        """``packed`` [N, W] with the sources ORed in at this plan's
        target columns, as a new tensor."""
        if self.n_distinct == 0:
            return packed
        out = packed.clone()
        touched = self._dev(packed.device)[2]
        out[:, touched] |= self.updates(sources)
        return out

    def apply_(self, packed: torch.Tensor, sources) -> torch.Tensor:
        """:meth:`apply` **in place**; returns a 0-d bool tensor "did
        any bit change", left on the device."""
        if self.n_distinct == 0:
            return torch.zeros((), dtype=torch.bool, device=packed.device)
        touched = self._dev(packed.device)[2]
        old = packed[:, touched]
        new = old | self.updates(sources)
        packed[:, touched] = new
        return (new != old).any()


def scatter_or_columns(packed: torch.Tensor, source_bits, targets) -> torch.Tensor:
    """One-shot convenience wrapper over :class:`ColumnScatter`."""
    return ColumnScatter(np.asarray(targets), packed.shape[1]).apply(
        packed, source_bits
    )


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction over ``dim``, whose length must be a power
    of two: PyTorch has no OR reduction, so the axis folds by halving
    (log2(n) elementwise ORs)."""
    n = x.shape[dim]
    assert n & (n - 1) == 0, f"or_reduce needs a power-of-two axis, got {n}"
    while n > 1:
        n //= 2
        x = x.narrow(dim, 0, n) | x.narrow(dim, n, n)
    return x.squeeze(dim)


def or_reduce_any(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Bitwise-OR reduction over an axis of any length (pads it with
    zero words up to a power of two first)."""
    n = x.shape[dim]
    if n == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        pad = list(x.shape)
        pad[dim] = p2 - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    return or_reduce(x, dim)


def _next_pow2(counts: np.ndarray) -> np.ndarray:
    """Elementwise smallest power of two >= counts (counts >= 1), exact
    for any int64 — float log2 alone misrounds near exact powers."""
    b = (1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
    b = np.where(b < counts, b << 1, b)         # log2 rounded down
    half = b >> 1
    return np.where(half >= counts, half, b)    # log2 rounded up


class SegmentedRowOr:
    """Static plan for OR-combining packed *rows* that share a target row.

    Segments are grouped by padded power-of-two length at build time,
    each segment padded *with repeats of its own members* (OR is
    idempotent, so repeats are free), and the runtime reduce is one
    reshape + OR-fold per bucket: [n_seg, blen, W] → [n_seg, W].  The
    plan is numpy; :meth:`reduce` and :meth:`write` run on tensors.

    ``order`` (length ``k``, with repeats) maps kernel row position →
    caller's raw axiom index; callers gather their per-axiom sources
    through it once.  ``targets`` are the per-segment target row ids in
    *bucket emission order*, aligned with :meth:`reduce`'s output.
    """

    def __init__(self, raw_targets: np.ndarray):
        raw_targets = np.asarray(raw_targets, np.int64)
        self._dev_cache: dict = {}
        if raw_targets.size == 0:
            self.k = 0
            self.order = np.zeros(0, np.int64)
            self.targets = raw_targets
            self._buckets = []
            return
        order0 = np.argsort(raw_targets, kind="stable")
        sorted_t = raw_targets[order0]
        seg_targets, first, counts = np.unique(
            sorted_t, return_index=True, return_counts=True
        )
        blens = _next_pow2(counts)
        self._init_from_segments(seg_targets, counts, blens, first, order0)

    def _init_from_segments(self, seg_targets, counts, blens, first, order0):
        """Build emission order + buckets from per-segment (target, member
        count, padded length, first-member offset into ``order0``)."""
        bucket_sort = np.argsort(blens, kind="stable")
        seg_targets = seg_targets[bucket_sort]
        counts = counts[bucket_sort]
        blens = blens[bucket_sort]
        first = first[bucket_sort]
        total = int(blens.sum())
        out_starts = np.r_[0, np.cumsum(blens)[:-1]]
        seg_of = np.repeat(np.arange(len(blens)), blens)
        within = np.arange(total) - out_starts[seg_of]
        # pad each segment with repeats of its own members — OR-idempotent
        order = order0[first[seg_of] + within % counts[seg_of]]
        ubl, ucnt = np.unique(blens, return_counts=True)  # ascending = emission
        self.k = total
        self.order = order
        self.targets = seg_targets
        #: (padded_len, n_segments) per bucket, in emission order
        self._buckets = list(zip(ubl.tolist(), ucnt.tolist()))

    def device_targets(self, device) -> torch.Tensor:
        """``targets`` as an int64 tensor on ``device`` (cached)."""
        key = ("t", str(device))
        if key not in self._dev_cache:
            self._dev_cache[key] = torch.as_tensor(
                self.targets, dtype=torch.int64
            ).to(device)
        return self._dev_cache[key]

    def reduce(self, rows: torch.Tensor) -> torch.Tensor:
        """OR-reduce ``rows`` [k, W] (already gathered through ``order``)
        within each segment → [n_targets, W]."""
        if not self._buckets:
            return rows[:0]
        outs = []
        pos = 0
        for blen, nseg in self._buckets:
            chunk = rows[pos : pos + nseg * blen]
            pos += nseg * blen
            if blen == 1:
                outs.append(chunk)
            else:
                chunk = chunk.reshape(nseg, blen, rows.shape[1])
                outs.append(or_reduce(chunk, 1))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def write(self, state: torch.Tensor, reduced: torch.Tensor,
              cols: slice = slice(None), track=True) -> torch.Tensor:
        """OR already-reduced per-target rows ``reduced`` [n_targets, w]
        into ``state[:, cols]`` **in place** (the state is the largest
        tensor of a run; a functional update would double it).  Returns
        a 0-d bool tensor "did any bit change"; with ``track="rows"``
        the per-target change vector [n_targets] bool instead (aligned
        with ``targets``: the frontier signal of gated engines).  Either
        is computed on the touched rows only and left on the device."""
        if self.k == 0:
            shape = (0,) if track == "rows" else ()
            return torch.zeros(shape, dtype=torch.bool, device=state.device)
        t = self.device_targets(state.device)
        old = state[t, cols]
        merged = old | reduced
        state[t, cols] = merged
        if track == "rows":
            return (merged != old).any(dim=1)
        return (merged != old).any()
