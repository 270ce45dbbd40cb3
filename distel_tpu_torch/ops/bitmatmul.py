"""Packed AND-OR products: the saturation engines' contractions.

Two products live here.  The first, the packed-columns product, is
the row-packed engine's:

``C_packed = pack_x(A ⊙ unpack_x(B_packed))`` in the boolean AND-OR
semiring:

    A         [M, L]  int8/bool — per-step operand (axiom masks)
    B_packed  [L, W]  int32     — state operand, 32 x-columns per word
    C_packed  [M, W]  int32

The contraction axis L is narrow (a window of the link table) and the
wide x-axis stays packed end to end.  This is CR4 and CR6 of the
row-packed engine and the transitive-reduction product of the blocked
taxonomy.

:class:`PackedColsMatmulPlan` runs hand-written CUDA kernels
(``csrc/packed_cols.cu``) for CUDA tensors and its plain PyTorch version
for CPU tensors.  Its two routes give the same words:

* sparse: ``packed_cols_list`` lists, per 64-row block of A, the
  contraction columns some row selects, each with its row mask
  (:class:`ColumnLists`); ``packed_cols_sparse`` then ORs the listed B
  rows into the rows each mask selects, so its work follows A's
  nonzeros;
* dense: ``packed_cols_dense`` runs the product on the int8 tensor
  cores over every contraction tile that holds a nonzero.

:func:`packed_cols_dense_batched` runs the dense route's kernel over a
batch of independent products in one launch (the component plane's
groups of isomorphic copies, ``core/components.py``), and
:func:`plain_packed_cols_batched` is its plain version.

Either can OR into an existing C (``out=``) instead of writing a fresh
one, and either can take a row count that lies on the card
(``n_rows=``): only rows below it are computed and ORed into C, which
lets a captured CUDA graph skip work no host decision can skip
(``packed_cols_list_n`` / ``packed_cols_dense_n``; their plain version
is :func:`plain_packed_cols_rows`).  :meth:`PackedColsMatmulPlan.batched_rows`
is that row-count call over a batch of independent products, one row
count a copy (the cohort plane's lanes, ``core/cohort.py``), by the
route the plan picks for one copy: ``packed_cols_dense_n_batched``, or
``packed_cols_list_n_batched`` + ``packed_cols_sparse_batched``; its
plain version is :func:`plain_packed_cols_rows_batched`.

The second, the packed-contraction product, is the packed engine's
(CR4 and CR6 over the x-major R):

    A  [M, KW]  int32 — state rows packed along the contraction K
    B  [K, N]   int8  — per-step 0/1 operand, rows in the plan's
                        ``bit_order``
    C  [M, N]   int8  — 0/1

:class:`PackedMatmulPlan` runs two hand-written kernels of
``csrc/packed_cols.cu`` for CUDA tensors and its plain version for CPU
tensors: ``packed_andor_list`` lists, per 64-row block of A, the
contraction indices some row sets, each with its row mask (the
:class:`ColumnLists` format), and ``packed_cols_sparse`` ORs each
listed B row into the rows its mask selects, on B and C viewed as
int32 words (B's bytes are 0 or 1, so an OR four bytes to a word is the
byte OR).  One listing of an A serves every product against it.

There is no fallback: a CUDA tensor launches its kernels or raises.
Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from distel_tpu_torch.core.engine import default_temp_budget
from distel_tpu_torch.ops.bitpack import pack_planes, unpack_words, unpack_words_planes

#: kernel launches since the last :func:`reset_launches`, per entry point
#: (the plain CPU version never counts)
LAUNCHES = {
    "packed_cols_list": 0,
    "packed_cols_dense": 0,
    "packed_cols_sparse": 0,
    "packed_andor_list": 0,
    "packed_cols_dense_batched": 0,
    "packed_cols_list_n": 0,
    "packed_cols_dense_n": 0,
    "packed_cols_dense_n_batched": 0,
    "packed_cols_list_n_batched": 0,
    "packed_cols_sparse_batched": 0,
}

#: the packed-columns kernels' row block and the listing kernel's
#: contraction chunk; checked against the built library when it loads
KERNEL_TM, LIST_CHUNK = 64, 256

#: auto ``skip_zero_tiles`` threshold in word-ANDs (M·L·W): plans at or
#: above it take the sparse route, smaller ones the dense route.  From
#: what ``chip_smoke.py`` measured on an H100 (both routes on the
#: classify's own operands): at 1.2e10 and above (window CR6, the
#: taxonomy product) the sparse route is 9x to 66x faster; at 6.5e8 and
#: below (CR4 at 64k classes) the two routes are within the spread of
#: the host's launch overhead, per call and end to end, and the dense
#: route needs one launch where the sparse one needs two; on the 8k
#: run's plans (4.6e7 and below) the dense route is 2-3x faster.
SKIP_TILES_MIN_WORK = 1 << 30

#: bytes that :class:`PackedMatmulPlan` pads B's and C's rows to, so that
#: their int32 views are whole 16-byte pieces (``packed_cols_sparse``'s
#: 16-byte copies)
N_ALIGN = 16

_LIB = None
#: guards :data:`LAUNCHES` and the library's first load: the serve
#: plane's scheduler workers launch from several threads
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


#: per thread, the launches a CUDA-graph capture in progress recorded
_RECORDING = threading.local()


def _count_launch(name: str) -> None:
    rec = recorded()
    if rec is not None:
        rec[name] += 1
        return
    with _LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording():
    """While this thread captures a CUDA graph: the wrappers' launches
    go to the yielded dict (by entry point) instead of :data:`LAUNCHES`,
    since a capture launches nothing; the graph's replays launch them,
    and whoever replays adds them with :func:`add_launches`."""
    _RECORDING.counts = rec = dict.fromkeys(LAUNCHES, 0)
    try:
        yield rec
    finally:
        _RECORDING.counts = None


def recorded() -> Optional[dict]:
    """The launches this thread's capture in progress recorded so far
    (None outside :func:`recording`)."""
    return getattr(_RECORDING, "counts", None)


def add_launches(counts: dict) -> None:
    """Add launches made by replaying captured kernels (a CUDA graph
    launches what its capture recorded, with no wrapper call)."""
    with _LOCK:
        for k, v in counts.items():
            LAUNCHES[k] += int(v)


def _lib():
    """The kernels' library, built from ``csrc/packed_cols.cu`` on first
    use (see ``ops/build.py``)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from distel_tpu_torch.ops import build

        lib = build.load("packed_cols")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.packed_cols_list.argtypes = [vp, vp, vp, vp, ci, ci, vp]
        lib.packed_cols_list.restype = ci
        lib.packed_cols_dense.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.packed_cols_dense.restype = ci
        lib.packed_cols_list_n.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp]
        lib.packed_cols_list_n.restype = ci
        lib.packed_cols_dense_n.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp]
        lib.packed_cols_dense_n.restype = ci
        ll = ctypes.c_longlong
        lib.packed_cols_dense_batched.argtypes = (
            [vp, vp, vp, ci, ci, ci, ci, ll, ll, ll, ci, vp]
        )
        lib.packed_cols_dense_batched.restype = ci
        lib.packed_cols_dense_n_batched.argtypes = (
            [vp, vp, vp, ci, ci, ci, ci, ll, ll, ll, vp, vp]
        )
        lib.packed_cols_dense_n_batched.restype = ci
        lib.packed_cols_list_n_batched.argtypes = (
            [vp, vp, vp, vp, ci, ci, ci, ll, vp, vp]
        )
        lib.packed_cols_list_n_batched.restype = ci
        lib.packed_cols_sparse_batched.argtypes = (
            [vp, vp, vp, vp, vp, ci, ci, ci, ci, ll, ll, ci, vp]
        )
        lib.packed_cols_sparse_batched.restype = ci
        lib.packed_cols_sparse.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.packed_cols_sparse.restype = ci
        lib.packed_andor_list.argtypes = [vp] * 4 + [ci, ci, ci, vp]
        lib.packed_andor_list.restype = ci
        lib.packed_cols_error_string.argtypes = [ci]
        lib.packed_cols_error_string.restype = ctypes.c_char_p
        tiles = (lib.packed_cols_tile_m(), lib.packed_cols_list_chunk())
        if tiles != (KERNEL_TM, LIST_CHUNK):
            raise RuntimeError(
                f"packed_cols library tiles {tiles} != wrapper's "
                f"{(KERNEL_TM, LIST_CHUNK)}"
            )
        _LIB = lib
        return _LIB


def _check_launch(error_string, code: int, what: str) -> None:
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------- packed-columns product


class ColumnLists(NamedTuple):
    """Per row block of A (``tm`` rows), the contraction columns some row
    selects, in ``chunk``-column chunks: entry ``j < counts[g, c]`` of
    chunk c is column ``cols[g, c, j]`` (ascending across the chunks),
    with ``masks[g, c, j]`` bit r set iff ``A[tm·g + r, col] != 0``
    (int64 holding the uint64 bits).  Entries at ``j >= counts`` are
    undefined; :func:`list_entries` reads only the valid ones.  The
    packed-columns listing puts chunk c's columns in ``[chunk·c,
    chunk·(c+1))``; the packed-contraction listing packs a row block's
    entries densely (chunk c holds its entries ``chunk·c`` onwards).
    ``packed_cols_sparse`` reads either."""

    cols: torch.Tensor     # [GM, NCH, chunk] int32
    masks: torch.Tensor    # [GM, NCH, chunk] int64
    counts: torch.Tensor   # [GM, NCH] int32


def list_entries(lists: ColumnLists):
    """``(cols, masks)`` of the valid entries, row block by row block,
    each block's in ascending column order — the form in which two
    listings compare bit for bit."""
    chunk = lists.cols.shape[-1]
    valid = (
        torch.arange(chunk, device=lists.counts.device)[None, None, :]
        < lists.counts[..., None]
    )
    return lists.cols[valid], lists.masks[valid]


def plain_list_columns(a: torch.Tensor, tm: int = KERNEL_TM,
                       chunk: int = LIST_CHUNK) -> ColumnLists:
    """The plain PyTorch version of ``packed_cols_list`` (and the
    reference's flags at a one-column contraction tile): row masks as
    sums of distinct powers of two (an OR), then a stable sort that puts
    each chunk's live columns first in ascending order.  Invalid
    entries hold -1 and 0."""
    if not 1 <= tm <= 64:
        raise ValueError(f"row masks hold at most 64 rows, got tm={tm}")
    m, l = a.shape
    gm, nch = -(-m // tm), max(-(-l // chunk), 1)
    dev = a.device
    bits = np.left_shift(np.uint64(1), np.arange(tm, dtype=np.uint64))
    weights = torch.from_numpy(bits.view(np.int64)).to(dev)
    masks = torch.zeros((gm, nch * chunk), dtype=torch.int64, device=dev)
    for g in range(gm):
        rows = (a[g * tm : (g + 1) * tm] != 0).to(torch.int64)
        masks[g, :l] = (rows * weights[: rows.shape[0], None]).sum(0)
    masks = masks.view(gm, nch, chunk)
    live = masks != 0
    order = torch.sort((~live).to(torch.int8), dim=2, stable=True).indices
    counts = live.sum(2).to(torch.int32)
    first = torch.arange(nch, device=dev)[None, :, None] * chunk
    valid = torch.arange(chunk, device=dev)[None, None, :] < counts[..., None]
    cols = torch.where(valid, first + order, -1).to(torch.int32)
    masks = torch.where(valid, torch.gather(masks, 2, order), 0)
    return ColumnLists(cols.contiguous(), masks.contiguous(), counts)


def _chunks(l: int) -> int:
    """List chunks a row block holds over ``l`` contraction indices (one
    when ``l`` is 0, as the plain listing and the listing kernels make)."""
    return max(-(-l // LIST_CHUNK), 1)


def _list_slabs(m: int, l: int, budget: Optional[int], device,
                copies: int = 1) -> list:
    """Row ranges (whole row blocks) of an m-row A whose lists over ``l``
    contraction indices, for each of ``copies`` copies, fit ``budget``
    bytes together (None = :func:`default_temp_budget` of the
    device)."""
    if budget is None:
        budget = default_temp_budget(device)
    per_block = 12 * _chunks(l) * LIST_CHUNK * max(copies, 1)
    rows = max(budget // per_block, 1) * KERNEL_TM
    return [(r, min(r + rows, m)) for r in range(0, m, rows)]


def _new_lists(rows: int, l: int, device, copies: int = 1) -> ColumnLists:
    """List buffers of ``rows`` rows over ``l`` indices; with ``copies``
    > 1 one region a copy, laid out one after another."""
    gm, nch = -(-rows // KERNEL_TM), _chunks(l)
    lead = (copies, gm) if copies > 1 else (gm,)
    return ColumnLists(
        torch.empty((*lead, nch, LIST_CHUNK), dtype=torch.int32, device=device),
        torch.empty((*lead, nch, LIST_CHUNK), dtype=torch.int64, device=device),
        torch.empty((*lead, nch), dtype=torch.int32, device=device),
    )


def _lists_in(into: ColumnLists, rows: int, l: int) -> ColumnLists:
    """The lists of ``rows`` rows over ``l`` indices, laid out in the
    leading elements of ``into``'s buffers."""
    gm, nch = -(-rows // KERNEL_TM), _chunks(l)
    n = gm * nch
    if into.counts.numel() < n:
        raise ValueError(f"list buffers hold {into.counts.numel()} chunks, "
                         f"{n} wanted")
    return ColumnLists(
        into.cols.view(-1)[: n * LIST_CHUNK].view(gm, nch, LIST_CHUNK),
        into.masks.view(-1)[: n * LIST_CHUNK].view(gm, nch, LIST_CHUNK),
        into.counts.view(-1)[:n].view(gm, nch),
    )


def _run_sparse(b: torch.Tensor, lists: ColumnLists, c: torch.Tensor, l: int,
                accumulate: bool) -> torch.Tensor:
    """``packed_cols_sparse``: B [l, w] int32 over ``lists`` into C
    [rows, w] int32."""
    lib = _lib()
    code = lib.packed_cols_sparse(
        b.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
        lists.counts.data_ptr(), c.data_ptr(), c.shape[0], l, c.shape[1],
        int(accumulate), _stream(b),
    )
    _check_launch(lib.packed_cols_error_string, code, "packed_cols_sparse")
    _count_launch("packed_cols_sparse")
    return c


def _span(t: torch.Tensor) -> int:
    """Bytes from ``t``'s first element to past its last (a strided
    view spans more than its elements)."""
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) \
        * t.element_size()


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    if x.numel() == 0 or y.numel() == 0:
        return False
    x0, y0 = x.data_ptr(), y.data_ptr()
    return x0 < y0 + _span(y) and y0 < x0 + _span(x)


class PackedColsMatmulPlan:
    """AND-OR semiring product with **packed output columns** for fixed
    shapes ``[m, l] ⊙ [l, w]``.

    ``skip_zero_tiles``: on a card, take the sparse route (listing +
    ``packed_cols_sparse``) rather than ``packed_cols_dense`` (None =
    auto, by :data:`SKIP_TILES_MIN_WORK`).  The choice never changes the
    result, only which kernels a CUDA call launches.
    ``temp_budget_bytes``: bytes the sparse route's lists may take (None
    = :func:`default_temp_budget` of the device); row blocks beyond it
    run in slabs."""

    def __init__(self, m: int, l: int, w: int, *,
                 skip_zero_tiles: Optional[bool] = None,
                 temp_budget_bytes: Optional[int] = None):
        self.m, self.l, self.w = int(m), int(l), int(w)
        if skip_zero_tiles is None:
            skip_zero_tiles = self.m * self.l * self.w >= SKIP_TILES_MIN_WORK
        self.skip_zero_tiles = bool(skip_zero_tiles)
        self.temp_budget_bytes = temp_budget_bytes
        # per device: the sparse route's slabs and its list buffers, kept
        # across calls (a plan serves every window and round of its shape;
        # calls on one stream run in order, so one set of lists serves all)
        self._slabs: dict = {}
        self._lists: dict = {}

    def __call__(self, a: torch.Tensor, b_packed: torch.Tensor,
                 out: Optional[torch.Tensor] = None,
                 n_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """a [m, l] int8/bool; b_packed [l, w] int32 → [m, w] int32.
        With ``out`` ([m, w] int32, not overlapping A or B) the product
        is ORed into it (C |= A ⊙ B) and ``out`` is returned.
        ``n_rows``: a one-element int32 tensor on A's device; only rows
        below its value are computed and ORed into ``out`` (which it
        requires), read by the kernels when they start — no host
        read."""
        if a.dtype == torch.bool:
            a = a.view(torch.int8)
        if a.dtype != torch.int8 or b_packed.dtype != torch.int32:
            raise TypeError(
                f"PackedColsMatmulPlan wants int8 A and int32 B, got "
                f"{a.dtype} and {b_packed.dtype}"
            )
        if tuple(a.shape) != (self.m, self.l) or tuple(b_packed.shape) != (
            self.l, self.w,
        ):
            raise ValueError(
                f"PackedColsMatmulPlan({self.m}, {self.l}, {self.w}) got A "
                f"{tuple(a.shape)} and B {tuple(b_packed.shape)}"
            )
        if a.device != b_packed.device:
            raise ValueError(f"A on {a.device} but B on {b_packed.device}")
        if out is not None:
            if out.dtype != torch.int32 or tuple(out.shape) != (self.m, self.w):
                raise ValueError(
                    f"out must be int32 [{self.m}, {self.w}], got {out.dtype} "
                    f"{tuple(out.shape)}"
                )
            if out.device != a.device or not out.is_contiguous():
                raise ValueError(f"out must be contiguous on {a.device}")
            if _overlaps(out, a) or _overlaps(out, b_packed):
                raise ValueError("out must not overlap A or B")
        if n_rows is not None:
            if out is None:
                raise ValueError("n_rows needs out (the rows past it keep out's)")
            if (n_rows.dtype != torch.int32 or n_rows.numel() != 1
                    or n_rows.device != a.device):
                raise ValueError(
                    f"n_rows must be one int32 on {a.device}, got "
                    f"{n_rows.dtype} {tuple(n_rows.shape)} on {n_rows.device}"
                )
        if a.device.type == "cpu":
            if n_rows is not None:
                return plain_packed_cols_rows(a, b_packed, out, n_rows)
            return plain_packed_cols(a, b_packed, out)
        if a.device.type != "cuda":
            raise ValueError(f"no packed-columns kernel for {a.device}")
        if n_rows is None:
            return self._launch(a, b_packed, out)
        return self._launch(a, b_packed, out, n_rows)

    def _launch(self, a: torch.Tensor, b: torch.Tensor,
                out: Optional[torch.Tensor],
                n_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("packed-columns kernels take contiguous A and B")
        if -(-self.m // KERNEL_TM) > 65535:
            raise ValueError(f"M={self.m} exceeds the kernel grid")
        accumulate = out is not None
        c = out if accumulate else torch.empty(
            (self.m, self.w), dtype=torch.int32, device=a.device
        )
        if self.m == 0 or self.w == 0:
            return c
        if self.l == 0:
            return c if accumulate else c.zero_()
        if not self.skip_zero_tiles:
            if n_rows is not None:
                return self.run_dense_n(a, b, c, n_rows)
            return self.run_dense(a, b, c, accumulate)
        slabs = self.slabs(a.device)
        bufs = self._lists.get(a.device)
        if bufs is None:
            bufs = self._lists[a.device] = _new_lists(
                slabs[0][1] - slabs[0][0], self.l, a.device
            )
        for r0, r1 in slabs:
            if n_rows is None:
                lists = self.list_columns(a[r0:r1], bufs)
            else:
                n = n_rows if r0 == 0 else (n_rows - r0).to(torch.int32)
                lists = self.list_columns_n(a[r0:r1], n, bufs)
            self.run_sparse(b, lists, c[r0:r1], accumulate)
        return c

    def slabs(self, device) -> list:
        """Row ranges (whole row blocks) whose lists fit the budget."""
        device = torch.device(device)
        got = self._slabs.get(device)
        if got is None:
            got = self._slabs[device] = _list_slabs(
                self.m, self.l, self.temp_budget_bytes, device
            )
        return got

    def list_columns(self, a: torch.Tensor,
                     into: Optional[ColumnLists] = None) -> ColumnLists:
        """``packed_cols_list`` on a contiguous int8 A [rows, l] on a
        card: its :class:`ColumnLists`, written into the leading
        elements of ``into`` (buffers for at least as many rows) or into
        fresh ones."""
        m, l = a.shape
        if into is None:
            into = _new_lists(m, l, a.device)
        lists = _lists_in(into, m, l)
        lib = _lib()
        code = lib.packed_cols_list(
            a.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
            lists.counts.data_ptr(), m, l, _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_list")
        _count_launch("packed_cols_list")
        return lists

    def list_columns_n(self, a: torch.Tensor, n_rows: torch.Tensor,
                       into: ColumnLists) -> ColumnLists:
        """``packed_cols_list_n``: :meth:`list_columns` over the rows of A
        below the card-held count ``n_rows`` (the lists of the other row
        blocks come out empty)."""
        m, l = a.shape
        lists = _lists_in(into, m, l)
        lib = _lib()
        code = lib.packed_cols_list_n(
            a.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
            lists.counts.data_ptr(), m, l, n_rows.data_ptr(), _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_list_n")
        _count_launch("packed_cols_list_n")
        return lists

    def run_dense_n(self, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    n_rows: torch.Tensor) -> torch.Tensor:
        """``packed_cols_dense_n``: C |= A ⊙ B over the rows below the
        card-held count ``n_rows``."""
        lib = _lib()
        code = lib.packed_cols_dense_n(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), self.m, self.l, self.w,
            n_rows.data_ptr(), _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_dense_n")
        _count_launch("packed_cols_dense_n")
        return c

    def run_sparse(self, b: torch.Tensor, lists: ColumnLists, c: torch.Tensor,
                   accumulate: bool) -> torch.Tensor:
        """``packed_cols_sparse`` over ``lists`` into C [rows, w]."""
        return _run_sparse(b, lists, c, self.l, accumulate)

    def run_dense(self, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  accumulate: bool) -> torch.Tensor:
        """``packed_cols_dense`` into C [m, w]."""
        lib = _lib()
        code = lib.packed_cols_dense(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), self.m, self.l, self.w,
            int(accumulate), _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_dense")
        _count_launch("packed_cols_dense")
        return c

    # ------------------------------------------------ batched row counts

    def batched_rows(self, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                     n_rows: torch.Tensor) -> torch.Tensor:
        """``out[k, r] |= (A[k] ⊙ B[k])[r]`` for every copy k and its rows
        ``r < n_rows[k]``: a [nb, m, l] int8/bool, b [nb, l, w] int32 and
        out [nb, m, w] int32, all contiguous (out not overlapping A or
        B); ``n_rows`` [nb] int32 on their device, read by the kernels
        when they start — no host read.  On a card the plan's route for
        one copy, every copy in each launch: ``packed_cols_dense_n_batched``
        (one launch), or per slab of rows (the lists of all copies within
        the temp budget) ``packed_cols_list_n_batched`` +
        ``packed_cols_sparse_batched``; on the CPU
        :func:`plain_packed_cols_rows_batched`."""
        if a.dtype == torch.bool:
            a = a.view(torch.int8)
        if a.dtype != torch.int8 or b.dtype != torch.int32:
            raise TypeError(
                f"batched_rows wants int8 A and int32 B, got {a.dtype} and "
                f"{b.dtype}"
            )
        nb = a.shape[0] if a.dim() == 3 else -1
        if (tuple(a.shape) != (nb, self.m, self.l)
                or tuple(b.shape) != (nb, self.l, self.w)
                or tuple(out.shape) != (nb, self.m, self.w)
                or out.dtype != torch.int32):
            raise ValueError(
                f"PackedColsMatmulPlan({self.m}, {self.l}, {self.w}).batched_rows "
                f"got A {tuple(a.shape)}, B {tuple(b.shape)}, out "
                f"{out.dtype} {tuple(out.shape)}"
            )
        if (n_rows.dtype != torch.int32 or tuple(n_rows.shape) != (nb,)
                or not n_rows.is_contiguous()):
            raise ValueError(
                f"n_rows must be {nb} contiguous int32, got {n_rows.dtype} "
                f"{tuple(n_rows.shape)}"
            )
        dev = a.device
        if not all(t.device == dev for t in (b, out, n_rows)):
            raise ValueError("A, B, out and n_rows must share a device")
        if not (a.is_contiguous() and b.is_contiguous() and out.is_contiguous()):
            raise ValueError("batched_rows takes contiguous A, B and out")
        if _overlaps(out, a) or _overlaps(out, b):
            raise ValueError("out must not overlap A or B")
        if dev.type == "cpu":
            return plain_packed_cols_rows_batched(a, b, out, n_rows)
        if dev.type != "cuda":
            raise ValueError(f"no packed-columns kernel for {dev}")
        if nb == 0 or self.m == 0 or self.w == 0 or self.l == 0:
            return out
        if not self.skip_zero_tiles:
            return self._dense_n_batched(a, b, out, n_rows)
        slabs = self._batched_slabs(dev, nb)
        key = (dev, "batched", nb)
        bufs = self._lists.get(key)
        if bufs is None:
            bufs = self._lists[key] = _new_lists(
                slabs[0][1] - slabs[0][0], self.l, dev, copies=nb
            )
        for r0, r1 in slabs:
            n = n_rows if r0 == 0 else (n_rows - r0).to(torch.int32)
            lists = self._list_n_batched(a[:, r0:r1], n, bufs)
            self._sparse_batched(b, lists, out[:, r0:r1], r1 - r0)
        return out

    def _batched_slabs(self, device, nb: int) -> list:
        """Row ranges whose lists for all ``nb`` copies fit the budget."""
        key = (torch.device(device), "batched", nb)
        got = self._slabs.get(key)
        if got is None:
            got = self._slabs[key] = _list_slabs(
                self.m, self.l, self.temp_budget_bytes, device, copies=nb
            )
        return got

    def _dense_n_batched(self, a, b, c, n_rows) -> torch.Tensor:
        nb = a.shape[0]
        lib = _lib()
        code = lib.packed_cols_dense_n_batched(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), nb, self.m, self.l,
            self.w, self.m * self.l, self.l * self.w, self.m * self.w,
            n_rows.data_ptr(), _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code,
                      "packed_cols_dense_n_batched")
        _count_launch("packed_cols_dense_n_batched")
        return c

    def _list_n_batched(self, a, n_rows, into: ColumnLists) -> ColumnLists:
        """``packed_cols_list_n_batched`` on a [nb, rows, l] (rows a slab:
        each copy's rows contiguous, copies ``a.stride(0)`` apart) into
        the leading regions of ``into``."""
        nb, rows, l = a.shape
        gm, nch = -(-rows // KERNEL_TM), _chunks(l)
        n = nb * gm * nch
        if into.counts.numel() < n:
            raise ValueError(f"list buffers hold {into.counts.numel()} "
                             f"chunks, {n} wanted")
        lists = ColumnLists(
            into.cols.view(-1)[: n * LIST_CHUNK].view(nb, gm, nch, LIST_CHUNK),
            into.masks.view(-1)[: n * LIST_CHUNK].view(nb, gm, nch, LIST_CHUNK),
            into.counts.view(-1)[:n].view(nb, gm, nch),
        )
        if a.stride(2) != 1 or a.stride(1) != l:
            raise ValueError(f"each copy's A rows must be contiguous, got "
                             f"strides {a.stride()}")
        lib = _lib()
        code = lib.packed_cols_list_n_batched(
            a.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
            lists.counts.data_ptr(), nb, rows, l, a.stride(0),
            n_rows.data_ptr(), _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code,
                      "packed_cols_list_n_batched")
        _count_launch("packed_cols_list_n_batched")
        return lists

    def _sparse_batched(self, b, lists: ColumnLists, c, rows: int) -> torch.Tensor:
        """``packed_cols_sparse_batched``: every copy's B [l, w] over its
        lists, ORed into its C rows (c [nb, rows, w], a slab of each
        copy's rows, copies ``c.stride(0)`` apart)."""
        nb = b.shape[0]
        lib = _lib()
        code = lib.packed_cols_sparse_batched(
            b.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
            lists.counts.data_ptr(), c.data_ptr(), nb, rows, self.l, self.w,
            b.stride(0), c.stride(0), 1, _stream(b),
        )
        _check_launch(lib.packed_cols_error_string, code,
                      "packed_cols_sparse_batched")
        _count_launch("packed_cols_sparse_batched")
        return c


def packed_cols_dense_batched(a: torch.Tensor, b: torch.Tensor,
                              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C[k] (|)= A[k] ⊙ B[k]`` for every copy k of a batch: a [nb, m, l]
    int8/bool, b [nb, l, w] int32 → [nb, m, w] int32, ORed into ``out``
    (contiguous, not overlapping A or B) when one is given.  Each copy's
    B rows must be contiguous (``b.stride()[1:] == (w, 1)``); the copies
    may lie anywhere (a slice of a batched state).  On a card this is one
    launch of ``packed_cols_dense_batched``, the dense route's kernel
    with a grid axis over the copies; on the CPU it is
    :func:`plain_packed_cols_batched`."""
    if a.dtype == torch.bool:
        a = a.view(torch.int8)
    if a.dtype != torch.int8 or b.dtype != torch.int32:
        raise TypeError(f"packed_cols_dense_batched wants int8 A and int32 B, "
                        f"got {a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"packed_cols_dense_batched got A {tuple(a.shape)} "
                         f"and B {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"A on {a.device} but B on {b.device}")
    nb, m, l = a.shape
    w = b.shape[2]
    if out is not None:
        if out.dtype != torch.int32 or tuple(out.shape) != (nb, m, w):
            raise ValueError(f"out must be int32 [{nb}, {m}, {w}], got "
                             f"{out.dtype} {tuple(out.shape)}")
        if out.device != a.device or not out.is_contiguous():
            raise ValueError(f"out must be contiguous on {a.device}")
        if _overlaps(out, a) or _overlaps(out, b):
            raise ValueError("out must not overlap A or B")
    if a.device.type == "cpu":
        return plain_packed_cols_batched(a, b, out)
    if a.device.type != "cuda":
        raise ValueError(f"no packed-columns kernel for {a.device}")
    return _launch_dense_batched(a, b, out)


def _launch_dense_batched(a: torch.Tensor, b: torch.Tensor,
                          out: Optional[torch.Tensor]) -> torch.Tensor:
    nb, m, l = a.shape
    w = b.shape[2]
    if not a.is_contiguous():
        raise ValueError("packed_cols_dense_batched takes a contiguous A")
    if w and l and (b.stride(2) != 1 or b.stride(1) != w):
        raise ValueError(f"each copy's B rows must be contiguous, got strides "
                         f"{b.stride()}")
    accumulate = out is not None
    c = out if accumulate else torch.empty((nb, m, w), dtype=torch.int32,
                                           device=a.device)
    if nb == 0 or m == 0 or w == 0:
        return c
    if l == 0:
        return c if accumulate else c.zero_()
    lib = _lib()
    code = lib.packed_cols_dense_batched(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), nb, m, l, w,
        m * l, b.stride(0), m * w, int(accumulate), _stream(a),
    )
    _check_launch(lib.packed_cols_error_string, code, "packed_cols_dense_batched")
    _count_launch("packed_cols_dense_batched")
    return c


def plain_packed_cols_batched(a: torch.Tensor, b: torch.Tensor,
                              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of ``packed_cols_dense_batched``: every
    copy's B unpacked plane-major, one batched matmul, ``> 0``, repacked
    and ORed into ``out`` when one is given (exact in float32 below 2^24
    contraction terms, as :func:`plain_packed_cols`)."""
    nb, m, l = a.shape
    w = b.shape[2]
    assert l < (1 << 24), "float32 accumulation is exact only below 2^24 terms"
    if out is None:
        out = torch.zeros((nb, m, w), dtype=torch.int32, device=a.device)
    if nb == 0 or m == 0 or w == 0 or l == 0:
        return out
    bits = unpack_words_planes(b.reshape(nb * l, w), torch.float32)
    prod = torch.bmm(a.to(torch.float32), bits.view(nb, l, 32 * w))
    out |= pack_planes((prod > 0).view(nb * m, 32 * w)).view(nb, m, w)
    return out


def plain_packed_cols(a: torch.Tensor, b_packed: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of the kernels' contract (the port of
    the reference's ``_xla``): plane-major unpack of B → matmul → ``> 0``
    → repack, ORed into ``out`` when one is given.  Only A's nonzero
    rows and columns enter the matmul — the others contribute nothing to
    an OR — and the count accumulates in float32, exact for any L below
    2^24."""
    m, l = a.shape
    w = b_packed.shape[1]
    assert l < (1 << 24), "float32 accumulation is exact only below 2^24 terms"
    if out is None:
        out = torch.zeros((m, w), dtype=torch.int32, device=a.device)
    nz = a != 0
    rows = nz.any(dim=1).nonzero().squeeze(1)
    cols = nz.any(dim=0).nonzero().squeeze(1)
    if rows.numel() == 0 or w == 0:
        return out
    a_sub = a[rows][:, cols].to(torch.float32)
    bits = unpack_words_planes(b_packed[cols], torch.float32)
    prod = a_sub @ bits
    out[rows] |= pack_planes(prod > 0)
    return out


def plain_packed_cols_rows(a: torch.Tensor, b_packed: torch.Tensor,
                           out: torch.Tensor,
                           n_rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``packed_cols_list_n`` +
    ``packed_cols_sparse`` and of ``packed_cols_dense_n``: ``out[r] |=
    (A ⊙ B)[r]`` for the rows ``r < n_rows`` (a one-element tensor), by
    :func:`plain_packed_cols` on those rows; the other rows of ``out``
    keep their words."""
    from distel_tpu_torch.ops.nosync import NoHostReads

    # the kernels read the count on the card; this stand-in reads it
    with NoHostReads.allowed():
        n = min(max(int(n_rows.reshape(())), 0), a.shape[0])
        if n:
            plain_packed_cols(a[:n], b_packed, out[:n])
    return out


def plain_packed_cols_rows_batched(a: torch.Tensor, b_packed: torch.Tensor,
                                   out: torch.Tensor,
                                   n_rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :meth:`PackedColsMatmulPlan.batched_rows`
    (``packed_cols_dense_n_batched``, and ``packed_cols_list_n_batched``
    + ``packed_cols_sparse_batched``): :func:`plain_packed_cols_rows` on
    each copy, ORed into ``out`` on the rows below that copy's count."""
    for k in range(a.shape[0]):
        plain_packed_cols_rows(a[k], b_packed[k], out[k], n_rows[k : k + 1])
    return out


# ------------------------------------------------- packed-contraction product


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class PackedMatmulPlan:
    """AND-OR product with A **packed along the contraction**, for fixed
    shapes ``[m, kw words] ⊙ [kw·32, n]`` (the port of the reference's
    ``PackedMatmulPlan``).

    ``bit_order`` [k_p] maps B's row position to the logical contraction
    bit it pairs with; callers lay B's rows out in it.  The reference's
    order is a TPU tile layout; this plan's is the logical order itself,
    ``k = 32·w + p`` (bit p of word w), which is what a kernel that lists
    A's set bits reads.  ``n_p`` is n rounded up to :data:`N_ALIGN`: a B
    (or C) with ``n_p`` columns is used without a copy, its extra columns
    zero.  B must hold 0/1 bytes (the card ORs them four to a word).

    ``temp_budget_bytes``: bytes a card's lists may take (None =
    :func:`default_temp_budget` of the device); row blocks beyond it are
    listed and multiplied in slabs."""

    def __init__(self, m: int, kw: int, n: int, *,
                 temp_budget_bytes: Optional[int] = None):
        self.m, self.kw, self.n = int(m), int(kw), int(n)
        self.k_p = self.kw * 32
        self.n_p = _pad_up(max(self.n, 1), N_ALIGN)
        #: B row position → logical contraction bit (length k_p)
        self.bit_order = np.arange(self.k_p)
        self.temp_budget_bytes = temp_budget_bytes
        # per device: the slabs and the list buffers (sized for the first
        # slab at k_p rows of B), kept across calls as PackedColsMatmulPlan
        # keeps its own
        self._slabs: dict = {}
        self._lists: dict = {}

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 lists: Optional[ColumnLists] = None) -> torch.Tensor:
        """a [m, kw] int32; b [<= k_p, n or n_p] int8/bool 0/1, rows in
        ``bit_order`` → C [m, n] int8 0/1 (a view of an [m, n_p] tensor
        on a card).  ``lists``: this A's :meth:`list_rows` at B's row
        count, which a card then uses instead of listing A again (the
        CPU's plain version needs none)."""
        if b.dtype == torch.bool:
            b = b.view(torch.int8)
        if a.dtype != torch.int32 or b.dtype != torch.int8:
            raise TypeError(
                f"PackedMatmulPlan wants int32 A and int8 B, got "
                f"{a.dtype} and {b.dtype}"
            )
        if (
            tuple(a.shape) != (self.m, self.kw)
            or b.dim() != 2
            or b.shape[0] > self.k_p
            or b.shape[1] not in (self.n, self.n_p)
        ):
            raise ValueError(
                f"PackedMatmulPlan({self.m}, {self.kw}, {self.n}) got A "
                f"{tuple(a.shape)} and B {tuple(b.shape)}"
            )
        if a.device != b.device:
            raise ValueError(f"A on {a.device} but B on {b.device}")
        if a.device.type == "cpu":
            return plain_packed_andor(a, b[:, : self.n])
        if a.device.type != "cuda":
            raise ValueError(f"no packed-contraction kernels for {a.device}")
        if lists is not None:
            want = (-(-self.m // KERNEL_TM), _chunks(b.shape[0]))
            if tuple(lists.counts.shape) != want or lists.counts.device != a.device:
                raise ValueError(
                    f"lists of {tuple(lists.counts.shape)} chunks on "
                    f"{lists.counts.device}, {want} on {a.device} wanted"
                )
        return self._launch(a, b, lists)

    def slabs(self, device) -> list:
        """Row ranges (whole row blocks) whose lists fit the budget."""
        device = torch.device(device)
        got = self._slabs.get(device)
        if got is None:
            got = self._slabs[device] = _list_slabs(
                self.m, self.k_p, self.temp_budget_bytes, device
            )
        return got

    def list_rows(self, a: torch.Tensor, k_rows: int) -> ColumnLists:
        """The :class:`ColumnLists` of A's set bits at
        contraction indices below ``k_rows`` (B's row count): on a card
        ``packed_andor_list`` on a contiguous int32 A [rows, kw], written
        into the plan's list buffers (so the next listing overwrites
        them) or, past their size, into fresh ones; on the CPU
        :func:`plain_andor_list`."""
        if a.dtype != torch.int32 or a.dim() != 2 or a.shape[1] != self.kw:
            raise ValueError(f"A must be int32 [rows, {self.kw}], got "
                             f"{a.dtype} {tuple(a.shape)}")
        if not 0 <= k_rows <= self.k_p:
            raise ValueError(f"k_rows={k_rows} outside [0, {self.k_p}]")
        if a.device.type == "cpu":
            return plain_andor_list(a, k_rows)
        if a.device.type != "cuda" or not a.is_contiguous():
            raise ValueError(f"packed_andor_list takes a contiguous A on a "
                             f"card, got one on {a.device}")
        rows = a.shape[0]
        if rows == 0:
            return _new_lists(0, k_rows, a.device)
        if -(-rows // KERNEL_TM) > 65535:
            raise ValueError(f"{rows} rows exceed the kernel grid")
        bufs = self._lists.get(a.device)
        if bufs is None:
            r0, r1 = self.slabs(a.device)[0]
            bufs = self._lists[a.device] = _new_lists(r1 - r0, self.k_p, a.device)
        if -(-rows // KERNEL_TM) * _chunks(k_rows) > bufs.counts.numel():
            bufs = _new_lists(rows, k_rows, a.device)
        lists = _lists_in(bufs, rows, k_rows)
        lib = _lib()
        code = lib.packed_andor_list(
            a.data_ptr(), lists.cols.data_ptr(), lists.masks.data_ptr(),
            lists.counts.data_ptr(), rows, self.kw, k_rows, _stream(a),
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_andor_list")
        _count_launch("packed_andor_list")
        return lists

    def _launch(self, a: torch.Tensor, b: torch.Tensor,
                lists: Optional[ColumnLists]) -> torch.Tensor:
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("the packed-contraction kernels take contiguous A and B")
        if b.shape[1] != self.n_p:
            b_p = torch.zeros((b.shape[0], self.n_p), dtype=torch.int8,
                              device=b.device)
            b_p[:, : self.n] = b
            b = b_p
        if b.data_ptr() % 4:
            raise ValueError("B must start on a 4-byte boundary (it is read as words)")
        c = torch.empty((self.m, self.n_p), dtype=torch.int8, device=a.device)
        k = b.shape[0]
        if self.m == 0 or self.n == 0:
            return c[:, : self.n]
        if self.kw == 0 or k == 0:
            return c.zero_()[:, : self.n]
        b32, c32 = b.view(torch.int32), c.view(torch.int32)
        if lists is not None:
            _run_sparse(b32, lists, c32, k, False)
        else:
            for r0, r1 in self.slabs(a.device):
                _run_sparse(b32, self.list_rows(a[r0:r1], k), c32[r0:r1], k, False)
        return c[:, : self.n]


def plain_packed_andor(a: torch.Tensor, b: torch.Tensor,
                       k_block: int = 4096) -> torch.Tensor:
    """The plain PyTorch version of :class:`PackedMatmulPlan`'s product
    (the port of the
    reference's ``_xla``): unpack A in logical bit order → matmul → ``> 0``
    → int8, with B's rows in logical order.  The count accumulates in
    float32 (exact below 2^24 terms; int8 matmuls wrap on the CPU), over
    contraction blocks of ``k_block`` bits, skipping blocks where A has no
    set bit."""
    m, kw = a.shape
    k, n = b.shape
    assert k < (1 << 24), "float32 accumulation is exact only below 2^24 terms"
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    wb = max(k_block // 32, 1)
    for w0 in range(0, min(kw, -(-k // 32)), wb):
        w1 = min(w0 + wb, kw)
        k0, k1 = 32 * w0, min(32 * w1, k)
        blk = a[:, w0:w1]
        if not bool((blk != 0).any()):
            continue
        bits = unpack_words(blk, k1 - k0, torch.float32)
        acc += bits @ b[k0:k1].to(torch.float32)
    return (acc > 0).to(torch.int8)


def plain_andor_list(a: torch.Tensor, k: int) -> ColumnLists:
    """The plain PyTorch version of ``packed_andor_list``: the
    :func:`plain_list_columns` listing of A's first ``k`` bits, unpacked
    in logical order (bit p of word w is contraction index 32·w + p),
    with each row block's entries packed densely into its chunks (chunk
    c holds entries ``chunk·c`` onwards, every chunk before the last
    nonempty one full).  Invalid entries hold -1 and 0."""
    lists = plain_list_columns(unpack_words(a, k, torch.int8))
    gm, nch, chunk = lists.cols.shape
    dev = a.device
    slots = torch.arange(nch * chunk, device=dev)
    valid = (slots % chunk)[None, :] < lists.counts.repeat_interleave(chunk, 1)
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    total = lists.counts.sum(1, keepdim=True)
    keep = slots[None, :] < total
    cols = torch.where(keep, torch.gather(lists.cols.view(gm, -1), 1, order), -1)
    masks = torch.where(keep, torch.gather(lists.masks.view(gm, -1), 1, order), 0)
    counts = (total - chunk * torch.arange(nch, device=dev)).clamp(0, chunk)
    return ColumnLists(cols.view(gm, nch, chunk).contiguous(),
                       masks.view(gm, nch, chunk).contiguous(),
                       counts.to(torch.int32))


def packed_andor_matmul(a: torch.Tensor, b_logical: torch.Tensor) -> torch.Tensor:
    """One-shot convenience: ``b_logical`` [K, N] int8/bool rows in
    logical bit order, laid out in the plan's ``bit_order`` by a gather
    (positions past K get zero rows).  Hot paths build B in ``bit_order``
    directly."""
    plan = PackedMatmulPlan(a.shape[0], a.shape[1], b_logical.shape[1])
    if b_logical.dtype == torch.bool:
        b_logical = b_logical.view(torch.int8)
    valid = plan.bit_order < b_logical.shape[0]
    src = torch.as_tensor(np.where(valid, plan.bit_order, 0),
                          device=b_logical.device)
    keep = torch.as_tensor(valid, device=b_logical.device)[:, None]
    b = torch.where(keep, b_logical[src], 0).to(torch.int8)
    return plan(a, b.contiguous())
