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

:class:`PackedColsMatmulPlan` runs one of two hand-written CUDA kernels
(``csrc/packed_cols.cu``) for CUDA tensors — ``packed_cols_dense``, or
``packed_cols_sparse``, which walks only the A tiles holding a nonzero —
and its plain PyTorch version for CPU tensors.

The second, the packed-contraction product, is the packed engine's
(CR4 and CR6 over the x-major R):

    A  [M, KW]  int32 — state rows packed along the contraction K
    B  [K, N]   int8  — per-step 0/1 operand, rows in the plan's
                        ``bit_order``
    C  [M, N]   int8  — 0/1

:class:`PackedMatmulPlan` runs the hand-written ``packed_andor`` kernel
(``csrc/packed_andor.cu``) for CUDA tensors and its plain version for
CPU tensors.

There is no fallback: a CUDA tensor launches its kernel or raises.
Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from distel_tpu_torch.ops.bitpack import pack_planes, unpack_words, unpack_words_planes

#: kernel launches since the last :func:`reset_launches`, per entry point
#: (the plain CPU version never counts)
LAUNCHES = {"packed_cols_dense": 0, "packed_cols_sparse": 0, "packed_andor": 0}

#: the kernels' block tile (rows of C, contraction rows, words of C);
#: checked against the built library when it loads
KERNEL_TM, KERNEL_TL, KERNEL_TW = 64, 32, 128

#: auto ``skip_zero_tiles`` threshold in word-ANDs (M·L·W): below it the
#: torch pass that lists live tiles (about 0.16 ms) costs more than
#: skipping saves.  Set inside the crossover that ``chip_smoke.py``
#: measured on an H100 (both kernels on the classify's own operands):
#: dense faster at 6.5e8 word-ANDs and below, sparse faster at 2.1e9
#: and above.
SKIP_TILES_MIN_WORK = 1 << 30

#: ``packed_andor``'s block tile (rows of C, bytes of C) and the byte
#: alignment it needs of B's and C's rows; checked against the library
ANDOR_TM, ANDOR_TN, ANDOR_ALIGN = 16, 4096, 16

_LIB = None
_ANDOR_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    """The kernels' library, built from ``csrc/packed_cols.cu`` on first
    use (see ``ops/build.py``)."""
    global _LIB
    if _LIB is None:
        from distel_tpu_torch.ops import build

        lib = build.load("packed_cols")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.packed_cols_dense.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.packed_cols_dense.restype = ci
        lib.packed_cols_sparse.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.packed_cols_sparse.restype = ci
        lib.packed_cols_error_string.argtypes = [ci]
        lib.packed_cols_error_string.restype = ctypes.c_char_p
        tiles = (
            lib.packed_cols_tile_m(), lib.packed_cols_tile_l(),
            lib.packed_cols_tile_w(),
        )
        if tiles != (KERNEL_TM, KERNEL_TL, KERNEL_TW):
            raise RuntimeError(
                f"packed_cols library tiles {tiles} != wrapper's "
                f"{(KERNEL_TM, KERNEL_TL, KERNEL_TW)}"
            )
        _LIB = lib
    return _LIB


def _andor_lib():
    """``packed_andor``'s library, built from ``csrc/packed_andor.cu`` on
    first use."""
    global _ANDOR_LIB
    if _ANDOR_LIB is None:
        from distel_tpu_torch.ops import build

        lib = build.load("packed_andor")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.packed_andor.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.packed_andor.restype = ci
        lib.packed_andor_error_string.argtypes = [ci]
        lib.packed_andor_error_string.restype = ctypes.c_char_p
        tiles = (
            lib.packed_andor_tile_m(), lib.packed_andor_tile_n(),
            lib.packed_andor_align(),
        )
        if tiles != (ANDOR_TM, ANDOR_TN, ANDOR_ALIGN):
            raise RuntimeError(
                f"packed_andor library tiles {tiles} != wrapper's "
                f"{(ANDOR_TM, ANDOR_TN, ANDOR_ALIGN)}"
            )
        _ANDOR_LIB = lib
    return _ANDOR_LIB


def _check_launch(error_string, code: int, what: str) -> None:
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def live_tiles(a: torch.Tensor, tm: int = KERNEL_TM, tl: int = KERNEL_TL):
    """Per-(row block, contraction tile) liveness of ``a`` [M, L] as the
    sparse kernel's compacted lists: ``live_k`` [GM, GK] int32 holds, per
    row block, the ascending ids of the ``tl``-wide contraction tiles
    whose ``tm``-row A tile has any nonzero (then GK as filler), and
    ``n_live`` [GM] int32 counts them.  Plain torch ops on ``a``'s
    device — the counterpart of the TPU kernel's scalar-prefetch
    ``flags``/``plk``."""
    m, l = a.shape
    gm, gk = -(-m // tm), -(-l // tl)
    nz = torch.zeros((gm * tm, gk * tl), dtype=torch.bool, device=a.device)
    nz[:m, :l] = a != 0
    live = nz.view(gm, tm, gk, tl).any(dim=3).any(dim=1)          # [GM, GK]
    ks = torch.arange(gk, dtype=torch.int32, device=a.device)
    live_k = torch.where(live, ks[None, :], gk).sort(dim=1).values
    return live_k.to(torch.int32).contiguous(), live.sum(1).to(torch.int32)


class PackedColsMatmulPlan:
    """AND-OR semiring product with **packed output columns** for fixed
    shapes ``[m, l] ⊙ [l, w]``.

    ``skip_zero_tiles``: launch the tile-skipping kernel (None = auto,
    by :data:`SKIP_TILES_MIN_WORK`).  The choice never changes the
    result, only which kernel a CUDA call launches."""

    def __init__(self, m: int, l: int, w: int, *,
                 skip_zero_tiles: Optional[bool] = None):
        self.m, self.l, self.w = int(m), int(l), int(w)
        if skip_zero_tiles is None:
            skip_zero_tiles = self.m * self.l * self.w >= SKIP_TILES_MIN_WORK
        self.skip_zero_tiles = bool(skip_zero_tiles)

    def __call__(self, a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
        """a [m, l] int8/bool; b_packed [l, w] int32 → [m, w] int32."""
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
        if a.device.type == "cpu":
            return plain_packed_cols(a, b_packed)
        if a.device.type != "cuda":
            raise ValueError(f"no packed-columns kernel for {a.device}")
        return self._launch(a, b_packed)

    def _launch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("packed-columns kernels take contiguous A and B")
        if -(-self.m // KERNEL_TM) > 65535:
            raise ValueError(f"M={self.m} exceeds the kernel grid")
        c = torch.empty((self.m, self.w), dtype=torch.int32, device=a.device)
        if self.m == 0 or self.w == 0:
            return c
        if self.l == 0:
            return c.zero_()
        if self.skip_zero_tiles:
            return self._launch_sparse(a, b, *live_tiles(a), c)
        lib = _lib()
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.packed_cols_dense(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), self.m, self.l,
            self.w, stream,
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_dense")
        LAUNCHES["packed_cols_dense"] += 1
        return c

    def _launch_sparse(self, a, b, live_k, n_live, c):
        """The sparse kernel on lists :func:`live_tiles` built."""
        lib = _lib()
        code = lib.packed_cols_sparse(
            a.data_ptr(), b.data_ptr(), live_k.data_ptr(),
            n_live.data_ptr(), c.data_ptr(), self.m, self.l, self.w,
            live_k.shape[1], torch.cuda.current_stream(a.device).cuda_stream,
        )
        _check_launch(lib.packed_cols_error_string, code, "packed_cols_sparse")
        LAUNCHES["packed_cols_sparse"] += 1
        return c


def plain_packed_cols(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernels' contract (the port of
    the reference's ``_xla``): plane-major unpack of B → matmul → ``> 0``
    → repack.  Only A's nonzero rows and columns enter the matmul — the
    others contribute nothing to an OR — and the count accumulates in
    float32, exact for any L below 2^24."""
    m, l = a.shape
    w = b_packed.shape[1]
    assert l < (1 << 24), "float32 accumulation is exact only below 2^24 terms"
    out = torch.zeros((m, w), dtype=torch.int32, device=a.device)
    nz = a != 0
    rows = nz.any(dim=1).nonzero().squeeze(1)
    cols = nz.any(dim=0).nonzero().squeeze(1)
    if rows.numel() == 0 or w == 0:
        return out
    a_sub = a[rows][:, cols].to(torch.float32)
    bits = unpack_words_planes(b_packed[cols], torch.float32)
    prod = a_sub @ bits
    out[rows] = pack_planes(prod > 0)
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
    ``k = 32·w + p`` (bit p of word w), which is what a kernel that walks
    A's set bits reads.  ``n_p`` is n rounded up to the kernel's row
    alignment: a B (or C) with ``n_p`` columns is used without a copy,
    its extra columns zero."""

    def __init__(self, m: int, kw: int, n: int):
        self.m, self.kw, self.n = int(m), int(kw), int(n)
        self.k_p = self.kw * 32
        self.n_p = _pad_up(max(self.n, 1), ANDOR_ALIGN)
        #: B row position → logical contraction bit (length k_p)
        self.bit_order = np.arange(self.k_p)

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [m, kw] int32; b [<= k_p, n or n_p] int8/bool 0/1, rows in
        ``bit_order`` → C [m, n] int8 0/1 (a view of an [m, n_p] tensor
        on a card)."""
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
            raise ValueError(f"no packed_andor kernel for {a.device}")
        return self._launch(a, b)

    def _launch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("packed_andor takes contiguous A and B")
        if -(-self.m // ANDOR_TM) > 65535:
            raise ValueError(f"M={self.m} exceeds the kernel grid")
        if b.shape[1] != self.n_p:
            b_p = torch.zeros((b.shape[0], self.n_p), dtype=torch.int8,
                              device=b.device)
            b_p[:, : self.n] = b
            b = b_p
        c = torch.empty((self.m, self.n_p), dtype=torch.int8, device=a.device)
        if self.m == 0 or self.n == 0:
            return c[:, : self.n]
        if self.kw == 0 or b.shape[0] == 0:
            return c.zero_()[:, : self.n]
        for t in (b, c):
            if t.data_ptr() % ANDOR_ALIGN:
                raise ValueError(f"packed_andor needs {ANDOR_ALIGN}-byte "
                                 "aligned B and C")
        lib = _andor_lib()
        code = lib.packed_andor(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), self.m, self.kw,
            b.shape[0], self.n_p, torch.cuda.current_stream(a.device).cuda_stream,
        )
        _check_launch(lib.packed_andor_error_string, code, "packed_andor")
        LAUNCHES["packed_andor"] += 1
        return c[:, : self.n]


def plain_packed_andor(a: torch.Tensor, b: torch.Tensor,
                       k_block: int = 4096) -> torch.Tensor:
    """The plain PyTorch version of ``packed_andor`` (the port of the
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
