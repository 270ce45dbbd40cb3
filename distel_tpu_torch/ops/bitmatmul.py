"""Packed-columns AND-OR product: the saturation engine's contraction.

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
and its plain PyTorch version for CPU tensors.  There is no fallback: a
CUDA tensor launches its kernel or raises.  Each launch adds one to
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from distel_tpu_torch.ops.bitpack import pack_planes, unpack_words_planes

#: kernel launches since the last :func:`reset_launches`, per entry point
#: (the plain CPU version never counts)
LAUNCHES = {"packed_cols_dense": 0, "packed_cols_sparse": 0}

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

_LIB = None


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


def _check_launch(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.packed_cols_error_string(code).decode()
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
        _check_launch(lib, code, "packed_cols_dense")
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
        _check_launch(lib, code, "packed_cols_sparse")
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
