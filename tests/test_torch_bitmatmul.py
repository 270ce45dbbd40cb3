"""distel_tpu_torch.ops.bitmatmul against the reference's Pallas plans.

The port's plain ``PackedColsMatmulPlan`` (the CPU path) must equal the
reference plan run as the reference's own tests run it
(``tests/test_ops.py``): the Pallas kernel bodies in interpret mode,
dense and tile-skipping, and the ``use_xla`` contract, also when the
product is ORed into an existing C.  The plain listing of A's columns
(the sparse route's first kernel) must equal the reference's tile flags
at a one-column tile.  Equality is bit for bit.  The CUDA kernels
themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distel_tpu.ops.bitmatmul import PackedColsMatmulPlan as RefPlan
from distel_tpu.ops.bitpack import pack_bool_columns as ref_pack
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES,
    PackedColsMatmulPlan,
    list_entries,
    plain_list_columns,
    plain_packed_cols,
)
from distel_tpu_torch.ops.bitpack import from_words, to_words

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)


def _operands(seed, m, l, x, density, dead_rows_from=None):
    rng = np.random.default_rng(seed)
    w = (x + 31) // 32
    a = rng.random((m, l)) < density
    if dead_rows_from is not None:
        a[dead_rows_from:, :] = False       # most tiles dead
    b = rng.random((l, w * 32)) < 0.1
    return a, b, np.asarray(ref_pack(jnp.asarray(b))).astype(np.uint32)


@pytest.mark.parametrize(
    "mode", ["xla", "interpret", "interpret-sparse"]
)
@pytest.mark.parametrize(
    "shape,dead", [((37, 70, 130), None), ((37, 70, 130), 3), ((9, 33, 40), None)]
)
def test_plain_matches_reference_plan(mode, shape, dead):
    m, l, x = shape
    a, b, bp = _operands(7, m, l, x, 0.2, dead)
    ref_plan = RefPlan(
        m, l, bp.shape[1], use_xla=(mode == "xla"), interpret=(mode != "xla"),
        tm=8, tl=16, tw=8, skip_zero_tiles=(mode == "interpret-sparse"),
    )
    want = np.asarray(ref_plan(jnp.asarray(a, jnp.int8), jnp.asarray(bp)))
    want = want.astype(np.uint32)
    before = dict(LAUNCHES)
    for skip in (False, True):
        plan = PackedColsMatmulPlan(m, l, bp.shape[1], skip_zero_tiles=skip)
        got = from_words(plan(torch.from_numpy(a.astype(np.int8)), to_words(bp)))
        assert got.shape == want.shape == (m, bp.shape[1])
        assert (got == want).all()
    # the plain CPU version never counts as a kernel launch
    assert dict(LAUNCHES) == before
    ref_bits = (a.astype(np.float32) @ b.astype(np.float32)) > 0
    got_bits = np.unpackbits(want.view(np.uint8), axis=1, bitorder="little")
    assert (got_bits.astype(bool) == ref_bits).all()


def test_plain_edge_cases():
    b = to_words(np.arange(12, dtype=np.uint32).reshape(4, 3) | 0x80000000)
    zero = torch.zeros((5, 4), dtype=torch.int8)
    assert (plain_packed_cols(zero, b) == 0).all()
    one = torch.zeros((2, 4), dtype=torch.int8)
    one[1, 2] = 1
    out = from_words(plain_packed_cols(one, b))
    assert out[0].tolist() == [0, 0, 0]
    assert out[1].tolist() == [6 | 0x80000000, 7 | 0x80000000, 8 | 0x80000000]
    # bool operand is accepted as its int8 view
    plan = PackedColsMatmulPlan(2, 4, 3)
    assert (plan(one.bool(), b) == plain_packed_cols(one, b)).all()


def test_wrapper_checks_shapes_and_types():
    plan = PackedColsMatmulPlan(4, 8, 2)
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        plan(a[:3], b)
    with pytest.raises(TypeError):
        plan(a, b.to(torch.int64))
    with pytest.raises(TypeError):
        plan(a.to(torch.int32), b)


def test_skip_auto_threshold():
    big = bitmatmul.SKIP_TILES_MIN_WORK
    assert PackedColsMatmulPlan(1, 1, big).skip_zero_tiles
    assert not PackedColsMatmulPlan(1, 1, big - 1).skip_zero_tiles
    assert not PackedColsMatmulPlan(1, 1, big, skip_zero_tiles=False).skip_zero_tiles


def _ref_flags_plk(a, tm, tl):
    """The reference's inline flag/redirect computation
    (``PackedColsMatmulPlan.__call__``, skip_zero_tiles=True)."""
    m, l = a.shape
    gm, gk = -(-m // tm), -(-l // tl)
    a = jnp.pad(jnp.asarray(a, jnp.int8), ((0, gm * tm - m), (0, gk * tl - l)))
    live = (a != 0).reshape(gm, tm, gk, tl).any(axis=(1, 3))
    flags = live.astype(jnp.int32)
    plk = jnp.maximum(
        lax.cummax(
            jnp.where(live, jnp.arange(gk, dtype=jnp.int32)[None, :], -1), axis=1
        ),
        0,
    )
    return np.asarray(flags), np.asarray(plk)


def _np_lists(a, tm):
    """Per row block: the columns some row selects and their row masks
    (uint64), by numpy."""
    out = []
    for g in range(0, a.shape[0], tm):
        blk = a[g : g + tm] != 0
        cols = np.flatnonzero(blk.any(axis=0))
        masks = [
            int(sum(1 << int(r) for r in np.flatnonzero(blk[:, c])))
            for c in cols
        ]
        out.append((cols, masks))
    return out


def _as_uint64(t):
    return t.numpy().astype(np.int64).view(np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_tiles_match_reference_flags(seed):
    """The sparse route's column lists are the reference's tile flags at
    a one-column contraction tile (``tl = 1``), listed in order."""
    rng = np.random.default_rng(seed)
    m, l, tm = 70, 200, 16
    a = rng.random((m, l)) < 0.01
    a[20:40] = False
    lists = plain_list_columns(torch.from_numpy(a.astype(np.int8)), tm)
    flags, plk = _ref_flags_plk(a, tm, 1)
    gm, gk = flags.shape
    assert lists.counts.shape == (gm, 1) and gk == l
    assert lists.cols.dtype == lists.counts.dtype == torch.int32
    assert lists.masks.dtype == torch.int64
    assert (lists.counts[:, 0].numpy() == flags.sum(1)).all()
    for i in range(gm):
        n = int(lists.counts[i, 0])
        ks = lists.cols[i, 0, :n].numpy()
        assert (ks == np.flatnonzero(flags[i])).all()
        assert (lists.cols[i, 0, n:].numpy() == -1).all()
        # the reference's redirect is the last listed column <= k
        redirect = np.array([ks[ks <= k][-1] if (ks <= k).any() else 0
                             for k in range(gk)])
        assert (redirect == plk[i]).all()
        blk = a[i * tm : (i + 1) * tm]
        want = [sum(1 << int(r) for r in np.flatnonzero(blk[:, k])) for k in ks]
        assert _as_uint64(lists.masks[i, 0, :n]).tolist() == want


@pytest.mark.parametrize(
    "m,l,density,chunk",
    [
        (37, 70, 0.05, 1024),      # unaligned M and L, one ragged row block
        (130, 300, 0.02, 1024),    # more than 64 rows, ragged last block
        (64, 2100, 0.003, 1024),   # several list chunks, the last ragged
        (100, 90, 0.0, 1024),      # all-zero A: empty lists
        (70, 45, 1.0, 1024),       # fully dense A: every column, all rows
        (129, 200, 0.1, 32),       # small chunks: many per row block
    ],
)
def test_plain_list_columns_matches_numpy(m, l, density, chunk):
    """Per 64-row block, the ascending columns and their exact 64-bit
    row masks (bit 63 included), chunk by chunk."""
    rng = np.random.default_rng(m * l)
    a = rng.random((m, l)) < density
    lists = plain_list_columns(torch.from_numpy(a.astype(np.int8)), chunk=chunk)
    gm, nch = -(-m // 64), -(-l // chunk)
    assert lists.cols.shape == lists.masks.shape == (gm, nch, chunk)
    assert lists.counts.shape == (gm, nch)
    want = _np_lists(a, 64)
    for g, (cols, masks) in enumerate(want):
        got_cols, got_masks = [], []
        for c in range(nch):
            n = int(lists.counts[g, c])
            part = lists.cols[g, c, :n].numpy()
            assert ((part >= c * chunk) & (part < (c + 1) * chunk)).all()
            got_cols += part.tolist()
            got_masks += _as_uint64(lists.masks[g, c, :n]).tolist()
        assert got_cols == cols.tolist()
        assert got_masks == masks
    cols, masks = list_entries(lists)
    assert cols.tolist() == [c for cs, _ in want for c in cs.tolist()]
    assert _as_uint64(masks).tolist() == [x for _, ms in want for x in ms]
    if density == 1.0:
        assert int(lists.counts.sum()) == gm * l
        assert _as_uint64(lists.masks[0, 0, :1])[0] == np.uint64(2**64 - 1)


@pytest.mark.parametrize(
    "mode", ["xla", "interpret", "interpret-sparse"]
)
@pytest.mark.parametrize("shape", [(37, 70, 130), (70, 33, 40)])
def test_plain_accumulate_matches_reference_plan(mode, shape):
    """``out=`` ORs the product into a seeded C: the reference's product
    ORed with that C, bit 31 included."""
    m, l, x = shape
    a, _b, bp = _operands(11, m, l, x, 0.1)
    ref_plan = RefPlan(
        m, l, bp.shape[1], use_xla=(mode == "xla"), interpret=(mode != "xla"),
        tm=8, tl=16, tw=8, skip_zero_tiles=(mode == "interpret-sparse"),
    )
    want = np.asarray(ref_plan(jnp.asarray(a, jnp.int8), jnp.asarray(bp)))
    c0 = np.random.default_rng(5).integers(0, 2**32, (m, bp.shape[1]),
                                           dtype=np.uint64).astype(np.uint32)
    c0[:, 0] |= 0x80000000
    want = want.astype(np.uint32) | c0
    for skip in (False, True):
        out = to_words(c0.copy())
        plan = PackedColsMatmulPlan(m, l, bp.shape[1], skip_zero_tiles=skip)
        got = plan(torch.from_numpy(a.astype(np.int8)), to_words(bp), out=out)
        assert got is out
        assert (from_words(got) == want).all()


def test_out_checks():
    """``out`` must be an int32 [m, w] tensor apart from A and B."""
    plan = PackedColsMatmulPlan(4, 8, 2)
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="out must be int32"):
        plan(a, b, out=torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="overlap"):
        plan(a, b, out=b[:4])
    with pytest.raises(ValueError, match="overlap"):
        plan(a, b, out=a.view(torch.int32))
    out = torch.zeros((4, 2), dtype=torch.int32)
    assert plan(a, b, out=out) is out


@pytest.mark.parametrize("nb", [2, 4, 8])
@pytest.mark.parametrize("shape", [(37, 70, 130), (70, 33, 40), (1, 1, 1)])
def test_batched_row_counts_match_per_copy(nb, shape):
    """``batched_rows`` (the plain version of ``packed_cols_dense_n_batched``
    and ``packed_cols_list_n_batched`` + ``packed_cols_sparse_batched``)
    at random row counts, 0 and all included: copy k equals the per-copy
    ``plain_packed_cols_rows`` and the reference's ``use_xla`` contract
    on its rows below the count, ORed into a seeded C; the rows past it
    keep C's words; no kernel counts on the CPU."""
    m, l, x = shape
    rng = np.random.default_rng(nb * 100 + m)
    ops = [_operands(int(rng.integers(1 << 30)), m, l, x, 0.1)
           for _ in range(nb)]
    a = torch.from_numpy(np.stack([o[0] for o in ops]).astype(np.int8))
    bp = np.stack([o[2] for o in ops])
    w = bp.shape[2]
    c0 = rng.integers(0, 2**32, (nb, m, w), dtype=np.uint64).astype(np.uint32)
    c0[:, :, 0] |= 0x80000000
    counts = rng.integers(0, m + 1, nb)
    counts[0], counts[-1] = 0, m
    n_rows = torch.tensor(counts, dtype=torch.int32)
    before = dict(LAUNCHES)
    for skip in (False, True):
        plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=skip)
        out = to_words(c0.copy())
        got = plan.batched_rows(a, to_words(bp), out, n_rows)
        assert got is out
        for k in range(nb):
            want = to_words(c0[k].copy())
            bitmatmul.plain_packed_cols_rows(a[k], to_words(bp[k]), want,
                                             n_rows[k : k + 1])
            assert torch.equal(got[k], want), (k, counts[k])
            ref = np.asarray(RefPlan(m, l, w, use_xla=True)(
                jnp.asarray(a[k].numpy()), jnp.asarray(bp[k])
            )).astype(np.uint32)
            rows = int(counts[k])
            assert (from_words(got[k])[:rows] == (ref | c0[k])[:rows]).all()
            assert (from_words(got[k])[rows:] == c0[k][rows:]).all()
    assert dict(LAUNCHES) == before


def test_batched_rows_checks():
    """``batched_rows`` wants [nb, m, l] / [nb, l, w] / [nb, m, w]
    operands and one int32 count a copy."""
    plan = PackedColsMatmulPlan(4, 8, 2)
    a = torch.zeros((3, 4, 8), dtype=torch.int8)
    b = torch.zeros((3, 8, 2), dtype=torch.int32)
    out = torch.zeros((3, 4, 2), dtype=torch.int32)
    n = torch.zeros(3, dtype=torch.int32)
    assert plan.batched_rows(a, b, out, n) is out
    with pytest.raises(ValueError, match="batched_rows got"):
        plan.batched_rows(a[:, :3], b, out, n)
    with pytest.raises(ValueError, match="n_rows must be 3"):
        plan.batched_rows(a, b, out, n[:2])
    with pytest.raises(ValueError, match="n_rows must be 3"):
        plan.batched_rows(a, b, out, n.to(torch.int64))
    with pytest.raises(ValueError, match="overlap"):
        plan.batched_rows(a, b, b.view(-1)[:24].view(3, 4, 2), n)
    with pytest.raises(ValueError, match="contiguous"):
        plan.batched_rows(a, b, torch.zeros((3, 2, 4), dtype=torch.int32)
                          .transpose(1, 2), n)
