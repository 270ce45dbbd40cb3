"""distel_tpu_torch's packed-contraction product against the reference's.

The port's plain ``PackedMatmulPlan`` / ``packed_andor_matmul`` (the
CPU path of the ``packed_andor`` kernel) must equal the reference's
``packed_andor_matmul`` as ``tests/test_ops.py`` runs it: the Pallas
``_andor_kernel`` body in interpret mode, and the ``use_xla`` contract.
Equality is bit for bit.  On a card the product is two launches: the
listing ``packed_andor_list`` (whose plain version ``plain_andor_list``
must list exactly the reference's unpacked bits) and
``packed_cols_sparse`` on B and C read as int32 words; that composition,
written out in plain torch here, must equal the reference too.  The
CUDA kernels themselves run only on a card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distel_tpu.ops.bitmatmul import packed_andor_matmul as ref_andor
from distel_tpu.ops.bitpack import pack_bool_columns as ref_pack
from distel_tpu.ops.bitpack import unpack_words as ref_unpack
from distel_tpu_torch.ops.bitmatmul import (
    KERNEL_TM,
    LAUNCHES,
    LIST_CHUNK,
    PackedMatmulPlan,
    list_entries,
    packed_andor_matmul,
    plain_andor_list,
    plain_packed_andor,
)
from distel_tpu_torch.ops.bitpack import to_words

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)


def _operands(seed, m, k, n, density, *, bit31=False, dead_rows_from=None):
    """A [m, kw·32] bits (zero past k), B [k, n] bits, and A packed."""
    rng = np.random.default_rng(seed)
    kw = (k + 31) // 32
    a = rng.random((m, kw * 32)) < density
    a[:, k:] = False
    if bit31:
        a[:, 31 : min(k, kw * 32) : 32] = True        # bit 31 of every word
    if dead_rows_from is not None:
        a[dead_rows_from:] = False
    b = rng.random((k, n)) < 0.05
    ap = np.asarray(ref_pack(jnp.asarray(a))).astype(np.uint32)
    return a, b, ap


CASES = {
    "unaligned": dict(m=70, k=300, n=90, density=0.1),
    "bit31": dict(m=33, k=256, n=17, density=0.05, bit31=True),
    "mostly-zero": dict(m=64, k=500, n=40, density=0.01, dead_rows_from=5),
    "all-zero": dict(m=9, k=64, n=33, density=0.0),
}


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference(mode, case):
    kw = dict(CASES[case])
    m, k, n = kw.pop("m"), kw.pop("k"), kw.pop("n")
    a, b, ap = _operands(3, m, k, n, **kw)
    want = np.asarray(
        ref_andor(jnp.asarray(ap), jnp.asarray(b, jnp.int8),
                  use_xla=(mode == "xla"), interpret=(mode == "interpret"))
    )
    before = dict(LAUNCHES)
    got = packed_andor_matmul(to_words(ap), torch.from_numpy(b))
    assert dict(LAUNCHES) == before            # the plain version never counts
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, n)
    assert (got.numpy() == want).all()
    assert (got.numpy().astype(bool) == ((a[:, :k].astype(np.float32)
                                          @ b.astype(np.float32)) > 0)).all()


def test_bit_order_is_the_logical_permutation():
    plan = PackedMatmulPlan(5, 7, 3)
    assert plan.k_p == 7 * 32
    assert sorted(plan.bit_order.tolist()) == list(range(plan.k_p))
    assert (plan.bit_order == np.arange(plan.k_p)).all()
    assert plan.n_p % 16 == 0 and plan.n_p >= plan.n


def test_plan_with_b_in_its_own_bit_order():
    """B laid out by ``plan.bit_order`` (as an engine builds it), fewer
    rows than k_p, and also given with the padded n_p columns."""
    m, k, n = 40, 100, 33
    a, b, ap = _operands(5, m, k, n, 0.2)
    plan = PackedMatmulPlan(m, ap.shape[1], n)
    bk = np.zeros((k, n), np.int8)
    valid = plan.bit_order < k
    bk[: valid.sum()] = b[plan.bit_order[valid]]
    want = (a[:, :k].astype(np.float32) @ b.astype(np.float32)) > 0
    got = plan(to_words(ap), torch.from_numpy(bk))
    assert (got.numpy().astype(bool) == want).all()
    wide = np.zeros((k, plan.n_p), np.int8)
    wide[:, :n] = bk
    got = plan(to_words(ap), torch.from_numpy(wide).bool())
    assert (got.numpy().astype(bool) == want).all()


def test_plain_contraction_blocks_and_bits_past_b():
    """Small contraction blocks give the same product, and A bits past
    B's last row select nothing."""
    m, k, n = 21, 200, 11
    a, b, ap = _operands(9, m, k, n, 0.3)
    at = to_words(ap)
    bt = torch.from_numpy(b.astype(np.int8))
    full = plain_packed_andor(at, bt)
    assert torch.equal(plain_packed_andor(at, bt, k_block=32), full)
    short = plain_packed_andor(at, bt[:70])
    want = (a[:, :70].astype(np.float32) @ b[:70].astype(np.float32)) > 0
    assert (short.numpy().astype(bool) == want).all()


def test_wrapper_checks_shapes_and_types():
    plan = PackedMatmulPlan(4, 2, 5)
    a = torch.zeros((4, 2), dtype=torch.int32)
    b = torch.zeros((64, 5), dtype=torch.int8)
    assert plan(a, b).shape == (4, 5)
    with pytest.raises(ValueError):
        plan(a[:3], b)
    with pytest.raises(ValueError):
        plan(a, torch.zeros((65, 5), dtype=torch.int8))   # more rows than k_p
    with pytest.raises(ValueError):
        plan(a, b[:, :4])
    with pytest.raises(TypeError):
        plan(a.to(torch.int64), b)
    with pytest.raises(TypeError):
        plan(a, b.to(torch.int32))


# ------------------------------------------------------------ the card's route


def _words(seed, m, kw, density, *, bit31=False):
    """A packed along K, uint32 [m, kw], with about ``density`` of all
    its 32·kw bit positions set (so also bits past a shorter B)."""
    rng = np.random.default_rng(seed)
    a = rng.random((m, kw * 32)) < density
    if bit31:
        a[:, 31::32] = True                             # bit 31 of every word
    return np.asarray(ref_pack(jnp.asarray(a))).astype(np.uint32)


#: the listing's cases beyond CASES: (m, kw, k, n, density, bit31)
LIST_EXTRA = {
    "rows-not-64": (130, 9, 288, 21, 0.05, False),      # M % 64 != 0, 3 row blocks
    "bits-past-k": (40, 12, 300, 37, 0.2, False),       # K % 32, K % 256 != 0
    "bit31-every-word": (70, 20, 640, 19, 0.01, True),  # several list chunks
    "all-zero-wide": (65, 17, 530, 8, 0.0, False),
    "many-chunks": (70, 300, 9500, 9, 0.002, False),    # 38 chunks, several full
}
LIST_CASES = sorted(CASES) + sorted(LIST_EXTRA)


def _list_case(name, seed=11):
    """(A words uint32 [m, kw], B bool [k, n], k) of a listing case."""
    if name in CASES:
        kw = dict(CASES[name])
        m, k, n = kw.pop("m"), kw.pop("k"), kw.pop("n")
        _a, b, ap = _operands(seed, m, k, n, **kw)
        return ap, b, k
    m, kw, k, n, density, bit31 = LIST_EXTRA[name]
    b = np.random.default_rng(seed + 1).random((k, n)) < 0.05
    return _words(seed, m, kw, density, bit31=bit31), b, k


def _entry_blocks(lists):
    """The row block of each valid entry, in :func:`list_entries` order."""
    gm = lists.counts.shape[0]
    return torch.arange(gm).repeat_interleave(lists.counts.sum(1).long())


def _rows_of(block, mask):
    bits = (torch.tensor(mask) >> torch.arange(KERNEL_TM)) & 1
    return KERNEL_TM * block + torch.nonzero(bits).squeeze(1)


@pytest.mark.parametrize("case", LIST_CASES)
def test_plain_andor_list_matches_reference_bits(case):
    """Every listed (row, k) pair is a set bit of the reference's unpacked
    A below K and back; entries ascend in k within each row block, fill
    its chunks in order, and the masks are the reference's row bits."""
    ap, _b, k = _list_case(case)
    bits = np.asarray(ref_unpack(jnp.asarray(ap), k))          # [m, k]
    m = bits.shape[0]
    before = dict(LAUNCHES)
    lists = plain_andor_list(to_words(ap), k)
    assert dict(LAUNCHES) == before
    gm, nch = -(-m // KERNEL_TM), max(-(-k // LIST_CHUNK), 1)
    assert tuple(lists.counts.shape) == (gm, nch)
    cols, masks = list_entries(lists)
    blocks = _entry_blocks(lists)
    pairs = set()
    for g, col, mask in zip(blocks.tolist(), cols.tolist(), masks.tolist()):
        rows = _rows_of(g, mask).tolist()
        assert rows and max(rows) < m
        pairs.update((r, col) for r in rows)
    assert pairs == set(zip(*map(np.ndarray.tolist, np.nonzero(bits))))
    for g in range(gm):
        blk = bits[KERNEL_TM * g : KERNEL_TM * (g + 1)]
        want_cols = np.nonzero(blk.any(0))[0]
        want_masks = (
            blk[:, want_cols].astype(np.uint64)
            << np.arange(blk.shape[0], dtype=np.uint64)[:, None]
        ).sum(0, dtype=np.uint64).view(np.int64)
        assert np.array_equal(cols[blocks == g].numpy(), want_cols)
        assert np.array_equal(masks[blocks == g].numpy(), want_masks)
        # packed densely: every chunk before the last nonempty one full
        packed = np.clip(len(want_cols) - LIST_CHUNK * np.arange(nch), 0, LIST_CHUNK)
        assert np.array_equal(lists.counts[g].numpy(), packed)


def _route(a, b, k):
    """The card's route written out in plain torch: list A, then OR each
    listed B row, its 0/1 bytes read as int32 words, into the rows its
    mask selects; C's words read back as bytes."""
    m, n = a.shape[0], b.shape[1]
    n_p = PackedMatmulPlan(m, a.shape[1], n).n_p
    bp = torch.zeros((k, n_p), dtype=torch.int8)
    bp[:, :n] = torch.from_numpy(b.astype(np.int8))
    b32 = bp.view(torch.int32)
    c32 = torch.zeros((m, n_p // 4), dtype=torch.int32)
    lists = plain_andor_list(a, k)
    cols, masks = list_entries(lists)
    for g, col, mask in zip(_entry_blocks(lists).tolist(), cols.tolist(),
                            masks.tolist()):
        c32[_rows_of(g, mask)] |= b32[col]
    return c32.view(torch.int8)[:, :n]


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("case", LIST_CASES)
def test_route_composition_matches_reference(mode, case):
    """Listing, then the word-wise OR of the listed B rows, gives the
    reference's product bit for bit (bits past B's rows select nothing)."""
    ap, b, k = _list_case(case)
    want = np.asarray(
        ref_andor(jnp.asarray(ap), jnp.asarray(b, jnp.int8),
                  use_xla=(mode == "xla"), interpret=(mode == "interpret"))
    )
    got = _route(to_words(ap), b, k)
    assert got.dtype == torch.int8 and (got.numpy() == want).all()


def test_list_rows_on_the_cpu_is_the_plain_listing():
    """The plan's listing takes the plain version for a CPU tensor and
    checks what it is given; the CPU product ignores ``lists``."""
    ap, b, k = _list_case("bits-past-k")
    a = to_words(ap)
    plan = PackedMatmulPlan(a.shape[0], a.shape[1], b.shape[1])
    got, want = plan.list_rows(a, k), plain_andor_list(a, k)
    assert torch.equal(got.counts, want.counts)
    for x, y in zip(list_entries(got), list_entries(want)):
        assert torch.equal(x, y)
    bt = torch.from_numpy(b.astype(np.int8))
    assert torch.equal(plan(a, bt, lists=got), plan(a, bt))
    with pytest.raises(ValueError):
        plan.list_rows(a, plan.k_p + 1)
    with pytest.raises(ValueError):
        plan.list_rows(a[:, :-1].contiguous(), k)
