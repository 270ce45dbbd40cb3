"""distel_tpu_torch.ops.bitpack against distel_tpu.ops.bitpack.

The same seeded numpy inputs go through the JAX functions and their
PyTorch counterparts; packed words must agree bit for bit (0 tolerance:
the data are bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distel_tpu.ops import bitpack as ref
from distel_tpu_torch.ops import bitpack as port

# six xdist workers share the host's cores: without a cap each would
# start one torch thread per core
torch.set_num_threads(2)


def _words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return port.to_words(a)


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_match_reference(seed):
    rng = np.random.default_rng(seed)
    bits = rng.random((13, 96)) < 0.3
    got = port.from_words(port.pack_bool_columns(torch.from_numpy(bits)))
    assert (got == _u32(ref.pack_bool_columns(jnp.asarray(bits)))).all()

    w = _words(rng, (11, 5))
    w[0, 0] = 0x80000000                    # bit 31 alone
    w[1, 1] = 0xFFFFFFFF
    for m in (160, 150, 1):
        got = port.unpack_words(_t(w), m).numpy()
        assert (got == np.asarray(ref.unpack_words(jnp.asarray(w), m))).all()
    planes = port.unpack_words_planes(_t(w)).numpy()
    assert (planes == np.asarray(ref.unpack_words_planes(jnp.asarray(w)))).all()
    back = port.from_words(port.pack_planes(torch.from_numpy(planes)))
    assert (back == _u32(ref.pack_planes(jnp.asarray(planes)))).all()
    assert (back == w).all()


def test_words_roundtrip_keeps_bit_31():
    w = np.array([[0x80000000, 0xFFFFFFFF, 1, 0]], np.uint32)
    t = _t(w)
    assert t.dtype == torch.int32
    assert (port.from_words(t) == w).all()
    assert ((t >> 31) & 1).tolist() == [[1, 1, 0, 0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_lookup_matches_reference(seed):
    rng = np.random.default_rng(seed)
    p = _words(rng, (40, 6))
    rows = rng.integers(0, 40, 17)
    cols = rng.integers(0, 6 * 32, 23)
    cols[0] = 31
    got = port.bit_lookup(_t(p), rows, cols).numpy()
    want = np.asarray(ref.bit_lookup(jnp.asarray(p), rows, jnp.asarray(cols)))
    assert got.shape == want.shape == (23, 17)
    assert (got == want).all()
    subt = np.ascontiguousarray(p[rows].T)
    got = port.bit_lookup_from(_t(subt), cols, dtype=torch.int8).numpy()
    want = np.asarray(
        ref.bit_lookup_from(jnp.asarray(subt), jnp.asarray(cols), dtype=jnp.int8)
    )
    assert (got == want).all()
    empty = port.bit_lookup(_t(p), np.zeros(0, np.int64), cols)
    assert empty.shape == (23, 0)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 33])
def test_or_reduce_any(n):
    rng = np.random.default_rng(n)
    w = _words(rng, (n, 7))
    got = port.from_words(port.or_reduce_any(_t(w), 0))
    assert (got == np.bitwise_or.reduce(w, axis=0)).all()


@pytest.mark.parametrize("trial", range(6))
def test_segmented_row_or_matches_reference(trial):
    """Plan (order, targets, buckets) identical to the reference's; the
    torch reduce/write agree with the reference and a per-axiom loop,
    with a bit-31 word among the sources."""
    r = np.random.default_rng(trial)
    n_targets = int(r.integers(1, 40))
    k = int(r.integers(1, 150))
    tgt = r.integers(0, n_targets, k)
    plan = port.SegmentedRowOr(tgt)
    rplan = ref.SegmentedRowOr(tgt)
    assert (plan.order == rplan.order).all()
    assert (plan.targets == rplan.targets).all()
    assert plan._buckets == rplan._buckets
    n, w = 50, 3
    state = _words(r, (n, w))
    state[int(r.integers(0, n)), 0] = 0x80000000
    src = r.integers(0, n, k)
    expect = state.copy()
    for j in range(k):
        expect[tgt[j]] |= state[src[j]]
    permuted = state[src][plan.order]
    red = port.from_words(plan.reduce(_t(permuted)))
    assert (red == _u32(rplan.reduce(jnp.asarray(permuted)))).all()
    st = _t(state)
    changed = plan.write(st, plan.reduce(_t(permuted)))
    assert (port.from_words(st) == expect).all()
    assert bool(changed) == bool((expect != state).any())
    ref_st, ref_changed = rplan.write(jnp.asarray(state), jnp.asarray(red), track=True)
    assert (port.from_words(st) == _u32(ref_st)).all()
    assert bool(changed) == bool(ref_changed)
    # the per-target change vector (track="rows"), as the reference's
    st = _t(state)
    rows = plan.write(st, plan.reduce(_t(permuted)), track="rows")
    _, ref_rows = rplan.write(jnp.asarray(state), jnp.asarray(red), track="rows")
    assert rows.dtype == torch.bool and rows.shape == (len(plan.targets),)
    assert (rows.numpy() == np.asarray(ref_rows)).all()
    assert (rows.numpy() == (expect != state).any(axis=1)[plan.targets]).all()
    # a column block: only those words move
    st = _t(state)
    plan.write(st, plan.reduce(_t(permuted))[:, 1:], slice(1, None))
    got = port.from_words(st)
    assert (got[:, 0] == state[:, 0]).all() and (got[:, 1:] == expect[:, 1:]).all()


def test_segmented_row_or_bit31_target_and_empty():
    plan = port.SegmentedRowOr(np.array([2, 2, 0]))
    state = np.zeros((3, 2), np.uint32)
    rows = np.array([[0x80000000, 0], [1, 0x80000000], [5, 0]], np.uint32)
    red = plan.reduce(_t(rows[plan.order]))
    st = _t(state)
    assert bool(plan.write(st, red))
    got = port.from_words(st)
    assert got[2].tolist() == [0x80000001, 0x80000000]
    assert got[0].tolist() == [5, 0]
    assert not bool(plan.write(st, red))    # idempotent second write
    empty = port.SegmentedRowOr(np.zeros(0, np.int64))
    out = empty.reduce(torch.zeros((0, 4), dtype=torch.int32))
    assert out.shape == (0, 4)
    st = torch.ones((3, 4), dtype=torch.int32)
    assert not bool(empty.write(st, out))
    assert empty.write(st, out, track="rows").shape == (0,)
    assert (st == 1).all()


def test_next_pow2_matches_reference():
    c = np.arange(1, 5000)
    assert (port._next_pow2(c) == ref._next_pow2(c)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_bit_columns_and_matrix_match_reference(seed):
    """Both gathers against the reference, with bit 31 among the
    columns and an all-ones word, from numpy and tensor indices."""
    rng = np.random.default_rng(seed)
    p = _words(rng, (21, 4))
    p[3, 2] = 0x80000000
    p[4, 1] = 0xFFFFFFFF
    cols = rng.integers(0, 4 * 32, 19)
    cols[:3] = [31, 95, 63]
    rows = rng.integers(0, 21, 13)
    rows[:2] = [3, 4]
    got = port.gather_bit_columns(_t(p), cols)
    assert got.dtype == torch.bool and got.shape == (21, 19)
    assert (got.numpy() == np.asarray(ref.gather_bit_columns(jnp.asarray(p), cols))).all()
    assert torch.equal(port.gather_bit_columns(_t(p), torch.as_tensor(cols)), got)
    got = port.gather_bit_matrix(_t(p), rows, cols)
    want = np.asarray(ref.gather_bit_matrix(jnp.asarray(p), rows, cols))
    assert got.shape == (13, 19) and (got.numpy() == want).all()
    assert port.gather_bit_columns(_t(p), np.zeros(0, np.int64)).shape == (21, 0)
    assert port.gather_bit_matrix(_t(p), rows, np.zeros(0, np.int64)).shape == (13, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_scatter_matches_reference(seed):
    """Repeated targets, a bit-31 target, sources given whole or as
    column blocks, functional and in place, against the reference and
    a per-source loop."""
    rng = np.random.default_rng(seed)
    n, w = 17, 4
    base = _words(rng, (n, w))
    base[:, 3] &= 0x7FFFFFFF                 # bit 127 clear: the scatter sets it
    targets = rng.integers(0, w * 32, 40)
    targets[:4] = [127, 31, 127, 31]         # repeated bit-31 targets
    bits = rng.random((n, len(targets))) < 0.3
    bits[:, 0] = True
    expect = port.unpack_words(_t(base), w * 32).numpy()
    for j, t in enumerate(targets):
        expect[:, t] |= bits[:, j]
    plan = port.ColumnScatter(targets, w)
    rplan = ref.ColumnScatter(targets, w)
    assert (plan.d_cols == rplan.d_cols).all() and (plan.inv == rplan.inv).all()
    want = _u32(rplan.apply(jnp.asarray(base), jnp.asarray(bits)))
    got = port.from_words(plan.apply(_t(base), torch.from_numpy(bits)))
    assert (got == want).all()
    assert (port.unpack_words(_t(got), w * 32).numpy() == expect).all()
    assert ((got[:, 3] >> 31) == 1).all()
    # column blocks, in place, with the change flag
    st = _t(base)
    blocks = [torch.from_numpy(bits[:, :7]), torch.from_numpy(bits[:, 7:])]
    assert bool(plan.apply_(st, blocks))
    assert (port.from_words(st) == want).all()
    assert not bool(plan.apply_(st, blocks))          # idempotent
    one_shot = port.scatter_or_columns(_t(base), torch.from_numpy(bits), targets)
    assert (port.from_words(one_shot) == want).all()
    with pytest.raises(ValueError, match="source columns"):
        plan.apply(_t(base), torch.from_numpy(bits[:, 1:]))


def test_column_scatter_empty():
    p = _t(_words(np.random.default_rng(4), (5, 1)))
    cs = port.ColumnScatter(np.zeros(0, np.int64), 1)
    assert cs.apply(p, torch.zeros((5, 0), dtype=torch.bool)) is p
    assert not bool(cs.apply_(p, torch.zeros((5, 0), dtype=torch.bool)))
