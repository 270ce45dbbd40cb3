"""distel_tpu_torch.ops.bitmatmul against the reference's Pallas plans.

The port's plain ``PackedColsMatmulPlan`` (the CPU path) must equal the
reference plan run as the reference's own tests run it
(``tests/test_ops.py``): the Pallas kernel bodies in interpret mode,
dense and tile-skipping, and the ``use_xla`` contract.  Equality is
bit for bit.  The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``).
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
    live_tiles,
    plain_packed_cols,
)
from distel_tpu_torch.ops.bitpack import from_words, to_words


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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_tiles_match_reference_flags(seed):
    rng = np.random.default_rng(seed)
    m, l, tm, tl = 70, 200, 16, 32
    a = rng.random((m, l)) < 0.01
    a[20:40] = False
    live_k, n_live = live_tiles(torch.from_numpy(a.astype(np.int8)), tm, tl)
    flags, plk = _ref_flags_plk(a, tm, tl)
    gm, gk = flags.shape
    assert live_k.shape == (gm, gk) and n_live.shape == (gm,)
    assert live_k.dtype == n_live.dtype == torch.int32
    assert (n_live.numpy() == flags.sum(1)).all()
    for i in range(gm):
        ks = live_k[i, : n_live[i]].numpy()
        assert (ks == np.flatnonzero(flags[i])).all()
        assert (live_k[i, n_live[i]:].numpy() == gk).all()
        # the redirect: last live k' <= k (0 before the first)
        redirect = np.zeros(gk, np.int64)
        for k in range(gk):
            prior = ks[ks <= k]
            redirect[k] = prior[-1] if len(prior) else 0
        assert (redirect == plk[i]).all()
