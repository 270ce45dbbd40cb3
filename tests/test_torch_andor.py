"""distel_tpu_torch's packed-contraction product against the reference's.

The port's plain ``PackedMatmulPlan`` / ``packed_andor_matmul`` (the
CPU path of the ``packed_andor`` kernel) must equal the reference's
``packed_andor_matmul`` as ``tests/test_ops.py`` runs it: the Pallas
``_andor_kernel`` body in interpret mode, and the ``use_xla`` contract.
Equality is bit for bit.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distel_tpu.ops.bitmatmul import packed_andor_matmul as ref_andor
from distel_tpu.ops.bitpack import pack_bool_columns as ref_pack
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES,
    PackedMatmulPlan,
    packed_andor_matmul,
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
