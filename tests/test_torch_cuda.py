"""The port on a CUDA card: the hand-written kernels and the paths that
launch them, each against the plain PyTorch version on the CPU.

Every test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.frontend.ontology_tools import (
    chain_tailed_ontology,
    snomed_shaped_ontology,
)
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES,
    PackedColsMatmulPlan,
    PackedMatmulPlan,
    list_entries,
    plain_andor_list,
    plain_list_columns,
    plain_packed_andor,
    plain_packed_cols,
)
from distel_tpu_torch.runtime.classifier import ELClassifier
from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

GOLDEN = Path(__file__).parent / "golden"
KERNELS = (("packed_cols_dense", False), ("packed_cols_sparse", True))
#: a CUDA call's launches per route: the sparse route lists A's columns
#: first (one slab when the lists fit the budget)
ROUTE = {False: {"packed_cols_dense": 1},
         True: {"packed_cols_list": 1, "packed_cols_sparse": 1}}

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(gen, m, l, w, density, dead_tiles=False, kind="random"):
    a = (torch.rand((m, l), generator=gen, device="cuda") < density).to(torch.int8)
    if dead_tiles:
        keep = torch.rand((-(-m // 64), -(-l // 32)), generator=gen, device="cuda") < 0.1
        keep = keep.repeat_interleave(64, 0)[:m].repeat_interleave(32, 1)[:, :l]
        a = a * keep.to(torch.int8)
    if kind == "one-per-row":
        a = torch.zeros((m, l), dtype=torch.int8, device="cuda")
        a[torch.arange(m, device="cuda"),
          torch.randint(0, l, (m,), generator=gen, device="cuda")] = 1
    b = torch.randint(-2**31, 2**31, (l, w), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    b[:, 0] |= -2**31                                  # bit 31 of every row
    return a.contiguous(), b.contiguous()


#: (m, l, w, density, dead tiles, kind): unaligned everywhere (L % 16,
#: W % 4), tile-sparse, 1x1, all-zero, fully dense, one nonzero a row,
#: several list chunks on aligned and unaligned rows, and a grid large
#: enough that the sparse kernel does not split its lists
CASES = [
    (37, 70, 5, 0.2, False, "random"),
    (513, 257, 129, 0.01, False, "random"),
    (300, 1000, 200, 0.05, True, "random"),
    (1, 1, 1, 1.0, False, "random"),
    (64, 32, 128, 0.0, False, "random"),
    (130, 96, 300, 1.0, False, "random"),
    (200, 1500, 260, 0.0, False, "one-per-row"),
    (150, 2304, 96, 0.004, False, "random"),
    (70, 2049, 33, 0.01, False, "random"),
    (2560, 300, 7680, 0.01, False, "random"),   # a grid that fills the card unsplit
]


@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "accumulate"])
@pytest.mark.parametrize("name,skip", KERNELS, ids=[k for k, _ in KERNELS])
@pytest.mark.parametrize("m,l,w,density,dead,kind", CASES)
def test_kernel_matches_plain(card, name, skip, m, l, w, density, dead, kind,
                              accumulate):
    """Bit for bit, written fresh or ORed into a seeded C; each call
    adds exactly its route's launches to the counters."""
    gen = torch.Generator(device="cuda").manual_seed(m * 7 + l)
    a, b = _operands(gen, m, l, w, density, dead, kind)
    c0 = None
    if accumulate:
        c0 = torch.randint(-2**31, 2**31, (m, w), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
        c0[::2] = 0
    want = plain_packed_cols(a, b, None if c0 is None else c0.clone())
    before = dict(LAUNCHES)
    out = None if c0 is None else c0.clone()
    got = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=skip)(a, b, out)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        k: ROUTE[skip].get(k, 0) for k in LAUNCHES
    }


@pytest.mark.parametrize("m,l,w,density,dead,kind", CASES)
def test_list_kernel_matches_plain(card, m, l, w, density, dead, kind):
    """``packed_cols_list``: the same counts and the same valid entries
    (columns and 64-bit row masks) as the plain listing."""
    gen = torch.Generator(device="cuda").manual_seed(m + l)
    a, _b = _operands(gen, m, l, w, density, dead, kind)
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=True)
    got = plan.list_columns(a)
    want = plain_list_columns(a)
    torch.cuda.synchronize()
    assert torch.equal(got.counts, want.counts)
    for x, y in zip(list_entries(got), list_entries(want)):
        assert torch.equal(x, y)


def test_sparse_route_runs_in_slabs_within_the_budget(card):
    """Lists past the budget split the rows into slabs of whole row
    blocks, one listing and one sparse launch each."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    a, b = _operands(gen, 300, 2100, 70, 0.01)
    per_block = 12 * -(-2100 // bitmatmul.LIST_CHUNK) * bitmatmul.LIST_CHUNK
    plan = PackedColsMatmulPlan(300, 2100, 70, skip_zero_tiles=True,
                                temp_budget_bytes=per_block)
    slabs = plan.slabs(a.device)
    assert len(slabs) == 5 and all((r0 % 64) == 0 for r0, _ in slabs)
    before = dict(LAUNCHES)
    got = plan(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, plain_packed_cols(a, b))
    assert LAUNCHES["packed_cols_list"] - before["packed_cols_list"] == 5
    assert LAUNCHES["packed_cols_sparse"] - before["packed_cols_sparse"] == 5


def test_bool_operand_and_wrapper_checks(card):
    gen = torch.Generator(device="cuda").manual_seed(1)
    a, b = _operands(gen, 40, 50, 9, 0.1)
    plan = PackedColsMatmulPlan(40, 50, 9, skip_zero_tiles=False)
    assert torch.equal(plan(a.bool(), b), plain_packed_cols(a, b))
    with pytest.raises(ValueError, match="contiguous"):
        PackedColsMatmulPlan(40, 25, 9)(a[:, ::2], b[:25])
    with pytest.raises(ValueError, match="on"):
        plan(a, b.cpu())
    with pytest.raises(ValueError, match="overlap"):
        PackedColsMatmulPlan(40, 50, 9)(a, b, out=b[:40])


@pytest.mark.parametrize(
    "text,config",
    [
        pytest.param(lambda: snomed_shaped_ontology(n_classes=600), {}, id="snomed"),
        pytest.param(lambda: snomed_shaped_ontology(n_classes=600),
                     {"cr6_tiles_density_threshold": 100.0}, id="snomed-tiles"),
        pytest.param(lambda: chain_tailed_ontology(400, 12), {}, id="chain-tailed"),
        pytest.param(lambda: (GOLDEN / "19-bottom-chain.ofn").read_text(), {},
                     id="bottom-chain"),
    ],
)
def test_classify_on_the_card_equals_the_cpu(card, text, config):
    """The whole slice: closure, derivations, iterations and taxonomy
    on the card equal the CPU run's."""
    text = text()
    cfg = ClassifierConfig(**config)
    bitmatmul.reset_launches()
    gpu = ELClassifier(cfg, device="cuda").classify_text(text)
    launched = sum(LAUNCHES.values())
    cpu = ELClassifier(cfg, device="cpu").classify_text(text)
    for g, c in zip(gpu.result.wire(), cpu.result.wire()):
        assert np.array_equal(g, c)
    assert gpu.result.derivations == cpu.result.derivations
    assert gpu.result.iterations == cpu.result.iterations
    assert gpu.taxonomy.parents == cpu.taxonomy.parents
    assert gpu.taxonomy.equivalents == cpu.taxonomy.equivalents
    assert gpu.taxonomy.unsatisfiable == cpu.taxonomy.unsatisfiable
    if gpu.idx.n_links:
        assert launched > 0


@pytest.mark.parametrize("route", ["sparse", "dense"])
def test_device_taxonomy_launches_the_chosen_kernel(card, route, monkeypatch):
    """The taxonomy's product takes the route the plan's auto rule picks
    (no pin), launches that route's kernels only, and gives the host
    taxonomy."""
    res = ELClassifier(device="cuda").classify_text(
        snomed_shaped_ontology(n_classes=600)
    )
    monkeypatch.setattr(bitmatmul, "SKIP_TILES_MIN_WORK",
                        0 if route == "sparse" else 1 << 62)
    bitmatmul.reset_launches()
    dev = extract_taxonomy(res.result, method="device", block=128)
    chosen = ("packed_cols_list", "packed_cols_sparse") if route == "sparse" \
        else ("packed_cols_dense",)
    assert all(LAUNCHES[k] > 0 for k in chosen)
    assert all(LAUNCHES[k] == 0 for k in LAUNCHES if k not in chosen)
    host = extract_taxonomy(res.result, method="host")
    assert dev.parents == host.parents and dev.equivalents == host.equivalents


def test_wide_taxonomy_stays_on_the_card(card, monkeypatch):
    """A result on the card takes the device path however many direct
    parents a class has; the host path is never reached."""
    from distel_tpu_torch.runtime import taxonomy

    text = "\n".join(f"SubClassOf(X P{i})" for i in range(5000))
    res = ELClassifier(device="cuda").classify_text(text)
    want = extract_taxonomy(
        ELClassifier(device="cpu").classify_text(text).result, method="host"
    )

    def no_host(*_args):
        raise AssertionError("a result on the card reached the host path")

    monkeypatch.setattr(taxonomy, "_extract_host", no_host)
    got = extract_taxonomy(res.result)
    assert len(got.parents["X"]) == 5000
    assert got.parents == want.parents and got.equivalents == want.equivalents


# ------------------------------------------- the packed-contraction product
#
# PackedMatmulPlan on a card: packed_andor_list, then packed_cols_sparse
# on B and C read as int32 words.


def _andor_operands(gen, m, kw, k, n, density, *, bit31=False, zero_rows_from=None,
                    offset=0):
    """A [m, kw] int32 words with about ``density`` of their bits set
    (``offset`` words into its allocation, so ``offset`` 1 misaligns it),
    B [k, n] int8 0/1."""
    bits = torch.rand((m, kw, 32), generator=gen, device="cuda") < density
    if bit31:
        bits[:, :, 31] = True
    if zero_rows_from is not None:
        bits[zero_rows_from:] = False
    shifts = torch.arange(32, device="cuda", dtype=torch.int64)
    words = (bits.to(torch.int64) << shifts).sum(dim=2)
    words = torch.where(words >= 2**31, words - 2**32, words)   # uint32 → int32
    a = torch.empty(m * kw + offset, dtype=torch.int32, device="cuda")[offset:]
    a = a.view(m, kw)
    a.copy_(words.to(torch.int32))
    b = (torch.rand((k, n), generator=gen, device="cuda") < 0.05).to(torch.int8)
    return a, b.contiguous()


def _launched(before):
    return {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}


@pytest.mark.parametrize(
    "m,kw,k,n,density,bit31,zero_from",
    [(70, 10, 300, 90, 0.1, False, None),       # unaligned everywhere
     (33, 8, 256, 17, 0.02, True, None),        # bit 31 of every word
     (300, 70, 2200, 4100, 0.001, False, 40),   # mostly zero, > one column tile
     (17, 300, 9600, 64, 0.0, False, None),     # all zero, many list chunks
     (1, 1, 32, 1, 1.0, False, None)],
)
def test_packed_andor_matches_plain(card, m, kw, k, n, density, bit31, zero_from):
    """The route bit for bit against the plain product; a call lists A
    once and runs the product once (one slab)."""
    gen = torch.Generator(device="cuda").manual_seed(m + kw + n)
    a, b = _andor_operands(gen, m, kw, k, n, density, bit31=bit31,
                           zero_rows_from=zero_from)
    want = plain_packed_andor(a, b)
    before = dict(LAUNCHES)
    got = PackedMatmulPlan(m, kw, n)(a, b)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.int8
    assert torch.equal(got, want)
    assert _launched(before) == {"packed_andor_list": 1, "packed_cols_sparse": 1}


@pytest.mark.parametrize(
    "m,kw,k,density,bit31,offset",
    [(70, 9, 288, 0.05, False, 0),              # odd KW, M % 64 != 0
     (130, 16, 512, 0.02, False, 1),            # A not 16-byte aligned
     (130, 16, 512, 0.02, True, 0),             # bit 31 of every word
     (64, 40, 1200, 0.01, False, 0),            # 5 chunks, bits past K dropped
     (65, 17, 530, 0.0, False, 0),              # all zero
     (130, 300, 9600, 0.05, False, 0),          # 38 full chunks: 3 passes of the kernel
     (600, 1998, 63936, 0.0005, False, 0)],     # the 64k run's contraction width
)
def test_andor_list_kernel_matches_plain(card, m, kw, k, density, bit31, offset):
    """``packed_andor_list``: the same counts and the same valid entries
    (contraction indices and 64-bit row masks) as the plain listing, in
    one launch."""
    gen = torch.Generator(device="cuda").manual_seed(m * 3 + kw)
    a, _b = _andor_operands(gen, m, kw, 1, 1, density, bit31=bit31, offset=offset)
    assert (a.data_ptr() % 16 != 0) == bool(offset)
    plan = PackedMatmulPlan(m, kw, 8)
    before = dict(LAUNCHES)
    got = plan.list_rows(a, k)
    torch.cuda.synchronize()
    assert _launched(before) == {"packed_andor_list": 1}
    want = plain_andor_list(a, k)
    assert torch.equal(got.counts, want.counts)
    for x, y in zip(list_entries(got), list_entries(want)):
        assert torch.equal(x, y)


def test_packed_andor_shares_lists_and_runs_in_slabs(card):
    """One listing serves two products (no second listing); past the
    budget, a call lists and multiplies in slabs of whole row blocks;
    lists of another shape are refused."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    a, b = _andor_operands(gen, 300, 70, 2240, 90, 0.002)
    b2 = (torch.rand((2240, 40), generator=gen, device="cuda") < 0.1).to(torch.int8)
    plan, plan2 = PackedMatmulPlan(300, 70, 90), PackedMatmulPlan(300, 70, 40)
    before = dict(LAUNCHES)
    lists = plan.list_rows(a, 2240)
    got, got2 = plan(a, b, lists=lists), plan2(a, b2, lists=lists)
    torch.cuda.synchronize()
    assert torch.equal(got, plain_packed_andor(a, b))
    assert torch.equal(got2, plain_packed_andor(a, b2))
    assert _launched(before) == {"packed_andor_list": 1, "packed_cols_sparse": 2}
    with pytest.raises(ValueError, match="chunks"):
        plan(a, b[:2000], lists=lists)
    per_block = 12 * -(-70 * 32 // bitmatmul.LIST_CHUNK) * bitmatmul.LIST_CHUNK
    small = PackedMatmulPlan(300, 70, 90, temp_budget_bytes=per_block)
    assert len(small.slabs(a.device)) == 5
    before = dict(LAUNCHES)
    assert torch.equal(small(a, b), plain_packed_andor(a, b))
    assert _launched(before) == {"packed_andor_list": 5, "packed_cols_sparse": 5}


def test_packed_andor_fewer_b_rows_and_wrapper_checks(card):
    """A bits past B's last row select nothing; B given with the padded
    n_p columns is used as it is; the wrapper refuses what the kernels
    do not take."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = _andor_operands(gen, 50, 6, 150, 40, 0.2)
    plan = PackedMatmulPlan(50, 6, 40)
    assert torch.equal(plan(a, b), plain_packed_andor(a, b))
    wide = torch.zeros((150, plan.n_p), dtype=torch.int8, device="cuda")
    wide[:, :40] = b
    assert torch.equal(plan(a, wide), plain_packed_andor(a, b))
    with pytest.raises(ValueError, match="contiguous"):
        PackedMatmulPlan(50, 3, 40)(a[:, ::2], b[:96])
    with pytest.raises(ValueError, match="on"):
        plan(a, b.cpu())


def test_packed_engine_step_lists_each_chunk_once(card):
    """One packed-engine step on the card, in several row chunks: one
    listing a chunk serves CR4 and CR6 (two products a chunk), and the
    step's state equals the CPU engine's from the same state."""
    from distel_tpu_torch.core.packed_engine import PackedSaturationEngine

    idx = ELClassifier(device="cpu").classify_text(
        snomed_shaped_ontology(n_classes=600)
    ).idx
    budget = 1 << 17
    cpu = PackedSaturationEngine(idx, device="cpu", temp_budget_bytes=budget)
    gpu = PackedSaturationEngine(idx, device="cuda", temp_budget_bytes=budget)
    chunks = gpu.plan_stats()["chunks"]
    assert chunks > 1 and gpu._has4 and gpu._has6
    sp, rp = cpu.initial_state()
    for _ in range(3):
        sp, rp, _ch = cpu.step(sp, rp)
    want_s, want_r, _ch = cpu.step(sp.clone(), rp.clone())
    before = dict(LAUNCHES)
    got_s, got_r, _ch = gpu.step(sp.cuda(), rp.cuda())
    torch.cuda.synchronize()
    assert _launched(before) == {"packed_andor_list": chunks,
                                 "packed_cols_sparse": 2 * chunks}
    assert torch.equal(got_s.cpu(), want_s) and torch.equal(got_r.cpu(), want_r)


@pytest.mark.parametrize(
    "text",
    [pytest.param(lambda: snomed_shaped_ontology(n_classes=600), id="snomed"),
     pytest.param(lambda: (GOLDEN / "19-bottom-chain.ofn").read_text(),
                  id="bottom-chain")],
)
def test_packed_engine_classify_on_the_card_equals_the_cpu(card, text):
    """``engine="packed"``: closure, derivations, iterations and taxonomy
    on the card equal the CPU run's, with CR4/CR6 through the listing
    and the sparse product."""
    text = text()
    cfg = ClassifierConfig(engine="packed")
    bitmatmul.reset_launches()
    gpu = ELClassifier(cfg, device="cuda").classify_text(text)
    launched = LAUNCHES["packed_andor_list"]
    cpu = ELClassifier(cfg, device="cpu").classify_text(text)
    assert not gpu.result.transposed
    for g, c in zip(gpu.result.wire(), cpu.result.wire()):
        assert np.array_equal(g, c)
    assert gpu.result.derivations == cpu.result.derivations
    assert gpu.result.iterations == cpu.result.iterations
    assert gpu.taxonomy.parents == cpu.taxonomy.parents
    assert gpu.taxonomy.equivalents == cpu.taxonomy.equivalents
    assert gpu.taxonomy.unsatisfiable == cpu.taxonomy.unsatisfiable
    if gpu.idx.n_links:
        assert launched > 0


# ------------------------------------------- frontier gating, dense engine

GATED = {
    "windows-lc64": {"l_chunk": 64},
    "tiles-lc64": {"l_chunk": 64,
                   "cr6_tiles": {"density_threshold": 100.0, "tile_m": 16,
                                 "tile_l": 32}},
    "cr5-gate-lc64": {"l_chunk": 64, "gate_chunks": True},
}


@pytest.mark.parametrize("kw", list(GATED.values()), ids=list(GATED))
def test_gated_rounds_on_the_card_equal_the_cpu(card, kw):
    """The gated fixed point on the card, step by step against the CPU:
    the same S, R and frontier flags every round, and one product
    launched per contracted window or link tile, none for a skipped
    one (these plans all take the dense route)."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    text = snomed_shaped_ontology(n_classes=2000) + "\n" + (
        GOLDEN / "19-bottom-chain.ofn").read_text()
    idx = ELClassifier(device="cpu").classify_text(text).idx
    gpu = RowPackedSaturationEngine(idx, device="cuda", **kw)
    cpu = RowPackedSaturationEngine(idx, device="cpu", **kw)
    assert not any(p.skip_zero_tiles for p in gpu._plans.values())
    if "cr6_tiles" in kw:
        assert gpu._t6 is not None and not gpu._t6["mm"].skip_zero_tiles
    gs, gr = gpu.initial_state()
    cs, cr = cpu.initial_state()
    gf = cf = None
    skipped = 0
    for rnd in range(1, 100):
        before = dict(LAUNCHES)
        gs, gr, gf = gpu.step(gs, gr, gf)
        torch.cuda.synchronize()
        cs, cr, cf = cpu.step(cs, cr, cf)
        assert torch.equal(gs.cpu(), cs) and torch.equal(gr.cpu(), cr), rnd
        for a in ("dirty_l", "f4", "f6", "fd6"):
            assert np.array_equal(getattr(gf, a), getattr(cf, a)), (rnd, a)
        assert (gf.changed, gf.cr5) == (cf.changed, cf.cr5)
        counts = gpu.gate_rounds[-1]
        assert counts == cpu.gate_rounds[-1]
        ran = counts["cr4"][0] + counts["cr6"][0] + counts["cr6_tiles"][0]
        skipped += counts["cr4"][1] + counts["cr6"][1] + counts["cr6_tiles"][1]
        assert _launched(before) == ({"packed_cols_dense": ran} if ran else {})
        if not gf.changed:
            break
    assert not gf.changed and skipped > 0


@pytest.mark.parametrize("m,k,n", [(37, 70, 5), (300, 1000, 200), (64, 20000, 96)])
def test_dense_andor_on_the_card_equals_the_cpu(card, m, k, n):
    """The dense engine's AND-OR product (bfloat16 on the card, float32
    on the CPU), on sparse, dense, all-zero and all-one operands."""
    from distel_tpu_torch.core.engine import SaturationEngine

    idx = ELClassifier(device="cpu").classify_text(chain_tailed_ontology(40, 4)).idx
    gpu = SaturationEngine(idx, device="cuda")
    cpu = SaturationEngine(idx, device="cpu")
    gen = torch.Generator().manual_seed(7)
    for density in (0.0, 0.001, 0.05, 0.5, 1.0):
        a = torch.rand((m, k), generator=gen) < density
        b = torch.rand((k, n), generator=gen) < density
        got = gpu._andor(a.cuda(), b.cuda()).cpu()
        assert torch.equal(got, cpu._andor(a, b)), density


@pytest.mark.parametrize(
    "text",
    [pytest.param(lambda: snomed_shaped_ontology(n_classes=600), id="snomed"),
     pytest.param(lambda: (GOLDEN / "19-bottom-chain.ofn").read_text(),
                  id="bottom-chain")],
)
def test_dense_classify_on_the_card_equals_the_cpu(card, text):
    text = text()
    cfg = ClassifierConfig(engine="dense")
    gpu = ELClassifier(cfg, device="cuda").classify_text(text)
    cpu = ELClassifier(cfg, device="cpu").classify_text(text)
    row = ELClassifier(device="cuda").classify_text(text)
    for g, c, r in zip(gpu.result.wire(), cpu.result.wire(), row.result.wire()):
        assert np.array_equal(g, c) and np.array_equal(g, r)
    assert gpu.result.iterations == cpu.result.iterations
    assert gpu.result.derivations == cpu.result.derivations == row.result.derivations
    assert gpu.taxonomy.parents == cpu.taxonomy.parents


def test_verify_on_the_card(card):
    for path in sorted(GOLDEN.glob("*.ofn")):
        ELClassifier(device="cuda").classify_file(str(path), verify=True)


@pytest.mark.parametrize("routed", [{"CR5": "host"}, {"CR1": "host", "CR6": "host"},
                                    {"CR4": "host"}],
                         ids=["CR5", "CR1+CR6", "CR4"])
def test_hybrid_on_the_card_equals_the_cpu(card, routed):
    """Rules routed to the host beside the card's row-packed engine:
    the same closure, counts and taxonomy as the same routing on the CPU
    and as the all-device card run."""
    text = snomed_shaped_ontology(n_classes=600, seed=3)
    cfg = ClassifierConfig(rule_backends=routed)
    gpu = ELClassifier(cfg, device="cuda").classify_text(text)
    cpu = ELClassifier(cfg, device="cpu").classify_text(text)
    row = ELClassifier(device="cuda").classify_text(text)
    n, nl = gpu.idx.n_concepts, gpu.idx.n_links
    assert np.array_equal(gpu.result.s[:n, :n], cpu.result.s[:n, :n])
    assert np.array_equal(gpu.result.s[:n, :n], row.result.s[:n, :n])
    assert np.array_equal(gpu.result.r[:n, :nl], row.result.r[:n, :nl])
    assert (gpu.result.iterations, gpu.result.derivations) == (
        cpu.result.iterations, cpu.result.derivations)
    assert gpu.result.derivations == row.result.derivations
    assert gpu.taxonomy.parents == row.taxonomy.parents


@pytest.mark.parametrize("name", ["galen_module_jia", "lubm_univ_bench"])
def test_rdfxml_corpus_on_the_card_equals_the_cpu(card, name):
    text = (Path(__file__).parent / "corpora" / f"{name}.owl").read_text(
        encoding="utf-8-sig")
    gpu = ELClassifier(device="cuda").classify_text(text)
    cpu = ELClassifier(device="cpu").classify_text(text)
    for g, c in zip(gpu.result.wire(), cpu.result.wire()):
        assert np.array_equal(g, c)
    assert (gpu.result.iterations, gpu.result.derivations) == (
        cpu.result.iterations, cpu.result.derivations)
    assert gpu.taxonomy.parents == cpu.taxonomy.parents


def test_incremental_state_stays_on_the_card(card, monkeypatch):
    """An engine built for ``"cuda"`` embeds a state on the card (its
    tensors report ``cuda:0``) on the card: no host copy; and the
    incremental fast path over it gives the CPU's closure."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    base = snomed_shaped_ontology(n_classes=600)
    delta = "SubClassOf(NewX Find3)\nSubClassOf(NewY ObjectSomeValuesFrom(attr0 Find5))\n"
    runs = {}
    for dev in (card, "cpu"):
        inc = IncrementalClassifier(device=dev)
        inc._FAST_PATH_MIN_CONCEPTS = 0
        inc.add_text(base)
        runs[str(dev)] = (inc.add_text(delta).wire(), inc.history[-1])
    assert runs["cuda"][1] == runs["cpu"][1] and runs["cuda"][1]["path"] == "fast"
    assert all(np.array_equal(x, y) for x, y in zip(runs["cuda"][0], runs["cpu"][0]))
    eng = RowPackedSaturationEngine(inc.last_result.idx, device="cuda")
    res = eng.saturate()

    def no_host(*_a, **_k):
        raise AssertionError("the embed copied the state to the host")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "cpu", no_host)
        m.setattr(torch.Tensor, "numpy", no_host)
        sp, rp = eng.embed_state(res.packed_s, res.packed_r)
    assert torch.equal(sp, res.packed_s) and torch.equal(rp, res.packed_r)


# ------------------------------------------------------------ serve plane


def test_evicting_a_tenant_frees_its_state_on_the_card(card, tmp_path):
    """A tenant demoted to the warm tier, or spilled cold, gives the card
    back at least its state's bytes (engines and tables go with it)."""
    from distel_tpu_torch.serve.query import SnapshotStore
    from distel_tpu_torch.serve.registry import OntologyRegistry, _state_bytes

    for warm in (1 << 30, 0):
        reg = OntologyRegistry(device=card, memory_budget_bytes=1 << 40,
                               spill_dir=str(tmp_path / str(warm)),
                               warm_budget_bytes=warm, query=SnapshotStore())
        oid = reg.new_id()
        reg.load(oid, snomed_shaped_ontology(n_classes=3000, seed=5))
        state = _state_bytes(reg.classifier(oid))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        reg.memory_budget_bytes = 1
        reg._maybe_evict()
        torch.cuda.synchronize()
        freed = held - torch.cuda.memory_allocated()
        tiers = reg.tier_stats()
        assert tiers["resident_ontologies"] == 0
        assert tiers["warm_ontologies" if warm else "cold_ontologies"] == 1
        assert state > 0 and freed >= state, (warm, freed, state)
        # and the next read brings it back with the same closure
        assert reg.classifier(oid).last_result.packed_s.is_cuda


def test_two_workers_two_tenants_equal_serial_requests(card):
    """Two scheduler workers serving two tenants' deltas at once on the
    card give the closures that the same requests one at a time do."""
    import threading

    from distel_tpu_torch.serve.server import ServeApp

    texts = {"a": snomed_shaped_ontology(n_classes=2500, seed=21),
             "b": snomed_shaped_ontology(n_classes=2200, seed=22)}
    deltas = {k: [f"SubClassOf(Card{k}{i} Find{i + 3})\n"
                  f"SubClassOf(CardR{k}{i} ObjectSomeValuesFrom(attr1 Find{i}))\n"
                  for i in range(3)] for k in texts}

    def run(concurrent):
        app = ServeApp(device=card, workers=2, max_batch=1)
        try:
            ids = {k: json_of(app, "POST", "/v1/ontologies", t)["id"]
                   for k, t in texts.items()}
            jobs = [(k, d) for k in texts for d in deltas[k]]

            def send(k, d):
                json_of(app, "POST", f"/v1/ontologies/{ids[k]}/deltas", d)

            if concurrent:
                threads = [threading.Thread(target=send, args=j) for j in jobs]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                    assert not t.is_alive()
            else:
                for j in jobs:
                    send(*j)
            return {k: app.registry.classifier(oid).last_result.wire()
                    for k, oid in ids.items()}, \
                {k: json_of(app, "GET", f"/v1/ontologies/{oid}/taxonomy")
                 for k, oid in ids.items()}
        finally:
            app.close(final_spill=False)

    (s_wire, s_tax), (c_wire, c_tax) = run(False), run(True)
    for k in texts:
        assert all(np.array_equal(x, y) for x, y in zip(s_wire[k], c_wire[k]))
        assert s_tax[k] == c_tax[k]


def json_of(app, method, path, text=None):
    import json

    body = json.dumps({"text": text}).encode() if text is not None else b""
    status, _, payload = app.dispatch(method, path, {}, body, None)
    assert status in (200, 201), payload
    return json.loads(payload)


def test_serve_app_runs_on_the_card_by_default(card):
    from distel_tpu_torch.serve.server import ServeApp

    app = ServeApp()
    try:
        assert app.registry.device.type == "cuda"
        oid = json_of(app, "POST", "/v1/ontologies", "SubClassOf(A B)\n")["id"]
        inc = app.registry.classifier(oid)
        assert inc.device.type == "cuda"
        assert inc.last_result.packed_s.is_cuda
        status, _, body = app.dispatch(
            "GET", f"/v1/ontologies/{oid}/query/subsumers", {"class": "A"},
            b"", None)
        assert status == 200 and b'"B"' in body
    finally:
        app.close(final_spill=False)
