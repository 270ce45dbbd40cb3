"""The port on a CUDA card: the hand-written kernels and the paths that
launch them, each against the plain PyTorch version on the CPU.

Every test here is marked ``cuda`` and skips without a card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import json
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

#: a bucketed engine's program record (its signature names the device;
#: the build walls are the device's)
COMPILE_KEYS = {"bucket_signature", "program", "trace_lower_s", "compile_s",
                "program_cache_hit", "persistent_cache_hits",
                "persistent_cache_misses", "delta_signature"}


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


# ------------------------------------------------- observed fixed point

#: the forced sparse tier with rungs up to 131,072 rows (the chip
#: smoke's 8k configuration)
FORCED_WIDE = {"density_threshold": 1.1, "hysteresis_rounds": 1,
               "capacity_buckets": 12}


def _observed_records(engine, sparse_tail):
    """The observer's sequence, each round's record, the result, and
    the kernel launches of the sparse rounds alone (a sparse round runs
    with no dense round in flight, so the launches between its record
    and the one before are its own)."""
    obs, sparse_launches = [], [0]
    last = [dict(LAUNCHES)]

    def frontier(st):
        now = dict(LAUNCHES)
        if st.tier == "sparse":
            sparse_launches[0] += sum(now[k] - last[0][k] for k in now)
        last[0] = now

    res = engine.saturate_observed(
        observer=lambda *a: obs.append(a), sparse_tail=sparse_tail,
        frontier_observer=frontier,
    )
    recs = [(s.iteration, s.tier, s.rows_touched, s.derivations,
             s.overflow, s.inflight) for s in engine.frontier_rounds]
    return obs, recs, res, sparse_launches[0]


@pytest.mark.parametrize("sparse_tail", [FORCED_WIDE, True],
                         ids=["forced", "default"])
def test_observed_8k_on_the_card_equals_the_cpu(card, sparse_tail):
    """The adaptive controller at 8k, ``unroll=1``: every round's
    record (tier, rows touched, derivations, overflow, occupancy), the
    observer's sequence, S and R equal on the card and on the CPU; the
    forced run's sparse rounds launch the packed-columns kernels."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    idx = ELClassifier(device="cpu").classify_text(
        snomed_shaped_ontology(n_classes=8000)
    ).idx
    gpu = RowPackedSaturationEngine(idx, device="cuda", unroll=1)
    got = _observed_records(gpu, sparse_tail)
    torch.cuda.synchronize()
    want = _observed_records(
        RowPackedSaturationEngine(idx, device="cpu", unroll=1), sparse_tail
    )
    assert got[0] == want[0] and got[1] == want[1]
    assert torch.equal(got[2].packed_s.cpu(), want[2].packed_s)
    assert torch.equal(got[2].packed_r.cpu(), want[2].packed_r)
    if sparse_tail is FORCED_WIDE:
        assert "sparse" in [r[1] for r in got[1]]
        assert got[3] > 0 and want[3] == 0


def test_exported_tenant_returns_its_card_memory(card, tmp_path):
    """A tenant exported off the card (the migration hook) releases its
    cached blocks, not only its tensors: the
    process's reserved bytes fall back to within 64 MiB of their level
    before the load."""
    from distel_tpu_torch.serve.registry import OntologyRegistry

    # exact shapes: a bucketed tenant's program (graph pool, tables,
    # state pair) outlives it in the registry by design
    reg = OntologyRegistry(ClassifierConfig(shape_buckets=False), device=card,
                           spill_dir=str(tmp_path))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    oid = reg.new_id()
    reg.load(oid, snomed_shaped_ontology(n_classes=8000))
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_reserved()
    assert loaded > base + (64 << 20)
    reg.export(oid)
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() <= base + (64 << 20), (
        base, loaded, torch.cuda.memory_reserved())


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
    # the exact-shape row-packed layout, word for word the dense one's
    row = ELClassifier(ClassifierConfig(shape_buckets=False),
                       device="cuda").classify_text(text)
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
    # the program records name their device (its signature and build)
    runs = {d: (w, {k: v for k, v in h.items() if k not in COMPILE_KEYS})
            for d, (w, h) in runs.items()}
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


# ------------------------------------------------------------ serve fleet


def _fleet_answers(device, spill):
    """An in-process two-replica fleet (``ReplicaApp``s on loopback HTTP
    servers behind a ``RouterApp``) on ``device``: the 8k corpus without
    its range axiom, a class-only delta, a live migration, a retraction,
    then the holder's crash recovered by journal replay (the retract
    marker in it).  Every answer, without clock readings; and the
    launches of the card's kernels over the traffic."""
    import threading
    import time

    from distel_tpu_torch.serve.client import ServeClient
    from distel_tpu_torch.serve.fleet.replica import ReplicaApp
    from distel_tpu_torch.serve.fleet.router import RouterApp
    from distel_tpu_torch.serve.server import make_server

    text = "".join(ln + "\n" for ln in snomed_shaped_ontology(
        n_classes=8000, seed=42).splitlines()
        if not ln.startswith("ObjectPropertyRange("))
    delta = "\n".join(f"SubClassOf(FleetD{i} Find{i * 7})" for i in range(40))
    apps, servers, replicas = [], [], []
    for i in range(2):
        app = ReplicaApp(replica_id=f"r{i}", spill_dir=str(spill), device=device)
        srv = make_server(app)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        apps.append(app)
        servers.append(srv)
        replicas.append((f"r{i}", f"http://127.0.0.1:{srv.server_address[1]}"))
    router = RouterApp(replicas, eject_failures=1)
    rsrv = make_server(router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    client = ServeClient(f"http://127.0.0.1:{rsrv.server_address[1]}", timeout=600)
    out = []

    def reads(oid, cls):
        out.extend([client.taxonomy(oid), client.subsumers(oid, cls),
                    client.query_subsumers(oid, cls)])

    bitmatmul.reset_launches()
    try:
        oid = client.load(text)["id"]
        out.append(client.delta(oid, delta))
        reads(oid, "FleetD3")
        rec = router.migrate(oid)
        assert rec["from"] != rec["to"]
        reads(oid, "FleetD3")
        out.append(client.retract(oid, delta))
        reads(oid, "Find21")
        holder = router.table.lookup(oid).rid
        servers[int(holder[1:])].shutdown()
        servers[int(holder[1:])].server_close()
        router.heartbeat_once()
        deadline = time.monotonic() + 600
        while router.metrics.counter_value("distel_fleet_recoveries_total") < 1:
            assert time.monotonic() < deadline, "recovery never ran"
            time.sleep(0.1)
        survivor = router.table.lookup(oid).rid
        assert survivor != holder
        # a journal replay restarts the snapshot versions (one increment
        # an op): this client's watermark is past them, a new one reads
        client = ServeClient(client.base_url, timeout=600)
        reads(oid, "Find21")
        inc = apps[int(survivor[1:])].registry.classifier(oid)
        assert inc.last_result.packed_s.device.type == torch.device(device).type
        for app in apps:
            assert app.registry.device.type == torch.device(device).type
        launches = dict(LAUNCHES)
    finally:
        router.close()
        for s in servers + [rsrv]:
            s.shutdown()
            s.server_close()
        for app in apps:
            app.close(final_spill=False)
    # clock readings, and the program records, which name their device
    drop = {"published_unix", "wall_s", *COMPILE_KEYS}
    return [{k: v for k, v in d.items() if k not in drop} for d in out], launches


def test_fleet_migrates_and_recovers_on_the_card(card, tmp_path):
    """The fleet on the card at 8k answers as the CPU fleet does, across
    a live migration and a journal-replay recovery with a retraction;
    its replicas launched the card's kernels."""
    got, launches = _fleet_answers("cuda", tmp_path / "card")
    want, _ = _fleet_answers("cpu", tmp_path / "cpu")
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    assert launches["packed_cols_dense"] + launches["packed_cols_sparse"] > 0


# ------------------------------------------ the batched dense-route kernel

#: (copies, m, l, w, density): a GALEN copy's CR4 shape, unaligned
#: everywhere, several row blocks and word tiles a copy, all-zero, dense
BATCHED_CASES = [
    (600, 61, 64, 8, 0.05),
    (7, 37, 70, 5, 0.2),
    (3, 130, 96, 19, 0.3),
    (5, 64, 32, 8, 0.0),
    (2, 70, 33, 9, 1.0),
]


@pytest.mark.parametrize("accumulate", [False, True], ids=["write", "accumulate"])
@pytest.mark.parametrize("nb,m,l,w,density", BATCHED_CASES)
def test_batched_dense_matches_plain_and_unbatched(card, nb, m, l, w, density,
                                                   accumulate):
    """``packed_cols_dense_batched``: bit for bit against its plain
    version and against ``nb`` launches of ``packed_cols_dense``, with
    B a strided window of a batched state; one launch counted."""
    gen = torch.Generator(device="cuda").manual_seed(nb * 31 + m)
    a = (torch.rand((nb, m, l), generator=gen, device="cuda") < density).to(torch.int8)
    state = torch.randint(-2**31, 2**31, (nb, l + 11, w), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    b = state[:, 5 : 5 + l]
    c0 = None
    if accumulate:
        c0 = torch.randint(-2**31, 2**31, (nb, m, w), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
        c0[:, ::2] = 0
    want = bitmatmul.plain_packed_cols_batched(
        a, b, None if c0 is None else c0.clone())
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=False)
    loop = torch.stack([
        plan(a[k], b[k].contiguous(), None if c0 is None else c0[k].clone())
        for k in range(nb)
    ])
    before = dict(LAUNCHES)
    got = bitmatmul.packed_cols_dense_batched(
        a, b, None if c0 is None else c0.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, loop)
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]} \
        == {"packed_cols_dense_batched": 1}


def test_isomorphic_group_on_the_card_equals_cpu(card):
    """A group of copies on the card: every copy's closure and the
    counters equal the CPU run's, and the group's CR4/CR6 went through
    the batched kernel."""
    from distel_tpu_torch.core.components import partition_index, saturate_components
    from distel_tpu_torch.core.indexing import index_ontology
    from distel_tpu_torch.frontend.normalizer import normalize
    from distel_tpu_torch.frontend.ontology_tools import multiply_ontology
    from distel_tpu_torch.owl import parser

    onto = multiply_ontology(parser.parse(snomed_shaped_ontology(n_classes=400)), 6)
    comps = partition_index(index_ontology(normalize(onto)))
    before = LAUNCHES["packed_cols_dense_batched"]
    got = saturate_components(comps, device="cuda", keep_state=True)
    assert LAUNCHES["packed_cols_dense_batched"] > before
    want = saturate_components(comps, device="cpu", keep_state=True)
    for k in ("n_components", "n_groups", "derivations", "iterations_max"):
        assert got[k] == want[k], k
    assert any(g["batch"] > 1 for g in got["groups"])
    for g, h in zip(got["groups"], want["groups"]):
        assert g["iterations"] == h["iterations"]
        assert torch.equal(g["packed_s"].cpu(), h["packed_s"])
        assert torch.equal(g["packed_r"].cpu(), h["packed_r"])


# ------------------------------------------------------ the fused window

#: (m, l, w, density): a CR4 window chunk of the 64k run's shape, a
#: sparse-route shape, one row block, unaligned everywhere
ROW_COUNT_CASES = [(223, 1056, 2768, 0.01), (332, 1056, 64, 0.02),
                   (64, 64, 8, 0.3), (130, 96, 40, 0.05)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_n", "list_n"])
@pytest.mark.parametrize("m,l,w,density", ROW_COUNT_CASES)
def test_row_count_variants_match_plain(card, m, l, w, density, sparse):
    """``packed_cols_dense_n`` and ``packed_cols_list_n`` (+ the sparse
    kernel) with the row count on the card: only the rows below it
    change, ORed into a seeded C, equal to the plain version — a dead
    window (0 rows) and a count past the rows included."""
    gen = torch.Generator(device="cuda").manual_seed(m + w)
    a, b = _operands(gen, m, l, w, density)
    c0 = torch.randint(-2**31, 2**31, (m, w), generator=gen, device="cuda",
                       dtype=torch.int64).to(torch.int32)
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=sparse)
    name = "packed_cols_list_n" if sparse else "packed_cols_dense_n"
    for n in (0, 1, m // 2, m, m + 7):
        nr = torch.full((1,), n, dtype=torch.int32, device="cuda")
        before = LAUNCHES[name]
        got = plan(a, b, out=c0.clone(), n_rows=nr)
        assert LAUNCHES[name] == before + 1
        want = bitmatmul.plain_packed_cols_rows(a.cpu(), b.cpu(), c0.cpu(),
                                                nr.cpu())
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got[n:].cpu(), c0[n:].cpu())


def test_graph_if_node_runs_its_body_only_when_true(card):
    """Two IF nodes of one captured graph, replayed under every pair of
    predicates: each body runs exactly when its predicate holds, in
    order, as Python ``if`` statements would run them."""
    from distel_tpu_torch.ops import graph_if

    x = torch.zeros(2, dtype=torch.int64, device="cuda")
    p = torch.zeros(2, dtype=torch.bool, device="cuda")
    graph, pool, child = torch.cuda.CUDAGraph(), torch.cuda.MemPool(), \
        torch.cuda.Stream()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        graph_if.capture_if(p[0], lambda: x[0:1].add_(1), child, pool)
        graph_if.capture_if(p[1], lambda: x[1:2].add_(x[0:1] * 10 + 1),
                            child, pool)
    want = [0, 0]
    for p0, p1 in ((False, False), (True, False), (False, True), (True, True)):
        p.copy_(torch.tensor([p0, p1]))
        graph.replay()
        if p0:
            want[0] += 1
        if p1:
            want[1] += want[0] * 10 + 1
        assert x.tolist() == want


def _fused_records(engine, idx, sparse, k, depth=1):
    from distel_tpu_torch.runtime.instrumentation import DISPATCH_EVENTS

    before = DISPATCH_EVENTS.snapshot()["fused_windows"]
    obs = []
    res = engine.saturate_observed(
        observer=lambda *a: obs.append(a), sparse_tail=sparse,
        fused_rounds={"rounds": k}, pipeline={"enable": depth > 1, "depth": depth},
    )
    recs = [(s.iteration, s.tier, s.rows_touched, s.derivations, s.overflow,
             s.inflight, s.rounds_in_window) for s in engine.frontier_rounds]
    windows = DISPATCH_EVENTS.snapshot()["fused_windows"] - before
    return obs, recs, res, windows, dict(engine.fused_run_stats)


OVERFLOW_8 = {"density_threshold": 1.1, "hysteresis_rounds": 1,
              "capacity_buckets": 1, "capacity_floor": 8}


@pytest.mark.parametrize("corpus,sparse,depth", [
    ("chain-400", FORCED_WIDE, 1), ("chain-400", FORCED_WIDE, 2),
    ("chain-400", True, 2), ("snomed-8k", FORCED_WIDE, 1),
    ("snomed-8k", OVERFLOW_8, 2),
], ids=["chain-forced", "chain-forced-depth2", "chain-default-depth2",
        "8k-forced", "8k-overflow-depth2"])
def test_fused_window_on_the_card_equals_the_cpu(card, corpus, sparse, depth):
    """The fused window (K = 4) as CUDA graphs on the card and eagerly
    on the CPU: every record (window sizes, occupancy and fallouts
    included), the observer's sequence, S and R equal; the card's
    windows launch the row-count kernels and the IF setter."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.ops import graph_if

    text = (chain_tailed_ontology(400, 12)
            + "\nDisjointClasses(TailChain3 TailChain7)"
            if corpus == "chain-400" else snomed_shaped_ontology(n_classes=8000))
    idx = ELClassifier(device="cpu").classify_text(text).idx
    before = dict(LAUNCHES)
    setters = graph_if.LAUNCHES["graph_if_set"]
    got = _fused_records(RowPackedSaturationEngine(idx, device="cuda", unroll=1),
                         idx, sparse, 4, depth)
    torch.cuda.synchronize()
    assert graph_if.LAUNCHES["graph_if_set"] > setters
    assert sum(LAUNCHES[k] - before[k]
               for k in ("packed_cols_dense_n", "packed_cols_list_n")) > 0
    want = _fused_records(RowPackedSaturationEngine(idx, device="cpu", unroll=1),
                          idx, sparse, 4, depth)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[3] == want[3] > 0 and got[4] == want[4]
    assert torch.equal(got[2].packed_s.cpu(), want[2].packed_s)
    assert torch.equal(got[2].packed_r.cpu(), want[2].packed_r)
    if sparse is OVERFLOW_8:
        assert got[4]["fallouts"] > 0



# ------------------------------------------------------------ shape buckets


def _pair_texts(n=240):
    """Two ontologies of one bucket with different wiring (the
    reference's ``tests/test_bucketing.py`` pair)."""
    def onto(shift):
        lines = [f"SubClassOf(C{i} C{(i + shift) % n})" for i in range(n)]
        for i in range(0, n, 4):
            lines.append(f"SubClassOf(C{i} ObjectSomeValuesFrom(r D{i % 16}))")
            lines.append(f"SubClassOf(ObjectSomeValuesFrom(r D{(i + shift) % 16})"
                         f" E{i % 8})")
        return "\n".join(lines)

    return onto(1), onto(3)


def test_same_bucket_engine_replays_the_captured_step(card):
    """The second engine of a bucket replays the first one's captured
    step group (capture 0.0 s, a registry hit) and computes its own
    closure, equal to the CPU's; the graph's launches are counted."""
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    PROGRAMS.clear()
    idxs = [ELClassifier(device="cpu").classify_text(t).idx for t in _pair_texts()]
    engines = [RowPackedSaturationEngine(i, device="cuda", bucket=True) for i in idxs]
    assert engines[0].bucket_signature == engines[1].bucket_signature
    before = sum(LAUNCHES.values())
    got = [e.saturate() for e in engines]
    torch.cuda.synchronize()
    assert sum(LAUNCHES.values()) > before
    first, second = (e.compile_stats for e in engines)
    assert not first.program_cache_hit and first.compile_s > 0.0
    assert second.program_cache_hit and second.compile_s == 0.0
    for idx, res in zip(idxs, got):
        want = RowPackedSaturationEngine(idx, device="cpu", bucket=True).saturate()
        assert res.iterations == want.iterations
        assert res.derivations == want.derivations
        assert torch.equal(res.packed_s.cpu(), want.packed_s)
        assert torch.equal(res.packed_r.cpu(), want.packed_r)


def test_same_corpus_engine_replays_the_fused_windows(card):
    """A second bucketed engine of the same corpus replays the first
    one's captured fused windows (capture 0.0 s), round for round."""
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    PROGRAMS.clear()
    text = chain_tailed_ontology(400, 12) + "\nDisjointClasses(TailChain3 TailChain7)"
    idx = ELClassifier(device="cpu").classify_text(text).idx
    runs = []
    for _ in range(2):
        eng = RowPackedSaturationEngine(idx, device="cuda", unroll=1, bucket=True)
        runs.append((_fused_records(eng, idx, FORCED_WIDE, 4), eng.compile_stats))
    (a, sa), (b, sb) = runs
    assert not sa.program_cache_hit and sa.compile_s > 0.0
    assert sb.program_cache_hit and sb.compile_s == 0.0
    assert a[0] == b[0] and a[1] == b[1]
    assert torch.equal(a[2].packed_s, b[2].packed_s)
    want = _fused_records(RowPackedSaturationEngine(idx, device="cpu", unroll=1),
                          idx, FORCED_WIDE, 4)
    assert a[1] == want[1]


def test_evicted_program_frees_its_card_blocks(card):
    """A program the registry evicts gives its card memory back (its
    graph pool, tables and its layout's state pair) with no garbage
    collection: engines hold programs weakly."""
    import gc

    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    PROGRAMS.clear()
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    idx = ELClassifier(device="cpu").classify_text(
        snomed_shaped_ontology(n_classes=2000)).idx
    eng = RowPackedSaturationEngine(idx, device="cuda", bucket=True)
    res = eng.saturate()
    held = bucketing.program_bytes("cuda")
    assert held > 0
    del res
    torch.cuda.synchronize()
    with_program = torch.cuda.memory_allocated()
    gc_was = gc.isenabled()
    gc.disable()
    try:
        PROGRAMS.clear()
        torch.cuda.synchronize()
        freed = with_program - torch.cuda.memory_allocated()
    finally:
        if gc_was:
            gc.enable()
    assert bucketing.program_bytes("cuda") == 0
    # at least the layout's state pair comes back
    assert freed >= (eng.nc + eng.nl) * eng.wc * 4, (freed, held)
    assert torch.cuda.memory_allocated() - base < with_program - base


#: a fresh process that installs a farm with no toolkit in reach, then
#: runs each packed-columns route (plain and row-count forms) against
#: the plain version
_FARM_CONSUMER = r"""
import json, sys
import torch
from distel_tpu_torch.core import artifacts
from distel_tpu_torch.ops.bitmatmul import (
    LAUNCHES, PackedColsMatmulPlan, plain_packed_cols)

rec = artifacts.install(sys.argv[1], require=True, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(5)
bad = 0
for skip in (False, True):
    for rows in (None, 0, 150, 300):
        a = (torch.rand((300, 1000), generator=gen, device="cuda") < 0.05
             ).to(torch.int8)
        b = torch.randint(-2**31, 2**31, (1000, 40), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
        out = torch.zeros((300, 40), dtype=torch.int32, device="cuda")
        n = None if rows is None else torch.tensor([rows], dtype=torch.int32,
                                                   device="cuda")
        PackedColsMatmulPlan(300, 1000, 40, skip_zero_tiles=skip)(
            a, b, out=out, n_rows=n)
        want = torch.zeros_like(out)
        k = 300 if rows is None else rows
        want[:k] = plain_packed_cols(a[:k], b)
        bad += int((out != want).sum())
torch.cuda.synchronize()
print(json.dumps({"libraries": rec["libraries"], "nvcc_runs": rec["nvcc_runs"],
                  "hits": rec["persistent_cache_hits"], "bad": bad,
                  "launches": {k: v for k, v in LAUNCHES.items() if v}}))
"""


def test_farm_library_loads_without_nvcc(card, tmp_path):
    """A farm's kernel libraries, installed by a fresh process into an
    empty build directory with ``nvcc`` out of reach, load with no build
    and compute what the plain version does, every route and row
    count."""
    import os
    import shutil
    import subprocess
    import sys

    from distel_tpu_torch.core import artifacts
    from distel_tpu_torch.ops import build

    build.build_all(build.sources())
    store = artifacts.ArtifactStore(str(tmp_path / "farm"), writable=True,
                                    device="cuda")
    assert store.adopt_libraries() == len(build.sources())
    assert store.flush()
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    env = dict(os.environ, PATH=path, CUDA_HOME=str(tmp_path / "no-cuda"),
               DISTEL_TORCH_BUILD_DIR=str(tmp_path / "empty"),
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    assert shutil.which("nvcc", path=path) is None
    r = subprocess.run([sys.executable, "-c", _FARM_CONSUMER,
                        str(tmp_path / "farm")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout.splitlines()[-1])
    assert doc["libraries"] == build.sources()
    assert doc["nvcc_runs"] == 0 and doc["hits"] == len(build.sources())
    assert doc["bad"] == 0
    for k in ("packed_cols_dense", "packed_cols_dense_n", "packed_cols_list",
              "packed_cols_list_n", "packed_cols_sparse"):
        assert doc["launches"].get(k, 0) > 0, (k, doc["launches"])


def _program_run(prog, engine) -> tuple:
    """``prog`` over ``engine``'s tables from the fresh initial state:
    every group's flags, then S and R."""
    pair = prog.pair
    with pair.lock:
        prog.load(engine._btables)
        engine._fill_initial(pair.sp, pair.rp)
        prog.ms.fill_(True)
        prog.dl.copy_(prog.T["dl_valid"])
        flags = []
        while True:
            f = prog.run()
            flags.append(f.tolist())
            if not f[0]:
                break
        return flags, pair.sp.clone(), pair.rp.clone()


def test_spec_program_captures_and_replays_as_the_engine_built(card):
    """A step program rebuilt from its spec captures on the card, and
    its replays give the engine-built program's flags and state, group
    for group."""
    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    PROGRAMS.clear()
    idx = ELClassifier(device="cpu").classify_text(
        snomed_shaped_ontology(n_classes=2000)).idx
    engine = RowPackedSaturationEngine(idx, device="cuda", bucket=True)
    prog = engine._bucket_program()
    assert prog.graph is not None
    spec = json.loads(json.dumps(bucketing.program_spec(prog)))
    back = bucketing.BucketProgram.from_spec(spec, "cuda")
    assert bucketing.shape_signature(back.struct, back.shapes) == \
        engine.bucket_signature
    back.capture()
    assert back.graph is not None and back.launches == prog.launches
    want, got = _program_run(prog, engine), _program_run(back, engine)
    assert got[0] == want[0] and len(want[0]) > 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ------------------------------------------------------ the cohort plane

#: (m, l, w, density) of the batched row-count forms: a CR4 window
#: chunk of the 64k step's shape, a sparse-route shape, one row block,
#: unaligned everywhere
BATCHED_CASES = [(239, 1152, 3084, 0.01), (332, 1056, 64, 0.02),
                 (64, 64, 8, 0.3), (130, 96, 40, 0.05)]


def _batched_operands(gen, nb, m, l, w, density):
    ops = [_operands(gen, m, l, w, density) for _ in range(nb)]
    return (torch.stack([a for a, _ in ops]).contiguous(),
            torch.stack([b for _, b in ops]).contiguous())


@pytest.mark.parametrize("sparse", [False, True],
                         ids=["dense_n_batched", "list_n_batched"])
@pytest.mark.parametrize("rung", [2, 4, 8])
@pytest.mark.parametrize("m,l,w,density", BATCHED_CASES)
def test_batched_row_count_variants_match_plain(card, m, l, w, density,
                                                 rung, sparse):
    """``packed_cols_dense_n_batched`` and ``packed_cols_list_n_batched`` +
    ``packed_cols_sparse_batched``: one launch each for every copy, each
    copy with its own row count on the card (0, 1, half, all, past the
    rows), ORed into a seeded C: 0 differing words against the plain
    version and against the per-copy row-count kernels."""
    gen = torch.Generator(device="cuda").manual_seed(rung * 1000 + m)
    a, b = _batched_operands(gen, rung, m, l, w, density)
    c0 = torch.randint(-2**31, 2**31, (rung, m, w), generator=gen,
                       device="cuda", dtype=torch.int64).to(torch.int32)
    counts = [(0, 1, m // 2, m, m + 7)[i % 5] for i in range(rung)]
    n_rows = torch.tensor(counts, dtype=torch.int32, device="cuda")
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=sparse)
    names = (("packed_cols_list_n_batched", "packed_cols_sparse_batched")
             if sparse else ("packed_cols_dense_n_batched",))
    before = dict(LAUNCHES)
    got = plan.batched_rows(a, b, c0.clone(), n_rows)
    torch.cuda.synchronize()
    slabs = len(plan._batched_slabs(a.device, rung)) if sparse else 1
    for k in LAUNCHES:
        assert LAUNCHES[k] - before[k] == (slabs if k in names else 0), k
    want = bitmatmul.plain_packed_cols_rows_batched(
        a.cpu(), b.cpu(), c0.cpu(), n_rows.cpu())
    assert torch.equal(got.cpu(), want)
    for k in range(rung):
        one = plan(a[k], b[k], out=c0[k].clone(), n_rows=n_rows[k : k + 1])
        assert torch.equal(got[k], one)


def test_batched_sparse_route_runs_in_slabs(card):
    """A temp budget that holds one row block's lists for every copy
    splits the batched sparse route into slabs, each one listing and one
    product launch for all copies; the words are the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    nb, m, l, w = 4, 300, 600, 40
    a, b = _batched_operands(gen, nb, m, l, w, 0.02)
    c0 = torch.zeros((nb, m, w), dtype=torch.int32, device="cuda")
    n_rows = torch.tensor([300, 0, 150, 299], dtype=torch.int32, device="cuda")
    budget = 12 * 3 * 256 * nb            # one row block of lists a slab
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=True,
                                temp_budget_bytes=budget)
    slabs = plan._batched_slabs(a.device, nb)
    assert len(slabs) == -(-m // 64)
    before = dict(LAUNCHES)
    got = plan.batched_rows(a, b, c0.clone(), n_rows)
    torch.cuda.synchronize()
    assert LAUNCHES["packed_cols_list_n_batched"] - \
        before["packed_cols_list_n_batched"] == len(slabs)
    assert LAUNCHES["packed_cols_sparse_batched"] - \
        before["packed_cols_sparse_batched"] == len(slabs)
    want = bitmatmul.plain_packed_cols_rows_batched(
        a.cpu(), b.cpu(), c0.cpu(), n_rows.cpu())
    assert torch.equal(got.cpu(), want)


def _cohort_members(device, spec):
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.owl import loader

    members = []
    for p, delta in spec:
        base = (f"SubClassOf({p}A {p}B)\nSubClassOf({p}B {p}C)\n"
                f"SubClassOf({p}C ObjectSomeValuesFrom(r {p}D))\n"
                f"SubClassOf(ObjectSomeValuesFrom(r {p}D) {p}E)\n"
                f"SubClassOf({p}E {p}F)\n"
                "SubObjectPropertyOf(ObjectPropertyChain(r r) r)\n")
        inc = IncrementalClassifier(ClassifierConfig(fast_path_min_concepts=0),
                                    device=device)
        inc.add_text(base)
        idx, batch = inc._ingest(loader.load(delta.format(p=p)))
        members.append((inc, inc._delta_fast_plan(idx, cohort_shape=True), batch))
    return members


@pytest.mark.parametrize("size", [2, 3, 5])
def test_cohort_on_the_card_equals_the_cpu(card, size):
    """A cohort on the card (rungs 2, 4, 8: captured cohort programs
    over a stacked state pair) equals the same cohort on the CPU in
    every member's S, R, derivations and iterations, and launches the
    batched row-count kernels."""
    from distel_tpu_torch.core import cohort

    deltas = ["SubClassOf({p}N0 {p}A)\nSubClassOf({p}N1 {p}N0)\n",
              "SubClassOf({p}L ObjectSomeValuesFrom(r {p}B))\n",
              "SubClassOf({p}N0 {p}A)\nSubClassOf({p}M ObjectSomeValuesFrom(r {p}C))\n"]
    spec = [(f"C{size}x{i}", deltas[i % 3]) for i in range(size)]
    want = cohort.execute_delta_cohort(_cohort_members("cpu", spec))
    before = dict(LAUNCHES)
    got = cohort.execute_delta_cohort(_cohort_members("cuda", spec))
    torch.cuda.synchronize()
    batched = sum(LAUNCHES[k] - before[k] for k in (
        "packed_cols_dense_n_batched", "packed_cols_list_n_batched"))
    assert batched > 0
    for g, w in zip(got, want):
        assert torch.equal(g.packed_s.cpu(), w.packed_s)
        assert torch.equal(g.packed_r.cpu(), w.packed_r)
        assert (g.derivations, g.iterations) == (w.derivations, w.iterations)


# ------------------------------------------------------------ the mesh plane

#: the 64k run's word widths halved (exact 2,768 and bucketed 3,084
#: words over two ranks), a quarter of them, and odd widths past them:
#: no tile multiple among them
SHARD_WIDTHS = [1384, 1542, 691, 771, 1543]


@pytest.mark.parametrize("route", ["dense", "sparse", "dense_n", "list_n"])
@pytest.mark.parametrize("w", SHARD_WIDTHS)
def test_kernel_routes_at_shard_local_widths(card, route, w):
    """Each packed-columns route at a rank's word window of the 64k mesh
    run (a CR4-sized and a CR6-sized operand), ORed into a seeded C,
    equal to the plain version word for word."""
    sparse = route in ("sparse", "list_n")
    m, l = (4046, 1056) if sparse else (223, 1056)
    gen = torch.Generator(device="cuda").manual_seed(w)
    a, b = _operands(gen, m, l, w, 0.01)
    c0 = torch.randint(-2**31, 2**31, (m, w), generator=gen, device="cuda",
                       dtype=torch.int64).to(torch.int32)
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=sparse)
    if route.endswith("_n"):
        nr = torch.full((1,), m - 3, dtype=torch.int32, device="cuda")
        got = plan(a, b, out=c0.clone(), n_rows=nr)
        want = bitmatmul.plain_packed_cols_rows(a.cpu(), b.cpu(), c0.cpu(),
                                                nr.cpu())
    else:
        got = plan(a, b, out=c0.clone())
        want = plain_packed_cols(a.cpu(), b.cpu(), c0.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _cli_json(*args, timeout=900):
    import subprocess
    import sys

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-m", "distel_tpu_torch.cli", *args],
                         capture_output=True, text=True, cwd=str(root),
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


@pytest.mark.parametrize("engine", ["rowpacked", "packed", "dense"])
def test_gloo_mesh_of_two_on_one_card_equals_the_solo_card_run(card, engine,
                                                               tmp_path):
    """``cli classify --mesh 2`` on one card (two gloo ranks on cuda:0,
    their collectives on card tensors) equals the solo card classify:
    both ranks' closure digests, derivations, iterations, taxonomy."""
    text = snomed_shaped_ontology(n_classes=600)
    onto = tmp_path / "s.ofn"
    onto.write_text(text)
    props = tmp_path / "c.properties"
    props.write_text(f"engine = {engine}\n")
    stdout = _cli_json("classify", str(onto), "--mesh", "2", "--config",
                       str(props), "-o", str(tmp_path / "mesh.txt"))
    got = json.loads(stdout[: stdout.rindex("}") + 1])
    solo = ELClassifier(ClassifierConfig.from_properties(str(props))).classify_text(text)
    solo.taxonomy.write(str(tmp_path / "solo.txt"))
    ranks = got["mesh"]["ranks"]
    assert [x["backend"] for x in ranks] == ["gloo", "gloo"]
    assert all(x["device"] == "cuda:0" for x in ranks)
    assert {x["closure_sha256"] for x in ranks} == {solo.result.live_digest()}
    assert got["derivations"] == solo.result.derivations
    assert got["iterations"] == solo.result.iterations
    assert (tmp_path / "mesh.txt").read_text() == (tmp_path / "solo.txt").read_text()


def test_nccl_mesh_of_one_equals_the_solo_card_run(card, tmp_path):
    """The coordinator keys with one process: an NCCL group of one on
    the card, a mesh of one (the reference's mesh-of-one posture), equal
    to the solo classify in closure and derivations."""
    import socket

    text = snomed_shaped_ontology(n_classes=600)
    onto = tmp_path / "s.ofn"
    onto.write_text(text)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    props = tmp_path / "c.properties"
    props.write_text(f"coordinator.address = 127.0.0.1:{port}\n"
                     "num.processes = 1\nprocess.id = 0\n")
    stdout = _cli_json("classify", str(onto), "--config", str(props))
    got = json.loads(stdout[: stdout.rindex("}") + 1])
    solo = ELClassifier().classify_text(text)
    assert got["mesh"]["size"] == 1
    assert got["mesh"]["ranks"][0]["backend"] == "nccl"
    assert got["derivations"] == solo.result.derivations


def _mesh_jobs():
    """The sparse tier forced and the fused window (K = 4) on the
    chain-tailed corpus with CR5 (``tests/torch_mesh_ranks.py``)."""
    text = chain_tailed_ontology(400, 12) + "\nDisjointClasses(TailChain3 TailChain7)"
    forced = {"density_threshold": 1.1, "hysteresis_rounds": 1}
    return [{"name": name, "kind": "adaptive", "text": text, "kw": {"unroll": 1},
             "observe": dict(sparse_tail=forced, pipeline={"enable": False}, **extra)}
            for name, extra in (("sparse", {}), ("fused", {"fused_rounds": {"rounds": 4}}))]


def test_sparse_tier_and_fused_window_on_a_gloo_mesh_of_two(card):
    """Two gloo ranks on cuda:0: the sparse tier's kernels at each rank's
    word window and the uncaptured fused window retire the solo card
    run's rounds and closure on both ranks."""
    import torch_mesh_ranks as ranks
    from distel_tpu_torch.parallel.mesh import launch_local

    jobs = _mesh_jobs()
    solo = ranks.run_jobs(card, jobs)
    outs = launch_local(2, ranks.run_jobs, jobs, device="cuda")
    for out in outs:
        for job in jobs:
            got, want = out[job["name"]], solo[job["name"]]
            for k in ("events", "stats", "iterations", "derivations"):
                assert got[k] == want[k], (job["name"], k)
            assert np.array_equal(got["s"], want["s"])
            assert np.array_equal(got["r"], want["r"])
            assert got["collectives"] > 0 and got["captured"] == 0
        assert out["sparse"]["launches"].get("packed_cols_list", 0) + \
            out["sparse"]["launches"].get("packed_cols_dense", 0) > 0
        assert out["fused"]["launches"].get("packed_cols_dense_n", 0) + \
            out["fused"]["launches"].get("packed_cols_list_n", 0) > 0


def test_fused_window_on_an_nccl_mesh_of_one_is_captured(card):
    """An NCCL mesh of one keeps the window one captured graph, and its
    runs equal the CPU port's on a mesh of one, record for record."""
    import torch_mesh_ranks as ranks
    from distel_tpu_torch.parallel.mesh import launch_local

    jobs = _mesh_jobs()
    (got,) = launch_local(1, ranks.run_jobs, jobs, device="cuda")
    cpu = ranks.run_jobs(torch.device("cpu"), jobs)
    assert got["fused"]["captured"] > 0
    for job in jobs:
        g, c = got[job["name"]], cpu[job["name"]]
        for k in ("events", "stats", "iterations", "derivations"):
            assert g[k] == c[k], (job["name"], k)
        assert np.array_equal(g["s"], c["s"]) and np.array_equal(g["r"], c["r"])


def test_gloo_mesh_stream_on_one_card_equals_the_solo_stream(card, tmp_path):
    """``cli stream`` with ``mesh.devices = 2`` on the card (two gloo
    ranks on cuda:0): the solo stream's records, the retraction
    included, and every rank's closure and taxonomy at every step."""
    text = "\n".join(ln for ln in snomed_shaped_ontology(n_classes=600).splitlines()
                     if not ln.startswith("ObjectPropertyRange(")) + "\n"
    files = []
    for name, body in (("base", text), ("d1", "SubClassOf(StreamA Find1)\n"),
                       ("d2", "SubObjectPropertyOf(attr2 attr3)\n")):
        path = tmp_path / f"{name}.ofn"
        path.write_text(body)
        files.append(str(path))
    runs = []
    for extra in ("", "mesh.devices = 2\n"):
        props = tmp_path / f"p{len(runs)}.properties"
        props.write_text("fast.path.min.concepts = 0\n" + extra)
        stdout = _cli_json("stream", *files, "--retract", files[1],
                           "--config", str(props))
        runs.append([json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")])
    solo, mesh = runs
    unstable = COMPILE_KEYS | {"wall_s"}
    assert [{k: v for k, v in r.items() if k not in unstable} for r in solo[:-1]] == \
        [{k: v for k, v in r.items() if k not in unstable} for r in mesh[:-1]]
    ranks = mesh[-1]["mesh"]["ranks"]
    assert [r["backend"] for r in ranks] == ["gloo", "gloo"]
    for k in ("closure_sha256", "taxonomy_sha256"):
        assert [s[k] for s in ranks[0]["steps"]] == [s[k] for s in ranks[1]["steps"]]
