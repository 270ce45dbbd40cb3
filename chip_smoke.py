#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distel_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. probe and build: the card, its power limit, and the CUDA kernels
   built from ``distel_tpu_torch/ops/csrc`` (one ``nvcc`` per source,
   all started together; timed);
2. kernel vs plain: the packed-columns product's two routes (the
   listing kernel ``packed_cols_list`` then ``packed_cols_sparse``; and
   ``packed_cols_dense``) against their plain PyTorch version, written
   fresh and ORed into a seeded C, and the listing against the plain
   listing, on unaligned, bit-31, tile-sparse, all-zero, fully dense,
   one-nonzero-a-row and several-list-chunk operands, bit for bit; and
   the packed-contraction route (the listing kernel ``packed_andor_list``
   then ``packed_cols_sparse``) against its plain version, and its
   listing against the plain listing, each timed beside the plain
   version and the bound;
3. golden fixtures: every ``tests/golden/*.ofn`` classified on the card
   through the row-packed engine and through ``engine="packed"`` must
   match its ``.expected`` file;
4. card vs CPU: the 8000-class SNOMED-shaped corpus classified on the
   card (with the window CR6, and with the live-tile CR6 forced on) and
   on the CPU gives identical packed S and R, derivation count and
   taxonomy; then ``engine="packed"`` on the card gives the same
   x-major S and R (compared in row blocks against the transposed
   row-packed state), derivations and taxonomy.  Then the frontier
   gating at 8k: the gated fixed point stepped on the
   card and on the CPU, every round's S, R and frontier flags equal
   (the default plan, and 256-link L-chunks with the live-tile CR6
   forced); ``engine="dense"`` on the card and the CPU, equal to the
   row-packed card run; and ``verify=True`` (the closure against the
   CPU oracle) on every golden fixture through the row-packed and the
   dense engine, and on the 8k corpus;
5. full width, the main path: the 64000-class SNOMED-shaped corpus
   through ``ELClassifier().classify_text`` with the default config
   (the native load plane, the frontier-gated engine) to convergence
   with nothing hooked in, its wall, phases, peak memory, the windows
   contracted and skipped, and the kernels' launch counts read from
   that run alone (every kernel of the routes its plans chose must be
   > 0); two more saturations of the same engine, timed (same
   closure); the same text through the Python load plane (same derivations and taxonomy by name); then a profiled
   rerun (per-rule breakdown), an end-to-end A/B of the route choice
   (saturation with the shipped choice, with every CR4/CR6 plan on the
   sparse route and with every plan flipped, A B C C B A) and a
   captured rerun (operands), all of which must give the same closure;
6. every operand pair captured in phase 4's live-tile run and phase
   5's captured rerun (one per call site and power-of-two work
   bucket): both routes bit for bit against the plain version and the
   listing against the plain listing, each timed beside it and beside
   the card's bound for the same work, the sparse route also split
   into the listing kernel and the bare sparse kernel; the per-site
   totals form the ``policy`` line.  The pairs go to
   ``chiprun_out/kernel_pairs.json``.
7. the packed engine at full width: the 64000-class corpus through
   ``engine="packed"`` to convergence with nothing hooked in (launch
   counts zeroed just before, read just after: ``packed_andor_list``,
   ``packed_cols_sparse`` and the taxonomy's listing must be > 0), its
   derivations, closure and taxonomy equal to the row-packed run's; then
   a profiled rerun (per-part breakdown), and a captured rerun that
   keeps the heaviest CR4 and CR6 operands (most set bits of A), on
   which the route must reproduce the plain product and its listing the
   plain listing bit for bit, the listing and the product each timed
   beside the plain version and the bound.

Kernel times are CUDA-event times per call over back-to-back calls;
the packed-contraction route's are also taken from CUDA-graph replays
(the card's time alone), which its kernel row carries as ``graph_ms``
beside the event times.
It prints the card's name and power limit, a ``{"policy": ...}`` line
(each site's device time under the chosen route and under each route,
with A's nonzero fraction), the ``{"andor_checks": ...}``,
``{"gating": ...}``, ``{"dense": ...}``, ``{"verify": ...}``,
``{"default_full_width": ...}``, ``{"full_width": ...}`` (the Python
load plane), ``{"breakdown": ...}``, ``{"threshold_ab": ...}``,
``{"packed_full_width": ...}``, ``{"packed_breakdown": ...}`` and
``{"andor_operands": ...}`` lines, a ``{"kernels": [...]}`` line
(the sparse row also carries the listing kernel's time and launches),
and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
#: int8 tensor-core ops/s — the bound of a bit-MAC counted as one int8
#: multiply-add (2 ops)
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
SOURCE = "distel_tpu_torch/ops/csrc/packed_cols.cu"
REPLACES = {
    "packed_cols_dense": "distel_tpu/ops/bitmatmul.py:231 (_packed_cols_kernel)",
    "packed_cols_sparse": "distel_tpu/ops/bitmatmul.py:241 "
                          "(_packed_cols_sparse_kernel)",
    "_andor_kernel": "distel_tpu/ops/bitmatmul.py:81 (_andor_kernel)",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn()``: CUDA events around ``reps``
    back-to-back calls (after one warm-up), over the count, so that the
    host's launch overhead overlaps the card's work wherever the card is
    the slower of the two."""
    fn()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn()`` with the host taken out: ``reps``
    calls captured in one CUDA graph, replayed once to warm up, then
    three replays timed with CUDA events, over the count."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (3 * reps)


def bound_ms(a: torch.Tensor, b: torch.Tensor):
    """Least time for ``C = A ⊙ B`` on these inputs: the work the data
    needs is one W-word OR per nonzero of A; the bytes are A once, the
    B rows some nonzero selects, and C once."""
    m, l = a.shape
    w = b.shape[1]
    nz = a != 0
    nnz = int(nz.sum())
    live_l = int(nz.any(dim=0).sum())
    nbytes = m * l + 4 * w * live_l + 4 * m * w
    ops = 2 * 32 * nnz * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases


def phase_probe():
    from distel_tpu_torch.ops import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    secs = build.build_all(["packed_cols"])
    from distel_tpu_torch.ops import bitmatmul

    bitmatmul._lib()
    log(f"[build] {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for p in Path(build.build_dir()).glob("libpacked_cols-*.so.ptxas.txt"):
        log(p.read_text().strip())
    return name


def check_kernel(a, b, sparse: bool, what: str, c0=None) -> int:
    """One route against the plain version, bit for bit, written fresh
    or (with ``c0``) ORed into a copy of ``c0``; for the sparse route
    also ``packed_cols_list`` against the plain listing."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, list_entries, plain_list_columns, plain_packed_cols,
    )

    plan = PackedColsMatmulPlan(a.shape[0], a.shape[1], b.shape[1],
                                skip_zero_tiles=sparse)
    got = plan(a, b, None if c0 is None else c0.clone())
    sync()
    want = plain_packed_cols(a, b, None if c0 is None else c0.clone())
    diff = int((got != want).sum())
    kern = "packed_cols_sparse" if sparse else "packed_cols_dense"
    mode = "accumulate" if c0 is not None else "write"
    if diff:
        raise AssertionError(f"{kern} {what} ({mode}): {diff} words differ from plain")
    if sparse:
        lists, plain = plan.list_columns(a), plain_list_columns(a)
        sync()
        same = torch.equal(lists.counts, plain.counts) and all(
            torch.equal(x, y) for x, y in zip(list_entries(lists), list_entries(plain))
        )
        if not same:
            raise AssertionError(f"packed_cols_list {what}: lists differ from plain")
    log(f"[kernel] {kern} {what} ({mode}) {tuple(a.shape)}x{tuple(b.shape)}: equal")
    return diff


def random_operands(gen, m, l, w, density, dead_tiles=False, kind="random"):
    a = (torch.rand((m, l), generator=gen, device="cuda") < density).to(torch.int8)
    if dead_tiles:
        # keep ~10% of the 64x32 A tiles alive
        keep = torch.rand((-(-m // 64), -(-l // 32)), generator=gen,
                          device="cuda") < 0.1
        keep = keep.repeat_interleave(64, 0)[:m].repeat_interleave(32, 1)[:, :l]
        a = a * keep.to(torch.int8)
    if kind == "one-per-row":
        a = torch.zeros((m, l), dtype=torch.int8, device="cuda")
        a[torch.arange(m, device="cuda"),
          torch.randint(0, l, (m,), generator=gen, device="cuda")] = 1
    b = torch.randint(-2**31, 2**31, (l, w), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    b[:, 0] |= -2**31                    # bit 31 set in every row
    return a.contiguous(), b.contiguous()


def phase_kernels():
    """Both routes and the listing on unaligned (L % 16, W % 4), bit-31,
    tile-sparse, all-zero, fully dense, one-nonzero-a-row and
    several-list-chunk operands, written fresh and accumulated."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, l, w, dens, dead, kind in (
        (37, 70, 5, 0.2, False, "random"),        # unaligned everywhere
        (1, 1, 1, 1.0, False, "random"),
        (300, 1000, 200, 0.05, True, "random"),   # most tiles dead
        (513, 257, 129, 0.01, False, "random"),   # just past every tile edge
        (128, 64, 33, 0.0, False, "random"),      # all-zero A
        (130, 96, 300, 1.0, False, "random"),     # fully dense A
        (200, 1500, 260, 0.0, False, "one-per-row"),
        (150, 2304, 96, 0.004, False, "random"),  # several list chunks
        (70, 2049, 33, 0.01, False, "random"),    # unaligned rows, 9 chunks
        (2560, 300, 7680, 0.01, False, "random"), # lists not split
    ):
        a, b = random_operands(gen, m, l, w, dens, dead, kind)
        c0 = torch.randint(-2**31, 2**31, (m, w), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
        c0[::2] = 0
        what = f"{kind}(d={dens}, dead={dead})"
        for sparse in (False, True):
            check_kernel(a, b, sparse, what)
            check_kernel(a, b, sparse, what, c0)


def golden_closure(result) -> dict:
    """{named atom: named non-trivial subsumers}, as tests/test_golden.py
    reads an engine result."""
    idx = result.idx
    s = result.s
    out = {}
    for name, cid in idx.concept_ids.items():
        if name.startswith("distel:") or name in ("owl:Thing", "owl:Nothing"):
            continue
        sups = {idx.concept_names[i] for i in np.nonzero(s[cid, : idx.n_concepts])[0]}
        out[name] = {
            x for x in sups
            if not x.startswith("distel:") and x not in (name, "owl:Thing")
        }
    return out


def load_expected(path: Path) -> dict:
    expected = {}
    for ln, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split("<=")
        if len(parts) != 2:
            raise ValueError(f"{path.name}:{ln}: malformed line {raw!r}")
        expected.setdefault(parts[0].strip(), set()).add(parts[1].strip())
    return expected


def golden_errors(closure: dict, expected: dict) -> list:
    """The checker contract of tests/test_golden.py: exact subsumer sets
    for satisfiable atoms; ⊥ plus at least the listed subsumers for
    unsatisfiable ones."""
    errors = [f"{x}: not in the closure" for x in sorted(set(expected) - set(closure))]
    for x, sups in sorted(closure.items()):
        want = expected.get(x, set())
        if "owl:Nothing" in want:
            if "owl:Nothing" not in sups or (want - {"owl:Nothing"}) - sups:
                errors.append(f"{x}: unsatisfiable entailments missing")
        elif sups != want:
            errors.append(f"{x}: got {sorted(sups)} want {sorted(want)}")
    return errors


def phase_golden(device: str = "cuda", engine: str = "rowpacked") -> int:
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.runtime.classifier import ELClassifier

    fixtures = sorted((ROOT / "tests" / "golden").glob("*.ofn"))
    if len(fixtures) < 20:
        raise AssertionError(f"only {len(fixtures)} golden fixtures found")
    clf = ELClassifier(ClassifierConfig(engine=engine), device=device)
    for path in fixtures:
        expected = load_expected(path.with_suffix(".expected"))
        closure = golden_closure(clf.classify_file(str(path)).result)
        errors = golden_errors(closure, expected)
        if errors:
            raise AssertionError(f"golden {path.stem} ({engine}): {errors}")
    log(f"[golden] {len(fixtures)} fixtures match on {device} ({engine})")
    return len(fixtures)


def taxonomy_key(tax):
    return (tax.parents, tax.equivalents, sorted(tax.unsatisfiable))


def phase_card_vs_cpu(cap: "Capture"):
    """The 8k corpus on the card (window CR6, and the live-tile CR6
    forced on) and on the CPU: identical closures and taxonomies."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=8000, seed=42)
    tiles = ClassifierConfig(cr6_tiles_density_threshold=100.0)
    runs = {}
    for what, clf in (
        ("cuda", ELClassifier(device="cuda")),
        ("cuda+tiles", ELClassifier(tiles, device="cuda")),
        ("cpu", ELClassifier(device="cpu")),
    ):
        t0 = time.perf_counter()
        cap.run = f"8k:{what}"
        with cap if what == "cuda+tiles" else contextlib.nullcontext():
            runs[what] = clf.classify_text(text)
        log(f"[8k] {what}: {time.perf_counter() - t0:.2f} s "
            f"{runs[what].summary()}")
    if not runs["cuda+tiles"].engine.plan_stats()["cr6_tiles"]:
        raise AssertionError("8k: live-tile CR6 did not engage when forced")
    cs, cr = runs["cpu"].result.wire()
    for what in ("cuda", "cuda+tiles"):
        res = runs[what]
        gs, gr = res.result.wire()
        if not (np.array_equal(gs, cs) and np.array_equal(gr, cr)):
            raise AssertionError(f"8k: packed S/R differ between {what} and cpu")
        if res.result.derivations != runs["cpu"].result.derivations:
            raise AssertionError(f"8k: derivation counts differ ({what})")
        if taxonomy_key(res.taxonomy) != taxonomy_key(runs["cpu"].taxonomy):
            raise AssertionError(f"8k: taxonomies differ ({what})")
    log("[8k] identical on cuda, cuda with live-tile CR6, and cpu")
    return runs["cuda"]


def same_x_major(packed, row, block: int = 2048) -> bool:
    """Whether an x-major packed-engine result and a transposed
    row-packed result hold the same S and R, padded rows and columns
    included: row blocks of the x-major words against the matching
    word columns of the transposed state, unpacked on the card."""
    from distel_tpu_torch.ops.bitpack import unpack_words

    for px, pt in ((packed.packed_s, row.packed_s), (packed.packed_r, row.packed_r)):
        width, nx = pt.shape[0], px.shape[0]
        if nx != 32 * pt.shape[1] or px.shape[1] * 32 != _pad32(width):
            return False
        for x0 in range(0, nx, block):
            x1 = min(x0 + block, nx)
            a = unpack_words(px[x0:x1], width)
            t = unpack_words(pt[:, x0 // 32 : x1 // 32], x1 - x0)
            if not torch.equal(a, t.T):
                return False
    return True


def _pad32(n: int) -> int:
    return -(-n // 32) * 32


def phase_cross_engine(row_run) -> None:
    """The 8k corpus through ``engine="packed"`` on the card: the same
    closure, derivations and taxonomy as the row-packed card run (which
    phase 4 held against the CPU)."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=8000, seed=42)
    t0 = time.perf_counter()
    got = ELClassifier(ClassifierConfig(engine="packed"), device="cuda").classify_text(text)
    log(f"[8k] packed: {time.perf_counter() - t0:.2f} s {got.summary()}")
    if not same_x_major(got.result, row_run.result):
        raise AssertionError("8k: packed and row-packed closures differ")
    if got.result.derivations != row_run.result.derivations:
        raise AssertionError("8k: packed and row-packed derivations differ")
    if taxonomy_key(got.taxonomy) != taxonomy_key(row_run.taxonomy):
        raise AssertionError("8k: packed and row-packed taxonomies differ")
    log("[8k] packed engine identical to the row-packed engine")


def phase_gating() -> dict:
    """The gated fixed point at 8k, step by step on the card and on the
    CPU from the same index: every round's S and R words and frontier
    flags equal, and the same windows contracted and skipped — with the
    default plan, and with many L-chunks and the live-tile CR6 forced."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.owl import native_loader

    idx = native_loader.load_indexed(snomed_shaped_ontology(n_classes=8000, seed=42))
    # one temporary budget on both devices, so both plan alike
    budget = 1 << 28
    plans = {
        "default": {"cr6_tiles": ClassifierConfig().cr6_tiles_config()},
        "lc256+tiles": {"l_chunk": 256,
                        "cr6_tiles": {"density_threshold": 100.0}},
    }
    out = {}
    for what, kw in plans.items():
        gpu = RowPackedSaturationEngine(idx, device="cuda",
                                        temp_budget_bytes=budget, **kw)
        cpu = RowPackedSaturationEngine(idx, device="cpu",
                                        temp_budget_bytes=budget, **kw)
        gs, gr = gpu.initial_state()
        cs, cr = cpu.initial_state()
        gf = cf = None
        t_gpu = t_cpu = 0.0
        while gf is None or gf.changed:
            sync()
            t0 = time.perf_counter()
            gs, gr, gf = gpu.step(gs, gr, gf)
            sync()
            t1 = time.perf_counter()
            cs, cr, cf = cpu.step(cs, cr, cf)
            t2 = time.perf_counter()
            t_gpu, t_cpu = t_gpu + t1 - t0, t_cpu + t2 - t1
            rnd = len(gpu.gate_rounds)
            if not (torch.equal(gs.cpu(), cs) and torch.equal(gr.cpu(), cr)):
                raise AssertionError(f"8k gating ({what}): S/R differ in round {rnd}")
            for a in ("changed", "dirty_l", "f4", "f6", "fd6", "cr5"):
                if not np.array_equal(getattr(gf, a), getattr(cf, a)):
                    raise AssertionError(f"8k gating ({what}): {a} differs in round {rnd}")
            if gpu.gate_rounds[-1] != cpu.gate_rounds[-1]:
                raise AssertionError(f"8k gating ({what}): window counts differ")
            if rnd > 200:
                raise AssertionError(f"8k gating ({what}): no fixed point")
        out[what] = {
            "rounds": len(gpu.gate_rounds),
            "windows": gpu.gate_totals(),
            "windows_per_round": gate_rounds_compact(gpu),
            "plan": gpu.plan_stats(),
            "card_steps_s": t_gpu,
            "cpu_steps_s": t_cpu,
        }
    log(f"[8k gating] {json.dumps(out)}")
    print(json.dumps({"gating": out}), flush=True)
    if not sum(v["skipped"] for v in out["lc256+tiles"]["windows"].values()):
        raise AssertionError("8k gating: no window was ever skipped")
    return out


def phase_dense(row_run) -> dict:
    """``engine="dense"`` on the 8k corpus, on the card and on the CPU:
    the same S and R as each other and as the row-packed card run, the
    same derivations and taxonomy.  It runs no kernel of the port (its
    products are matmuls), which its launch counts show."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=8000, seed=42)
    cfg = ClassifierConfig(engine="dense")
    runs, walls = {}, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for dev in ("cuda", "cpu"):
        reset_launches()
        sync()
        t0 = time.perf_counter()
        runs[dev] = ELClassifier(cfg, device=dev).classify_text(text)
        sync()
        walls[dev] = time.perf_counter() - t0
        if dev == "cuda":
            launches, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
    for dev, res in runs.items():
        for x, y in zip(res.result.wire(), row_run.result.wire()):
            if not np.array_equal(x, y):
                raise AssertionError(f"8k dense ({dev}): S/R differ from the row-packed run")
        if res.result.derivations != row_run.result.derivations:
            raise AssertionError(f"8k dense ({dev}): derivations differ")
        if taxonomy_key(res.taxonomy) != taxonomy_key(row_run.taxonomy):
            raise AssertionError(f"8k dense ({dev}): taxonomy differs")
    if runs["cuda"].result.iterations != runs["cpu"].result.iterations:
        raise AssertionError("8k dense: card and CPU iteration counts differ")
    out = {
        **runs["cuda"].summary(),
        "wall_s": walls["cuda"],
        "cpu_wall_s": walls["cpu"],
        "cpu_phases_ms": runs["cpu"].summary()["phases_ms"],
        "max_memory_allocated": peak,
        "launches": launches,
        "rowpacked_iterations": row_run.result.iterations,
    }
    log(f"[8k dense] {json.dumps(out)}")
    print(json.dumps({"dense": out}), flush=True)
    return out


def phase_verify() -> dict:
    """``verify=True`` (the closure against the CPU oracle) on the card:
    every golden fixture through the row-packed and the dense engine,
    and the 8k corpus."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.runtime.classifier import ELClassifier

    fixtures = sorted((ROOT / "tests" / "golden").glob("*.ofn"))
    for engine in ("rowpacked", "dense"):
        clf = ELClassifier(ClassifierConfig(engine=engine), device="cuda")
        for path in fixtures:
            clf.classify_file(str(path), verify=True)
    t0 = time.perf_counter()
    res = ELClassifier(device="cuda").classify_text(
        snomed_shaped_ontology(n_classes=8000, seed=42), verify=True
    )
    out = {
        "goldens": len(fixtures),
        "engines": ["rowpacked", "dense"],
        "8k_wall_s": time.perf_counter() - t0,
        "8k_phases_ms": res.summary()["phases_ms"],
    }
    log(f"[verify] {json.dumps(out)}")
    print(json.dumps({"verify": out}), flush=True)
    return out


#: the callers of PackedColsMatmulPlan on the main path, by function name
SITES = {
    "_cr4": "cr4",
    "_cr6_windows": "cr6_windows",
    "_cr6_tiles": "cr6_tiles",
    "_extract_device_blocked": "taxonomy",
}


class Capture:
    """While active, counts the launches at each (run, call site, kernel,
    power-of-two work bucket) and keeps on the host, per key, the
    operand pair whose A has the most nonzeros, to re-run it with both
    kernels and the plain version afterwards.  Its stack walks, counts
    and copies slow the run it watches, so no measured run has one."""

    def __init__(self):
        from distel_tpu_torch.ops import bitmatmul

        self.mod = bitmatmul
        self.run = ""
        self.pairs = {}   # key -> [launches, nnz(A), a, b]
        self._orig = bitmatmul.PackedColsMatmulPlan._launch

    def __enter__(self):
        cap = self

        def launch(plan, a, b, out):
            f, site = sys._getframe(1), "other"
            while f is not None and f.f_code.co_name not in SITES:
                f = f.f_back
            if f is not None:
                site = SITES[f.f_code.co_name]
            kern = "packed_cols_sparse" if plan.skip_zero_tiles else "packed_cols_dense"
            work = plan.m * plan.l * plan.w
            key = (cap.run, site, kern, work.bit_length())
            got = cap.pairs.setdefault(key, [0, -1, None, None])
            got[0] += 1
            nnz = int(torch.count_nonzero(a))
            if nnz > got[1]:
                got[1:] = [nnz, a.cpu(), b.cpu()]
            return cap._orig(plan, a, b, out)

        self.mod.PackedColsMatmulPlan._launch = launch
        return self

    def __exit__(self, *exc):
        self.mod.PackedColsMatmulPlan._launch = self._orig


def path_kernels(plans) -> list:
    """The packed-columns kernels the row-packed path must launch: the
    sparse route (listing + sparse kernel) for CR6 and the taxonomy at
    full width, and the dense kernel if any CR4/CR6 plan chose it."""
    kernels = ["packed_cols_list", "packed_cols_sparse"]
    if any(not p.skip_zero_tiles for p in plans):
        kernels.append("packed_cols_dense")
    return kernels


def gate_rounds_compact(engine) -> dict:
    """Per round, the windows (or link tiles) contracted and skipped."""
    out = {k: [] for k in ("cr4", "cr6", "cr6_tiles")}
    for rnd in engine.gate_rounds:
        for k in out:
            out[k].append(rnd[k])
    return out


def phase_default_full_width():
    """The main path: ``ELClassifier().classify_text`` with the default
    config (the native load plane, the frontier-gated row-packed
    engine) on the 64k corpus, with nothing hooked into it: wall, phases,
    peak memory, launch counts and windows contracted and skipped are
    those of ``cli classify``.  Then two more saturations of the same
    engine, timed."""
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=64000, seed=42)
    clf = ELClassifier(device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    res = clf.classify_text(text)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gated = res.engine
    gate_totals = gated.gate_totals()
    per_round = gate_rounds_compact(gated)
    walls = []
    for _ in range(2):
        sync()
        t1 = time.perf_counter()
        again = gated.saturate()
        sync()
        walls.append(time.perf_counter() - t1)
        for x, y in zip(again.wire(), res.result.wire()):
            if not np.array_equal(x, y):
                raise AssertionError("64k: a rerun gave another closure")
    stats = {
        **res.summary(),
        "wall_s": wall,
        "max_memory_allocated": peak,
        "memory_allocated_before": base,
        "launches": launches,
        "windows": gate_totals,
        "windows_per_round": per_round,
        "plan": gated.plan_stats(),
        "classes_in_taxonomy": len(res.taxonomy.parents),
        "saturate_reruns_s": walls,
    }
    log(f"[64k default] {json.dumps(stats)}")
    print(json.dumps({"default_full_width": stats}), flush=True)
    if "load(native)" not in res.timer.phases:
        raise AssertionError("64k: the default classify did not run the native plane")
    if not res.result.converged:
        raise AssertionError("64k run did not converge")
    for k in path_kernels(gated._plans.values()):
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched on the 64k run")
    if len(res.taxonomy.parents) == 0:
        raise AssertionError("64k taxonomy is empty")
    return launches, res


def phase_full_width(default):
    """The same 64k text through the Python load plane (parse →
    normalize → index), with nothing hooked in: its wall, peak memory
    and launch counts; its derivations and taxonomy (by name: ids
    differ between the planes) must equal the default run's."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=64000, seed=42)
    clf = ELClassifier(ClassifierConfig(use_native_loader=False), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    res = clf.classify_text(text)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    summary = res.summary()
    stats = {
        **summary,
        "load_plane": "python",
        "wall_s": wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_before": base,
        "launches": launches,
        "windows": res.engine.gate_totals(),
        "plan": res.engine.plan_stats(),
        "classes_in_taxonomy": len(res.taxonomy.parents),
    }
    log(f"[64k python plane] {json.dumps(stats)}")
    print(json.dumps({"full_width": stats}), flush=True)
    if not res.result.converged:
        raise AssertionError("64k python-plane run did not converge")
    for k in path_kernels(res.engine._plans.values()):
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched on the 64k python-plane run")
    if res.result.derivations != default.result.derivations:
        raise AssertionError("64k: the load planes give other derivation counts")
    if taxonomy_key(res.taxonomy) != taxonomy_key(default.taxonomy):
        raise AssertionError("64k: the load planes give other taxonomies")
    log("[64k] native and python load planes: same derivations and taxonomy")


def phase_threshold_ab(res) -> dict:
    """The shipped route choice end to end against every CR4 and
    window-CR6 plan on the sparse route and against every plan on the
    route it did not choose: ``saturate()`` on the 64k engine in the
    order A B C C B A, host wall with the card synchronised.  Every
    closure must equal the first run's."""
    plans = list(res.engine._plans.values())
    shipped = [p.skip_zero_tiles for p in plans]
    choice = {
        "shipped": shipped,
        "all_sparse": [True] * len(plans),
        "flipped": [not x for x in shipped],
    }
    walls = {k: [] for k in choice}
    try:
        for what in ("flipped", "all_sparse", "shipped", "shipped", "all_sparse",
                     "flipped"):
            for p, chosen in zip(plans, choice[what]):
                p.skip_zero_tiles = chosen
            sync()
            t0 = time.perf_counter()
            again = res.engine.saturate()
            sync()
            walls[what].append(time.perf_counter() - t0)
            for x, y in zip(again.wire(), res.result.wire()):
                if not np.array_equal(x, y):
                    raise AssertionError(f"64k A/B ({what}) gave another closure")
    finally:
        for p, chosen in zip(plans, shipped):
            p.skip_zero_tiles = chosen
    out = {"saturate_s": walls,
           "plans_dense_when_shipped": shipped.count(False),
           "plans": len(plans)}
    log(f"[threshold A/B] {json.dumps(out)}")
    print(json.dumps({"threshold_ab": out}), flush=True)
    return out


def phase_capture_64k(res, cap: Capture) -> None:
    """A third saturate-and-taxonomy run on the 64k index, under the
    capture; its closure must equal the first run's."""
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    cap.run = "64k"
    with cap:
        again = res.engine.saturate()
        tax = extract_taxonomy(again)
    for x, y in zip(again.wire(), res.result.wire()):
        if not np.array_equal(x, y):
            raise AssertionError("64k: the captured rerun gave another closure")
    if taxonomy_key(tax) != taxonomy_key(res.taxonomy):
        raise AssertionError("64k: the captured rerun gave another taxonomy")
    log(f"[capture] {len(cap.pairs)} operand pairs")


def phase_breakdown(res) -> dict:
    """Where the 64k run's device time goes, from a second run on the
    same index: saturation with each rule group synchronised and timed
    (the engine's ``profile=True``), and the taxonomy's two halves (the
    blocked reduction, then the transitive-reduction product and the
    parent-edge transfer).  The second closure must equal the first."""
    from distel_tpu_torch.runtime import taxonomy

    engine = res.engine
    engine.rule_seconds = {}
    sync()
    t0 = time.perf_counter()
    again = engine.saturate(profile=True)
    t1 = time.perf_counter()
    for x, y in zip(again.wire(), res.result.wire()):
        if not np.array_equal(x, y):
            raise AssertionError("64k: the profiled rerun gave another closure")
    orig, names = taxonomy._signature(res.idx)
    t2 = time.perf_counter()
    taxonomy._blocked_reduction(again.packed_s, orig, taxonomy._TAX_BLOCK)
    sync()
    t3 = time.perf_counter()
    taxonomy.extract_taxonomy(again)
    sync()
    t4 = time.perf_counter()
    out = {
        "saturate_profiled_s": t1 - t0,
        "rule_s": dict(engine.rule_seconds),
        "taxonomy_s": t4 - t3,
        "taxonomy_reduction_s": t3 - t2,
    }
    log(f"[breakdown] {json.dumps(out)}")
    print(json.dumps({"breakdown": out}), flush=True)
    return out


def wall_ms(fn, reps: int = 10) -> float:
    """Host wall per call of ``fn()`` over ``reps`` back-to-back calls,
    the card synchronised once at the end: launch and host overhead
    included."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def check_pair(run, site, kern, launches, a, b) -> dict:
    """One captured operand pair: both routes bit for bit against the
    plain version and the listing against the plain listing, then their
    times (CUDA events; the sparse route also split into the listing
    kernel and the bare sparse kernel), the host wall per call, the
    plain version's time and the bound."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, list_entries, plain_list_columns, plain_packed_cols,
    )

    a, b = a.cuda(), b.cuda()
    m, l = a.shape
    w = b.shape[1]
    dense = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=False)
    sparse = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=True)
    want = plain_packed_cols(a, b)
    err = 0
    for plan in (dense, sparse):
        err = max(err, int((plan(a, b) != want).sum()))
    lists = sparse.list_columns(a)
    plain = plain_list_columns(a)
    if not torch.equal(lists.counts, plain.counts):
        err = max(err, int((lists.counts != plain.counts).sum()))
    else:
        for x, y in zip(list_entries(lists), list_entries(plain)):
            err = max(err, int((x != y).sum()))
    del plain
    if err:
        raise AssertionError(f"{run} {site} {tuple(a.shape)}: {err} entries differ")
    if len(sparse.slabs(a.device)) != 1:
        raise AssertionError(f"{run} {site}: lists past the budget")
    c = torch.empty((m, w), dtype=torch.int32, device="cuda")
    gm = lists.counts.shape[0]
    out = {
        "run": run,
        "site": site,
        "main_path_kernel": kern,
        "launches": launches,
        "shape": [m, l, w],
        "a_nonzero_fraction": float((a != 0).float().mean()),
        "mean_list_length": float(lists.counts.sum()) / max(gm, 1),
        "max_abs_err": err,
        "dense_ms": time_ms(lambda: dense(a, b)),
        "sparse_ms": time_ms(lambda: sparse(a, b)),
        "list_ms": time_ms(lambda: sparse.list_columns(a, lists)),
        "sparse_kernel_ms": time_ms(lambda: sparse.run_sparse(b, lists, c, False)),
        "dense_wall_ms": wall_ms(lambda: dense(a, b)),
        "sparse_wall_ms": wall_ms(lambda: sparse(a, b)),
        "plain_ms": time_ms(lambda: plain_packed_cols(a, b), reps=3),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(a, b)
    log(f"[pair] {json.dumps(out)}")
    return out


def phase_kernel_line(launches, cap: Capture):
    """Every captured pair with both routes, the per-site policy, then
    one row per kernel.  A row's numbers are its kernel's at the
    heaviest pair (most word-ANDs) that the 64k main path sent to it
    (for a kernel the path did not choose, the heaviest 64k pair)."""
    pairs = []
    for (run, site, kern, _bucket) in sorted(cap.pairs):
        n, _nnz, a, b = cap.pairs.pop((run, site, kern, _bucket))
        pairs.append(check_pair(run, site, kern, n, a, b))
    # each site's device time under the route the plan chose, and under
    # each route for every launch (launch-weighted over the buckets)
    totals = {}
    for p in pairs:
        t = totals.setdefault(f"{p['run']}:{p['site']}", {
            "launches": 0, "chosen": set(), "chosen_ms": 0.0,
            "all_dense_ms": 0.0, "all_sparse_ms": 0.0, "list_ms": 0.0,
            "a_nonzero_fraction": 0.0,
        })
        t["launches"] += p["launches"]
        t["chosen"].add(p["main_path_kernel"])
        chosen = "sparse_ms" if p["main_path_kernel"].endswith("sparse") else "dense_ms"
        t["chosen_ms"] += p["launches"] * p[chosen]
        t["all_dense_ms"] += p["launches"] * p["dense_ms"]
        t["all_sparse_ms"] += p["launches"] * p["sparse_ms"]
        t["list_ms"] += p["launches"] * p["list_ms"]
        t["a_nonzero_fraction"] += p["launches"] * p["a_nonzero_fraction"]
    for t in totals.values():
        t["chosen"] = sorted(t["chosen"])
        t["a_nonzero_fraction"] /= max(t["launches"], 1)
    log(f"[policy] {json.dumps(totals)}")
    print(json.dumps({"policy": totals}), flush=True)
    rows = []
    for kern in ("packed_cols_dense", "packed_cols_sparse"):
        on_path = [p for p in pairs if p["main_path_kernel"] == kern and p["run"] == "64k"]
        pool = on_path or [p for p in pairs if p["run"] == "64k"] or pairs
        top = max(pool, key=lambda p: p["shape"][0] * p["shape"][1] * p["shape"][2])
        key = "sparse_ms" if kern.endswith("sparse") else "dense_ms"
        row = {
            "name": kern,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kern],
            "launches": launches[kern],
            "max_abs_err": max(p["max_abs_err"] for p in pairs),
            "ms": top[key],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
            "at": {k: top[k] for k in ("run", "site", "shape")},
            "main_path": bool(on_path),
        }
        if kern.endswith("sparse"):
            # the sparse route's own listing kernel (no TPU kernel of its own)
            row.update(list_ms=top["list_ms"], sparse_kernel_ms=top["sparse_kernel_ms"],
                       list_launches=launches["packed_cols_list"])
        rows.append(row)
    return rows, pairs


# ------------------------------------------- the packed-contraction route


def andor_operands(gen, m, kw, k, n, density, *, bit31=False, zero_rows_from=None,
                   offset=0):
    """A [m, kw] int32 words with about ``density`` of their bits set
    (bit 31 of every word with ``bit31``; ``offset`` words into its
    allocation, so 1 misaligns it), B [k, n] int8 0/1."""
    bits = torch.rand((m, kw, 32), generator=gen, device="cuda") < density
    if bit31:
        bits[:, :, 31] = True
    if zero_rows_from is not None:
        bits[zero_rows_from:] = False
    words = (bits.to(torch.int64) << torch.arange(32, device="cuda")).sum(dim=2)
    words = torch.where(words >= 2**31, words - 2**32, words)
    a = torch.empty(m * kw + offset, dtype=torch.int32, device="cuda")[offset:]
    a = a.view(m, kw)
    a.copy_(words.to(torch.int32))
    b = (torch.rand((k, n), generator=gen, device="cuda") < 0.05).to(torch.int8)
    return a, b.contiguous()


def andor_bound_ms(a: torch.Tensor, b: torch.Tensor):
    """Least time for ``C = A ⊙ B`` (A packed along K) on these inputs:
    the bytes are A once, the B rows some set bit of A selects, and C
    once; the work is one byte-OR per set bit of A per output column,
    counted as one int8 multiply-add (2 ops), as the packed-columns
    bound counts a bit-MAC."""
    from distel_tpu_torch.core.engine import popcount_rows
    from distel_tpu_torch.ops.bitpack import or_reduce_any

    m, kw = a.shape
    k, n = b.shape
    full, rem = divmod(k, 32)
    any_row = or_reduce_any(a, 0)[None, :]

    def bits(p):   # set bits at contraction indices < k
        total = int(popcount_rows(p[:, :full]).sum())
        if rem:
            total += int(popcount_rows(p[:, full : full + 1] & ((1 << rem) - 1)).sum())
        return total

    nnz, selected = bits(a), bits(any_row)
    nbytes = 4 * m * kw + selected * n + m * n
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, 2 * nnz * n / PEAK_INT8_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nnz, selected)


def check_andor(a, b, n, what: str) -> dict:
    """The route against the plain product bit for bit, and its listing
    against ``plain_andor_list`` entry for entry; then the listing, the
    product over that listing and the whole call timed (CUDA events over
    back-to-back calls, as every kernel row is timed, which at small
    work measure the host's side; and replayed from a CUDA graph, the
    card's side alone) beside the plain product and the bound.
    ``b`` may carry padded columns past ``n``; it is padded to ``n_p``
    once, as the engine builds it, so no time holds a padding copy."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedMatmulPlan, list_entries, plain_andor_list, plain_packed_andor,
    )

    plan = PackedMatmulPlan(a.shape[0], a.shape[1], n)
    k = b.shape[0]
    if b.shape[1] != plan.n_p:
        b_p = torch.zeros((k, plan.n_p), dtype=torch.int8, device="cuda")
        b_p[:, : b.shape[1]] = b
        b = b_p
    got = plan(a, b)
    sync()
    want = plain_packed_andor(a, b[:, :n])
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0
    del got, want
    lists, plain = plan.list_rows(a, k), plain_andor_list(a, k)
    sync()
    if not torch.equal(lists.counts, plain.counts):
        err = max(err, int((lists.counts != plain.counts).sum()))
    else:
        for x, y in zip(list_entries(lists), list_entries(plain)):
            err = max(err, int((x != y).sum()))
    del plain
    if err:
        raise AssertionError(f"packed-contraction route {what}: differs from plain")
    entries = int(lists.counts.sum())
    out = {"what": what, "shape": [a.shape[0], a.shape[1], k, n],
           "a_aligned_16": a.data_ptr() % 16 == 0,
           "max_abs_err": err,
           "list_entries": entries,
           "max_row_block_entries": int(lists.counts.sum(1).max()) if entries else 0,
           "b_bytes_read": entries * plan.n_p,
           "list_ms": time_ms(lambda: plan.list_rows(a, k)),
           "product_ms": time_ms(lambda: plan(a, b, lists=lists)),
           "call_ms": time_ms(lambda: plan(a, b)),
           "list_graph_ms": graph_ms(lambda: plan.list_rows(a, k)),
           "product_graph_ms": graph_ms(lambda: plan(a, b, lists=lists)),
           "plain_ms": time_ms(lambda: plain_packed_andor(a, b[:, :n]), reps=3)}
    out["ms"] = out["list_ms"] + out["product_ms"]
    out["graph_ms"] = out["list_graph_ms"] + out["product_graph_ms"]
    out["bound_ms"], out["bound_by"], out["a_bits"], out["b_rows_selected"] = \
        andor_bound_ms(a, b[:, :n])
    log(f"[andor] {json.dumps(out)}")
    return out


def phase_andor_kernel() -> list:
    """The route and its listing bit for bit against their plain
    versions on unaligned shapes, bit-31 words, a mostly-zero A with
    more than one column tile, an all-zero A, and an A that is not
    16-byte aligned with an odd word count."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    checks = []
    for what, (m, kw, k, n, dens, bit31, zero_from, offset) in (
        ("unaligned", (70, 10, 300, 90, 0.1, False, None, 0)),
        ("bit31", (33, 8, 256, 17, 0.02, True, None, 0)),
        ("mostly-zero", (300, 70, 2200, 4100, 0.001, False, 40, 0)),
        ("all-zero", (17, 300, 9600, 64, 0.0, False, None, 0)),
        ("misaligned-odd-kw", (130, 37, 1180, 200, 0.01, False, None, 1)),
    ):
        a, b = andor_operands(gen, m, kw, k, n, dens, bit31=bit31,
                              zero_rows_from=zero_from, offset=offset)
        checks.append(check_andor(a, b, n, what))
    print(json.dumps({"andor_checks": checks}), flush=True)
    return checks


def phase_packed_full_width(row_res):
    """The 64k corpus through ``engine="packed"`` with nothing hooked
    in: wall per phase, peak memory, iterations, derivations and launch
    counts of that run alone; its derivations, closure and taxonomy
    must equal the row-packed run's."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=64000, seed=42)
    clf = ELClassifier(ClassifierConfig(engine="packed"), device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    res = clf.classify_text(text)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    stats = {
        **res.summary(),
        "wall_s": wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_before": base,
        "launches": launches,
        "plan": res.engine.plan_stats(),
        "classes_in_taxonomy": len(res.taxonomy.parents),
    }
    log(f"[64k packed] {json.dumps(stats)}")
    print(json.dumps({"packed_full_width": stats}), flush=True)
    if not res.result.converged:
        raise AssertionError("64k packed run did not converge")
    # CR4/CR6 through the listing and the sparse product, the taxonomy
    # through the sparse route
    for k in ("packed_andor_list", "packed_cols_list", "packed_cols_sparse"):
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched on the 64k packed run")
    if res.result.derivations != row_res.result.derivations:
        raise AssertionError("64k: packed and row-packed derivations differ")
    if taxonomy_key(res.taxonomy) != taxonomy_key(row_res.taxonomy):
        raise AssertionError("64k: packed and row-packed taxonomies differ")
    if not same_x_major(res.result, row_res.result):
        raise AssertionError("64k: packed and row-packed closures differ")
    log("[64k packed] derivations, closure and taxonomy equal the row-packed run's")
    return launches, res


def phase_packed_breakdown(packed) -> dict:
    """Where the 64k packed run's time goes, from a profiled rerun on
    the same engine (each part of the step synchronised and timed); its
    closure must equal the first run's."""
    engine = packed.engine
    engine.rule_seconds = {}
    sync()
    t0 = time.perf_counter()
    again = engine.saturate(profile=True)
    wall = time.perf_counter() - t0
    for x, y in zip((again.packed_s, again.packed_r),
                    (packed.result.packed_s, packed.result.packed_r)):
        if not torch.equal(x, y):
            raise AssertionError("64k packed: the profiled rerun gave another closure")
    out = {"saturate_profiled_s": wall, "iterations": again.iterations,
           "rule_s": dict(engine.rule_seconds)}
    log(f"[packed breakdown] {json.dumps(out)}")
    print(json.dumps({"packed_breakdown": out}), flush=True)
    return out


def phase_andor_operands(packed, launches: dict, checks: list) -> dict:
    """A captured rerun of the 64k packed engine keeps, for CR4 and CR6,
    the operand pair whose A has the most set bits; the route must
    reproduce each bit for bit and its listing the plain listing, each
    timed beside the plain version and the bound.  Returns the kernel
    line's row, at the heavier pair, with the packed run's launches:
    the listings, and the sparse products less the taxonomy's (one a
    ``packed_cols_list``)."""
    from distel_tpu_torch.core.engine import popcount_rows
    from distel_tpu_torch.ops import bitmatmul

    engine = packed.engine
    heavy = {}     # site -> [set bits of A, a, b, n]
    orig = bitmatmul.PackedMatmulPlan._launch

    def launch(plan, a, b, lists):
        site = next(r for (r, _m), p in engine._plans.items() if p is plan)
        nbits = int(popcount_rows(a).sum())
        if nbits > heavy.get(site, [-1])[0]:
            heavy[site] = [nbits, a.clone(), b, plan.n]
        return orig(plan, a, b, lists)

    bitmatmul.PackedMatmulPlan._launch = launch
    try:
        again = engine.saturate()
    finally:
        bitmatmul.PackedMatmulPlan._launch = orig
    for x, y in zip((again.packed_s, again.packed_r),
                    (packed.result.packed_s, packed.result.packed_r)):
        if not torch.equal(x, y):
            raise AssertionError("64k packed: the captured rerun gave another closure")
    del again
    pairs = []
    for site in sorted(heavy):
        _nbits, a, b, n = heavy.pop(site)
        pairs.append({"site": site, **check_andor(a, b, n, f"64k {site}")})
        del a, b
    print(json.dumps({"andor_operands": pairs}), flush=True)
    top = max(pairs, key=lambda p: p["a_bits"] * p["shape"][3])
    return {
        "name": "packed_andor_list + packed_cols_sparse",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES["_andor_kernel"],
        "launches": launches["packed_andor_list"],
        "product_launches": launches["packed_cols_sparse"] - launches["packed_cols_list"],
        "max_abs_err": max(p["max_abs_err"] for p in pairs + checks),
        "ms": top["ms"],
        "list_ms": top["list_ms"],
        "product_ms": top["product_ms"],
        "graph_ms": top["graph_ms"],
        "list_graph_ms": top["list_graph_ms"],
        "product_graph_ms": top["product_graph_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "at": {"run": "64k packed", "site": top["site"], "shape": top["shape"]},
    }


def main() -> int:
    # the port first: in a directory without it this fails before any
    # result is printed
    import distel_tpu_torch  # noqa: F401

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py needs one card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    name = phase_probe()
    phase_kernels()
    andor_checks = phase_andor_kernel()
    phase_golden()
    phase_golden(engine="packed")
    cap = Capture()
    row8k = phase_card_vs_cpu(cap)
    phase_cross_engine(row8k)
    phase_gating()
    phase_dense(row8k)
    del row8k
    phase_verify()
    launches, res = phase_default_full_width()
    phase_full_width(res)
    phase_breakdown(res)
    phase_threshold_ab(res)
    phase_capture_64k(res, cap)
    packed_launches, packed = phase_packed_full_width(res)
    del res
    torch.cuda.empty_cache()
    phase_packed_breakdown(packed)
    andor_row = phase_andor_operands(packed, packed_launches, andor_checks)
    del packed
    torch.cuda.empty_cache()
    rows, pairs = phase_kernel_line(launches, cap)
    rows.append(andor_row)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_pairs.json").write_text(json.dumps(pairs, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name,
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
