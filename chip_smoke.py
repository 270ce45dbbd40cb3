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
   row-packed card run; ``backend.CRn = host`` (CR5, and CR1 with CR6,
   through the hybrid saturator) equal to the all-device card run;
   ``verify=True`` (the closure against the CPU oracle) on every golden
   fixture through the row-packed and the dense engine, and on the 8k
   corpus; and the XML readers: the RDF/XML corpora of
   ``tests/corpora`` (OpenGALEN module, LUBM) and the RDF/XML and
   OWL/XML fixtures of ``tests/test_xml_readers.py`` classified on the
   card, each equal (ids, S, R, derivations, taxonomy) to its EL part
   written as OFN;
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
   beside the plain version and the bound;
8. the weak-scaling corpus at full width: the OpenGALEN module read
   through the RDF/XML reader, multiplied into 600 crossed copies
   (88,802 concepts), written as OFN and classified by the default
   path with nothing hooked in (launch counts zeroed just before, read
   just after; every kernel of the engine's routes must be > 0), held
   to the Python-plane run of the same text (derivations, taxonomy);
   how each plane's peak memory splits (plan tables, state, a rerun's
   temporaries); then a captured saturate-and-taxonomy rerun of each
   plane's engine, whose operand pairs (one per call site and work
   bucket) are checked as in phase 6 and join the kernel line.
9. the incremental plane (``IncrementalClassifier``): the reference
   bench's traffic (a 100-axiom class-only delta, a role-introducing
   delta, ``SubObjectPropertyOf(attr7 attr8)``), the class-only delta
   retracted, and a restore from a snapshot through the op log — over
   the 8k corpus on the card and on the CPU (packed S and R and the
   history equal after every step), then over the 64k corpus on the
   card with the default config and nothing hooked in: each step's
   path (base rebuild; class-only and role deltas on the fast path, the
   role delta with a cross engine; the closure delta fast through the
   rebind or rebuilt), held to a from-scratch card classify (taxonomy
   and named subsumers by name), the retraction to a classify of the
   survivors, the restore one quiet group with the same closure, and a
   forced rebuild of the class-only delta on a second classifier; then
   the delta, cross and rebound-base engines rerun under the capture,
   whose heaviest operand pair per site, engine and kernel is checked
   as in phase 6 and joins the kernel line.
10. the serve plane on the card and on the CPU (``ServeApp`` through
   ``dispatch``): the bench's traffic over the 8k corpus without its
   range axiom, the scheduled and snapshot reads after each write, every
   answer equal; the tracked mixed trace replayed over loopback HTTP on
   both, with the row-packed and with the packed engine, every answer
   equal; the 8k corpus and the class-only delta served by the packed
   engine on the card, its answers equal to the row-packed engine's.
11. the resident server at full width: ``ServeApp(device="cuda")``
   behind ``make_server``, two workers, a card-memory budget (once the
   64k tenant's state is known) that holds that tenant alone, driven
   over HTTP by ``ServeClient`` under the capture: the 64k corpus without its range axiom, the three deltas and
   the retraction, every served taxonomy held by name to a from-scratch
   card classify; an 8k tenant evicting it to the warm tier (the card
   must get its state's bytes back), a read promoting it; without the
   warm tier, a cold spill and a restore; a concurrent burst held to
   serial answers; the graceful close with its final spill.  The
   captured operand pairs are checked as in phase 6 and join the kernel
   line.

Kernel times are CUDA-event times per call over back-to-back calls;
the packed-contraction route's are also taken from CUDA-graph replays
(the card's time alone), which its kernel row carries as ``graph_ms``
beside the event times.
It prints the card's name and power limit, a ``{"policy": ...}`` line
(each site's device time under the chosen route and under each route,
with A's nonzero fraction), the ``{"andor_checks": ...}``,
``{"gating": ...}``, ``{"dense": ...}``, ``{"hybrid": ...}``,
``{"verify": ...}``, ``{"xml_corpora": ...}``,
``{"default_full_width": ...}`` (with the ``unroll`` it ran and its
``rounds``), ``{"full_width": ...}`` (the Python
load plane), ``{"breakdown": ...}``, ``{"threshold_ab": ...}``,
``{"packed_full_width": ...}``, ``{"packed_breakdown": ...}`` and
``{"andor_operands": ...}``, ``{"multiplied_full_width": ...}``,
``{"incremental_card_vs_cpu": ...}`` and ``{"incremental_full_width":
...}`` (each step's path, iterations, derivations, wall, phases,
launches, host and card peaks; the retraction's overdeletion time),
``{"serve_card_vs_cpu": ...}`` and ``{"serve_full_width": ...}`` (per
request: client wall, path, iterations, phases, launches, snapshot
publish seconds, host peak RSS, card memory; the bytes an eviction
freed; the burst; the close) lines,
a ``{"kernels": [...]}`` line
(the sparse row also carries the listing kernel's time and launches),
and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import ast
import contextlib
import json
import os
import re
import shutil
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


def xml_reader_documents() -> dict:
    """The OFN, RDF/XML and OWL/XML serializations of one ontology in
    ``tests/test_xml_readers.py``, read off its source (the test module
    imports the JAX package, so it is not imported here)."""
    tree = ast.parse((ROOT / "tests" / "test_xml_readers.py").read_text())
    names: dict = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("EX", "OFN", "RDFXML", "OWLXML")):
            code = compile(ast.Expression(node.value), "test_xml_readers", "eval")
            names[node.targets[0].id] = eval(code, {}, dict(names))
    return names


def x_major_equal(a, b, n: int, nl: int) -> bool:
    """Whether two results hold the same S and R over the live concepts
    (x < n) and links (l < nl), padding left out."""
    return bool(np.array_equal(a.s[:n, :n], b.s[:n, :n])
                and np.array_equal(a.r[:n, :nl], b.r[:n, :nl]))


def el_part_as_ofn(onto) -> str:
    """The ontology's EL part (``strip_non_el``) as OFN text.  The
    writer leaves relative IRIs (``#advisor``: LUBM's ``rdf:ID``s
    without an ``xml:base``) bare, which OFN cannot read back, so they
    are bracketed (``<#advisor>``, the same IRI)."""
    from distel_tpu_torch.frontend.ontology_tools import strip_non_el
    from distel_tpu_torch.owl import writer

    text = writer.ontology_to_str(strip_non_el(onto))
    return re.sub(r"(?<=[ (])#([^\s()]+)", r"<#\1>", text)


def phase_xml_corpora() -> dict:
    """RDF/XML and OWL/XML on the card: the two real corpora of
    ``tests/corpora`` and the readers' serializations through the
    default classify (the Python plane reads XML), each against the card
    run of its EL part (``strip_non_el``) written as OFN: the same ids,
    S and R, derivations and taxonomy; the readers' three serializations
    give one taxonomy; the profile check reports LUBM's dropped
    inverses."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.profile_checker import check_profile
    from distel_tpu_torch.owl import loader
    from distel_tpu_torch.runtime.classifier import ELClassifier

    docs = xml_reader_documents()
    corpora = ROOT / "tests" / "corpora"
    inputs = {
        "galen_module_jia": (corpora / "galen_module_jia.owl").read_text(encoding="utf-8-sig"),
        "lubm_univ_bench": (corpora / "lubm_univ_bench.owl").read_text(encoding="utf-8-sig"),
        "readers_rdfxml": docs["RDFXML"],
        "readers_owlxml": docs["OWLXML"],
    }
    xml = ELClassifier(device="cuda")
    ofn = ELClassifier(ClassifierConfig(use_native_loader=False), device="cuda")
    out, taxes = {}, {}
    for name, text in inputs.items():
        onto = loader.load(text)
        kept, removed = check_profile(onto)
        sync()
        t0 = time.perf_counter()
        got = xml.classify_text(text)
        wall = time.perf_counter() - t0
        if got.norm is None or "parse" not in got.timer.phases:
            raise AssertionError(f"xml {name}: did not go through the Python plane")
        want = ofn.classify_text(el_part_as_ofn(onto))
        idx = got.idx
        if idx.concept_names != want.idx.concept_names:
            raise AssertionError(f"xml {name}: the OFN text indexes other concepts")
        if not x_major_equal(got.result, want.result, idx.n_concepts, idx.n_links):
            raise AssertionError(f"xml {name}: S/R differ from the OFN run")
        if got.result.derivations != want.result.derivations:
            raise AssertionError(f"xml {name}: derivations differ from the OFN run")
        if taxonomy_key(got.taxonomy) != taxonomy_key(want.taxonomy):
            raise AssertionError(f"xml {name}: taxonomy differs from the OFN run")
        taxes[name] = got.taxonomy
        out[name] = {
            "format": loader.detect_format(text), "axioms": len(onto),
            "in_profile": kept, "removed": dict(removed),
            "concepts": idx.n_concepts, "links": idx.n_links,
            "iterations": got.result.iterations,
            "derivations": got.result.derivations,
            "wall_s": wall, "phases_ms": got.summary()["phases_ms"],
        }
    if out["lubm_univ_bench"]["removed"] != {"InverseObjectProperties": 2}:
        raise AssertionError(f"xml lubm: profile check reports {out['lubm_univ_bench']['removed']}")
    native = xml.classify_text(docs["OFN"])
    for name in ("readers_rdfxml", "readers_owlxml"):
        if (taxes[name].parents, taxes[name].equivalents) != (
                native.taxonomy.parents, native.taxonomy.equivalents):
            raise AssertionError(f"xml {name}: taxonomy differs from the OFN fixture's")
    log(f"[xml] {json.dumps(out)}")
    print(json.dumps({"xml_corpora": out}), flush=True)
    return out


def phase_hybrid(row_run) -> dict:
    """``backend.CRn = host`` at 8k on the card: CR5, and CR1 with CR6,
    routed to the host through the hybrid saturator; the same S, R,
    derivations and taxonomy as the all-device card run."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.hybrid import HybridSaturator
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=8000, seed=42)
    idx = row_run.idx
    out = {}
    for routed in ({"CR5": "host"}, {"CR1": "host", "CR6": "host"}):
        what = "+".join(sorted(routed))
        reset_launches()
        sync()
        t0 = time.perf_counter()
        res = ELClassifier(ClassifierConfig(rule_backends=routed),
                           device="cuda").classify_text(text)
        wall = time.perf_counter() - t0
        if not isinstance(res.engine, HybridSaturator):
            raise AssertionError(f"hybrid {what}: no hybrid saturator ran")
        if res.idx.concept_names != idx.concept_names:
            raise AssertionError(f"hybrid {what}: another index")
        if not x_major_equal(res.result, row_run.result, idx.n_concepts, idx.n_links):
            raise AssertionError(f"hybrid {what}: S/R differ from the all-device run")
        if res.result.derivations != row_run.result.derivations:
            raise AssertionError(f"hybrid {what}: derivations differ")
        if taxonomy_key(res.taxonomy) != taxonomy_key(row_run.taxonomy):
            raise AssertionError(f"hybrid {what}: taxonomy differs")
        out[what] = {
            "host_rules": sorted(res.engine.host_rules),
            "iterations": res.result.iterations,
            "derivations": res.result.derivations,
            "wall_s": wall, "phases_ms": res.summary()["phases_ms"],
            "launches": dict(LAUNCHES),
        }
    out["all_device_iterations"] = row_run.result.iterations
    log(f"[8k hybrid] {json.dumps(out)}")
    print(json.dumps({"hybrid": out}), flush=True)
    return out


#: the weak-scaling corpus: the OpenGALEN module (RDF/XML) in this many
#: renamed copies, neighbours crossed, and what its index must hold
MULTIPLY_COPIES = 600
MULTIPLIED_EXPECT = {"concepts": 88802, "links": 22800, "classes": 59402}


def device_bytes(engine) -> dict:
    """Bytes of the card tensors an engine holds, by attribute (a chunk
    list's and the live-tile schedule's by field), each storage once."""
    seen_storage, seen_obj = set(), set()

    def walk(x) -> int:
        if isinstance(x, torch.Tensor):
            if x.device.type != "cuda":
                return 0
            st = x.untyped_storage()
            if st.data_ptr() in seen_storage:
                return 0
            seen_storage.add(st.data_ptr())
            return st.nbytes()
        if id(x) in seen_obj or isinstance(x, (str, bytes, int, float, np.ndarray)):
            return 0
        seen_obj.add(id(x))
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return walk(vars(x)) if hasattr(x, "__dict__") else 0

    out = {}
    for name, val in vars(engine).items():
        if name == "idx":
            continue
        if isinstance(val, list) and val and hasattr(val[0], "_fields"):
            for f in val[0]._fields:
                out[f"{name}.{f}"] = sum(walk(getattr(c, f)) for c in val)
        elif name == "_t6" and val is not None:
            for k, v in val.items():
                out[f"_t6.{k}"] = walk(v)
        else:
            out[name] = walk(val)
    return {k: v for k, v in out.items() if v}


def memory_split(engine, result) -> dict:
    """How a row-packed engine's peak splits: the plan's tables (by
    attribute), the closure's packed state, and what one more
    saturation allocates on top of both (its state, the deferred write
    groups and the other temporaries), from a plain rerun."""
    plan = device_bytes(engine)
    state = sum(t.untyped_storage().nbytes()
                for t in (result.packed_s, result.packed_r))
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    again = engine.saturate()
    sync()
    transient = torch.cuda.max_memory_allocated() - base
    del again
    masks = sum(v for k, v in plan.items() if k.endswith(".mask"))
    return {"plan_bytes": plan, "plan_total": sum(plan.values()),
            "mask_tables": masks, "state": state,
            "saturate_peak_over_held": transient}


def phase_multiplied_full_width(cap: Capture):
    """The reference's weak-scaling pipeline at full width: the GALEN
    module read through the RDF/XML reader, ``multiply_ontology(600,
    crossed=True)``, written as OFN, then the default classify on the
    card (the native load plane, the gated row-packed engine) with
    nothing hooked in; held against the Python-plane card run of the
    same text (taxonomy by name, derivations).  Then how each plane's
    peak memory splits, and a captured saturate-and-taxonomy rerun of
    each plane's engine: every operand pair captured there is checked
    (both routes and the listing against the plain versions, bit for
    bit); the pairs are returned for the kernel line."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import multiply_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.owl import rdfxml, writer
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    t0 = time.perf_counter()
    galen = rdfxml.parse_file(str(ROOT / "tests" / "corpora" / "galen_module_jia.owl"))
    onto = multiply_ontology(galen, MULTIPLY_COPIES, crossed=True)
    text = writer.ontology_to_str(onto)
    build_s = time.perf_counter() - t0
    clf = ELClassifier(device="cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t0 = time.perf_counter()
    res = clf.classify_text(text)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    eng = res.engine
    got = {"concepts": res.idx.n_concepts, "links": res.idx.n_links,
           "classes": len(res.idx.original_classes)}
    py_clf = ELClassifier(ClassifierConfig(use_native_loader=False), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    py = py_clf.classify_text(text)
    py_wall = time.perf_counter() - t0
    py_peak = torch.cuda.max_memory_allocated()
    split = {"native": memory_split(eng, res.result),
             "python": memory_split(py.engine, py.result)}
    for run, r in (("multiplied", res), ("multiplied:python", py)):
        cap.run = run
        with cap:
            again = r.engine.saturate()
            tax = extract_taxonomy(again)
        for x, y in zip(again.wire(), r.result.wire()):
            if not np.array_equal(x, y):
                raise AssertionError(f"{run}: the captured rerun gave another closure")
        if taxonomy_key(tax) != taxonomy_key(r.taxonomy):
            raise AssertionError(f"{run}: the captured rerun gave another taxonomy")
        del again, tax
    pairs = []
    for key in sorted(k for k in cap.pairs if k[0].startswith("multiplied")):
        n, _nnz, a, b = cap.pairs.pop(key)
        pairs.append(check_pair(*key[:3], n, a, b))
    stats = {
        **res.summary(),
        "copies": MULTIPLY_COPIES,
        "axioms": len(onto),
        "ofn_bytes": len(text.encode()),
        "corpus_build_s": build_s,
        "wall_s": wall,
        "unroll": eng.unroll,
        "rounds": len(eng.gate_rounds),
        "windows": eng.gate_totals(),
        "windows_per_round": gate_rounds_compact(eng),
        "launches": launches,
        "max_memory_allocated": peak,
        "memory_split": split,
        "plan": eng.plan_stats(),
        "index": got,
        "classes_in_taxonomy": len(res.taxonomy.parents),
        "python_plane": {
            "wall_s": py_wall, "phases_ms": py.summary()["phases_ms"],
            "max_memory_allocated": py_peak,
            "cr6_tiles": py.engine.plan_stats()["cr6_tiles"],
            "cr6_row_tiles": py.engine.plan_stats()["cr6_row_tiles"],
            "iterations": py.result.iterations,
            "derivations": py.result.derivations,
        },
        "kernel_checks": [
            {k: p[k] for k in ("run", "site", "main_path_kernel", "launches",
                               "shape", "max_abs_err")}
            for p in pairs
        ],
    }
    log(f"[multiplied] {json.dumps(stats)}")
    print(json.dumps({"multiplied_full_width": stats}), flush=True)
    if got != MULTIPLIED_EXPECT:
        raise AssertionError(f"multiplied: index {got}, expected {MULTIPLIED_EXPECT}")
    if "load(native)" not in res.timer.phases:
        raise AssertionError("multiplied: the default classify did not run the native plane")
    if not res.result.converged:
        raise AssertionError("multiplied: did not converge")
    for k in path_kernels(eng._plans.values()):
        if launches[k] == 0:
            raise AssertionError(f"multiplied: {k} was never launched")
    for run, e in (("multiplied", eng), ("multiplied:python", py.engine)):
        sites = {p["site"] for p in pairs if p["run"] == run}
        want = {"taxonomy", "cr6_tiles" if e._t6 is not None else "cr6_windows"}
        if e._chunks4:
            want.add("cr4")
        if not want <= sites:
            raise AssertionError(f"{run}: no operand captured at {sorted(want - sites)}")
    if py.result.derivations != res.result.derivations:
        raise AssertionError("multiplied: the load planes give other derivation counts")
    if taxonomy_key(py.taxonomy) != taxonomy_key(res.taxonomy):
        raise AssertionError("multiplied: the load planes give other taxonomies")
    log("[multiplied] native and python load planes: same derivations and taxonomy")
    return pairs


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
    and copies slow the run it watches, so no measured run has one (bar
    the serve phase, whose requests it watches as they are served).
    The bookkeeping is locked: the serve plane launches from its
    scheduler's worker threads."""

    def __init__(self):
        import threading

        from distel_tpu_torch.ops import bitmatmul

        self.mod = bitmatmul
        self._lock = threading.Lock()
        self.run = ""
        #: None, or engine -> label: the call site is then keyed
        #: ``site:label`` by the engine that launched
        self.kind = None
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
                if cap.kind is not None:
                    site = f"{site}:{cap.kind(f.f_locals.get('self'))}"
            kern = "packed_cols_sparse" if plan.skip_zero_tiles else "packed_cols_dense"
            work = plan.m * plan.l * plan.w
            key = (cap.run, site, kern, work.bit_length())
            nnz = int(torch.count_nonzero(a))
            with cap._lock:
                got = cap.pairs.setdefault(key, [0, -1, None, None])
                got[0] += 1
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


def chosen_kernels(engine) -> list:
    """The packed-columns kernels of the routes a row-packed engine's
    plans chose (the sparse route is the listing and the sparse kernel)."""
    routes = {p.skip_zero_tiles for p in engine._plans.values()}
    return (["packed_cols_list", "packed_cols_sparse"] if True in routes else []) \
        + (["packed_cols_dense"] if False in routes else [])


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
    n_rounds = len(gated.gate_rounds)
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
        "unroll": gated.unroll,
        "rounds": n_rounds,
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


def phase_kernel_line(launches, cap: Capture, checked=()):
    """Every captured pair with both routes (``checked``: pairs already
    checked), the per-site policy, then one row per kernel.  A row's
    numbers are its kernel's at the heaviest pair (most word-ANDs) that
    the 64k main path sent to it (for a kernel the path did not choose,
    the heaviest 64k pair); its ``max_abs_err`` is over every pair."""
    pairs = list(checked)
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


# ------------------------------------------------------ the incremental plane

#: the reference bench's incremental traffic (``bench.py:1293-1382``): a
#: 100-axiom class-only delta, a role-introducing delta (a new subrole,
#: 50 property assertions over it, an ∃-on-the-left axiom), and a
#: closure-changing delta between two base roles
INC_CLASS_DELTA = "\n".join(f"SubClassOf(BenchDelta{i} Find{i * 7})" for i in range(100))
INC_ROLE_DELTA = (
    "SubObjectPropertyOf(benchNewRole attr0)\n"
    + "\n".join(
        f"SubClassOf(BenchR{i} ObjectSomeValuesFrom(benchNewRole Find{i * 11}))"
        for i in range(50)
    )
    + "\nSubClassOf(ObjectSomeValuesFrom(benchNewRole Find11) BenchRoleHit)"
)
INC_CLOSURE_DELTA = "SubObjectPropertyOf(attr7 attr8)"
SNAPSHOT_DIR = ROOT / "build" / "smoke"


def named_closure_equal(a, b, block: int = 1024) -> bool:
    """Whether two row-packed results hold the same subsumptions between
    named classes, matched by name (the two indexes may number them
    differently): S rows of named subsumers unpacked on the card in
    blocks, restricted to named columns, in one name order."""
    from distel_tpu_torch.ops.bitpack import unpack_words

    ia, ib = a.idx, b.idx
    names = sorted(ia.concept_names[i] for i in ia.original_classes)
    if names != sorted(ib.concept_names[i] for i in ib.original_classes):
        return False
    ids = [
        torch.as_tensor([idx.concept_ids[n] for n in names], device=res.packed_s.device)
        for idx, res in ((ia, a), (ib, b))
    ]
    for i0 in range(0, len(names), block):
        rows = []
        for res, idv in zip((a, b), ids):
            r = unpack_words(res.packed_s[idv[i0 : i0 + block]], res.packed_s.shape[1] * 32)
            rows.append(r[:, idv])
        if not torch.equal(rows[0], rows[1]):
            return False
    return True


class HostPeak:
    """The process's peak resident memory while active, sampled from
    ``/proc/self/statm`` every 20 ms by a thread."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def poll():
            while True:
                with open("/proc/self/statm") as f:
                    self.peak = max(self.peak, int(f.read().split()[1]) * page)
                if self._stop.wait(0.02):
                    return

        self._thread = threading.Thread(target=poll, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def without_ranges(text: str) -> str:
    """``text`` without its ``ObjectPropertyRange`` axioms: with range
    elimination active, retraction is refused (the reference's rule:
    range retrofits attribute rows of old texts to later batches), so
    the retraction runs over this variant of a corpus."""
    return "\n".join(
        ln for ln in text.splitlines() if not ln.startswith("ObjectPropertyRange(")
    ) + "\n"


def incremental_steps(text: str):
    """The bench's sequence over ``text``: (op, text) in order."""
    return [("add", text), ("add", INC_CLASS_DELTA), ("add", INC_ROLE_DELTA),
            ("add", INC_CLOSURE_DELTA), ("retract", INC_CLASS_DELTA)]


def phase_incremental_card_vs_cpu() -> dict:
    """The bench's incremental traffic over the 8k corpus (without its
    one range axiom, so that the retraction is not refused), the default
    config (the fast path engages above 2,048 concepts), on the card and
    on the CPU: after every increment, the retraction and a restore from
    a snapshot (with the retraction marker in the op log), the packed S
    and R byte-identical and the history records equal."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology

    text = without_ranges(snomed_shaped_ontology(n_classes=8000, seed=42))
    steps = incremental_steps(text)
    log_ops = [t for _op, t in steps[:-1]] + [{"op": "retract", "text": INC_CLASS_DELTA}]
    SNAPSHOT_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        inc = IncrementalClassifier(device=dev)
        wires = []
        for op, t in steps:
            res = inc.add_text(t) if op == "add" else inc.retract(t)
            wires.append(res.wire())
        path = str(SNAPSHOT_DIR / f"inc8k-{dev}.npz")
        inc.snapshot(path, compressed=False)
        back = IncrementalClassifier.restore(log_ops, path, device=dev)
        wires.append(back.last_result.wire())
        runs[dev] = (inc.history + back.history[-1:], wires, time.perf_counter() - t0)
        del inc, back, res
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    (hc, wc, tc), (hp, wp, tp) = runs["cuda"], runs["cpu"]
    for i, (x, y) in enumerate(zip(wc, wp)):
        if not all(np.array_equal(u, v) for u, v in zip(x, y)):
            raise AssertionError(f"incremental 8k: step {i}: packed S/R differ card/cpu")
    strip = [{k: v for k, v in h.items() if k != "restored_from"} for h in hc]
    if strip != [{k: v for k, v in h.items() if k != "restored_from"} for h in hp]:
        raise AssertionError(f"incremental 8k: histories differ: {hc} / {hp}")
    paths = [h["path"] for h in hc]
    if paths[:3] != ["rebuild", "fast", "fast"] or paths[4:] != ["retract", "restore"]:
        raise AssertionError(f"incremental 8k: paths {paths}")
    if hc[-1]["new_derivations"] != 0:
        raise AssertionError("incremental 8k: the restore derived something")
    out = {"history": hc, "cuda_s": tc, "cpu_s": tp}
    log(f"[incremental 8k] {json.dumps(out)}")
    print(json.dumps({"incremental_card_vs_cpu": out}), flush=True)
    return out


def phase_incremental_full_width(cap: Capture):
    """The incremental plane at full width: the bench's traffic over the
    64k corpus with the default config and nothing hooked in — base
    (rebuild), class-only delta (fast), role delta (fast, with a cross
    engine), closure delta (fast through the rebind, or rebuild), each
    held to a from-scratch card classify of the texts so far; the
    class-only delta retracted (held to a classify of the survivors);
    a snapshot restored through the op log (one quiet group, the same
    closure); a second classifier's forced rebuild of the class-only
    delta.  Then the delta, cross and rebound-base engines rerun under
    the capture; the heaviest operand pair per site, engine and kernel
    is checked bit for bit and returned for the kernel line."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    text = snomed_shaped_ontology(n_classes=64000, seed=42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    inc = IncrementalClassifier(device="cuda")
    records = []

    def step(name, fn, paths):
        """``fn() -> (result, classifier)``, timed and recorded."""
        reset_launches()
        sync()
        t0 = time.perf_counter()
        with HostPeak() as hp:
            res, who = fn()
            sync()
        wall = time.perf_counter() - t0
        h = who.history[-1]
        rec = {"step": name, **{k: h[k] for k in h if k != "restored_from"},
               "wall_s": wall, "phases_s": who.last_phases,
               "launches": dict(LAUNCHES), "host_peak_rss": hp.peak,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        log(f"[incremental 64k] {json.dumps(rec)}")
        records.append(rec)
        if h["path"] not in paths:
            raise AssertionError(f"incremental 64k {name}: path {h['path']}, want {paths}")
        # every step's first round runs every window of the base engine,
        # so each route its plans chose must have launched in the step
        for k in chosen_kernels(who._base_engine):
            if rec["launches"][k] == 0:
                raise AssertionError(f"incremental 64k {name}: {k} was never launched")
        return res

    def check(res, texts, what):
        t0 = time.perf_counter()
        batch = ELClassifier(device="cuda").classify_text("\n".join(texts) + "\n")
        if taxonomy_key(extract_taxonomy(res)) != taxonomy_key(batch.taxonomy):
            raise AssertionError(f"incremental 64k {what}: taxonomy differs from a classify")
        if not named_closure_equal(res, batch.result):
            raise AssertionError(f"incremental 64k {what}: named subsumers differ")
        log(f"[incremental 64k] {what}: equal to a from-scratch classify "
            f"({time.perf_counter() - t0:.1f} s)")

    step("base", lambda: (inc.add_text(text), inc), {"rebuild"})
    r1 = step("class_only", lambda: (inc.add_text(INC_CLASS_DELTA), inc), {"fast"})
    check(r1, [text, INC_CLASS_DELTA], "class-only delta")
    r2 = step("role", lambda: (inc.add_text(INC_ROLE_DELTA), inc), {"fast"})
    if inc.history[-1]["delta_programs"] != 2:
        raise AssertionError("incremental 64k: the role delta ran without a cross engine")
    check(r2, [text, INC_CLASS_DELTA, INC_ROLE_DELTA], "role delta")
    del r2
    base_before = inc._base_engine
    r3 = step("closure", lambda: (inc.add_text(INC_CLOSURE_DELTA), inc),
              {"fast", "rebuild"})
    closure_path = inc.history[-1]["path"]
    rebound = inc._base_engine is base_before and closure_path == "fast"
    del base_before
    check(r3, [text, INC_CLASS_DELTA, INC_ROLE_DELTA, INC_CLOSURE_DELTA], "closure delta")
    del r3
    # the corpus has a range axiom: the reference refuses the retraction,
    # leaving the classifier untouched, and so must the port
    from distel_tpu_torch.core.retract import EntangledRetraction

    n_hist, last = len(inc.history), inc.last_result
    try:
        inc.retract(INC_CLASS_DELTA)
    except EntangledRetraction:
        pass
    else:
        raise AssertionError("incremental 64k: retraction under a range axiom ran")
    if len(inc.history) != n_hist or inc.last_result is not last:
        raise AssertionError("incremental 64k: a refused retraction changed the classifier")
    del inc, last
    torch.cuda.empty_cache()
    # the same traffic over the corpus without its range axiom, retracted
    text_nr = without_ranges(text)
    inc = IncrementalClassifier(device="cuda")
    for name, t in (("base", text_nr), ("class_only", INC_CLASS_DELTA),
                    ("role", INC_ROLE_DELTA), ("closure", INC_CLOSURE_DELTA)):
        step(f"{name}:no_range", lambda t=t: (inc.add_text(t), inc),
             {"rebuild"} if name == "base" else {"fast", "rebuild"})
    survivors = [text_nr, INC_ROLE_DELTA, INC_CLOSURE_DELTA]
    r4 = step("retract:no_range", lambda: (inc.retract(INC_CLASS_DELTA), inc),
              {"retract"})
    check(r4, survivors, "retraction")
    SNAPSHOT_DIR.mkdir(parents=True, exist_ok=True)
    path = str(SNAPSHOT_DIR / "inc64k.npz")
    sync()
    t0 = time.perf_counter()
    inc.snapshot(path, compressed=False)
    snapshot_s = time.perf_counter() - t0
    ops = [text_nr, INC_CLASS_DELTA, INC_ROLE_DELTA, INC_CLOSURE_DELTA,
           {"op": "retract", "text": INC_CLASS_DELTA}]

    made = []

    def restore():
        made.append(IncrementalClassifier.restore(ops, path, device="cuda"))
        return made[0].last_result, made[0]

    r5 = step("restore", restore, {"restore"})
    back = made.pop()
    if r5.iterations != back._base_engine.unroll or r5.derivations != 0:
        raise AssertionError("incremental 64k: the restore was not one quiet group")
    if not all(np.array_equal(x, y) for x, y in zip(r5.wire(), r4.wire())):
        raise AssertionError("incremental 64k: the restored closure differs")
    del back, r5, r4, inc
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    inc2 = IncrementalClassifier(device="cuda")
    inc2.add_text(text)
    inc2.drop_base_program()
    r6 = step("class_only_rebuild",
              lambda: (inc2.add_text(INC_CLASS_DELTA), inc2), {"rebuild"})
    if not named_closure_equal(r6, r1) or \
            taxonomy_key(extract_taxonomy(r6)) != taxonomy_key(extract_taxonomy(r1)):
        raise AssertionError("incremental 64k: the forced rebuild gave another closure")
    peak = torch.cuda.max_memory_allocated()
    del inc2, r6, r1
    torch.cuda.empty_cache()
    # the delta, cross and rebound-base engines again, under the capture
    inc3 = IncrementalClassifier(device="cuda")
    inc3.add_text(text)
    base3 = inc3._base_engine

    def kind(eng):
        """Which engine launched: the reused base, a cross or delta
        engine, or a rebuild's engine (which alone reserves window
        slots besides the base)."""
        if eng is None:
            return "taxonomy"
        if eng is base3:
            return "base"
        if eng._link_window is not None:
            return "cross"
        return "rebuild" if eng._window_headroom else "delta"

    cap.kind = kind
    try:
        for name, delta in (("class_only", INC_CLASS_DELTA), ("role", INC_ROLE_DELTA),
                            ("closure", INC_CLOSURE_DELTA)):
            cap.run = f"incremental:{name}"
            with cap:
                inc3.add_text(delta)
    finally:
        cap.kind = None
    cap_paths = [h["path"] for h in inc3.history]
    del inc3, base3
    torch.cuda.empty_cache()
    # the heaviest pair per step, site (with engine) and kernel (when the
    # rebind fits, the closure step's base pairs are the rebound base's)
    heaviest = {}
    for key in [k for k in cap.pairs if k[0].startswith("incremental")]:
        n, nnz, a, b = cap.pairs.pop(key)
        got = heaviest.setdefault(key[:3], [0, -1, None, None])
        got[0] += n
        if nnz > got[1]:
            got[1:] = [nnz, a, b]
    pairs = [check_pair(*key, n, a, b)
             for key, (n, _nnz, a, b) in sorted(heaviest.items())]
    sites = {p["site"] for p in pairs}
    for want in ("cr4:delta", "cr4:cross", "cr4:base"):
        if want not in sites:
            raise AssertionError(f"incremental 64k: no {want} operand was captured")
    retract_rec = next(r for r in records if r["step"].startswith("retract"))
    out = {
        "steps": records,
        "closure_delta_path": closure_path,
        "closure_delta_rebound": rebound,
        "snapshot_s": snapshot_s,
        "retract_overdelete_s": retract_rec["phases_s"]["overdelete"],
        "retract_host_peak_rss": retract_rec["host_peak_rss"],
        "max_memory_allocated": peak,
        "memory_allocated_before": held,
        "captured_paths": cap_paths,
        "kernel_checks": [{k: p[k] for k in ("run", "site", "main_path_kernel", "shape",
                                             "launches", "max_abs_err")} for p in pairs],
    }
    log(f"[incremental 64k] {json.dumps(out)}")
    print(json.dumps({"incremental_full_width": out}), flush=True)
    return pairs


# ------------------------------------------------------- the serve plane

#: answer fields that are clock readings (taken out before comparing)
SERVE_CLOCK_KEYS = ("published_unix",)
TRACE_FILE = ROOT / "traces" / "mixed_add_retract_query.jsonl"
SERVE_DIR = ROOT / "build" / "smoke_serve"


def serve_call(app, method, path, query=None, text=None):
    """One request through ``ServeApp.dispatch``: ``(status, answer)``,
    the answer without its clock readings (an error's message for a
    refused request)."""
    from distel_tpu_torch.serve.server import HTTPError

    body = json.dumps({"text": text}).encode() if text is not None else b""
    try:
        status, _ctype, payload = app.dispatch(method, path, query or {}, body, None)
    except HTTPError as e:
        return e.status, e.message
    doc = json.loads(payload)
    for k in SERVE_CLOCK_KEYS:
        doc.pop(k, None)
    return status, doc


def serve_reads(app, oid, cls, sub, sup):
    """The reads after a write: the taxonomy and subsumers on the
    scheduler lane, then every snapshot-plane read."""
    base = f"/v1/ontologies/{oid}"
    return [
        serve_call(app, "GET", base + "/taxonomy"),
        serve_call(app, "GET", base + "/subsumers", {"class": sub}),
        serve_call(app, "GET", base + "/query/subsumed", {"sub": sub, "sup": sup}),
        serve_call(app, "GET", base + "/query/subsumers", {"class": cls}),
        serve_call(app, "GET", base + "/query/slice", {"class": cls}),
        serve_call(app, "GET", base + "/query/version"),
    ]


def serve_steps(app, text):
    """The bench's traffic through one app: load, the three deltas and
    the retraction of the class-only delta, each followed by the reads;
    every answer in order."""
    out = []
    status, rec = serve_call(app, "POST", "/v1/ontologies", text=text)
    out.append((status, rec))
    oid = rec["id"]
    reads = ("Find7", "BenchDelta3", "Find21")
    out += serve_reads(app, oid, *reads)
    for op, t in incremental_steps(text)[1:]:
        what = "deltas" if op == "add" else "retract"
        out.append(serve_call(app, "POST", f"/v1/ontologies/{oid}/{what}", text=t))
        out += serve_reads(app, oid, *reads)
    return out


class RecordingClient:
    """A ``ServeClient`` whose request calls keep every answer, in order
    (a trace replay returns only counts)."""

    CALLS = ("load", "delta", "retract", "taxonomy", "subsumers",
             "query_subsumers", "snapshot_version")

    def __init__(self, url):
        from distel_tpu_torch.serve.client import ServeClient

        self.client = ServeClient(url, timeout=600)
        self.answers = []

    def __getattr__(self, name):
        fn = getattr(self.client, name)
        if name not in self.CALLS:
            return fn

        def call(*a, **kw):
            doc = fn(*a, **kw)
            self.answers.append((name, {k: v for k, v in doc.items()
                                        if k not in SERVE_CLOCK_KEYS}))
            return doc

        return call


@contextlib.contextmanager
def http_serving(app):
    """``app`` behind ``make_server`` on an ephemeral loopback port;
    yields its base url; shuts the server down (the app stays open)."""
    import threading

    from distel_tpu_torch.serve.server import make_server

    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)


def replay_answers(app):
    """The tracked mixed trace replayed against ``app`` over loopback
    HTTP: the replay record and every answer."""
    from distel_tpu_torch.serve.traces import load_trace, replay_trace

    with http_serving(app) as url:
        client = RecordingClient(url)
        rec = replay_trace(load_trace(str(TRACE_FILE)), client)
    rec.pop("wall_s")
    return rec, client.answers


def phase_serve_card_vs_cpu() -> dict:
    """The serve plane on the card and on the CPU: ``ServeApp()`` (the
    card by default) and ``ServeApp(device="cpu")`` driven through
    ``dispatch`` with the bench's traffic over the 8k corpus without its
    range axiom (load, the three deltas, the retraction; the scheduled
    and snapshot reads after each write), every answer equal; then the
    tracked mixed trace replayed over loopback HTTP against a card and a
    CPU server, and again with ``engine = packed``, whose card app then
    also serves the 8k corpus and the class-only delta — every answer
    equal.  Launch counts are zeroed just before each card app's traffic
    and read just after."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.serve.server import ServeApp

    from distel_tpu_torch.runtime.classifier import resolve_device

    text8 = snomed_shaped_ontology(n_classes=8000, seed=42)
    text = without_ranges(text8)
    out, answers = {}, {}
    for dev in ("cuda", "cpu"):
        app = ServeApp() if dev == "cuda" else ServeApp(device="cpu")
        if app.registry.device != resolve_device(dev):
            raise AssertionError(f"serve 8k: ServeApp runs on {app.registry.device}")
        reset_launches()
        t0 = time.perf_counter()
        answers[dev] = serve_steps(app, text)
        sync()
        out[f"{dev}_s"] = time.perf_counter() - t0
        if dev == "cuda":
            out["launches"] = dict(LAUNCHES)
            out["chosen"] = chosen_kernels(
                app.registry.classifier("ont-0001")._base_engine)
        app.close(final_spill=False)
        del app
    torch.cuda.empty_cache()
    for i, (c, p) in enumerate(zip(answers["cuda"], answers["cpu"])):
        if c != p:
            raise AssertionError(f"serve 8k: answer {i} differs card/cpu: "
                                 f"{str(c)[:300]} / {str(p)[:300]}")
    # BenchDelta3 is unknown (404) to the reads naming it before the
    # class-only delta adds it, and to the taxonomy's subsumers after its
    # retraction (the snapshot keeps the retired concept id: its
    # subsumption test answers); 7 answers a write
    refused = {i: st for i, (st, _a) in enumerate(answers["cuda"]) if st not in (200, 201)}
    if len(answers["cuda"]) != len(answers["cpu"]) or \
            refused != {2: 404, 3: 404, 30: 404}:
        raise AssertionError(f"serve 8k: requests refused: {refused}")
    writes = [a for st, a in answers["cuda"] if st in (200, 201) and "path" in a]
    out["paths"] = [w["path"] for w in writes]
    if out["paths"] != ["rebuild", "fast", "fast", "fast", "retract"] and \
            out["paths"] != ["rebuild", "fast", "fast", "rebuild", "retract"]:
        raise AssertionError(f"serve 8k: paths {out['paths']}")
    for k in out["chosen"]:
        if out["launches"][k] == 0:
            raise AssertionError(f"serve 8k: {k} was never launched")
    out["answers"] = len(answers["cuda"])
    # the tracked trace on the card and the CPU; then the card app also
    # serves the 8k corpus and the class-only delta, and the packed
    # engine's answers must equal the row-packed engine's
    tenant = {}
    for engine in ("auto", "packed"):
        runs = {}
        for dev in ("cuda", "cpu"):
            app = ServeApp(ClassifierConfig(engine=engine), device=dev)
            reset_launches()
            t0 = time.perf_counter()
            rec, got = replay_answers(app)
            sync()
            runs[dev] = (rec, got, time.perf_counter() - t0, dict(LAUNCHES))
            if dev == "cuda":
                reset_launches()
                t0 = time.perf_counter()
                st, load = serve_call(app, "POST", "/v1/ontologies", text=text8)
                oid = load["id"]
                ops = [(st, load), serve_call(
                    app, "POST", f"/v1/ontologies/{oid}/deltas", text=INC_CLASS_DELTA)]
                ops += serve_reads(app, oid, "Find7", "BenchDelta3", "Find21")
                sync()
                tenant[engine] = (ops, time.perf_counter() - t0, dict(LAUNCHES))
            app.close(final_spill=False)
            del app
        torch.cuda.empty_cache()
        (rc, gc_, tc, lc), (rp, gp, tp, _lp) = runs["cuda"], runs["cpu"]
        if rc != rp or gc_ != gp:
            bad = next((i for i, (x, y) in enumerate(zip(gc_, gp)) if x != y), None)
            raise AssertionError(f"serve {engine}: the replays differ card/cpu "
                                 f"({rc} / {rp}; first answer {bad})")
        if rc["failed_requests"] or rc["skipped_migrates"] != 1:
            raise AssertionError(f"serve {engine}: replay {rc}")
        out[f"replay_{engine}"] = {"record": rc, "answers": len(gc_),
                                   "cuda_s": tc, "cpu_s": tp, "launches": lc}
        ops, t8, l8 = tenant[engine]
        out[f"tenant8k_{engine}"] = {"wall_s": t8, "launches": l8,
                                     "paths": [a["path"] for _s, a in ops[:2]]}
    # the trace's toy tenants reach the packed-columns kernels through
    # their taxonomy products at least; the packed tenant's CR4/CR6 run
    # the packed-contraction route
    for engine, lc in (("auto", out["replay_auto"]["launches"]),
                       ("packed", out["tenant8k_packed"]["launches"])):
        ran = lc["packed_andor_list"] if engine == "packed" else \
            lc["packed_cols_dense"] + lc["packed_cols_sparse"]
        if ran == 0:
            raise AssertionError(f"serve {engine}: its kernels were never launched")
    # the engines step differently (iterations; the row-packed engine's
    # fast path and its accounting) and pad their packed rows
    # differently (a snapshot's bytes); the answers agree
    engine_keys = ("path", "iterations", "delta_bucketed", "delta_programs",
                   "snapshot_bytes")
    row, packed = ([(st, {k: v for k, v in a.items() if k not in engine_keys})
                    for st, a in tenant[e][0]] for e in ("auto", "packed"))
    if row != packed:
        bad = next(i for i, (x, y) in enumerate(zip(row, packed)) if x != y)
        raise AssertionError(f"serve 8k: the packed engine's answer {bad} differs: "
                             f"{str(packed[bad])[:300]} / {str(row[bad])[:300]}")
    log(f"[serve 8k] {json.dumps(out)}")
    print(json.dumps({"serve_card_vs_cpu": out}), flush=True)
    return out


def publish_seconds(app) -> float:
    """The serve metrics' summed snapshot build-and-swap seconds."""
    for ln in app.metrics.render().splitlines():
        if ln.startswith("distel_query_publish_seconds_sum"):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def phase_serve_full_width(cap: Capture):
    """The resident server at full width: ``ServeApp(device="cuda")``
    behind ``make_server`` on a loopback port, two workers and a spill
    directory, driven over HTTP by ``ServeClient`` under the capture; once
    the 64k tenant's state is known, the card-memory budget is set to its
    bytes (it holds that tenant, not it and a second one together).  The 64k corpus without its range axiom is loaded,
    takes the three deltas and the retraction of the class-only delta;
    after each write every served taxonomy is held, by name, to a
    from-scratch card classify of the accumulated text (and the
    tenant's closure by ``named_closure_equal``), and ``query/subsumers``
    of sampled classes to that taxonomy's subsumers.  The 8k corpus as
    a second tenant evicts the 64k one to the warm tier (it must give
    the card back at least its state's bytes); a scheduled read
    promotes it.  With the warm tier turned off, a read of the 8k tenant
    spills the 64k one cold, and a read of it restores it from the
    spill.  Then one concurrent burst (a delta to one tenant, reads of
    both, one client thread a request; the reads held to the same reads
    served one at a time), and the graceful close with its final spill.
    Per request: the client wall, the tenant's phases, path, iterations,
    launches, host peak RSS and card memory; the snapshot publish
    seconds.  The captured operand pairs are checked as in phase 6 and
    returned for the kernel line."""
    import threading

    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.serve.client import ServeClient
    from distel_tpu_torch.serve.registry import _state_bytes
    from distel_tpu_torch.serve.server import ServeApp

    big = without_ranges(snomed_shaped_ontology(n_classes=64000, seed=42))
    small = snomed_shaped_ontology(n_classes=8000, seed=42)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory = {"before_load": torch.cuda.memory_allocated()}
    # the warm tier holds the whole 64k state on the host (about 1.9 GB)
    cfg = ClassifierConfig(storage_warm_budget_mb=16384)
    app = ServeApp(cfg, device="cuda", workers=2, spill_dir=str(SERVE_DIR),
                   memory_budget_bytes=1 << 40)
    records = []
    rng = np.random.default_rng(0)
    cap.run = "serve"
    with cap, http_serving(app) as url:
        client = ServeClient(url, timeout=1200)

        def history(oid):
            entry = app.registry._entries.get(oid) if oid else None
            inc = entry.inc if entry is not None else None
            return (inc, len(inc.history)) if inc is not None else (None, 0)

        def request(name, oid, fn):
            """One request, timed on the client; the launches, host peak
            RSS and card memory over it; and, where it changed the
            tenant's classifier (a write, a promotion, a restore), the
            new history record and its phases."""
            before = history(oid)
            reset_launches()
            pub0 = publish_seconds(app)
            t0 = time.perf_counter()
            with HostPeak() as hp:
                doc = fn()
            wall = time.perf_counter() - t0
            rec = {"request": name, "wall_s": wall,
                   "launches": dict(LAUNCHES), "host_peak_rss": hp.peak,
                   "memory_allocated": torch.cuda.memory_allocated(),
                   "publish_s": publish_seconds(app) - pub0}
            inc, n = history(oid or doc.get("id"))
            if inc is not None and (inc is not before[0] or n > before[1]):
                h = inc.history[-1]
                rec.update(path=h["path"], iterations=h["iterations"],
                           new_derivations=h["new_derivations"],
                           phases_s=inc.last_phases)
            if isinstance(doc, dict) and "version" in doc:
                rec["version"] = doc["version"]
            log(f"[serve 64k] {json.dumps(rec)}")
            records.append(rec)
            return doc

        def check(oid, texts, what):
            """The served taxonomy and sampled snapshot subsumers against
            a from-scratch card classify of ``texts``."""
            t0 = time.perf_counter()
            served = request(f"taxonomy:{what}", oid, lambda: client.taxonomy(oid))
            batch = ELClassifier(device="cuda").classify_text(
                "\n".join(texts) + "\n")
            tax = batch.taxonomy
            if (served["parents"], served["equivalents"],
                    sorted(served["unsatisfiable"])) != taxonomy_key(tax):
                raise AssertionError(f"serve 64k {what}: taxonomy differs from a classify")
            inc = app.registry._entries[oid].inc
            if not named_closure_equal(inc.last_result, batch.result):
                raise AssertionError(f"serve 64k {what}: named subsumers differ")
            names = sorted(tax.subsumers)
            for cls in rng.choice(names, 24, replace=False).tolist():
                got = client.query_subsumers(oid, cls)["subsumers"]
                if got != tax.subsumers[cls]:
                    raise AssertionError(f"serve 64k {what}: query/subsumers {cls}")
            del batch
            log(f"[serve 64k] {what}: equal to a from-scratch classify "
                f"({time.perf_counter() - t0:.1f} s)")
            return names

        def reads(oid, cls):
            return [client.subsumers(oid, cls), client.query_subsumers(oid, cls),
                    client.taxonomy_slice(oid, cls), client.snapshot_version(oid)]

        a = request("load:64k", None, lambda: client.load(big))["id"]
        memory["after_load"] = torch.cuda.memory_allocated()
        texts = [big]
        check(a, texts, "load")
        for (op, t), name in zip(incremental_steps(big)[1:],
                                 ("delta:class_only", "delta:role", "delta:closure",
                                  "retract:class_only")):
            if op == "add":
                request(name, a, lambda t=t: client.delta(a, t))
                texts.append(t)
            else:
                request(name, a, lambda t=t: client.retract(a, t))
                texts.remove(t)
            check(a, texts, name)
            reads(a, "Find7")
        paths = [r.get("path") for r in records if r["request"].startswith(
            ("load", "delta", "retract"))]
        if paths[:3] != ["rebuild", "fast", "fast"] or paths[4] != "retract" or \
                paths[3] not in ("fast", "rebuild"):
            raise AssertionError(f"serve 64k: write paths {paths}")
        # the writes ran every kernel of the routes the tenant's plans chose
        for k in chosen_kernels(app.registry._entries[a].inc._base_engine):
            if not any(r["launches"][k] for r in records):
                raise AssertionError(f"serve 64k: {k} was never launched")
        # from here the card budget holds the 64k tenant alone
        state_a = _state_bytes(app.registry._entries[a].inc)
        app.registry.memory_budget_bytes = state_a
        memory["before_evict"] = torch.cuda.memory_allocated()
        # round 1: the second tenant evicts the 64k one to the warm tier
        b = request("load:8k", None, lambda: client.load(small))["id"]
        entry_a, entry_b = app.registry._entries[a], app.registry._entries[b]
        if entry_a.inc is not None or entry_a.warm_inc is None:
            raise AssertionError("serve 64k: the 8k load did not demote the 64k tenant")
        sync()
        held_b = sum(device_bytes(entry_b.inc).values())
        memory["after_evict_warm"] = torch.cuda.memory_allocated()
        freed_warm = memory["before_evict"] + held_b - memory["after_evict_warm"]
        if freed_warm < state_a:
            raise AssertionError(f"serve 64k: the warm eviction freed {freed_warm} B "
                                 f"of a {state_a} B state")
        request("promote:64k", a, lambda: client.taxonomy(a))
        memory["after_promote"] = torch.cuda.memory_allocated()
        if entry_a.inc is None or entry_b.inc is not None:
            raise AssertionError("serve 64k: the read did not promote the 64k tenant")
        # round 2: no warm tier; the 8k tenant's read spills the 64k one cold
        app.registry.warm_budget_bytes = 0
        request("promote:8k", b, lambda: client.taxonomy(b))
        sync()
        memory["after_evict_cold"] = torch.cuda.memory_allocated()
        if entry_a.inc is not None or entry_a.warm_inc is not None or not entry_a.spill_path:
            raise AssertionError("serve 64k: the 64k tenant was not spilled cold")
        held_b = sum(device_bytes(entry_b.inc).values())
        freed_cold = memory["after_promote"] + held_b - memory["after_evict_cold"]
        if freed_cold < state_a:
            raise AssertionError(f"serve 64k: the cold spill freed {freed_cold} B "
                                 f"of a {state_a} B state")
        request("restore:64k", a, lambda: client.taxonomy(a))
        memory["after_restore"] = torch.cuda.memory_allocated()
        if records[-1].get("path") != "restore":
            raise AssertionError("serve 64k: the read did not restore the 64k tenant")
        names = check(a, texts, "restore")
        # the burst: both tenants resident, a delta to the 8k one, reads
        app.registry.memory_budget_bytes = 1 << 40
        burst_delta = "\n".join(f"SubClassOf(BurstX{i} Find{i * 3})" for i in range(20))
        classes = rng.choice(names, 12, replace=False).tolist()
        jobs = [("delta", b, None)] + [("read", a, c) for c in classes] + \
            [("taxonomy", a, None), ("read", b, "Find7")]
        got, errors = {}, []

        def send(i, kind, oid, cls):
            try:
                if kind == "delta":
                    got[i] = client.delta(oid, burst_delta)
                elif kind == "taxonomy":
                    got[i] = client.taxonomy(oid)
                else:
                    got[i] = [client.subsumers(oid, cls), client.query_subsumers(oid, cls)]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"{kind} {oid}: {type(e).__name__}: {e}")

        reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i, *j)) for i, j in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
            if th.is_alive():
                raise AssertionError("serve 64k: a burst request never returned")
        burst = {"requests": len(jobs), "wall_s": time.perf_counter() - t0,
                 "launches": dict(LAUNCHES), "delta": {k: got[0].get(k) for k in
                                                     ("path", "iterations", "version")}}
        if errors:
            raise AssertionError(f"serve 64k: burst failures {errors}")
        for i, (kind, oid, cls) in enumerate(jobs):
            if kind == "read" and oid == a:
                if got[i] != [client.subsumers(oid, cls), client.query_subsumers(oid, cls)]:
                    raise AssertionError(f"serve 64k: burst read {cls} differs from serial")
            elif kind == "taxonomy":
                if got[i] != client.taxonomy(oid):
                    raise AssertionError("serve 64k: burst taxonomy differs from serial")
        check(b, [small, burst_delta], "burst delta (8k)")
        log(f"[serve 64k] burst {json.dumps(burst)}")
    cap.run = ""
    t0 = time.perf_counter()
    spilled = app.close()
    close_s = time.perf_counter() - t0
    memory["peak"] = torch.cuda.max_memory_allocated()
    tiers = app.registry.tier_stats()
    flight = [e["kind"] for e in app.flight.events()]
    del app
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    if len(spilled) != 2 or tiers["cold_ontologies"] != 2:
        raise AssertionError(f"serve 64k: close spilled {spilled}, tiers {tiers}")
    pairs = [check_pair(*key[:3], n, a_, b_)
             for key, (n, _nnz, a_, b_) in sorted(cap.pairs.items()) if key[0] == "serve"]
    for key in [k for k in cap.pairs if k[0] == "serve"]:
        del cap.pairs[key]
    if not pairs:
        raise AssertionError("serve 64k: no operand pair was captured")
    out = {
        "requests": records,
        "write_paths": paths,
        "state_bytes_64k": state_a,
        "freed_warm": freed_warm,
        "freed_cold": freed_cold,
        "memory_allocated": memory,
        "burst": burst,
        "close_s": close_s,
        "spilled": [os.path.basename(p) for p in spilled],
        "flight_kinds": sorted(set(flight)),
        "kernel_checks": [{k: p[k] for k in ("run", "site", "main_path_kernel", "shape",
                                             "launches", "max_abs_err")} for p in pairs],
    }
    log(f"[serve 64k] {json.dumps(out)}")
    print(json.dumps({"serve_full_width": out}), flush=True)
    return pairs


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


class Tee:
    """A text stream that writes to two (flushing both)."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def main() -> int:
    # the port first: in a directory without it this fails before any
    # result is printed
    import distel_tpu_torch  # noqa: F401

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py needs one card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    # every result line also to a file: a runner may keep only the tail
    # of standard output
    sys.stdout = Tee(sys.stdout, open(out / "smoke_stdout.txt", "w"))
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
    phase_hybrid(row8k)
    del row8k
    phase_verify()
    phase_xml_corpora()
    phase_incremental_card_vs_cpu()
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
    checked = phase_multiplied_full_width(cap)
    torch.cuda.empty_cache()
    checked += phase_incremental_full_width(cap)
    torch.cuda.empty_cache()
    phase_serve_card_vs_cpu()
    checked += phase_serve_full_width(cap)
    torch.cuda.empty_cache()
    rows, pairs = phase_kernel_line(launches, cap, checked)
    rows.append(andor_row)
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
