#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distel_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. probe and build: the card, its power limit, and the CUDA kernels
   built from ``distel_tpu_torch/ops/csrc`` (timed);
2. kernel vs plain: both packed-columns kernels against their plain
   PyTorch version on unaligned and tile-sparse shapes, bit for bit;
3. golden fixtures: every ``tests/golden/*.ofn`` classified on the card
   must match its ``.expected`` file;
4. card vs CPU: the 8000-class SNOMED-shaped corpus classified on the
   card (with the window CR6, and with the live-tile CR6 forced on) and
   on the CPU gives identical packed S and R, derivation count and
   taxonomy;
5. full width: the 64000-class SNOMED-shaped corpus classified on the
   card to convergence with nothing hooked in, its wall, peak memory
   and the kernels' launch counts read from that run alone (both must
   be > 0); then a profiled rerun (per-rule breakdown), an A/B of the
   tile-skip threshold (saturation with every CR4/CR6 plan on the
   sparse kernel against the shipped choice, A B B A) and a captured
   rerun (operands), all of which must give the same closure;
6. every operand pair captured in phase 4's live-tile run and phase
   5's captured rerun (one per call site and power-of-two work
   bucket): both kernels bit for bit against the
   plain version, each timed beside it and beside the card's bound for
   the same work, the sparse one also split into its live-tile listing
   and the bare kernel.  The pairs go to ``chiprun_out/kernel_pairs.json``.

It prints the card's name and power limit, a ``{"policy": ...}`` line
(each site's device time under the chosen kernel and under each
kernel), a ``{"kernels": [...]}`` line, and as its last line
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
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events,
    after one warm-up)."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


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
    ptxas = Path(build.build_dir()).glob("libpacked_cols-*.so.ptxas.txt")
    for p in ptxas:
        log(p.read_text().strip())
    return name


def check_kernel(a, b, sparse: bool, what: str) -> int:
    """Both kernels are exact: any differing bit fails."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, plain_packed_cols,
    )

    plan = PackedColsMatmulPlan(a.shape[0], a.shape[1], b.shape[1],
                                skip_zero_tiles=sparse)
    got = plan(a, b)
    sync()
    want = plain_packed_cols(a, b)
    diff = int((got != want).sum())
    kern = "packed_cols_sparse" if sparse else "packed_cols_dense"
    if diff:
        raise AssertionError(f"{kern} {what}: {diff} words differ from plain")
    log(f"[kernel] {kern} {what} {tuple(a.shape)}x{tuple(b.shape)}: equal")
    return diff


def random_operands(gen, m, l, w, density, dead_tiles=False):
    a = (torch.rand((m, l), generator=gen, device="cuda") < density).to(torch.int8)
    if dead_tiles:
        # keep ~10% of the 64x32 A tiles alive
        keep = torch.rand((-(-m // 64), -(-l // 32)), generator=gen,
                          device="cuda") < 0.1
        keep = keep.repeat_interleave(64, 0)[:m].repeat_interleave(32, 1)[:, :l]
        a = a * keep.to(torch.int8)
    b = torch.randint(-2**31, 2**31, (l, w), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    return a.contiguous(), b.contiguous()


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for sparse in (False, True):
        for m, l, w, dens, dead in (
            (37, 70, 5, 0.2, False),       # unaligned everywhere
            (1, 1, 1, 1.0, False),
            (300, 1000, 200, 0.05, True),  # most tiles dead
            (513, 257, 129, 0.01, False),  # just past every tile edge
        ):
            a, b = random_operands(gen, m, l, w, dens, dead)
            check_kernel(a, b, sparse, f"random(d={dens}, dead={dead})")
        # all-zero A: every tile dead
        a = torch.zeros((128, 64), dtype=torch.int8, device="cuda")
        b = random_operands(gen, 1, 64, 33, 0.0)[1]
        check_kernel(a, b, sparse, "all-zero A")


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


def phase_golden(device: str = "cuda") -> int:
    from distel_tpu_torch.runtime.classifier import ELClassifier

    fixtures = sorted((ROOT / "tests" / "golden").glob("*.ofn"))
    if len(fixtures) < 20:
        raise AssertionError(f"only {len(fixtures)} golden fixtures found")
    clf = ELClassifier(device=device)
    for path in fixtures:
        expected = load_expected(path.with_suffix(".expected"))
        closure = golden_closure(clf.classify_file(str(path)).result)
        errors = golden_errors(closure, expected)
        if errors:
            raise AssertionError(f"golden {path.stem}: {errors}")
    log(f"[golden] {len(fixtures)} fixtures match on {device}")
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

        def launch(plan, a, b):
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
            return cap._orig(plan, a, b)

        self.mod.PackedColsMatmulPlan._launch = launch
        return self

    def __exit__(self, *exc):
        self.mod.PackedColsMatmulPlan._launch = self._orig


def phase_full_width():
    """The main path at full width, with nothing hooked into it: wall,
    peak memory and launch counts are those of ``cli classify``."""
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
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
    summary = res.summary()
    stats = {
        **summary,
        "wall_s": wall,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "memory_allocated_before": base,
        "launches": launches,
        "plan": res.engine.plan_stats(),
        "classes_in_taxonomy": len(res.taxonomy.parents),
    }
    log(f"[64k] {json.dumps(stats)}")
    print(json.dumps({"full_width": stats}), flush=True)
    if not res.result.converged:
        raise AssertionError("64k run did not converge")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched on the 64k run")
    if len(res.taxonomy.parents) == 0:
        raise AssertionError("64k taxonomy is empty")
    return launches, res


def phase_threshold_ab(res) -> dict:
    """The shipped tile-skip threshold against every CR4 and window-CR6
    plan on the sparse kernel (what the earlier threshold, 2^28, chose
    at 64k): ``saturate()`` on the 64k engine in the order A B B A, host
    wall with the card synchronised.  Every closure must equal the
    first run's."""
    plans = list(res.engine._plans.values())
    shipped = [p.skip_zero_tiles for p in plans]
    walls = {"all_sparse": [], "shipped": []}
    try:
        for what in ("all_sparse", "shipped", "shipped", "all_sparse"):
            for p, chosen in zip(plans, shipped):
                p.skip_zero_tiles = chosen or what == "all_sparse"
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
    """One captured operand pair: both kernels bit for bit against the
    plain version, then their times (CUDA events; the sparse one also
    split into its live-tile listing and the bare kernel), the host wall
    per call, the plain version's time and the bound."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, live_tiles, plain_packed_cols,
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
    if err:
        raise AssertionError(f"{run} {site} {tuple(a.shape)}: {err} words differ")
    lists = live_tiles(a)
    c = torch.empty((m, w), dtype=torch.int32, device="cuda")
    out = {
        "run": run,
        "site": site,
        "main_path_kernel": kern,
        "launches": launches,
        "shape": [m, l, w],
        "a_nonzero_fraction": float((a != 0).float().mean()),
        "live_tile_fraction": float(lists[1].sum()) / max(lists[0].numel(), 1),
        "max_abs_err": err,
        "dense_ms": time_ms(lambda: dense(a, b)),
        "sparse_ms": time_ms(lambda: sparse(a, b)),
        "live_tiles_ms": time_ms(lambda: live_tiles(a)),
        "sparse_kernel_ms": time_ms(lambda: sparse._launch_sparse(a, b, *lists, c)),
        "dense_wall_ms": wall_ms(lambda: dense(a, b)),
        "sparse_wall_ms": wall_ms(lambda: sparse(a, b)),
        "plain_ms": time_ms(lambda: plain_packed_cols(a, b), reps=3),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(a, b)
    log(f"[pair] {json.dumps(out)}")
    return out


def phase_kernel_line(launches, cap: Capture):
    """Every captured pair with both kernels, then one row per kernel.
    A row's numbers are its kernel's at the heaviest pair (most
    word-ANDs) that the 64k main path sent to it."""
    pairs = []
    for (run, site, kern, _bucket) in sorted(cap.pairs):
        n, _nnz, a, b = cap.pairs.pop((run, site, kern, _bucket))
        pairs.append(check_pair(run, site, kern, n, a, b))
    # each site's device time under the kernel the plan chose, and under
    # each kernel for every launch (launch-weighted over the buckets)
    totals = {}
    for p in pairs:
        t = totals.setdefault(f"{p['run']}:{p['site']}", {
            "launches": 0, "chosen_ms": 0.0, "all_dense_ms": 0.0,
            "all_sparse_ms": 0.0,
        })
        t["launches"] += p["launches"]
        chosen = "sparse_ms" if p["main_path_kernel"].endswith("sparse") else "dense_ms"
        t["chosen_ms"] += p["launches"] * p[chosen]
        t["all_dense_ms"] += p["launches"] * p["dense_ms"]
        t["all_sparse_ms"] += p["launches"] * p["sparse_ms"]
    log(f"[policy] {json.dumps(totals)}")
    print(json.dumps({"policy": totals}), flush=True)
    rows = []
    for kern in ("packed_cols_dense", "packed_cols_sparse"):
        mine = [p for p in pairs if p["main_path_kernel"] == kern]
        on_path = [p for p in mine if p["run"] == "64k"] or mine
        top = max(on_path, key=lambda p: p["shape"][0] * p["shape"][1] * p["shape"][2])
        key = "sparse_ms" if kern.endswith("sparse") else "dense_ms"
        rows.append({
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
        })
    return rows, pairs


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
    phase_golden()
    cap = Capture()
    phase_card_vs_cpu(cap)
    launches, res = phase_full_width()
    phase_breakdown(res)
    phase_threshold_ab(res)
    phase_capture_64k(res, cap)
    del res
    torch.cuda.empty_cache()
    rows, pairs = phase_kernel_line(launches, cap)
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
