#!/usr/bin/env python3
"""Compare the port's row-packed fixed point across trees of the repo
on one CUDA card, one tree a process.

    python3 chip_ab.py --tree DIR --label NAME [--pairs DIR]

``DIR`` is the root of a tree of the repo: this checkout (``.``), or an
older commit unpacked with ``git archive`` into a directory that git
ignores.  Its ``distel_tpu_torch`` is imported (its kernels build under
its own ``build/``); the measuring code is this checkout's
``chip_smoke.py``, so every tree is read with one yardstick.  Run it
once a tree, alternating (A B B A), on one card, and compare lines of
one session only.

For the 8000- and 64000-class SNOMED-shaped corpora (seed 42), both
loaded through the Python plane so that every tree contracts the same
index:

* ``classify_text`` with the tree's default engine: wall, phases,
  rounds, derivations, launches, peak memory;
* saturations of that engine again, timed (8k five times, 64k three),
  each closure equal to the first;
* where the tree's engine has the reference's volume threshold for
  role-run chunking (``ROLE_SPLIT_MIN_VOLUME``), the same index through
  an engine with that threshold at 0, so every table chunks at role
  runs and windows cap at the mean role run (the plan of the trees
  before it): its rounds, launches and windows, and saturations timed
  in the order default, role-split, role-split, default;
* at 64k, one more saturation and taxonomy under ``chip_smoke.Capture``:
  the heaviest operand pair of CR4, window CR6 and the taxonomy
  product, each checked bit for bit and timed by ``chip_smoke.check_pair``
  (CUDA events over back-to-back calls).  With ``--pairs``, the CR4 and
  CR6 pairs are saved there as ``NAME.pt``, and every other tree's
  pairs found there are checked and timed too, so a kernel's time on
  one operand can be read in every tree.

Prints the card's name and power limit, then one line ``{"ab": {...}}``.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SIZES = {"8k": (8000, 5), "64k": (64000, 3)}
PAIR_SITES = ("cr4", "cr6_windows")


def _import_tree(tree: Path):
    sys.path.insert(0, str(tree))
    import distel_tpu_torch

    got = Path(distel_tpu_torch.__file__).resolve()
    if tree not in got.parents:
        raise SystemExit(f"imported {got}, not the tree {tree}")
    # this checkout's measuring code, whatever the tree holds
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a.wire(), b.wire()))


def _timed_saturate(engine, want, cs):
    cs.sync()
    t0 = time.perf_counter()
    got = engine.saturate()
    cs.sync()
    wall = time.perf_counter() - t0
    if not _same(got, want):
        raise AssertionError("a rerun gave another closure")
    return wall


def run_size(cs, n_classes: int, reps: int) -> tuple:
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core import rowpacked_engine as rpe
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=n_classes, seed=42)
    cfg = ClassifierConfig()
    if hasattr(cfg, "use_native_loader"):
        cfg.use_native_loader = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    cs.sync()
    t0 = time.perf_counter()
    res = ELClassifier(cfg, device="cuda").classify_text(text)
    cs.sync()
    out = {
        **res.summary(),
        "wall_s": time.perf_counter() - t0,
        "launches": dict(LAUNCHES),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "plan": res.engine.plan_stats(),
    }
    if hasattr(res.engine, "gate_totals"):
        out["windows"] = res.engine.gate_totals()
    out["saturate_s"] = [
        _timed_saturate(res.engine, res.result, cs) for _ in range(reps)
    ]
    if hasattr(rpe, "ROLE_SPLIT_MIN_VOLUME"):
        keep = rpe.ROLE_SPLIT_MIN_VOLUME
        rpe.ROLE_SPLIT_MIN_VOLUME = 0
        try:
            split = rpe.RowPackedSaturationEngine(
                res.idx, device="cuda", cr6_tiles=cfg.cr6_tiles_config()
            )
        finally:
            rpe.ROLE_SPLIT_MIN_VOLUME = keep
        reset_launches()
        first = split.saturate()
        split_launches = dict(LAUNCHES)
        if not _same(first, res.result):
            raise AssertionError("the role-split plan gave another closure")
        walls = {"default": [], "role_split": []}
        for what in ("default", "role_split", "role_split", "default"):
            eng = res.engine if what == "default" else split
            walls[what].append(_timed_saturate(eng, res.result, cs))
        out["role_split"] = {
            "iterations": first.iterations,
            "launches": split_launches,
            "windows": split.gate_totals(),
            "plan": split.plan_stats(),
            "saturate_s": walls,
        }
        del split
    return out, res


def kernel_pairs(cs, res, label: str, pairs_dir) -> list:
    """The heaviest pair (largest m·l·w, then most nonzeros) of each
    site in a captured saturation and taxonomy, checked and timed; with
    ``pairs_dir``, this tree's CR4/CR6 pairs saved and every other
    tree's timed here too."""
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    cap = cs.Capture()
    cap.run = "64k"
    with cap:
        again = res.engine.saturate()
        extract_taxonomy(again)
    if not _same(again, res.result):
        raise AssertionError("64k: the captured rerun gave another closure")
    top = {}
    for (_run, site, kern, _bucket), (n, _nnz, a, b) in cap.pairs.items():
        size = a.shape[0] * a.shape[1] * b.shape[1]
        if site not in top or size > top[site][0]:
            top[site] = (size, kern, n, a, b)
    rows = []
    for site, (_size, kern, n, a, b) in sorted(top.items()):
        rows.append({"tree": label, **cs.check_pair("64k", site, kern, n, a, b)})
    if pairs_dir is not None:
        pairs_dir.mkdir(parents=True, exist_ok=True)
        mine = {s: (top[s][3], top[s][4]) for s in PAIR_SITES if s in top}
        torch.save(mine, pairs_dir / f"{label}.pt")
        for f in sorted(pairs_dir.glob("*.pt")):
            if f.stem == label:
                continue
            for site, (a, b) in torch.load(f).items():
                kern = next(r["main_path_kernel"] for r in rows if r["site"] == site)
                rows.append({"tree": f.stem, **cs.check_pair("64k", site, kern, 0, a, b)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, type=Path)
    ap.add_argument("--label", required=True)
    ap.add_argument("--pairs", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: chip_ab.py needs one card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _import_tree(args.tree.resolve())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    out = {"tree": args.label, "card": card}
    for what, (n_classes, reps) in SIZES.items():
        out[what], res = run_size(cs, n_classes, reps)
        if what == "64k":
            out["kernel_pairs"] = kernel_pairs(cs, res, args.label, args.pairs)
        del res
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"ab": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
