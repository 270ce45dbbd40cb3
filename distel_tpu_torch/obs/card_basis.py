"""Build the launch guard's card basis: observed, ledgered rebuilds of
SNOMED-shaped corpora on a card, every record stamped with the card's
name and power limit.

Each size runs what ``cli stream`` runs for its base file, the
incremental plane's rebuild, in exact layout with ``obs.ledger.enable``
(one ledger record a round), as ``chip_smoke.py``'s ledgered 64k
rebuild does.  The records of all sizes are written to one JSONL file,
which :func:`~distel_tpu_torch.obs.costmodel.default_basis_paths`
reads (``obs/h100_basis.jsonl`` is the tracked one).

Usage (on a card)::

    python -m distel_tpu_torch.obs.card_basis --out distel_tpu_torch/obs/h100_basis.jsonl \\
        --sizes 16000 32000 64000 [--seed 42]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Sequence


def stamp(records: List[dict], card: dict, corpus: dict) -> List[dict]:
    """``records`` with the card and the corpus they were measured on."""
    return [dict(r, card=card, corpus=corpus) for r in records]


def build(sizes: Sequence[int], seed: int = 42, device="cuda") -> List[dict]:
    """Ledger records of one observed rebuild a size, stamped."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.obs import ledger
    from distel_tpu_torch.runtime.profiling import device_record

    rec = device_record(device)
    card = {"name": rec.get("name", "cpu"), "power_limit": rec.get("power_limit")}
    # build and load the kernels first: no record's wall holds a build
    IncrementalClassifier(ClassifierConfig(shape_buckets=False), device=device) \
        .add_text(snomed_shaped_ontology(n_classes=500, seed=seed))
    out: List[dict] = []
    for n in sizes:
        text = snomed_shaped_ontology(n_classes=n, seed=seed)
        with tempfile.TemporaryDirectory(prefix="distel_basis_") as d:
            cfg = ClassifierConfig(shape_buckets=False, obs_ledger=True,
                                   obs_ledger_dir=d)
            inc = IncrementalClassifier(cfg, device=device)
            t0 = time.perf_counter()
            res = inc.add_text(text)
            wall = time.perf_counter() - t0
            files = sorted(f for f in os.listdir(d) if f.endswith(".ledger.jsonl"))
            recs = [r for f in files
                    for r in ledger.read_ledger(os.path.join(d, f))]
            del inc
        corpus = {"generator": "snomed_shaped_ontology", "n_classes": n,
                  "seed": seed}
        out += stamp(recs, card, corpus)
        print(json.dumps({"n_classes": n, "wall_s": wall,
                          "iterations": res.iterations,
                          "derivations": res.derivations,
                          "records": len(recs), "card": card}), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--sizes", type=int, nargs="+", default=[16000, 32000, 64000])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA card)")
    args = p.parse_args(argv)
    from distel_tpu_torch.runtime.classifier import resolve_device

    recs = build(args.sizes, args.seed, resolve_device(args.device))
    with open(args.out, "w", encoding="utf-8") as f:
        for r in recs:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
