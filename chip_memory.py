#!/usr/bin/env python3
"""Device memory of the one-shot classify on the weak-scaling corpus,
copy count by copy count, on one CUDA card.

    python3 chip_memory.py [--plane native|python|both] [COPIES ...]
                                             (default: both, 600 1200)

For each count: the OpenGALEN module (``tests/corpora``) read through
the RDF/XML reader, ``multiply_ontology(COPIES, crossed=True)``, written
as OFN, then ``ELClassifier(device="cuda").classify_text`` through the
native load plane and through the Python load plane (the plane every
XML input takes), or the one ``--plane`` names.  Per run it prints one
line ``{"memory": {...}}``: the index's sizes, the wall and phases, the
peak of ``torch.cuda.max_memory_allocated``, the process's peak host
resident set, and how the card's peak splits
(``chip_smoke.memory_split``: the plan's card tensors by attribute, the
mask tables among them, the closure's packed state, and what one more
saturation allocates over what is held).  A run that runs out of card
memory prints ``"oom": true`` with the error and the count goes on.
Prints the card's name and power limit first; exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time

import torch

from chip_smoke import ROOT, log, memory_split, sync


def run(text: str, copies: int, native: bool) -> dict:
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.runtime.classifier import ELClassifier

    clf = ELClassifier(ClassifierConfig(use_native_loader=native), device="cuda")
    out = {"copies": copies, "plane": "native" if native else "python"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    try:
        res = clf.classify_text(text)
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).splitlines()[0],
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        return out
    out.update(
        wall_s=time.perf_counter() - t0,
        phases_ms=res.summary()["phases_ms"],
        iterations=res.result.iterations,
        derivations=res.result.derivations,
        concepts=res.idx.n_concepts,
        links=res.idx.n_links,
        roles=res.idx.role_closure.shape[0],
        cr6_tiles=res.engine.plan_stats()["cr6_tiles"],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        split=memory_split(res.engine, res.result),
    )
    return out


def host_peak_bytes() -> int:
    """This process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def main() -> int:
    import distel_tpu_torch  # noqa: F401

    ap = argparse.ArgumentParser()
    ap.add_argument("--plane", choices=("native", "python", "both"), default="both")
    ap.add_argument("copies", type=int, nargs="*", default=[600, 1200])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA device: chip_memory.py needs one card")
        return 2
    from distel_tpu_torch.frontend.ontology_tools import multiply_ontology
    from distel_tpu_torch.owl import rdfxml, writer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    planes = {"native": [True], "python": [False], "both": [True, False]}[args.plane]
    galen = rdfxml.parse_file(str(ROOT / "tests" / "corpora" / "galen_module_jia.owl"))
    for n in args.copies:
        text = writer.ontology_to_str(multiply_ontology(galen, n, crossed=True))
        for native in planes:
            out = run(text, n, native)
            out["host_peak_bytes"] = host_peak_bytes()
            log(f"[memory] {json.dumps(out)}")
            print(json.dumps({"memory": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
