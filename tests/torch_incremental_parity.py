"""The port's incremental plane against the reference's on the smoke's
traffic at a chosen size, on the CPU (not collected by pytest: at 8,000
classes the reference takes about six minutes here).

    JAX_PLATFORMS=cpu python tests/torch_incremental_parity.py [N_CLASSES]

Feeds ``snomed_shaped_ontology(N_CLASSES, seed=42)`` without its range
axiom, then the reference bench's class-only, role and closure deltas
(``chip_smoke.py``'s ``INC_*``), then retracts the class-only delta,
through ``distel_tpu``'s ``IncrementalClassifier(ClassifierConfig(
shape_buckets=False))`` and ``distel_tpu_torch``'s on the CPU; prints
each step's history record from both packages and whether S and R are
equal, and exits 1 on any difference.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from distel_tpu.config import ClassifierConfig as RefConfig  # noqa: E402
from distel_tpu.core.incremental import IncrementalClassifier as RefInc  # noqa: E402
from distel_tpu_torch.core.incremental import IncrementalClassifier  # noqa: E402
from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology  # noqa: E402

KEYS = ("path", "iterations", "new_derivations", "batch_axioms",
        "retracted_rows", "affected_concepts")


def main(n_classes: int) -> int:
    torch.set_num_threads(4)
    text = chip_smoke.without_ranges(snomed_shaped_ontology(n_classes, seed=42))
    ref = RefInc(RefConfig(shape_buckets=False))
    port = IncrementalClassifier(device="cpu")
    ok = True
    for op, t in chip_smoke.incremental_steps(text):
        walls = []
        results = []
        for inc in (ref, port):
            t0 = time.perf_counter()
            results.append(inc.add_text(t) if op == "add" else inc.retract(t))
            walls.append(round(time.perf_counter() - t0, 1))
        hr, hp = ({k: h.history[-1][k] for k in KEYS if k in h.history[-1]}
                  for h in (ref, port))
        rr, pr = results
        n, nl = rr.idx.n_concepts, rr.idx.n_links
        same = (hr == hp
                and np.array_equal(np.asarray(rr.s)[:n, :n], pr.s[:n, :n])
                and np.array_equal(np.asarray(rr.r)[:n, :nl], pr.r[:n, :nl]))
        ok &= same
        print({"op": op, "reference": hr, "port": hp, "same": same,
               "wall_s": walls}, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8000))
