#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``distel_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. probe and build: the card, its power limit, and the CUDA kernels
   built from ``distel_tpu_torch/ops/csrc`` (one ``nvcc`` per source,
   ``packed_cols.cu`` and ``graph_if.cu``, all started together; timed);
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
   row-packed state), derivations and taxonomy.  Then, at the cut depth
   (:data:`CUT_CLASSES`, 3,500 classes of the same generator and seed),
   the frontier gating: the gated fixed point stepped on the card and on
   the CPU, every round's S, R and frontier flags equal (the default
   plan, and 256-link L-chunks with the live-tile CR6 forced);
   ``engine="dense"`` on the card and the CPU, equal to the row-packed
   card run; and ``backend.CRn = host`` (CR5, and CR1 with CR6, through
   the hybrid saturator) equal to the all-device card run;
   ``verify=True`` (the closure against the CPU oracle) on every golden
   fixture through the row-packed and the dense engine, and on the 8k
   corpus; and the XML readers: the RDF/XML corpora of
   ``tests/corpora`` (OpenGALEN module, LUBM) and the RDF/XML and
   OWL/XML fixtures of ``tests/test_xml_readers.py`` classified on the
   card, each equal (ids, S, R, derivations, taxonomy) to its EL part
   written as OFN;
5. full width, the main path: the 64000-class SNOMED-shaped corpus
   through ``ELClassifier().classify_text`` with the default config
   (the native load plane, the frontier-gated engine, shape buckets:
   its step program captured as a CUDA graph in the ``compile`` phase)
   to convergence with nothing hooked in, its wall, phases, peak
   memory, the windows contracted and skipped, the program's record
   and the kernels' launch counts read from that run alone (the step's
   row-count kernels and the taxonomy's must be > 0); two more
   saturations of the same engine, timed (graph replays, same closure);
   the same text through the Python load plane in exact mode (same
   derivations, iterations and taxonomy by name); then ``shape
   buckets`` at full width (``bucket_full_width``): the signatures of
   seeds 42, 41 (the nearest seed of 42's bucket) and 43; seed 41
   classified bucketed as a registry hit with nothing captured; seeds
   42 and 41 in exact mode, each bucketed run equal to it in S and R
   over the real rows, derivations, iterations and taxonomy; the
   chain-tailed 64k corpus with the fused window (K = 8) on two
   bucketed engines, the second replaying the first's windows, both
   equal round for round to the exact per-round run; ``warmup_paths``
   (serve profile) on the 64k corpus, then a fresh ``ServeApp``'s load
   and class-only delta, both building nothing; the cut corpus bucketed
   on the card and on the CPU, equal; and one step group of the 64k
   program run eagerly under the capture, whose heaviest operand of
   each route goes through both row-count variants against the plain
   version (the bucketed rows of the kernel line).  Then, on the exact
   native 64k run, a profiled rerun (per-rule breakdown), an end-to-end
   A/B of the route choice (saturation with the shipped choice, with
   every CR4/CR6 plan on the sparse route and with every plan flipped,
   A B C C B A) and a captured rerun (operands), all of which must give
   the same closure.  Every other phase pins ``shape_buckets=False``
   (``EXACT``): its records are held to earlier PRs' figures, and its
   captured reruns watch each launch from the host;
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
7b. the mesh plane (``mesh_full_width``): five ``cli classify`` runs,
   started after the build, beside the first phases, each its own
   process tree: the 64k corpus at ``--mesh 2``, two gloo ranks sharing
   the card (default config: bucketed, gated, native plane; the step
   program runs uncaptured, a graph cannot hold a gloo collective); on
   the cut corpus ``engine = packed`` in exact layout and the dense
   engine at ``--mesh 2``, a mesh of one over NCCL (the coordinator
   keys, one process) and the CPU port's mesh of one.  Every rank of a
   run must gather one closure; the dense and packed runs are held to
   the solo dense and packed card runs, the NCCL mesh of one to the
   CPU's; once phase 5 has run, the 64k run is held to it (the solo
   card classify of the same text: closure digest on every rank,
   derivations, iterations, taxonomy).  Each rank's wall, phases, peak
   memory, collectives (calls, bytes, seconds), windows, launches and
   shard-local product shapes are printed; then the bucketed step's
   heaviest operands at each rank's word window go through both
   row-count routes against the plain version (the ``(mesh 2, rank
   window)`` rows of the kernel line);
7c. the observed, fused and incremental paths on a mesh
   (``mesh_observed_full_width``), one background process tree started
   beside 7b's, its runs in turn: (c) ``cli stream`` with ``mesh.devices
   = 2`` (two gloo ranks on the card, exact layout) over the 64k corpus
   without its range axiom, the bench's deltas and ``--retract`` of the
   class-only one; (a) the forced 64k observed run (threshold 1.1,
   hysteresis 1, 12 capacity rungs, ``unroll=1``) and (b) the
   chain-tailed 64k corpus with the fused window, K = 8, on two gloo
   ranks (``parallel.mesh.launch_local``; the window uncaptured, its
   rounds folded across the ranks), the sparse tier's operands captured
   in (a); on the cut corpus (a) and (b) forced, K = 8, on an NCCL mesh
   of one (windows captured) and on the CPU port's.  Held, once phases
   9, 10 and 10b have run: every rank of (a) round for round (tier,
   rows touched, derivations, overflow, occupancy) and in closure
   digest, iterations, derivations and taxonomy to the solo forced run
   of phase 10, every rank of (b) round for round and in closure to
   phase 10b's synchronous per-round run, every rank's every step of (c) in closure
   and taxonomy digest (and path, iterations) to phase 9's range-free
   steps, the NCCL runs record for record to the CPU's.  Per rank:
   wall, phases, per-round records, host reads, collectives (calls,
   bytes, seconds), launches, peak memory; the sparse tier's heaviest
   operand per site and kernel at each rank's word window through both
   routes against the plain version (the ``(sparse tier, mesh 2, rank
   window)`` rows of the kernel line);
8. the weak-scaling corpus at full width: the OpenGALEN module read
   through the RDF/XML reader, multiplied into 600 crossed copies
   (88,802 concepts), written as OFN and classified by the default
   path with nothing hooked in (launch counts zeroed just before, read
   just after; every kernel of the engine's routes must be > 0), held
   to the Python-plane run of the same text (derivations, taxonomy);
   how each plane's peak memory splits (plan tables, state, a rerun's
   temporaries); then a captured saturate-and-taxonomy rerun of each
   plane's engine, whose operand pairs (one per call site and work
   bucket) are checked as in phase 6 and join the kernel line.  Then
   the component plane at the reference's weak-scaling size: 16,384
   disjoint GALEN copies (2.52M axioms) as OFN text, split by
   ``partition_ofn_text`` into one group, its representative ingested
   natively and the group run as one batched fixed point on the card
   (``saturate_isomorphic``, nothing hooked in, launch counts zeroed
   just before and read just after; every copy's S and R equal to copy
   0's, copy 0 to the CPU classify, derivations 16,384 times the
   representative's); GALEN x 64 with the 8k corpus through
   ``partition_index`` and ``saturate_components`` (65 components, each
   equal to the monolithic card classify of the union restricted to
   it); and ``packed_cols_dense_batched`` at the heaviest operand of a
   captured rerun against its plain version, for the kernel line.
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
   as in phase 6 and joins the kernel line.  (The card-and-CPU part
   runs at the cut depth, 3,500 classes.)
10. the observed fixed point (``saturate_observed``: the adaptive
   dense/sparse controller with pipelined dense rounds) at full width:
   ``chain_tailed_ontology(64000, 64)`` (the reference's sparse-tier
   regime, ``unroll=1``, default config) held round for round to its
   dense-only observed run and to ``saturate``, with at least 20
   sparse rounds, and both runs again with the pipeline off for the
   per-round walls (``low_density_speedup``); the forced tier on the
   64k corpus (threshold 1.1, hysteresis 1, 12 capacity rungs), per
   round equal to the dense-only run, taxonomy equal to the default
   classify, its sparse rounds launching the kernels, and a captured
   rerun whose heaviest sparse-tier CR4 and CR6 pairs are checked as
   in phase 6 and join the kernel line; the 64k base rebuild of the
   incremental plane with ``obs.ledger.enable`` (observed, one ledger
   record a round, ``cli runs report`` over it) beside the unobserved
   rebuild; the cut corpus forced on the card and on the CPU, every
   round equal.
10b. the fused K-round window (``fused_rounds``: K rounds of the
   adaptive controller a captured CUDA graph of IF nodes, one host read
   a window) at full width, each run equal round for round and in
   closure to the synchronous per-round controller: the chain-tailed
   64k corpus at K = 4, K = 8 (this phase's main path: its launches of
   ``packed_cols_dense_n``, ``packed_cols_list_n`` and the IF setter
   ``graph_if_set`` are read from that run alone, and must be > 0) and
   K = 8 adaptive, each cold and warm; the forced 64k tier at K = 8;
   the 64k ledgered rebuild with ``fused.rounds.k = 8`` from a
   properties file against the unfused rebuild; the cut corpus forced
   and with a one-rung overflow on the card and on the CPU, record for
   record, fallouts included; the row-count variants at the heaviest
   CR4 and CR6 windows of the forced run's final state (both routes,
   row counts 0, 1, half and all) and the IF node against a Python
   ``if``, for the kernel line.
10c. the artifact farm (``core/artifacts.py``) across fresh processes
   (the phase itself a child process, :func:`start_phase`, started after
   phase 10 and read after phase 12, beside 10b, 10d, 11 and 12):
   ``cli farm-build`` of the serve tenant's text (:data:`SERVE_CLASSES`,
   24k; 64k until PR 17 needed the time) with the class-only
   delta (the rebuild's and the delta plane's program specs, the kernel
   libraries), and again, writing nothing; a ``cli serve`` process with
   no ``nvcc`` on ``PATH``, no ``CUDA_HOME`` and an empty build
   directory consuming it (``--artifacts-require``): the load and the
   delta over HTTP with ``compile_s`` 0.0 and exe hits, the taxonomy
   equal to this process's classify, the farm's five ``/metrics``
   series, its own launches (a ``sitecustomize`` count) of the step's
   kernels; each kernel of the path from the farm's library in a child
   of the same environment at the heaviest bucketed operand of each
   route, against the plain version (the kernel line's ``farm`` rows);
   a copy with one spec byte flipped refused under
   ``--artifacts-require`` before binding and served without it, built
   from the engine's tables, the same taxonomy.
10d. the cohort plane (``core/cohort.py``): an in-process
   ``OntologyRegistry`` on the card, four 64k tenants (seed 42 three
   times, seed 41 once) and one ``delta_cohort`` call with their deltas,
   each family within the seg-OR ladder's floor rung (8 rows) so that
   they share one roster key: the bench's class-only delta's first 8
   axioms, 8 ∃-assertions over existing links, both, the class-only
   rows again), launch counts zeroed just before and read just after (the
   batched row-count kernels must launch); each member's roster key
   and path, the rung, the votes and their walls, the cohort programs'
   capture seconds and card bytes, peak memory; every cohort member
   held to its plan run solo on the card from its pre-cohort state (S,
   R, derivations, iterations, taxonomy), a fallback member to a
   from-scratch classify; one eager group of the base position's
   cohort program on the joint fixed point, whose heaviest operand of
   each route goes through the batched kernels at rungs 2, 4 and 8
   against the plain version (the ``(cohort step)`` rows of the kernel
   line); then cohorts of 2, 3 and 5 (rungs 2, 4, 8) of the cut corpus
   on the card, against the same increments run solo on the CPU, every
   record and taxonomy equal; and a card
   ``ServeApp`` over loopback HTTP whose scheduler forms a cohort from
   three tenants' concurrent deltas, answers equal to the CPU's.
11. the serve plane on the card and on the CPU (``ServeApp`` through
   ``dispatch``): the bench's traffic over the cut corpus (3,500
   classes) without its range axiom, the scheduled and snapshot reads after each write, every
   answer equal; the tracked mixed trace replayed over loopback HTTP on
   both, with the row-packed and with the packed engine, every answer
   equal; the cut corpus and the class-only delta served by the packed
   engine on the card, its answers equal to the row-packed engine's.
12. the resident server (:data:`SERVE_CLASSES`, 24k; 64k until PR 17
   needed the time): ``ServeApp(device="cuda")``
   behind ``make_server``, two workers, a card-memory budget (once the
   big tenant's state is known) that holds that tenant alone, driven
   over HTTP by ``ServeClient`` under the capture: the big corpus
   without its range axiom, the three deltas and
   the retraction, every served taxonomy held by name to a from-scratch
   card classify; an 8k tenant evicting it to the warm tier (the card
   must get its state's bytes back), a read promoting it; without the
   warm tier, a cold spill and a restore; a concurrent burst held to
   serial answers; the graceful close with its final spill.  The
   captured operand pairs are checked as in phase 6 and join the kernel
   line.
13. the serve fleet (a child process, :func:`start_phase`, started
   after phase 8 and read at the end): two replica processes on the card
   (``ReplicaSupervisor``: ``cli serve --replica-id ... --device cuda``,
   each checked to run this tree) behind a ``RouterApp`` in the
   phase's process: the :data:`SERVE_CLASSES` corpus (24k; 64k until
   PR 17, then 16k, before the phase left the smoke's process) and the 8k corpus
   (without their range axiom) loaded through the router onto
   different replicas, the class-only delta; the big tenant migrated
   live under reader threads and an 8k writer (no request may fail, its
   taxonomy byte-identical across the move) and moved back to its
   source; a read replica of the 8k tenant; the big tenant's replica
   SIGKILLed and its tenant recovered by journal replay, then a
   retraction on the 8k tenant and its replica killed (the replay with
   the retract marker); the tracked trace through the router with its
   ``migrate`` op, equal to an in-process CPU fleet's replay; the
   router's aggregated ``/metrics``, a stitched ``/debug/trace``,
   ``/fleet/status``; the graceful stop.  Every big and 8k taxonomy is
   held to a from-scratch card classify.  The replicas' launches happen
   in their own processes, out of this one's counts: a
   ``sitecustomize`` the smoke puts ahead of the tree on their
   ``PYTHONPATH`` writes each process's launches and allocator bytes to
   a file, and every replica process must have launched the path's
   kernels.  After the big tenant moves out, its source replica's
   reserved bytes must be below 1 GiB (the registry returns a departed
   tenant's blocks).

Kernel times are CUDA-event times per call over back-to-back calls;
the packed-contraction route's are also taken from CUDA-graph replays
(the card's time alone), which its kernel row carries as ``graph_ms``
beside the event times.
It prints the card's name and power limit, a ``{"policy": ...}`` line
(each site's device time under the chosen route and under each route,
with A's nonzero fraction), the ``{"andor_checks": ...}``,
``{"gating": ...}``, ``{"dense": ...}``, ``{"hybrid": ...}``,
``{"verify": ...}``, ``{"xml_corpora": ...}``,
``{"default_full_width": ...}`` (with the ``unroll`` it ran, its
``rounds``, ``mode`` and ``program``), ``{"full_width": ...}`` (the
Python load plane, exact), ``{"bucket_full_width": ...}`` (signatures,
per seed the bucketed and exact walls and phases, iterations, state
bytes, the build record; the program's capture seconds and card bytes;
the fused K = 8 runs on two engines; the warmup and the warmed load and
delta; the 8k card = CPU; the registry's counters; ``phase_s``),
``{"breakdown": ...}``, ``{"threshold_ab": ...}``,
``{"packed_full_width": ...}``, ``{"packed_breakdown": ...}`` and
``{"andor_operands": ...}``, ``{"multiplied_full_width": ...}``,
``{"partition_full_width": ...}`` (text-level walls, host peak RSS,
state bytes, launches; the index-level union),
``{"incremental_card_vs_cpu": ...}`` and ``{"incremental_full_width":
...}`` (each step's path, iterations, derivations, wall, phases,
launches, host and card peaks; the retraction's overdeletion time),
``{"observed_full_width": ...}`` (tier strings, per-round records,
walls and the sparse rounds' launches of each run; the ledgered and
unledgered rebuilds), ``{"fused_full_width": ...}`` (per run: cold and
warm walls, rounds each window retired, fallouts, dropped windows,
dispatch counters, the host's blocking reads, launches, and each
captured window's K, capacities, capture seconds, recorded operations
and card bytes), ``{"farm_full_width": ...}`` (the bake's records,
stats and wall, the re-bake's, the consumer's start-to-serving wall,
install record, load and delta, ``/metrics`` series and launches, the
kernel check, the refusal and the lenient consumer),
``{"mesh_full_width": ...}`` (each mesh run's summary and rank
records, its comparisons, and the rank-window kernel checks),
``{"cohort_full_width": ...}`` (the 64k cohort's members, key, rung,
votes, vote walls beside the solo walls, programs, events, launches,
solo checks, batched kernel checks; the cut cohorts; the HTTP cohort),
``{"serve_card_vs_cpu": ...}`` and ``{"serve_full_width": ...}`` (per
request: client wall, path, iterations, phases, launches, snapshot
publish seconds, host peak RSS, card memory; the bytes an eviction
freed; the burst; the close) and ``{"fleet_full_width": ...}`` (boot,
load, migration and recovery walls, the client hold, each recovery's
polls, spans and events, per-process card memory, launches and host
RSS, heartbeat latencies, ejections) lines,
a ``{"kernels": [...]}`` line
(the dense row's launches are the exact 64k run's, the bucketed main
path launching the row-count forms, whose rows ``(bucketed step)`` are
at the 64k program's heaviest operands;
the sparse row also carries the listing kernel's time and launches;
the batched dense row's numbers are from the component phase; the
row-count variants' and the IF setter's from the fused phase; the rows
marked ``"library": "farm"`` from the farm phase, their launches the
consumer process's; the ``(cohort step)`` rows from the cohort phase,
their launches the 64k cohort's),
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
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def EXACT(**kw):
    """The exact-shape config (``shape.buckets = false``): the phases
    whose records are held to earlier PRs' figures, and whose captured
    reruns watch each launch from the host, run the engines they ran
    before buckets became the default."""
    from distel_tpu_torch.config import ClassifierConfig

    return ClassifierConfig(shape_buckets=False, **kw)
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
    secs = build.build_all(["packed_cols", "graph_if"])
    from distel_tpu_torch.ops import bitmatmul, graph_if

    bitmatmul._lib()
    graph_if._lib()
    log(f"[build] {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for p in Path(build.build_dir()).glob("lib*.so.ptxas.txt"):
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
    tiles = ClassifierConfig(shape_buckets=False, cr6_tiles_density_threshold=100.0)
    runs = {}
    for what, clf in (
        ("cuda", ELClassifier(EXACT(), device="cuda")),
        ("cuda+tiles", ELClassifier(tiles, device="cuda")),
        ("cpu", ELClassifier(EXACT(), device="cpu")),
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
    got = ELClassifier(EXACT(engine="packed"), device="cuda").classify_text(text)
    log(f"[8k] packed: {time.perf_counter() - t0:.2f} s {got.summary()}")
    if not same_x_major(got.result, row_run.result):
        raise AssertionError("8k: packed and row-packed closures differ")
    if got.result.derivations != row_run.result.derivations:
        raise AssertionError("8k: packed and row-packed derivations differ")
    if taxonomy_key(got.taxonomy) != taxonomy_key(row_run.taxonomy):
        raise AssertionError("8k: packed and row-packed taxonomies differ")
    log("[8k] packed engine identical to the row-packed engine")


#: the depth of the phases that hold the card to a CPU run at a cut size
#: (``gating``, ``dense``, ``hybrid``, ``incremental_card_vs_cpu``, the
#: CPU halves of ``bucket_full_width``, ``observed_full_width`` and
#: ``fused_full_width``, ``serve_card_vs_cpu``): the 8k corpus's
#: generator and seed at fewer classes, the host's share of the smoke's
#: time budget cut so the farm phase fits; 3,500 classes keep every
#: target of the class-only delta (``Find0``-``Find693``) a class
CUT_CLASSES = 3500


def phase_gating(n_classes: int = CUT_CLASSES) -> dict:
    """The gated fixed point at the cut depth, step by step on the card
    and on the CPU from the same index: every round's S and R words and frontier
    flags equal, and the same windows contracted and skipped — with the
    default plan, and with many L-chunks and the live-tile CR6 forced."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.owl import native_loader

    idx = native_loader.load_indexed(snomed_shaped_ontology(n_classes=n_classes, seed=42))
    # one temporary budget on both devices, so both plan alike
    budget = 1 << 28
    plans = {
        "default": {"cr6_tiles": ClassifierConfig().cr6_tiles_config()},
        "lc256+tiles": {"l_chunk": 256,
                        "cr6_tiles": {"density_threshold": 100.0}},
    }
    out = {"n_classes": n_classes}
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
                raise AssertionError(f"gating ({what}): S/R differ in round {rnd}")
            for a in ("changed", "dirty_l", "f4", "f6", "fd6", "cr5"):
                if not np.array_equal(getattr(gf, a), getattr(cf, a)):
                    raise AssertionError(f"gating ({what}): {a} differs in round {rnd}")
            if gpu.gate_rounds[-1] != cpu.gate_rounds[-1]:
                raise AssertionError(f"gating ({what}): window counts differ")
            if rnd > 200:
                raise AssertionError(f"gating ({what}): no fixed point")
        out[what] = {
            "rounds": len(gpu.gate_rounds),
            "windows": gpu.gate_totals(),
            "windows_per_round": gate_rounds_compact(gpu),
            "plan": gpu.plan_stats(),
            "card_steps_s": t_gpu,
            "cpu_steps_s": t_cpu,
        }
    log(f"[gating] {json.dumps(out)}")
    print(json.dumps({"gating": out}), flush=True)
    if not sum(v["skipped"] for v in out["lc256+tiles"]["windows"].values()):
        raise AssertionError("gating: no window was ever skipped")
    return out


def phase_dense(n_classes: int = CUT_CLASSES) -> dict:
    """``engine="dense"`` on the cut corpus, on the card and on the CPU:
    the same S and R as each other and as the row-packed card run of the
    same text, the same derivations and taxonomy.  It runs no kernel of
    the port (its products are matmuls), which its launch counts show."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=n_classes, seed=42)
    row_run = ELClassifier(EXACT(), device="cuda").classify_text(text)
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
                raise AssertionError(f"dense ({dev}): S/R differ from the row-packed run")
        if res.result.derivations != row_run.result.derivations:
            raise AssertionError(f"dense ({dev}): derivations differ")
        if taxonomy_key(res.taxonomy) != taxonomy_key(row_run.taxonomy):
            raise AssertionError(f"dense ({dev}): taxonomy differs")
    if runs["cuda"].result.iterations != runs["cpu"].result.iterations:
        raise AssertionError("dense: card and CPU iteration counts differ")
    out = {
        "n_classes": n_classes,
        **runs["cuda"].summary(),
        "wall_s": walls["cuda"],
        "cpu_wall_s": walls["cpu"],
        "cpu_phases_ms": runs["cpu"].summary()["phases_ms"],
        "max_memory_allocated": peak,
        "launches": launches,
        "rowpacked_iterations": row_run.result.iterations,
    }
    log(f"[dense] {json.dumps(out)}")
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
        clf = ELClassifier(EXACT(engine=engine), device="cuda")
        for path in fixtures:
            clf.classify_file(str(path), verify=True)
    t0 = time.perf_counter()
    res = ELClassifier(EXACT(), device="cuda").classify_text(
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
    xml = ELClassifier(EXACT(), device="cuda")
    ofn = ELClassifier(EXACT(use_native_loader=False), device="cuda")
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


def phase_hybrid(n_classes: int = CUT_CLASSES) -> dict:
    """``backend.CRn = host`` at the cut depth on the card: CR5, and CR1
    with CR6, routed to the host through the hybrid saturator; the same
    S, R, derivations and taxonomy as the all-device card run of the same
    text."""
    from distel_tpu_torch.core.hybrid import HybridSaturator
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier

    text = snomed_shaped_ontology(n_classes=n_classes, seed=42)
    row_run = ELClassifier(EXACT(), device="cuda").classify_text(text)
    idx = row_run.idx
    out = {"n_classes": n_classes}
    for routed in ({"CR5": "host"}, {"CR1": "host", "CR6": "host"}):
        what = "+".join(sorted(routed))
        reset_launches()
        sync()
        t0 = time.perf_counter()
        res = ELClassifier(EXACT(rule_backends=routed),
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
    log(f"[hybrid] {json.dumps(out)}")
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
    clf = ELClassifier(EXACT(), device="cuda")
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
    py_clf = ELClassifier(EXACT(use_native_loader=False), device="cuda")
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


#: the weak-scaling regime of the component plane: this many disjoint
#: renamed GALEN copies (2.52M axioms; the monolithic path runs out of
#: the card between 2,400 and 2,700 copies), and the reference's own
#: 10M-axiom size (65,536 copies), run in a call of its own
PARTITION_COPIES = 16384
#: the index-level union (GALEN x 64 uncrossed + the 8k corpus), as the
#: reference's partition_index splits it
PARTITION_UNION_EXPECT = {"concepts": 20569, "roles": 3010, "links": 10600,
                          "components": 65, "groups": 2,
                          "component_concepts": [150, 11097]}


def galen_copy_template() -> str:
    """One renamed copy of the GALEN module as OFN lines, ``__copy0``
    the substitution anchor (the renaming of ``multiply_ontology``;
    out-of-profile axioms dropped) — the recipe of the reference's
    ``scripts/weak_scaling.py``, built with the port's modules."""
    from distel_tpu_torch.frontend.ontology_tools import _rename_axiom
    from distel_tpu_torch.owl import rdfxml, syntax as S
    from distel_tpu_torch.owl.writer import axiom_to_str

    onto = rdfxml.parse_file(str(ROOT / "tests" / "corpora" / "galen_module_jia.owl"))
    return "\n".join(
        axiom_to_str(_rename_axiom(ax, 0)) for ax in onto.axioms
        if not isinstance(ax, S.UnsupportedAxiom)
    )


class BatchedCapture:
    """While active, keeps the operand pair of ``packed_cols_dense_batched``
    whose A has the most nonzeros (on the card, copied), and counts the
    launches it saw."""

    def __init__(self):
        from distel_tpu_torch.ops import bitmatmul

        self.mod = bitmatmul
        self._orig = bitmatmul._launch_dense_batched
        self.launches, self.nnz, self.a, self.b = 0, -1, None, None

    def __enter__(self):
        cap = self

        def launch(a, b, out):
            cap.launches += 1
            nnz = int(torch.count_nonzero(a))
            if nnz > cap.nnz:
                cap.nnz, cap.a, cap.b = nnz, a.clone(), b.contiguous()
            return cap._orig(a, b, out)

        self.mod._launch_dense_batched = launch
        return self

    def __exit__(self, *exc):
        self.mod._launch_dense_batched = self._orig


def batched_bound_ms(a: torch.Tensor, b: torch.Tensor):
    """:func:`bound_ms` summed over a batch's copies: A once, the B rows
    some nonzero of their copy selects, C once; one W-word OR a
    nonzero."""
    nb, m, l = a.shape
    w = b.shape[2]
    nz = a != 0
    nnz = int(nz.sum())
    live_l = int(nz.any(dim=1).sum())
    nbytes = nb * m * l + 4 * w * live_l + 4 * nb * m * w
    ops = 2 * 32 * nnz * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_partition_full_width(copies: int = PARTITION_COPIES,
                               index_level: bool = True, device: str = "cuda"):
    """The component plane at the reference's weak-scaling size.

    (a) ``copies`` renamed GALEN copies built as OFN text (the
    reference's ``scripts/weak_scaling.py`` recipe), split by
    ``partition_ofn_text``, the one group's representative ingested
    through the native plane, then ``saturate_isomorphic`` on the card
    with the warm rerun — nothing hooked in, the launch counts zeroed
    just before and read just after.  Every copy's S and R must equal
    copy 0's word for word, copy 0 the CPU classify of the
    representative; derivations ``copies`` times the representative's,
    the iterations its own.
    (b) GALEN x 64 uncrossed plus the 8k corpus in one text, through the
    native plane, ``partition_index`` and ``saturate_components`` on the
    card: the reference's component counts, and every component's S
    equal to the monolithic card classify of the union restricted to
    it, the derivations equal in all.
    (c) The batched kernel at the heaviest operand (a) sent it (a
    captured rerun): against its plain version bit for bit, timed
    beside it and the bound.  Returns the kernel row."""
    from distel_tpu_torch.core.components import (
        partition_index, saturate_components, saturate_isomorphic,
    )
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import (
        multiply_ontology, snomed_shaped_ontology,
    )
    from distel_tpu_torch.frontend.partition_text import partition_ofn_text
    from distel_tpu_torch.ops.bitmatmul import (
        LAUNCHES, packed_cols_dense_batched, plain_packed_cols_batched,
        reset_launches,
    )
    from distel_tpu_torch.ops.bitpack import gather_bit_matrix
    from distel_tpu_torch.owl import native_loader, rdfxml, writer
    from distel_tpu_torch.runtime.classifier import ELClassifier

    t_phase = time.perf_counter()
    out = {"copies": copies}
    native_loader.load_indexed("SubClassOf(A B)")   # the plane built, if not yet
    # ---- (a) the text level
    with HostPeak() as hp:
        t0 = time.perf_counter()
        template = galen_copy_template()
        text = "\n".join(template.replace("__copy0", f"__copy{k}")
                         for k in range(copies))
        out["gen_s"] = time.perf_counter() - t0
        out["axioms"] = (template.count("\n") + 1) * copies
        out["ofn_bytes"] = len(text)
        t0 = time.perf_counter()
        parts = partition_ofn_text(text)
        out["partition_s"] = time.perf_counter() - t0
        del text
    out["host_peak_rss"] = hp.peak
    out["text_fallback"] = parts.fallback
    out["n_components"] = sum(c for _, c in parts.groups)
    out["n_groups"] = len(parts.groups)
    log(f"[partition] {copies} copies: gen {out['gen_s']:.2f} s, partition "
        f"{out['partition_s']:.2f} s, {out['n_groups']} group(s)")
    # the reference's grouping: one group of every copy (a copy landing
    # in a group of its own would shrink the batch silently)
    if parts.fallback or out["n_groups"] != 1 or out["n_components"] != copies:
        raise AssertionError(f"partition: text level gave {out}")
    rep_text, count = parts.groups[0]
    del parts
    t0 = time.perf_counter()
    idx = native_loader.load_indexed(rep_text)
    out["ingest_s"] = time.perf_counter() - t0
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sync()
    held = torch.cuda.memory_allocated() if device == "cuda" else 0
    reset_launches()
    t0 = time.perf_counter()
    g = saturate_isomorphic(idx, count, warm_timing=True, device=device,
                            keep_state=True)
    out["solve_total_s"] = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    if device == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["memory_allocated_before"] = held
    ps, pr = g.pop("packed_s"), g.pop("packed_r")
    out["solve_s"], out["solve_warm_s"] = g["wall_s"], g["wall_warm_s"]
    out["group"] = g
    out["derivations"], out["iterations_max"] = g["derivations"], g["iterations"]
    out["launches"] = launches
    out["n_concepts"] = (idx.n_concepts - 2) * count
    out["n_links"] = idx.n_links * count
    nc, nl, wc = ps.shape[1], pr.shape[1], ps.shape[2]
    out["state_bytes"] = ps.untyped_storage().nbytes()
    out["per_copy_bytes"] = (nc + nl) * wc * 4
    out["state_shape"] = [count, nc + nl, wc]
    same = bool((ps == ps[:1]).all()) and bool((pr == pr[:1]).all())
    cpu = RowPackedSaturationEngine(idx, device="cpu").saturate()
    cs, cr = cpu.wire()
    copy0 = (np.array_equal(ps[0].cpu().numpy().view(np.uint32), cs)
             and np.array_equal(pr[0].cpu().numpy().view(np.uint32), cr))
    out["rep"] = {"n_concepts": idx.n_concepts, "n_links": idx.n_links,
                  "iterations": cpu.iterations, "derivations": cpu.derivations}
    del ps, pr, g
    if not same:
        raise AssertionError("partition: a copy's closure differs from copy 0's")
    if not copy0:
        raise AssertionError("partition: copy 0 differs from the CPU classify")
    if out["derivations"] != count * cpu.derivations:
        raise AssertionError(f"partition: derivations {out['derivations']} != "
                             f"{count} x {cpu.derivations}")
    if out["iterations_max"] != cpu.iterations:
        raise AssertionError(f"partition: {out['iterations_max']} iterations, "
                             f"the representative {cpu.iterations}")
    if out["state_bytes"] != count * out["per_copy_bytes"]:
        raise AssertionError(f"partition: state {out['state_bytes']} B for "
                             f"{count} x {out['per_copy_bytes']} B")
    if device == "cuda" and launches["packed_cols_dense_batched"] == 0:
        raise AssertionError("partition: the batched kernel was never launched")
    log(f"[partition] text level: solve {out['solve_s']} s, warm "
        f"{out['solve_warm_s']} s, {out['derivations']} derivations; every "
        "copy equal to copy 0, copy 0 to the CPU classify")

    # ---- (c) the batched kernel at the heaviest operand of (a)
    if device == "cuda":
        torch.cuda.empty_cache()
    with BatchedCapture() as bcap:
        saturate_isomorphic(idx, count, device=device)
    a, b = bcap.a, bcap.b
    want = plain_packed_cols_batched(a, b)
    err = int((packed_cols_dense_batched(a, b) != want).sum())
    del want
    if err:
        raise AssertionError(f"packed_cols_dense_batched: {err} words differ from plain")
    timer = time_ms if device == "cuda" else wall_ms
    row = {
        "name": "packed_cols_dense_batched",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES["packed_cols_dense"],
        "launches": launches["packed_cols_dense_batched"],
        "max_abs_err": err,
        "ms": timer(lambda: packed_cols_dense_batched(a, b)),
        "plain_ms": timer(lambda: plain_packed_cols_batched(a, b), reps=3),
        "library_ms": None,
        "at": {"run": f"partition:{copies}", "shape": list(a.shape) + [b.shape[2]],
               "a_nonzero_fraction": float((a != 0).float().mean()),
               "captured_launches": bcap.launches},
        "main_path": True,
    }
    row["bound_ms"], row["bound_by"] = batched_bound_ms(a, b)
    del a, b, bcap
    out["kernel"] = row
    log(f"[partition] kernel {json.dumps(row)}")

    # ---- (b) the index level: GALEN x 64 + the 8k corpus, one text
    if index_level:
        galen = rdfxml.parse_file(str(ROOT / "tests" / "corpora" / "galen_module_jia.owl"))
        union = (writer.ontology_to_str(multiply_ontology(galen, 64)) + "\n"
                 + snomed_shaped_ontology(n_classes=8000, seed=42))
        t0 = time.perf_counter()
        uidx = native_loader.load_indexed(union)
        comps = partition_index(uidx)
        ib = {"ingest_partition_s": time.perf_counter() - t0}
        sizes = sorted({c.idx.n_concepts for c in comps})
        got = {"concepts": uidx.n_concepts, "roles": uidx.n_roles,
               "links": uidx.n_links, "components": len(comps),
               "groups": len({c.signature() for c in comps}),
               "component_concepts": sizes}
        ib["index"] = got
        if got != PARTITION_UNION_EXPECT:
            raise AssertionError(f"partition: union {got}, expected "
                                 f"{PARTITION_UNION_EXPECT}")
        reset_launches()
        t0 = time.perf_counter()
        agg = saturate_components(comps, device=device, keep_state=True)
        ib["saturate_s"] = time.perf_counter() - t0
        ib["launches"] = dict(LAUNCHES)
        t0 = time.perf_counter()
        whole = ELClassifier(EXACT(), device=device).classify_text(union)
        ib["monolithic"] = {"wall_s": time.perf_counter() - t0,
                            "iterations": whole.result.iterations,
                            "derivations": whole.result.derivations}
        ib["groups"] = [{k: v for k, v in gr.items() if not k.startswith("packed")}
                        for gr in agg["groups"]]
        ib["derivations"], ib["iterations_max"] = agg["derivations"], agg["iterations_max"]
        if agg["derivations"] != whole.result.derivations:
            raise AssertionError("partition: union derivations differ from the "
                                 "monolithic classify")
        # every component's S against the union's, restricted to it
        usp = whole.result.packed_s
        by_sig = {}
        for c in comps:
            by_sig.setdefault(c.signature(), []).append(c)
        checked = 0
        for gr, members in zip(agg["groups"], by_sig.values()):
            for k, c in enumerate(members):
                n = c.idx.n_concepts
                gmap = torch.as_tensor(np.r_[0, 1, c.global_concepts], device=usp.device)
                local = gather_bit_matrix(gr["packed_s"][k], torch.arange(n, device=usp.device),
                                          torch.arange(2, n, device=usp.device))
                glob = gather_bit_matrix(usp, gmap, gmap[2:])
                if not torch.equal(local, glob):
                    raise AssertionError(f"partition: component {checked} differs "
                                         "from the union's closure")
                checked += 1
        ib["components_checked"] = checked
        if device == "cuda":
            if ib["launches"]["packed_cols_dense_batched"] == 0:
                raise AssertionError("partition: the union's 64-copy group never "
                                     "launched the batched kernel")
            if ib["launches"]["packed_cols_dense"] + ib["launches"]["packed_cols_sparse"] == 0:
                raise AssertionError("partition: the singleton never launched a kernel")
        del agg, whole, usp, comps, uidx
        out["index_level"] = ib
        log(f"[partition] index level: {checked} components equal to the union's")
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"partition_full_width": out}), flush=True)
    return row


#: the callers of PackedColsMatmulPlan on the main path, by function name
SITES = {
    "_cr4": "cr4",
    "_cr6_windows": "cr6_windows",
    "_cr6_tiles": "cr6_tiles",
    "_extract_device_blocked": "taxonomy",
    # the observed controller's sparse tier (its rule: the frame's
    # ``d`` is the engine's CR4 or CR6 table)
    "_sparse_contract": "sparse",
    # the bucketed step program run eagerly (``core/bucketing._Step``;
    # the frame's ``key`` is "4" or "6")
    "contract": "bucket",
}


def site_of(frame) -> str:
    """The call site a captured launch came from (``frame``: the
    engine's frame named in :data:`SITES`)."""
    site = SITES[frame.f_code.co_name]
    if site == "bucket":
        return f"bucket_cr{frame.f_locals['key']}"
    if site == "sparse":
        loc = frame.f_locals
        site = "sparse_cr4" if loc["d"] is loc["self"]._sp4 else "sparse_cr6"
    return site


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

        def launch(plan, a, b, out, n_rows=None):
            if torch.cuda.is_current_stream_capturing():
                # a graph being captured: its launches replay unseen
                # (a copy to the host here would fail the capture)
                if n_rows is None:
                    return cap._orig(plan, a, b, out)
                return cap._orig(plan, a, b, out, n_rows)
            f, site = sys._getframe(1), "other"
            while f is not None and f.f_code.co_name not in SITES:
                f = f.f_back
            if f is not None:
                site = site_of(f)
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
            if n_rows is None:
                return cap._orig(plan, a, b, out)
            return cap._orig(plan, a, b, out, n_rows)

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


def bucket_path_kernels(engine) -> list:
    """The kernels a bucketed row-packed run must launch: its step
    program's row-count routes (the dense kernel's ``_n`` form, or the
    ``_n`` listing and the sparse kernel) and the taxonomy's listing and
    sparse kernel."""
    plans = engine._bucket_program().step.plans.values()
    kernels = ["packed_cols_list", "packed_cols_sparse"]
    if any(not p.skip_zero_tiles for p in plans):
        kernels.append("packed_cols_dense_n")
    if any(p.skip_zero_tiles for p in plans):
        kernels.append("packed_cols_list_n")
    return kernels


def program_stats(engine) -> dict:
    """A bucketed engine's program: signature, build record, the
    registry's counters and the card bytes it holds."""
    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.core.program_cache import PROGRAMS

    prog = engine._bucket_program()
    return {
        "bucket_signature": engine.bucket_signature,
        "compile": engine.compile_stats.as_dict(),
        "capture_s": prog.capture_s,
        "graph_bytes": prog.graph_bytes,
        "program_card_bytes": prog.nbytes,
        "state_pair_bytes": prog.pair.nbytes,
        "registry": PROGRAMS.stats(),
        "registry_card_bytes": bucketing.program_bytes("cuda"),
        "struct": repr(engine._bstruct),
    }


def gate_rounds_compact(engine) -> dict:
    """Per round, the windows (or link tiles) contracted and skipped."""
    out = {k: [] for k in ("cr4", "cr6", "cr6_tiles")}
    for rnd in engine.gate_rounds:
        for k in out:
            out[k].append(rnd[k])
    return out


def phase_default_full_width():
    """The main path: ``ELClassifier().classify_text`` with the default
    config (the native load plane, the frontier-gated row-packed engine,
    shape buckets: its step program captured as a CUDA graph in the
    ``compile`` phase) on the 64k corpus, with nothing hooked into it:
    wall, phases, peak memory, launch counts and windows contracted and
    skipped are those of ``cli classify``.  Then two more saturations of
    the same engine, timed (graph replays)."""
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
        "mode": "bucketed",
        "program": program_stats(gated),
    }
    log(f"[64k default] {json.dumps(stats)}")
    print(json.dumps({"default_full_width": stats}), flush=True)
    if "load(native)" not in res.timer.phases:
        raise AssertionError("64k: the default classify did not run the native plane")
    if not gated._bucket or "compile" not in res.timer.phases:
        raise AssertionError("64k: the default classify did not run bucketed")
    if not res.result.converged:
        raise AssertionError("64k run did not converge")
    for k in bucket_path_kernels(gated):
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
    clf = ELClassifier(EXACT(use_native_loader=False), device="cuda")
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
    """A third saturate-and-taxonomy run on the exact 64k index, under
    the capture (run ``64k-exact``: the bucketed main path replays a
    graph, whose launches the host cannot see one by one); its closure
    must equal the first run's."""
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    cap.run = "64k-exact"
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


def phase_kernel_line(launches, exact_launches, cap: Capture, checked=()):
    """Every captured pair with both routes (``checked``: pairs already
    checked), the per-site policy, then one row per kernel.  A row's
    ``launches`` are the bucketed main path's (``launches``; the dense
    kernel's are 0 there: its step launches the row-count forms, whose
    rows :func:`bucket_kernel_rows` adds), ``exact_64k_launches`` the
    exact 64k run's; its times and bound are its kernel's at the
    heaviest pair (most word-ANDs) that the exact 64k run sent to it
    (for a kernel that run did not choose, its heaviest pair), so the
    row is not the main path's (``main_path`` false); its
    ``max_abs_err`` is over every pair."""
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
        exact = [p for p in pairs if p["run"] == "64k-exact"]
        pool = [p for p in exact if p["main_path_kernel"] == kern] or exact or pairs
        top = max(pool, key=lambda p: p["shape"][0] * p["shape"][1] * p["shape"][2])
        key = "sparse_ms" if kern.endswith("sparse") else "dense_ms"
        row = {
            "name": kern,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kern],
            "launches": launches[kern],
            "exact_64k_launches": exact_launches[kern],
            "max_abs_err": max(p["max_abs_err"] for p in pairs),
            "ms": top[key],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
            "at": {k: top[k] for k in ("run", "site", "shape")},
            "main_path": False,
        }
        if kern.endswith("sparse"):
            # the sparse route's own listing kernel (no TPU kernel of its own)
            row.update(list_ms=top["list_ms"], sparse_kernel_ms=top["sparse_kernel_ms"],
                       list_launches=launches["packed_cols_list"],
                       exact_64k_list_launches=exact_launches["packed_cols_list"])
        rows.append(row)
    return rows, pairs


# ------------------------------------------------------ shape buckets

BUCKET_SEEDS = (42, 41, 43)
#: a class-only delta within the warmed delta programs' floor rung
BUCKET_DELTA = "\n".join(f"SubClassOf(BucketDelta{i} Find{i * 7})" for i in range(4))


def rows_equal(bucketed, exact, n_c: int, n_l: int) -> bool:
    """S and R of a bucketed and an exact result over the real rows and
    the exact layout's words, compared on the card."""
    wc = exact.packed_s.shape[1]
    return (torch.equal(bucketed.packed_s[:n_c, :wc], exact.packed_s[:n_c, :wc])
            and torch.equal(bucketed.packed_r[:n_l, :wc], exact.packed_r[:n_l, :wc]))


def bucket_operands(engine, res, cap: "Capture") -> None:
    """One step group of ``engine``'s bucketed program run eagerly (not
    replayed) from ``res``'s closure with every window live, under the
    capture (run ``64k-bucketed``): the operands the program's kernels
    get at the real rung shapes.  The closure must not move."""
    prog = engine._bucket_program()
    with prog.pair.lock:
        prog.load(engine._btables)
        prog.pair.sp.copy_(res.packed_s)
        prog.pair.rp.copy_(res.packed_r)
        prog.ms.fill_(True)
        prog.dl.copy_(prog.T["dl_valid"])
        cap.run = "64k-bucketed"
        with cap:
            prog._group()
        sync()
        if bool(prog.flags[0]) or not torch.equal(prog.pair.sp, res.packed_s):
            raise AssertionError("64k bucketed: a step on the fixed point changed it")


def bucket_heaviest(cap: "Capture") -> dict:
    """``{variant: (site, A, B, sparse route)}``: the bucketed 64k step's
    heaviest operand (rows × links × words) of each route, out of the
    pairs :func:`bucket_operands` captured (taken from ``cap``)."""
    ops = []
    for (run, site, kern, bucket) in sorted(cap.pairs):
        if run != "64k-bucketed":
            continue
        n, nnz, a, b = cap.pairs.pop((run, site, kern, bucket))
        ops.append((site, kern, nnz, a, b))
    out = {}
    for kern, variant in (("packed_cols_dense", "packed_cols_dense_n"),
                          ("packed_cols_sparse", "packed_cols_list_n")):
        pool = [o for o in ops if o[1] == kern]
        if pool:
            site, _k, _nnz, a, b = max(pool, key=lambda o: o[3].shape[0]
                                       * o[3].shape[1] * o[4].shape[1])
            out[variant] = (site, a, b, kern.endswith("sparse"))
    return out


def bucket_kernel_rows(heaviest: dict, launches: dict) -> list:
    """The bucketed 64k step's heaviest operand of each route
    (:func:`bucket_heaviest`), through both row-count variants against
    the plain version (0 differing words) and timed: one kernel row
    each, with the main path's launches of the variant."""
    rows = []
    for kern, variant, replaces in (
        ("packed_cols_dense", "packed_cols_dense_n", REPLACES["packed_cols_dense"]),
        ("packed_cols_sparse", "packed_cols_list_n", REPLACES["packed_cols_sparse"]),
    ):
        if variant not in heaviest:
            continue
        site, a, b, sparse = heaviest[variant]
        a, b = a.cuda(), b.cuda()
        checks = check_variants([(site, a, b, sparse)])
        mine = [c for c in checks if c["kernel"] == variant]
        top = mine[0]
        row = {
            "name": f"{variant} (bucketed step)", "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[variant],
            "max_abs_err": max(c["max_abs_err"] for c in checks),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "dead_ms": top["dead_ms"],
            "at": {"run": "64k-bucketed", "site": site, "shape": top["shape"]},
            "main_path": True,
        }
        if variant == "packed_cols_list_n":
            row["sparse_launches"] = launches["packed_cols_sparse"]
        rows.append(row)
        del a, b
    if not rows:
        raise AssertionError("the bucketed 64k step sent no operand to a kernel")
    return rows


def phase_bucket_full_width(default, device: str = "cuda", n_classes: int = 64000,
                            n_chain: int = 64000, chain_depth: int = 64,
                            n_small: int = CUT_CLASSES, seeds=BUCKET_SEEDS):
    """Shape buckets at full width.  ``default`` is the main path's
    bucketed 64k classify (seed 42), which captured its bucket's step
    program.

    1. The signatures of the seeds 42, 41 and 43 (41 is the nearest seed
       whose corpus shares 42's bucket; 43 lands in another: a hub
       target's segment falls a power of two lower).
    2. Seed 41 classified bucketed: a registry hit, nothing captured
       (``compile_s == 0.0``).  Seeds 42 and 41 classified exact on the
       native plane: each bucketed run equal to it in S and R over the
       real rows, derivations, iterations and taxonomy.
    3. ``chain_tailed_ontology(64000, 64)`` with the fused window
       (``fused_rounds`` K = 8) on two bucketed engines, each held round
       for round to the exact synchronous per-round run; the second
       engine's windows are registry hits (capture 0.0 s).
    4. ``warmup_paths`` (the ``"serve"`` profile) on the 64k corpus, then
       a fresh ``ServeApp`` loads it and takes a class-only delta: both
       build nothing (``compile_s == 0.0``, hits).
    5. The 8k corpus bucketed on the card and on the CPU: equal.

    Returns the exact native 64k result (seed 42) for the phases that
    capture operands from the host, and the exact run's launches."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import (
        chain_tailed_ontology, snomed_shaped_ontology,
    )
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.owl import native_loader
    from distel_tpu_torch.runtime import warmup
    from distel_tpu_torch.runtime.classifier import ELClassifier, make_engine
    from distel_tpu_torch.serve.server import ServeApp

    t_phase = time.perf_counter()
    out = {"mode": "bucketed, ratio 1.25"}
    one, two, _other = seeds
    texts = {s: snomed_shaped_ontology(n_classes=n_classes, seed=s)
             for s in set(seeds)}

    # 1. signatures
    sigs = {}
    for s in seeds:
        idx = native_loader.load_indexed(texts[s])
        eng = make_engine(ClassifierConfig(), idx, device)
        sigs[s] = {"signature": eng.bucket_signature, "nc": eng.nc, "nl": eng.nl,
                   "concepts": idx.n_concepts, "links": idx.n_links}
        del eng, idx
    out["signatures"] = sigs
    log(f"[bucket] signatures {json.dumps(sigs)}")
    if sigs[two]["signature"] != sigs[one]["signature"]:
        raise AssertionError(f"seeds {one} and {two} no longer share a bucket")
    if default.engine.bucket_signature != sigs[one]["signature"]:
        raise AssertionError("the main path ran another bucket")

    # 2. the second corpus of the bucket, and both held to exact mode
    first = default.engine.compile_stats
    reset_launches()
    sync()
    t0 = time.perf_counter()
    second = ELClassifier(device=device).classify_text(texts[two])
    sync()
    runs = {one: {"bucketed": default, "first_compile": first.as_dict()},
            two: {"bucketed": second, "wall_s": time.perf_counter() - t0,
                  "launches": dict(LAUNCHES)}}
    st = second.compile_stats
    if not st.program_cache_hit or st.compile_s != 0.0 or st.trace_lower_s != 0.0:
        raise AssertionError(f"seed {two}: the bucket's program was built again: {st}")
    exact42 = exact_launches = None
    for s in (one, two):
        reset_launches()
        sync()
        t0 = time.perf_counter()
        ex = ELClassifier(EXACT(), device=device).classify_text(texts[s])
        sync()
        wall = time.perf_counter() - t0
        b = runs[s]["bucketed"]
        same = {
            "rows": rows_equal(b.result, ex.result, ex.idx.n_concepts, ex.idx.n_links),
            "derivations": b.result.derivations == ex.result.derivations,
            "iterations": b.result.iterations == ex.result.iterations,
            "taxonomy": taxonomy_key(b.taxonomy) == taxonomy_key(ex.taxonomy),
        }
        runs[s].update(
            exact_wall_s=wall, exact_phases_ms=ex.summary()["phases_ms"],
            bucketed_phases_ms=b.summary()["phases_ms"],
            iterations=[b.result.iterations, ex.result.iterations],
            derivations=b.result.derivations, same=same,
            state_bytes=[(b.engine.nc + b.engine.nl) * b.engine.wc * 4,
                         (ex.engine.nc + ex.engine.nl) * ex.engine.wc * 4],
            compile=b.compile_stats.as_dict(),
        )
        runs[s].pop("bucketed")
        if not all(same.values()):
            raise AssertionError(f"seed {s}: bucketed and exact runs differ: {same}")
        if s == one:
            exact42, exact_launches = ex, dict(LAUNCHES)
        del ex
    prog = default.engine._bucket_program()
    out["runs"] = runs
    out["program"] = {"capture_s": prog.capture_s, "graph_bytes": prog.graph_bytes,
                      "program_card_bytes": prog.nbytes,
                      "state_pair_bytes": prog.pair.nbytes}
    del second
    log(f"[bucket 64k] {json.dumps(runs)} {json.dumps(out['program'])}")

    # 3. the fused window on two engines of one corpus
    idx = native_loader.load_indexed(chain_tailed_ontology(n_chain, chain_depth))
    base = observed_run(RowPackedSaturationEngine(idx, device=device, unroll=1),
                        sparse_tail=True, pipeline=False)
    fused = {"per_round_wall_s": base[3], "rounds": len(base[1])}
    for label in ("first", "second"):
        eng = RowPackedSaturationEngine(idx, device=device, unroll=1, bucket=True)
        run, info = fused_run(eng, sparse_tail=True, fused_rounds={"rounds": 8})
        if run[0] != base[0] or fused_records(run[1]) != fused_records(base[1]) \
                or run[2].iterations != base[2].iterations \
                or not rows_equal(run[2], base[2], idx.n_concepts, idx.n_links):
            raise AssertionError(f"chain-tailed K8 ({label} bucketed engine) differs "
                                 "from the per-round run")
        cs = eng.compile_stats
        fused[label] = {"wall_s": run[3], "window_rounds": info["windows"],
                        "compile": cs.as_dict(), "captured": info["captured"]}
        if label == "second" and (not cs.program_cache_hit or cs.compile_s != 0.0):
            raise AssertionError(f"the second engine captured its windows: {cs}")
        del eng, run
    out["fused_k8"] = fused
    del base, idx
    torch.cuda.empty_cache()
    log(f"[bucket fused] {json.dumps(fused)}")

    # 4. warmup (serve profile), then a fresh server's load and delta
    path = ROOT / "build" / "smoke" / "bucket64k.ofn"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(texts[one])
    t0 = time.perf_counter()
    recs = warmup.warmup_paths([str(path)], ClassifierConfig(), profile="serve",
                               device=device)
    warm = {"wall_s": time.perf_counter() - t0, "record": recs[0],
            "registry": PROGRAMS.stats()}
    app = ServeApp(device=device)
    try:
        t0 = time.perf_counter()
        status, load = serve_call(app, "POST", "/v1/ontologies", text=texts[one])
        warm["load_wall_s"] = time.perf_counter() - t0
        if status != 201:
            raise AssertionError(f"the 64k load answered {status}: {load}")
        t0 = time.perf_counter()
        status, delta = serve_call(app, "POST",
                                   f"/v1/ontologies/{load['id']}/deltas",
                                   text=BUCKET_DELTA)
        warm["delta_wall_s"] = time.perf_counter() - t0
    finally:
        app.close(final_spill=False)
    path.unlink()
    warm["load"] = {k: load.get(k) for k in ("compile_s", "trace_lower_s",
                                              "program_cache_hit", "bucket_signature",
                                              "iterations", "path")}
    warm["delta"] = {k: delta.get(k) for k in (
        "compile_s", "program_cache_hit", "delta_programs", "delta_program_hits",
        "delta_bucketed", "path", "iterations")}
    out["warmup_serve"] = warm
    log(f"[bucket warmup] {json.dumps(warm)}")
    if load.get("compile_s") != 0.0 or not load.get("program_cache_hit"):
        raise AssertionError(f"the warmed load built a program: {warm['load']}")
    if delta.get("path") != "fast" or delta.get("compile_s") != 0.0 \
            or delta.get("delta_program_hits") != delta.get("delta_programs"):
        raise AssertionError(f"the warmed delta built a program: {warm['delta']}")
    del app
    torch.cuda.empty_cache()

    # 5. 8k bucketed on the card and on the CPU
    text8 = snomed_shaped_ontology(n_classes=n_small)
    small = {}
    got = {dev: ELClassifier(device=dev).classify_text(text8) for dev in (device, "cpu")}
    c, h = got[device], got["cpu"]
    small = {"iterations": c.result.iterations, "derivations": c.result.derivations,
             "signature": c.engine.bucket_signature}
    if (c.result.iterations, c.result.derivations) != \
            (h.result.iterations, h.result.derivations) \
            or not torch.equal(c.result.packed_s.cpu(), h.result.packed_s) \
            or not torch.equal(c.result.packed_r.cpu(), h.result.packed_r) \
            or taxonomy_key(c.taxonomy) != taxonomy_key(h.taxonomy):
        raise AssertionError("cut bucketed: card and CPU differ")
    out["card_vs_cpu_cut"] = small
    out["registry"] = PROGRAMS.stats()
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"bucket_full_width": out}), flush=True)
    return exact42, exact_launches


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


def phase_incremental_card_vs_cpu(n_classes: int = CUT_CLASSES) -> dict:
    """The bench's incremental traffic over the cut corpus (without its
    one range axiom, so that the retraction is not refused), the default
    config (the fast path engages above 2,048 concepts), on the card and
    on the CPU: after every increment, the retraction and a restore from
    a snapshot (with the retraction marker in the op log), the packed S
    and R byte-identical and the history records equal."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology

    text = without_ranges(snomed_shaped_ontology(n_classes=n_classes, seed=42))
    steps = incremental_steps(text)
    log_ops = [t for _op, t in steps[:-1]] + [{"op": "retract", "text": INC_CLASS_DELTA}]
    SNAPSHOT_DIR.mkdir(parents=True, exist_ok=True)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        inc = IncrementalClassifier(EXACT(), device=dev)
        wires = []
        for op, t in steps:
            res = inc.add_text(t) if op == "add" else inc.retract(t)
            wires.append(res.wire())
        path = str(SNAPSHOT_DIR / f"inc-cut-{dev}.npz")
        inc.snapshot(path, compressed=False)
        back = IncrementalClassifier.restore(log_ops, path, EXACT(), device=dev)
        wires.append(back.last_result.wire())
        runs[dev] = ([without_build(h) for h in inc.history + back.history[-1:]],
                     wires, time.perf_counter() - t0)
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
    out = {"n_classes": n_classes, "history": hc, "cuda_s": tc, "cpu_s": tp}
    log(f"[incremental card/cpu] {json.dumps(out)}")
    print(json.dumps({"incremental_card_vs_cpu": out}), flush=True)
    return out


def phase_incremental_full_width(cap: Capture, refs: Optional[dict] = None):
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
    is checked bit for bit and returned for the kernel line.  ``refs``
    gets ``"stream"``: each range-free step's path, iterations, closure
    and taxonomy digests (what 7c's stream on a mesh is held to)."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    text = snomed_shaped_ontology(n_classes=64000, seed=42)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    inc = IncrementalClassifier(EXACT(), device="cuda")
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
        batch = ELClassifier(EXACT(), device="cuda").classify_text("\n".join(texts) + "\n")
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
    inc = IncrementalClassifier(EXACT(), device="cuda")
    stream_ref = []

    def stream_step(res):
        stream_ref.append({
            "path": inc.history[-1]["path"],
            "iterations": inc.history[-1]["iterations"],
            "digests": digests_later(res, extract_taxonomy(res)),
        })

    for name, t in (("base", text_nr), ("class_only", INC_CLASS_DELTA),
                    ("role", INC_ROLE_DELTA), ("closure", INC_CLOSURE_DELTA)):
        stream_step(step(f"{name}:no_range", lambda t=t: (inc.add_text(t), inc),
                         {"rebuild"} if name == "base" else {"fast", "rebuild"}))
    survivors = [text_nr, INC_ROLE_DELTA, INC_CLOSURE_DELTA]
    r4 = step("retract:no_range", lambda: (inc.retract(INC_CLASS_DELTA), inc),
              {"retract"})
    stream_step(r4)
    if refs is not None:
        refs["stream"] = stream_ref
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
        made.append(IncrementalClassifier.restore(ops, path, EXACT(), device="cuda"))
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
    inc2 = IncrementalClassifier(EXACT(), device="cuda")
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
    inc3 = IncrementalClassifier(EXACT(), device="cuda")
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


# --------------------------------------------- the observed fixed point

OBS_DIR = ROOT / "build" / "smoke_runs"
#: the forced sparse tier (the reference's strictest selection test)
#: with capacity rungs up to 64 << 11 = 131,072 rows: at the default 8
#: rungs (8,192 rows) most 64k rounds would overflow to dense
FORCED_WIDE = {"density_threshold": 1.1, "hysteresis_rounds": 1,
               "capacity_buckets": 12}


def observed_run(engine, **kw) -> tuple:
    """One ``saturate_observed``, the launch counts set to 0 just
    before it: the observer's ``(iteration, derivations, changed)``
    sequence; each round's record with the host wall since the previous
    record and the kernel launches in between (a sparse round runs with
    no dense round in flight, so those are its own); the result; the
    wall; the run's launches, read just after it."""
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches

    reset_launches()
    obs, rounds = [], []
    last = [dict(LAUNCHES), 0.0]

    def frontier(st):
        now, t = dict(LAUNCHES), time.perf_counter()
        rounds.append({
            "iteration": st.iteration, "tier": st.tier,
            "density": st.density, "rows_touched": st.rows_touched,
            "derivations": st.derivations, "overflow": st.overflow,
            "inflight": st.inflight, "rounds_in_window": st.rounds_in_window,
            "wall_s": t - last[1],
            "launches": {k: now[k] - last[0][k] for k in now
                         if now[k] != last[0][k]},
        })
        last[0], last[1] = now, t

    on_card = engine.device.type == "cuda"
    if on_card:
        sync()
    t0 = last[1] = time.perf_counter()
    res = engine.saturate_observed(
        observer=lambda *a: obs.append(a), frontier_observer=frontier, **kw
    )
    if on_card:
        sync()
    return obs, rounds, res, time.perf_counter() - t0, dict(LAUNCHES)


def round_records(rounds) -> list:
    """Per round, what card and CPU (or two tiers) must agree on."""
    return [(r["iteration"], r["tier"], r["rows_touched"], r["derivations"],
             r["overflow"], r["inflight"]) for r in rounds]


def tier_string(rounds) -> str:
    return "".join(r["tier"][0] for r in rounds)


def sparse_launches(rounds) -> dict:
    out = {}
    for r in rounds:
        if r["tier"] == "sparse":
            for k, v in r["launches"].items():
                out[k] = out.get(k, 0) + v
    return out


def same_closure(a, b) -> bool:
    return bool(torch.equal(a.packed_s.cpu(), b.packed_s.cpu())
                and torch.equal(a.packed_r.cpu(), b.packed_r.cpu()))


def phase_observed_full_width(cap: Capture, device: str = "cuda",
                              n_chain: int = 64000, chain_depth: int = 64,
                              n_big: int = 64000, n_small: int = CUT_CLASSES,
                              min_sparse: int = 20, refs: Optional[dict] = None):
    """The observed fixed point (``saturate_observed``: the adaptive
    dense/sparse controller, pipelined dense rounds) at full width:

    1. the reference's sparse-tier regime, ``chain_tailed_ontology(64000,
       64)`` at ``unroll=1``, default sparse config, pipeline depth 2:
       held round for round to the dense-only observed run, and to the
       unobserved ``saturate``'s closure and derivations, with at least
       ``min_sparse`` sparse rounds; then both again with the pipeline
       off, whose per-round walls at matching iterations give the
       reference probe's ``low_density_speedup``;
    2. the forced tier on the 64k SNOMED-shaped corpus (threshold 1.1,
       hysteresis 1, 12 capacity rungs), ``unroll=1``: per round equal
       to the dense-only run, closure and taxonomy equal to the default
       classify, every round after the first sparse unless it
       overflowed, and its sparse rounds launching the packed-columns
       kernels; a captured rerun keeps the sparse tier's heaviest CR4
       and CR6 operand pairs, checked as in phase 6;
    3. the user's path: the 64k corpus through the incremental plane
       (what ``cli stream`` runs) with ``obs.ledger.enable``: the base
       rebuild runs observed, its taxonomy equals the unobserved
       rebuild's and the classify's, its ledger holds one record a
       retired round and ``cli runs report`` reads its chain; both
       rebuilds' walls;
    4. the cut corpus, forced tier, ``unroll=1``, on the card and on the
       CPU: every round's record, the observer's sequence, S and R
       equal.

    Returns the checked sparse-tier pairs for the kernel line.  ``refs``
    gets ``"forced_64k"``: the forced run's round records, observer
    sequence, iterations, derivations, closure and taxonomy digests
    (what 7c's forced run on a mesh is held to)."""
    import io

    from distel_tpu_torch import cli
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import (
        chain_tailed_ontology, snomed_shaped_ontology,
    )
    from distel_tpu_torch.obs import ledger as ledger_mod
    from distel_tpu_torch.owl import native_loader
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    on_card = device == "cuda"
    out = {}
    t_phase = time.perf_counter()

    def settle():
        if on_card:
            sync()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def held_equal(what, a, b):
        """Observer sequences, iterations and closures of two runs."""
        if a[0] != b[0]:
            raise AssertionError(f"{what}: the observer sequences differ")
        if a[2].iterations != b[2].iterations or not same_closure(a[2], b[2]):
            raise AssertionError(f"{what}: iterations or closure differ")

    # 1. the chain-tailed regime
    text = chain_tailed_ontology(n_chain, chain_depth)
    idx = native_loader.load_indexed(text)
    del text

    def chain_engine():
        return RowPackedSaturationEngine(idx, device=device, unroll=1)

    ad = observed_run(chain_engine(), sparse_tail=True)
    dn = observed_run(chain_engine(), sparse_tail={"enable": False})
    held_equal("chain-tailed adaptive vs dense-only", ad, dn)
    sat_engine = chain_engine()
    settle()
    t0 = time.perf_counter()
    sat = sat_engine.saturate()
    settle()
    sat_s = time.perf_counter() - t0
    if not same_closure(ad[2], sat) or ad[2].derivations != sat.derivations:
        raise AssertionError("chain-tailed: the observed closure is not saturate's")
    n_sparse = tier_string(ad[1]).count("s")
    if n_sparse < min_sparse:
        raise AssertionError(f"chain-tailed: {n_sparse} sparse rounds < {min_sparse}")
    # the walls with the pipeline off (observer inter-arrival is then
    # each round's own wall, as the reference's probe times it)
    ad_sync = observed_run(chain_engine(), sparse_tail=True, pipeline=False)
    dn_sync = observed_run(chain_engine(), sparse_tail={"enable": False},
                           pipeline=False)
    held_equal("chain-tailed synchronous", ad_sync, dn_sync)
    dense_wall = {r["iteration"]: r["wall_s"] for r in dn_sync[1]}
    speedups = sorted(
        dense_wall[r["iteration"]] / r["wall_s"] for r in ad_sync[1]
        if r["tier"] == "sparse" and r["rows_touched"] and r["wall_s"] > 0
        and r["iteration"] in dense_wall
    )
    out["chain_tailed"] = {
        "concepts": idx.n_concepts, "links": idx.n_links, "roles": idx.n_roles,
        "iterations": ad[2].iterations, "derivations": ad[2].derivations,
        "tiers": tier_string(ad[1]), "sparse_rounds": n_sparse,
        "tiers_synchronous": tier_string(ad_sync[1]),
        "wall_s": {"adaptive": ad[3], "dense_only": dn[3], "saturate": sat_s,
                   "adaptive_synchronous": ad_sync[3],
                   "dense_only_synchronous": dn_sync[3]},
        "round_walls_s": {"adaptive": [(r["iteration"], r["tier"], r["wall_s"])
                                       for r in ad_sync[1]],
                          "dense_only": sorted(dense_wall.items())},
        "low_density_speedup": speedups[len(speedups) // 2] if speedups else None,
        "launches": ad[4],
        "sparse_round_launches": sparse_launches(ad[1]),
    }
    log(f"[observed chain-tailed] {json.dumps(out['chain_tailed'])}")
    del ad, dn, ad_sync, dn_sync, sat, sat_engine, idx
    free()

    # 2. the forced tier at 64k
    text = snomed_shaped_ontology(n_classes=n_big, seed=42)
    idx = native_loader.load_indexed(text)

    def big_engine():
        return RowPackedSaturationEngine(idx, device=device, unroll=1)

    fo_engine = big_engine()
    fo = observed_run(fo_engine, sparse_tail=FORCED_WIDE)
    dn = observed_run(big_engine(), sparse_tail={"enable": False})
    held_equal("64k forced vs dense-only", fo, dn)
    late = [r for r in fo[1][1:] if r["tier"] not in ("sparse", "idle")
            and not r["overflow"]]
    if fo[1][0]["tier"] != "dense" or late:
        raise AssertionError(f"64k forced: rounds that did not run sparse: {late}")
    fo_launches = sparse_launches(fo[1])
    if not any(v for k, v in fo_launches.items() if k.startswith("packed_cols")) \
            or not all(fo[4][k] for k in chosen_kernels(fo_engine)):
        raise AssertionError(f"64k forced: kernels not launched: {fo[4]}, "
                             f"sparse rounds {fo_launches}")
    t0 = time.perf_counter()
    classified = ELClassifier(EXACT(), device=device).classify_text(text)
    classify_s = time.perf_counter() - t0
    want_key = taxonomy_key(classified.taxonomy)
    if fo[2].derivations != classified.result.derivations \
            or not same_closure(fo[2], classified.result):
        raise AssertionError("64k forced: closure or derivations differ from the classify")
    fo_tax = extract_taxonomy(fo[2])
    if taxonomy_key(fo_tax) != want_key:
        raise AssertionError("64k forced: taxonomy differs from the classify")
    if refs is not None:
        refs["forced_64k"] = {
            "records": round_records(fo[1]), "events": observer_events(fo[0]),
            "iterations": fo[2].iterations, "derivations": fo[2].derivations,
            "digests": digests_later(fo[2], fo_tax),
        }
    del fo_tax
    out["forced_64k"] = {
        "concepts": idx.n_concepts, "iterations": fo[2].iterations,
        "derivations": fo[2].derivations, "tiers": tier_string(fo[1]),
        "overflow_rounds": sum(r["overflow"] for r in fo[1]),
        "rounds": [{k: r[k] for k in ("iteration", "tier", "rows_touched",
                                       "derivations", "overflow", "wall_s",
                                       "launches")} for r in fo[1]],
        "dense_only_round_walls_s": [(r["iteration"], r["wall_s"]) for r in dn[1]],
        "wall_s": {"forced": fo[3], "dense_only": dn[3], "classify": classify_s},
        "launches": fo[4],
        "sparse_round_launches": fo_launches,
    }
    log(f"[observed forced 64k] {json.dumps(out['forced_64k'])}")
    del fo, fo_engine, dn, classified
    free()
    # the sparse tier's operands: a captured rerun, the heaviest pair per
    # site and kernel kept and checked
    cap.run = "observed:forced64k"
    with cap:
        big_engine().saturate_observed(sparse_tail=FORCED_WIDE)
    heaviest = {}
    for key in [k for k in cap.pairs if k[0] == cap.run]:
        n, nnz, a, b = cap.pairs.pop(key)
        if not key[1].startswith("sparse"):
            continue
        got = heaviest.setdefault(key[:3], [0, -1, None, None])
        got[0] += n
        if nnz > got[1]:
            got[1:] = [nnz, a, b]
    cap.run = ""
    pairs = [check_pair(*key, n, a, b)
             for key, (n, _nnz, a, b) in sorted(heaviest.items())]
    if {p["site"] for p in pairs} != {"sparse_cr4", "sparse_cr6"}:
        raise AssertionError(f"64k forced: captured sites {sorted(heaviest)}")
    out["forced_64k"]["kernel_checks"] = [
        {k: p[k] for k in ("site", "main_path_kernel", "shape", "launches",
                           "max_abs_err", "dense_ms", "sparse_ms", "plain_ms",
                           "bound_ms", "bound_by")} for p in pairs]
    free()

    # 3. the user's path: a ledgered rebuild through the incremental plane
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    rebuilds = {}
    for ledger in (True, False):
        cfg = EXACT(obs_ledger=ledger, obs_ledger_dir=str(OBS_DIR))
        inc = IncrementalClassifier(cfg, device=device)
        settle()
        t0 = time.perf_counter()
        res = inc.add_text(text)
        settle()
        wall = time.perf_counter() - t0
        key = taxonomy_key(extract_taxonomy(res))
        engine = inc._base_engine
        rebuilds["observed" if ledger else "unobserved"] = {
            "wall_s": wall, "phases_s": dict(inc.timer.phases),
            "iterations": res.iterations, "derivations": res.derivations,
            "path": inc.history[-1]["path"],
            "tiers": "".join(st.tier[0] for st in engine.frontier_rounds),
            "taxonomy_equal": key == want_key,
        }
        if key != want_key:
            raise AssertionError(f"ledgered rebuild (ledger={ledger}): taxonomy differs")
        if ledger:
            n_rounds = len(engine.frontier_rounds)
        del inc, res, engine
        free()
    if rebuilds["unobserved"]["tiers"]:
        raise AssertionError("the unledgered rebuild ran observed")
    files = sorted(OBS_DIR.glob("*.ledger.jsonl"))
    if len(files) != 1:
        raise AssertionError(f"ledgered rebuild: ledger files {files}")
    recs = ledger_mod.read_ledger(str(files[0]))
    n_round_recs = sum(1 for r in recs if r["ev"] == "round")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["runs", "report", str(files[0]), "--json"])
    report = json.loads(buf.getvalue())
    if rc != 0 or n_round_recs != n_rounds or report["rounds"] != n_rounds \
            or not report["converged"]:
        raise AssertionError(f"ledgered rebuild: {n_round_recs} records, {n_rounds} "
                             f"rounds, report {report.get('rounds')} rc {rc}")
    out["ledgered_rebuild"] = {
        **rebuilds, "ledger_round_records": n_round_recs,
        "report": {k: report[k] for k in ("rounds", "tiers", "derivations_total",
                                          "wall_s", "converged")},
    }
    log(f"[observed ledgered rebuild] {json.dumps(out['ledgered_rebuild'])}")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    del idx, text

    # 4. card vs CPU at 8k, forced
    idx8 = native_loader.load_indexed(snomed_shaped_ontology(n_classes=n_small, seed=42))
    g = observed_run(RowPackedSaturationEngine(idx8, device=device, unroll=1),
                     sparse_tail=FORCED_WIDE)
    c = observed_run(RowPackedSaturationEngine(idx8, device="cpu", unroll=1),
                     sparse_tail=FORCED_WIDE)
    if round_records(g[1]) != round_records(c[1]) or g[0] != c[0] \
            or not same_closure(g[2], c[2]):
        raise AssertionError("cut forced: card and CPU rounds differ")
    out["card_vs_cpu_cut"] = {
        "concepts": idx8.n_concepts, "tiers": tier_string(g[1]),
        "rounds": len(g[1]), "wall_s": {"card": g[3], "cpu": c[3]},
        "sparse_round_launches": sparse_launches(g[1]),
    }
    del g, c
    free()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[observed] {json.dumps(out['card_vs_cpu_cut'])} phase {out['phase_s']:.1f} s")
    print(json.dumps({"observed_full_width": out}), flush=True)
    return pairs


# ------------------------------------------------------ the fused window

GRAPH_IF_SOURCE = "distel_tpu_torch/ops/csrc/graph_if.cu"
#: the 8k overflow configuration: a one-rung workspace of 8 rows, so the
#: busy rounds fall out of the window
OVERFLOW_8 = {"density_threshold": 1.1, "hysteresis_rounds": 1,
              "capacity_buckets": 1, "capacity_floor": 8}


def fused_records(rounds) -> list:
    """Per round, what a fused run and the per-round run must agree on
    (the occupancy and the window size are the window's own)."""
    return [(r["iteration"], r["tier"], r["rows_touched"], r["derivations"],
             r["overflow"]) for r in rounds]


def fused_run(engine, **kw) -> tuple:
    """:func:`observed_run` of a fused run, with the IF setter's
    launches zeroed just before too, and the window counters: rounds a
    retired window retired, fallouts, windows dropped, the dispatch
    counters' deltas, the host's blocking reads, the captured windows."""
    from distel_tpu_torch.ops import graph_if
    from distel_tpu_torch.runtime.instrumentation import DISPATCH_EVENTS

    graph_if.reset_launches()
    before = DISPATCH_EVENTS.snapshot()
    run = observed_run(engine, **kw)
    after = DISPATCH_EVENTS.snapshot()
    info = {
        **{k: v for k, v in engine.fused_run_stats.items()},
        "dispatch": {k: after[k] - before[k] for k in
                     ("dense_dispatches", "sparse_dispatches", "fused_windows",
                      "fused_rounds_retired")},
        "host_reads": dict(engine.host_reads),
        "launches": {**run[4], **graph_if.LAUNCHES},
        "captured": engine.fused_window_stats(),
    }
    return run, info


def variant_operands(engine, res) -> list:
    """The heaviest contraction window of each CR4/CR6 row-chunk table of
    ``engine`` (rows × links), as the window's dense step builds it from
    the final state ``res``: ``(rule, A, B, the engine's route)``."""
    from distel_tpu_torch.ops.bitpack import bit_lookup_from

    sp, rp = res.packed_s, res.packed_r
    out = []
    for rule, chunks, bits_state in (("cr4", engine._chunks4, sp),
                                     ("cr6", engine._chunks6, rp)):
        best = max(((c.src.shape[0] * (e - o), c, o, e) for c in chunks
                    for o, e, _c0, _c1 in c.windows), default=None,
                   key=lambda t: t[0])
        if best is None:
            continue
        _work, chunk, off, end = best
        subt = bits_state[chunk.src].T.contiguous()
        f = bit_lookup_from(subt, engine._fillers[off:end], dtype=torch.int8)
        a = (chunk.mask[:, engine._link_roles[off:end]] * f.T).contiguous()
        route = engine._plan(a.shape[0], a.shape[1]).skip_zero_tiles
        out.append((rule, a, rp[off:end].contiguous(), route))
    return out


def check_variants(ops) -> list:
    """Both row-count variants (the dense kernel, and the listing
    kernel then the sparse kernel) on every operand, against the plain
    version for row counts 0 (a dead window), 1, half and all of A's
    rows, ORed into a seeded C; then each variant's time at every row
    live and at none, the plain version's and the bound."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, plain_packed_cols_rows,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    checks = []
    for rule, a, b, route in ops:
        m, l = a.shape
        w = b.shape[1]
        c0 = torch.randint(-2**31, 2**31, (m, w), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
        for sparse in (False, True):
            plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=sparse)
            err = 0
            for n in (0, 1, m // 2, m):
                nr = torch.full((1,), n, dtype=torch.int32, device="cuda")
                got = plan(a, b, out=c0.clone(), n_rows=nr)
                want = plain_packed_cols_rows(a, b, c0.clone(), nr)
                sync()
                err = max(err, int((got != want).sum()))
            if err:
                raise AssertionError(f"row-count variant {rule} sparse={sparse}: "
                                     f"{err} words differ from plain")
            c = c0.clone()
            full = torch.full((1,), m, dtype=torch.int32, device="cuda")
            dead = torch.zeros(1, dtype=torch.int32, device="cuda")
            row = {
                "kernel": "packed_cols_list_n" if sparse else "packed_cols_dense_n",
                "rule": rule, "shape": [m, l, w], "main_path": sparse == route,
                "max_abs_err": err,
                "ms": time_ms(lambda: plan(a, b, out=c, n_rows=full)),
                "dead_ms": time_ms(lambda: plan(a, b, out=c, n_rows=dead)),
                "plain_ms": time_ms(lambda: plain_packed_cols_rows(a, b, c, full),
                                    reps=3),
                "a_nonzero_fraction": float((a != 0).float().mean()),
            }
            row["bound_ms"], row["bound_by"] = bound_ms(a, b)
            checks.append(row)
            log(f"[fused variant] {json.dumps(row)}")
    return checks


def graph_if_check() -> dict:
    """The IF node against a Python ``if`` (the plain version): a graph
    of two IF nodes replayed under every pair of predicates, each
    result equal to the branches run by hand; then the time a node
    takes (a graph of 64 IF nodes with empty bodies, replayed, over the
    count) beside a host read of the predicate, its plain version."""
    from distel_tpu_torch.ops import graph_if

    x = torch.zeros(2, dtype=torch.int64, device="cuda")
    p = torch.zeros(2, dtype=torch.bool, device="cuda")
    graph, pool, child = torch.cuda.CUDAGraph(), torch.cuda.MemPool(), \
        torch.cuda.Stream()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        graph_if.capture_if(p[0], lambda: x[0:1].add_(1), child, pool)
        graph_if.capture_if(p[1], lambda: x[1:2].add_(x[0:1] * 10 + 1), child, pool)
    want, err = [0, 0], 0
    for p0, p1 in ((False, False), (True, False), (False, True), (True, True)):
        p.copy_(torch.tensor([p0, p1]))
        graph.replay()
        if p0:
            want[0] += 1
        if p1:
            want[1] += want[0] * 10 + 1
        err = max(err, max(abs(g - h) for g, h in zip(x.tolist(), want)))
    if err:
        raise AssertionError(f"IF nodes: {x.tolist()} != {want}")
    n = 64
    empty = torch.cuda.CUDAGraph()
    pool2 = torch.cuda.MemPool()
    q = torch.zeros((), dtype=torch.bool, device="cuda")
    y = torch.zeros(1, dtype=torch.int64, device="cuda")
    with torch.cuda.graph(empty, capture_error_mode="thread_local"):
        for _ in range(n):
            graph_if.capture_if(q, lambda: y.add_(1), child, pool2)
    empty.replay()
    sync()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(10):
        empty.replay()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1) / (10 * n)
    plain_ms = wall_ms(lambda: bool(q), reps=100)
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * 1 / PEAK_BYTES_S, "bound_by": "bytes"}
    log(f"[graph_if] {json.dumps(out)}")
    return out


def phase_fused_full_width(device: str = "cuda", n_chain: int = 64000,
                           chain_depth: int = 64, n_big: int = 64000,
                           n_small: int = CUT_CLASSES, refs: Optional[dict] = None):
    """The fused K-round window (``fused_rounds``: K rounds of the
    adaptive controller a captured CUDA graph, one host read a window)
    at full width, each run held round for round and in closure to the
    per-round controller:

    1. ``chain_tailed_ontology(64000, 64)``, ``unroll=1``, the default
       sparse config and pipeline: the per-round run (synchronous, what
       the windows' rounds equal; pipelined, for its wall), then K = 4,
       K = 8
       (THE main path of this phase: its launches, the row-count kernel
       variants and the IF setter among them, are read from that run
       alone) and K = 8 adaptive, each cold (its captures inside) and
       again warm on the same engine;
    2. the forced tier on the 64k corpus (threshold 1.1, hysteresis 1,
       12 rungs), K = 8, against the per-round forced run, cold and
       warm; the row-count variants at the heaviest CR4 and CR6 windows
       of its final state, both routes, against the plain version;
    3. the 64k corpus through the incremental plane with
       ``obs.ledger.enable = true`` and ``fused.rounds.k = 8`` read from
       a properties file: the closure of the unfused (unobserved)
       rebuild, ledger records with ``rounds_in_window`` > 1;
    4. the cut corpus, K = 4, forced and with the one-rung overflow
       config, on the card and on the CPU: every record (window sizes
       and occupancy included), the observer's sequence, S and R equal.

    Returns the kernel line's rows of the row-count variants and the IF
    setter.  ``refs`` gets ``"chain_per_round"``: the synchronous
    per-round run's records, observer sequence, iterations, derivations,
    closure and taxonomy digests (what 7c's fused run on a mesh is held
    to)."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.frontend.ontology_tools import (
        chain_tailed_ontology, snomed_shaped_ontology,
    )
    from distel_tpu_torch.obs import ledger as ledger_mod
    from distel_tpu_torch.owl import native_loader
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    on_card = device == "cuda"
    out = {}
    t_phase = time.perf_counter()

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def held_equal(what, got, want):
        if got[0] != want[0]:
            raise AssertionError(f"{what}: the observer sequences differ")
        if fused_records(got[1]) != fused_records(want[1]):
            raise AssertionError(f"{what}: the round records differ")
        if got[2].iterations != want[2].iterations \
                or got[2].derivations != want[2].derivations \
                or not same_closure(got[2], want[2]):
            raise AssertionError(f"{what}: iterations, derivations or closure differ")

    def summary(run, info, warm):
        return {
            "wall_s": run[3], "warm_wall_s": warm[3],
            "rounds": len(run[1]), "tiers": tier_string(run[1]),
            "window_rounds": info["windows"], "fallouts": info["fallouts"],
            "dropped": info["dropped"], "dispatch": info["dispatch"],
            "host_reads": info["host_reads"], "launches": info["launches"],
            "captured": info["captured"],
        }

    # 1. the chain-tailed regime, K = 4, 8, 8 adaptive
    idx = native_loader.load_indexed(chain_tailed_ontology(n_chain, chain_depth))

    def chain_engine():
        return RowPackedSaturationEngine(idx, device=device, unroll=1)

    # the per-round controller, synchronous: what a window's retired
    # rounds equal (a pipelined per-round run may switch tiers up to
    # depth - 1 rounds late); and pipelined, the default, for its wall
    base_engine = chain_engine()
    base = observed_run(base_engine, sparse_tail=True, pipeline=False)
    if refs is not None:
        refs["chain_per_round"] = {
            "records": fused_records(base[1]), "events": observer_events(base[0]),
            "iterations": base[2].iterations, "derivations": base[2].derivations,
            "digests": digests_later(base[2], extract_taxonomy(base[2])),
        }
    piped = observed_run(chain_engine(), sparse_tail=True)
    chain = {"concepts": idx.n_concepts, "per_round": {
        "wall_s": base[3], "rounds": len(base[1]), "tiers": tier_string(base[1]),
        "host_reads": dict(base_engine.host_reads), "launches": base[4],
        "pipelined_wall_s": piped[3], "pipelined_tiers": tier_string(piped[1])}}
    del base_engine, piped
    main = None
    for label, fused in (("K4", {"rounds": 4}), ("K8", {"rounds": 8}),
                         ("K8_adaptive", {"rounds": 8, "adaptive": True})):
        eng = chain_engine()
        run, info = fused_run(eng, sparse_tail=True, fused_rounds=fused)
        held_equal(f"chain-tailed {label}", run, base)
        warm, _ = fused_run(eng, sparse_tail=True, fused_rounds=fused)
        held_equal(f"chain-tailed {label} warm", warm, base)
        chain[label] = summary(run, info, warm)
        if label == "K8":
            main = info["launches"]
        log(f"[fused chain-tailed {label}] {json.dumps(chain[label])}")
        del eng, run, warm
        free()
    if on_card and (not (main["packed_cols_dense_n"] + main["packed_cols_list_n"])
                    or not main["graph_if_set"]):
        raise AssertionError(f"chain-tailed K8: the window's kernels were not "
                             f"launched: {main}")
    out["chain_tailed"] = chain
    del base, idx
    free()

    # 2. the forced tier at 64k, K = 8
    text = snomed_shaped_ontology(n_classes=n_big, seed=42)
    idx = native_loader.load_indexed(text)

    def big_engine():
        return RowPackedSaturationEngine(idx, device=device, unroll=1)

    base = observed_run(big_engine(), sparse_tail=FORCED_WIDE, pipeline=False)
    eng = big_engine()
    run, info = fused_run(eng, sparse_tail=FORCED_WIDE, fused_rounds={"rounds": 8})
    held_equal("64k forced K8", run, base)
    warm, _ = fused_run(eng, sparse_tail=FORCED_WIDE, fused_rounds={"rounds": 8})
    held_equal("64k forced K8 warm", warm, base)
    out["forced_64k"] = {"concepts": idx.n_concepts,
                         "per_round": {"wall_s": base[3], "tiers": tier_string(base[1])},
                         "K8": summary(run, info, warm)}
    log(f"[fused forced 64k] {json.dumps(out['forced_64k'])}")
    checks = check_variants(variant_operands(eng, warm[2]))
    del base, eng, run, warm
    free()

    # 3. the ledgered rebuild with K = 8 from a properties file
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    props = OBS_DIR / "fused.properties"
    props.write_text(f"obs.ledger.enable = true\nobs.ledger.dir = {OBS_DIR}\n"
                     "fused.rounds.k = 8\nshape.buckets = false\n")
    rebuilds = {}
    for label, cfg in (("fused", ClassifierConfig.from_properties(str(props))),
                       ("unfused", EXACT())):
        inc = IncrementalClassifier(cfg, device=device)
        sync()
        t0 = time.perf_counter()
        res = inc.add_text(text)
        sync()
        engine = inc._base_engine
        rebuilds[label] = {
            "wall_s": time.perf_counter() - t0, "iterations": res.iterations,
            "derivations": res.derivations,
            "tiers": "".join(st.tier[0] for st in engine.frontier_rounds),
            "rounds_in_window": [st.rounds_in_window for st in engine.frontier_rounds],
            "captured": engine.fused_window_stats(),
            "result": res,
        }
        del inc, engine, res
    fz, uf = rebuilds["fused"].pop("result"), rebuilds["unfused"].pop("result")
    if fz.derivations != uf.derivations or not same_closure(fz, uf):
        raise AssertionError("ledgered fused rebuild: closure differs from the unfused")
    (ledger_file,) = sorted(OBS_DIR.glob("*.ledger.jsonl"))
    recs = [r for r in ledger_mod.read_ledger(str(ledger_file)) if r["ev"] == "round"]
    if not recs or max(r["rounds_in_window"] for r in recs) <= 1:
        raise AssertionError(f"ledgered fused rebuild: window sizes "
                             f"{[r['rounds_in_window'] for r in recs]}")
    out["ledgered_rebuild"] = {**rebuilds, "ledger_round_records": len(recs),
                               "records_rounds_in_window":
                                   [r["rounds_in_window"] for r in recs]}
    log(f"[fused ledgered rebuild] {json.dumps(out['ledgered_rebuild'])}")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    del fz, uf, idx, text
    free()

    # 4. card vs CPU at 8k: forced and overflow, K = 4
    idx8 = native_loader.load_indexed(snomed_shaped_ontology(n_classes=n_small, seed=42))
    out["card_vs_cpu_cut"] = {}
    for label, sparse in (("forced", FORCED_WIDE), ("overflow", OVERFLOW_8)):
        g, ginfo = fused_run(RowPackedSaturationEngine(idx8, device=device, unroll=1),
                             sparse_tail=sparse, fused_rounds={"rounds": 4})
        c, cinfo = fused_run(RowPackedSaturationEngine(idx8, device="cpu", unroll=1),
                             sparse_tail=sparse, fused_rounds={"rounds": 4})
        recs_g = [(*x, r["inflight"], r["rounds_in_window"])
                  for x, r in zip(fused_records(g[1]), g[1])]
        recs_c = [(*x, r["inflight"], r["rounds_in_window"])
                  for x, r in zip(fused_records(c[1]), c[1])]
        if recs_g != recs_c or g[0] != c[0] or not same_closure(g[2], c[2]) \
                or ginfo["fallouts"] != cinfo["fallouts"]:
            raise AssertionError(f"cut {label}: card and CPU fused runs differ")
        out["card_vs_cpu_cut"][label] = {
            "tiers": tier_string(g[1]), "window_rounds": ginfo["windows"],
            "fallouts": ginfo["fallouts"], "wall_s": {"card": g[3], "cpu": c[3]},
        }
        del g, c
    free()
    if_check = graph_if_check()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[fused] cut {json.dumps(out['card_vs_cpu_cut'])} phase {out['phase_s']:.1f} s")
    print(json.dumps({"fused_full_width": out}), flush=True)

    rows = []
    for kern, replaces in (("packed_cols_dense_n", REPLACES["packed_cols_dense"]),
                           ("packed_cols_list_n", REPLACES["packed_cols_sparse"])):
        mine = [c for c in checks if c["kernel"] == kern]
        pool = [c for c in mine if c["main_path"]] or mine
        top = max(pool, key=lambda c: c["shape"][0] * c["shape"][1] * c["shape"][2])
        row = {
            "name": kern, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": main[kern],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "dead_ms": top["dead_ms"],
            "at": {"run": "forced64k:final", "rule": top["rule"],
                   "shape": top["shape"]},
            "main_path": top["main_path"],
        }
        if kern == "packed_cols_list_n":
            row["sparse_launches"] = main["packed_cols_sparse"]
        rows.append(row)
    rows.append({
        "name": "graph_if_set", "route": "cuda", "source": GRAPH_IF_SOURCE,
        "replaces": "distel_tpu/core/rowpacked_engine.py:3026 (the cond of "
                    "_fused_exec's lax.while_loop and its lax.switch; no Pallas "
                    "kernel)",
        "launches": main["graph_if_set"], **if_check, "library_ms": None,
    })
    return rows


# ------------------------------------------------------- the serve plane

#: answer fields that are clock readings (taken out before comparing)
SERVE_CLOCK_KEYS = ("published_unix",)
#: a write record's program-build fields: the signatures name the device
#: (and an exact engine's the card's temporary budget), the walls are the
#: device's, so card and CPU records differ there by construction
BUILD_KEYS = {"bucket_signature", "program", "trace_lower_s", "compile_s",
              "program_cache_hit", "persistent_cache_hits",
              "persistent_cache_misses", "delta_signature"}


def without_build(doc):
    """``doc`` (a record, or a ``(status, record)`` answer) without its
    :data:`BUILD_KEYS`."""
    if isinstance(doc, tuple):
        return tuple(without_build(d) for d in doc)
    if isinstance(doc, dict):
        return {k: v for k, v in doc.items() if k not in BUILD_KEYS}
    return doc
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
            self.answers.append((name, without_build(
                {k: v for k, v in doc.items() if k not in SERVE_CLOCK_KEYS})))
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


def phase_serve_card_vs_cpu(n_classes: int = CUT_CLASSES) -> dict:
    """The serve plane on the card and on the CPU: ``ServeApp()`` (the
    card by default) and ``ServeApp(device="cpu")`` driven through
    ``dispatch`` with the bench's traffic over the cut corpus without its
    range axiom (load, the three deltas, the retraction; the scheduled
    and snapshot reads after each write), every answer equal; then the
    tracked mixed trace replayed over loopback HTTP against a card and a
    CPU server, and again with ``engine = packed``, whose card app then
    also serves the cut corpus and the class-only delta — every answer
    equal.  Launch counts are zeroed just before each card app's traffic
    and read just after."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.serve.server import ServeApp

    from distel_tpu_torch.runtime.classifier import resolve_device

    text8 = snomed_shaped_ontology(n_classes=n_classes, seed=42)
    text = without_ranges(text8)
    out, answers = {"n_classes": n_classes}, {}
    for dev in ("cuda", "cpu"):
        app = ServeApp(EXACT()) if dev == "cuda" else ServeApp(EXACT(), device="cpu")
        if app.registry.device != resolve_device(dev):
            raise AssertionError(f"serve card/cpu: ServeApp runs on {app.registry.device}")
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
        if without_build(c) != without_build(p):
            raise AssertionError(f"serve card/cpu: answer {i} differs card/cpu: "
                                 f"{str(c)[:300]} / {str(p)[:300]}")
    # BenchDelta3 is unknown (404) to the reads naming it before the
    # class-only delta adds it, and to the taxonomy's subsumers after its
    # retraction (the snapshot keeps the retired concept id: its
    # subsumption test answers); 7 answers a write
    refused = {i: st for i, (st, _a) in enumerate(answers["cuda"]) if st not in (200, 201)}
    if len(answers["cuda"]) != len(answers["cpu"]) or \
            refused != {2: 404, 3: 404, 30: 404}:
        raise AssertionError(f"serve card/cpu: requests refused: {refused}")
    writes = [a for st, a in answers["cuda"] if st in (200, 201) and "path" in a]
    out["paths"] = [w["path"] for w in writes]
    if out["paths"] != ["rebuild", "fast", "fast", "fast", "retract"] and \
            out["paths"] != ["rebuild", "fast", "fast", "rebuild", "retract"]:
        raise AssertionError(f"serve card/cpu: paths {out['paths']}")
    for k in out["chosen"]:
        if out["launches"][k] == 0:
            raise AssertionError(f"serve card/cpu: {k} was never launched")
    out["answers"] = len(answers["cuda"])
    # the tracked trace on the card and the CPU; then the card app also
    # serves the 8k corpus and the class-only delta, and the packed
    # engine's answers must equal the row-packed engine's
    tenant = {}
    for engine in ("auto", "packed"):
        runs = {}
        for dev in ("cuda", "cpu"):
            app = ServeApp(EXACT(engine=engine), device=dev)
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
        out[f"tenant_{engine}"] = {"wall_s": t8, "launches": l8,
                                     "paths": [a["path"] for _s, a in ops[:2]]}
    # the trace's toy tenants reach the packed-columns kernels through
    # their taxonomy products at least; the packed tenant's CR4/CR6 run
    # the packed-contraction route
    for engine, lc in (("auto", out["replay_auto"]["launches"]),
                       ("packed", out["tenant_packed"]["launches"])):
        ran = lc["packed_andor_list"] if engine == "packed" else \
            lc["packed_cols_dense"] + lc["packed_cols_sparse"]
        if ran == 0:
            raise AssertionError(f"serve {engine}: its kernels were never launched")
    # the engines step differently (iterations; the row-packed engine's
    # fast path and its accounting) and pad their packed rows
    # differently (a snapshot's bytes); the answers agree
    engine_keys = ("path", "iterations", "delta_bucketed", "delta_programs",
                   "delta_program_hits",
                   "snapshot_bytes")
    row, packed = ([(st, {k: v for k, v in without_build(a).items()
                          if k not in engine_keys})
                    for st, a in tenant[e][0]] for e in ("auto", "packed"))
    if row != packed:
        bad = next(i for i, (x, y) in enumerate(zip(row, packed)) if x != y)
        raise AssertionError(f"serve card/cpu: the packed engine's answer {bad} differs: "
                             f"{str(packed[bad])[:300]} / {str(row[bad])[:300]}")
    log(f"[serve card/cpu] {json.dumps(out)}")
    print(json.dumps({"serve_card_vs_cpu": out}), flush=True)
    return out


def publish_seconds(app) -> float:
    """The serve metrics' summed snapshot build-and-swap seconds."""
    for ln in app.metrics.render().splitlines():
        if ln.startswith("distel_query_publish_seconds_sum"):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def phase_serve_full_width(cap: Capture, n_big: int = 64000):
    """The resident server: ``ServeApp(device="cuda")``
    behind ``make_server`` on a loopback port, two workers and a spill
    directory, driven over HTTP by ``ServeClient`` under the capture; once
    the big tenant's state is known, the card-memory budget is set to its
    bytes (it holds that tenant, not it and a second one together).  The
    big corpus (``n_big`` classes of the 64k corpus's generator, the
    records' ``tag``) without its range axiom is loaded, takes the three
    deltas and the retraction of the class-only delta; after each write
    every served taxonomy is held, by name, to a
    from-scratch card classify of the accumulated text (and the
    tenant's closure by ``named_closure_equal``), and ``query/subsumers``
    of sampled classes to that taxonomy's subsumers.  The 8k corpus as
    a second tenant evicts the big one to the warm tier (it must give
    the card back at least its state's bytes); a scheduled read
    promotes it.  With the warm tier turned off, a read of the 8k tenant
    spills the big one cold, and a read of it restores it from the
    spill.  Then one concurrent burst (a delta to one tenant, reads of
    both, one client thread a request; the reads held to the same reads
    served one at a time), and the graceful close with its final spill.
    Per request: the client wall, the tenant's phases, path, iterations,
    launches, host peak RSS and card memory; the snapshot publish
    seconds.  The captured operand pairs are checked as in phase 6 and
    returned for the kernel line."""
    import threading

    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.serve.client import ServeClient
    from distel_tpu_torch.serve.registry import _state_bytes
    from distel_tpu_torch.serve.server import ServeApp

    tag = f"{n_big // 1000}k"
    big = without_ranges(snomed_shaped_ontology(n_classes=n_big, seed=42))
    small = snomed_shaped_ontology(n_classes=8000, seed=42)
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory = {"before_load": torch.cuda.memory_allocated()}
    # the warm tier holds the whole big state on the host (about 1.9 GB at 64k)
    cfg = EXACT(storage_warm_budget_mb=16384)
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
            log(f"[serve {tag}] {json.dumps(rec)}")
            records.append(rec)
            return doc

        def check(oid, texts, what):
            """The served taxonomy and sampled snapshot subsumers against
            a from-scratch card classify of ``texts``."""
            t0 = time.perf_counter()
            served = request(f"taxonomy:{what}", oid, lambda: client.taxonomy(oid))
            batch = ELClassifier(EXACT(), device="cuda").classify_text(
                "\n".join(texts) + "\n")
            tax = batch.taxonomy
            if (served["parents"], served["equivalents"],
                    sorted(served["unsatisfiable"])) != taxonomy_key(tax):
                raise AssertionError(f"serve {tag} {what}: taxonomy differs from a classify")
            inc = app.registry._entries[oid].inc
            if not named_closure_equal(inc.last_result, batch.result):
                raise AssertionError(f"serve {tag} {what}: named subsumers differ")
            names = sorted(tax.subsumers)
            for cls in rng.choice(names, 24, replace=False).tolist():
                got = client.query_subsumers(oid, cls)["subsumers"]
                if got != tax.subsumers[cls]:
                    raise AssertionError(f"serve {tag} {what}: query/subsumers {cls}")
            del batch
            log(f"[serve {tag}] {what}: equal to a from-scratch classify "
                f"({time.perf_counter() - t0:.1f} s)")
            return names

        def reads(oid, cls):
            return [client.subsumers(oid, cls), client.query_subsumers(oid, cls),
                    client.taxonomy_slice(oid, cls), client.snapshot_version(oid)]

        a = request(f"load:{tag}", None, lambda: client.load(big))["id"]
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
            raise AssertionError(f"serve {tag}: write paths {paths}")
        # the writes ran every kernel of the routes the tenant's plans chose
        for k in chosen_kernels(app.registry._entries[a].inc._base_engine):
            if not any(r["launches"][k] for r in records):
                raise AssertionError(f"serve {tag}: {k} was never launched")
        # from here the card budget holds the big tenant alone
        state_a = _state_bytes(app.registry._entries[a].inc)
        # the programs earlier phases left idle go now, not inside the
        # evictions measured here (the budget would drop them first)
        bucketing.drop_idle_programs("cuda")
        app.registry.memory_budget_bytes = state_a
        memory["before_evict"] = torch.cuda.memory_allocated()
        # round 1: the second tenant evicts the big one to the warm tier
        b = request("load:8k", None, lambda: client.load(small))["id"]
        entry_a, entry_b = app.registry._entries[a], app.registry._entries[b]
        if entry_a.inc is not None or entry_a.warm_inc is None:
            raise AssertionError(f"serve {tag}: the 8k load did not demote the {tag} tenant")
        sync()
        held_b = sum(device_bytes(entry_b.inc).values())
        memory["after_evict_warm"] = torch.cuda.memory_allocated()
        freed_warm = memory["before_evict"] + held_b - memory["after_evict_warm"]
        if freed_warm < state_a:
            raise AssertionError(f"serve {tag}: the warm eviction freed {freed_warm} B "
                                 f"of a {state_a} B state")
        request(f"promote:{tag}", a, lambda: client.taxonomy(a))
        memory["after_promote"] = torch.cuda.memory_allocated()
        if entry_a.inc is None or entry_b.inc is not None:
            raise AssertionError(f"serve {tag}: the read did not promote the {tag} tenant")
        # round 2: no warm tier; the 8k tenant's read spills the big one cold
        app.registry.warm_budget_bytes = 0
        request("promote:8k", b, lambda: client.taxonomy(b))
        sync()
        memory["after_evict_cold"] = torch.cuda.memory_allocated()
        if entry_a.inc is not None or entry_a.warm_inc is not None or not entry_a.spill_path:
            raise AssertionError(f"serve {tag}: the {tag} tenant was not spilled cold")
        held_b = sum(device_bytes(entry_b.inc).values())
        freed_cold = memory["after_promote"] + held_b - memory["after_evict_cold"]
        if freed_cold < state_a:
            raise AssertionError(f"serve {tag}: the cold spill freed {freed_cold} B "
                                 f"of a {state_a} B state")
        request(f"restore:{tag}", a, lambda: client.taxonomy(a))
        memory["after_restore"] = torch.cuda.memory_allocated()
        if records[-1].get("path") != "restore":
            raise AssertionError(f"serve {tag}: the read did not restore the {tag} tenant")
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
                raise AssertionError(f"serve {tag}: a burst request never returned")
        burst = {"requests": len(jobs), "wall_s": time.perf_counter() - t0,
                 "launches": dict(LAUNCHES), "delta": {k: got[0].get(k) for k in
                                                     ("path", "iterations", "version")}}
        if errors:
            raise AssertionError(f"serve {tag}: burst failures {errors}")
        for i, (kind, oid, cls) in enumerate(jobs):
            if kind == "read" and oid == a:
                if got[i] != [client.subsumers(oid, cls), client.query_subsumers(oid, cls)]:
                    raise AssertionError(f"serve {tag}: burst read {cls} differs from serial")
            elif kind == "taxonomy":
                if got[i] != client.taxonomy(oid):
                    raise AssertionError(f"serve {tag}: burst taxonomy differs from serial")
        check(b, [small, burst_delta], "burst delta (8k)")
        log(f"[serve {tag}] burst {json.dumps(burst)}")
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
        raise AssertionError(f"serve {tag}: close spilled {spilled}, tiers {tiers}")
    pairs = [check_pair(*key[:3], n, a_, b_)
             for key, (n, _nnz, a_, b_) in sorted(cap.pairs.items()) if key[0] == "serve"]
    for key in [k for k in cap.pairs if k[0] == "serve"]:
        del cap.pairs[key]
    if not pairs:
        raise AssertionError(f"serve {tag}: no operand pair was captured")
    out = {
        "requests": records,
        "write_paths": paths,
        f"state_bytes_{tag}": state_a,
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
    log(f"[serve {tag}] {json.dumps(out)}")
    print(json.dumps({"serve_full_width": out}), flush=True)
    return pairs


# ------------------------------------------------------- the serve fleet

FLEET_DIR = ROOT / "build" / "smoke_fleet"
#: the big tenant of the farm, serve and fleet phases (10c, 12, 13): the
#: 64k corpus's generator at 24,000 classes (cut from 64,000 to keep the
#: smoke within its time limit on a slower machine; every check kept).
#: Not below: at 16k the bucketed step's CR6 takes the dense route, so
#: the farm's consumer would launch no listing kernel.  The cohort phase
#: (10d) stays at 64k
SERVE_CLASSES = 24000
#: the router's probe timeout (``RouterApp(heartbeat_probe_timeout_s=)``,
#: its default): the smoke's own probes use the same
PROBE_TIMEOUT_S = 5.0
#: the ``sitecustomize`` that counts inside each replica (put ahead of
#: the tree on the replicas' ``PYTHONPATH``), and where it writes
FLEET_SITE = ROOT / "build" / "smoke_fleet_site"
FLEET_COUNTS = ROOT / "build" / "smoke_fleet_counts"
#: seconds between two writes of a replica's counts
COUNTS_PERIOD_S = 0.25

#: The replicas' ``sitecustomize``: in a process started with
#: ``--replica-id`` (or with ``SMOKE_COUNTS_RID`` in its environment, the
#: farm phase's consumer), a thread writes the process's kernel launches
#: (``ops.bitmatmul.LAUNCHES``, which count from 0 at import) and its
#: CUDA caching allocator's bytes to ``<counts>/<rid>_<pid>.json`` every
#: ``COUNTS_PERIOD_S`` and once more at exit (a graceful stop returns
#: from ``cli serve`` and reaches ``atexit``).  It changes nothing in the
#: program; the interpreter's own ``sitecustomize``, which it shadows,
#: still runs.
REPLICA_HOOK = '''\
import atexit
import importlib.machinery
import importlib.util
import json
import os
import sys
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize",
    [p for p in sys.path if os.path.abspath(p or os.curdir) != _HERE])
if _spec is not None and _spec.loader is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))

with open("/proc/self/cmdline", "rb") as _f:
    _ARGV = _f.read().decode().split("\\0")

_RID = (_ARGV[_ARGV.index("--replica-id") + 1] if "--replica-id" in _ARGV
        else os.environ.get("SMOKE_COUNTS_RID"))
if _RID:
    _PATH = os.path.join(COUNTS, "%s_%d.json" % (_RID, os.getpid()))
    _STARTED = time.time()

    def _dump():
        doc = {"rid": _RID, "pid": os.getpid(), "ppid": os.getppid(),
               "started": _STARTED, "ts": time.time(), "launches": None,
               "cuda": None}
        launches = getattr(
            sys.modules.get("distel_tpu_torch.ops.bitmatmul"), "LAUNCHES", None)
        if launches is not None:
            doc["launches"] = dict(launches)
        torch = sys.modules.get("torch")
        try:
            if torch is not None and torch.cuda.is_initialized():
                st = torch.cuda.memory_stats()
                doc["cuda"] = {
                    "reserved": st.get("reserved_bytes.all.current", 0),
                    "allocated": st.get("allocated_bytes.all.current", 0),
                    "peak_reserved": st.get("reserved_bytes.all.peak", 0)}
        except Exception:   # torch half imported: no reading this time
            pass
        tmp = "%s.%d.tmp" % (_PATH, threading.get_ident())
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, _PATH)

    def _loop():
        while True:
            try:
                _dump()
            except Exception:
                pass
            time.sleep(PERIOD)

    threading.Thread(target=_loop, name="smoke-counts", daemon=True).start()
    atexit.register(_dump)
'''


def install_replica_hook() -> str:
    """Write the replicas' ``sitecustomize``; returns its directory."""
    shutil.rmtree(FLEET_SITE, ignore_errors=True)
    shutil.rmtree(FLEET_COUNTS, ignore_errors=True)
    FLEET_SITE.mkdir(parents=True)
    FLEET_COUNTS.mkdir(parents=True)
    (FLEET_SITE / "sitecustomize.py").write_text(
        f"COUNTS = {str(FLEET_COUNTS)!r}\nPERIOD = {COUNTS_PERIOD_S!r}\n" + REPLICA_HOOK)
    return str(FLEET_SITE)


def replica_counts() -> dict:
    """{pid: the last counts each replica process wrote}."""
    out = {}
    for path in FLEET_COUNTS.glob("*.json"):
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        out[doc["pid"]] = doc
    return out


def fresh_counts(pids: dict, timeout_s: float = 10.0) -> dict:
    """{rid: counts} of the live processes ``pids`` ({rid: pid}), each
    written after this call began (so every launch the process made
    before it is in)."""
    t0 = time.time()
    deadline = time.monotonic() + timeout_s
    while True:
        docs = replica_counts()
        got = {rid: docs.get(pid) for rid, pid in pids.items()}
        if all(d is not None and d["ts"] > t0 for d in got.values()):
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: replicas {pids} wrote no counts "
                                 f"in {timeout_s} s: {got}")
        time.sleep(COUNTS_PERIOD_S / 2)


def kernel_launches(doc) -> int:
    """A replica's launches of the fleet path's kernels."""
    return sum((doc.get("launches") or {}).get(k, 0) for k in
               ("packed_cols_list", "packed_cols_dense", "packed_cols_sparse"))


def process_tree_of(pid: int) -> dict:
    """Where a process imports from: its working directory, its
    ``PYTHONPATH`` and its command line."""
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split("=", 1) for kv in f.read().decode().split("\0") if "=" in kv)
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        argv = f.read().decode().split("\0")
    return {"cwd": os.readlink(f"/proc/{pid}/cwd"), "pythonpath": env.get("PYTHONPATH"),
            "argv": [a for a in argv if a]}


def host_rss_of(pid: int):
    """A process's resident memory now (``/proc/<pid>/statm``), bytes."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        return None


def nvidia_smi(query: str) -> list:
    out = subprocess.run(["nvidia-smi", query, "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return [[x.strip() for x in ln.split(",")] for ln in out.stdout.splitlines()
            if ln.strip()]


def card_memory() -> dict:
    """The card's memory in use (MiB) and its per-process rows as
    ``nvidia-smi --query-compute-apps`` reports them ({pid: MiB}, pids as
    the host's kernel sees them: a container may show all its processes
    as one row)."""
    return {"used": int(nvidia_smi("--query-gpu=memory.used")[0][0]),
            "apps": {int(pid): int(mib) for pid, mib in
                     nvidia_smi("--query-compute-apps=pid,used_memory")}}


def kill_and_measure(pid: int, on_card: bool):
    """SIGKILL a replica process; with a card, the card memory it held
    when it died: its own ``nvidia-smi`` row where the row has its pid
    (other processes may share the card), else the card's memory in use
    just before, less once the process is gone (the supervisor reaps it
    later)."""
    import signal

    before = card_memory() if on_card else None
    os.kill(pid, signal.SIGKILL)
    while True:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break
        except OSError:
            break
        time.sleep(0.02)
    if not on_card:
        return None
    if pid in before["apps"]:
        return before["apps"][pid]
    time.sleep(1.0)    # the CUDA context is torn down at exit
    return before["used"] - card_memory()["used"]


class FleetProbe:
    """Heartbeat latencies: a thread that GETs every replica's
    ``/healthz`` once a second with the router's probe timeout, each
    sample labelled with the step the smoke is in."""

    def __init__(self, router):
        import threading

        self.router, self.step, self.samples = router, "boot", []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        import urllib.request

        while not self._stop.wait(1.0):
            for st in self.router.table.replicas():
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(st.url + "/healthz",
                                                timeout=PROBE_TIMEOUT_S) as r:
                        r.read()
                    err = None
                except Exception as e:  # noqa: BLE001 — a sample, not a fault
                    err = type(e).__name__
                self.samples.append((self.step, st.rid, time.perf_counter() - t0, err))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def summary(self) -> dict:
        """Per step and replica: probes, the slowest and the median
        latency (s), and the probes that failed (timeouts among them)."""
        out = {}
        for step, rid, lat, err in self.samples:
            out.setdefault(step, {}).setdefault(rid, []).append((lat, err))
        return {
            step: {rid: {"probes": len(v), "max_s": max(x for x, _ in v),
                         "median_s": sorted(x for x, _ in v)[len(v) // 2],
                         "failed": sorted(e for _, e in v if e)}
                   for rid, v in per.items()}
            for step, per in out.items()
        }


def raw_get(url: str, timeout: float = 1800) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def cpu_fleet_replay(tmp: Path):
    """The tracked trace through an in-process two-replica fleet on the
    CPU (``ReplicaApp``s behind a ``RouterApp``, loopback HTTP), its
    ``migrate`` op run: the replay record and every answer."""
    import threading

    from distel_tpu_torch.serve.fleet.replica import ReplicaApp
    from distel_tpu_torch.serve.fleet.router import RouterApp
    from distel_tpu_torch.serve.server import make_server
    from distel_tpu_torch.serve.traces import load_trace, replay_trace

    apps, servers = [], []
    for i in range(2):
        apps.append(ReplicaApp(EXACT(), replica_id=f"r{i}", spill_dir=str(tmp),
                               device="cpu"))
        servers.append(make_server(apps[-1], "127.0.0.1", 0))
        threading.Thread(target=servers[-1].serve_forever, daemon=True).start()
    router = RouterApp([(f"r{i}", f"http://127.0.0.1:{s.server_address[1]}")
                        for i, s in enumerate(servers)])
    try:
        with http_serving(router) as url:
            client = RecordingClient(url)
            rec = replay_trace(load_trace(str(TRACE_FILE)), client, migrate=router.migrate)
    finally:
        router.close()
        for s in servers:
            s.shutdown()
            s.server_close()
        for a in apps:
            a.close(final_spill=False)
    rec.pop("wall_s")
    return rec, client.answers


def phase_fleet_full_width(device: str = "cuda", n_big: int = 64000,
                           n_small: int = 8000) -> dict:
    """The serve fleet: two replica processes on one card,
    started by the port's ``ReplicaSupervisor`` (``cli serve
    --replica-id ... --device cuda``, ``PYTHONPATH`` set to this tree,
    each checked to import it), behind a ``RouterApp`` in this process
    over loopback HTTP.  The big corpus (``n_big`` classes, the records'
    ``tag``) without its range axiom and the 8k corpus are loaded
    through the router (affinity must place them apart) and the big
    tenant takes the class-only delta (its taxonomy held to a
    from-scratch card classify).  The big tenant is migrated
    live while reader threads read both tenants and a writer sends
    deltas to the 8k one: no request may fail, the big taxonomy must be
    byte-identical before and after, the 8k answers equal the serial
    ones.  The 8k tenant is replicated and its fanned-out reads equal
    the primary's.  The big tenant's replica is SIGKILLed: the router
    ejects it, the supervisor respawns it, the journal replays the
    tenant, whose taxonomy must equal the classify; then a retraction on
    the 8k tenant and a kill of its replica, whose journal replay (with
    the retract marker) must equal a classify of the survivors.  The
    tracked trace is replayed through the router with its ``migrate``
    op, equal to the same replay on an in-process CPU fleet.  The
    router's aggregated ``/metrics``, a stitched ``/debug/trace`` and
    ``/fleet/status`` are checked, and the fleet stops gracefully.
    Walls, the card's memory (``nvidia-smi``; each killed replica's
    share as the drop at its death), the replicas' host RSS and
    heartbeat latencies are printed.  Each replica process counts its
    own kernel launches and allocator bytes (the smoke's
    ``sitecustomize``, :data:`REPLICA_HOOK`): every process must have
    launched the path's kernels, and the replica that replays the big
    journal must launch them in the replay."""
    import threading

    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.obs.trace import SpanRecorder
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.serve.client import ServeClient, ServeError
    from distel_tpu_torch.serve.fleet.router import RouterApp
    from distel_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
    from distel_tpu_torch.serve.traces import load_trace, replay_trace

    # both without their range axiom, under which retraction is refused
    tag = f"{n_big // 1000}k"
    big = without_ranges(snomed_shaped_ontology(n_classes=n_big, seed=42))
    small = without_ranges(snomed_shaped_ontology(n_classes=n_small, seed=42))
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    out = {"device": device, "walls_s": {}, "card_memory_mib": {}, "replicas": {},
           "host_rss": {}}
    walls = out["walls_s"]
    seen_pids = {}
    on_card = device != "cpu"

    def classify_key(texts):
        res = ELClassifier(EXACT(), device=device).classify_text("\n".join(texts) + "\n")
        key = taxonomy_key(res.taxonomy)
        del res
        if on_card:
            torch.cuda.empty_cache()
        return key

    def served_key(doc):
        return (doc["parents"], doc["equivalents"], sorted(doc["unsatisfiable"]))

    def replica_pids() -> dict:
        """{rid: pid} of the live replica processes, as the supervisor
        started them; every pid seen is kept in ``seen_pids``."""
        pids = {rid: p.proc.pid for rid, p in sorted(sup._procs.items())
                if p.proc.poll() is None}
        seen_pids.update({pid: rid for rid, pid in pids.items()})
        return pids

    def memory(label):
        """The card's memory in use, ``nvidia-smi``'s per-process rows,
        what this process holds of it (reserved by its allocator), each
        replica's allocator bytes and kernel launches (its counts, fresh)
        and each replica's host RSS."""
        pids = replica_pids()
        counts = fresh_counts(pids)
        if on_card:
            out["card_memory_mib"][label] = {
                **card_memory(), "smoke_reserved": torch.cuda.memory_reserved() >> 20}
        out["replicas"][label] = {
            rid: {"pid": pids[rid], "launches": kernel_launches(doc),
                  **{f"cuda_{k}_mib": v >> 20 for k, v in (doc["cuda"] or {}).items()}}
            for rid, doc in counts.items()}
        out["host_rss"][label] = {rid: host_rss_of(pid) for rid, pid in pids.items()}

    # 1. boot: both replicas started together, each timed to its serving line
    site = install_replica_hook()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([site, str(ROOT)])}
    exact_props = FLEET_DIR / "exact.properties"
    exact_props.parent.mkdir(parents=True, exist_ok=True)
    exact_props.write_text("shape.buckets = false\n")
    sup = ReplicaSupervisor(2, spill_dir=str(FLEET_DIR),
                            extra_args=["--device", device,
                                        "--config", str(exact_props)], env=env)
    served_at = {}

    def watch(rid, t0):
        path = FLEET_DIR / "logs" / f"{rid}.log"
        while time.perf_counter() - t0 < sup.startup_timeout_s:
            try:
                if '"serving": true' in path.read_text():
                    served_at[rid] = time.perf_counter() - t0
                    return
            except OSError:
                pass
            time.sleep(0.05)

    t0 = time.perf_counter()
    watchers = [threading.Thread(target=watch, args=(f"r{i}", t0), daemon=True)
                for i in range(2)]
    for w in watchers:
        w.start()
    replicas = sup.start()
    walls["boot"] = time.perf_counter() - t0
    for w in watchers:
        w.join(timeout=30)
    walls["boot_to_serving"] = dict(sorted(served_at.items()))

    def check_trees(label):
        """Every replica process runs ``cli serve`` from this tree: its
        working directory is this checkout, and its ``PYTHONPATH`` this
        checkout behind the counting hook."""
        pids = replica_pids()
        if sorted(pids) != ["r0", "r1"]:
            raise AssertionError(f"fleet: replica processes {pids}")
        trees = {rid: process_tree_of(pid) for rid, pid in pids.items()}
        for rid, tree in trees.items():
            if tree["cwd"] != str(ROOT) or tree["pythonpath"] != env["PYTHONPATH"] or \
                    tree["argv"][1:4] != ["-m", "distel_tpu_torch.cli", "serve"] or \
                    tree["argv"][tree["argv"].index("--device") + 1] != device:
                raise AssertionError(f"fleet: replica {rid} runs {tree}, not this tree")
        out.setdefault("replica_trees", {})[label] = {
            rid: {"pid": pids[rid], **{k: t[k] for k in ("cwd", "pythonpath")}}
            for rid, t in trees.items()}

    check_trees("booted")
    memory("booted")
    router = RouterApp(replicas, supervisor=sup)
    router.start()
    failures = []
    try:
        with http_serving(router) as url, FleetProbe(router) as probe:
            client = ServeClient(url, timeout=1800)

            # 2. loads through the router; affinity places them apart
            probe.step = "load"
            t0 = time.perf_counter()
            a = client.load(big)["id"]
            walls[f"load_{tag}"] = time.perf_counter() - t0
            # placement reads the load the last heartbeat saw: one taken
            # while the big load was in flight counts no tenant there yet
            first = router.table.lookup(a)
            t_loaded = time.monotonic()
            while first.last_seen <= t_loaded:
                time.sleep(0.1)
            t0 = time.perf_counter()
            b = client.load(small)["id"]
            walls["load_8k"] = time.perf_counter() - t0
            place = router.table.stats()["placement"]
            if place[a] == place[b]:
                raise AssertionError(f"fleet: both tenants placed on {place[a]}")
            out["placement_after_load"] = dict(place)
            t0 = time.perf_counter()
            client.delta(a, INC_CLASS_DELTA)
            walls[f"delta_{tag}"] = time.perf_counter() - t0
            memory("loaded")
            want_a = classify_key([big, INC_CLASS_DELTA])
            if served_key(client.taxonomy(a)) != want_a:
                raise AssertionError(f"fleet: the {tag} taxonomy differs from a classify")
            log(f"[fleet] loaded: {json.dumps(walls)}")

            # 3. live migration of the big tenant under load
            probe.step = "migrate"
            tax_url = f"{url}/v1/ontologies/{a}/taxonomy"
            before = raw_get(tax_url)
            # the writer's deltas add classes under Find* classes: the
            # subsumers of Find7 stay as they are, the snapshot version moves
            serial_b = [client.subsumers(b, "Find7")["subsumers"],
                        client.query_subsumers(b, "Find7")["subsumers"]]
            names = sorted(json.loads(before)["parents"])
            rng = np.random.default_rng(1)
            sample = rng.choice(names, 8, replace=False).tolist()
            serial_a = {c: client.subsumers(a, c) for c in sample}
            stop, lock = threading.Event(), threading.Lock()
            timeline, writes = [], []

            def note(tenant, t_start, ok):
                with lock:
                    timeline.append((tenant, t_start, time.perf_counter(), ok))

            def read_big():
                i = 0
                while not stop.is_set():
                    t_s = time.perf_counter()
                    try:
                        if i % 3 == 0:
                            ok = raw_get(tax_url) == before
                        else:
                            c = sample[i % len(sample)]
                            ok = client.subsumers(a, c) == serial_a[c]
                        note(tag, t_s, ok)
                    except Exception as e:  # noqa: BLE001 — the check below
                        failures.append(f"{tag} read: {type(e).__name__}: {e}")
                    i += 1

            def read_small():
                while not stop.is_set():
                    t_s = time.perf_counter()
                    try:
                        ok = [client.subsumers(b, "Find7")["subsumers"],
                              client.query_subsumers(b, "Find7")["subsumers"]] == serial_b
                        note("8k", t_s, ok)
                    except Exception as e:  # noqa: BLE001
                        failures.append(f"8k read: {type(e).__name__}: {e}")

            w_texts = []

            def write_small():
                i = 0
                while not stop.is_set():
                    t = "\n".join(f"SubClassOf(FleetW{i}x{j} Find{j * 5 + i})"
                                  for j in range(10))
                    t_s = time.perf_counter()
                    try:
                        writes.append(client.delta(b, t))
                        w_texts.append(t)
                        note("8k write", t_s, True)
                    except Exception as e:  # noqa: BLE001
                        failures.append(f"8k write: {type(e).__name__}: {e}")
                    i += 1
                    stop.wait(2.0)

            threads = [threading.Thread(target=f, daemon=True)
                       for f in (read_big, read_big, read_small, write_small)]
            for th in threads:
                th.start()
            time.sleep(3.0)
            memory("before_migrate")
            t_mig = time.perf_counter()
            rec = router.migrate(a)
            t_end = time.perf_counter()
            walls["migrate"] = t_end - t_mig
            time.sleep(3.0)
            stop.set()
            for th in threads:
                th.join(timeout=1800)
                if th.is_alive():
                    raise AssertionError("fleet: a client thread never returned")
            memory("after_migrate")
            # the registry releases a departed tenant's cached blocks:
            # the source replica's reserved bytes fall below 1 GiB
            src = out["replicas"]["after_migrate"].get(rec["from"], {})
            out["repair"] = {
                "source": rec["from"],
                "source_reserved_mib_after_move": src.get("cuda_reserved_mib"),
                "source_allocated_mib_after_move": src.get("cuda_allocated_mib"),
                "card_used_mib_after_move":
                    out["card_memory_mib"].get("after_migrate", {}).get("used"),
            }
            log(f"[fleet] after the move: {json.dumps(out['repair'])}")
            if on_card and not (src.get("cuda_reserved_mib") is not None
                                and src["cuda_reserved_mib"] < 1024):
                raise AssertionError(f"fleet: the source replica kept its blocks "
                                     f"after the move: {out['repair']}")
            for e in router.flight.events():
                if e["kind"] in ("migrate_drain", "migrate_export", "migrate_adopt",
                                 "migrate_commit") and e.get("oid") == a:
                    walls[e["kind"]] = e.get("wall_s")
            overlapping = [t1 - t0_ for who, t0_, t1, _ in timeline
                           if who == tag and t0_ < t_end and t1 > t_mig]
            out["migration"] = {
                "record": {k: v for k, v in rec.items() if k != "wall_s"},
                "requests": len(timeline), "failed": len(failures),
                "wrong": sum(1 for *_r, ok in timeline if not ok),
                "requests_by_tenant": {t: sum(1 for x in timeline if x[0] == t)
                                       for t in (tag, "8k", "8k write")},
                "client_hold_s": max(overlapping, default=None),
                "requests_in_move": len(overlapping),
                "writes": [w.get("path") for w in writes],
            }
            if failures or out["migration"]["wrong"] or len(w_texts) < 2:
                raise AssertionError(f"fleet: migration under load: {out['migration']} "
                                     f"{failures[:5]}")
            if raw_get(tax_url) != before:
                raise AssertionError(f"fleet: the {tag} taxonomy changed across the move")
            want_b = classify_key([small] + w_texts)
            if served_key(client.taxonomy(b)) != want_b:
                raise AssertionError("fleet: the 8k tenant differs from its serial classify")
            log(f"[fleet] migrated: {json.dumps(out['migration'])}")
            # the big tenant back where it came from: does the source's
            # allocator take it into the blocks it kept?
            seq0 = max((e["seq"] for e in router.flight.events()), default=0)
            t0 = time.perf_counter()
            router.migrate(a, dst_rid=rec["from"])
            walls["migrate_back"] = time.perf_counter() - t0
            out["repair"]["move_back_s"] = walls["migrate_back"]
            for e in router.flight.events():
                if e["seq"] > seq0 and e["kind"] in ("migrate_export", "migrate_adopt") \
                        and e.get("oid") == a:
                    walls[e["kind"] + "_back"] = e.get("wall_s")
            if raw_get(tax_url) != before:
                raise AssertionError(f"fleet: the {tag} taxonomy changed across the move back")
            memory("after_migrate_back")

            # 4. read replica of the 8k tenant
            probe.step = "replicate"
            rep = client._request("POST", "/fleet/replicate", {"id": b})
            primary = ServeClient(router.table.lookup(b).url, timeout=600)
            for cls in ("Find7", "Find21", "FleetW1x3", "Find2"):
                want = primary.query_subsumers(b, cls)
                for _ in range(2):
                    if client.query_subsumers(b, cls) != want:
                        raise AssertionError(f"fleet: a fanned-out read of {cls} differs")
            page = router.metrics.render()
            reads = {t: float(m.group(1)) for t in ("primary", "replica")
                     for m in [re.search(
                         r'distel_router_reads_total\{target="%s"\} (\S+)' % t, page)] if m}
            if not reads.get("replica"):
                raise AssertionError(f"fleet: no read went to the read replica: {reads}")
            out["read_replica"] = {"record": rep, "reads": reads}

            # 5. crash and recovery of the big tenant's replica
            def await_taxonomy(oid, t_kill, budget_s):
                """Poll the tenant's taxonomy through the router until it
                answers: the answer, and each poll's start and end (s after
                the kill), status and trace id."""
                poller = ServeClient(url, timeout=1800, tracer=SpanRecorder(service="smoke"))
                polls = []
                deadline = time.monotonic() + budget_s
                while True:
                    if time.monotonic() > deadline:
                        raise AssertionError(f"fleet: no recovery of {oid}: {polls}")
                    t_s = time.time()
                    try:
                        doc, status = poller.taxonomy(oid), 200
                    except ServeError as e:
                        doc, status = None, e.status
                    polls.append({"start_s": t_s - t_kill, "end_s": time.time() - t_kill,
                                  "status": status, "trace_id": poller.last_trace_id})
                    if doc is not None:
                        return doc, polls
                    time.sleep(0.5)

            def events_since(events, t_kill):
                return [{"kind": e["kind"], "t_s": e["ts"] - t_kill,
                         **{k: e[k] for k in ("rid", "oid", "dst", "to", "ok", "verdict",
                                              "wall_s", "path") if k in e}}
                        for e in events if e["ts"] >= t_kill]

            probe.step = f"recover_{tag}"
            holder = router.table.lookup(a).rid
            memory("before_kill")
            killed = replica_pids()[holder]
            t_kill = time.time()
            held = kill_and_measure(killed, on_card)
            doc, polls = await_taxonomy(a, t_kill, 900)
            if served_key(doc) != want_a:
                raise AssertionError(f"fleet: the recovered {tag} taxonomy differs")

            def since_kill(kind, **match):
                ev = [e for e in router.flight.events(kind=kind)
                      if e["ts"] >= t_kill and all(e.get(k) == v for k, v in match.items())]
                return (ev[0]["ts"] - t_kill, ev[0]) if ev else (None, None)

            recovery = {"killed": holder, "card_mib_at_death": held,
                        "to_first_correct_taxonomy_s": polls[-1]["end_s"]}
            for kind, match in (("eject", {"rid": holder}), ("respawn", {"rid": holder}),
                                ("journal_replay", {"oid": a}), ("recover", {"oid": a})):
                at, ev = since_kill(kind, **match)
                recovery[f"to_{kind}_s"] = at
                if ev is not None and "wall_s" in ev:
                    recovery[f"{kind}_wall_s"] = ev["wall_s"]
            if recovery["to_respawn_s"] is None or recovery["to_recover_s"] is None:
                raise AssertionError(f"fleet: recovery incomplete: {recovery}")
            # where the time between the kill and the answer went: every
            # poll, the slowest poll's stitched spans (router and replica),
            # the router's events and the new holder's
            slow = max(polls, key=lambda p: p["end_s"] - p["start_s"])
            spans = json.loads(raw_get(f"{url}/debug/trace?trace_id={slow['trace_id']}"))
            new_holder = router.table.lookup(a)
            recovery.update({
                "recovered_on": new_holder.rid,
                "polls": [{k: p[k] for k in ("start_s", "end_s", "status")} for p in polls],
                "slowest_poll_spans": sorted(
                    ({"service": sp.get("service"), "name": sp["name"],
                      "start_s": sp["start_s"] - t_kill, "duration_s": sp["duration_s"]}
                     for sp in spans["spans"]), key=lambda x: x["start_s"]),
                "router_events": events_since(router.flight.events(), t_kill),
                "holder_events": events_since(json.loads(raw_get(
                    new_holder.url + "/debug/events"))["events"], t_kill),
            })
            memory("after_recovery")
            check_trees("respawned")
            # the replay re-classified the tenant from its texts: on the card
            # its new holder launched the kernels for it
            after = out["replicas"]["after_recovery"][new_holder.rid]
            prior = out["replicas"]["before_kill"].get(new_holder.rid)
            recovery["replay_launches"] = after["launches"] - (
                prior["launches"] if prior and prior["pid"] == after["pid"] else 0)
            if on_card and recovery["replay_launches"] <= 0:
                raise AssertionError(f"fleet: the journal replay launched no kernel: {recovery}")
            out[f"recovery_{tag}"] = recovery
            log(f"[fleet] recovered {tag}: {json.dumps(recovery)}")

            # the 8k tenant: a retraction, then its replica killed
            probe.step = "recover_8k"
            t0 = time.perf_counter()
            retract = client.retract(b, w_texts[1])
            walls["retract_8k"] = time.perf_counter() - t0
            if retract.get("path") != "retract":
                raise AssertionError(f"fleet: the 8k retraction took {retract}")
            holder_b = router.table.lookup(b).rid
            if holder_b == router.table.lookup(a).rid:
                router.migrate(b)
                holder_b = router.table.lookup(b).rid
            journal = router._journal_texts(b)
            if {"op": "retract", "text": w_texts[1]} not in journal:
                raise AssertionError("fleet: the retraction is not in the journal")
            want_survivors = classify_key([small] + [t for i, t in enumerate(w_texts) if i != 1])
            memory("before_kill_8k")
            t_kill = time.time()
            held_b = kill_and_measure(replica_pids()[holder_b], on_card)
            doc, polls = await_taxonomy(b, t_kill, 600)
            if served_key(doc) != want_survivors:
                raise AssertionError("fleet: the 8k journal replay differs from a "
                                     "classify of the survivors")
            out["recovery_8k"] = {
                "killed": holder_b, "card_mib_at_death": held_b, "journal_ops": len(journal),
                "to_first_correct_taxonomy_s": polls[-1]["end_s"],
                "polls": [{k: p[k] for k in ("start_s", "end_s", "status")} for p in polls]}
            memory("after_recovery_8k")
            check_trees("respawned_8k")

            # 6. the tracked trace through the router, its migrate op run
            probe.step = "trace"
            t0 = time.perf_counter()
            rc = RecordingClient(url)
            replay = replay_trace(load_trace(str(TRACE_FILE)), rc, migrate=router.migrate)
            replay.pop("wall_s")
            replay, answers = logical_ids(replay, rc.answers)
            walls["trace_replay"] = time.perf_counter() - t0
            cpu_rec, cpu_answers = logical_ids(*cpu_fleet_replay(FLEET_DIR / "cpu_fleet"))
            if replay != cpu_rec or answers != cpu_answers:
                bad = next((i for i, (x, y) in enumerate(zip(answers, cpu_answers))
                            if x != y), None)
                raise AssertionError(f"fleet: the trace replay differs from the CPU "
                                     f"fleet's ({replay} / {cpu_rec}; answer {bad})")
            if replay["skipped_migrates"] or replay["failed_requests"] or \
                    replay["ok"].get("migrate") != 1:
                raise AssertionError(f"fleet: trace replay {replay}")
            out["trace_replay"] = {"record": replay, "answers": len(answers)}

            # 7. fleet observability
            probe.step = "observe"
            page = client.metrics_text()
            for fam in ("distel_requests_total", "distel_registry_adoptions_total"):
                for rid in ("r0", "r1"):
                    if not re.search(r'^%s\{[^}]*replica="%s"' % (fam, rid), page, re.M):
                        raise AssertionError(f"fleet: /metrics lacks {fam} of {rid}")
            families = sorted({m.group(1) for m in re.finditer(
                r"^(distel_(?:fleet|router)_[a-z_]+?)(?:_bucket|_sum|_count)?[ {]", page, re.M)})
            for fam in ("distel_fleet_migrations_total", "distel_fleet_ejections_total",
                        "distel_fleet_recoveries_total", "distel_fleet_replicas_healthy",
                        "distel_router_requests_total", "distel_router_reads_total"):
                if fam not in families:
                    raise AssertionError(f"fleet: /metrics lacks {fam}")
            traced = ServeClient(url, timeout=600, tracer=SpanRecorder(service="smoke"))
            traced.query_subsumers(b, "Find7")
            spans = json.loads(raw_get(f"{url}/debug/trace?trace_id={traced.last_trace_id}"))
            services = sorted({s.get("service") for s in spans["spans"]})
            if "router" not in services or not any(s.startswith("replica:") for s in services):
                raise AssertionError(f"fleet: /debug/trace did not stitch: {services}")
            status = json.loads(raw_get(f"{url}/fleet/status"))
            if not all(r["healthy"] for r in status["replicas"]) or len(status["replicas"]) != 2:
                raise AssertionError(f"fleet: /fleet/status {status['replicas']}")
            counters = {m.group(1): float(m.group(2)) for m in re.finditer(
                r"^(distel_fleet_[a-z_]+_total) (\S+)$", page, re.M)}
            out["observability"] = {"fleet_counters": counters, "router_families": families,
                                    "stitched_services": services,
                                    "status_healthy": [r["id"] for r in status["replicas"]]}
            ejects = router.flight.events(kind="eject")
            out["ejections"] = [{k: e.get(k) for k in ("rid", "dead_process",
                                                       "consecutive_failures",
                                                       "consecutive_timeouts")}
                                for e in ejects]
            out["false_ejections"] = sum(1 for e in ejects if not e.get("dead_process"))
            out["heartbeat_misses"] = [{k: e.get(k) for k in ("rid", "verdict", "consecutive")}
                                       for e in router.flight.events(kind="heartbeat_miss")]
            out["heartbeats"] = probe.summary()
            memory("end")
            tenants = sorted(router.table.stats()["placement"])
    finally:
        router.close()
        # 8. graceful stop: every replica spills its tenants
        t0, t_stop = time.perf_counter(), time.time()
        procs = dict(sup._procs)
        sup.stop(graceful=True, timeout_s=600)
        walls["graceful_stop"] = time.perf_counter() - t0
    codes = {rid: p.proc.returncode for rid, p in procs.items()}
    shutdown = {}
    for rid in procs:
        lines = [ln for ln in (FLEET_DIR / "logs" / f"{rid}.log").read_text().splitlines()
                 if ln.startswith('{"shutdown"')]
        shutdown[rid] = json.loads(lines[-1]) if lines else None
    out["stop"] = {"exit_codes": codes,
                   "spilled": {rid: [os.path.basename(p) for p in (d or {}).get("spilled", [])]
                               for rid, d in shutdown.items()}}
    if any(codes.values()) or not all(shutdown.values()) or \
            sorted(sum(out["stop"]["spilled"].values(), [])) != \
            sorted(f"{oid}.snapshot.npz" for oid in tenants):
        raise AssertionError(f"fleet: graceful stop {out['stop']}")
    # every replica process's own launches, the last counts it wrote (at
    # its exit for those stopped, just before the kill for those killed)
    docs = replica_counts()
    out["replica_launches"] = {
        f"{rid}:{pid}": {"launches": (docs.get(pid) or {}).get("launches"),
                         "written_after_stop": pid in docs and docs[pid]["ts"] >= t_stop}
        for pid, rid in sorted(seen_pids.items())}
    stopped = {p.proc.pid for p in procs.values()}
    if any(pid not in docs for pid in seen_pids) or \
            any(docs[pid]["ts"] < t_stop for pid in stopped):
        raise AssertionError(f"fleet: replica counts missing {out['replica_launches']}")
    if on_card and any(kernel_launches(docs[pid]) <= 0 for pid in seen_pids):
        raise AssertionError(f"fleet: a replica launched no kernel {out['replica_launches']}")
    for d in (FLEET_DIR, FLEET_SITE, FLEET_COUNTS):
        shutil.rmtree(d, ignore_errors=True)
    log(f"[fleet] {json.dumps(out)}")
    print(json.dumps({"fleet_full_width": out}), flush=True)
    return out


def logical_ids(rec: dict, answers: list):
    """A trace replay's record and answers with the server's ontology
    ids replaced by the trace's logical names (a fleet that served other
    tenants first mints other ids)."""
    text = json.dumps([rec, answers])
    for name, oid in rec["ontologies"].items():
        text = text.replace(json.dumps(oid), json.dumps(name))
    return tuple(json.loads(text))


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
    clf = ELClassifier(EXACT(engine="packed"), device="cuda")
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


# ------------------------------------------------------- the artifact farm

FARM_DIR = ROOT / "build" / "smoke_farm"
FARM_WORK = ROOT / "build" / "smoke_farm_work"

#: the child that checks the farm's kernels: it installs the farm's
#: libraries with no toolkit in reach (its build directory empty; the
#: programs it would not run are not built), then runs both row-count
#: variants on the heaviest bucketed 64k operand of each route against
#: the plain version (:func:`check_variants`), loaded from them
FARM_CHECK = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as S
from distel_tpu_torch.core import artifacts
from distel_tpu_torch.ops import build

store = artifacts.ArtifactStore(sys.argv[2])
if store.env_mismatch("cuda") is not None:
    raise artifacts.ArtifactError(store.env_mismatch("cuda"))
before = build.CACHE_EVENTS.snapshot()
libraries = store.install_libraries(require=True)
for name in libraries:
    build.load(name)
after = build.CACHE_EVENTS.snapshot()
ops = torch.load(sys.argv[3])
checks = S.check_variants([(o["site"], o["a"].cuda(), o["b"].cuda(),
                            o["sparse"]) for o in ops])
print(json.dumps({"libraries": libraries,
                  "nvcc_runs": after["misses"] - before["misses"],
                  "persistent_cache_hits": after["hits"] - before["hits"],
                  "checks": checks}))
'''


def toolkit_free_env(build_dir: Path, rid=None) -> dict:
    """This process's environment with no CUDA toolkit in reach: no
    ``nvcc`` on ``PATH``, a ``CUDA_HOME`` that does not exist, an empty
    kernel build directory; the tree (and, with ``rid``, the counting
    ``sitecustomize`` of :data:`REPLICA_HOOK`) on ``PYTHONPATH``."""
    path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                           if d and not os.path.exists(os.path.join(d, "nvcc")))
    if shutil.which("nvcc", path=path):
        raise AssertionError("farm: nvcc still on the consumer's PATH")
    shutil.rmtree(build_dir, ignore_errors=True)
    build_dir.mkdir(parents=True)
    env = {**os.environ, "PATH": path, "CUDA_HOME": str(FARM_WORK / "no-cuda"),
           "DISTEL_TORCH_BUILD_DIR": str(build_dir),
           "PYTHONPATH": str(ROOT)}
    if rid is not None:
        env["SMOKE_COUNTS_RID"] = rid
        env["PYTHONPATH"] = os.pathsep.join([str(FLEET_SITE), str(ROOT)])
    return env


def spawn_serve(args, env, log_path: Path):
    """``cli serve`` on an ephemeral port in a fresh process, its output
    to ``log_path``."""
    with open(log_path, "w") as log:
        return subprocess.Popen(
            [sys.executable, "-m", "distel_tpu_torch.cli", "serve", "--host",
             "127.0.0.1", "--port", "0", "--device", "cuda", *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))


def start_serve(args, env, log_path: Path, timeout_s: float = 300, proc=None):
    """``cli serve`` in a fresh process (or ``proc``, spawned by
    :func:`spawn_serve`); returns the process and its start line (None
    when it exited first)."""
    if proc is None:
        proc = spawn_serve(args, env, log_path)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for ln in log_path.read_text().splitlines():
            if ln.startswith('{"serving"'):
                return proc, json.loads(ln)
        if proc.poll() is not None:
            return proc, None
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"farm: serve {args} printed no start line in {timeout_s} s")


def stop(proc, timeout_s: float = 60) -> int:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


def bake_process(cmd, prefix: Path, env=None):
    """``cmd`` in a fresh process, its output to ``<prefix>.out/.err``."""
    with open(f"{prefix}.out", "w") as fo, open(f"{prefix}.err", "w") as fe:
        return subprocess.Popen(cmd, stdout=fo, stderr=fe, cwd=str(ROOT), env=env)


def bake_result(proc, prefix: Path, timeout_s: float = 600):
    """Wait for a :func:`bake_process`; its standard output and error."""
    proc.wait(timeout=timeout_s)
    return Path(f"{prefix}.out").read_text(), Path(f"{prefix}.err").read_text()


def farm_metric(page: str, name: str):
    m = re.search(rf"^{name} (\S+)$", page, re.M)
    return float(m.group(1)) if m else None


FARM_SERIES = ("distel_artifact_exe_hits_total", "distel_artifact_hlo_hits_total",
               "distel_artifact_misses_total", "distel_artifact_rejected_total",
               "distel_persistent_cache_hits_total")


def phase_farm_full_width(n_classes: int = 64000):
    """The artifact farm (``core/artifacts.py``) across fresh processes
    on the card, over ``n_classes`` classes of the 64k corpus's
    generator (the records' ``tag``):

    1. bake: ``cli farm-build --profile serve --delta <the 100-axiom
       class-only delta>`` on that corpus without its range axiom (the
       serve tenant's text), so the farm holds the rebuild's and the
       delta plane's program specs and the kernel libraries; its records,
       the manifest's stats and its wall; the same command again must
       write nothing;
    2. consume: ``cli serve --artifacts-dir ... --artifacts-require`` in
       a fresh process with no ``nvcc`` on ``PATH``, a ``CUDA_HOME`` that
       does not exist and an empty build directory: its install record
       (0 ``nvcc`` runs, the libraries as persistent-cache hits, each
       program's capture seconds and bytes); the text loaded over HTTP,
       then the class-only delta, both with ``compile_s`` 0.0 and exe
       hits, the delta on the fast path; the served taxonomy equal to
       this process's classify of the same text; ``/metrics`` with the
       farm's five series; the process's own launches (its
       ``sitecustomize`` counts) of the step's kernels > 0;
    3. in a ``python -c`` child with the same environment, each kernel
       of the path (both row-count variants) on the heaviest bucketed
       operand of each route against its plain version, loaded from
       the farm's library: 0 differing words (the kernel line's ``farm``
       rows);
    4. refuse: one byte of the load's program spec flipped in a copy of
       the farm: ``serve --artifacts-require`` exits non-zero before it
       binds, naming the checksum; without ``--artifacts-require`` it
       serves the load and the delta, the rejection counted, the program
       built from the engine's tables, the same taxonomy.  Beside them, a
       fresh ``cli serve`` with no farm and an empty build directory
       (``nvcc`` in reach; booted during step 3, its requests held until
       the kernel check is done), its load and delta building their
       programs and the library: the cold start without the farm.  These
       three, and the re-bake of step 1, run side by side (their walls
       are taken beside each other: step 2 runs alone).

    Returns the kernel line's farm rows."""
    from distel_tpu_torch.core import artifacts
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.serve.client import ServeClient

    import threading

    from distel_tpu_torch.core.program_cache import PROGRAMS

    t_phase = time.perf_counter()
    # the card is shared with up to four processes of this phase: the
    # programs earlier phases left in this process's registry go first
    PROGRAMS.clear()
    torch.cuda.empty_cache()
    out = {}
    shutil.rmtree(FARM_DIR, ignore_errors=True)
    shutil.rmtree(FARM_WORK, ignore_errors=True)
    FARM_WORK.mkdir(parents=True)
    text = without_ranges(snomed_shaped_ontology(n_classes=n_classes, seed=42))
    tag = f"{n_classes // 1000}k"
    corpus, delta = FARM_WORK / f"serve{tag}.ofn", FARM_WORK / "class_delta.ofn"
    corpus.write_text(text)
    delta.write_text(INC_CLASS_DELTA + "\n")
    bake_cmd = [sys.executable, "-m", "distel_tpu_torch.cli", "farm-build",
                str(corpus), "--out", str(FARM_DIR), "--profile", "serve",
                "--delta", str(delta), "--device", "cuda"]
    procs = []
    check_done = threading.Event()
    try:
        # 1. the bake, beside this process's classify of the text and
        # the delta (the taxonomy every consumer is held to) and the
        # heaviest operand of each route of its bucketed step
        t0 = time.perf_counter()
        bake = bake_process(bake_cmd, FARM_WORK / "bake")
        procs.append(bake)
        ref = ELClassifier(device="cuda").classify_text(
            text + "\n" + INC_CLASS_DELTA + "\n")
        want = taxonomy_key(ref.taxonomy)
        ops_cap = Capture()
        bucket_operands(ref.engine, ref.result, ops_cap)
        ops = [{"site": site, "a": a.cpu(), "b": b.cpu(), "sparse": sparse}
               for _variant, (site, a, b, sparse) in
               sorted(bucket_heaviest(ops_cap).items())]
        del ref, ops_cap
        torch.cuda.empty_cache()
        ops_path = FARM_WORK / "operands.pt"
        torch.save(ops, ops_path)
        stdout, stderr = bake_result(bake, FARM_WORK / "bake")
        out["bake_s"] = time.perf_counter() - t0
        if bake.returncode != 0:
            raise AssertionError(f"farm-build exited {bake.returncode}: {stderr[-3000:]}")
        lines = [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]
        out["bake"] = lines[-1]
        out["bake_records"] = [{k: r.get(k) for k in (
            "profile", "bucket_signature", "path", "compile_s", "delta_programs",
            "artifact_serialized", "artifact_unserializable", "wall_s")}
            for r in lines[:-1]]
        stats = lines[-1]
        log(f"[farm bake] {out['bake_s']:.2f} s {json.dumps(stats)}")
        # the phase's clock at each step's end (s)
        out["clock_s"] = {"bake": time.perf_counter() - t_phase}
        if stats["exe"] < 2 or stats["kernels"] != 2 or not stats["nvcc"]:
            raise AssertionError(f"farm: the bake shipped {stats}")

        # 2. a fresh serve process with no toolkit consumes it
        install_replica_hook()
        env = toolkit_free_env(FARM_WORK / "consumer_build", rid="farm")
        t0 = time.perf_counter()
        proc, start = start_serve(["--artifacts-dir", str(FARM_DIR),
                                   "--artifacts-require"], env,
                                  FARM_WORK / "consumer.log")
        procs.append(proc)
        boot_s = time.perf_counter() - t0
        if start is None:
            raise AssertionError("farm: the consumer did not start: "
                                 + (FARM_WORK / "consumer.log").read_text()[-3000:])
        inst = start["artifacts"]
        if not inst["installed"] or inst["nvcc_runs"] != 0 or \
                inst["persistent_cache_hits"] != stats["kernels"] or \
                inst["programs_built"] != stats["exe"]:
            raise AssertionError(f"farm: the consumer's install {inst}")
        client = ServeClient(f"http://127.0.0.1:{start['port']}", timeout=600)
        # the launches of the load and the delta: the counts after them
        # less those after the install (its warm-up launches)
        counts0 = fresh_counts({"farm": proc.pid})["farm"]["launches"] or {}
        t0 = time.perf_counter()
        load = client.load(text)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        drec = client.delta(load["id"], INC_CLASS_DELTA)
        delta_s = time.perf_counter() - t0
        # the kernel check's child starts now: the consumer's card work is
        # done, what is left of it (its reads and its exit) is the host's
        t_check = time.perf_counter()
        check_proc = bake_process(
            [sys.executable, "-c", FARM_CHECK, str(ROOT), str(FARM_DIR), str(ops_path)],
            FARM_WORK / "check", env=toolkit_free_env(FARM_WORK / "check_build"))
        procs.append(check_proc)
        # the cold consumer (no farm) boots now too; its requests wait for
        # the kernel check's end
        cold_env = {**os.environ, "PYTHONPATH": str(ROOT),
                    "DISTEL_TORCH_BUILD_DIR": str(FARM_WORK / "cold_build")}
        cold = spawn_serve([], cold_env, FARM_WORK / "cold.log")
        procs.append(cold)
        cold_out = {}

        def cold_start():
            """The cold consumer's start, then (once the kernel check is
            done) its load and delta: a thread, the lenient consumer's
            requests run meanwhile."""
            t_cold = time.perf_counter()
            _p, st = start_serve([], cold_env, FARM_WORK / "cold.log", proc=cold)
            if st is None:
                return
            cold_out["boot_s"] = time.perf_counter() - t_cold
            check_done.wait(timeout=600)
            c = ServeClient(f"http://127.0.0.1:{st['port']}", timeout=600)
            t1 = time.perf_counter()
            cold_out["load"] = c.load(text)
            cold_out["load_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            cold_out["delta"] = c.delta(cold_out["load"]["id"], INC_CLASS_DELTA)
            cold_out["delta_s"] = time.perf_counter() - t1

        cold_thread = threading.Thread(target=cold_start, name="farm-cold",
                                       daemon=True)
        cold_thread.start()
        served = client.taxonomy(load["id"])
        page = client.metrics_text()
        counts = fresh_counts({"farm": proc.pid})["farm"]
        proc.terminate()
        keys = ("compile_s", "trace_lower_s", "program_cache_hit", "artifact_hits",
                "path", "iterations", "bucket_signature", "delta_programs",
                "delta_program_hits")
        out["consumer"] = {
            "boot_s": boot_s, "install_s": inst["install_s"],
            "libraries": inst["libraries"], "nvcc_runs": inst["nvcc_runs"],
            "persistent_cache_hits": inst["persistent_cache_hits"],
            "programs": inst["programs"],
            "load_s": load_s, "delta_s": delta_s,
            "load": {k: load.get(k) for k in keys},
            "delta": {k: drec.get(k) for k in keys},
            "metrics": {n: farm_metric(page, n) for n in FARM_SERIES},
            "launches": {k: v - counts0.get(k, 0)
                         for k, v in (counts["launches"] or {}).items()
                         if v - counts0.get(k, 0)},
        }
        log(f"[farm consumer] {json.dumps(out['consumer'])}")
        out["clock_s"]["consumer"] = time.perf_counter() - t_phase
        for what, rec in (("load", load), ("delta", drec)):
            if rec.get("compile_s") != 0.0 or \
                    not (rec.get("artifact_hits") or {}).get("exe_hits"):
                raise AssertionError(f"farm: the consumer's {what} built: {rec}")
        if drec.get("path") != "fast":
            raise AssertionError(f"farm: the delta took {drec.get('path')}")
        if (served["parents"], served["equivalents"],
                sorted(served["unsatisfiable"])) != want:
            raise AssertionError("farm: the served taxonomy differs from the classify")
        met = out["consumer"]["metrics"]
        if None in met.values() or not met["distel_artifact_exe_hits_total"] or \
                met["distel_artifact_rejected_total"] != 0:
            raise AssertionError(f"farm: the consumer's /metrics {met}")
        for k in ("packed_cols_dense_n", "packed_cols_list_n", "packed_cols_sparse"):
            if not out["consumer"]["launches"].get(k):
                raise AssertionError(f"farm: the consumer never launched {k}")

        # 3. the path's kernels from the farm's library, in the child
        stdout, stderr = bake_result(check_proc, FARM_WORK / "check", timeout_s=300)
        if check_proc.returncode != 0:
            raise AssertionError(f"farm: the kernel check exited "
                                 f"{check_proc.returncode}: {stderr[-3000:]}")
        check = json.loads(stdout.splitlines()[-1])
        out["check"] = {"wall_s": time.perf_counter() - t_check,
                        **{k: check[k] for k in ("libraries", "nvcc_runs",
                                                 "persistent_cache_hits")}}
        if check["nvcc_runs"] != 0 or any(c["max_abs_err"] for c in check["checks"]):
            raise AssertionError(f"farm: the kernel check {check}")
        out["clock_s"]["check"] = time.perf_counter() - t_phase

        # 4. a corrupt copy, with and without --artifacts-require; the
        # re-bake beside it
        rebake = bake_process(bake_cmd, FARM_WORK / "rebake")
        procs.append(rebake)
        t_rebake = time.perf_counter()
        bad = FARM_WORK / "bad_farm"
        shutil.copytree(FARM_DIR, bad)
        manifest = json.loads((bad / artifacts.MANIFEST_NAME).read_text())
        spec = next(e["file"] for e in manifest["artifacts"].values()
                    if e.get("kind") == "step"
                    and e.get("bucket_signature") == load["bucket_signature"])
        blob = bytearray((bad / spec).read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (bad / spec).write_bytes(bytes(blob))
        t0 = time.perf_counter()
        refused = bake_process(
            [sys.executable, "-m", "distel_tpu_torch.cli", "serve", "--port", "0",
             "--device", "cuda", "--artifacts-dir", str(bad), "--artifacts-require"],
            FARM_WORK / "refused", env=toolkit_free_env(FARM_WORK / "refused_build"))
        procs.append(refused)
        check_done.set()
        proc, start = start_serve(["--artifacts-dir", str(bad)],
                                  toolkit_free_env(FARM_WORK / "lenient_build"),
                                  FARM_WORK / "lenient.log")
        procs.append(proc)
        if start is None:
            raise AssertionError("farm: the lenient consumer did not start: "
                                 + (FARM_WORK / "lenient.log").read_text()[-3000:])
        client = ServeClient(f"http://127.0.0.1:{start['port']}", timeout=600)
        lload = client.load(text)
        ldelta = client.delta(lload["id"], INC_CLASS_DELTA)
        lserved = client.taxonomy(lload["id"])
        lpage = client.metrics_text()
        proc.terminate()
        out["lenient"] = {
            "wall_s": time.perf_counter() - t0,
            "install": {k: start["artifacts"].get(k) for k in (
                "installed", "programs_built", "install_s")},
            "load": {k: lload.get(k) for k in keys},
            "delta": {k: ldelta.get(k) for k in keys},
            "rejected": farm_metric(lpage, "distel_artifact_rejected_total"),
        }
        log(f"[farm lenient] {json.dumps(out['lenient'])}")
        if out["lenient"]["rejected"] != 1 or lload.get("program_cache_hit") or \
                not lload.get("compile_s"):
            raise AssertionError(f"farm: the corrupt farm without require {out['lenient']}")
        if (lserved["parents"], lserved["equivalents"],
                sorted(lserved["unsatisfiable"])) != want:
            raise AssertionError("farm: the lenient taxonomy differs from the classify")
        cold_thread.join(timeout=600)
        cold.terminate()
        if "delta" not in cold_out:
            raise AssertionError("farm: the cold consumer did not serve: "
                                 + (FARM_WORK / "cold.log").read_text()[-3000:])
        out["cold"] = {"boot_s": cold_out["boot_s"], "load_s": cold_out["load_s"],
                       "delta_s": cold_out["delta_s"],
                       "load": {k: cold_out["load"].get(k) for k in keys + (
                           "persistent_cache_misses",)},
                       "delta": {k: cold_out["delta"].get(k) for k in keys}}
        # the library the cold process built with nvcc
        out["cold"]["built"] = sorted(p.name for p in
                                      (FARM_WORK / "cold_build").glob("lib*.so"))
        log(f"[farm cold] {json.dumps(out['cold'])}")
        if not out["cold"]["load"]["compile_s"] or not out["cold"]["built"]:
            raise AssertionError(f"farm: the cold consumer built nothing {out['cold']}")
        stdout, stderr = bake_result(refused, FARM_WORK / "refused", timeout_s=300)
        out["refused"] = {"exit": refused.returncode,
                          "error": stderr.strip().splitlines()[-1][-300:]
                          if stderr.strip() else ""}
        if refused.returncode == 0 or '"serving"' in stdout or "sha256" not in stderr:
            raise AssertionError(f"farm: the corrupt farm under require {out['refused']}")
        stdout, stderr = bake_result(rebake, FARM_WORK / "rebake")
        out["rebake_s"] = time.perf_counter() - t_rebake
        if rebake.returncode != 0:
            raise AssertionError(f"farm re-bake exited {rebake.returncode}: {stderr[-3000:]}")
        again = json.loads(stdout.splitlines()[-1])
        out["rebake"] = {k: again[k] for k in ("written", "manifest_written", "exe",
                                               "hlo_cache_keys", "kernels", "wall_s")}
        if again["written"] != 0 or again["manifest_written"]:
            raise AssertionError(f"farm: the re-bake wrote {out['rebake']}")
    finally:
        check_done.set()
        for p in procs:
            stop(p, timeout_s=30)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"farm_full_width": out}), flush=True)

    rows = []
    by_kernel = {c["kernel"]: c for c in check["checks"] if c["main_path"]}
    for variant in ("packed_cols_dense_n", "packed_cols_list_n"):
        c = by_kernel[variant]
        base = "packed_cols_dense" if variant == "packed_cols_dense_n" \
            else "packed_cols_sparse"
        row = {
            "name": f"{variant} (farm consumer)", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[base],
            "launches": out["consumer"]["launches"].get(variant, 0),
            "max_abs_err": max(x["max_abs_err"] for x in check["checks"]),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None, "dead_ms": c["dead_ms"],
            "library": "farm", "at": {"run": f"{tag}-bucketed", "site": c["rule"],
                                      "shape": c["shape"]},
        }
        if variant == "packed_cols_list_n":
            row["sparse_launches"] = out["consumer"]["launches"].get(
                "packed_cols_sparse", 0)
        rows.append(row)
    return rows


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


# ------------------------------------------------------ the cohort plane

#: the cohort plane's phase: rows a delta family of the 64k cohort
#: (the seg-OR ladder's floor rung, 8 segments a level: class-only, link
#: and mixed deltas share one roster key only within it)
COHORT_FLOOR_ROWS = 8
COHORT_BATCHED = ("packed_cols_dense_n_batched", "packed_cols_list_n_batched",
                  "packed_cols_sparse_batched")


def cohort_nf3_delta(idx, n: int = 50) -> str:
    """``n`` ∃-assertions over existing classes and links of ``idx``:
    ``SubClassOf(Find_k ObjectSomeValuesFrom(r B))`` for the first ``n``
    links (r, B) whose filler is a named class, each with its own
    subject; no link, class or role is new."""
    names, roles = idx.concept_names, idx.role_names
    named = set(int(i) for i in idx.original_classes)
    lines, seen = [], set()
    for r, f in np.asarray(idx.links).tolist():
        if f not in named or (r, f) in seen:
            continue
        seen.add((r, f))
        lines.append(f"SubClassOf(Find{3 * len(lines) + 1} "
                     f"ObjectSomeValuesFrom({roles[r]} {names[f]}))")
        if len(lines) == n:
            break
    if len(lines) < n:
        raise AssertionError(f"cohort: only {len(lines)} named links for the ∃-delta")
    return "\n".join(lines)


def cohort_cut_delta(r: int, i: int) -> str:
    """Round ``r``'s delta of tenant ``i`` on the cut corpus, within the
    canonical floor rung (so the default config forms one key): kinds
    cycle class-only (4 axioms), link (2 new links), mixed."""
    cls = "\n".join(f"SubClassOf(CohortC{r}x{i}y{j} Find{7 * j + i + r})"
                    for j in range(4))
    link = "\n".join(f"SubClassOf(Find{11 * j + i} ObjectSomeValuesFrom(attr1 "
                     f"CohortL{r}x{i}y{j}))" for j in range(2))
    return (cls, link, cls + "\n" + link)[i % 3]


#: the cohort cut's rounds: tenant indices per cohort (rungs 2, 4, 8)
COHORT_CUT_ROUNDS = [[0, 1], [2, 3, 4], [0, 1, 2, 3, 4]]


def as_json(x):
    """``x`` through JSON (tuples become lists, keys strings): the form
    in which a child process's answers compare with this one's."""
    return json.loads(json.dumps(x, sort_keys=True))


def cohort_cut_load(cut_text: str, dev: str) -> dict:
    """Five registry tenants of ``cut_text`` on ``dev``."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.serve.metrics import Metrics
    from distel_tpu_torch.serve.registry import OntologyRegistry

    reg = OntologyRegistry(ClassifierConfig(), device=dev, metrics=Metrics())
    oids = [reg.new_id() for _ in range(5)]
    t0 = time.perf_counter()
    for oid in oids:
        reg.load(oid, cut_text)
    return {"reg": reg, "oids": oids, "load_s": time.perf_counter() - t0}


def cohort_cut_rounds(box: dict, solo: bool = False) -> dict:
    """The cut rounds over ``box``'s tenants through ``delta_cohort``:
    one call a round, or with ``solo`` one call a member (each alone:
    the registry's solo fallback, the same canonical plan run solo).
    Returns the records (without build keys), walls and taxonomies
    (after the second round for tenants 0-2, and at the end)."""
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    def tax(res):
        return as_json(taxonomy_key(extract_taxonomy(res)))

    reg, oids = box.pop("reg"), box["oids"]
    recs, walls, taxes = [], [], {}
    for r, group in enumerate(COHORT_CUT_ROUNDS):
        items = [(oids[i], [cohort_cut_delta(r, i)]) for i in group]
        t0 = time.perf_counter()
        got = {}
        for part in ([[it] for it in items] if solo else [items]):
            got.update(reg.delta_cohort(part))
        if reg.device.type == "cuda":
            sync()
        walls.append(time.perf_counter() - t0)
        for i in group:
            if isinstance(got[oids[i]], BaseException):
                raise got[oids[i]]
        recs.append([as_json(without_build(got[oids[i]])) for i in group])
        if r == 1:      # tenants 0, 1, 2 after their first delta
            taxes = {str(i): tax(reg.classifier(oids[i]).last_result)
                     for i in range(3)}
    box.update(walls_s=walls, records=recs, first_taxonomies=taxes,
               final=[tax(reg.classifier(oid).last_result) for oid in oids])
    return box


def cohort_cut_cpu(cut_classes: int, out: str) -> None:
    """The cohort cut's CPU half, in a child process (no card): five
    tenants, each round's increments each alone; the result as JSON to
    ``out``."""
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology

    # half the cores: the card's process keeps the rest
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    text = without_ranges(snomed_shaped_ontology(n_classes=cut_classes, seed=42))
    box = cohort_cut_rounds(cohort_cut_load(text, "cpu"), solo=True)
    Path(out).write_text(json.dumps(box))


class BatchedRowsCapture:
    """While active, keeps per route the operand of ``batched_rows`` with
    the most work (copies × rows × links × words, copied on the card) and
    its row counts."""

    def __init__(self):
        from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan

        self.cls = PackedColsMatmulPlan
        self._orig = PackedColsMatmulPlan.batched_rows
        self.top = {}

    def __enter__(self):
        cap = self

        def batched_rows(plan, a, b, out, n_rows):
            route = "list" if plan.skip_zero_tiles else "dense"
            work = int(n_rows.sum()) * plan.l * plan.w
            if work > cap.top.get(route, (-1,))[0]:
                cap.top[route] = (work, a.clone(), b.clone(), out.clone(),
                                  n_rows.clone())
            return cap._orig(plan, a, b, out, n_rows)

        self.cls.batched_rows = batched_rows
        return self

    def __exit__(self, *exc):
        self.cls.batched_rows = self._orig


def batched_rows_bound_ms(a, b, n_rows):
    """:func:`bound_ms` of a batched row-count call: per copy its rows
    below the count (A once, the B rows some nonzero selects, C once;
    one W-word OR a nonzero), summed over the copies."""
    w = b.shape[2]
    nbytes = ops = 0
    for k in range(a.shape[0]):
        n = int(n_rows[k])
        nz = a[k, :n] != 0
        nbytes += n * a.shape[2] + 4 * w * int(nz.any(dim=0).sum()) + 4 * n * w
        ops += 2 * 32 * int(nz.sum()) * w
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_batched_rows(route: str, a, b, out, n_rows) -> dict:
    """One captured batched operand through its route's kernels at its
    rung and, re-stacked, at rungs 2 and 8 with mixed row counts (0,
    all, half, the captured ones): 0 differing words against
    ``plain_packed_cols_rows_batched``; then timed (CUDA events) beside
    the plain version, with the bound."""
    from distel_tpu_torch.ops.bitmatmul import (
        PackedColsMatmulPlan, plain_packed_cols_rows_batched,
    )

    nb, m, l = a.shape
    w = b.shape[2]
    plan = PackedColsMatmulPlan(m, l, w, skip_zero_tiles=(route == "list"))
    err, rungs = 0, {}
    for rung in sorted({2, nb, 8}):
        pick = torch.arange(rung, device=a.device) % nb
        aa, bb, oo = a[pick].contiguous(), b[pick].contiguous(), out[pick].contiguous()
        mix = torch.tensor([(int(n_rows[k % nb]), 0, m, m // 2)[k % 4]
                            for k in range(rung)], dtype=torch.int32, device=a.device)
        got = plan.batched_rows(aa, bb, oo.clone(), mix)
        sync()
        want = plain_packed_cols_rows_batched(aa, bb, oo.clone(), mix)
        diff = int((got != want).sum())
        rungs[rung] = diff
        err = max(err, diff)
        del aa, bb, oo, got, want
    if err:
        raise AssertionError(f"cohort: {route} batched kernels differ from plain "
                             f"by {rungs} words")
    c = out.clone()
    rec = {
        "route": route, "shape": [nb, m, l, w], "n_rows": n_rows.tolist(),
        "max_abs_err": err, "rung_diffs": rungs,
        "ms": time_ms(lambda: plan.batched_rows(a, b, c, n_rows)),
        "plain_ms": time_ms(lambda: plain_packed_cols_rows_batched(a, b, c, n_rows),
                            reps=3),
    }
    if route == "list":
        lists = plan._list_n_batched(a, n_rows, plan._lists[(a.device, "batched", nb)])
        rec["list_ms"] = time_ms(lambda: plan._list_n_batched(
            a, n_rows, plan._lists[(a.device, "batched", nb)]))
        rec["sparse_kernel_ms"] = time_ms(lambda: plan._sparse_batched(b, lists, c, m))
        rec["slabs"] = len(plan._batched_slabs(a.device, nb))
    dead = torch.zeros_like(n_rows)
    rec["dead_ms"] = time_ms(lambda: plan.batched_rows(a, b, c, dead))
    rec["bound_ms"], rec["bound_by"] = batched_rows_bound_ms(a, b, n_rows)
    log(f"[cohort] batched {json.dumps(rec)}")
    return rec


def start_cohort_cpu(cut_classes: int = CUT_CLASSES):
    """Start :func:`cohort_cut_cpu` in a child process with no card:
    ``(process, result path)``.  The process is killed when this one
    exits (and by :func:`phase_cohort_full_width` when done)."""
    import atexit

    out = ROOT / "build" / "smoke_cohort_cpu.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    child = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke as cs; "
         f"cs.cohort_cut_cpu({cut_classes}, {str(out)!r})"],
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    atexit.register(lambda: child.poll() is None and (child.kill(), child.wait()))
    return child, out


def phase_cohort_full_width(device: str = "cuda", n_classes: int = 64000,
                            cut_classes: int = CUT_CLASSES,
                            rows: int = COHORT_FLOOR_ROWS, cpu=None) -> list:
    """The cohort plane: same-bucket tenants' deltas advanced by one
    batched step program a vote (``core/cohort.py``).

    1. Full width, an in-process ``OntologyRegistry`` on the card:
       tenants a, b, c (the 64k corpus, seed 42, without its range
       axiom) and d (seed 41); deltas of ``rows`` axioms a family (the
       floor rung, so all four share one roster key) a: the bench's
       class-only delta's first ``rows`` axioms, b: ``rows``
       ∃-assertions over existing classes and links, c: both, d: a's.
       One ``delta_cohort`` call: each member's path and roster key,
       the rung, the votes and their walls, the cohort programs' capture
       seconds and card bytes, ``max_memory_allocated``; launches counted
       from 0 around that call (the batched kernels must launch).  Each
       cohort member is held to the same plan run solo on the card from
       its pre-cohort state (S, R, derivations, iterations, taxonomy);
       a fallback member to a from-scratch classify.  Then one eager
       group of the base position's cohort program on the final stacked
       state gives the batched kernels' heaviest operands: checked at
       rungs 2, 4 and 8 and timed (the ``kernels`` rows).
    2. Cut, card against CPU: five tenants of the cut corpus, cohorts of
       2, 3 and 5 (rungs 2, 4, 8) through ``delta_cohort`` with the
       default config on the card; on the CPU the same increments each
       alone (the registry's solo fallback: the same canonical plan run
       solo), in a child process (``cohort_cut_cpu``, no card; ``cpu``:
       one started earlier by :func:`start_cohort_cpu`) beside the card's
       work; every record (bar the cohort's own keys) and taxonomy
       equal.
    3. A card ``ServeApp`` over loopback HTTP: three tenants, their
       deltas from three threads at once; the scheduler forms a cohort
       (``distel_cohort_formed_total`` >= 1) and the answers equal the
       CPU's."""
    t_phase = time.perf_counter()
    # the cut part's CPU half runs in a child process (no card) beside
    # the card's work; ``cpu``: one the caller started earlier
    child, cpu_out = cpu if cpu is not None else start_cohort_cpu(cut_classes)
    try:
        return _cohort_phase(device, n_classes, cut_classes, rows, child,
                             cpu_out, t_phase)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        cpu_out.unlink(missing_ok=True)


def _cohort_phase(device, n_classes, cut_classes, rows, child, cpu_out,
                  t_phase) -> list:
    """:func:`phase_cohort_full_width`'s card half."""
    import threading

    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.core import bucketing
    from distel_tpu_torch.core import cohort as cohort_mod
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology
    from distel_tpu_torch.ops.bitmatmul import LAUNCHES, reset_launches
    from distel_tpu_torch.runtime.classifier import ELClassifier
    from distel_tpu_torch.runtime.instrumentation import COHORT_EVENTS
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy
    from distel_tpu_torch.serve.metrics import Metrics
    from distel_tpu_torch.serve.registry import OntologyRegistry

    out = {}

    def tax(res):
        return taxonomy_key(extract_taxonomy(res))

    # ---- 1. full width
    texts = {"a": without_ranges(snomed_shaped_ontology(n_classes=n_classes, seed=42))}
    texts["d"] = without_ranges(snomed_shaped_ontology(n_classes=n_classes, seed=41))
    metrics = Metrics()
    cfg = ClassifierConfig()
    reg = OntologyRegistry(cfg, device=device, metrics=metrics)
    ids = {}
    t0 = time.perf_counter()
    for who in "abcd":
        ids[who] = reg.new_id()
        reg.load(ids[who], texts["d" if who == "d" else "a"])
    out["load_s"] = time.perf_counter() - t0
    nf3 = cohort_nf3_delta(reg.classifier(ids["b"])._base_idx, rows)
    nf1 = "\n".join(INC_CLASS_DELTA.splitlines()[:rows])
    deltas = {"a": nf1, "b": nf3, "c": nf1 + "\n" + nf3, "d": nf1}
    out["cohort_keys"] = {w: reg.cohort_key(ids[w]) for w in "abcd"}
    runs = []
    orig = cohort_mod.execute_delta_cohort

    def hooked(members, max_iters=None, **kw):
        saved = [(inc, plan, batch, (inc._state[0].clone(), inc._state[1].clone()))
                 for inc, plan, batch in members]
        runs.append({"members": saved, "keys": [p.roster_key() for _i, p, _b in members]})
        res = orig(members, max_iters, **kw)
        runs[-1]["results"] = res
        return res

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    free_before = cohort_mod.free_bytes(device)
    ev0 = COHORT_EVENTS.snapshot()
    cohort_mod.execute_delta_cohort = hooked
    try:
        sync()
        reset_launches()
        t0 = time.perf_counter()
        answers = reg.delta_cohort([(ids[w], [deltas[w]]) for w in "abcd"])
        sync()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        cohort_mod.execute_delta_cohort = orig
    ev1 = COHORT_EVENTS.snapshot()
    if len(runs) != 1:
        raise AssertionError(f"cohort: {len(runs)} cohorts formed at 64k, one wanted")
    stats = runs[0]["members"][0][0].last_cohort
    for w in "abcd":
        if isinstance(answers[ids[w]], BaseException):
            raise answers[ids[w]]
    run = runs[0]
    members = {ids[w]: w for w in "abcd"}
    in_cohort = [members[next(o for o, e in reg._entries.items() if e.inc is inc)]
                 for inc, _p, _b, _s in run["members"]]
    full = {
        "tenants": {w: {"id": ids[w], "path": answers[ids[w]]["path"],
                        "iterations": answers[ids[w]]["iterations"],
                        "new_derivations": answers[ids[w]]["new_derivations"],
                        "batch_axioms": answers[ids[w]]["batch_axioms"]}
                    for w in "abcd"},
        "in_cohort": in_cohort,
        "roster_keys_equal": len(set(run["keys"])) == 1,
        "roster_key": list(run["keys"][0]),
        "delta_cohort_wall_s": wall,
        "rung": stats["rung"], "votes": stats["votes"],
        "vote_walls_s": stats["vote_walls_s"],
        "programs": stats["programs"], "cohort_pair_bytes": stats["pair_bytes"],
        "events": {k: ev1[k] - ev0[k] for k in ev1 if k not in ("last_size", "last_rung")},
        "launches": {k: v for k, v in launches.items() if v},
        "registry_program_bytes": bucketing.program_bytes(device),
        # the memory check's room before the call (the hook's saved
        # states take 4 lanes of it)
        "free_bytes_before": free_before,
        "phases_s": {w: reg.classifier(ids[w]).last_phases for w in "abcd"},
    }
    if device == "cuda":
        full["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if set("abc") - set(in_cohort):
        raise AssertionError(f"cohort: a, b, c must share one cohort, got {in_cohort}")
    if stats["rung"] != cohort_mod.cohort_rung(len(in_cohort)):
        raise AssertionError("cohort: wrong rung")
    if device == "cuda" and not all(launches[k] for k in COHORT_BATCHED[:2]):
        raise AssertionError(f"cohort: the batched kernels did not launch: {launches}")
    if full["events"]["solo_dispatches"] != (0 if "d" in in_cohort else
                                             full["events"]["solo_dispatches"]):
        raise AssertionError("cohort: a full cohort ran a solo dispatch")
    # each member against its plan run solo on the card from its
    # pre-cohort state, then given its cohort answer back
    checks, solo_walls = {}, []
    for (inc, plan, _b, state), res in zip(run["members"], run["results"]):
        who = members[next(o for o, e in reg._entries.items() if e.inc is inc)]
        inc._state = state
        sync()
        t0 = time.perf_counter()
        solo = inc._execute_delta_plan(plan)
        sync()
        solo_walls.append(time.perf_counter() - t0)
        same = {
            "S": bool(torch.equal(solo.packed_s, res.packed_s)),
            "R": bool(torch.equal(solo.packed_r, res.packed_r)),
            "derivations": solo.derivations == res.derivations,
            "iterations": solo.iterations == res.iterations,
        }
        same["taxonomy"] = tax(solo) == tax(res)
        checks[who] = same
        inc._state = (res.packed_s, res.packed_r)
        inc.last_result = res
        del solo, state
        if not all(same.values()):
            raise AssertionError(f"cohort: member {who} differs from its solo run: {same}")
    run["members"] = None
    full["solo_checks"] = checks
    full["solo_walls_s"] = solo_walls
    full["solo_walls_sum_s"] = sum(solo_walls)
    full["vote_walls_sum_s"] = sum(stats["vote_walls_s"])
    for w in set("abcd") - set(in_cohort):
        whole = ELClassifier(device=device).classify_text(
            texts["d" if w == "d" else "a"] + deltas[w])
        same = named_closure_equal(reg.classifier(ids[w]).last_result, whole.result)
        checks[w] = {"fallback": True, "equal_to_classify": bool(same)}
        if not same:
            raise AssertionError(f"cohort: fallback member {w} differs from a classify")
        del whole
    # the batched kernels' heaviest operands: one eager group of the base
    # position's cohort program on the final stacked state
    base_sig = run["keys"][0][-1]
    prog = next(p for k, p in list(PROGRAMS._programs.items()) if k[0] == base_sig
                and k[1] == "cohort_run" and k[3] == stats["rung"])
    base_tabs = [reg.classifier(ids[w])._base_engine.bucket_tables() for w in in_cohort]
    with prog.pair.lock, BatchedRowsCapture() as bcap:
        before = prog.pair.sp.clone()
        prog.load(base_tabs + [base_tabs[-1]] * (prog.rung - len(base_tabs)))
        prog.ms.fill_(True)
        prog.dl.copy_(prog.T["dl_valid"])
        prog._group()
        sync()
        if bool(prog.flags[:, 0].any()) or not torch.equal(prog.pair.sp, before):
            raise AssertionError("cohort: a group on the joint fixed point changed it")
        del before
    rows = []
    if device == "cuda":
        recs = [check_batched_rows(route, *top[1:])
                for route, top in sorted(bcap.top.items())]
        for rec in recs:
            names = (("packed_cols_list_n_batched", "packed_cols_sparse_batched")
                     if rec["route"] == "list" else ("packed_cols_dense_n_batched",))
            row = {
                "name": f"{names[0]} (cohort step)", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES["packed_cols_sparse" if rec["route"] == "list"
                                     else "packed_cols_dense"],
                "launches": launches[names[0]],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "dead_ms": rec["dead_ms"], "rung_diffs": rec["rung_diffs"],
                "at": {"run": "64k-cohort", "shape": rec["shape"],
                       "n_rows": rec["n_rows"]},
                "main_path": True,
            }
            if rec["route"] == "list":
                row.update(sparse_launches=launches["packed_cols_sparse_batched"],
                           list_ms=rec["list_ms"], sparse_kernel_ms=rec["sparse_kernel_ms"],
                           slabs=rec["slabs"])
            rows.append(row)
        full["kernel_checks"] = recs
    bcap.top.clear()
    del reg, run, runs, answers, prog
    out["full_width"] = full
    if device == "cuda":
        torch.cuda.empty_cache()
    log(f"[cohort] 64k: {json.dumps({k: full[k] for k in ('in_cohort', 'rung', 'votes', 'vote_walls_sum_s', 'solo_walls_sum_s')})}")

    # ---- 2. cut, card against CPU: cohorts of 2, 3 and 5
    cut_text = without_ranges(snomed_shaped_ontology(n_classes=cut_classes, seed=42))
    card = cohort_cut_rounds(cohort_cut_load(cut_text, device))
    rounds = COHORT_CUT_ROUNDS
    for r, group in enumerate(rounds):
        for rec in card["records"][r]:
            if rec["path"] != "cohort" or rec["cohort_rung"] != cohort_mod.cohort_rung(len(group)):
                raise AssertionError(f"cohort cut: round {r} did not form: {rec}")

    # ---- 3. a card ServeApp over loopback HTTP: concurrent deltas
    from distel_tpu_torch.serve.client import ServeClient
    from distel_tpu_torch.serve.server import ServeApp

    app = ServeApp(ClassifierConfig(cohort_max_wait_ms=2000.0), device=device,
                   workers=4)
    http = {}
    try:
        with http_serving(app) as url:
            client = ServeClient(url, timeout=600)
            oids = [client.load(cut_text)["id"] for _ in range(3)]
            first = {0: 0, 1: 0, 2: 1}       # the cut rounds' first deltas
            recs, errors = {}, []

            def send(i):
                try:
                    recs[i] = client.delta(oids[i], cohort_cut_delta(first[i], i))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            http["deltas_wall_s"] = time.perf_counter() - t0
            if errors:
                raise errors[0]
            http["paths"] = [recs[i]["path"] for i in range(3)]
            http["cohort_sizes"] = [recs[i].get("cohort_size") for i in range(3)]
            http["formed"] = app.metrics.counter_value("distel_cohort_formed_total")
            got = {i: tax(app.registry.classifier(oids[i]).last_result) for i in range(3)}
    finally:
        app.close(final_spill=False)
    t0 = time.perf_counter()
    if child.wait(timeout=900) != 0:
        raise AssertionError(f"cohort cut: the CPU child exited {child.returncode}")
    cpu = json.loads(cpu_out.read_text())
    # what only a cohort (or only the solo path) records, and registry
    # hits, which depend on what the process built before
    own = {"path", "cohort_size", "cohort_rung", "cohort_dispatches",
           "delta_programs", "delta_program_hits"}

    def shared(recs):
        return [[{k: v for k, v in rec.items() if k not in own} for rec in rr]
                for rr in recs]

    if any(rec["path"] != "fast" for rr in cpu["records"] for rec in rr):
        raise AssertionError("cohort cut: a CPU member left the fast path")
    if shared(card["records"]) != shared(cpu["records"]) or card["final"] != cpu["final"]:
        raise AssertionError("cohort cut: card and CPU differ")
    out["cut"] = {
        "classes": cut_classes, "rungs": [cohort_mod.cohort_rung(len(g)) for g in rounds],
        "card_equals_cpu": True,
        "card": {k: card[k] for k in ("load_s", "walls_s")},
        "cpu": {k: cpu[k] for k in ("load_s", "walls_s")},
        "cpu_wait_s": time.perf_counter() - t0,
        "iterations": [[rec["iterations"] for rec in rr] for rr in card["records"]],
        "votes": [rr[0]["cohort_dispatches"] for rr in card["records"]],
    }
    log(f"[cohort] cut: {json.dumps(out['cut'])}")
    if http["formed"] < 1:
        raise AssertionError(f"cohort http: no cohort formed: {http}")
    if as_json({str(i): t for i, t in got.items()}) != cpu["first_taxonomies"]:
        raise AssertionError("cohort http: answers differ from the CPU's")
    http["equal_to_cpu"] = True
    out["http"] = http
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"cohort_full_width": out}, default=str), flush=True)
    return rows


# ------------------------------------------------------------ the mesh plane

MESH_DIR = ROOT / "build" / "smoke_mesh"


def closure_digest(result) -> str:
    """The digest of a result's live closure, as the ranks of ``cli
    classify --mesh`` report theirs (layouts of different padding
    compare)."""
    return result.live_digest()


def mesh_cli(args, device: str = "cuda", env=None):
    """``cli classify ARGS --device DEVICE`` started in a child process
    at a lower scheduling priority (its ranks inherit it: the smoke's
    own phases keep the host's cores first); :func:`mesh_result` reads
    it."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "distel_tpu_torch.cli", "classify", *args,
         "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env=env, preexec_fn=lambda: os.nice(10))
    proc.t0 = time.perf_counter()
    return proc


def mesh_result(proc, what: str) -> dict:
    """A :func:`mesh_cli` child's JSON summary, with ``read_after_s``,
    the seconds from its start until the smoke read it (its process
    wall when nothing was read before it).  A failed run (any rank)
    fails the phase; so do ranks that gathered different closures."""
    stdout, stderr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"mesh {what}: cli classify exited {proc.returncode}:\n"
                             f"{stderr[-6000:]}")
    summary = json.loads(stdout[: stdout.rindex("}") + 1])
    summary["read_after_s"] = time.perf_counter() - proc.t0
    if len({r["closure_sha256"] for r in summary["mesh"]["ranks"]}) != 1:
        raise AssertionError(f"mesh {what}: the ranks gathered different closures")
    log(f"[mesh] {what}: {json.dumps(summary)}")
    return summary


def mesh_ranks_agree(summary, what: str, digest: str) -> None:
    """Every rank gathered the closure ``digest`` names."""
    got = {r["closure_sha256"] for r in summary["mesh"]["ranks"]}
    if got != {digest}:
        raise AssertionError(f"mesh {what}: rank closures {sorted(got)} != {digest}")


def _props(path: Path, **kv) -> str:
    path.write_text("".join(f"{k} = {v}\n" for k, v in kv.items()))
    return str(path)


def closure_ref(res, name: str) -> dict:
    """A classify's digest, derivations, iterations and taxonomy, for a
    mesh run to be held to; the digest and the taxonomy file are made
    by a background thread (``"done"``, a future), beside the phases
    that follow."""
    from concurrent.futures import ThreadPoolExecutor

    MESH_DIR.mkdir(parents=True, exist_ok=True)
    path = MESH_DIR / f"tax_{name}.txt"
    ref = {"derivations": res.result.derivations,
           "iterations": res.result.iterations, "taxonomy_file": str(path)}

    def work(result=res.result, taxonomy=res.taxonomy):
        taxonomy.write(str(path))
        ref["closure_sha256"] = closure_digest(result)

    pool = ThreadPoolExecutor(max_workers=1)
    ref["done"] = pool.submit(work)
    pool.shutdown(wait=False)
    return ref


def start_mesh_runs(n_classes: int = 64000, device: str = "cuda") -> dict:
    """Start the mesh phase's five ``cli classify`` runs (the module
    docstring's 7b), each its own process tree: the 64k corpus at
    ``--mesh 2`` (the default config), and on the cut corpus
    ``engine = packed`` in exact layout and the dense engine at ``--mesh
    2``, an NCCL mesh of one (the coordinator keys, one process) and the
    CPU's mesh of one (the packed run was at 64k until the sparse tier's
    mesh runs took its share of the budget).  They run beside the smoke's first phases (their
    start-up — each process imports torch and reaches the card — and
    their exchanges are host work), so a rank's wall here is under that
    load; PERF.md gives each run's wall alone."""
    import socket

    from distel_tpu_torch.frontend.ontology_tools import snomed_shaped_ontology

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    cut = MESH_DIR / "cut.ofn"
    cut.write_text(snomed_shaped_ontology(n_classes=CUT_CLASSES, seed=42))
    big = MESH_DIR / "s64k.ofn"
    big.write_text(snomed_shaped_ontology(n_classes=n_classes, seed=42))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    nccl = _props(MESH_DIR / "nccl.properties",
                  **{"coordinator.address": f"127.0.0.1:{port}",
                     "num.processes": 1, "process.id": 0})
    dense = _props(MESH_DIR / "dense.properties", engine="dense")
    packed = _props(MESH_DIR / "packed.properties", engine="packed",
                    **{"shape.buckets": "false"})
    cpu_env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    procs = {
        "row": mesh_cli([str(big), "--mesh", "2",
                         "-o", str(MESH_DIR / "tax_mesh.txt")], device),
        "packed": mesh_cli([str(cut), "--mesh", "2", "--config", packed], device),
        "dense": mesh_cli([str(cut), "--mesh", "2", "--config", dense], device),
        "nccl": mesh_cli([str(cut), "--config", nccl], device),
        "cpu": mesh_cli([str(cut), "--mesh", "1"], "cpu", env=cpu_env),
    }
    for proc in procs.values():
        proc.started = time.perf_counter()
    return {"procs": procs, "cut": cut, "t0": time.perf_counter()}


def finish_mesh_runs(runs: dict, device: str = "cuda") -> dict:
    """Wait for the mesh runs and hold the cut corpus's to their
    references: the dense and packed meshes of two to the solo dense and
    packed card runs (here), the NCCL mesh of one to the CPU's mesh of
    one.  Returns the runs' records; every process is stopped whatever
    happens."""
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.runtime.classifier import ELClassifier

    procs, out = runs["procs"], {}
    try:
        for key, what in (("row", "64k row-packed"), ("packed", "cut packed"),
                          ("dense", "cut dense"), ("nccl", "cut NCCL mesh of one"),
                          ("cpu", "cut CPU mesh of one")):
            out[key] = mesh_result(procs[key], what)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["runs_wall_s"] = time.perf_counter() - runs["t0"]
    for key, cfg in (("dense", ClassifierConfig(engine="dense")),
                     ("packed", ClassifierConfig(engine="packed", shape_buckets=False))):
        solo = ELClassifier(cfg, device=device).classify_text(runs["cut"].read_text())
        run = out[key]
        mesh_ranks_agree(run, f"cut {key}", closure_digest(solo.result))
        if (run["derivations"], run["iterations"]) != (solo.result.derivations,
                                                       solo.result.iterations):
            raise AssertionError(f"mesh cut {key}: derivations or iterations differ")
        run["equal_to_solo"] = True
    nccl, cpu = out["nccl"], out.pop("cpu")
    if nccl["mesh"]["ranks"][0]["backend"] != ("nccl" if device == "cuda" else "gloo"):
        raise AssertionError(f"mesh of one: backend {nccl['mesh']['ranks'][0]['backend']}")
    mesh_ranks_agree(nccl, "cut NCCL mesh of one", cpu["mesh"]["ranks"][0]["closure_sha256"])
    if (nccl["derivations"], nccl["iterations"]) != (cpu["derivations"], cpu["iterations"]):
        raise AssertionError("mesh of one: card and CPU derivations or iterations differ")
    nccl["equal_to_cpu"] = True
    nccl["cpu_wall_s"] = cpu["mesh"]["ranks"][0]["wall_s"]
    for key in ("row", "packed"):
        for rec in out[key]["mesh"]["ranks"] if device == "cuda" else ():
            for k in (("packed_cols_dense_n", "packed_cols_list_n", "packed_cols_sparse")
                      if key == "row" else ("packed_andor_list",)):
                if not rec["launches"].get(k):
                    raise AssertionError(f"mesh 64k {key} rank {rec['rank']}: "
                                         f"{k} never launched")
    return out


def phase_mesh_full_width(mesh: dict, solo_ref: dict, heaviest: dict,
                          device: str = "cuda") -> list:
    """The 64k mesh run held to the solo card classify of the same text
    (``solo_ref``: phase 5's default classify) — the gathered closure's
    digest on every rank, derivations, iterations, the taxonomy rank 0
    wrote; then the
    bucketed step's heaviest operands (``heaviest``) at each rank's word
    window through both row-count routes against the plain version (the
    kernel line's ``(mesh 2, rank window)`` rows, their launches the
    mesh run's).  Prints the phase's line; returns the rows."""
    for key, ref, tax in (("row", solo_ref, "tax_mesh.txt"),):
        ref.pop("done").result()
        run = mesh[key]
        mesh_ranks_agree(run, f"64k {key}", ref["closure_sha256"])
        for k in ("derivations", "iterations"):
            if run[k] != ref[k]:
                raise AssertionError(f"mesh 64k {key}: {k} {run[k]} != {ref[k]}")
        if (MESH_DIR / tax).read_text() != Path(ref["taxonomy_file"]).read_text():
            raise AssertionError(f"mesh 64k {key}: taxonomy differs from the solo run's")
        run["solo"] = ref
        run["equal_to_solo"] = True
    rows, checks, launches = [], [], {}
    for rec in mesh["row"]["mesh"]["ranks"]:
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for variant, (site, a, b, sparse) in sorted(heaviest.items()):
        if device != "cuda":
            break
        wl = b.shape[1] // 2
        a = a.cuda()
        ops = [(f"{site} rank {r}", a, b[:, r * wl:(r + 1) * wl].contiguous().cuda(),
                sparse) for r in range(2)]
        mine = [c for c in check_variants(ops) if c["kernel"] == variant]
        checks += mine
        top = mine[-1]
        rows.append({
            "name": f"{variant} (mesh 2, rank window)", "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES["packed_cols_sparse" if sparse else "packed_cols_dense"],
            "launches": launches.get(variant, 0),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "dead_ms": top["dead_ms"],
            "at": {"run": "64k-mesh2", "site": site, "shape": top["shape"],
                   "ranks_ms": [c["ms"] for c in mine]},
            "main_path": True,
        })
        del a, ops
    mesh["rank_window_checks"] = checks
    print(json.dumps({"mesh_full_width": mesh}, default=str), flush=True)
    return rows


# ------------------------------------- the observed paths on a mesh (7c)

MESH_OBS_DIR = ROOT / "build" / "smoke_mesh_observed"


def digests_later(res, taxonomy):
    """A future of ``{"closure_sha256", "taxonomy_sha256"}`` of a result
    and its taxonomy: the closure is copied to the host now, and a
    background thread hashes both (``SaturationResult.live_digest``,
    ``Taxonomy.digest``) beside the phases that follow."""
    from concurrent.futures import ThreadPoolExecutor

    from distel_tpu_torch.core.engine import SaturationResult

    s, r = res.wire()
    host = SaturationResult(
        packed_s=torch.from_numpy(s.view(np.int32)),
        packed_r=torch.from_numpy(r.view(np.int32)), iterations=res.iterations,
        derivations=res.derivations, idx=res.idx, transposed=res.transposed)

    def work():
        return {"closure_sha256": host.live_digest(),
                "taxonomy_sha256": taxonomy.digest()}

    pool = ThreadPoolExecutor(max_workers=1)
    done = pool.submit(work)
    pool.shutdown(wait=False)
    return done


def observer_events(obs) -> list:
    """An observer's ``(iteration, derivations, changed)`` sequence as
    plain JSON values."""
    return [[int(it), int(d), bool(ch)] for it, d, ch in obs]


def _observed_record(engine, run, info=None) -> dict:
    """What one observed run on a rank reports: the round records (with
    each round's wall and launches), the observer's sequence, iterations,
    derivations, the closure's and the taxonomy's digests, the wall."""
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    obs, rounds, res, wall, launches = run
    rec = {
        "records": round_records(rounds), "events": observer_events(obs),
        "iterations": res.iterations, "derivations": res.derivations,
        "closure_sha256": res.live_digest(),
        "taxonomy_sha256": extract_taxonomy(res).digest(),
        "tiers": tier_string(rounds), "wall_s": wall, "launches": launches,
        "sparse_round_launches": sparse_launches(rounds),
        "rounds": [{k: r[k] for k in ("iteration", "tier", "rows_touched",
                                       "derivations", "wall_s", "launches")}
                   for r in rounds],
        "host_reads": dict(engine.host_reads),
    }
    if info is not None:
        rec["fused"] = {k: info[k] for k in ("windows", "fallouts", "dropped",
                                             "dispatch", "captured")}
        rec["launches"] = info["launches"]
    return rec


def mesh_observed_rank(device, jobs) -> dict:
    """One rank of 7c's (a) and (b) (or of their cut runs): per job the
    engine on this rank's mesh (the group's, or a mesh of one), one
    observed run (``fused_run`` with a K, else ``observed_run``), the
    counts set to 0 just before it; with ``capture`` the sparse tier's
    heaviest operand per site and kernel at this rank's word window
    (moved to the host, for the parent to check).  Returns the rank's
    records."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
    from distel_tpu_torch.owl import native_loader
    from distel_tpu_torch.parallel.mesh import build_mesh
    from distel_tpu_torch.parallel.shard_compat import COLLECTIVES

    mesh = build_mesh(device=device)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(device), "jobs": {}, "pairs": []}
    on_card = device.type == "cuda"
    for job in jobs:
        t0 = time.perf_counter()
        idx = native_loader.load_indexed(Path(job["text"]).read_text())
        engine = RowPackedSaturationEngine(idx, device=device, unroll=1, mesh=mesh)
        plan_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        COLLECTIVES.reset()
        cap = Capture() if job.get("capture") else contextlib.nullcontext()
        if job.get("capture"):
            cap.run = job["name"]
        with cap:
            if "fused_rounds" in job["kw"]:
                run, info = fused_run(engine, **job["kw"])
            else:
                run, info = observed_run(engine, **job["kw"]), None
        rec = _observed_record(engine, run, info)
        rec.update(
            plan_s=plan_s, concepts=idx.n_concepts,
            window=[engine.wl, engine.word_base],
            shard_shapes=([list(t.shape) for t in run[2].shards]
                          if run[2].shards is not None else None),
            collectives=COLLECTIVES.snapshot(),
            max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                  if on_card else None),
        )
        out["jobs"][job["name"]] = rec
        if job.get("capture"):
            heaviest = {}
            for key, (n, nnz, a, b) in cap.pairs.items():
                if key[1].startswith("sparse"):
                    got = heaviest.setdefault(key[1:3], [0, -1, None, None])
                    got[0] += n
                    if nnz > got[1]:
                        got[1:] = [nnz, a, b]
            out["pairs"] += [(job["name"], site, kern, n, a, b)
                             for (site, kern), (n, _nnz, a, b) in sorted(heaviest.items())]
        del engine, run, info, idx
        if on_card:
            torch.cuda.empty_cache()
    return out


def mesh_observed_main(spec_path: str) -> None:
    """7c's background process (``start_mesh_observed``): (c), then (a)
    and (b) on two gloo ranks, then the cut runs on an NCCL mesh of one
    and on the CPU, in turn; every record to ``result.json``, the
    captured operands to ``pairs.pt``.  Every process it starts is
    stopped before it returns (``launch_local`` terminates its ranks)."""
    from distel_tpu_torch.parallel.mesh import launch_local

    spec = json.loads(Path(spec_path).read_text())
    out = {"t0_unix": time.time()}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "distel_tpu_torch.cli", "stream", *spec["stream"],
         "--retract", spec["stream"][1], "--config", spec["stream_props"],
         "--device", spec["device"]],
        capture_output=True, text=True, cwd=str(ROOT), timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"mesh stream exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    out["stream"] = {"lines": [json.loads(ln) for ln in proc.stdout.splitlines()
                               if ln.startswith("{")],
                     "process_wall_s": time.perf_counter() - t0}
    log(f"[mesh observed] stream {out['stream']['process_wall_s']:.1f} s")
    pairs = []
    for key, n, jobs, device in (("mesh2", 2, spec["jobs"], spec["device"]),
                                 ("nccl1", 1, spec["cut_jobs"], spec["device"])):
        t1 = time.perf_counter()
        ranks = launch_local(n, mesh_observed_rank, jobs, device=device)
        for r in ranks:
            pairs += [(r["rank"], *p) for p in r.pop("pairs")]
        out[key] = {"ranks": ranks, "process_wall_s": time.perf_counter() - t1}
        log(f"[mesh observed] {key} {out[key]['process_wall_s']:.1f} s")
    torch.set_num_threads(2)
    t1 = time.perf_counter()
    cpu = mesh_observed_rank(torch.device("cpu"), spec["cut_jobs"])
    cpu.pop("pairs")
    out["cpu1"] = {"ranks": [cpu], "process_wall_s": time.perf_counter() - t1}
    out["wall_s"] = time.perf_counter() - t0
    torch.save(pairs, MESH_OBS_DIR / "pairs.pt")
    (MESH_OBS_DIR / "result.json").write_text(json.dumps(out, default=str))


def start_mesh_observed(n_classes: int = 64000, chain_depth: int = 64,
                        device: str = "cuda") -> dict:
    """Start 7c's background process tree (at a lower scheduling
    priority, as 7b's): it writes the corpora and deltas, then runs
    :func:`mesh_observed_main`.  :func:`phase_mesh_observed_full_width`
    reads it."""
    from distel_tpu_torch.frontend.ontology_tools import (
        chain_tailed_ontology, snomed_shaped_ontology,
    )

    shutil.rmtree(MESH_OBS_DIR, ignore_errors=True)
    MESH_OBS_DIR.mkdir(parents=True)
    d = MESH_OBS_DIR
    text = snomed_shaped_ontology(n_classes=n_classes, seed=42)
    files = {"forced.ofn": text,
             "chain.ofn": chain_tailed_ontology(n_classes, chain_depth),
             "cut.ofn": snomed_shaped_ontology(n_classes=CUT_CLASSES, seed=42),
             "base.ofn": without_ranges(text),
             "d1.ofn": INC_CLASS_DELTA, "d2.ofn": INC_ROLE_DELTA,
             "d3.ofn": INC_CLOSURE_DELTA}
    for name, body in files.items():
        (d / name).write_text(body)
    forced = dict(sparse_tail=FORCED_WIDE)
    spec = {
        "device": device,
        "stream": [str(d / n) for n in ("base.ofn", "d1.ofn", "d2.ofn", "d3.ofn")],
        "stream_props": _props(d / "stream.properties",
                               **{"mesh.devices": 2, "shape.buckets": "false"}),
        "jobs": [
            {"name": "forced_64k", "text": str(d / "forced.ofn"), "kw": forced,
             "capture": True},
            {"name": "chain_K8", "text": str(d / "chain.ofn"),
             "kw": dict(sparse_tail=True, fused_rounds={"rounds": 8})},
        ],
        "cut_jobs": [
            {"name": "forced_cut", "text": str(d / "cut.ofn"), "kw": forced},
            {"name": "forced_cut_K8", "text": str(d / "cut.ofn"),
             "kw": dict(forced, fused_rounds={"rounds": 8})},
        ],
    }
    (d / "spec.json").write_text(json.dumps(spec))
    err = open(d / "stderr.txt", "w")

    def lower():
        os.setsid()        # its own process group: stopped as a whole
        os.nice(10)

    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke as cs; cs.mesh_observed_main(sys.argv[1])",
         str(d / "spec.json")],
        stdout=err, stderr=subprocess.STDOUT, text=True, cwd=str(ROOT),
        preexec_fn=lower)
    # a smoke that fails before reading it still stops the tree
    import atexit

    atexit.register(_stop_tree, proc)
    return {"proc": proc, "t0": time.perf_counter(), "err": err}


def _stop_tree(proc) -> None:
    """Kill ``proc``'s process group (it and the ranks it spawned) if it
    is still running."""
    import signal

    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _hold(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"mesh observed {what}: {got!r} != {want!r}")


def phase_mesh_observed_full_width(runs: dict, refs: dict,
                                   device: str = "cuda") -> list:
    """Wait for 7c's process tree, hold every run to its reference
    (``refs``: what phases 9, 10 and 10b kept; the NCCL runs to the
    CPU's) and check the sparse tier's captured operands at each rank's
    window; print the phase's line and return the kernel line's rows."""
    proc = runs["proc"]
    try:
        proc.wait(timeout=1200)
    finally:
        _stop_tree(proc)
        runs["err"].close()
    if proc.returncode != 0:
        raise AssertionError(f"mesh observed: the runs exited {proc.returncode}:\n"
                             f"{(MESH_OBS_DIR / 'stderr.txt').read_text()[-8000:]}")
    out = json.loads((MESH_OBS_DIR / "result.json").read_text())
    out["read_after_s"] = time.perf_counter() - runs["t0"]
    for ref in [refs["forced_64k"], refs["chain_per_round"], *refs["stream"]]:
        ref.update(ref.pop("digests").result())
    # (a) and (b): every rank against the solo runs
    for rank in out["mesh2"]["ranks"]:
        _hold("rank size", (rank["size"], rank["backend"]), (2, "gloo"))
        for name, ref_key, rec_key in (("forced_64k", "forced_64k", "records"),
                                       ("chain_K8", "chain_per_round", "fused")):
            got, want = rank["jobs"][name], refs[ref_key]
            recs = got["records"] if rec_key == "records" else \
                [r[:5] for r in got["records"]]
            _hold(f"{name} rank {rank['rank']} rounds", [list(r) for r in recs],
                  [list(r) for r in want["records"]])
            _hold(f"{name} rank {rank['rank']} events", got["events"], want["events"])
            for k in ("iterations", "derivations", "closure_sha256", "taxonomy_sha256"):
                _hold(f"{name} rank {rank['rank']} {k}", got[k], want[k])
            if not got["collectives"]["total"]["calls"]:
                raise AssertionError(f"mesh observed {name}: no collective ran")
        sparse = rank["jobs"]["forced_64k"]["sparse_round_launches"]
        if device == "cuda" and not any(v for k, v in sparse.items()
                                        if k.startswith("packed_cols")):
            raise AssertionError(f"mesh observed forced: the sparse rounds launched "
                                 f"no kernel: {sparse}")
        fl = rank["jobs"]["chain_K8"]["launches"]
        if device == "cuda" and not (fl.get("packed_cols_dense_n", 0)
                                     + fl.get("packed_cols_list_n", 0)):
            raise AssertionError(f"mesh observed chain K8: the window's kernels "
                                 f"were not launched: {fl}")
    # the cut runs: the NCCL mesh of one (windows captured) against the CPU's
    (nccl,), (cpu,) = out["nccl1"]["ranks"], out["cpu1"]["ranks"]
    _hold("cut backend", nccl["backend"], "nccl" if device == "cuda" else "gloo")
    for name in ("forced_cut", "forced_cut_K8"):
        for k in ("records", "events", "iterations", "derivations",
                  "closure_sha256", "taxonomy_sha256"):
            _hold(f"{name} card vs CPU {k}", nccl["jobs"][name][k], cpu["jobs"][name][k])
    if device == "cuda" and not any(w["captured_ops"] for w in
                                    nccl["jobs"]["forced_cut_K8"]["fused"]["captured"]):
        raise AssertionError("mesh observed: the NCCL mesh of one captured no window")
    for rank in out["mesh2"]["ranks"]:
        if any(w["captured_ops"] for w in rank["jobs"]["chain_K8"]["fused"]["captured"]):
            raise AssertionError("mesh observed: a window of two ranks was captured")
    # (c): every rank's every step against the solo stream's
    lines = out["stream"]["lines"]
    totals = lines[-1]
    want = refs["stream"]
    _hold("stream paths", [ln["path"] for ln in lines[:-1]], [w["path"] for w in want])
    _hold("stream iterations", [ln["iterations"] for ln in lines[:-1]],
          [w["iterations"] for w in want])
    for rank in totals["mesh"]["ranks"]:
        for k in ("closure_sha256", "taxonomy_sha256", "path", "iterations"):
            _hold(f"stream rank {rank['rank']} {k}", [s[k] for s in rank["steps"]],
                  [w[k] for w in want])
        for kern in ("packed_cols_list", "packed_cols_sparse"):
            if device == "cuda" and not rank["launches"].get(kern):
                raise AssertionError(f"mesh stream rank {rank['rank']}: {kern} "
                                     "never launched")
    out["equal_to_solo"] = True
    # the sparse tier's operands at each rank's window
    rows, checks = [], []
    launches = {}
    for rank in out["mesh2"]["ranks"]:
        for k, v in rank["jobs"]["forced_64k"]["sparse_round_launches"].items():
            launches[k] = launches.get(k, 0) + v
    pairs = (torch.load(MESH_OBS_DIR / "pairs.pt", weights_only=False)
             if device == "cuda" else [])
    by_kern = {}
    for rank, run, site, kern, n, a, b in pairs:
        chk = check_pair(f"{run}:mesh2:rank{rank}", site, kern, n, a, b)
        checks.append({k: chk[k] for k in ("run", "site", "main_path_kernel", "shape",
                                           "launches", "max_abs_err", "dense_ms",
                                           "sparse_ms", "plain_ms", "bound_ms",
                                           "bound_by")})
        by_kern.setdefault(kern, []).append(chk)
    for kern, mine in sorted(by_kern.items()):
        # the site that launched the kernel most, its heavier rank
        top = max(mine, key=lambda c: (c["launches"], c["shape"][0] * c["shape"][2]))
        sparse_k = kern == "packed_cols_sparse"
        rows.append({
            "name": f"{kern} (sparse tier, mesh 2, rank window)", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[kern],
            "launches": launches.get(kern, 0),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": top["sparse_ms"] if sparse_k else top["dense_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "at": {"run": "forced_64k-mesh2", "site": top["site"],
                   "shape": top["shape"], "ranks": [c["run"] for c in mine]},
            "main_path": True,
        })
    out["rank_window_checks"] = checks
    shutil.rmtree(MESH_OBS_DIR, ignore_errors=True)
    print(json.dumps({"mesh_observed_full_width": out}, default=str), flush=True)
    return rows


PHASE_DIR = ROOT / "build" / "smoke_phases"


def phase_child_main(name: str, call: str) -> None:
    """A phase in a child process (:func:`start_phase`): ``call`` is the
    JSON ``[function name, keyword arguments]``; its return value goes
    as JSON to ``<name>.json``."""
    fn, kw = json.loads(call)
    # the smoke's own process keeps most of the cores
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    res = globals()[fn](**kw)
    (PHASE_DIR / f"{name}.json").write_text(json.dumps(
        {"result": res, "wall_s": time.perf_counter() - t0}, default=str))


def start_phase(name: str, fn, **kw) -> dict:
    """Run ``fn(**kw)`` in a child process beside the smoke's own phases,
    in its own process group (stopped with every process it started if
    the smoke exits first); its standard output and error go to files
    that :func:`finish_phase` copies into the smoke's."""
    import atexit

    PHASE_DIR.mkdir(parents=True, exist_ok=True)
    files = {k: PHASE_DIR / f"{name}.{k}" for k in ("json", "out", "err")}
    for p in files.values():
        p.unlink(missing_ok=True)
    out, err = open(files["out"], "w"), open(files["err"], "w")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import sys, chip_smoke as cs; cs.phase_child_main(*sys.argv[1:])",
         name, json.dumps([fn.__name__, kw])],
        stdout=out, stderr=err, text=True, cwd=str(ROOT), preexec_fn=os.setsid)
    out.close()
    err.close()
    atexit.register(_stop_tree, proc)
    return {"name": name, "proc": proc, "files": files, "t0": time.perf_counter()}


def finish_phase(run: dict, timeout_s: float = 1200):
    """Wait for a :func:`start_phase` child, copy its output into the
    smoke's (standard error first, then standard output) and return the
    phase's return value; raise if it failed."""
    proc, files = run["proc"], run["files"]
    try:
        proc.wait(timeout=timeout_s)
    finally:
        _stop_tree(proc)
    sys.stderr.write(files["err"].read_text())
    sys.stderr.flush()
    if proc.returncode != 0:
        raise AssertionError(f"{run['name']}: the phase's process exited "
                             f"{proc.returncode}")
    sys.stdout.write(files["out"].read_text())
    sys.stdout.flush()
    doc = json.loads(files["json"].read_text())
    log(f"[{run['name']}] the phase's wall in its process {doc['wall_s']:.1f} s, "
        f"read {time.perf_counter() - run['t0']:.1f} s after its start")
    for p in files.values():
        p.unlink(missing_ok=True)
    return doc["result"]


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

    def mark(what):
        # the smoke's clock at each phase's end, for its time budget
        log(f"[clock] {what} {time.perf_counter() - t_start:.1f} s")

    name = phase_probe()
    # the mesh plane's runs, beside the first phases (7b and 7c; they
    # load the kernels the probe built)
    mesh_runs = start_mesh_runs()
    mesh_observed = start_mesh_observed()
    #: what 7c is held to, kept by phases 9, 10 and 10b
    mesh_refs = {}
    phase_kernels()
    andor_checks = phase_andor_kernel()
    phase_golden()
    phase_golden(engine="packed")
    mark("goldens")
    cap = Capture()
    row8k = phase_card_vs_cpu(cap)
    phase_cross_engine(row8k)
    phase_gating()
    phase_dense()
    phase_hybrid()
    del row8k
    phase_verify()
    phase_xml_corpora()
    phase_incremental_card_vs_cpu()
    mark("8k phases")
    mesh = finish_mesh_runs(mesh_runs)
    mark("mesh runs")
    launches, res = phase_default_full_width()
    solo_ref = closure_ref(res, "solo")
    phase_full_width(res)
    exact, exact_launches = phase_bucket_full_width(res)
    bucket_operands(res.engine, res.result, cap)
    heaviest = bucket_heaviest(cap)
    bucket_rows = bucket_kernel_rows(heaviest, launches)
    mark("64k bucketed")
    del res
    torch.cuda.empty_cache()
    # the phases that watch each launch from the host run the exact engine
    phase_breakdown(exact)
    phase_threshold_ab(exact)
    phase_capture_64k(exact, cap)
    packed_launches, packed = phase_packed_full_width(exact)
    del exact
    torch.cuda.empty_cache()
    phase_packed_breakdown(packed)
    andor_row = phase_andor_operands(packed, packed_launches, andor_checks)
    del packed
    torch.cuda.empty_cache()
    mesh_rows = phase_mesh_full_width(mesh, solo_ref, heaviest)
    del heaviest
    mark("64k exact and packed")
    checked = phase_multiplied_full_width(cap)
    torch.cuda.empty_cache()
    mark("multiplied")
    batched_row = phase_partition_full_width()
    torch.cuda.empty_cache()
    mark("partition")
    # from here three phases run in processes of their own beside this
    # one's (7c's tree is done by now): the fleet (its replicas are
    # processes anyway), the cohort phase's CPU half (no card) and the
    # farm (its bake and consumers are processes anyway)
    fleet = start_phase("fleet", phase_fleet_full_width, n_big=SERVE_CLASSES)
    checked += phase_incremental_full_width(cap, mesh_refs)
    torch.cuda.empty_cache()
    mark("incremental")
    cohort_cpu = start_cohort_cpu()
    checked += phase_observed_full_width(cap, refs=mesh_refs)
    torch.cuda.empty_cache()
    mark("observed")
    farm = start_phase("farm", phase_farm_full_width, n_classes=SERVE_CLASSES)
    fused_rows = phase_fused_full_width(refs=mesh_refs)
    torch.cuda.empty_cache()
    mark("fused")
    mesh_observed_rows = phase_mesh_observed_full_width(mesh_observed, mesh_refs)
    mark("mesh observed")
    cohort_rows = phase_cohort_full_width(cpu=cohort_cpu)
    torch.cuda.empty_cache()
    mark("cohort")
    phase_serve_card_vs_cpu()
    checked += phase_serve_full_width(cap, n_big=SERVE_CLASSES)
    torch.cuda.empty_cache()
    mark("serve")
    farm_rows = finish_phase(farm)
    mark("farm")
    finish_phase(fleet)
    mark("fleet")
    rows, pairs = phase_kernel_line(launches, exact_launches, cap, checked)
    rows.extend(bucket_rows)
    rows.append(andor_row)
    rows.append(batched_row)
    rows.extend(fused_rows)
    rows.extend(farm_rows)
    rows.extend(cohort_rows)
    rows.extend(mesh_rows)
    rows.extend(mesh_observed_rows)
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
