"""Command-line interface of the port.

  classify   load → saturate → taxonomy on a CUDA device (the engine
             from --config: ``engine = rowpacked``, ``packed`` or
             ``dense``; ``backend.CRn = host`` routes a rule to the
             host); ``--verify`` diffs the closure against the CPU
             oracle; ``--mesh N`` shards the fixed point over N local
             ranks (``parallel/mesh.py``; rank 0 prints and writes);
             with the coordinator keys in ``--config`` the process is
             one rank of an external group
  stream     classify a base ontology, then add each delta file on top
             of the running closure (``core/incremental.py``), then
             retract each ``--retract`` file: one JSON record per step,
             then the totals; ``mesh.devices = N`` in ``--config`` runs
             the stream on N local ranks (rank 0 prints and writes)
  diff       the dense engine's closure against the CPU oracle; exit 1
             on a difference
  normalize  dump the NF1-NF6 normal forms
  stats      axiom-shape census (JSON)
  check      EL profile check (JSON); exit 1 when axioms are removed
  multiply   n renamed copies of an ontology (``--crossed`` links
             neighbouring copies), written as OFN
  partition  component-partitioned classification
             (``core/components.py``): isomorphic components run as one
             batched fixed point; prints the counters as JSON (the mesh
             keys are ignored, as in the reference)
  serve      the resident classification service (``serve/``): HTTP
             on ``--host``/``--port``, one incremental classifier per
             loaded ontology on the card, graceful SIGTERM with a final
             spill; ``--replica-id`` adds the fleet's /fleet admin plane
  fleet      the serve fleet (``serve/fleet/``): a router in front of N
             supervised replica processes, all on the one device
             ``--device`` names (affinity placement, live migration,
             journal-replay recovery, read replicas)
  query      snapshot-plane reads against a serve process
  trace      fetch a recorded request trace from ``/debug/trace``
  runs       run observatory over run ledgers (``obs/ledger.py``):
             ``list`` chains, ``report`` one, ``watch`` a ledger file
  warmup     build the bucket programs of sample corpora
             (``runtime/warmup.py``): one JSON record per corpus and a
             summary; ``serve --warmup`` (and ``fleet --warmup``, passed
             to each replica) warms in a background thread before
             traffic
  farm-build bake the artifact farm (``core/artifacts.py``): the kernel
             libraries and the spec of every bucket program the sample
             corpora (and ``--delta``) build, under a checksummed
             manifest that ``--artifacts-dir`` installs in a fresh
             process (no ``nvcc``, ``compile_s == 0.0`` on its first
             load and delta)

Every command reads OWL functional syntax, RDF/XML or OWL/XML.

Usage: python -m distel_tpu_torch.cli classify FILE [--device cpu] [--mesh N] ...
       python -m distel_tpu_torch.cli stream BASE [DELTA ...] [--retract F] [--device cpu]
       python -m distel_tpu_torch.cli diff FILE [--device cpu]
       python -m distel_tpu_torch.cli multiply FILE N -o OUT [--crossed]
       python -m distel_tpu_torch.cli partition FILE [--device cpu] [--config P]
       python -m distel_tpu_torch.cli serve [--port 8080] [--device cpu] ...
       python -m distel_tpu_torch.cli fleet --spill-dir D [--replicas 2] [--device cpu]
       python -m distel_tpu_torch.cli query OID subsumers CLASS [--url URL]
       python -m distel_tpu_torch.cli trace [TRACE_ID] [--format chrome]
       python -m distel_tpu_torch.cli runs list|report|watch LEDGER ...
       python -m distel_tpu_torch.cli farm-build FILE --out DIR [--delta D]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _load_cfg(args):
    from distel_tpu_torch.config import ClassifierConfig

    return (
        ClassifierConfig.from_properties(args.config)
        if args.config
        else ClassifierConfig()
    )


def _install_farm(cfg, args, device) -> bool:
    """Install the config's artifact farm (``--artifacts-dir`` and
    ``--artifacts-require`` override its keys) for ``device``; print the
    install record when there is a farm.  Returns whether one was
    installed."""
    from distel_tpu_torch.core import artifacts

    if getattr(args, "artifacts_dir", None):
        cfg.artifacts_dir = args.artifacts_dir
    if getattr(args, "artifacts_require", False):
        cfg.artifacts_require = True
    rec = artifacts.install_from_config(cfg, device=device)
    if rec is not None:
        print(json.dumps({"artifacts": rec}), flush=True)
    return bool(rec and rec.get("installed"))


def cmd_classify(args) -> int:
    from distel_tpu_torch.runtime.classifier import ELClassifier, resolve_device

    cfg = _load_cfg(args)
    warm_farm = _install_farm(cfg, args, resolve_device(args.device))
    cfg.instrumentation = args.instrument
    if args.budget_s is not None:
        # launch budget guard: predict the wall from the fitted cost
        # model BEFORE paying load/saturate, and refuse a run that
        # cannot fit the stage budget (the basis is the port's own run
        # ledgers under the repo's runs/, not the cwd's)
        from distel_tpu_torch.obs import costmodel
        from distel_tpu_torch.runtime.stats import ontology_stats

        repo_root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        model = costmodel.fit_from_paths(
            args.model_from
            if args.model_from is not None
            else costmodel.default_basis_paths(repo_root),
            shards=1,
        )
        n = ontology_stats(args.ontology)["classes"]
        guard = costmodel.guard_launch(
            model, n, args.budget_s, force=args.force,
            warm_artifacts=warm_farm,
        )
        print(json.dumps({"launch_guard": guard}), flush=True)
        if not guard["allowed"]:
            print(f"refusing launch: {guard['reason']}", file=sys.stderr)
            return 3
    if args.mesh is not None and args.mesh > 1:
        from distel_tpu_torch.parallel.mesh import launch_local

        cfg.mesh_devices = args.mesh
        t0 = time.perf_counter()
        ranks = launch_local(args.mesh, _classify_rank, cfg, args.ontology,
                             args.verify, args.resume, bool(args.snapshot),
                             device=args.device)
        summary = dict(ranks[0]["summary"])
        summary["mesh"] = {"size": args.mesh, "launch_s": time.perf_counter() - t0,
                           "ranks": [r["rank"] for r in ranks]}
        print(json.dumps(summary, indent=2))
        _write_outputs(args, ranks[0]["taxonomy"], ranks[0]["snapshot"])
        return 0
    if args.mesh is not None:
        cfg.mesh_devices = args.mesh
    clf = ELClassifier(cfg, device=args.device)
    if clf.mesh is not None:
        # a mesh of one, or one rank of an external group (the
        # coordinator keys): every rank classifies and reports itself,
        # rank 0 prints the summary and writes
        rec = _classify_rank(clf.device, cfg, args.ontology, args.verify,
                             args.resume, bool(args.snapshot), clf=clf)
        if clf.mesh.rank == 0:
            summary = dict(rec["summary"], mesh={"size": clf.mesh.size,
                                                 "ranks": [rec["rank"]]})
            print(json.dumps(summary, indent=2))
            _write_outputs(args, rec["taxonomy"], rec["snapshot"])
        else:
            print(json.dumps({"mesh_rank": rec["rank"]}))
        return 0
    res = clf.classify_file(
        args.ontology, verify=args.verify, resume_from=args.resume
    )
    print(json.dumps(res.summary(), indent=2))
    _write_outputs(args, res.taxonomy, res.result if args.snapshot else None)
    return 0


def _write_outputs(args, taxonomy, snapshot_result) -> None:
    if args.output:
        taxonomy.write(args.output)
        print(f"taxonomy written to {args.output}")
    if args.snapshot:
        from distel_tpu_torch.runtime.checkpoint import save_snapshot

        save_snapshot(args.snapshot, snapshot_result)
        print(f"snapshot written to {args.snapshot}")


def _classify_rank(device, cfg, path, verify, resume, snapshot=False,
                   clf=None) -> dict:
    """One rank of ``classify --mesh``: the classify on this rank's
    shard, and what the rank saw — its wall and phases, its peak card
    memory, its collectives (calls, bytes, seconds), its windows
    contracted and skipped, its kernel launches and their shard-local
    product shapes, and the digest of the gathered closure
    (``SaturationResult.live_digest``).  Rank 0
    also returns the summary, the taxonomy and (for ``--snapshot``) the
    result, moved to the host."""
    import torch

    from distel_tpu_torch.ops import bitmatmul
    from distel_tpu_torch.parallel.shard_compat import COLLECTIVES
    from distel_tpu_torch.runtime.classifier import ELClassifier

    COLLECTIVES.reset()
    before = dict(bitmatmul.LAUNCHES)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if clf is None:
        clf = ELClassifier(cfg, device=device)
    res = clf.classify_file(path, verify=verify, resume_from=resume)
    wall = time.perf_counter() - t0
    engine = res.engine
    shards = res.result.shards
    rec = {
        "rank": clf.mesh.rank,
        "device": str(device),
        "backend": clf.mesh.backend,
        "wall_s": wall,
        "phases_ms": res.summary()["phases_ms"],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
        "collectives": COLLECTIVES.snapshot(),
        "windows": (engine.gate_totals() if hasattr(engine, "gate_totals")
                    else None),
        "launches": {k: v - before.get(k, 0)
                     for k, v in bitmatmul.LAUNCHES.items() if v - before.get(k, 0)},
        "product_shapes": _product_shapes(engine),
        "shard_shapes": ([list(t.shape) for t in shards] if shards is not None
                         else None),
        "closure_sha256": res.result.live_digest(),
    }
    out = {"rank": rec, "summary": None, "taxonomy": None, "snapshot": None}
    if clf.mesh.rank == 0:
        out["summary"] = res.summary()
        out["taxonomy"] = res.taxonomy
        if snapshot:
            res.result.packed_s, res.result.packed_r = (
                res.result.packed_s.cpu(), res.result.packed_r.cpu())
            res.result.shards = None
            out["snapshot"] = res.result
    return out


def _product_shapes(engine) -> list:
    """The packed-columns and and-or products ``engine``'s plans launch,
    as ``[m, l, words]`` / ``[m, word rows, columns]`` (on a mesh the
    words are the rank's window)."""
    plans = list(getattr(engine, "_plans", {}).values())
    ref = getattr(engine, "_prog_ref", None)
    prog = ref() if ref is not None else None
    if prog is not None:
        plans += list(prog.step.plans.values())
    return sorted({(p.m, p.l, p.w) if hasattr(p, "w") else (p.m, p.kw, p.n)
                   for p in plans})


def cmd_stream(args) -> int:
    """Incremental streaming: classify a base ontology, then add each
    delta file on top of the running closure (the reference's
    ``traffic-data-load-classify.sh`` loop), then retract each
    ``--retract`` file's text.  With ``mesh.devices = N > 1`` in
    ``--config`` (and no coordinator keys) N local ranks run the same
    stream (``parallel/mesh.launch_local``), as ``classify --mesh``
    does; with the coordinator keys the process is one rank of an
    external group.  Rank 0 prints the lines and writes the snapshots;
    on a mesh the totals line carries ``mesh``, each rank's record."""
    cfg = _load_cfg(args)
    if (cfg.mesh_devices or 0) > 1 and not cfg.coordinator_address:
        from distel_tpu_torch.parallel.mesh import launch_local

        t0 = time.perf_counter()
        ranks = launch_local(cfg.mesh_devices, _stream_rank, cfg, args,
                             device=args.device)
        totals = dict(ranks[0]["totals"])
        totals["mesh"] = {"size": cfg.mesh_devices,
                          "launch_s": time.perf_counter() - t0,
                          "ranks": [r["rank"] for r in ranks]}
        print(json.dumps(totals), flush=True)
        return 0
    out = _stream_rank(args.device, cfg, args)
    if out["rank"] is not None:
        totals = dict(out["totals"])
        if out["rank"]["rank"] == 0:
            totals["mesh"] = {"size": out["rank"]["size"],
                              "ranks": [out["rank"]]}
            print(json.dumps(totals), flush=True)
        else:
            print(json.dumps({"mesh_rank": out["rank"]}), flush=True)
    else:
        print(json.dumps(out["totals"]), flush=True)
    return 0


def _stream_rank(device, cfg, args) -> dict:
    """One stream (every rank of a mesh runs it): the files in order,
    then the retractions.  Rank 0 (or the process off a mesh) prints one
    record a step and writes the snapshots.  On a mesh each rank also
    returns what it saw, ``rank``: per step the path, iterations, wall
    and phases, the gathered closure's digest
    (``SaturationResult.live_digest``) and its taxonomy's; its wall,
    peak card memory, collectives (calls, bytes, seconds) and kernel
    launches.  Returns ``{"totals", "rank"}`` (``rank`` None off a
    mesh)."""
    import torch

    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.ops import bitmatmul
    from distel_tpu_torch.parallel.shard_compat import COLLECTIVES
    from distel_tpu_torch.runtime.checkpoint import Snapshotter
    from distel_tpu_torch.runtime.taxonomy import extract_taxonomy

    COLLECTIVES.reset()
    before = dict(bitmatmul.LAUNCHES)
    t_rank = time.perf_counter()
    inc = IncrementalClassifier(cfg, device=device)
    mesh = inc._mesh
    lead = mesh is None or mesh.rank == 0
    dev = inc.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    snap = (
        Snapshotter(args.snapshot_prefix, args.snapshot_interval)
        if args.snapshot_prefix and lead
        else None
    )
    steps = []
    ops = [(inc.add_text, p) for p in [args.base] + args.deltas]
    ops += [(inc.retract, p) for p in args.retract]
    for fn, path in ops:
        t0 = time.time()
        with open(path, "r", encoding="utf-8") as f:
            fn(f.read())
        rec = dict(inc.history[-1], file=path, wall_s=round(time.time() - t0, 3))
        if lead:
            print(json.dumps(rec), flush=True)
        if snap is not None:
            snap.maybe_snapshot(inc.last_result)
        if mesh is not None:
            steps.append({
                "file": path, "path": rec["path"],
                "iterations": rec["iterations"], "wall_s": rec["wall_s"],
                "phases_s": inc.last_phases,
                "closure_sha256": inc.last_result.live_digest(),
                "taxonomy_sha256": extract_taxonomy(inc.last_result).digest(),
            })
    totals = {
        "increments": inc.increment,
        "total_derivations": sum(h["new_derivations"] for h in inc.history),
    }
    if mesh is None:
        return {"totals": totals, "rank": None}
    rank = {
        "rank": mesh.rank,
        "size": mesh.size,
        "device": str(dev),
        "backend": mesh.backend,
        "wall_s": time.perf_counter() - t_rank,
        "steps": steps,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "collectives": COLLECTIVES.snapshot(),
        "launches": {k: v - before.get(k, 0)
                     for k, v in bitmatmul.LAUNCHES.items()
                     if v - before.get(k, 0)},
    }
    return {"totals": totals, "rank": rank}


def _render_curve(curve, width: int = 48, height: int = 8) -> str:
    """Coarse ASCII completeness curve (derivations_total over rounds)
    straight off a ledger."""
    pts = [
        (c.get("round") or 0, c.get("derivations_total") or 0)
        for c in curve
    ]
    if not pts:
        return "(no rounds)"
    top = max(d for _, d in pts) or 1
    cols = min(width, len(pts))
    # resample onto the column grid (later rounds win within a column)
    grid = [0] * cols
    for i, (_, d) in enumerate(pts):
        grid[i * cols // len(pts)] = d
    lines = []
    for row in range(height, 0, -1):
        cut = top * (row - 0.5) / height
        lines.append(
            "  " + "".join("#" if d >= cut else " " for d in grid)
        )
    lines.append("  " + "-" * cols)
    lines.append(
        f"  rounds 1..{pts[-1][0]}, derivations_total {top}"
    )
    return "\n".join(lines)


def cmd_runs(args) -> int:
    """Run observatory: render chains of runs from their ledgers —
    round counts, completeness curves, per-rule share trends,
    ETA/prediction error — without re-running anything."""
    from distel_tpu_torch.obs import ledger as ledger_mod

    by_chain = {}
    if args.op in ("list", "report"):
        records = []
        for path in args.ledgers:
            records.extend(
                ledger_mod.read_ledger(path, strict=not args.lax)
            )
        by_chain = ledger_mod.chains(records)
    if args.op == "list":
        rows = []
        for cid, recs in by_chain.items():
            try:
                s = ledger_mod.validate_chain(recs)
            except ValueError as e:
                rows.append({"chain_run_id": cid, "invalid": str(e)})
                continue
            rows.append({"chain_run_id": cid, **s})
        print(json.dumps({"chains": rows}, indent=2))
        return 0
    if args.op == "report":
        cid = args.chain
        if cid is None:
            if len(by_chain) != 1:
                print(
                    f"{len(by_chain)} chains in the ledger(s) — pick one "
                    f"with --chain: {sorted(by_chain)}",
                    file=sys.stderr,
                )
                return 2
            cid = next(iter(by_chain))
        if cid not in by_chain:
            print(f"unknown chain {cid!r}", file=sys.stderr)
            return 2
        try:
            rep = ledger_mod.report_chain(by_chain[cid])
        except ValueError as e:
            print(f"invalid chain {cid}: {e}", file=sys.stderr)
            return 2
        if args.json:
            print(json.dumps(rep, indent=2))
            return 0
        print(f"chain {rep['chain_run_id']}")
        print(
            f"  sessions: {rep['runs']} ({rep['closed_runs']} closed"
            + (
                f", session {rep['open_session']} crashed/in-flight)"
                if rep["open_session"]
                else ")"
            )
        )
        print(
            f"  rounds: {rep['rounds']} (last index {rep['last_round']}) "
            f"tiers {rep['tiers']}"
        )
        print(
            f"  derivations_total: {rep['derivations_total']}  "
            f"wall: {rep['wall_s']}s  converged: {rep['converged']}"
        )
        print(
            f"  snapshots: {rep['snapshots']}  anomalies: "
            f"{rep['anomalies']}"
        )
        if rep.get("rule_shares"):
            shares = ", ".join(
                f"{k}={v:.0%}" for k, v in sorted(rep["rule_shares"].items())
            )
            print(f"  rule shares: {shares}")
        if rep.get("launch_prediction"):
            lp = rep["launch_prediction"]
            print(
                f"  launch prediction: {lp['predicted_wall_s']}s vs "
                f"actual {lp['actual_wall_s']}s "
                f"(error {lp['error']:+.0%})"
            )
        if rep.get("eta_final"):
            ef = rep["eta_final"]
            print(
                f"  final ETA: predicted tail {ef['predicted_tail_s']}s "
                f"vs actual {ef['actual_tail_s']}s "
                f"(error {ef['error_s']:+}s)"
            )
        print(_render_curve(rep["curve"]))
        return 0
    # watch: poll the ledger file and echo new records as they land
    if len(args.ledgers) != 1:
        print("watch follows exactly one ledger file", file=sys.stderr)
        return 2
    path = args.ledgers[0]
    # byte-offset tail, not a full re-read per poll
    offset = 0
    buf = ""
    ticks = 0
    while True:
        if os.path.exists(path):
            size = os.path.getsize(path)
            if size < offset:  # truncated/replaced: start over
                offset = 0
                buf = ""
            if size > offset:
                with open(path, "r", encoding="utf-8") as f:
                    f.seek(offset)
                    buf += f.read()
                    offset = f.tell()
                # the trailing fragment (no newline yet) waits for the
                # writer's flush; complete lines print immediately
                *complete, buf = buf.split("\n")
                for line in complete:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    print(json.dumps(rec), flush=True)
        ticks += 1
        if args.iterations is not None and ticks >= args.iterations:
            return 0
        time.sleep(args.interval)


def cmd_diff(args) -> int:
    from distel_tpu_torch.frontend.normalizer import normalize
    from distel_tpu_torch.owl import loader
    from distel_tpu_torch.runtime.classifier import resolve_device
    from distel_tpu_torch.testing.differential import classify_and_diff

    device = resolve_device(args.device)
    with open(args.ontology, "r", encoding="utf-8-sig") as f:
        norm = normalize(loader.load(f.read()))
    _, report = classify_and_diff(norm, device=device)
    print(report.summary())
    return 0 if report.ok() else 1


def cmd_partition(args) -> int:
    """Partitioned classification: discover interaction components,
    batch isomorphic ones through one planned fixed point
    (``core/components.py`` — the weak-scaling path for
    OntologyMultiplier-style corpora).  OFN corpora partition at TEXT
    level before any index exists (the monolithic index is
    role-quadratic and impossible at multiplied-corpus scale); other
    formats, and corpora with global-conclusion axioms, partition at
    index level or fall back to monolithic classification — always
    sound.  Runs on ``--device`` (the first card by default)."""
    from distel_tpu_torch.core.components import (
        partition_index,
        saturate_components,
        saturate_isomorphic,
    )
    from distel_tpu_torch.owl import loader as owl_loader
    from distel_tpu_torch.runtime.classifier import resolve_device

    # the mesh keys are not threaded here, as in the reference: a batched
    # group is one program over its copies, single-device by design
    cfg = _load_cfg(args)
    device = resolve_device(args.device)

    def ingest(text):
        """The config's load plane, as the classifier picks it: the
        native C++ plane for OFN when enabled, else the Python
        frontend."""
        if cfg.use_native_loader and owl_loader.detect_format(text) == "ofn":
            from distel_tpu_torch.owl import native_loader

            return native_loader.load_indexed(text)
        from distel_tpu_torch.core.indexing import index_ontology
        from distel_tpu_torch.frontend.normalizer import normalize

        return index_ontology(normalize(owl_loader.load(text)))

    # the reference threads matmul.dtype into its engines; the port's
    # bit kernels are exact and have no such knob
    max_iters = cfg.max_iterations

    # utf-8-sig: a BOM would otherwise glue onto the first functor and
    # silently defeat the text-level splitter (loader.load_file parity)
    with open(args.ontology, "r", encoding="utf-8-sig") as f:
        text = f.read()
    out = {"file": args.ontology}
    t0 = time.time()
    if owl_loader.detect_format(text) == "ofn":
        from distel_tpu_torch.frontend.partition_text import partition_ofn_text

        parts = partition_ofn_text(text)
        out["text_fallback"] = parts.fallback
        if not parts.fallback:
            out["level"] = "text"
            out["n_components"] = sum(c for _, c in parts.groups)
            out["n_groups"] = len(parts.groups)
            derivs = 0
            iters = 0
            for rep, count in parts.groups:
                g = saturate_isomorphic(
                    ingest(rep), count, max_iters=max_iters, device=device,
                )
                derivs += g["derivations"]
                iters = max(iters, g["iterations"])
            out.update(derivations=derivs, iterations_max=iters)
            out["wall_s"] = round(time.time() - t0, 3)
            print(json.dumps(out, indent=2))
            return 0
    # index-level partition (non-OFN formats, or text-level fallback)
    comps = partition_index(ingest(text))
    agg = saturate_components(comps, max_iters=max_iters, device=device)
    out["level"] = "index"
    out.update(
        n_components=agg["n_components"],
        n_groups=agg["n_groups"],
        derivations=agg["derivations"],
        iterations_max=agg["iterations_max"],
        wall_s=round(time.time() - t0, 3),
    )
    print(json.dumps(out, indent=2))
    return 0


def cmd_normalize(args) -> int:
    from distel_tpu_torch.frontend.normalizer import normalize
    from distel_tpu_torch.owl import loader as parser_compat

    norm = normalize(parser_compat.load_file(args.ontology))
    out = sys.stdout if not args.output else open(args.output, "w")
    try:
        for a, b in norm.nf1:
            out.write(f"NF1 {a!r} ⊑ {b!r}\n")
        for ops, b in norm.nf2:
            out.write(f"NF2 {' ⊓ '.join(map(repr, ops))} ⊑ {b!r}\n")
        for a, r, b in norm.nf3:
            out.write(f"NF3 {a!r} ⊑ ∃{r.iri}.{b!r}\n")
        for r, a, b in norm.nf4:
            out.write(f"NF4 ∃{r.iri}.{a!r} ⊑ {b!r}\n")
        for r, s in norm.nf5:
            out.write(f"NF5 {r.iri} ⊑ {s.iri}\n")
        for r, s, t in norm.nf6:
            out.write(f"NF6 {r.iri} ∘ {s.iri} ⊑ {t.iri}\n")
    finally:
        if args.output:
            out.close()
    print(
        f"# normalized: {norm.axiom_count()} axioms, "
        f"{len(norm.gensyms)} gensyms, removed: {dict(norm.removed)}",
        file=sys.stderr,
    )
    return 0


def cmd_stats(args) -> int:
    from distel_tpu_torch.runtime.stats import ontology_stats

    print(json.dumps(ontology_stats(args.ontology), indent=2))
    return 0


def cmd_check(args) -> int:
    from distel_tpu_torch.frontend.profile_checker import check_profile
    from distel_tpu_torch.owl import loader as parser_compat

    kept, removed = check_profile(parser_compat.load_file(args.ontology))
    print(json.dumps({"in_profile": kept, "removed": dict(removed)}, indent=2))
    return 0 if not removed else 1


def cmd_multiply(args) -> int:
    from distel_tpu_torch.frontend.ontology_tools import multiply_ontology
    from distel_tpu_torch.owl import loader as parser_compat
    from distel_tpu_torch.owl.writer import write_file

    onto = parser_compat.load_file(args.ontology)
    out = multiply_ontology(onto, args.n, crossed=args.crossed)
    write_file(out, args.output)
    print(f"{len(out)} axioms written to {args.output}")
    return 0


def cmd_warmup(args) -> int:
    """Warmup: resolve each sample corpus to its bucket and build that
    bucket's programs into this process's registry (on a card, capture
    their CUDA graphs).  Prints one JSON record per corpus (bucket
    signature, build walls, registry hit, the artifact farm's share) and
    a summary line.  Nothing persists past the process: ``farm-build``
    bakes programs for other processes, ``serve --warmup`` is the warm
    path of one."""
    from distel_tpu_torch.runtime.classifier import resolve_device
    from distel_tpu_torch.runtime.warmup import warmup_paths

    cfg = _load_cfg(args)
    # consume a farm during warmup: the programs it covers come from
    # their specs instead of the corpora's tables
    _install_farm(cfg, args, resolve_device(args.device))
    t0 = time.time()
    recs = warmup_paths(
        args.ontologies,
        cfg,
        profile=args.profile,
        max_iters=args.max_iters,
        parallel=not args.serial,
        device=args.device,
    )
    for rec in recs:
        print(json.dumps(rec), flush=True)
    print(
        json.dumps(
            {
                "warmed_buckets": len({r["bucket_signature"] for r in recs}),
                "corpora": len(recs),
                "wall_s": round(time.time() - t0, 2),
                "serial_compile_s": round(
                    sum(r["compile_s"] + r["trace_lower_s"] for r in recs), 2
                ),
                "delta_programs": sum(r.get("delta_programs", 0) for r in recs),
                "delta_compile_s": round(
                    sum(r.get("delta_compile_s", 0) for r in recs), 2
                ),
                # the artifact farm's share of the roster
                "artifact_exe_hits": sum(
                    r.get("artifact_exe_hits", 0) for r in recs
                ),
                "artifact_hlo_hits": sum(
                    r.get("artifact_hlo_hits", 0) for r in recs
                ),
            }
        ),
        flush=True,
    )
    return 0


def cmd_farm_build(args) -> int:
    """Artifact farm bake: build the bucket-program roster of each
    sample corpus (and, with ``--delta``, of a representative increment
    replayed on it) with the farm as the registry's sink, so every step
    program's spec lands in the farm and every fused window's key is
    recorded; on a card, ship the kernel libraries too.  Point serving
    processes at the output with ``--artifacts-dir`` (or drop it at
    ``<spill_dir>/artifacts`` and the fleet supervisor hands it to every
    replica).  Idempotent: a re-bake installs the farm first, so its
    programs come off their specs, and writes nothing (``written ==
    0``)."""
    from dataclasses import replace

    from distel_tpu_torch.config import enable_compile_cache
    from distel_tpu_torch.core import artifacts
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.ops import build
    from distel_tpu_torch.runtime.classifier import resolve_device
    from distel_tpu_torch.runtime.warmup import warmup_paths

    cfg = _load_cfg(args)
    enable_compile_cache(cfg.compile_cache_dir)
    device = resolve_device(args.device)
    out = os.path.abspath(args.out)
    try:
        store = artifacts.ArtifactStore(out, writable=True, device=device)
        mismatch = store.env_mismatch(device)
    except artifacts.ArtifactError as e:
        mismatch = str(e)
    if mismatch is not None:
        # extending someone else's farm would mix environments in one
        # manifest — bake a fresh directory instead
        print(f"refusing farm-build: {mismatch}", file=sys.stderr)
        return 3
    t0 = time.time()
    store.install_libraries()
    if device.type == "cuda":
        build.build_all(build.sources())
    store.build_programs(device)
    # source AND sink: the farm's own programs are handed over (nothing
    # rebuilds, nothing rewrites); fresh keys build once and land
    # through the sink
    PROGRAMS.artifact_source = store
    PROGRAMS.artifact_sink = store
    try:
        recs = warmup_paths(
            args.ontologies,
            cfg,
            profile=args.profile,
            max_iters=args.max_iters,
            parallel=not args.serial,
            device=device,
        )
        if args.delta:
            # replay a representative increment per corpus with the
            # sink attached: the delta plane's programs for this
            # delta's rungs land too, so a consumer's first delta
            # builds nothing.  fast_path_min_concepts=0 forces the
            # delta plane whatever the corpus size
            with open(args.delta, encoding="utf-8") as f:
                delta_text = f.read()
            rcfg = replace(cfg, fast_path_min_concepts=0)
            for path in args.ontologies:
                with open(path, encoding="utf-8") as f:
                    corpus = f.read()
                td = time.time()
                inc = IncrementalClassifier(rcfg, device=device)
                inc.add_text(corpus)
                inc.add_text(delta_text)
                recs.append({
                    "profile": "delta-replay",
                    "file": path,
                    "delta": args.delta,
                    "path": inc.history[-1].get("path"),
                    "compile_s": inc.history[-1].get("compile_s"),
                    "wall_s": round(time.time() - td, 3),
                })
                del inc
    finally:
        PROGRAMS.artifact_sink = None
        PROGRAMS.artifact_source = None
        store.drop_held(device.type)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    adopted = store.adopt_libraries() if device.type == "cuda" else 0
    wrote_manifest = store.flush()
    print(
        json.dumps(
            {
                "farm": out,
                "manifest": os.path.join(out, artifacts.MANIFEST_NAME),
                "manifest_written": wrote_manifest,
                "libraries_adopted": adopted,
                "corpora": len(recs),
                "wall_s": round(time.time() - t0, 2),
                **store.stats(),
            }
        ),
        flush=True,
    )
    return 0


def cmd_serve(args) -> int:
    """Resident classification service: one incremental classifier per
    loaded ontology, its closure resident on the card, behind a
    bounded-queue scheduler; see ``distel_tpu_torch/serve/``."""
    from distel_tpu_torch.config import enable_compile_cache
    from distel_tpu_torch.serve.server import ServeApp, serve_forever

    cfg = _load_cfg(args)
    enable_compile_cache(cfg.compile_cache_dir)
    if args.artifacts_dir:
        cfg.artifacts_dir = args.artifacts_dir
    if args.artifacts_require:
        cfg.artifacts_require = True
    budget = (
        int(args.memory_budget_mb * (1 << 20))
        if args.memory_budget_mb is not None
        else None
    )
    warm_budget = (
        int(args.warm_budget_mb * (1 << 20))
        if args.warm_budget_mb is not None
        else None
    )
    kw = dict(
        device=args.device,
        workers=args.workers,
        max_queue=args.max_queue,
        max_batch=args.max_batch,
        deadline_s=args.deadline_s,
        memory_budget_bytes=budget,
        warm_budget_bytes=warm_budget,
        spill_dir=args.spill_dir,
        fast_path_min_concepts=args.fast_path_min_concepts,
        warmup_paths=args.warmup or None,
    )
    if args.replica_id:
        # fleet worker: the same app plus the /fleet admin plane the
        # router drives (load-with-id, migrate-out, adopt)
        from distel_tpu_torch.serve.fleet.replica import ReplicaApp

        if not args.spill_dir:
            print(
                "--replica-id needs --spill-dir (the migration handoff "
                "spills through it)",
                file=sys.stderr,
            )
            return 2
        app = ReplicaApp(cfg, replica_id=args.replica_id, **kw)
    else:
        app = ServeApp(cfg, **kw)
    spilled = serve_forever(app, args.host, args.port)
    print(
        json.dumps({"shutdown": "graceful", "spilled": spilled}),
        flush=True,
    )
    return 0


def cmd_fleet(args) -> int:
    """Serve fleet: N shared-nothing replica processes (supervised)
    behind the affinity/migration router — the horizontal scale-out of
    ``serve`` (see ``distel_tpu_torch/serve/fleet/``).  Every replica
    runs on the device ``--device`` names (the first card by default)."""
    import os
    import signal as _signal
    import threading

    from distel_tpu_torch.serve.fleet.router import RouterApp
    from distel_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor
    from distel_tpu_torch.serve.server import make_server

    cfg = _load_cfg(args)
    n = args.replicas if args.replicas is not None else cfg.fleet_replicas
    extra = []
    for flag, val in (
        ("--config", args.config),
        ("--device", args.device),
        ("--workers", args.workers),
        ("--max-queue", args.max_queue),
        ("--max-batch", args.max_batch),
        ("--deadline-s", args.deadline_s),
        ("--memory-budget-mb", args.memory_budget_mb),
        ("--warm-budget-mb", args.warm_budget_mb),
        ("--fast-path-min-concepts", args.fast_path_min_concepts),
        ("--artifacts-dir", args.artifacts_dir),
    ):
        if val is not None:
            extra += [flag, str(val)]
    if args.artifacts_require:
        extra += ["--artifacts-require"]
        if args.artifacts_dir:
            # every replica would refuse to start: refuse before any does
            from distel_tpu_torch.core.artifacts import ArtifactStore

            ArtifactStore(args.artifacts_dir)
    if args.warmup:
        extra += ["--warmup", *args.warmup]
    sup = ReplicaSupervisor(n, spill_dir=args.spill_dir, extra_args=extra)
    router = None
    try:
        replicas = sup.start()
        router = RouterApp(
            replicas,
            supervisor=sup,
            depth_divergence=(
                args.depth_divergence
                if args.depth_divergence is not None
                else cfg.fleet_depth_divergence
            ),
            heartbeat_interval_s=cfg.fleet_heartbeat_interval_s,
            eject_failures=cfg.fleet_eject_failures,
            rebalance_interval_s=cfg.fleet_rebalance_interval_s,
            config=cfg,
        )
        router.start()
        server = make_server(router, args.host, args.port)
    except Exception as e:
        # a failed replica start, router bind (port taken) or
        # construction must not orphan the live replica subprocesses
        if router is not None:
            router.close()
        sup.stop(graceful=False)
        print(f"fleet startup failed: {e}", file=sys.stderr)
        return 1
    bound = server.server_address[1]
    print(
        json.dumps(
            {
                "serving": True,
                "role": "fleet-router",
                "host": args.host,
                "port": bound,
                "replicas": [
                    {"id": rid, "url": url} for rid, url in replicas
                ],
                "spill_dir": args.spill_dir,
            }
        ),
        flush=True,
    )

    def _drain(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    prev_term = _signal.signal(_signal.SIGTERM, _drain)
    prev_int = _signal.signal(_signal.SIGINT, _drain)
    try:
        server.serve_forever()
    finally:
        _signal.signal(_signal.SIGTERM, prev_term)
        _signal.signal(_signal.SIGINT, prev_int)
        server.server_close()
        router.close()
        sup.stop(graceful=True)
    # the flight recorder is the fleet's black box: dump it next to the
    # spills on the way out and surface the tail in the shutdown record
    flight_path = os.path.join(args.spill_dir, "flight_router.jsonl")
    try:
        dumped = router.flight.dump(flight_path)
    except OSError:
        flight_path, dumped = None, 0
    print(
        json.dumps(
            {
                "shutdown": "graceful",
                "replicas": n,
                "flight_events": dumped,
                "flight_dump": flight_path,
                "recent_events": router.flight.events(limit=5),
            }
        ),
        flush=True,
    )
    return 0


def cmd_trace(args) -> int:
    """Fetch a recorded request trace from a serve process's
    ``/debug/trace`` endpoint.  ``--format chrome`` writes Chrome
    trace-event JSON (Perfetto or chrome://tracing load it)."""
    from urllib.parse import quote
    from urllib.request import urlopen

    base = args.url.rstrip("/")
    qs = []
    if args.trace_id:
        qs.append(f"trace_id={quote(args.trace_id)}")
    if args.format == "chrome":
        qs.append("format=chrome")
    if args.limit is not None:
        qs.append(f"limit={args.limit}")
    if args.no_stitch:
        qs.append("stitch=0")
    url = base + "/debug/trace" + ("?" + "&".join(qs) if qs else "")
    with urlopen(url, timeout=args.timeout) as resp:
        payload = resp.read()
    if args.output:
        with open(args.output, "wb") as f:
            f.write(payload)
        doc = json.loads(payload)
        n = len(doc.get("traceEvents", doc.get("spans", [])))
        print(json.dumps({"written": args.output, "format": args.format,
                          "records": n}))
    else:
        sys.stdout.write(payload.decode("utf-8"))
    return 0


def cmd_query(args) -> int:
    """Snapshot-plane reads against a serve process: subsumption tests,
    subsumer sets and taxonomy slices off the lock-free versioned read
    snapshots.  Every answer carries the snapshot version it came
    from."""
    from distel_tpu_torch.serve.client import ServeClient

    c = ServeClient(args.url, timeout=args.timeout)
    if args.min_version:
        c._versions[args.oid] = args.min_version
    try:
        if args.op == "subsumed":
            if len(args.names) != 2:
                print("subsumed needs SUB SUP", file=sys.stderr)
                return 2
            doc = c.is_subsumed(args.oid, args.names[0], args.names[1])
        elif args.op == "subsumers":
            if len(args.names) != 1:
                print("subsumers needs CLASS", file=sys.stderr)
                return 2
            doc = c.query_subsumers(args.oid, args.names[0])
        elif args.op == "slice":
            if len(args.names) != 1:
                print("slice needs CLASS", file=sys.stderr)
                return 2
            doc = c.taxonomy_slice(args.oid, args.names[0])
        else:  # version
            doc = c.snapshot_version(args.oid)
    except Exception as e:  # noqa: BLE001 — ops surface, fail readable
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
              file=sys.stderr)
        return 1
    print(json.dumps(doc, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="distel_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("classify", help="classify an ontology")
    c.add_argument("ontology")
    c.add_argument("--config", help="properties/config file")
    c.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    c.add_argument("--output", "-o", help="write taxonomy here")
    c.add_argument(
        "--snapshot",
        help="write an S/R snapshot (.npz): v2 from the row-packed engine, "
             "v1 from the packed engine",
    )
    c.add_argument(
        "--resume",
        help="warm-start from a v1 or v2 snapshot (.npz), realigned by name; "
             "its corpus must be a SUBSET of this one",
    )
    c.add_argument("--instrument", action="store_true", help="phase timers")
    c.add_argument("--verify", action="store_true", help="diff vs CPU oracle")
    c.add_argument("--budget-s", type=float, default=None,
                   help="stage budget: predict the wall from the fitted "
                        "cost model (obs/costmodel.py) at launch and "
                        "refuse the run (exit 3) when the prediction "
                        "exceeds this many seconds")
    c.add_argument("--force", action="store_true",
                   help="launch past a failed --budget-s guard")
    c.add_argument("--model-from", nargs="*", default=None, metavar="FILE",
                   help="ledger/probe files the cost model fits from "
                        "(default: the repo's runs/*.ledger.jsonl)")
    c.add_argument("--artifacts-dir", default=None,
                   help="install a farm-build output: covered bucket "
                        "programs come from their specs, the kernels from "
                        "its libraries, and the --budget-s guard drops its "
                        "compile term")
    c.add_argument("--mesh", type=int, default=None,
                   help="shard the fixed point over this many local ranks "
                        "(the cards, gloo ranks sharing one when there are "
                        "fewer; all on the CPU with --device cpu); rank 0 "
                        "prints and writes")
    c.set_defaults(fn=cmd_classify)
    st = sub.add_parser("stream", help="incremental streaming classification")
    st.add_argument("base")
    st.add_argument("deltas", nargs="*")
    st.add_argument("--config", help="properties/config file")
    st.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    st.add_argument(
        "--snapshot-prefix", help="timed state snapshots (ResultSnapshotter)"
    )
    st.add_argument("--snapshot-interval", type=float, default=120.0)
    st.add_argument(
        "--retract", action="append", default=[], metavar="FILE",
        help="after the files, retract this earlier file's text (DRed "
             "delete-and-rederive; repeatable, in order)",
    )
    st.set_defaults(fn=cmd_stream)
    d = sub.add_parser("diff", help="verify against the CPU oracle")
    d.add_argument("ontology")
    d.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    d.set_defaults(fn=cmd_diff)
    n = sub.add_parser("normalize", help="dump NF1-NF6 normal forms")
    n.add_argument("ontology")
    n.add_argument("--output", "-o")
    n.set_defaults(fn=cmd_normalize)
    s = sub.add_parser("stats", help="axiom-shape census")
    s.add_argument("ontology")
    s.set_defaults(fn=cmd_stats)
    k = sub.add_parser("check", help="EL profile check")
    k.add_argument("ontology")
    k.set_defaults(fn=cmd_check)
    m = sub.add_parser("multiply", help="synthetic n-copy scaling")
    m.add_argument("ontology")
    m.add_argument("n", type=int)
    m.add_argument("--output", "-o", required=True)
    m.add_argument("--crossed", action="store_true")
    m.set_defaults(fn=cmd_multiply)
    pt = sub.add_parser(
        "partition",
        help="component-partitioned classification (weak-scaling path)",
    )
    pt.add_argument("ontology")
    pt.add_argument("--config", help="properties/config file")
    pt.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    pt.set_defaults(fn=cmd_partition)
    sv = sub.add_parser("serve", help="resident classification service (HTTP)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port (printed at startup)")
    sv.add_argument("--config", help="properties/config file")
    sv.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    sv.add_argument("--workers", type=int, default=2,
                    help="scheduler workers (cross-ontology concurrency)")
    sv.add_argument("--max-queue", type=int, default=64,
                    help="bounded admission queue; overflow answers 429")
    sv.add_argument("--max-batch", type=int, default=8,
                    help="max queued deltas coalesced into one increment")
    sv.add_argument("--deadline-s", type=float, default=300.0,
                    help="default per-request deadline (503 past it)")
    sv.add_argument("--memory-budget-mb", type=float, default=None,
                    help="resident-closure budget; the quietest ontologies "
                         "demote past it (warm tier or --spill-dir)")
    sv.add_argument("--warm-budget-mb", type=float, default=None,
                    help="host-RAM warm-tier budget: hot evictions demote "
                         "to packed host state (no frontend replay) before "
                         "overflowing to compressed disk (default: config "
                         "storage.warm.budget.mb, 0 = warm tier off)")
    sv.add_argument("--spill-dir", default=None,
                    help="snapshot directory for eviction + graceful "
                         "shutdown (required with --memory-budget-mb)")
    sv.add_argument("--fast-path-min-concepts", type=int, default=None,
                    help="override the delta fast path's base-size "
                         "cutoff (0 forces it everywhere)")
    sv.add_argument("--replica-id", default=None,
                    help="run as a fleet replica with this id: adds "
                         "the /fleet admin plane (load-with-id, "
                         "migrate-out, adopt) the router drives; "
                         "requires --spill-dir")
    sv.add_argument("--warmup", nargs="*", default=None, metavar="ONTOLOGY",
                    help="sample corpora whose bucket programs a "
                         "background thread builds before traffic")
    sv.add_argument("--artifacts-dir", default=None,
                    help="install a farm-build output before binding: the "
                         "kernel libraries (no nvcc) and every program "
                         "spec, built before traffic, so a covered load "
                         "or delta has compile_s == 0 on first request")
    sv.add_argument("--artifacts-require", action="store_true",
                    help="refuse to start when the artifact farm cannot "
                         "be installed whole (default: warn and build)")
    sv.set_defaults(fn=cmd_serve)
    fl = sub.add_parser(
        "fleet",
        help="serve fleet: router + N supervised shared-nothing "
             "replica processes (affinity placement, live migration, "
             "queue-depth rebalance)",
    )
    fl.add_argument("--host", default="127.0.0.1")
    fl.add_argument("--port", type=int, default=8080,
                    help="router port; 0 binds ephemerally (printed "
                         "at startup)")
    fl.add_argument("--replicas", type=int, default=None,
                    help="replica process count (default: config "
                         "fleet.replicas, 2)")
    fl.add_argument("--spill-dir", required=True,
                    help="shared snapshot directory — the migration "
                         "handoff and graceful shutdown spill through "
                         "it; every replica mounts the same path")
    fl.add_argument("--depth-divergence", type=int, default=None,
                    help="queue-depth gap (hot − cool) that triggers a "
                         "rebalance migration (default: config, 8)")
    fl.add_argument("--config", help="properties/config file "
                                     "(fleet.* knobs + replica config)")
    fl.add_argument(
        "--device", default=None,
        help="torch device of every replica (default: the first CUDA "
             "device; a replica raises if there is none)",
    )
    fl.add_argument("--workers", type=int, default=None,
                    help="scheduler workers per replica")
    fl.add_argument("--max-queue", type=int, default=None,
                    help="per-replica admission queue bound")
    fl.add_argument("--max-batch", type=int, default=None,
                    help="per-replica delta batch bound")
    fl.add_argument("--deadline-s", type=float, default=None,
                    help="per-replica default request deadline")
    fl.add_argument("--memory-budget-mb", type=float, default=None,
                    help="per-replica resident-closure budget")
    fl.add_argument("--warm-budget-mb", type=float, default=None,
                    help="per-replica host-RAM warm-tier budget")
    fl.add_argument("--fast-path-min-concepts", type=int, default=None,
                    help="per-replica delta fast-path cutoff override")
    fl.add_argument("--warmup", nargs="*", default=None, metavar="ONTOLOGY",
                    help="passed to every replica: sample corpora whose "
                         "bucket programs each builds before traffic")
    fl.add_argument("--artifacts-dir", default=None,
                    help="farm directory every replica installs "
                         "(default: <spill_dir>/artifacts when its "
                         "manifest exists)")
    fl.add_argument("--artifacts-require", action="store_true",
                    help="replicas refuse to start without a usable "
                         "artifact farm")
    fl.set_defaults(fn=cmd_fleet)
    w = sub.add_parser(
        "warmup",
        help="build bucket programs from sample corpora (in-process "
             "registry; on a card, captured CUDA graphs)",
    )
    w.add_argument("ontologies", nargs="+",
                   help="one sample corpus per bucket to warm")
    w.add_argument("--config", help="properties/config file")
    w.add_argument("--profile", choices=("serve", "classify"),
                   default="serve",
                   help="which construction's programs to warm: the "
                        "incremental/serve rebuild (default) or the "
                        "one-shot classify engine")
    w.add_argument("--max-iters", type=int, default=None,
                   help="fixed-point budget (default: config)")
    w.add_argument("--serial", action="store_true",
                   help="warm buckets one at a time")
    w.add_argument("--device", default=None,
                   help="torch device (default: the first CUDA device)")
    w.add_argument("--artifacts-dir", default=None,
                   help="install a farm-build output while warming: "
                        "covered programs come from their specs")
    w.add_argument("--artifacts-require", action="store_true",
                   help="refuse to warm when the artifact farm cannot be "
                        "installed whole")
    w.set_defaults(fn=cmd_warmup)
    fb = sub.add_parser(
        "farm-build",
        help="artifact farm: bake the kernel libraries and the bucket "
             "programs' specs of sample corpora into a directory that "
             "fresh processes install with --artifacts-dir",
    )
    fb.add_argument("ontologies", nargs="+",
                    help="one sample corpus per bucket to bake")
    fb.add_argument("--out", required=True,
                    help="farm output directory (manifest.json + exe/ + "
                         "kernels/); ship it to <spill_dir>/artifacts for "
                         "the fleet's replicas")
    fb.add_argument("--config", help="properties/config file")
    fb.add_argument("--profile", choices=("serve", "classify"),
                    default="serve",
                    help="which construction's programs to bake "
                         "(default: the serve/incremental roster)")
    fb.add_argument("--max-iters", type=int, default=None,
                    help="fixed-point budget (default: config)")
    fb.add_argument("--delta", metavar="FILE", default=None,
                    help="representative increment replayed on each "
                         "corpus during the bake: its delta-plane "
                         "programs land in the farm too, so a consumer's "
                         "first delta builds nothing")
    fb.add_argument("--serial", action="store_true",
                    help="bake buckets one at a time")
    fb.add_argument("--device", default=None,
                    help="torch device the bake builds on (default: the "
                         "first CUDA device); consumers must match it")
    fb.set_defaults(fn=cmd_farm_build)
    tr = sub.add_parser(
        "trace", help="fetch a request trace from a serve /debug/trace endpoint"
    )
    tr.add_argument("trace_id", nargs="?", default=None,
                    help="trace id (32 hex chars; ServeClient keeps the "
                         "last one on .last_trace_id); omitted: every "
                         "buffered span")
    tr.add_argument("--url", default="http://127.0.0.1:8080",
                    help="serve base url")
    tr.add_argument("--format", choices=("json", "chrome"), default="json",
                    help="chrome: Perfetto-loadable trace-event JSON")
    tr.add_argument("--output", "-o", default=None,
                    help="write the payload here instead of stdout")
    tr.add_argument("--limit", type=int, default=None,
                    help="newest N spans only")
    tr.add_argument("--no-stitch", action="store_true",
                    help="router only: skip fetching replica spans")
    tr.add_argument("--timeout", type=float, default=30.0)
    tr.set_defaults(fn=cmd_trace)
    qr = sub.add_parser(
        "query",
        help="snapshot-plane reads against a serve process "
             "(subsumed / subsumers / slice / version)",
    )
    qr.add_argument("oid", help="ontology id")
    qr.add_argument("op", choices=("subsumed", "subsumers", "slice", "version"))
    qr.add_argument("names", nargs="*",
                    help="subsumed: SUB SUP; subsumers/slice: CLASS")
    qr.add_argument("--url", default="http://127.0.0.1:8080",
                    help="serve base url")
    qr.add_argument("--min-version", type=int, default=None,
                    help="read-your-writes watermark: refuse answers from "
                         "snapshots older than this version")
    qr.add_argument("--timeout", type=float, default=30.0)
    qr.set_defaults(fn=cmd_query)
    rn = sub.add_parser(
        "runs",
        help="run observatory: chains, reports, and live tailing of "
             "run ledgers (obs/ledger.py JSONL)",
    )
    rn.add_argument("op", choices=("list", "report", "watch"))
    rn.add_argument("ledgers", nargs="+", metavar="LEDGER",
                    help="ledger JSONL file(s)")
    rn.add_argument("--chain", default=None,
                    help="report: chain_run_id to report (needed when "
                         "the ledgers hold more than one chain)")
    rn.add_argument("--json", action="store_true",
                    help="report: machine-readable JSON instead of "
                         "the text rendering")
    rn.add_argument("--lax", action="store_true",
                    help="tolerate malformed mid-file lines instead "
                         "of failing the strict parse")
    rn.add_argument("--interval", type=float, default=2.0,
                    help="watch: poll period in seconds")
    rn.add_argument("--iterations", type=int, default=None,
                    help="watch: stop after N polls (default: forever)")
    rn.set_defaults(fn=cmd_runs)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
