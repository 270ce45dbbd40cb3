"""Command-line interface of the port.

  classify   load → saturate → taxonomy on a CUDA device (the engine
             from --config: ``engine = rowpacked``, ``packed`` or
             ``dense``; ``backend.CRn = host`` routes a rule to the
             host); ``--verify`` diffs the closure against the CPU
             oracle
  stream     classify a base ontology, then add each delta file on top
             of the running closure (``core/incremental.py``): one JSON
             record per file, then the totals
  diff       the dense engine's closure against the CPU oracle; exit 1
             on a difference
  normalize  dump the NF1-NF6 normal forms
  stats      axiom-shape census (JSON)
  check      EL profile check (JSON); exit 1 when axioms are removed
  multiply   n renamed copies of an ontology (``--crossed`` links
             neighbouring copies), written as OFN
  serve      the resident classification service (``serve/``): HTTP
             on ``--host``/``--port``, one incremental classifier per
             loaded ontology on the card, graceful SIGTERM with a final
             spill
  query      snapshot-plane reads against a serve process
  trace      fetch a recorded request trace from ``/debug/trace``

Every command reads OWL functional syntax, RDF/XML or OWL/XML.

Usage: python -m distel_tpu_torch.cli classify FILE [--device cpu] ...
       python -m distel_tpu_torch.cli stream BASE [DELTA ...] [--device cpu]
       python -m distel_tpu_torch.cli diff FILE [--device cpu]
       python -m distel_tpu_torch.cli multiply FILE N -o OUT [--crossed]
       python -m distel_tpu_torch.cli serve [--port 8080] [--device cpu] ...
       python -m distel_tpu_torch.cli query OID subsumers CLASS [--url URL]
       python -m distel_tpu_torch.cli trace [TRACE_ID] [--format chrome]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_cfg(args):
    from distel_tpu_torch.config import ClassifierConfig

    return (
        ClassifierConfig.from_properties(args.config)
        if args.config
        else ClassifierConfig()
    )


def cmd_classify(args) -> int:
    from distel_tpu_torch.runtime.classifier import ELClassifier

    cfg = _load_cfg(args)
    cfg.instrumentation = args.instrument
    clf = ELClassifier(cfg, device=args.device)
    res = clf.classify_file(
        args.ontology, verify=args.verify, resume_from=args.resume
    )
    print(json.dumps(res.summary(), indent=2))
    if args.output:
        res.taxonomy.write(args.output)
        print(f"taxonomy written to {args.output}")
    if args.snapshot:
        from distel_tpu_torch.runtime.checkpoint import save_snapshot

        save_snapshot(args.snapshot, res.result)
        print(f"snapshot written to {args.snapshot}")
    return 0


def cmd_stream(args) -> int:
    """Incremental streaming: classify a base ontology, then add each
    delta file on top of the running closure (the reference's
    ``traffic-data-load-classify.sh`` loop)."""
    from distel_tpu_torch.core.incremental import IncrementalClassifier
    from distel_tpu_torch.runtime.checkpoint import Snapshotter

    inc = IncrementalClassifier(_load_cfg(args), device=args.device)
    snap = (
        Snapshotter(args.snapshot_prefix, args.snapshot_interval)
        if args.snapshot_prefix
        else None
    )
    for path in [args.base] + args.deltas:
        t0 = time.time()
        with open(path, "r", encoding="utf-8") as f:
            inc.add_text(f.read())
        rec = dict(inc.history[-1], file=path, wall_s=round(time.time() - t0, 3))
        print(json.dumps(rec), flush=True)
        if snap is not None:
            snap.maybe_snapshot(inc.last_result)
    print(
        json.dumps(
            {
                "increments": inc.increment,
                "total_derivations": sum(
                    h["new_derivations"] for h in inc.history
                ),
            }
        )
    )
    return 0


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


#: the reference's serve flags whose modules the port does not have
#: yet: flag -> (argument, the reference module it waits for)
REFUSED_SERVE_FLAGS = {
    "--replica-id": ("replica_id", "serve/fleet/replica.py"),
    "--artifacts-dir": ("artifacts_dir", "core/artifacts.py"),
    "--artifacts-require": ("artifacts_require", "core/artifacts.py"),
    "--warmup": ("warmup", "runtime/warmup.py"),
}


def cmd_serve(args) -> int:
    """Resident classification service: one incremental classifier per
    loaded ontology, its closure resident on the card, behind a
    bounded-queue scheduler; see ``distel_tpu_torch/serve/``."""
    from distel_tpu_torch.serve.server import ServeApp, serve_forever

    for flag, (attr, module) in REFUSED_SERVE_FLAGS.items():
        if getattr(args, attr):
            raise ValueError(
                f"{flag} is not supported by distel_tpu_torch yet: it needs "
                f"the reference's {module}, which is not ported"
            )
    cfg = _load_cfg(args)
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
    app = ServeApp(
        cfg,
        device=args.device,
        workers=args.workers,
        max_queue=args.max_queue,
        max_batch=args.max_batch,
        deadline_s=args.deadline_s,
        memory_budget_bytes=budget,
        warm_budget_bytes=warm_budget,
        spill_dir=args.spill_dir,
        fast_path_min_concepts=args.fast_path_min_concepts,
    )
    spilled = serve_forever(app, args.host, args.port)
    print(
        json.dumps({"shutdown": "graceful", "spilled": spilled}),
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
    # the reference's flags whose modules are not ported: accepted by
    # the parser, refused by cmd_serve naming the flag
    sv.add_argument("--warmup", nargs="*", default=None, metavar="ONTOLOGY",
                    help="not supported yet (refused)")
    sv.add_argument("--replica-id", default=None,
                    help="not supported yet (refused)")
    sv.add_argument("--artifacts-dir", default=None,
                    help="not supported yet (refused)")
    sv.add_argument("--artifacts-require", action="store_true",
                    help="not supported yet (refused)")
    sv.set_defaults(fn=cmd_serve)
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
