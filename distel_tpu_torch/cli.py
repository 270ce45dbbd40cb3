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

Every command reads OWL functional syntax, RDF/XML or OWL/XML.

Usage: python -m distel_tpu_torch.cli classify FILE [--device cpu] ...
       python -m distel_tpu_torch.cli stream BASE [DELTA ...] [--device cpu]
       python -m distel_tpu_torch.cli diff FILE [--device cpu]
       python -m distel_tpu_torch.cli multiply FILE N -o OUT [--crossed]
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
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
