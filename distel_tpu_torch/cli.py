"""Command-line interface of the port.

  classify   load → saturate → taxonomy on a CUDA device (the engine
             from --config: ``engine = rowpacked``, ``packed`` or
             ``dense``); ``--verify`` diffs the closure against the CPU
             oracle
  diff       the dense engine's closure against the CPU oracle; exit 1
             on a difference

Usage: python -m distel_tpu_torch.cli classify FILE [--device cpu] ...
       python -m distel_tpu_torch.cli diff FILE [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_classify(args) -> int:
    from distel_tpu_torch.config import ClassifierConfig
    from distel_tpu_torch.runtime.classifier import ELClassifier

    cfg = (
        ClassifierConfig.from_properties(args.config)
        if args.config
        else ClassifierConfig()
    )
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="distel_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("classify", help="classify an OFN ontology")
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
    d = sub.add_parser("diff", help="verify against the CPU oracle")
    d.add_argument("ontology")
    d.add_argument(
        "--device", default=None,
        help="torch device (default: the first CUDA device; raises if none)",
    )
    d.set_defaults(fn=cmd_diff)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
