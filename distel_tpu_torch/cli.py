"""Command-line interface of the port.

  classify   load → saturate → taxonomy on a CUDA device

Usage: python -m distel_tpu_torch.cli classify FILE [--device cpu] ...
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
    res = clf.classify_file(args.ontology, resume_from=args.resume)
    print(json.dumps(res.summary(), indent=2))
    if args.output:
        res.taxonomy.write(args.output)
        print(f"taxonomy written to {args.output}")
    if args.snapshot:
        from distel_tpu_torch.runtime.checkpoint import save_snapshot

        save_snapshot(args.snapshot, res.result)
        print(f"snapshot written to {args.snapshot}")
    return 0


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
    c.add_argument("--snapshot", help="write a v2 S/R snapshot (.npz)")
    c.add_argument(
        "--resume",
        help="warm-start from a v2 snapshot (.npz), realigned by name; its "
             "corpus must be a SUBSET of this one",
    )
    c.add_argument("--instrument", action="store_true", help="phase timers")
    c.set_defaults(fn=cmd_classify)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
