"""distel-lint orchestration: scopes, rule registry, CLI entry.

Each rule runs over the slice of the tree whose contract it encodes —
the lock rules over the threaded serve/obs planes, the purity rule
over the jit-compiled core, the drift rules over everything plus
README.md.  Scoping is what keeps the signal clean: the ~80 legitimate
host-side syncs in the rowpacked CONTROLLER never meet the purity rule
because the controller is not reachable from a jit root, and test
fixtures never meet any rule because tests are not analyzed.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

from distel_tpu_torch.analysis import (
    knobs,
    lockorder,
    metricnames,
    purity,
    sharedstate,
)
from distel_tpu_torch.analysis.findings import Baseline, Finding
from distel_tpu_torch.analysis.project import Project

#: modules whose hand-rolled locking replaced the reference's atomic
#: Redis Lua scripts — the lock rules' jurisdiction
LOCK_SCOPE_PREFIXES = (
    "distel_tpu_torch/serve/",
    "distel_tpu_torch/obs/",
    "distel_tpu_torch/runtime/instrumentation.py",
    "distel_tpu_torch/core/program_cache.py",
    "distel_tpu_torch/parallel/",
)

#: modules that build jit programs — the purity rule's jurisdiction
PURITY_SCOPE_PREFIXES = (
    "distel_tpu_torch/core/",
    "distel_tpu_torch/ops/",
)

#: what the CLI parses (tests/fixtures deliberately excluded)
DEFAULT_INCLUDE = [
    "distel_tpu_torch",
    "chip_smoke.py",
    "chip_ab.py",
    "chip_memory.py",
]


def _scope(project: Project, prefixes) -> List[str]:
    return [
        p
        for p in sorted(project.modules)
        if any(
            p == pre or p.startswith(pre)
            for pre in prefixes
        )
    ]


def run_rules(
    project: Project,
    readme_text: str = "",
    rules: Optional[List[str]] = None,
) -> List[Finding]:
    wanted = set(rules) if rules else None

    def on(name: str) -> bool:
        return wanted is None or name in wanted

    findings: List[Finding] = []
    if on("lock-order"):
        findings += lockorder.check(
            project, _scope(project, LOCK_SCOPE_PREFIXES)
        )
    if on("traced-purity"):
        findings += purity.check(
            project, _scope(project, PURITY_SCOPE_PREFIXES)
        )
    if on("shared-state"):
        findings += sharedstate.check(
            project, _scope(project, LOCK_SCOPE_PREFIXES)
        )
    if on("knobs"):
        findings += knobs.check(project, readme_text)
    if on("metric-names"):
        findings += metricnames.check(
            project, readme_text,
            [p for p in sorted(project.modules)
             if p.startswith("distel_tpu_torch/")],
        )
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol))
    return findings


ALL_RULES = (
    "lock-order",
    "traced-purity",
    "shared-state",
    "knobs",
    "metric-names",
)

#: rule group → the finding rule-ids it emits, so a ``--rules`` subset
#: run can scope baseline stale/unjustified reporting to the groups
#: that actually ran (entries of unselected rules are NOT stale — they
#: just didn't get a chance to fire)
RULE_IDS = {
    "lock-order": (lockorder.RULE_CYCLE, lockorder.RULE_CROSS),
    "traced-purity": (
        purity.RULE_CAPTURE, purity.RULE_SYNC, purity.RULE_BRANCH,
    ),
    "shared-state": (sharedstate.RULE,),
    "knobs": (
        knobs.RULE_DEAD, knobs.RULE_UNDOC, knobs.RULE_MISSPELLED,
    ),
    "metric-names": (metricnames.RULE_NAME, metricnames.RULE_README),
}


def repo_root() -> str:
    import distel_tpu_torch

    return os.path.dirname(os.path.dirname(os.path.abspath(
        distel_tpu_torch.__file__
    )))


def lint_main(args) -> int:
    """``cli lint`` entry: run the rules, apply the baseline, report.

    Exit codes: 0 clean (or all findings baselined), 1 fresh findings
    or an invalid baseline, 2 usage errors."""
    t0 = time.time()
    root = args.root or repo_root()
    readme_path = os.path.join(root, "README.md")
    readme_text = ""
    if os.path.exists(readme_path):
        with open(readme_path, "r", encoding="utf-8") as f:
            readme_text = f.read()
    project = Project(root, include=DEFAULT_INCLUDE)
    rules = (
        [r.strip() for r in args.rules.split(",") if r.strip()]
        if args.rules
        else None
    )
    if rules:
        unknown = sorted(set(rules) - set(ALL_RULES))
        if unknown:
            print(
                f"unknown rule(s) {unknown}; expected {list(ALL_RULES)}",
                file=sys.stderr,
            )
            return 2
    findings = run_rules(project, readme_text, rules)

    if args.write_baseline:
        if rules:
            # a subset run produces a subset baseline — committing it
            # would silently drop every other rule's suppressions
            print(
                "--write-baseline needs a full-rule run (drop --rules)",
                file=sys.stderr,
            )
            return 2
        bl = Baseline.from_findings(findings)
        bl.save(args.write_baseline)
        print(
            json.dumps(
                {
                    "written": args.write_baseline,
                    "findings": len(findings),
                    "note": (
                        "justify every entry by hand before "
                        "committing — lint fails on empty "
                        "justifications"
                    ),
                }
            )
        )
        return 0

    baseline = Baseline()
    baseline_path = args.baseline
    if baseline_path is None:
        default = os.path.join(root, ".distel-torch-lint-baseline.json")
        if os.path.exists(default):
            baseline_path = default
    if baseline_path:
        try:
            baseline = Baseline.load(baseline_path)
        except (OSError, ValueError, KeyError) as e:
            print(f"cannot load baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    fresh, suppressed, stale = baseline.filter(findings)
    unjustified = baseline.unjustified()
    if rules:
        # scope baseline bookkeeping to the rule ids that actually
        # ran: unselected rules' entries are neither stale nor held
        # to the justification bar on this run
        active_ids = {
            rid for group in rules for rid in RULE_IDS.get(group, ())
        }

        def _active(fp: str) -> bool:
            return (
                baseline.entries[fp].finding.get("rule") in active_ids
            )

        stale = [fp for fp in stale if _active(fp)]
        unjustified = [fp for fp in unjustified if _active(fp)]

    if args.json:
        doc = {
            "fresh": [f.as_dict() for f in fresh],
            "suppressed": [f.as_dict() for f in suppressed],
            "stale_baseline": stale,
            "unjustified_baseline": unjustified,
            "wall_s": round(time.time() - t0, 3),
        }
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")

    for f in fresh:
        print(f.render())
    for fp in stale:
        entry = baseline.entries[fp].finding
        print(
            f"stale baseline entry {fp} "
            f"({entry.get('rule')}: {entry.get('symbol')}) — the "
            "finding no longer fires; drop it from the baseline",
            file=sys.stderr,
        )
    for fp in unjustified:
        print(
            f"baseline entry {fp} has no justification — every "
            "committed suppression needs a one-line why",
            file=sys.stderr,
        )
    summary = {
        "findings": len(findings),
        "fresh": len(fresh),
        "baselined": len(suppressed),
        "stale_baseline": len(stale),
        "unjustified_baseline": len(unjustified),
        "wall_s": round(time.time() - t0, 3),
    }
    print(json.dumps(summary))
    return 1 if fresh or unjustified else 0
