"""Finding + baseline model for distel-lint.

A finding's identity is its **fingerprint** — ``rule | path | symbol |
message`` hashed, deliberately excluding the line number so ordinary
edits above a finding don't churn the baseline.  The baseline file is a
JSON document mapping fingerprints to ``{finding..., justification}``;
every committed entry must carry a non-empty one-line justification
(the lint run fails otherwise — a suppression nobody can defend is a
bug with paperwork).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional


@dataclass
class Finding:
    #: rule id, e.g. "lock-order-cycle", "metric-name"
    rule: str
    #: repo-relative posix path — must be STABLE for the finding's
    #: identity (rules anchor e.g. a lock edge to the held lock's
    #: defining module, not to whichever call site witnessed it)
    path: str
    #: 1-based line of the primary site (0 = whole-file / cross-file)
    line: int
    #: stable symbol the finding anchors to (class.attr, function, knob,
    #: metric family, lock pair) — part of the fingerprint
    symbol: str
    #: human message; must not embed line numbers or witness call
    #: chains (fingerprint stability — an unrelated refactor must not
    #: churn the baseline)
    message: str
    #: unstable diagnostic detail (witness chain, schedule info) —
    #: rendered, exported, NEVER fingerprinted
    note: str = ""

    def fingerprint(self) -> str:
        h = hashlib.sha1(
            "|".join((self.rule, self.path, self.symbol, self.message))
            .encode("utf-8")
        )
        return h.hexdigest()[:12]

    def as_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule}] {self.symbol}: {self.message}"
        if self.note:
            out += f" [{self.note}]"
        return out


@dataclass
class BaselineEntry:
    finding: dict
    justification: str = ""


class Baseline:
    """Committed suppression set: pre-existing findings with a one-line
    justification each.  ``filter`` splits a run's findings into fresh
    (fail the build) vs baselined; stale entries (nothing fired) are
    reported so the file shrinks as debts are paid."""

    def __init__(self, entries: Optional[Dict[str, BaselineEntry]] = None):
        self.entries: Dict[str, BaselineEntry] = entries or {}

    # ------------------------------------------------------------- io

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        entries = {}
        for fp, rec in doc.get("findings", {}).items():
            entries[fp] = BaselineEntry(
                finding=rec.get("finding", {}),
                justification=rec.get("justification", ""),
            )
        return cls(entries)

    def save(self, path: str) -> None:
        doc = {
            "comment": (
                "distel-lint baseline: pre-existing findings, each "
                "carrying a one-line justification.  Regenerate "
                "candidates with `cli lint --write-baseline`, then "
                "justify every entry by hand."
            ),
            "findings": {
                fp: {
                    "finding": e.finding,
                    "justification": e.justification,
                }
                for fp, e in sorted(self.entries.items())
            },
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=False)
            f.write("\n")

    # ---------------------------------------------------------- policy

    @classmethod
    def from_findings(
        cls, findings: List[Finding], justification: str = ""
    ) -> "Baseline":
        return cls(
            {
                f.fingerprint(): BaselineEntry(
                    finding=f.as_dict(), justification=justification
                )
                for f in findings
            }
        )

    def unjustified(self) -> List[str]:
        """Fingerprints whose entry has no justification — a committed
        baseline with one of these fails the lint run."""
        return [
            fp
            for fp, e in sorted(self.entries.items())
            if not e.justification.strip()
        ]

    def filter(self, findings: List[Finding]):
        """``(fresh, suppressed, stale_fingerprints)``."""
        fired = set()
        fresh: List[Finding] = []
        suppressed: List[Finding] = []
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                fired.add(fp)
                suppressed.append(f)
            else:
                fresh.append(f)
        stale = [fp for fp in sorted(self.entries) if fp not in fired]
        return fresh, suppressed, stale
