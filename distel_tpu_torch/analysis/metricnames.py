"""Rule 5: metric-name discipline.

PR 4 shipped gauges named ``distel_frontier_*_rounds_total`` — a
counter suffix on a gauge path, which trips promtool lint and breaks
``rate()`` semantics for anyone graphing them; the rename cost a
review round that a static check catches in milliseconds.  This rule
statically collects every minted metric family and enforces:

* ``metric-name`` — counters (``counter_inc`` sites) end ``_total``;
  gauges (``gauge_set``/``gauge_fn``/``*_GAUGES`` tables) and
  histograms (``observe`` sites) never do;
* ``metric-readme`` — every minted family is covered by the README
  family table (exact, ``{a,b}``-brace expanded, or ``prefix_*``
  wildcard), and every exact README family still exists in code —
  both directions of doc drift.
"""

from __future__ import annotations

import ast
import itertools
import re
from typing import Dict, List, Optional, Set, Tuple

from distel_tpu_torch.analysis.findings import Finding
from distel_tpu_torch.analysis.project import Project

RULE_NAME = "metric-name"
RULE_README = "metric-readme"

#: a COMPLETE family name — trailing-underscore strings are prefixes
#: (tempdir names, dynamic-family concatenation), not families
_FAMILY_RE = re.compile(r"^distel_[a-z0-9_]*[a-z0-9]$")


def _is_family(name: str) -> bool:
    """A plausible metric family.  The package namespace itself
    (``"distel_tpu"``, env-var-ish ``"distel_tpu_..."`` strings) is
    excluded on BOTH the mint and README sides — path/package tokens
    would otherwise register as families and the cross-check would
    only balance by accident."""
    if name == "distel_tpu" or name.startswith("distel_tpu_"):
        return False
    return bool(_FAMILY_RE.match(name))

#: method name → family kind for literal first-argument call sites
_KIND_BY_CALL = {
    "counter_inc": "counter",
    "counter_value": "counter",
    "gauge_set": "gauge",
    "gauge_fn": "gauge",
    "observe": "histogram",
    "describe": None,  # declaration, kindless
}

#: README tokens: distel_* with optional {a,b} braces / label blocks /
#: trailing wildcard
_README_TOKEN_RE = re.compile(r"distel_[a-zA-Z0-9_{},*=.]*")


def collect_minted(
    project: Project, paths: Optional[List[str]] = None
) -> Dict[str, List[Tuple[str, str, int]]]:
    """family → [(kind, path, line)] for statically visible mints."""
    if paths is None:
        paths = sorted(project.modules)
    out: Dict[str, List[Tuple[str, str, int]]] = {}

    def note(fam: str, kind: Optional[str], path: str, line: int):
        if _is_family(fam):
            out.setdefault(fam, []).append((kind or "mention", path, line))

    for path in paths:
        mod = project.modules.get(path)
        if mod is None:
            continue
        for sub in ast.walk(mod.tree):
            if isinstance(sub, ast.Call) and isinstance(
                sub.func, ast.Attribute
            ):
                kind = _KIND_BY_CALL.get(sub.func.attr, "skip")
                if kind != "skip" and sub.args and isinstance(
                    sub.args[0], ast.Constant
                ) and isinstance(sub.args[0].value, str):
                    note(sub.args[0].value, kind, path, sub.lineno)
            elif isinstance(sub, ast.Assign):
                # gauge/counter tables (`_FRONTIER_GAUGES = ...`,
                # `_ARTIFACT_COUNTERS = ...`) register through
                # gauge_group/counter_group with computed names — type
                # their string members by the GAUGE/COUNTER in the
                # target
                names = [
                    t.id for t in sub.targets if isinstance(t, ast.Name)
                ]
                table_kind = None
                if any("GAUGE" in n.upper() for n in names):
                    table_kind = "gauge"
                elif any("COUNTER" in n.upper() for n in names):
                    table_kind = "counter"
                if table_kind is not None:
                    for c in ast.walk(sub.value):
                        if isinstance(c, ast.Constant) and isinstance(
                            c.value, str
                        ):
                            note(c.value, table_kind, path, c.lineno)
            elif isinstance(sub, ast.Constant) and isinstance(
                sub.value, str
            ) and sub.value.startswith("distel_"):
                # bare string constants keep families visible for the
                # README cross-check even when the mint site is dynamic
                # (the REQUEST_METRIC getattr indirection)
                note(sub.value, None, path, sub.lineno)
    return out


def _kind_of(sites: List[Tuple[str, str, int]]) -> Optional[str]:
    kinds = {k for k, _p, _l in sites if k in (
        "counter", "gauge", "histogram",
    )}
    if len(kinds) == 1:
        return next(iter(kinds))
    return None  # unknown or conflicting — naming check skips it


def _expand_readme_tokens(text: str) -> Tuple[Set[str], Set[str]]:
    """(exact family names, wildcard prefixes) documented in README."""
    exact: Set[str] = set()
    prefixes: Set[str] = set()
    for token in _README_TOKEN_RE.findall(text):
        token = token.rstrip(".,")
        # strip a label block: distel_x_seconds{phase=...}
        token = re.sub(r"\{[^}]*=[^}]*\}", "", token)
        # expand {a,b} alternation groups
        parts = re.split(r"(\{[^}]*\})", token)
        options = [
            p[1:-1].split(",") if p.startswith("{") else [p]
            for p in parts
            if p
        ]
        for combo in itertools.product(*options) if options else ():
            name = "".join(combo)
            if name.endswith("*"):
                if name != "distel_tpu*":
                    prefixes.add(name[:-1])
            elif _is_family(name):
                exact.add(name)
    return exact, prefixes


def check(
    project: Project,
    readme_text: str = "",
    paths: Optional[List[str]] = None,
) -> List[Finding]:
    minted = collect_minted(project, paths)
    findings: List[Finding] = []

    # ---- naming discipline
    for fam, sites in sorted(minted.items()):
        kind = _kind_of(sites)
        path, line = sites[0][1], sites[0][2]
        for k, p, l in sites:
            if k == (kind or ""):
                path, line = p, l
                break
        if kind == "counter" and not fam.endswith("_total"):
            findings.append(
                Finding(
                    rule=RULE_NAME, path=path, line=line, symbol=fam,
                    message=(
                        f"counter family {fam} must end in _total "
                        "(Prometheus counter convention; rate() and "
                        "promtool depend on it)"
                    ),
                )
            )
        elif kind in ("gauge", "histogram") and fam.endswith("_total"):
            findings.append(
                Finding(
                    rule=RULE_NAME, path=path, line=line, symbol=fam,
                    message=(
                        f"{kind} family {fam} carries the "
                        "counter-reserved _total suffix — rename (the "
                        "PR 4 frontier-gauge mistake)"
                    ),
                )
            )

    # ---- README family-table cross-check
    if readme_text:
        exact, prefixes = _expand_readme_tokens(readme_text)
        for fam, sites in sorted(minted.items()):
            covered = fam in exact or any(
                fam.startswith(p) for p in prefixes
            )
            if not covered:
                path, line = sites[0][1], sites[0][2]
                findings.append(
                    Finding(
                        rule=RULE_README, path=path, line=line,
                        symbol=fam,
                        message=(
                            f"metric family {fam} is minted but "
                            "missing from the README family table"
                        ),
                    )
                )
        minted_names = set(minted)
        for fam in sorted(exact):
            if fam in minted_names:
                continue
            # histogram suffixes of a minted family are documented
            base = re.sub(r"_(bucket|sum|count|max)$", "", fam)
            if base in minted_names:
                continue
            findings.append(
                Finding(
                    rule=RULE_README, path="README.md", line=0,
                    symbol=fam,
                    message=(
                        f"README documents metric family {fam}, but "
                        "nothing in the tree mints it — stale doc "
                        "(renamed or removed family)"
                    ),
                )
            )
    return findings
