"""Rule 4: config-knob drift.

Three planes must agree about every knob: the ``ClassifierConfig``
dataclass field, the ``from_properties`` java-properties key, and the
README documentation.  They drift independently (a knob lands with its
PR, the properties key follows, the docs never do), and the failure
modes are silent: a dead field nobody reads, a documented spelling that
parses to nothing, a properties key that sets a field that no longer
exists.

Findings:

* ``knob-dead`` — a config field no code ever reads (outside its
  definition and the properties parser);
* ``knob-undocumented`` — a properties key README never mentions (an
  operator cannot discover it);
* ``knob-misspelled`` — a ``from_properties`` branch that tests a key
  but assigns no known field, or assigns a field the dataclass does
  not define (the classic silent-typo: the key parses, nothing
  changes).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from distel_tpu_torch.analysis.findings import Finding
from distel_tpu_torch.analysis.project import Project

RULE_DEAD = "knob-dead"
RULE_UNDOC = "knob-undocumented"
RULE_MISSPELLED = "knob-misspelled"

#: properties-key prefixes handled dynamically (``backend.CR1 = tpu``)
_DYNAMIC_KEY_PREFIXES = ("backend.",)


def _config_class(project: Project, config_path: str):
    mod = project.modules.get(config_path)
    if mod is None:
        return None
    for cls in mod.classes.values():
        if "Config" in cls.name:
            return cls
    return None


def _fields(cls) -> Dict[str, int]:
    """Dataclass field name → definition line."""
    out: Dict[str, int] = {}
    for item in cls.node.body:
        if isinstance(item, ast.AnnAssign) and isinstance(
            item.target, ast.Name
        ):
            out[item.target.id] = item.lineno
    return out


def _properties_map(cls) -> List[Tuple[str, Optional[str], int]]:
    """(properties key, assigned field | None, line) triples from the
    ``from_properties`` parser.  A branch that tests several keys
    (reference spellings) yields one triple per key."""
    fn = cls.methods.get("from_properties")
    if fn is None:
        return []
    out: List[Tuple[str, Optional[str], int]] = []

    def keys_of(test: ast.expr) -> List[str]:
        ks = []
        for sub in ast.walk(test):
            if (
                isinstance(sub, ast.Compare)
                and isinstance(sub.left, ast.Constant)
                and isinstance(sub.left.value, str)
                and any(isinstance(op, ast.In) for op in sub.ops)
            ):
                ks.append(sub.left.value)
        return ks

    def fields_of(body) -> List[Tuple[Optional[str], int]]:
        fs = []
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "cfg"
                        ):
                            fs.append((tgt.attr, tgt.lineno))
        return fs

    def walk(stmts):
        for stmt in stmts:
            if isinstance(stmt, ast.If):
                branches = [(stmt.test, stmt.body)]
                node = stmt
                while (
                    len(node.orelse) == 1
                    and isinstance(node.orelse[0], ast.If)
                ):
                    node = node.orelse[0]
                    branches.append((node.test, node.body))
                tail = node.orelse
                for test, body in branches:
                    ks = keys_of(test)
                    fs = fields_of(body)
                    for k in ks:
                        if fs:
                            for fname, line in fs:
                                out.append((k, fname, line))
                        else:
                            out.append((k, None, test.lineno))
                    walk(body)
                walk(tail)
            elif isinstance(stmt, ast.For):
                # `for key in ("a", "b"):  if key in raw:` — the
                # multi-spelling loop: every constant in the iterable
                # is a key for the loop body's cfg assignment
                ks = [
                    sub.value
                    for sub in ast.walk(stmt.iter)
                    if isinstance(sub, ast.Constant)
                    and isinstance(sub.value, str)
                    and not sub.value.startswith(_DYNAMIC_KEY_PREFIXES)
                ]
                fs = fields_of(stmt.body)
                for k in ks:
                    for fname, line in fs:
                        out.append((k, fname, line))

    walk(fn.body)
    # drop duplicate (key, field) pairs, keep first line
    seen: Set[Tuple[str, Optional[str]]] = set()
    uniq = []
    for k, f, line in out:
        if (k, f) not in seen:
            seen.add((k, f))
            uniq.append((k, f, line))
    return uniq


def _attribute_reads(project: Project,
                     field_names: Set[str]) -> Dict[str, int]:
    """field → count of attribute LOADS across the project (any
    receiver), excluding the parser's ``cfg.x = ...`` stores and the
    dataclass definition."""
    counts = {f: 0 for f in field_names}
    for path, mod in project.modules.items():
        for sub in ast.walk(mod.tree):
            if not isinstance(sub, ast.Attribute):
                continue
            if sub.attr not in counts:
                continue
            if isinstance(sub.ctx, (ast.Store, ast.Del)):
                continue
            counts[sub.attr] += 1
    return counts


def check(
    project: Project,
    readme_text: str = "",
    config_path: str = "distel_tpu_torch/config.py",
) -> List[Finding]:
    cls = _config_class(project, config_path)
    if cls is None:
        return []
    fields = _fields(cls)
    props = _properties_map(cls)
    findings: List[Finding] = []

    # ---- misspelled: parser branches that set nothing / set unknowns
    for key, fname, line in props:
        if fname is None:
            findings.append(
                Finding(
                    rule=RULE_MISSPELLED,
                    path=config_path,
                    line=line,
                    symbol=key,
                    message=(
                        f"from_properties tests {key!r} but assigns no "
                        "config field — the key parses to nothing"
                    ),
                )
            )
        elif fname not in fields:
            findings.append(
                Finding(
                    rule=RULE_MISSPELLED,
                    path=config_path,
                    line=line,
                    symbol=f"{key}->{fname}",
                    message=(
                        f"from_properties assigns cfg.{fname} for key "
                        f"{key!r}, but the dataclass defines no such "
                        "field — a silent typo the parser never catches"
                    ),
                )
            )

    # ---- dead: fields nothing reads
    reads = _attribute_reads(project, set(fields))
    for fname, line in sorted(fields.items()):
        if reads.get(fname, 0) == 0:
            findings.append(
                Finding(
                    rule=RULE_DEAD,
                    path=config_path,
                    line=line,
                    symbol=fname,
                    message=(
                        f"config field {fname} is never read anywhere "
                        "— dead knob (delete it or wire it through)"
                    ),
                )
            )

    # ---- undocumented: properties keys README never mentions.  The
    # canonical (non-reference) spelling per field is the FIRST key in
    # parser order; reference-compat aliases (NODES_LIST, chunk.size)
    # ride along undocumented by design, so only the canonical key is
    # held to the README bar.
    canonical: Dict[str, Tuple[str, int]] = {}
    for key, fname, line in props:
        if fname is not None and fname not in canonical:
            canonical[fname] = (key, line)
    for fname, (key, line) in sorted(canonical.items()):
        if key not in readme_text and fname not in readme_text:
            findings.append(
                Finding(
                    rule=RULE_UNDOC,
                    path=config_path,
                    line=line,
                    symbol=key,
                    message=(
                        f"properties key {key!r} (config field "
                        f"{fname}) is not documented in README — "
                        "operators cannot discover it"
                    ),
                )
            )
    return findings
