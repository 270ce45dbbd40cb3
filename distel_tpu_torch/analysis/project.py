"""Source model for distel-lint: parsed modules + shared AST facts.

A :class:`Project` is a root directory and a set of parsed python
modules (repo-relative posix paths → :class:`Module`).  Rules consume
the pre-computed per-module facts — classes, their lock attributes,
attribute types inferred from constructor assignments — so each rule
stays a small pass over a shared index instead of five ad-hoc AST
walks.  Tests build projects from temp dirs of fixture snippets; the
CLI builds one from the repo.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

#: the load-bearing docstring convention: a sentence like "Caller
#: holds ``entry.lock``." marks a helper whose callers hold a lock.
#: BOTH lock rules parse it through :func:`caller_holds_tokens` — one
#: parser, so the rules can never disagree about which helpers are
#: lock-covered
#: the sentence tail: up to the first period that ENDS a sentence —
#: a period followed by non-space (``entry.lock``) is part of a token
_HOLDS_SENTENCE_RE = re.compile(
    r"[Cc]aller(?:s)?[^.]{0,40}?holds?\s+((?:[^.]|\.(?=\S))*)"
)
_HOLDS_TOKEN_RE = re.compile(r"[A-Za-z_][\w.]*(?:lock|_cv)\w*")


def caller_holds_tokens(fn) -> List[str]:
    """Raw lock tokens (``"entry.lock"``, ``"self._lock"``) named by a
    function docstring's "Caller holds ..." sentence(s).  Whitespace is
    normalized first so the sentence survives docstring line wraps."""
    doc = re.sub(r"\s+", " ", ast.get_docstring(fn) or "")
    out: List[str] = []
    for m in _HOLDS_SENTENCE_RE.finditer(doc):
        out.extend(_HOLDS_TOKEN_RE.findall(m.group(1)))
    return out

#: constructors that mint a lock object (attribute paths as written)
_LOCK_CTORS = {
    ("threading", "Lock"),
    ("threading", "RLock"),
    ("threading", "Condition"),
}

#: bare names that mint a lock when imported from threading
_LOCK_NAMES = {"Lock", "RLock", "Condition"}


def _call_target(call: ast.Call) -> Optional[Tuple[str, ...]]:
    """Dotted-name tuple of a call's callee (``threading.Lock`` →
    ``("threading", "Lock")``), or None for non-name callees."""
    parts: List[str] = []
    node = call.func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    tgt = _call_target(node)
    if tgt is None:
        return False
    if len(tgt) == 2 and tgt in _LOCK_CTORS:
        return True
    return len(tgt) == 1 and tgt[0] in _LOCK_NAMES


@dataclass
class ClassInfo:
    module: str  # repo-relative path
    name: str
    node: ast.ClassDef
    #: attribute names assigned a lock constructor anywhere in the class
    lock_attrs: Set[str] = field(default_factory=set)
    #: attr name → class name, from ``self.x = ClassName(...)``
    attr_types: Dict[str, str] = field(default_factory=dict)
    #: attr name → True when assigned an array-producing expression
    #: (``jnp.asarray(...)``, ``jnp.zeros(...)``, ``device_put`` ...)
    array_attrs: Set[str] = field(default_factory=set)
    #: method name → FunctionDef/AsyncFunctionDef
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)


_ARRAY_MINTERS = {
    "asarray", "array", "zeros", "ones", "full", "arange", "where",
    "device_put", "packbits",
}


def _is_array_expr(node: ast.expr) -> bool:
    """Does this expression look like it builds a device/ndarray?"""
    if isinstance(node, ast.Call):
        tgt = _call_target(node)
        if tgt and tgt[-1] in _ARRAY_MINTERS:
            return True
        # jnp.x.astype(...) / jnp.asarray(...).reshape(...)
        if isinstance(node.func, ast.Attribute):
            return _is_array_expr(node.func.value)
    return False


@dataclass
class Module:
    path: str  # repo-relative posix path
    source: str
    tree: ast.AST
    #: class name → info, for classes defined here
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    #: top-level function name → node
    functions: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    #: imported name → dotted module it came from
    #: (``from distel_tpu.serve.metrics import Metrics`` →
    #: ``{"Metrics": "distel_tpu.serve.metrics"}``)
    imports: Dict[str, str] = field(default_factory=dict)


class Project:
    """Parsed view of the analyzed tree.

    ``files``: explicit ``{relpath: source}`` mapping (tests); or scan
    ``root`` for ``include`` prefixes (CLI).  Paths are posix-style and
    repo-relative throughout.
    """

    def __init__(
        self,
        root: str,
        files: Optional[Dict[str, str]] = None,
        include: Optional[List[str]] = None,
    ):
        self.root = root
        self.modules: Dict[str, Module] = {}
        if files is None:
            files = {}
            for rel in self._scan(root, include):
                try:
                    with open(
                        os.path.join(root, rel), "r", encoding="utf-8"
                    ) as f:
                        files[rel.replace(os.sep, "/")] = f.read()
                except OSError:
                    continue
        for rel, src in sorted(files.items()):
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError:
                continue  # a broken file is pytest's problem, not lint's
            self.modules[rel] = self._index(rel, src, tree)
        #: class name → [ClassInfo] across modules (collision-aware)
        self.classes_by_name: Dict[str, List[ClassInfo]] = {}
        for mod in self.modules.values():
            for ci in mod.classes.values():
                self.classes_by_name.setdefault(ci.name, []).append(ci)

    @staticmethod
    def _scan(root: str, include: Optional[List[str]]) -> List[str]:
        out: List[str] = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [
                d for d in dirnames
                if d not in (".git", "__pycache__", "build", ".claude")
            ]
            for fn in filenames:
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                rel = rel.replace(os.sep, "/")
                if include is None or any(
                    rel == p or rel.startswith(p.rstrip("/") + "/")
                    for p in include
                ):
                    out.append(rel)
        return sorted(out)

    # ------------------------------------------------------- indexing

    @staticmethod
    def _index(rel: str, src: str, tree: ast.AST) -> Module:
        mod = Module(path=rel, source=src, tree=tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    mod.imports[alias.asname or alias.name] = node.module
        for node in getattr(tree, "body", []):
            if isinstance(node, ast.ClassDef):
                mod.classes[node.name] = Project._index_class(rel, node)
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                mod.functions[node.name] = node
        return mod

    @staticmethod
    def _index_class(rel: str, node: ast.ClassDef) -> ClassInfo:
        ci = ClassInfo(module=rel, name=node.name, node=node)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = item
        for sub in ast.walk(node):
            if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                sub.targets if isinstance(sub, ast.Assign) else [sub.target]
            )
            value = sub.value
            if value is None:
                continue
            for tgt in targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                if is_lock_ctor(value):
                    ci.lock_attrs.add(tgt.attr)
                elif _is_array_expr(value):
                    ci.array_attrs.add(tgt.attr)
                elif isinstance(value, ast.Call):
                    tgt_path = _call_target(value)
                    if tgt_path is not None and tgt_path[-1][:1].isupper():
                        ci.attr_types[tgt.attr] = tgt_path[-1]
        return ci

    # -------------------------------------------------------- queries

    def classes_with_lock_attr(self, attr: str) -> List[ClassInfo]:
        return [
            ci
            for cis in self.classes_by_name.values()
            for ci in cis
            if attr in ci.lock_attrs
        ]

    def find_class(self, name: str) -> Optional[ClassInfo]:
        cis = self.classes_by_name.get(name, [])
        return cis[0] if len(cis) == 1 else None
