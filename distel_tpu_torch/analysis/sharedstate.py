"""Rule 3: shared-state heuristic.

For every class that owns a lock (``self._lock = threading.Lock()``
and friends), find instance attributes that are **mutated both inside
and outside** a ``with <that class's lock>:`` block.  A lock that
covers only some writers is the PR 6 split-brain shape: every reader
that takes the lock believes it sees a consistent value while an
unlocked writer races it.

Covered mutation forms: ``self.x = ...`` / ``self.x += ...`` and
mutating method calls (``self.x.append(...)``, ``.pop``, ``.add``,
``.update``, ...), both via ``self`` inside the class and via a typed
receiver from outside it (``entry.inc = ...`` in the registry counts
against ``_Entry``).  ``__init__`` (and other constructors) are
exempt — construction happens before the object is shared.  The
``"caller holds ``x.lock``"`` docstring convention marks a helper as
lock-covered without a lexical ``with``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from distel_tpu_torch.analysis.findings import Finding
from distel_tpu_torch.analysis.project import (
    ClassInfo,
    Module,
    Project,
    caller_holds_tokens,
)

RULE = "shared-state"

#: method names that mutate common containers
_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "remove", "clear",
    "add", "discard", "update", "setdefault", "appendleft",
}

#: constructor-ish methods exempt from the both-sides check
_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}


@dataclass
class _Site:
    path: str
    line: int
    func: str
    locked: bool


class _MutationWalker(ast.NodeVisitor):
    """Collect attribute mutations in one function, tagged with whether
    any analyzed-class lock is held at the site."""

    def __init__(
        self,
        project: Project,
        module: Module,
        cls: Optional[ClassInfo],
        func_name: str,
        path: str,
        sites: Dict[Tuple[str, str], List[_Site]],
        entry_locked_attrs: Set[str],
    ):
        self.project = project
        self.module = module
        self.cls = cls
        self.func_name = func_name
        self.path = path
        self.sites = sites
        #: receivers whose lock is held RIGHT NOW: "self" and/or local
        #: variable names ("entry"), plus "*" when entry docstring says
        #: the caller holds a lock attr without naming the receiver
        self.locked_receivers: List[str] = sorted(entry_locked_attrs)

    # ------------------------------------------------------- helpers

    def _owner_of(self, recv: ast.expr, attr: str):
        """(class-name, receiver-token) owning the mutated attr, or
        None when the receiver can't be typed."""
        if isinstance(recv, ast.Name):
            if recv.id == "self" and self.cls is not None:
                return self.cls.name, "self"
            # typed local: unique analyzed class owning this attr as a
            # lock attr OR declared in __slots__/assignments — approx:
            # unique class with a lock whose methods/ctor assign attr
            owners = [
                cis[0]
                for cis in self.project.classes_by_name.values()
                if len(cis) == 1
                and cis[0].lock_attrs
                and _class_has_attr(cis[0], attr)
            ]
            if len(owners) == 1:
                return owners[0].name, recv.id
        return None

    def _record(self, recv: ast.expr, attr: str, line: int) -> None:
        owner = self._owner_of(recv, attr)
        if owner is None:
            return
        cls_name, token = owner
        ci = self.project.find_class(cls_name)
        if ci is None or not ci.lock_attrs or attr in ci.lock_attrs:
            return
        locked = token in self.locked_receivers or (
            token == "self" and "<self-lock>" in self.locked_receivers
        )
        self.sites.setdefault((cls_name, attr), []).append(
            _Site(self.path, line, self.func_name, locked)
        )

    # -------------------------------------------------------- visits

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node) -> None:
        pushed: List[str] = []
        for item in node.items:
            ce = item.context_expr
            if isinstance(ce, ast.Attribute):
                attr, recv = ce.attr, ce.value
                is_lock = False
                if (
                    isinstance(recv, ast.Name)
                    and recv.id == "self"
                    and self.cls is not None
                    and attr in self.cls.lock_attrs
                ):
                    is_lock = True
                    token = "<self-lock>"
                elif isinstance(recv, ast.Name) and self.project\
                        .classes_with_lock_attr(attr):
                    is_lock = True
                    token = recv.id
                if is_lock:
                    self.locked_receivers.append(token)
                    pushed.append(token)
        for stmt in node.body:
            self.visit(stmt)
        for token in pushed:
            self.locked_receivers.remove(token)

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._target(tgt)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target)
        self.generic_visit(node)

    def _target(self, tgt: ast.expr) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el)
            return
        if isinstance(tgt, ast.Subscript):
            tgt = tgt.value  # self.x[k] = v mutates self.x
        if isinstance(tgt, ast.Attribute):
            self._record(tgt.value, tgt.attr, tgt.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr in _MUTATORS
            and isinstance(fn.value, ast.Attribute)
        ):
            self._record(fn.value.value, fn.value.attr, node.lineno)
        self.generic_visit(node)

    # nested defs run on other threads/timing — analyzed separately
    def visit_FunctionDef(self, node) -> None:  # noqa: D102
        pass

    visit_AsyncFunctionDef = visit_FunctionDef


def _class_has_attr(ci: ClassInfo, attr: str) -> bool:
    for sub in ast.walk(ci.node):
        if isinstance(sub, ast.Attribute) and sub.attr == attr and (
            isinstance(sub.value, ast.Name) and sub.value.id == "self"
        ):
            return True
        if isinstance(sub, ast.Constant) and sub.value == attr:
            return True  # __slots__ entry
    return False


def check(project: Project, paths: Optional[List[str]] = None) -> List[Finding]:
    if paths is None:
        paths = sorted(project.modules)
    sites: Dict[Tuple[str, str], List[_Site]] = {}
    for path in paths:
        module = project.modules.get(path)
        if module is None:
            continue
        for cls in module.classes.values():
            for mname, fn in cls.methods.items():
                if mname in _EXEMPT_METHODS:
                    continue
                # the shared "Caller holds ``x.lock``" parser (ONE
                # parser for both lock rules): "self.X"/bare lock
                # attrs of this class cover self-mutations, a named
                # receiver ("entry.lock") covers that variable's
                tokens: Set[str] = set()
                for token in caller_holds_tokens(fn):
                    parts = token.split(".")
                    recv = parts[0] if len(parts) > 1 else None
                    if recv not in (None, "self"):
                        tokens.add(recv)
                    elif recv == "self" or parts[-1] in cls.lock_attrs:
                        tokens.add("<self-lock>")
                walker = _MutationWalker(
                    project, module, cls, f"{cls.name}.{mname}",
                    path, sites, tokens,
                )
                for stmt in fn.body:
                    walker.visit(stmt)
        for fname, fn in module.functions.items():
            walker = _MutationWalker(
                project, module, None, fname, path, sites,
                set(),
            )
            for stmt in fn.body:
                walker.visit(stmt)

    findings: List[Finding] = []
    for (cls_name, attr), slist in sorted(sites.items()):
        locked = [s for s in slist if s.locked]
        unlocked = [s for s in slist if not s.locked]
        if not locked or not unlocked:
            continue
        un = unlocked[0]
        lk = locked[0]
        findings.append(
            Finding(
                rule=RULE,
                path=un.path,
                line=un.line,
                symbol=f"{cls_name}.{attr}",
                message=(
                    f"{cls_name}.{attr} is mutated under a lock in "
                    f"{lk.func} but WITHOUT one in {un.func} — either "
                    "every writer takes the lock or none should"
                ),
            )
        )
    return findings
