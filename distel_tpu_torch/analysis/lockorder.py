"""Rule 1: static lock-order analysis.

Builds the lock-acquisition graph of the serve/obs planes from
``with <lock>:`` nesting and intra-package call edges, then reports

* ``lock-order-cycle`` — a cycle in the acquired-while-holding graph:
  two schedules can acquire the same locks in opposite orders, i.e. a
  deadlock a test schedule may never hit;
* ``lock-order-cross-module`` — a lock acquired while holding a lock
  that lives in a different module.  Not a bug by itself, but every
  such edge is a standing constraint on the callee module ("never call
  back into the holder") that nothing else records — the committed
  baseline is where each one carries its justification.

Lock identity is ``Class.attr`` (one id per allocation role, like the
runtime lockdep's allocation-site classes in
:mod:`distel_tpu.testing.lockdep` — the static and runtime views name
locks compatibly).  The ``"caller holds ``x.lock``"`` docstring
convention marks helper functions whose callers hold a lock; the rule
treats those locks as held at entry, so the helper's acquisitions
order after them exactly as at runtime.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from distel_tpu_torch.analysis.findings import Finding
from distel_tpu_torch.analysis.project import (
    ClassInfo,
    Module,
    Project,
    caller_holds_tokens,
)

RULE_CYCLE = "lock-order-cycle"
RULE_CROSS = "lock-order-cross-module"


@dataclass
class _Edge:
    held: str
    acquired: str
    path: str
    line: int
    via: str  # function chain that witnessed the edge


@dataclass
class _FuncFacts:
    qualid: str
    path: str
    cls: Optional[ClassInfo]
    entry_held: FrozenSet[str] = frozenset()
    #: blocking acquisitions made directly in this function
    acquires: Set[str] = field(default_factory=set)
    #: (held-set, callee-spec, line)
    calls: List[Tuple[FrozenSet[str], "_CallSpec", int]] = field(
        default_factory=list
    )
    edges: List[_Edge] = field(default_factory=list)


@dataclass(frozen=True)
class _CallSpec:
    kind: str  # "self" | "module" | "attr" | "name"
    name: str  # method/function name
    extra: str = ""  # receiver attr / module alias


class _LockResolver:
    """Maps a ``with``-context / ``.acquire()`` receiver expression to
    a stable lock id (``Class.attr``) or None."""

    def __init__(self, project: Project, module: Module,
                 cls: Optional[ClassInfo]):
        self.project = project
        self.module = module
        self.cls = cls

    def resolve(self, node: ast.expr) -> Optional[str]:
        if not isinstance(node, ast.Attribute):
            return None
        attr = node.attr
        recv = node.value
        # self.X
        if isinstance(recv, ast.Name) and recv.id == "self" and self.cls:
            if attr in self.cls.lock_attrs:
                return f"{self.cls.name}.{attr}"
            return None
        # self.A.B → type(A).B when the ctor typed A; else fall through
        # to the unique-lock-attr match below
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and self.cls is not None
        ):
            tname = self.cls.attr_types.get(recv.attr)
            if tname:
                ci = self.project.find_class(tname)
                if ci and attr in ci.lock_attrs:
                    return f"{ci.name}.{attr}"
        # var.X / self.A.X: unique class carrying lock attr X wins
        owners = self.project.classes_with_lock_attr(attr)
        if len(owners) == 1:
            return f"{owners[0].name}.{attr}"
        return None

    def resolve_token(self, token: str) -> Optional[str]:
        """Docstring token (``entry.lock`` / ``self._lock``) → lock id."""
        parts = token.split(".")
        attr = parts[-1]
        if len(parts) >= 2 and parts[-2] == "self" and self.cls:
            if attr in self.cls.lock_attrs:
                return f"{self.cls.name}.{attr}"
            return None
        owners = self.project.classes_with_lock_attr(attr)
        if len(owners) == 1:
            return f"{owners[0].name}.{attr}"
        if self.cls and attr in self.cls.lock_attrs:
            return f"{self.cls.name}.{attr}"
        return None


def _entry_held(fn: ast.FunctionDef, resolver: _LockResolver) -> FrozenSet[str]:
    held: Set[str] = set()
    for token in caller_holds_tokens(fn):
        lid = resolver.resolve_token(token)
        if lid:
            held.add(lid)
    return frozenset(held)


class _FuncWalker(ast.NodeVisitor):
    """Walks one function body tracking the held-lock stack."""

    def __init__(self, facts: _FuncFacts, resolver: _LockResolver):
        self.facts = facts
        self.resolver = resolver
        self.held: List[str] = list(facts.entry_held)

    # ------------------------------------------------------- helpers

    def _record_acquire(self, lid: str, line: int, blocking: bool) -> None:
        if blocking:
            self.facts.acquires.add(lid)
            for h in self.held:
                if h != lid:
                    self.facts.edges.append(
                        _Edge(h, lid, self.facts.path, line,
                              self.facts.qualid)
                    )

    # -------------------------------------------------------- visits

    def visit_With(self, node: ast.With) -> None:
        self._with(node)

    def visit_AsyncWith(self, node: ast.AsyncWith) -> None:
        self._with(node)

    def _with(self, node) -> None:
        base = len(self.held)
        pushed = 0
        for item in node.items:
            lid = self.resolver.resolve(item.context_expr)
            if lid is not None:
                self._record_acquire(lid, node.lineno, blocking=True)
                self.held.append(lid)
                pushed += 1
            else:
                # a non-lock context manager may still contain calls
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        # remove exactly the with-pushed slice: a bare .acquire()
        # inside the body appends PAST it and legitimately outlives
        # the with — popping positionally would strip the wrong locks
        del self.held[base:base + pushed]

    def visit_Call(self, node: ast.Call) -> None:
        spec = self._callee(node)
        if spec is not None and spec.name in ("acquire", "release"):
            recv = node.func.value if isinstance(
                node.func, ast.Attribute
            ) else None
            lid = self.resolver.resolve(recv) if recv is not None else None
            if lid is not None:
                if spec.name == "acquire":
                    blocking = True
                    if node.args and isinstance(
                        node.args[0], ast.Constant
                    ):
                        blocking = bool(node.args[0].value)
                    for kw in node.keywords:
                        if kw.arg == "blocking" and isinstance(
                            kw.value, ast.Constant
                        ):
                            blocking = bool(kw.value.value)
                    self._record_acquire(lid, node.lineno, blocking)
                    self.held.append(lid)
                else:
                    if lid in self.held:
                        # remove the innermost occurrence
                        for i in range(len(self.held) - 1, -1, -1):
                            if self.held[i] == lid:
                                del self.held[i]
                                break
                self.generic_visit(node)
                return
        if spec is not None:
            self.facts.calls.append(
                (frozenset(self.held), spec, node.lineno)
            )
        self.generic_visit(node)

    def _callee(self, node: ast.Call) -> Optional[_CallSpec]:
        fn = node.func
        if isinstance(fn, ast.Name):
            return _CallSpec("name", fn.id)
        if isinstance(fn, ast.Attribute):
            recv = fn.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                return _CallSpec("self", fn.attr)
            if (
                isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"
            ):
                return _CallSpec("attr", fn.attr, recv.attr)
            if isinstance(recv, ast.Name):
                return _CallSpec("name_attr", fn.attr, recv.id)
        return None

    # nested defs/lambdas run later, under unknown locks — skip them
    def visit_FunctionDef(self, node) -> None:  # noqa: D102
        pass

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node) -> None:  # noqa: D102
        pass


def _collect_facts(project: Project, paths: List[str]) -> Dict[str, _FuncFacts]:
    facts: Dict[str, _FuncFacts] = {}
    for path in paths:
        module = project.modules[path]
        for cls in module.classes.values():
            for mname, fn in cls.methods.items():
                resolver = _LockResolver(project, module, cls)
                qualid = f"{cls.name}.{mname}"
                ff = _FuncFacts(qualid, path, cls)
                ff.entry_held = _entry_held(fn, resolver)
                walker = _FuncWalker(ff, resolver)
                for stmt in fn.body:
                    walker.visit(stmt)
                facts[qualid] = ff
        for fname, fn in module.functions.items():
            resolver = _LockResolver(project, module, None)
            qualid = f"{path}::{fname}"
            ff = _FuncFacts(qualid, path, None)
            ff.entry_held = _entry_held(fn, resolver)
            walker = _FuncWalker(ff, resolver)
            for stmt in fn.body:
                walker.visit(stmt)
            facts[qualid] = ff
    return facts


def _resolve_call(
    project: Project,
    facts: Dict[str, _FuncFacts],
    caller: _FuncFacts,
    spec: _CallSpec,
) -> Optional[str]:
    if spec.kind == "self" and caller.cls is not None:
        qid = f"{caller.cls.name}.{spec.name}"
        return qid if qid in facts else None
    if spec.kind == "name":
        qid = f"{caller.path}::{spec.name}"
        return qid if qid in facts else None
    if spec.kind == "attr" and caller.cls is not None:
        tname = caller.cls.attr_types.get(spec.extra)
        if tname:
            qid = f"{tname}.{spec.name}"
            if qid in facts:
                return qid
    if spec.kind in ("attr", "name_attr"):
        # unique method name across analyzed classes
        owners = [
            cis[0].name
            for cis in project.classes_by_name.values()
            if len(cis) == 1 and spec.name in cis[0].methods
        ]
        candidates = [
            f"{c}.{spec.name}" for c in owners if f"{c}.{spec.name}" in facts
        ]
        if len(candidates) == 1:
            return candidates[0]
    return None


def _lock_module(project: Project, lock_id: str) -> str:
    cls_name = lock_id.split(".", 1)[0]
    ci = project.find_class(cls_name)
    return ci.module if ci is not None else "?"


def check(project: Project, paths: Optional[List[str]] = None) -> List[Finding]:
    if paths is None:
        paths = sorted(project.modules)
    paths = [p for p in paths if p in project.modules]
    facts = _collect_facts(project, paths)

    # transitive blocking acquisitions per function (fixpoint)
    eff: Dict[str, Set[str]] = {q: set(f.acquires) for q, f in facts.items()}
    resolved: Dict[Tuple[str, int], Optional[str]] = {}
    changed = True
    guard = 0
    while changed and guard < 50:
        changed = False
        guard += 1
        for qid, ff in facts.items():
            for i, (_held, spec, _line) in enumerate(ff.calls):
                key = (qid, i)
                if key not in resolved:
                    resolved[key] = _resolve_call(project, facts, ff, spec)
                callee = resolved[key]
                if callee is None:
                    continue
                add = eff[callee] - eff[qid]
                if add:
                    eff[qid] |= add
                    changed = True

    # edge set: direct nesting + held × callee's effective acquisitions
    edges: Dict[Tuple[str, str], _Edge] = {}
    for qid, ff in facts.items():
        for e in ff.edges:
            edges.setdefault((e.held, e.acquired), e)
        for i, (held, spec, line) in enumerate(ff.calls):
            callee = resolved.get((qid, i))
            if callee is None or not held:
                continue
            for acq in eff[callee]:
                for h in held:
                    if h != acq:
                        edges.setdefault(
                            (h, acq),
                            _Edge(h, acq, ff.path, line,
                                  f"{qid} -> {callee}"),
                        )

    findings: List[Finding] = []

    # ---- cycles: DFS over the edge graph
    graph: Dict[str, Set[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
        graph.setdefault(b, set())
    seen_cycles: Set[FrozenSet[str]] = set()

    def _find_cycle_from(start: str) -> Optional[List[str]]:
        stack = [(start, [start])]
        visited: Set[str] = set()
        while stack:
            node, trail = stack.pop()
            for nxt in graph.get(node, ()):
                if nxt == start:
                    return trail
                if nxt not in visited:
                    visited.add(nxt)
                    stack.append((nxt, trail + [nxt]))
        return None

    for node in sorted(graph):
        cyc = _find_cycle_from(node)
        if cyc is None:
            continue
        key = frozenset(cyc)
        if key in seen_cycles:
            continue
        seen_cycles.add(key)
        # identity (symbol/message/path) built ONLY from the sorted
        # lock set — witness call chains and DFS orderings are
        # unstable under unrelated refactors and live in `note`
        ordered = sorted(cyc)
        witness = edges.get(
            (cyc[0], cyc[1 % len(cyc)])
        ) or next(iter(edges.values()))
        findings.append(
            Finding(
                rule=RULE_CYCLE,
                path=_lock_module(project, ordered[0]),
                line=witness.line,
                symbol=" <-> ".join(ordered),
                message=(
                    "lock-order cycle among "
                    + ", ".join(ordered)
                    + " — two schedules can acquire these in opposite"
                    " orders and deadlock"
                ),
                note="one witness order: "
                + " -> ".join(cyc + [cyc[0]])
                + f" via {witness.via}",
            )
        )

    # ---- cross-module acquire-while-holding
    for (a, b), e in sorted(edges.items()):
        ma, mb = _lock_module(project, a), _lock_module(project, b)
        if ma == mb or "?" in (ma, mb):
            continue
        findings.append(
            Finding(
                rule=RULE_CROSS,
                # anchor to the HELD lock's defining module — stable
                # regardless of which call site witnessed the edge
                path=ma,
                line=e.line,
                symbol=f"{a} -> {b}",
                message=(
                    f"{b} ({mb}) is acquired while holding {a} ({ma}); "
                    f"{mb} must never call back under {a}"
                ),
                note=f"witness: {e.via} at {e.path}:{e.line}",
            )
        )
    return findings
