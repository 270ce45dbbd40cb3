"""Rule 2: captured purity, the port's form of the reference's
traced-purity / bucket-invariant lint.

The reference's contract is "a traced program is a pure function of
``bucket_signature``" (PR 2 of the reference).  The port runs its step
programs as CUDA graphs, and its contract reads: a captured step
program is a function of its tables only.  A graph keeps the ADDRESSES
its capture saw and replays no Python: a tensor attribute the owner
rebinds after the capture is read at its old address, a host read
inside the body fails the capture (or, outside one, silently syncs
every step), and a Python branch on a tensor is decided once, at
capture time, for every replay.  No test fails on any of these until
a rebind or a data-dependent branch meets a replay.

The roots are the functions called in the body of a ``with
torch.cuda.graph(...)`` block, and the rule follows what they call
within the module (``self.x()``, bare names, function-valued
arguments, and ``self.<attr>(...)`` where ``<attr>`` holds an instance
of a class the module defines: its ``__call__``).  Three checks:

* ``traced-closure-capture`` — reads of ``self.<attr>`` where the class
  assigns that attr an array expression outside ``__init__`` (a
  rebind after the capture), UNLESS the read is the documented
  fallback idiom (guarded by ``<param> is None`` or by a ``self._bucket``
  branch);
* ``traced-host-sync`` — ``float()``/``int()``/``bool()`` /
  ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
  ``np.asarray`` applied to a tensor;
* ``traced-python-branch`` — Python ``if``/``while`` on a tensor.

"Tensor" is a per-function taint set: the root's parameters (minus
``self``), what a call site passes a tensor into, anything assigned
from an expression that mentions a tainted name, calls into ``torch``,
or reads a ``self`` attribute some class of the module assigns an
array expression; ``.shape``/``.dtype``/``.device``/``.size()``/
``len()`` launder the taint (static at capture).  Host-side controller
code is never reached from a capture root, which keeps its legitimate
host reads out of the signal.  The three rule ids are the
reference's, so a baseline reads the same.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from distel_tpu_torch.analysis.findings import Finding
from distel_tpu_torch.analysis.project import Module, Project, _call_target

RULE_CAPTURE = "traced-closure-capture"
RULE_SYNC = "traced-host-sync"
RULE_BRANCH = "traced-python-branch"

#: context managers whose body is captured into a CUDA graph
_CAPTURE_HEADS = {("torch", "cuda", "graph"), ("cuda", "graph")}

#: receivers whose module taints a call result / marks device compute
_TRACED_MODULES = {"torch"}

#: taint-laundering attribute reads (static at capture)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}

#: taint-laundering tensor methods (their results are host ints)
_STATIC_METHODS = {"size", "dim", "numel", "element_size", "stride",
                   "data_ptr", "is_contiguous"}

#: tensor methods that read the device from the host
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}

_HOST_CASTS = {"float", "int", "bool", "complex"}


def _func_index(module: Module):
    """Qualified name → (node, owner-class-name | None) for every
    function in the module, including nested defs (``Class.meth``,
    ``Class.meth.<fn>``, ``func``)."""
    out: Dict[str, Tuple[ast.AST, Optional[str]]] = {}

    def walk_fn(node, prefix: str, owner: Optional[str]):
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qid = f"{prefix}{sub.name}"
                out[qid] = (sub, owner)
                walk_fn(sub, qid + ".", owner)
            elif not isinstance(sub, ast.ClassDef):
                walk_fn(sub, prefix, owner)

    for node in module.tree.body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    qid = f"{node.name}.{item.name}"
                    out[qid] = (item, node.name)
                    walk_fn(item, qid + ".", node.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = (node, None)
            walk_fn(node, node.name + ".", None)
    return out


def _is_capture_with(node) -> bool:
    """Is this ``with`` block a CUDA graph capture?"""
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call) and _call_target(ctx) in _CAPTURE_HEADS:
            return True
    return False


class _RootCollector(ast.NodeVisitor):
    """Find capture roots in a module: the functions called in the body
    of a ``with torch.cuda.graph(...)`` block (lambdas resolved through
    their bodies), with the positions their calls there pass literals
    to (the reference's jit roots' ``static_argnums``)."""

    def __init__(self):
        #: (owner-class-or-None, bare function name) → static argnums
        self.roots: Dict[Tuple[Optional[str], str], Set[int]] = {}
        self._class: Optional[str] = None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._class = self._class, node.name
        self.generic_visit(node)
        self._class = prev

    def visit_With(self, node: ast.With) -> None:
        if _is_capture_with(node):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        # a literal argument is a host value at capture,
                        # as a jit root's static argnum is under trace
                        statics = {
                            i for i, arg in enumerate(sub.args)
                            if isinstance(arg, ast.Constant)
                        }
                        self._root_arg(sub.func, statics)
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    def _root_arg(self, arg: ast.expr, statics: Set[int]) -> None:
        if isinstance(arg, ast.Lambda):
            for sub in ast.walk(arg.body):
                if isinstance(sub, ast.Call):
                    self._root_arg(sub.func, set())
            return
        if isinstance(arg, ast.Attribute) and isinstance(
            arg.value, ast.Name
        ) and arg.value.id == "self":
            self.roots[(self._class, arg.attr)] = statics
        elif isinstance(arg, ast.Name):
            # local nested def or module function — key by bare name
            # under the current class scope first, module scope second
            self.roots[(self._class, arg.id)] = statics
            self.roots[(None, arg.id)] = statics


def _instance_attrs(module: Module) -> Dict[Tuple[str, str], str]:
    """``(class, attr) → class name`` for ``self.<attr> = C(...)`` or
    ``self.<attr> = self.m(...)`` with ``m`` returning ``C(...)``, where
    ``C`` is a class of this module: a call ``self.<attr>(...)`` runs
    ``C.__call__``."""
    out: Dict[Tuple[str, str], str] = {}
    classes = set(module.classes)

    def built(value) -> Optional[str]:
        tgt = _call_target(value) if isinstance(value, ast.Call) else None
        return tgt[-1] if tgt and tgt[-1] in classes else None

    def made(value, ci) -> Optional[str]:
        cls = built(value)
        tgt = _call_target(value) if isinstance(value, ast.Call) else None
        if cls is None and tgt and len(tgt) == 2 and tgt[0] == "self":
            meth = ci.methods.get(tgt[1])
            for sub in ast.walk(meth) if meth is not None else ():
                if isinstance(sub, ast.Return) and sub.value is not None:
                    cls = cls or built(sub.value)
        return cls

    for name, ci in module.classes.items():
        for sub in ast.walk(ci.node):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                if (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    cls = made(sub.value, ci)
                    if cls:
                        out[(name, tgt.attr)] = cls
    return out


def _is_tensor_expr(node: ast.expr) -> bool:
    """Does this expression build a tensor (a ``torch.*`` call, or a
    method chained on one: ``torch.as_tensor(x).to(dev)``)?"""
    if isinstance(node, ast.Call):
        tgt = _call_target(node)
        if tgt and tgt[0] in _TRACED_MODULES:
            return True
        if isinstance(node.func, ast.Attribute):
            return _is_tensor_expr(node.func.value)
    return False


def _tensor_attrs(ci, skip_init: bool = False) -> Set[str]:
    """Attributes a class assigns a tensor expression (outside its
    ``__init__`` with ``skip_init``: rebound after a capture may have
    kept the old one)."""
    out: Set[str] = set()
    for mname, meth in ci.methods.items():
        if skip_init and mname == "__init__":
            continue
        for sub in ast.walk(meth):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)) and sub.value is not None:
                targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                for tgt in targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                            and _is_tensor_expr(sub.value)):
                        out.add(tgt.attr)
    return out


def _reached(module: Module, funcs, roots):
    """Transitively reached functions from the jit roots via
    ``self.x()`` / bare-name calls inside the module.  Returns
    ``(traced: qid → root static argnums, root_qids)`` — only roots
    carry static argnums; non-root reached functions are tainted from
    their call sites instead."""
    by_key: Dict[Tuple[Optional[str], str], List[str]] = {}
    for qid, (_node, owner) in funcs.items():
        bare = qid.rsplit(".", 1)[-1]
        by_key.setdefault((owner, bare), []).append(qid)
        by_key.setdefault((None, bare), []).append(qid)

    # pre-seed EVERY root with its static argnums before expanding:
    # a root reached first as another root's callee must not have its
    # statics clobbered by the empty callee entry (the static param
    # would read as tainted and fire bogus branch/sync findings)
    instances = _instance_attrs(module)
    root_qids: Set[str] = set()
    traced: Dict[str, Set[int]] = {}
    for key, statics in roots.items():
        for qid in by_key.get(key, []):
            traced[qid] = traced.get(qid, set()) | set(statics)
            root_qids.add(qid)
    expanded: Set[str] = set()
    work: List[str] = list(traced)
    while work:
        qid = work.pop()
        if qid in expanded:
            continue
        expanded.add(qid)
        node, owner = funcs[qid]
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            callee_keys = []
            fn = sub.func
            if isinstance(fn, ast.Attribute) and isinstance(
                fn.value, ast.Name
            ) and fn.value.id == "self":
                callee_keys.append((owner, fn.attr))
                cls = instances.get((owner, fn.attr))
                if cls is not None:
                    callee_keys.append((cls, "__call__"))
            elif isinstance(fn, ast.Name):
                key = (owner, fn.id)
                callee_keys.append(
                    key if key in by_key else (None, fn.id)
                )
            # function-valued arguments (a branch body handed to a
            # helper) run captured too
            for arg in sub.args:
                if isinstance(arg, ast.Name):
                    key = (owner, arg.id)
                    if key in by_key:
                        callee_keys.append(key)
            for callee_key in callee_keys:
                for cq in by_key.get(callee_key, []):
                    if cq not in traced:
                        traced[cq] = set()
                    if cq not in expanded:
                        work.append(cq)
    return traced, root_qids, by_key, instances


def _seed_taints(funcs, traced, root_qids, by_key,
                 instances=None, base=frozenset()) -> Dict[str, Set[str]]:
    """Per-function seed taint.  Roots taint every parameter (minus
    ``self`` and jit static argnums — the values jit feeds are
    tracers); non-root reached functions taint only the parameters
    their call sites actually pass tainted expressions into — the
    host-side plan builders a traced function calls AT TRACE TIME with
    static arguments stay untainted, which is what keeps trace-time
    Python (shape planning, table selection) out of the signal."""
    instances = instances or {}
    seeds: Dict[str, Set[str]] = {}
    for qid in traced:
        node, _owner = funcs[qid]
        params = _params(node)
        if qid in root_qids:
            statics = traced[qid]
            # static_argnums index the signature jit actually sees:
            # for a jit over the BOUND method (jax.jit(self._kern)),
            # that signature excludes self — offset the def's params
            off = 1 if params[:1] == ["self"] else 0
            static_names = {
                params[i + off]
                for i in statics
                if i + off < len(params)
            }
            seeds[qid] = set(params) - {"self"} - static_names
        else:
            seeds[qid] = set()
    for _ in range(4):  # cross-function fixpoint
        changed = False
        for qid in traced:
            node, owner = funcs[qid]
            local = _local_taint(node, seeds[qid] | base)
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                fn = sub.func
                skip_self = False
                if isinstance(fn, ast.Attribute) and isinstance(
                    fn.value, ast.Name
                ) and fn.value.id == "self":
                    key = (owner, fn.attr)
                    if key not in by_key and (owner, fn.attr) in instances:
                        key = (instances[(owner, fn.attr)], "__call__")
                    skip_self = True
                elif isinstance(fn, ast.Name):
                    key = (owner, fn.id)
                    if key not in by_key:
                        key = (None, fn.id)
                else:
                    continue
                for cq in by_key.get(key, []):
                    if cq not in traced:
                        continue
                    cparams = _params(funcs[cq][0])
                    if skip_self and cparams[:1] == ["self"]:
                        cparams = cparams[1:]
                    for i, arg in enumerate(sub.args):
                        if i < len(cparams) and _mentions_tainted(
                            arg, local
                        ):
                            if cparams[i] not in seeds[cq]:
                                seeds[cq].add(cparams[i])
                                changed = True
                    for kw in sub.keywords:
                        if kw.arg and kw.arg in cparams and \
                                _mentions_tainted(kw.value, local):
                            if kw.arg not in seeds[cq]:
                                seeds[cq].add(kw.arg)
                                changed = True
        if not changed:
            break
    return seeds


def _params(node) -> List[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


_LAUNDER_CALLS = {"len", "isinstance", "hasattr", "callable", "range",
                  "type"}


def _mentions_tainted(node: ast.expr, tainted: Set[str]) -> bool:
    """Does this expression carry a traced value?  ``.shape`` /
    ``.dtype`` / ``len()`` subtrees launder the taint — they are
    static under trace."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False  # static metadata read — whole subtree laundered
    if isinstance(node, ast.Attribute) and "." + node.attr in tainted:
        base = node.value
        while isinstance(base, ast.Attribute):
            base = base.value
        if isinstance(base, ast.Name) and base.id == "self":
            return True  # a tensor attribute of a class of the module
    if isinstance(node, ast.Call):
        tgt = _call_target(node)
        if tgt and len(tgt) == 1 and tgt[0] in _LAUNDER_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) and node.func.attr in _STATIC_METHODS:
            return False  # x.size(0), x.numel(): host ints
        if tgt and tgt[0] in _TRACED_MODULES:
            return True
    return any(
        _mentions_tainted(child, tainted)
        for child in ast.iter_child_nodes(node)
        if isinstance(child, (ast.expr, ast.keyword))
        or isinstance(child, ast.comprehension)
    )


def _is_host_key(node: ast.expr) -> bool:
    """A string key: a literal, an f-string, or a literal joined to
    something (``"act" + key``)."""
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _is_host_key(node.left) or _is_host_key(node.right)
    return False


def _guarded_by_fallback(
    ancestors: List[ast.AST], params: Set[str]
) -> bool:
    """Is this site inside a ``<param> is None`` guard or a
    ``self._bucket`` conditional — the legitimate non-bucketed
    fallback idiom?"""
    for anc in ancestors:
        test = None
        if isinstance(anc, (ast.If, ast.IfExp)):
            test = anc.test
        if test is None:
            continue
        for sub in ast.walk(test):
            if isinstance(sub, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops
            ):
                names = [
                    n.id
                    for n in ast.walk(sub)
                    if isinstance(n, ast.Name)
                ]
                if any(n in params for n in names):
                    return True
            if isinstance(sub, ast.Attribute) and "bucket" in sub.attr:
                return True
    return False


def _local_taint(node, seed: Set[str]) -> Set[str]:
    """Seed taint + forward assignment fixpoint within one function."""
    tainted = set(seed)
    for _ in range(4):  # small fixpoint: taint flows forward
        before = len(tainted)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                if _mentions_tainted(sub.value, tainted):
                    for tgt in sub.targets:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                if sub.value is not None and _mentions_tainted(
                    sub.value, tainted
                ):
                    for n in ast.walk(sub.target):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
        if len(tainted) == before:
            break
    return tainted


class _PurityWalker:
    """Per-traced-function checks (iterative walk keeping the ancestor
    chain for guard detection)."""

    def __init__(
        self,
        path: str,
        qid: str,
        node,
        seed_taint: Set[str],
        array_attrs: Set[str],
        findings: List[Finding],
    ):
        self.path = path
        self.qid = qid
        self.node = node
        self.array_attrs = array_attrs
        self.findings = findings
        self.param_names = set(_params(node))
        self.tainted: Set[str] = set(seed_taint)

    def run(self) -> None:
        self.tainted = _local_taint(self.node, self.tainted)
        self._walk(self.node, [])

    def _walk(self, node: ast.AST, ancestors: List[ast.AST]) -> None:
        for sub in ast.iter_child_nodes(node):
            self._visit(sub, ancestors)
            self._walk(sub, ancestors + [sub])

    def _visit(self, sub: ast.AST, ancestors: List[ast.AST]) -> None:
        # ---- closure capture of ontology arrays
        if (
            isinstance(sub, ast.Attribute)
            and isinstance(sub.value, ast.Name)
            and sub.value.id == "self"
            and sub.attr in self.array_attrs
            and not _guarded_by_fallback(
                ancestors + [sub], self.param_names
            )
        ):
            self.findings.append(
                Finding(
                    rule=RULE_CAPTURE,
                    path=self.path,
                    line=sub.lineno,
                    symbol=f"{self.qid}:self.{sub.attr}",
                    message=(
                        f"captured function reads self.{sub.attr}, a "
                        "tensor its class rebinds — a graph replays "
                        "the address its capture saw; a step program "
                        "must own its tables and copy new content in"
                    ),
                )
            )
        # ---- host syncs
        if isinstance(sub, ast.Call):
            tgt = _call_target(sub)
            if (
                tgt
                and len(tgt) == 1
                and tgt[0] in _HOST_CASTS
                and sub.args
                and _mentions_tainted(sub.args[0], self.tainted)
            ):
                self._sync(sub, f"{tgt[0]}()")
            elif (
                tgt
                and tgt[-1] in ("asarray", "array")
                and tgt[0] == "np"
                and sub.args
                and _mentions_tainted(sub.args[0], self.tainted)
            ):
                self._sync(sub, "np." + tgt[-1])
            elif (
                isinstance(sub.func, ast.Attribute)
                and sub.func.attr in _SYNC_METHODS
                and _mentions_tainted(sub.func.value, self.tainted)
            ):
                self._sync(sub, f".{sub.func.attr}()")
        # ---- python branching on traced values
        if isinstance(sub, (ast.If, ast.While)):
            test = sub.test
            if self._value_branch(test):
                self.findings.append(
                    Finding(
                        rule=RULE_BRANCH,
                        path=self.path,
                        line=sub.lineno,
                        symbol=f"{self.qid}",
                        message=(
                            "Python branch on a tensor "
                            f"({ast.unparse(test)[:60]!r}) — a graph "
                            "replays the branch its capture took; use "
                            "torch.where or a conditional graph node"
                        ),
                    )
                )

    def _value_branch(self, test: ast.expr) -> bool:
        # `x is None` / `x is not None` tests are structural, not value
        if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
        ):
            return False
        # `"act" + key in plan`: membership of a host key in a dict of
        # tensors is structure, static at capture
        if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn)) for op in test.ops
        ) and (_is_host_key(test.left)
               or not _mentions_tainted(test.left, self.tainted)):
            return False
        if isinstance(test, ast.BoolOp):
            return any(self._value_branch(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(
            test.op, ast.Not
        ):
            return self._value_branch(test.operand)
        # laundered reads (.shape/len) are static
        if isinstance(test, ast.Call):
            tgt = _call_target(test)
            if tgt and tgt[-1] in ("len", "isinstance", "hasattr",
                                   "callable"):
                return False
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
                return False
        return _mentions_tainted(test, self.tainted)

    def _sync(self, node: ast.Call, what: str) -> None:
        self.findings.append(
            Finding(
                rule=RULE_SYNC,
                path=self.path,
                line=node.lineno,
                symbol=f"{self.qid}:{what}",
                message=(
                    f"{what} on a tensor inside a captured function "
                    "reads the device from the host (a failed capture, "
                    "or a sync every step uncaptured) — keep the value "
                    "on the device or move the read to the controller"
                ),
            )
        )


def check(project: Project, paths: Optional[List[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    if paths is None:
        paths = sorted(project.modules)
    for path in paths:
        module = project.modules.get(path)
        if module is None:
            continue
        funcs = _func_index(module)
        collector = _RootCollector()
        collector.visit(module.tree)
        if not collector.roots:
            continue
        traced, root_qids, by_key, instances = _reached(
            module, funcs, collector.roots
        )
        # a self attribute some class here assigns a tensor is a
        # tensor wherever it is read (".<attr>" in a taint set)
        tensor_attrs = {
            "." + a for ci in module.classes.values() for a in _tensor_attrs(ci)
        }
        seeds = _seed_taints(funcs, traced, root_qids, by_key, instances,
                             tensor_attrs)
        for qid in sorted(traced):
            node, owner = funcs[qid]
            array_attrs: Set[str] = set()
            if owner is not None:
                ci = module.classes.get(owner)
                if ci is not None:
                    array_attrs = _tensor_attrs(ci, skip_init=True)
            _PurityWalker(
                path, qid, node, seeds.get(qid, set()) | tensor_attrs,
                array_attrs, findings,
            ).run()
    # dedupe identical (rule, symbol, message) repeats at different
    # lines (a loop-unrolled pattern fires once, not N times)
    seen: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        fp = f.fingerprint()
        if fp not in seen:
            seen.add(fp)
            out.append(f)
    return out
