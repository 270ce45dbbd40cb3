"""EL+ normalization into the 7 normal forms.

Rebuild of the reference normalizer (``init/Normalizer.java:117-208`` —
two-phase NF1-NF7 stack algorithm) as a single recursive pass with
direction-aware gensym memoization. Output normal forms:

  NF1   A ⊑ B                      (A, B atomic, incl. ⊤ on the left / ⊥ right)
  NF2   A1 ⊓ ... ⊓ An ⊑ B          (n-ary conjunction kept, like the
                                     reference's ZINTERSTORE kernel,
                                     ``base/Type1_2AxiomProcessorBase.java:45-66``)
  NF3   A ⊑ ∃r.B
  NF4   ∃r.A ⊑ B
  NF5   r ⊑ s
  NF6   r ∘ s ⊑ t                   (long chains split, reference
                                     ``init/Normalizer.java:619-637``)

Sugar lowered first (reference :172-208 entry loop):
  * EquivalentClasses → cyclic SubClassOf pairs
  * DisjointClasses   → pairwise Ci ⊓ Cj ⊑ ⊥
  * TransitiveObjectProperty(r) → r ∘ r ⊑ r
  * ObjectPropertyDomain(r, D)  → ∃r.⊤ ⊑ D
  * ClassAssertion / ObjectPropertyAssertion → ABox→TBox conversion
    (reference ``init/Ind2ClassConverter.java:43-81``: individuals become
    classes; sound for EL subsumption because EL has no way to distinguish
    a nominal from a fresh atomic class under these axiom shapes)

Range elimination (reference "EL Envelope Further" rewrite,
``init/Normalizer.java:119-137,455-497``): every *positive* existential
A ⊑ ∃r.B where some super-role s ⊒ r has Range(s, D) is rewritten to
A ⊑ ∃r.X, X ⊑ B, X ⊑ D with X memoized per (B, ranges).  Per the OWL 2 EL
global restriction on range axioms interacting with role chains, applying
ranges over the reflexive-transitive closure of the *plain* role hierarchy
is complete.

Out-of-profile axioms are dropped and counted (reference
``init/Normalizer.java:247-256``, ``getRemovedTypes`` :863).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Tuple

from distel_tpu_torch.owl import syntax as S
from distel_tpu_torch.owl.writer import expr_to_str

Atom = S.ClassExpression  # Class | Individual | OWL_THING | OWL_NOTHING

GENSYM_PREFIX = "distel:gensym#"


def is_atom(e: S.ClassExpression) -> bool:
    return isinstance(e, (S.Class, S.Individual))


@dataclass
class NormalizedOntology:
    """The normalized axiom IR handed to ``core/indexing.py`` — the analog
    of what the reference's AxiomLoader bulk-inserts into Redis, categorized
    by rule type (``init/AxiomLoader.java:495-577``)."""

    nf1: List[Tuple[Atom, Atom]] = field(default_factory=list)
    nf2: List[Tuple[Tuple[Atom, ...], Atom]] = field(default_factory=list)
    nf3: List[Tuple[Atom, S.ObjectProperty, Atom]] = field(default_factory=list)
    nf4: List[Tuple[S.ObjectProperty, Atom, Atom]] = field(default_factory=list)
    nf5: List[Tuple[S.ObjectProperty, S.ObjectProperty]] = field(default_factory=list)
    nf6: List[Tuple[S.ObjectProperty, S.ObjectProperty, S.ObjectProperty]] = field(
        default_factory=list
    )
    #: kinds of axioms/expressions dropped as out-of-profile
    removed: Counter = field(default_factory=Counter)
    #: gensym name → source description (for debugging / cache export)
    gensyms: Dict[str, str] = field(default_factory=dict)

    def axiom_count(self) -> int:
        return (
            len(self.nf1) + len(self.nf2) + len(self.nf3)
            + len(self.nf4) + len(self.nf5) + len(self.nf6)
        )

    def atoms(self) -> set:
        out = {S.OWL_THING, S.OWL_NOTHING}
        for a, b in self.nf1:
            out.add(a); out.add(b)
        for ops, b in self.nf2:
            out.update(ops); out.add(b)
        for a, _, b in self.nf3:
            out.add(a); out.add(b)
        for _, a, b in self.nf4:
            out.add(a); out.add(b)
        return out

    def roles(self) -> set:
        out = set()
        for _, r, _ in self.nf3:
            out.add(r)
        for r, _, _ in self.nf4:
            out.add(r)
        for r, s in self.nf5:
            out.add(r); out.add(s)
        for r, s, t in self.nf6:
            out.add(r); out.add(s); out.add(t)
        return out


class Normalizer:
    def __init__(
        self,
        cache: Optional[Dict[str, str]] = None,
        range_state: Optional[tuple] = None,
    ):
        """``range_state``: ``(ranges, role_edges)`` carried from earlier
        increments (``export_range_state``) so a NEW batch's existentials
        see ranges declared in OLD batches — the reference applies ranges
        at runtime per link insert (``RolePairHandler.java:380-444``),
        which is naturally cross-increment; here the rewrite happens at
        normalize time, so the state must be threaded explicitly."""
        self.out = NormalizedOntology()
        self._gensym_counter = 0
        #: direction-aware memo: (expr-str, 'lhs'|'rhs') → gensym Class.
        #: The persistable equivalent of the reference's in-JVM LRU plus the
        #: shared Redis NORMALIZE_CACHE (``init/Normalizer.java:869-894``)
        #: that lets incremental re-runs reuse gensym names.
        self._memo: Dict[Tuple[str, str], S.Class] = {}
        if cache:
            for k, name in cache.items():
                expr_s, direction = k.rsplit("\x00", 1)
                self._memo[(expr_s, direction)] = S.Class(name)
                idx = int(name[len(GENSYM_PREFIX):])
                self._gensym_counter = max(self._gensym_counter, idx + 1)
        #: role → set of range classes (collected in pass 1)
        self._ranges: Dict[S.ObjectProperty, set] = {}
        #: plain role hierarchy edges for range super-role closure
        self._role_edges: List[Tuple[S.ObjectProperty, S.ObjectProperty]] = []
        self._range_memo: Dict[Tuple[Atom, FrozenSet[Atom]], S.Class] = {}
        self._super_closure: Dict[S.ObjectProperty, set] = {}
        if range_state is not None:
            ranges, edges = range_state
            for role, rs in ranges.items():
                self._ranges.setdefault(role, set()).update(rs)
            self._role_edges.extend(edges)

    # ------------------------------------------------------------------ API

    def normalize(self, onto: S.Ontology) -> NormalizedOntology:
        # pass 1: collect ranges + plain role hierarchy (needed before any
        # NF3 emission so the range rewrite sees the full hierarchy)
        for ax in onto.axioms:
            if isinstance(ax, S.ObjectPropertyRange):
                if self._profile_ok(ax.range) and is_atom_or_top(ax.range):
                    self._ranges.setdefault(ax.role, set()).add(ax.range)
                elif self._profile_ok(ax.range):
                    # complex range: name it, then treat as atomic range
                    a = self._flatten_rhs(ax.range)
                    self._ranges.setdefault(ax.role, set()).add(a)
                else:
                    self.out.removed["ObjectPropertyRange"] += 1
            elif isinstance(ax, S.SubObjectPropertyOf) and len(ax.chain) == 1:
                self._role_edges.append((ax.chain[0], ax.sup))
            elif isinstance(ax, S.EquivalentObjectProperties):
                ops = ax.operands
                for i in range(len(ops)):
                    self._role_edges.append((ops[i], ops[(i + 1) % len(ops)]))
        self._super_closure = _reflexive_transitive_closure(self._role_edges)

        # pass 2: lower + normalize
        for ax in onto.axioms:
            self._lower_axiom(ax)
        return self.out

    def export_cache(self) -> Dict[str, str]:
        """Persistable gensym cache (parity with the Redis NORMALIZE_CACHE)."""
        return {f"{k[0]}\x00{k[1]}": v.iri for k, v in self._memo.items()}

    def export_range_state(self) -> tuple:
        """Carry-over counterpart of :meth:`export_cache` for the range
        machinery: ``(ranges, role_edges)`` to seed the NEXT increment's
        Normalizer (see ``__init__``)."""
        return (
            {r: set(v) for r, v in self._ranges.items()},
            list(self._role_edges),
        )

    def effective_ranges(self, role: S.ObjectProperty) -> FrozenSet[Atom]:
        """R*(role): the ranges of every super-role over the plain-
        hierarchy closure (the set ``_apply_range_rewrite`` conjoins),
        minus ⊤.  Only meaningful after :meth:`normalize` has built the
        closure."""
        out: set = set()
        for sup in self._super_closure.get(role, {role}):
            out.update(self._ranges.get(sup, ()))
        out.discard(S.OWL_THING)
        return frozenset(out)

    def retrofit_ranges(self, old_nf3, old_effective: Dict) -> int:
        """Re-apply range elimination to nf3 rows normalized in EARLIER
        increments whose effective range set has since GROWN (a later
        batch added Range(s, D) with s ⊒ r, or a hierarchy edge under a
        range-bearing role).  Append-only: for each affected old row
        A ⊑ ∃r.F this emits A ⊑ ∃r.X, X ⊑ F, X ⊑ D into THIS batch's
        output — the old row stays (sound: its consequences remain
        entailed) and the new row carries the range conjunct, exactly
        the reference's runtime re-emit on live stores
        (``RolePairHandler.java:380-444``).  Returns the number of rows
        retrofitted.  Call after :meth:`normalize`."""
        if not self._ranges:
            # range-free workloads (the common case) skip the
            # O(|accumulated nf3|) walk entirely: effective sets are
            # monotone, so no current ranges ⇒ none before either
            return 0
        changed: Dict[S.ObjectProperty, bool] = {}
        n = 0
        for a, role, f in old_nf3:
            if role not in changed:
                changed[role] = self.effective_ranges(
                    role
                ) != old_effective.get(role, frozenset())
            if changed[role]:
                x = self._apply_range_rewrite(role, f)
                if x is not f:
                    self.out.nf3.append((a, role, x))
                    n += 1
        return n

    def save_cache(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export_cache(), f)

    @staticmethod
    def load_cache(path: str) -> Dict[str, str]:
        with open(path) as f:
            return json.load(f)

    # ------------------------------------------------------------- lowering

    def _lower_axiom(self, ax: S.Axiom) -> None:
        if isinstance(ax, S.SubClassOf):
            if self._profile_ok(ax.sub) and self._profile_ok(ax.sup):
                self._emit_sub(ax.sub, ax.sup)
            else:
                self.out.removed["SubClassOf(non-EL)"] += 1
        elif isinstance(ax, S.EquivalentClasses):
            ops = [o for o in ax.operands]
            if not all(self._profile_ok(o) for o in ops):
                self.out.removed["EquivalentClasses(non-EL)"] += 1
                return
            n = len(ops)
            for i in range(n):
                self._emit_sub(ops[i], ops[(i + 1) % n])
        elif isinstance(ax, S.DisjointClasses):
            ops = list(ax.operands)
            if not all(self._profile_ok(o) for o in ops):
                self.out.removed["DisjointClasses(non-EL)"] += 1
                return
            for i in range(len(ops)):
                for j in range(i + 1, len(ops)):
                    self._emit_sub(
                        S.ObjectIntersectionOf((ops[i], ops[j])), S.OWL_NOTHING
                    )
        elif isinstance(ax, S.SubObjectPropertyOf):
            self._lower_role_inclusion(list(ax.chain), ax.sup)
        elif isinstance(ax, S.EquivalentObjectProperties):
            ops = ax.operands
            for i in range(len(ops)):
                self.out.nf5.append((ops[i], ops[(i + 1) % len(ops)]))
        elif isinstance(ax, S.TransitiveObjectProperty):
            self.out.nf6.append((ax.role, ax.role, ax.role))
        elif isinstance(ax, S.ReflexiveObjectProperty):
            # ε ⊑ r is outside the CR1-CR6 rule set the reference implements
            self.out.removed["ReflexiveObjectProperty"] += 1
        elif isinstance(ax, S.ObjectPropertyDomain):
            if self._profile_ok(ax.domain):
                self._emit_sub(
                    S.ObjectSomeValuesFrom(ax.role, S.OWL_THING), ax.domain
                )
            else:
                self.out.removed["ObjectPropertyDomain(non-EL)"] += 1
        elif isinstance(ax, S.ObjectPropertyRange):
            pass  # handled in pass 1 / NF3 rewrite
        elif isinstance(ax, S.ClassAssertion):
            if self._profile_ok(ax.cls):
                self._emit_sub(ax.individual, ax.cls)
            else:
                self.out.removed["ClassAssertion(non-EL)"] += 1
        elif isinstance(ax, S.ObjectPropertyAssertion):
            self._emit_sub(
                ax.subject, S.ObjectSomeValuesFrom(ax.role, ax.object)
            )
        elif isinstance(ax, S.UnsupportedAxiom):
            self.out.removed[ax.kind] += 1
        else:
            self.out.removed[type(ax).__name__] += 1

    def _lower_role_inclusion(
        self, chain: List[S.ObjectProperty], sup: S.ObjectProperty
    ) -> None:
        if any(r.iri.startswith("__inverse__:") for r in chain + [sup]):
            self.out.removed["SubObjectPropertyOf(inverse)"] += 1
            return
        if len(chain) == 1:
            self.out.nf5.append((chain[0], sup))
        elif len(chain) == 2:
            self.out.nf6.append((chain[0], chain[1], sup))
        else:
            # r1∘...∘rn ⊑ s  →  r1∘r2 ⊑ u1, u1∘r3 ⊑ u2, ..., u(n-2)∘rn ⊑ s
            # (reference splits left-associatively, init/Normalizer.java:619-637)
            acc = chain[0]
            for i in range(1, len(chain) - 1):
                u = self._gensym_role(f"{acc.iri}*{chain[i].iri}")
                self.out.nf6.append((acc, chain[i], u))
                acc = u
            self.out.nf6.append((acc, chain[-1], sup))

    def _profile_ok(self, e: S.ClassExpression) -> bool:
        if isinstance(e, S.UnsupportedClassExpression):
            return False
        if isinstance(e, S.ObjectOneOf):
            return len(e.individuals) == 1
        if isinstance(e, S.ObjectIntersectionOf):
            return all(self._profile_ok(o) for o in e.operands)
        if isinstance(e, S.ObjectSomeValuesFrom):
            return (not e.role.iri.startswith("__inverse__:")) and self._profile_ok(
                e.filler
            )
        return True

    # -------------------------------------------------------- normalization

    def _emit_sub(self, c: S.ClassExpression, d: S.ClassExpression) -> None:
        c = _simplify(c)
        d = _simplify(d)
        # trivial cases
        if c is S.OWL_NOTHING or d is S.OWL_THING:
            return
        if _lhs_unsatisfiable(c):
            return  # e.g. ∃r.⊥ ⊑ D, A ⊓ ⊥ ⊑ D — vacuously true
        # RHS conjunction splits (NF7, reference :775-784)
        if isinstance(d, S.ObjectIntersectionOf):
            for op in d.operands:
                self._emit_sub(c, op)
            return
        # both sides complex (NF5, reference :734-743)
        if not is_atom_or_top(c) and not is_atom_or_bottom(d):
            a = self._flatten_lhs(c)
            self._emit_sub(a, d)
            return
        # LHS cases
        if is_atom_or_top(c):
            if is_atom_or_bottom(d):
                self.out.nf1.append((c, d))
            elif isinstance(d, S.ObjectSomeValuesFrom):
                filler = _simplify(d.filler)
                if filler is S.OWL_NOTHING:
                    # A ⊑ ∃r.⊥ forces A ⊑ ⊥
                    self.out.nf1.append((c, S.OWL_NOTHING))
                    return
                b = filler if is_atom_or_top(filler) else self._flatten_rhs(filler)
                b = self._apply_range_rewrite(d.role, b)
                self.out.nf3.append((c, d.role, b))
            else:
                raise AssertionError(f"unexpected RHS {d!r}")
        elif isinstance(c, S.ObjectIntersectionOf):
            ops = []
            for op in c.operands:
                op = _simplify(op)
                if op is S.OWL_THING:
                    continue
                ops.append(op if is_atom(op) else self._flatten_lhs(op))
            if not ops:
                self._emit_sub(S.OWL_THING, d)
            elif len(ops) == 1:
                self._emit_sub(ops[0], d)
            else:
                assert is_atom_or_bottom(d)
                self.out.nf2.append((tuple(ops), d))
        elif isinstance(c, S.ObjectSomeValuesFrom):
            filler = _simplify(c.filler)
            a = filler if is_atom_or_top(filler) else self._flatten_lhs(filler)
            assert is_atom_or_bottom(d)
            self.out.nf4.append((c.role, a, d))
        else:
            raise AssertionError(f"unexpected LHS {c!r}")

    def _flatten_lhs(self, e: S.ClassExpression) -> S.Class:
        """Atomic A with (e ⊑ A) emitted — for complex subexpressions in
        negative positions (NF2/NF3-left of the reference, :647-718)."""
        key = (expr_to_str(e), "lhs")
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        a = self._gensym(key[0])
        self._memo[key] = a
        self._emit_sub(e, a)
        return a

    def _flatten_rhs(self, e: S.ClassExpression) -> S.Class:
        """Atomic A with (A ⊑ e) emitted — for complex fillers in positive
        positions (NF6 of the reference, :750-768)."""
        key = (expr_to_str(e), "rhs")
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        a = self._gensym(key[0])
        self._memo[key] = a
        self._emit_sub(a, e)
        return a

    def _apply_range_rewrite(self, role: S.ObjectProperty, b: Atom) -> Atom:
        ranges: set = set()
        for sup in self._super_closure.get(role, {role}):
            ranges.update(self._ranges.get(sup, ()))
        ranges.discard(S.OWL_THING)
        ranges.discard(b)
        if not ranges:
            return b
        key = (b, frozenset(ranges))
        hit = self._range_memo.get(key)
        if hit is not None:
            return hit
        # persistable twin of ``key``: range gensyms must enter the SAME
        # exported cache as every other gensym — an unexported name lets
        # the next increment's restored counter re-mint it for a
        # DIFFERENT concept, silently merging the two (unsound).  A
        # cache hit (cross-process restore) reuses the name without
        # re-emitting its defining rows, like ``_flatten_rhs``: the
        # cache contract is that the rows live in the accumulated
        # corpus the cache came from.
        ckey = (
            expr_to_str(b)
            + "\x01"
            + ",".join(sorted(expr_to_str(d) for d in ranges)),
            "range",
        )
        x = self._memo.get(ckey)
        if x is not None:
            self._range_memo[key] = x
            return x
        x = self._gensym(f"range({role.iri},{expr_to_str(b)})")
        self._memo[ckey] = x
        self._range_memo[key] = x
        if b is not S.OWL_THING:
            self.out.nf1.append((x, b))
        for d in sorted(ranges, key=expr_to_str):
            self.out.nf1.append((x, d))
        return x

    def _gensym(self, source: str) -> S.Class:
        name = f"{GENSYM_PREFIX}{self._gensym_counter}"
        self._gensym_counter += 1
        self.out.gensyms[name] = source
        return S.Class(name)

    def _gensym_role(self, source: str) -> S.ObjectProperty:
        name = f"distel:genrole#{self._gensym_counter}"
        self._gensym_counter += 1
        self.out.gensyms[name] = source
        return S.ObjectProperty(name)


# ------------------------------------------------------------------ helpers


def is_atom_or_top(e: S.ClassExpression) -> bool:
    return is_atom(e) or e is S.OWL_THING or e == S.OWL_THING


def is_atom_or_bottom(e: S.ClassExpression) -> bool:
    return is_atom(e) or e is S.OWL_NOTHING or e == S.OWL_NOTHING


def _simplify(e: S.ClassExpression) -> S.ClassExpression:
    """Collapse singleton nominals to individuals; flatten nested
    intersections; dedupe operands."""
    if isinstance(e, S.ObjectOneOf):
        assert len(e.individuals) == 1
        return e.individuals[0]
    if isinstance(e, S.ObjectIntersectionOf):
        flat: List[S.ClassExpression] = []
        seen = set()
        stack = list(e.operands)
        while stack:
            op = _simplify(stack.pop(0))
            if isinstance(op, S.ObjectIntersectionOf):
                stack = list(op.operands) + stack
                continue
            k = expr_to_str(op)
            if k not in seen:
                seen.add(k)
                flat.append(op)
        if len(flat) == 1:
            return flat[0]
        return S.ObjectIntersectionOf(tuple(flat))
    if isinstance(e, S.ObjectSomeValuesFrom):
        return S.ObjectSomeValuesFrom(e.role, _simplify(e.filler))
    return e


def _lhs_unsatisfiable(c: S.ClassExpression) -> bool:
    """Syntactically unsatisfiable LHS → axiom is vacuous."""
    if c is S.OWL_NOTHING or c == S.OWL_NOTHING:
        return True
    if isinstance(c, S.ObjectIntersectionOf):
        return any(_lhs_unsatisfiable(o) for o in c.operands)
    if isinstance(c, S.ObjectSomeValuesFrom):
        return _lhs_unsatisfiable(c.filler)
    return False


def _reflexive_transitive_closure(
    edges: List[Tuple[S.ObjectProperty, S.ObjectProperty]]
) -> Dict[S.ObjectProperty, set]:
    adj: Dict[S.ObjectProperty, set] = {}
    for r, s in edges:
        adj.setdefault(r, set()).add(s)
        adj.setdefault(s, set())
    closure: Dict[S.ObjectProperty, set] = {}
    for start in adj:
        seen = {start}
        frontier = [start]
        while frontier:
            cur = frontier.pop()
            for nxt in adj.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        closure[start] = seen
    return closure


def normalize(onto: S.Ontology, cache: Optional[Dict[str, str]] = None) -> NormalizedOntology:
    return Normalizer(cache).normalize(onto)
