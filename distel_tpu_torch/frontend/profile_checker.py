"""EL-profile checking: report/strip out-of-profile axioms.

Equivalent of the reference's standalone filter
(``init/ProfileChecker.java:49-112``): classify every axiom as in/out of
the supported EL+ fragment and report the removed kinds, without mutating
the input.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple

from distel_tpu_torch.owl import syntax as S


def expr_in_profile(e: S.ClassExpression) -> bool:
    if isinstance(e, S.UnsupportedClassExpression):
        return False
    if isinstance(e, S.ObjectOneOf):
        return len(e.individuals) == 1
    if isinstance(e, S.ObjectIntersectionOf):
        return all(expr_in_profile(o) for o in e.operands)
    if isinstance(e, S.ObjectSomeValuesFrom):
        return not e.role.iri.startswith("__inverse__:") and expr_in_profile(e.filler)
    return True


def axiom_in_profile(ax: S.Axiom) -> bool:
    if isinstance(ax, S.UnsupportedAxiom):
        return False
    if isinstance(ax, S.SubClassOf):
        return expr_in_profile(ax.sub) and expr_in_profile(ax.sup)
    if isinstance(ax, (S.EquivalentClasses, S.DisjointClasses)):
        return all(expr_in_profile(o) for o in ax.operands)
    if isinstance(ax, S.SubObjectPropertyOf):
        return not any(
            r.iri.startswith("__inverse__:") for r in (*ax.chain, ax.sup)
        )
    if isinstance(ax, S.ReflexiveObjectProperty):
        return False  # outside the CR1-CR6 rule set
    if isinstance(ax, S.ObjectPropertyDomain):
        return expr_in_profile(ax.domain)
    if isinstance(ax, S.ObjectPropertyRange):
        return expr_in_profile(ax.range)
    if isinstance(ax, S.ClassAssertion):
        return expr_in_profile(ax.cls)
    return True


def check_profile(onto: S.Ontology) -> Tuple[int, Counter]:
    """Returns (n_in_profile, Counter of removed kinds) — the report the
    reference prints (``init/ProfileChecker.java:49-112``)."""
    removed: Counter = Counter()
    kept = 0
    for ax in onto.axioms:
        if axiom_in_profile(ax):
            kept += 1
        else:
            kind = ax.kind if isinstance(ax, S.UnsupportedAxiom) else type(ax).__name__
            removed[kind] += 1
    return kept, removed
