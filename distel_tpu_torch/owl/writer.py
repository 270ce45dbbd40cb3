"""Serialize the EL AST back to OWL functional syntax.

Used by corpus tools (``frontend/ontology_tools.py``, the equivalents of the
reference's ``init/OntologyModifier.java`` / ``samples/OntologyMultiplier.java``)
and to dump normalized ontologies for inspection, matching the reference's
standalone Normalizer main (``init/Normalizer.java:896-943``).
"""

from __future__ import annotations

from typing import Iterable

from distel_tpu_torch.owl import syntax as S


def _iri(s: str) -> str:
    if s.startswith("owl:") or ":" not in s:
        return s
    return f"<{s}>"


def expr_to_str(e: S.ClassExpression) -> str:
    if isinstance(e, S.Class):
        return _iri(e.iri)
    if isinstance(e, S.Individual):
        return _iri(e.iri)
    if isinstance(e, S.ObjectIntersectionOf):
        return "ObjectIntersectionOf(" + " ".join(expr_to_str(o) for o in e.operands) + ")"
    if isinstance(e, S.ObjectSomeValuesFrom):
        return f"ObjectSomeValuesFrom({_iri(e.role.iri)} {expr_to_str(e.filler)})"
    if isinstance(e, S.ObjectOneOf):
        return "ObjectOneOf(" + " ".join(_iri(i.iri) for i in e.individuals) + ")"
    if isinstance(e, S.UnsupportedClassExpression):
        return f"{e.constructor}(...)"
    raise TypeError(f"cannot serialize {e!r}")


def axiom_to_str(ax: S.Axiom) -> str:
    if isinstance(ax, S.SubClassOf):
        return f"SubClassOf({expr_to_str(ax.sub)} {expr_to_str(ax.sup)})"
    if isinstance(ax, S.EquivalentClasses):
        return "EquivalentClasses(" + " ".join(expr_to_str(o) for o in ax.operands) + ")"
    if isinstance(ax, S.DisjointClasses):
        return "DisjointClasses(" + " ".join(expr_to_str(o) for o in ax.operands) + ")"
    if isinstance(ax, S.SubObjectPropertyOf):
        if len(ax.chain) == 1:
            return f"SubObjectPropertyOf({_iri(ax.chain[0].iri)} {_iri(ax.sup.iri)})"
        chain = " ".join(_iri(r.iri) for r in ax.chain)
        return f"SubObjectPropertyOf(ObjectPropertyChain({chain}) {_iri(ax.sup.iri)})"
    if isinstance(ax, S.EquivalentObjectProperties):
        return "EquivalentObjectProperties(" + " ".join(_iri(r.iri) for r in ax.operands) + ")"
    if isinstance(ax, S.TransitiveObjectProperty):
        return f"TransitiveObjectProperty({_iri(ax.role.iri)})"
    if isinstance(ax, S.ReflexiveObjectProperty):
        return f"ReflexiveObjectProperty({_iri(ax.role.iri)})"
    if isinstance(ax, S.ObjectPropertyDomain):
        return f"ObjectPropertyDomain({_iri(ax.role.iri)} {expr_to_str(ax.domain)})"
    if isinstance(ax, S.ObjectPropertyRange):
        return f"ObjectPropertyRange({_iri(ax.role.iri)} {expr_to_str(ax.range)})"
    if isinstance(ax, S.ClassAssertion):
        return f"ClassAssertion({expr_to_str(ax.cls)} {_iri(ax.individual.iri)})"
    if isinstance(ax, S.ObjectPropertyAssertion):
        return (
            f"ObjectPropertyAssertion({_iri(ax.role.iri)} "
            f"{_iri(ax.subject.iri)} {_iri(ax.object.iri)})"
        )
    if isinstance(ax, S.UnsupportedAxiom):
        return f"# unsupported: {ax.kind}"
    raise TypeError(f"cannot serialize {ax!r}")


def ontology_to_str(onto: S.Ontology) -> str:
    lines = []
    iri = onto.iri or "http://distel-tpu/generated"
    lines.append(f"Ontology(<{iri}>")
    for ax in onto.axioms:
        lines.append(axiom_to_str(ax))
    lines.append(")")
    return "\n".join(lines) + "\n"


def write_file(onto: S.Ontology, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(ontology_to_str(onto))
