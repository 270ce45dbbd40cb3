"""AST for the OWL 2 EL fragment (plus the sugar DistEL accepts).

The reference consumes ontologies through OWLAPI (reference
``init/AxiomLoader.java:126-143``); we define a minimal, hashable,
immutable AST covering exactly the constructs the reference's normalizer
handles (``init/Normalizer.java``): atomic classes, ⊤/⊥, intersections,
existential restrictions, individuals (for ABox→TBox conversion, reference
``init/Ind2ClassConverter.java``), plus the axiom sugar it lowers
(equivalence, disjointness, transitivity, domain/range, role chains,
assertions).

Everything else (unions, universals, cardinalities, datatypes, ...) is
*out of profile*: the parser still parses common constructs so that
``ProfileChecker`` can report/strip them, mirroring the reference's
behavior of dropping-and-recording non-EL axioms
(``init/Normalizer.java:247-256``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


# --------------------------------------------------------------------------
# Class expressions
# --------------------------------------------------------------------------


class ClassExpression:
    """Base class for class expressions. All subclasses are frozen/hashable."""

    __slots__ = ()

    def is_atomic(self) -> bool:
        return isinstance(self, (Class, Individual))


@dataclass(frozen=True)
class Class(ClassExpression):
    iri: str

    def __repr__(self) -> str:
        return f"C({self.iri})"


#: Distinguished IRIs. The reference pins TOP_ID=1 / BOTTOM_ID=0
#: (``misc/Constants.java:30-31``); we use the OWL vocabulary IRIs.
OWL_THING = Class("owl:Thing")
OWL_NOTHING = Class("owl:Nothing")

#: Literal-datatype IRIs shared by every reader (datatypes-as-classes,
#: reference EntityType.DATATYPE): untyped literals are xsd:string per
#: the OWL 2 structural spec, lang-tagged ones rdf:PlainLiteral.
XSD_STRING = "http://www.w3.org/2001/XMLSchema#string"
RDF_PLAIN_LITERAL = "http://www.w3.org/1999/02/22-rdf-syntax-ns#PlainLiteral"


@dataclass(frozen=True)
class Individual(ClassExpression):
    """A named individual, usable as a nominal-ish class via Ind2Class
    conversion (reference ``init/Ind2ClassConverter.java:43-81``)."""

    iri: str

    def __repr__(self) -> str:
        return f"I({self.iri})"


@dataclass(frozen=True)
class ObjectProperty:
    iri: str

    def __repr__(self) -> str:
        return f"R({self.iri})"


@dataclass(frozen=True)
class ObjectIntersectionOf(ClassExpression):
    operands: Tuple[ClassExpression, ...]

    def __post_init__(self) -> None:
        assert len(self.operands) >= 2, "intersection needs >= 2 operands"

    def __repr__(self) -> str:
        return "And(" + ", ".join(map(repr, self.operands)) + ")"


@dataclass(frozen=True)
class ObjectSomeValuesFrom(ClassExpression):
    role: ObjectProperty
    filler: ClassExpression

    def __repr__(self) -> str:
        return f"Some({self.role.iri}, {self.filler!r})"


@dataclass(frozen=True)
class ObjectOneOf(ClassExpression):
    """Nominal {a1,...,an}. In-profile for OWL EL only as singletons; the
    reference rewrites nominal axioms into assertions
    (``init/ELKTranslator.java:45-105``)."""

    individuals: Tuple[Individual, ...]


@dataclass(frozen=True)
class UnsupportedClassExpression(ClassExpression):
    """Anything parsed but outside the EL fragment (union, complement,
    allValuesFrom, hasValue, cardinalities, datatype restrictions...).
    Kept opaque so ProfileChecker can count/strip it."""

    constructor: str
    payload: Tuple = field(default_factory=tuple)


# --------------------------------------------------------------------------
# Axioms
# --------------------------------------------------------------------------


class Axiom:
    __slots__ = ()


@dataclass(frozen=True)
class SubClassOf(Axiom):
    sub: ClassExpression
    sup: ClassExpression


@dataclass(frozen=True)
class EquivalentClasses(Axiom):
    operands: Tuple[ClassExpression, ...]


@dataclass(frozen=True)
class DisjointClasses(Axiom):
    operands: Tuple[ClassExpression, ...]


@dataclass(frozen=True)
class SubObjectPropertyOf(Axiom):
    #: chain of length 1 = plain role inclusion r ⊑ s; length >= 2 = complex
    #: role inclusion r1 ∘ ... ∘ rn ⊑ s (reference NF1 splits long chains,
    #: ``init/Normalizer.java:619-637``).
    chain: Tuple[ObjectProperty, ...]
    sup: ObjectProperty


@dataclass(frozen=True)
class EquivalentObjectProperties(Axiom):
    operands: Tuple[ObjectProperty, ...]


@dataclass(frozen=True)
class TransitiveObjectProperty(Axiom):
    role: ObjectProperty


@dataclass(frozen=True)
class ReflexiveObjectProperty(Axiom):
    role: ObjectProperty


@dataclass(frozen=True)
class ObjectPropertyDomain(Axiom):
    role: ObjectProperty
    domain: ClassExpression


@dataclass(frozen=True)
class ObjectPropertyRange(Axiom):
    role: ObjectProperty
    range: ClassExpression


@dataclass(frozen=True)
class ClassAssertion(Axiom):
    cls: ClassExpression
    individual: Individual


@dataclass(frozen=True)
class ObjectPropertyAssertion(Axiom):
    role: ObjectProperty
    subject: Individual
    object: Individual


@dataclass(frozen=True)
class UnsupportedAxiom(Axiom):
    """Out-of-profile axiom kept for reporting (reference
    ``Normalizer.getRemovedTypes``, ``init/Normalizer.java:863``)."""

    kind: str
    payload: Tuple = field(default_factory=tuple)


# --------------------------------------------------------------------------
# Ontology container
# --------------------------------------------------------------------------


@dataclass
class Ontology:
    iri: str = ""
    axioms: list = field(default_factory=list)
    prefixes: dict = field(default_factory=dict)

    def add(self, axiom: Axiom) -> None:
        self.axioms.append(axiom)

    def classes(self) -> set:
        out: set = set()
        for ax in self.axioms:
            _collect_classes(ax, out)
        return out

    def roles(self) -> set:
        out: set = set()
        for ax in self.axioms:
            _collect_roles(ax, out)
        return out

    def individuals(self) -> set:
        out: set = set()
        for ax in self.axioms:
            _collect_individuals(ax, out)
        return out

    def __len__(self) -> int:
        return len(self.axioms)


def walk_expressions(obj):
    """Yield every ClassExpression reachable from an axiom or expression."""
    if isinstance(obj, ClassExpression):
        yield obj
        if isinstance(obj, ObjectIntersectionOf):
            for op in obj.operands:
                yield from walk_expressions(op)
        elif isinstance(obj, ObjectSomeValuesFrom):
            yield from walk_expressions(obj.filler)
        elif isinstance(obj, UnsupportedClassExpression):
            for p in obj.payload:
                yield from walk_expressions(p)
    elif isinstance(obj, SubClassOf):
        yield from walk_expressions(obj.sub)
        yield from walk_expressions(obj.sup)
    elif isinstance(obj, (EquivalentClasses, DisjointClasses)):
        for op in obj.operands:
            yield from walk_expressions(op)
    elif isinstance(obj, (ObjectPropertyDomain,)):
        yield from walk_expressions(obj.domain)
    elif isinstance(obj, (ObjectPropertyRange,)):
        yield from walk_expressions(obj.range)
    elif isinstance(obj, ClassAssertion):
        yield from walk_expressions(obj.cls)
        yield obj.individual
    elif isinstance(obj, ObjectPropertyAssertion):
        yield obj.subject
        yield obj.object
    elif isinstance(obj, UnsupportedAxiom):
        for p in obj.payload:
            if isinstance(p, ClassExpression):
                yield from walk_expressions(p)


def _collect_classes(ax, out: set) -> None:
    for e in walk_expressions(ax):
        if isinstance(e, Class):
            out.add(e)


def _collect_individuals(ax, out: set) -> None:
    for e in walk_expressions(ax):
        if isinstance(e, Individual):
            out.add(e)


def _collect_roles(obj, out: set) -> None:
    if isinstance(obj, ObjectSomeValuesFrom):
        out.add(obj.role)
        _collect_roles(obj.filler, out)
    elif isinstance(obj, ObjectIntersectionOf):
        for op in obj.operands:
            _collect_roles(op, out)
    elif isinstance(obj, SubClassOf):
        _collect_roles(obj.sub, out)
        _collect_roles(obj.sup, out)
    elif isinstance(obj, (EquivalentClasses, DisjointClasses)):
        for op in obj.operands:
            _collect_roles(op, out)
    elif isinstance(obj, SubObjectPropertyOf):
        out.update(obj.chain)
        out.add(obj.sup)
    elif isinstance(obj, EquivalentObjectProperties):
        out.update(obj.operands)
    elif isinstance(obj, (TransitiveObjectProperty, ReflexiveObjectProperty)):
        out.add(obj.role)
    elif isinstance(obj, ObjectPropertyDomain):
        out.add(obj.role)
        _collect_roles(obj.domain, out)
    elif isinstance(obj, ObjectPropertyRange):
        out.add(obj.role)
        _collect_roles(obj.range, out)
    elif isinstance(obj, ObjectPropertyAssertion):
        out.add(obj.role)
