"""RDF/XML reader for the OWL 2 EL fragment.

The reference ingests any OWLAPI-supported serialization
(``init/AxiomLoader.java:127-136`` — OWLAPI auto-detects the format); most
public corpora (GO releases, older GALEN/SNOMED exports) ship as RDF/XML.
This module gives the framework the same reach without OWLAPI: a two-stage
reader — RDF/XML → triples (subset: node elements, property elements,
``rdf:about/resource/ID/nodeID``, ``rdf:parseType="Collection"``,
``rdf:first/rest`` lists) → OWL axioms over the shared AST
(``distel_tpu.owl.syntax``).

Out-of-profile constructs (unions, universals, cardinalities, datatype
restrictions) become ``Unsupported*`` nodes, mirroring the functional-
syntax parser and the reference's drop-and-record behavior
(``init/Normalizer.java:247-256``).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from distel_tpu_torch.owl import syntax as S

RDF = "http://www.w3.org/1999/02/22-rdf-syntax-ns#"
RDFS = "http://www.w3.org/2000/01/rdf-schema#"
OWL = "http://www.w3.org/2002/07/owl#"

_ABOUT = f"{{{RDF}}}about"
_RESOURCE = f"{{{RDF}}}resource"
_ID = f"{{{RDF}}}ID"
_NODEID = f"{{{RDF}}}nodeID"
_PARSETYPE = f"{{{RDF}}}parseType"
_DATATYPE = f"{{{RDF}}}datatype"

_TYPE = f"{RDF}type"
_FIRST = f"{RDF}first"
_REST = f"{RDF}rest"
_NIL = f"{RDF}nil"
_DESCRIPTION = f"{{{RDF}}}Description"


def _tag_iri(elem: ET.Element) -> str:
    t = elem.tag
    return t[1:].replace("}", "", 1) if t.startswith("{") else t


class _TripleStore:
    def __init__(self) -> None:
        self.spo: List[Tuple[str, str, str]] = []
        #: subject → predicate → [objects]
        self.index: Dict[str, Dict[str, List[str]]] = {}
        self._blank = 0

    def add(self, s: str, p: str, o: str) -> None:
        self.spo.append((s, p, o))
        self.index.setdefault(s, {}).setdefault(p, []).append(o)

    def blank(self) -> str:
        self._blank += 1
        return f"_:g{self._blank}"

    def objects(self, s: str, p: str) -> List[str]:
        return self.index.get(s, {}).get(p, [])

    def one(self, s: str, p: str) -> Optional[str]:
        objs = self.objects(s, p)
        return objs[0] if objs else None

    def rdf_list(self, head: str) -> List[str]:
        out: List[str] = []
        seen = set()
        while head and head != _NIL and head not in seen:
            seen.add(head)
            first = self.one(head, _FIRST)
            if first is not None:
                out.append(first)
            head = self.one(head, _REST) or _NIL
        return out


def _parse_node(elem: ET.Element, store: _TripleStore, base: str) -> str:
    """Node element → subject id; emits its triples."""
    subj = elem.get(_ABOUT)
    if subj is None and elem.get(_ID) is not None:
        subj = base + "#" + elem.get(_ID)
    if subj is None and elem.get(_NODEID) is not None:
        subj = "_:" + elem.get(_NODEID)
    if subj is None:
        subj = store.blank()
    if elem.tag != _DESCRIPTION:
        store.add(subj, _TYPE, _tag_iri(elem))
    for prop in elem:
        pred = _tag_iri(prop)
        res = prop.get(_RESOURCE)
        if res is None and prop.get(_NODEID) is not None:
            res = "_:" + prop.get(_NODEID)
        if res is not None:
            store.add(subj, pred, res)
            continue
        if prop.get(_PARSETYPE) == "Collection":
            members = [_parse_node(child, store, base) for child in prop]
            head = _NIL
            for m in reversed(members):
                node = store.blank()
                store.add(node, _FIRST, m)
                store.add(node, _REST, head)
                head = node
            store.add(subj, pred, head)
            continue
        children = list(prop)
        if children:
            for child in children:
                store.add(subj, pred, _parse_node(child, store, base))
            continue
        text = (prop.text or "").strip()
        # literal object — quoted marker so it never collides with IRIs;
        # rdf:datatype / xml:lang ride after the closing quote (consumers
        # split on the LAST quote, so embedded quotes in text are safe)
        dt = prop.get(_DATATYPE)
        lang = prop.get("{http://www.w3.org/XML/1998/namespace}lang")
        suffix = f"^^{dt}" if dt else ("@" + lang if lang else "")
        store.add(subj, pred, f'"{text}"{suffix}')
    return subj


#: datatype IRI of a stored literal marker (OWL 2 mapping: untyped →
#: xsd:string, lang-tagged → rdf:PlainLiteral) — the reference keys
#: DataHasValue on this (init/AxiomLoader.java:712-721)
def _literal_datatype(marker: str) -> str:
    suffix = marker.rsplit('"', 1)[1]
    if suffix.startswith("^^"):
        return suffix[2:]
    if suffix.startswith("@"):
        return S.RDF_PLAIN_LITERAL
    return S.XSD_STRING


class _AxiomBuilder:
    def __init__(self, store: _TripleStore):
        self.store = store
        types = {}
        for s, p, o in store.spo:
            if p == _TYPE:
                types.setdefault(s, set()).add(o)
        self.types: Dict[str, set] = types
        self.object_properties = {
            s
            for s, t in types.items()
            if f"{OWL}ObjectProperty" in t
            or f"{OWL}TransitiveProperty" in t
            or f"{OWL}ReflexiveProperty" in t
        }
        self.data_properties = {
            s for s, t in types.items() if f"{OWL}DatatypeProperty" in t
        }
        self.individuals = {
            s for s, t in types.items() if f"{OWL}NamedIndividual" in t
        }
        self.classes = {s for s, t in types.items() if f"{OWL}Class" in t}

    # -- expressions --------------------------------------------------------

    def expr(self, node: str) -> S.ClassExpression:
        st = self.store
        if not node.startswith("_:"):
            if node == f"{OWL}Thing":
                return S.OWL_THING
            if node == f"{OWL}Nothing":
                return S.OWL_NOTHING
            if node in self.individuals:
                return S.Individual(node)
            return S.Class(node)
        inter = st.one(node, f"{OWL}intersectionOf")
        if inter is not None:
            ops = tuple(self.expr(m) for m in st.rdf_list(inter))
            if len(ops) == 1:
                return ops[0]
            return S.ObjectIntersectionOf(ops)
        on_prop = st.one(node, f"{OWL}onProperty")
        some = st.one(node, f"{OWL}someValuesFrom")
        if on_prop is not None and some is not None:
            return S.ObjectSomeValuesFrom(
                S.ObjectProperty(on_prop), self.expr(some)
            )
        one_of = st.one(node, f"{OWL}oneOf")
        if one_of is not None:
            return S.ObjectOneOf(
                tuple(S.Individual(m) for m in st.rdf_list(one_of))
            )
        has_value = st.one(node, f"{OWL}hasValue")
        if on_prop is not None and has_value is not None:
            if has_value.startswith('"'):
                # DataHasValue: keyed on the literal's datatype
                # (datatypes-as-classes, init/AxiomLoader.java:712-721)
                return S.ObjectSomeValuesFrom(
                    S.ObjectProperty(on_prop),
                    S.Class(_literal_datatype(has_value)),
                )
            if not has_value.startswith("_:"):
                # EL sugar: hasValue with an individual ≡ ∃r.{a}
                return S.ObjectSomeValuesFrom(
                    S.ObjectProperty(on_prop),
                    S.ObjectOneOf((S.Individual(has_value),)),
                )
        for ctor in (
            "unionOf",
            "complementOf",
            "allValuesFrom",
            "hasValue",
            "minCardinality",
            "maxCardinality",
            "cardinality",
            "minQualifiedCardinality",
            "maxQualifiedCardinality",
            "qualifiedCardinality",
            "hasSelf",
            "onDataRange",
        ):
            if st.one(node, f"{OWL}{ctor}") is not None:
                return S.UnsupportedClassExpression(ctor)
        # opaque blank node (e.g. a datatype restriction)
        return S.UnsupportedClassExpression("blank", (node,))

    # -- axioms -------------------------------------------------------------

    def build(self, onto: S.Ontology) -> None:
        st = self.store
        vocab_classes = {f"{OWL}Thing", f"{OWL}Nothing"}
        for s, p, o in st.spo:
            if p == f"{RDFS}subClassOf":
                onto.add(S.SubClassOf(self.expr(s), self.expr(o)))
            elif p == f"{OWL}equivalentClass":
                onto.add(S.EquivalentClasses((self.expr(s), self.expr(o))))
            elif p == f"{OWL}disjointWith":
                onto.add(S.DisjointClasses((self.expr(s), self.expr(o))))
            elif p == f"{OWL}members" and f"{OWL}AllDisjointClasses" in self.types.get(s, ()):
                ops = tuple(self.expr(m) for m in st.rdf_list(o))
                if len(ops) >= 2:
                    onto.add(S.DisjointClasses(ops))
            elif p == f"{RDFS}subPropertyOf":
                onto.add(
                    S.SubObjectPropertyOf(
                        (S.ObjectProperty(s),), S.ObjectProperty(o)
                    )
                )
            elif p == f"{OWL}propertyChainAxiom":
                chain = tuple(S.ObjectProperty(m) for m in st.rdf_list(o))
                if chain:
                    onto.add(S.SubObjectPropertyOf(chain, S.ObjectProperty(s)))
            elif p == f"{OWL}equivalentProperty":
                onto.add(
                    S.EquivalentObjectProperties(
                        (S.ObjectProperty(s), S.ObjectProperty(o))
                    )
                )
            elif p == f"{RDFS}domain":
                if s in self.object_properties:
                    onto.add(
                        S.ObjectPropertyDomain(S.ObjectProperty(s), self.expr(o))
                    )
            elif p == f"{RDFS}range":
                if s in self.object_properties:
                    onto.add(
                        S.ObjectPropertyRange(S.ObjectProperty(s), self.expr(o))
                    )
            elif p == f"{OWL}inverseOf" and not s.startswith("_:"):
                # out-of-profile property axiom: drop-and-record, like the
                # reference's Normalizer.getRemovedTypes
                # (init/Normalizer.java:863).  Blank-node subjects are
                # anonymous inverse EXPRESSIONS (ObjectInverseOf inside
                # owl:onProperty), not axioms — those keep flowing through
                # expr() and are reported by the profile checker instead.
                onto.add(S.UnsupportedAxiom("InverseObjectProperties", (s, o)))
            elif p == f"{OWL}propertyDisjointWith" and not s.startswith("_:"):
                kind = (
                    "DisjointDataProperties"
                    if s in self.data_properties
                    else "DisjointObjectProperties"
                )
                onto.add(S.UnsupportedAxiom(kind, (s, o)))
            elif p == _TYPE:
                if o == f"{OWL}TransitiveProperty" and not s.startswith("_:"):
                    onto.add(S.TransitiveObjectProperty(S.ObjectProperty(s)))
                elif o == f"{OWL}ReflexiveProperty":
                    onto.add(S.ReflexiveObjectProperty(S.ObjectProperty(s)))
                elif o in (
                    f"{OWL}FunctionalProperty",
                    f"{OWL}InverseFunctionalProperty",
                    f"{OWL}SymmetricProperty",
                    f"{OWL}AsymmetricProperty",
                    f"{OWL}IrreflexiveProperty",
                ) and not s.startswith("_:"):
                    # record under the OWL *axiom* name (the spelling the
                    # functional-syntax and OWL/XML readers use) so removed
                    # reports compare across serializations of one corpus.
                    # Of the five characteristics only Functional exists
                    # for data properties in OWL 2
                    kind = o[len(OWL):].replace("Property", "")
                    if kind == "Functional" and s in self.data_properties:
                        kind += "DataProperty"
                    else:
                        kind += "ObjectProperty"
                    onto.add(S.UnsupportedAxiom(kind, (s,)))
                elif (
                    not o.startswith(OWL)
                    and not o.startswith(RDF)
                    and not o.startswith(RDFS)
                    and not o.startswith('"')
                    and (s in self.individuals or o in self.classes or o.startswith("_:"))
                    and o not in vocab_classes
                ):
                    onto.add(
                        S.ClassAssertion(self.expr(o), S.Individual(s))
                    )
            elif (
                p in self.object_properties
                and not o.startswith('"')
                and s not in self.object_properties
            ):
                onto.add(
                    S.ObjectPropertyAssertion(
                        S.ObjectProperty(p), S.Individual(s), S.Individual(o)
                    )
                )


def parse(text: str) -> S.Ontology:
    """RDF/XML document → Ontology over the shared EL AST."""
    root = ET.fromstring(text)
    if _tag_iri(root) != f"{RDF}RDF":
        # a single node element as document root
        nodes = [root]
    else:
        nodes = list(root)
    store = _TripleStore()
    base = root.get(f"{{http://www.w3.org/XML/1998/namespace}}base", "")
    onto = S.Ontology()
    for node in nodes:
        subj = _parse_node(node, store, base)
        if f"{OWL}Ontology" in _tag_iri(node):
            onto.iri = subj
    _AxiomBuilder(store).build(onto)
    return onto


def parse_file(path: str) -> S.Ontology:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())


def wrap_fragment(body: str, extra_namespaces: str = "") -> str:
    """Wrap a headerless RDF/XML *fragment* (node elements only) into a
    complete ``rdf:RDF`` document — the reference streams per-interval
    traffic files that lack the envelope and prepends/appends it with
    ``HeaderFooterAdder.java`` before loading; this is that utility for
    the streaming CLI.  ``extra_namespaces`` is spliced into the root
    element verbatim (e.g. ``xmlns:dc="..."``)."""
    return (
        '<?xml version="1.0"?>\n'
        '<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"\n'
        '         xmlns:rdfs="http://www.w3.org/2000/01/rdf-schema#"\n'
        '         xmlns:owl="http://www.w3.org/2002/07/owl#"\n'
        f'         {extra_namespaces}>\n'
        f"{body}\n"
        "</rdf:RDF>\n"
    )
