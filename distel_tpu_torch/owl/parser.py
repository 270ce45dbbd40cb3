"""OWL 2 functional-syntax parser for the EL fragment.

Replaces the reference's OWLAPI dependency (reference
``init/AxiomLoader.java:127-136`` loads via ``OWLManager``): a small
recursive-descent parser over the functional-style syntax, which is the
format SNOMED CT / GO / GALEN distributions ship in.

Design notes (TPU-first loading):
  * parsing produces plain Python AST nodes (``distel_tpu_torch.owl.syntax``);
    all heavy per-axiom work (interning, categorization) happens later in
    ``core/indexing.py`` in vectorized numpy, the analog of the reference's
    pipelined bulk loads (``init/AxiomLoader.java:597-651``);
  * out-of-profile constructs parse into ``Unsupported*`` nodes rather than
    raising, so profile checking/stripping is a separate, reportable pass
    (reference ``init/ProfileChecker.java:49-112``).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from distel_tpu_torch.owl import syntax as S

_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|\#[^\n]*)                       # whitespace / comments
    | (?P<iri><[^>\s]*>)                          # full IRI
    | (?P<string>"(?:[^"\\]|\\.)*")               # string literal
    | (?P<lpar>\()
    | (?P<rpar>\))
    | (?P<eq>=)
    | (?P<caret>\^\^)
    | (?P<lang>@[A-Za-z][A-Za-z0-9-]*)
    | (?P<name>[^\s()="^]+)                       # prefixed name / keyword
    """,
    re.VERBOSE,
)

_BUILTIN_PREFIXES = {
    "owl:": "http://www.w3.org/2002/07/owl#",
    "rdf:": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "rdfs:": "http://www.w3.org/2000/01/rdf-schema#",
    "xsd:": "http://www.w3.org/2001/XMLSchema#",
}

_OWL_THING_IRIS = {
    "http://www.w3.org/2002/07/owl#Thing",
    "owl:Thing",
    "Thing",
}
_OWL_NOTHING_IRIS = {
    "http://www.w3.org/2002/07/owl#Nothing",
    "owl:Nothing",
    "Nothing",
}


class OWLParseError(ValueError):
    def __init__(self, msg: str, pos: int = -1, line: int = -1):
        super().__init__(f"{msg} (line {line})" if line >= 0 else msg)
        self.pos = pos
        self.line = line


class _Tokenizer:
    __slots__ = ("text", "pos", "tokens", "idx")

    def __init__(self, text: str):
        self.text = text
        self.tokens: List[Tuple[str, str, int]] = []
        pos = 0
        n = len(text)
        while pos < n:
            m = _TOKEN_RE.match(text, pos)
            if m is None:
                raise OWLParseError(
                    f"unexpected character {text[pos]!r}", pos, text.count("\n", 0, pos) + 1
                )
            pos = m.end()
            kind = m.lastgroup
            if kind == "ws":
                continue
            self.tokens.append((kind, m.group(), m.start()))
        self.idx = 0

    def peek(self) -> Optional[Tuple[str, str, int]]:
        return self.tokens[self.idx] if self.idx < len(self.tokens) else None

    def next(self) -> Tuple[str, str, int]:
        tok = self.peek()
        if tok is None:
            raise OWLParseError("unexpected end of input")
        self.idx += 1
        return tok

    def expect(self, kind: str) -> Tuple[str, str, int]:
        tok = self.next()
        if tok[0] != kind:
            raise OWLParseError(
                f"expected {kind}, got {tok[0]} {tok[1]!r}",
                tok[2],
                self.text.count("\n", 0, tok[2]) + 1,
            )
        return tok


class Parser:
    """Parses a functional-syntax document into an ``Ontology``."""

    def __init__(self, text: str):
        self.tz = _Tokenizer(text)
        self.ontology = S.Ontology()
        self.ontology.prefixes.update(_BUILTIN_PREFIXES)
        #: IRIs declared as NamedIndividual, to disambiguate ObjectOneOf-free
        #: usage; populated from Declaration() axioms.
        self.declared_individuals: set = set()
        self.declared_classes: set = set()
        self.declared_roles: set = set()

    # -- entity resolution --------------------------------------------------

    def _resolve(self, token_kind: str, token_text: str) -> str:
        if token_kind == "iri":
            return token_text[1:-1]
        # prefixed name: expand against declared prefixes; keep verbatim if
        # the prefix is unknown (robustness over strictness, like OWLAPI's
        # lenient IRI handling).
        for pfx, base in self.ontology.prefixes.items():
            if token_text.startswith(pfx):
                return base + token_text[len(pfx):]
        return token_text

    def _as_class(self, iri: str) -> S.ClassExpression:
        if iri in _OWL_THING_IRIS:
            return S.OWL_THING
        if iri in _OWL_NOTHING_IRIS:
            return S.OWL_NOTHING
        if iri in self.declared_individuals:
            return S.Individual(iri)
        return S.Class(iri)

    # -- document -----------------------------------------------------------

    def parse(self) -> S.Ontology:
        while True:
            tok = self.tz.peek()
            if tok is None:
                break
            if tok[0] != "name":
                raise OWLParseError(f"expected construct, got {tok[1]!r}", tok[2])
            if tok[1] == "Prefix":
                self._parse_prefix()
            elif tok[1] == "Ontology":
                self._parse_ontology_block()
            else:
                # bare axiom stream (no Ontology(...) wrapper) — accepted for
                # convenience in tests and generated corpora.
                ax = self._parse_axiom()
                if ax is not None:
                    self.ontology.add(ax)
        return self.ontology

    def _parse_prefix(self) -> None:
        self.tz.next()  # Prefix
        self.tz.expect("lpar")
        name_tok = self.tz.next()
        prefix = name_tok[1]
        if prefix.endswith("="):  # e.g. ":=" tokenizes as name ':=' sometimes
            prefix = prefix[:-1]
        else:
            self.tz.expect("eq")
        iri_tok = self.tz.expect("iri")
        self.ontology.prefixes[prefix] = iri_tok[1][1:-1]
        self.tz.expect("rpar")

    def _parse_ontology_block(self) -> None:
        self.tz.next()  # Ontology
        self.tz.expect("lpar")
        tok = self.tz.peek()
        if tok and tok[0] == "iri":
            self.ontology.iri = self.tz.next()[1][1:-1]
            tok = self.tz.peek()
            if tok and tok[0] == "iri":  # version IRI
                self.tz.next()
        # Two passes are not needed: Declaration(NamedIndividual(..)) usually
        # precedes use. For robustness we pre-scan declarations.
        self._prescan_declarations()
        while True:
            tok = self.tz.peek()
            if tok is None:
                raise OWLParseError("unterminated Ontology(")
            if tok[0] == "rpar":
                self.tz.next()
                return
            ax = self._parse_axiom()
            if ax is not None:
                self.ontology.add(ax)

    def _prescan_declarations(self) -> None:
        toks = self.tz.tokens
        i = self.tz.idx
        while i < len(toks) - 4:
            if toks[i][1] == "Declaration" and toks[i + 1][0] == "lpar":
                kind = toks[i + 2][1]
                if toks[i + 3][0] == "lpar":
                    ent = toks[i + 4]
                    iri = self._resolve(ent[0], ent[1])
                    if kind == "NamedIndividual":
                        self.declared_individuals.add(iri)
                    elif kind == "Class":
                        self.declared_classes.add(iri)
                    elif kind == "ObjectProperty":
                        self.declared_roles.add(iri)
            i += 1

    # -- axioms -------------------------------------------------------------

    def _skip_balanced(self) -> Tuple:
        """Consume a balanced (...) group, returning raw token texts."""
        depth = 0
        out = []
        while True:
            tok = self.tz.next()
            out.append(tok[1])
            if tok[0] == "lpar":
                depth += 1
            elif tok[0] == "rpar":
                depth -= 1
                if depth == 0:
                    return tuple(out)

    def _skip_annotations(self) -> None:
        while True:
            tok = self.tz.peek()
            if tok is not None and tok[0] == "name" and tok[1] == "Annotation":
                self.tz.next()
                self._skip_balanced()
            else:
                return

    def _parse_axiom(self) -> Optional[S.Axiom]:
        tok = self.tz.next()
        if tok[0] != "name":
            raise OWLParseError(f"expected axiom, got {tok[1]!r}", tok[2])
        kind = tok[1]
        self.tz.expect("lpar")
        self._skip_annotations()
        handler = getattr(self, f"_ax_{kind}", None)
        if handler is None:
            # out-of-profile axiom (DataPropertyAssertion, HasKey, ...)
            payload = self._consume_group_payload()
            if kind in ("Declaration", "AnnotationAssertion", "SubAnnotationPropertyOf",
                        "AnnotationPropertyDomain", "AnnotationPropertyRange"):
                return None
            return S.UnsupportedAxiom(kind, payload)
        return handler()

    def _consume_group_payload(self) -> Tuple:
        depth = 1
        out = []
        while depth:
            tok = self.tz.next()
            out.append(tok[1])
            if tok[0] == "lpar":
                depth += 1
            elif tok[0] == "rpar":
                depth -= 1
        return tuple(out[:-1])

    def _end(self) -> None:
        self.tz.expect("rpar")

    # class axioms

    def _ax_SubClassOf(self) -> S.Axiom:
        sub = self._parse_class_expr()
        sup = self._parse_class_expr()
        self._end()
        return S.SubClassOf(sub, sup)

    def _ax_EquivalentClasses(self) -> S.Axiom:
        ops = self._parse_class_expr_list()
        self._end()
        return S.EquivalentClasses(tuple(ops))

    def _ax_DisjointClasses(self) -> S.Axiom:
        ops = self._parse_class_expr_list()
        self._end()
        return S.DisjointClasses(tuple(ops))

    # property axioms

    def _ax_SubObjectPropertyOf(self) -> S.Axiom:
        tok = self.tz.peek()
        if tok and tok[0] == "name" and tok[1] == "ObjectPropertyChain":
            self.tz.next()
            self.tz.expect("lpar")
            chain = []
            while self.tz.peek() and self.tz.peek()[0] != "rpar":
                chain.append(self._parse_role())
            self.tz.expect("rpar")
        else:
            chain = [self._parse_role()]
        sup = self._parse_role()
        self._end()
        return S.SubObjectPropertyOf(tuple(chain), sup)

    def _ax_EquivalentObjectProperties(self) -> S.Axiom:
        ops = []
        while self.tz.peek() and self.tz.peek()[0] != "rpar":
            ops.append(self._parse_role())
        self._end()
        return S.EquivalentObjectProperties(tuple(ops))

    def _ax_TransitiveObjectProperty(self) -> S.Axiom:
        role = self._parse_role()
        self._end()
        return S.TransitiveObjectProperty(role)

    def _ax_ReflexiveObjectProperty(self) -> S.Axiom:
        role = self._parse_role()
        self._end()
        return S.ReflexiveObjectProperty(role)

    def _ax_ObjectPropertyDomain(self) -> S.Axiom:
        role = self._parse_role()
        dom = self._parse_class_expr()
        self._end()
        return S.ObjectPropertyDomain(role, dom)

    def _ax_ObjectPropertyRange(self) -> S.Axiom:
        role = self._parse_role()
        rng = self._parse_class_expr()
        self._end()
        return S.ObjectPropertyRange(role, rng)

    # assertions

    def _ax_ClassAssertion(self) -> S.Axiom:
        cls = self._parse_class_expr()
        ind = self._parse_individual()
        self._end()
        return S.ClassAssertion(cls, ind)

    def _ax_ObjectPropertyAssertion(self) -> S.Axiom:
        role = self._parse_role()
        subj = self._parse_individual()
        obj = self._parse_individual()
        self._end()
        return S.ObjectPropertyAssertion(role, subj, obj)

    # -- expressions --------------------------------------------------------

    def _parse_class_expr_list(self) -> List[S.ClassExpression]:
        ops = []
        while self.tz.peek() and self.tz.peek()[0] != "rpar":
            ops.append(self._parse_class_expr())
        return ops

    _EL_CONSTRUCTORS = ("ObjectIntersectionOf", "ObjectSomeValuesFrom", "ObjectOneOf")

    def _parse_class_expr(self) -> S.ClassExpression:
        tok = self.tz.next()
        if tok[0] in ("iri", "name"):
            nxt = self.tz.peek()
            if nxt is not None and nxt[0] == "lpar" and tok[0] == "name" and (
                tok[1] in self._EL_CONSTRUCTORS or tok[1].startswith(("Object", "Data"))
            ):
                self.tz.next()  # consume (
                return self._parse_constructor(tok[1])
            return self._as_class(self._resolve(tok[0], tok[1]))
        raise OWLParseError(
            f"expected class expression, got {tok[1]!r}",
            tok[2],
            self.tz.text.count("\n", 0, tok[2]) + 1,
        )

    def _parse_constructor(self, name: str) -> S.ClassExpression:
        if name == "ObjectIntersectionOf":
            ops = self._parse_class_expr_list()
            self._end()
            if len(ops) == 1:
                return ops[0]
            return S.ObjectIntersectionOf(tuple(ops))
        if name == "ObjectSomeValuesFrom":
            role = self._parse_role()
            filler = self._parse_class_expr()
            self._end()
            return S.ObjectSomeValuesFrom(role, filler)
        if name == "ObjectOneOf":
            inds = []
            while self.tz.peek() and self.tz.peek()[0] != "rpar":
                inds.append(self._parse_individual())
            self._end()
            return S.ObjectOneOf(tuple(inds))
        if name == "ObjectHasValue":
            # EL sugar: ObjectHasValue(r a) ≡ ∃r.{a} (the reference loads
            # it as a T3₁ axiom keyed on the individual,
            # init/AxiomLoader.java:702-711)
            role = self._parse_role()
            ind = self._parse_individual()
            self._end()
            return S.ObjectSomeValuesFrom(role, S.ObjectOneOf((ind,)))
        if name == "DataSomeValuesFrom":
            # datatypes-as-classes (reference EntityType.DATATYPE,
            # init/AxiomLoader.java:687-701): the data property acts as a
            # role and a *named* datatype as a class; complex data ranges
            # (DatatypeRestriction etc.) stay out of profile
            role = self._parse_role()
            tok = self.tz.peek()
            if tok is not None and tok[0] in ("iri", "name"):
                dt = self.tz.next()
                nxt = self.tz.peek()
                if nxt is not None and nxt[0] == "rpar":
                    self._end()
                    return S.ObjectSomeValuesFrom(
                        role, self._as_class(self._resolve(dt[0], dt[1]))
                    )
            payload = self._consume_group_payload()
            return S.UnsupportedClassExpression("DataSomeValuesFrom", payload)
        if name == "DataHasValue":
            # the reference keys DataHasValue on the *literal's datatype*
            # (init/AxiomLoader.java:712-721): DataHasValue(p "v"^^dt) ≡
            # ∃p.dt-as-class; untyped literals are xsd:string (OWL 2
            # structural spec), lang-tagged ones rdf:PlainLiteral
            role = self._parse_role()
            tok = self.tz.peek()
            if tok is not None and tok[0] == "string":
                self.tz.next()
                dt_iri = S.XSD_STRING
                nxt = self.tz.peek()
                if nxt is not None and nxt[0] == "lang":
                    self.tz.next()
                    dt_iri = S.RDF_PLAIN_LITERAL
                elif nxt is not None and nxt[0] == "caret":
                    self.tz.next()
                    dt_tok = self.tz.next()
                    if dt_tok[0] not in ("iri", "name"):
                        raise OWLParseError(
                            f"expected datatype after ^^, got {dt_tok[1]!r}",
                            dt_tok[2],
                        )
                    dt_iri = self._resolve(dt_tok[0], dt_tok[1])
                if self.tz.peek() and self.tz.peek()[0] == "rpar":
                    self._end()
                    return S.ObjectSomeValuesFrom(
                        role, self._as_class(dt_iri)
                    )
            payload = self._consume_group_payload()
            return S.UnsupportedClassExpression("DataHasValue", payload)
        # out-of-profile constructor: swallow the group
        payload = self._consume_group_payload()
        return S.UnsupportedClassExpression(name, payload)

    def _parse_role(self) -> S.ObjectProperty:
        tok = self.tz.next()
        if tok[0] in ("iri", "name"):
            if tok[0] == "name" and tok[1] == "ObjectInverseOf":
                # inverse roles are not EL; record under a marker IRI
                self.tz.expect("lpar")
                inner = self._parse_role()
                self._end()
                return S.ObjectProperty(f"__inverse__:{inner.iri}")
            return S.ObjectProperty(self._resolve(tok[0], tok[1]))
        raise OWLParseError(f"expected role, got {tok[1]!r}", tok[2])

    def _parse_individual(self) -> S.Individual:
        tok = self.tz.next()
        if tok[0] in ("iri", "name"):
            iri = self._resolve(tok[0], tok[1])
            self.declared_individuals.add(iri)
            return S.Individual(iri)
        raise OWLParseError(f"expected individual, got {tok[1]!r}", tok[2])


def parse(text: str) -> S.Ontology:
    return Parser(text).parse()


def parse_file(path: str) -> S.Ontology:
    with open(path, "r", encoding="utf-8") as f:
        return parse(f.read())
