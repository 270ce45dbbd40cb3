"""Text-level component partitioning of OFN corpora.

``core/components.py`` partitions an already-indexed ontology — the
right tool for mixed corpora, but the GLOBAL index itself is the scale
wall for massively-multiplied corpora: ``role_closure`` and the factored
CR4/CR6 masks are dense in the role count, so a 65k-copy corpus
(~3.3M roles) can never be monolithically indexed, regardless of how
the state is later sharded.  (The reference never hits this because its
Redis hashes are sparse; the dense-role assumption is what buys this
framework its MXU-shaped masks at normal role counts.)

So at weak-scaling size the split happens BEFORE indexing: axiom LINES
of functional-syntax text are union-found over the entity names they
mention (linear in corpus size), components are grouped by a canonical
form that renames entities to first-occurrence ordinals (so the n
renamed copies of ``OntologyMultiplier`` collapse into one group
regardless of their ``__copyK`` suffixes), and ONE representative per
group is parsed/normalized/indexed.  The caller batch-executes each
group with ``core/components.saturate_isomorphic``.

Glue handling mirrors the index-level partitioner: ``owl:Thing`` /
``owl:Nothing`` are not union nodes; a line whose FIRST entity is ⊤/⊥
(a global-conclusion axiom like ⊤ ⊑ B) forces the unpartitioned
fallback.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

#: entity tokens: IRIs in <>, prefixed names (incl. default-prefix
#: ``:A`` — without the optional leading colon, ``:A`` and a bare ``A``
#: would intern as the same union-find node and silently coarsen the
#: partition; advisor r3 item 3), or bare NCNames — anything that is
#: not an OFN keyword/punctuation
_TOKEN = re.compile(r"<[^>]*>|:?[A-Za-z_][\w\-.:#/]*")
#: string literals: their contents must not create interaction-graph
#: edges (a literal that happens to spell an entity name would glue
#: unrelated components).  Canonicalization still renames literal
#: tokens — sound, because closures are equivariant under renaming.
_LITERAL = re.compile(r'"(?:[^"\\]|\\.)*"')
_KEYWORDS = frozenset(
    (
        "SubClassOf", "EquivalentClasses", "DisjointClasses",
        "ObjectIntersectionOf", "ObjectSomeValuesFrom", "ObjectOneOf",
        "ObjectHasValue", "SubObjectPropertyOf", "ObjectPropertyChain",
        "EquivalentObjectProperties", "TransitiveObjectProperty",
        "ReflexiveObjectProperty", "ObjectPropertyDomain",
        "ObjectPropertyRange", "ClassAssertion", "ObjectPropertyAssertion",
        "Ontology", "Prefix", "Declaration", "Class", "ObjectProperty",
        "NamedIndividual", "DataSomeValuesFrom", "DataHasValue",
    )
)
_GLUE = frozenset(("owl:Thing", "owl:Nothing", "<http://www.w3.org/2002/07/owl#Thing>", "<http://www.w3.org/2002/07/owl#Nothing>"))


@dataclass
class TextComponentGroups:
    """``groups[i]`` is (representative_text, member_count); every axiom
    line of the corpus belongs to exactly one member of one group."""

    groups: List[Tuple[str, int]]
    fallback: bool = False  # True => single group holds the whole corpus


#: top-level functors whose lines carry no logical content for the
#: partition: dropped from the interaction graph (Prefix/Declaration
#: lines become a shared preamble instead)
_IGNORABLE = frozenset(
    (
        "Annotation", "AnnotationAssertion", "SubAnnotationPropertyOf",
        "AnnotationPropertyDomain", "AnnotationPropertyRange",
    )
)
_PREAMBLE = ("Prefix(", "Declaration(")
#: logical functors the splitter understands; an unrecognized top-level
#: functor means tokens may not be entities at all — refuse to split
_LOGICAL = frozenset(
    (
        "SubClassOf", "EquivalentClasses", "DisjointClasses",
        "SubObjectPropertyOf", "EquivalentObjectProperties",
        "TransitiveObjectProperty", "ReflexiveObjectProperty",
        "ObjectPropertyDomain", "ObjectPropertyRange", "ClassAssertion",
        "ObjectPropertyAssertion",
    )
)


def _line_entities(line: str) -> List[str]:
    out = []
    for tok in _TOKEN.findall(_LITERAL.sub('""', line)):
        if tok in _KEYWORDS:
            continue
        out.append(tok)
    return out


def partition_ofn_text(text: str) -> TextComponentGroups:
    raw_lines = [
        ln
        for ln in text.splitlines()
        if ln.strip() and not ln.lstrip().startswith(("#", "Ontology(", ")"))
    ]
    preamble: List[str] = []
    lines: List[str] = []
    fallback = False
    for ln in raw_lines:
        s = ln.lstrip()
        if s.startswith(_PREAMBLE):
            preamble.append(ln)
            continue
        functor = s.split("(", 1)[0].strip()
        if functor in _IGNORABLE:
            continue
        if functor not in _LOGICAL:
            fallback = True  # unknown construct: tokens untrustworthy
            break
        lines.append(ln)
    intern: Dict[str, int] = {}
    line_first: List[int] = []
    edges_u: List[int] = []
    edges_v: List[int] = []
    if not fallback:
        for ln in lines:
            ents = _line_entities(ln)
            live = [e for e in ents if e not in _GLUE]
            # global-conclusion hazards (the text-level analog of the
            # index partitioner's ⊤/⊥-LHS refusal): ⊤/⊥ in subject
            # position, or ANYWHERE in an EquivalentClasses (either
            # side of the equivalence becomes an nf1 LHS)
            glue_present = len(live) < len(ents)
            if glue_present and (
                (ents and ents[0] in _GLUE)
                or ln.lstrip().startswith("EquivalentClasses")
            ):
                fallback = True
                break
            if not live:
                fallback = True  # line purely over ⊤/⊥
                break
            ids = []
            for e in live:
                i = intern.setdefault(e, len(intern))
                ids.append(i)
            line_first.append(ids[0])
            for j in ids[1:]:
                edges_u.append(ids[0])
                edges_v.append(j)
    if fallback or not lines:
        return TextComponentGroups(
            groups=[(text, 1)] if raw_lines else [], fallback=True
        )
    pre = "\n".join(preamble)

    n = len(intern)
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix(
        (np.ones(len(edges_u), np.int8), (edges_u, edges_v)), shape=(n, n)
    )
    _, labels = connected_components(adj, directed=False)

    comp_lines: Dict[int, List[int]] = {}
    for li, first in enumerate(line_first):
        comp_lines.setdefault(int(labels[first]), []).append(li)

    groups: Dict[bytes, Tuple[str, int]] = {}
    for lab in sorted(comp_lines, key=lambda k: comp_lines[k][0]):
        lis = comp_lines[lab]
        # canonical form: entities renamed to first-occurrence ordinals
        ren: Dict[str, str] = {}

        def sub(m):
            tok = m.group(0)
            if tok in _KEYWORDS or tok in _GLUE:
                return tok
            if tok not in ren:
                ren[tok] = f"e{len(ren)}"
            return ren[tok]

        canon = "\n".join(_TOKEN.sub(sub, lines[li]) for li in lis)
        key = hashlib.sha256(canon.encode()).digest()
        if key in groups:
            rep, cnt = groups[key]
            groups[key] = (rep, cnt + 1)
        else:
            body = "\n".join(lines[li] for li in lis)
            # every representative carries the shared Prefix/Declaration
            # preamble so prefixed names still resolve when parsed alone
            groups[key] = (pre + "\n" + body if pre else body, 1)
    return TextComponentGroups(groups=list(groups.values()))
