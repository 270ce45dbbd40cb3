"""Corpus tools: synthetic generators and ontology transforms.

Equivalents of the reference's corpus tooling:
  * ``synthetic_ontology``   — deterministic EL+ generator (the scale tool
    behind weak-scaling runs; plays the role of the reference's
    ``samples/OntologyMultiplier.java`` synthetic corpora).
  * ``snomed_shaped_ontology`` — deterministic generator with SNOMED CT's
    *role structure*: tens of object properties under a role hierarchy,
    role-group-style conjunctive definitions, transitive partonomy and
    right-identity chains.  The reference's evaluation corpus is SNOMED
    (``ShardInfo.properties:27`` chunk-tuning notes); this generator
    reproduces its axiom-shape mix where the real release cannot ship.
  * ``multiply_ontology``    — n-copy entity renaming and "crossed"
    duplication (reference ``samples/OntologyMultiplier.java:32-88`` and
    :97-…: copy k gets every axiom with entities renamed E→E_k; crossed
    mode additionally mixes copies in conjunctions).
  * ``strip_non_el``         — batch removal of out-of-profile axioms
    (reference ``init/OntologyModifier.java:21-97``).
"""

from __future__ import annotations

import random
from typing import List, Optional

from distel_tpu_torch.owl import syntax as S


def synthetic_ontology(
    n_classes: int = 2000,
    n_anatomy: int = 300,
    n_locations: int = 200,
    n_definitions: int = 100,
    seed: int = 42,
) -> str:
    """Deterministic GALEN/GO-shaped EL+ corpus in functional syntax:
    a binary-tree is-a hierarchy, a transitive partonomy, a located-in
    role with a right-identity chain, domain/range, and conjunctive
    definitions — every completion rule CR1-CR6 gets exercised."""
    rng = random.Random(seed)
    lines: List[str] = [
        "TransitiveObjectProperty(partOf)",
        "SubObjectPropertyOf(ObjectPropertyChain(hasLoc partOf) hasLoc)",
        "SubObjectPropertyOf(hasExactLoc hasLoc)",
        "ObjectPropertyDomain(hasLoc Disease)",
        "ObjectPropertyRange(hasLoc Anatomy)",
    ]
    for i in range(1, n_classes):
        lines.append(f"SubClassOf(C{i} C{i // 2})")
    for i in range(1, n_anatomy):
        lines.append(f"SubClassOf(Anat{i} Anatomy)")
        if i > 1:
            lines.append(
                f"SubClassOf(Anat{i} ObjectSomeValuesFrom(partOf Anat{i // 2}))"
            )
    for _ in range(n_locations):
        c = rng.randrange(n_classes)
        a = rng.randrange(1, n_anatomy)
        role = "hasExactLoc" if rng.random() < 0.3 else "hasLoc"
        lines.append(f"SubClassOf(C{c} ObjectSomeValuesFrom({role} Anat{a}))")
    for i in range(n_definitions):
        c = rng.randrange(n_classes)
        a = rng.randrange(1, n_anatomy)
        lines.append(
            f"EquivalentClasses(Def{i} ObjectIntersectionOf(C{c} "
            f"ObjectSomeValuesFrom(hasLoc Anat{a})))"
        )
    return "\n".join(lines)


def chain_tailed_ontology(
    n_classes: int,
    chain_depth: int,
    *,
    n_anatomy: Optional[int] = None,
    n_locations: Optional[int] = None,
    n_definitions: Optional[int] = None,
    seed: int = 42,
) -> str:
    """:func:`synthetic_ontology` plus a ``SubClassOf`` chain tail
    (``TailChain0 ⊑ … ⊑ TailChain{chain_depth}``, anchored by
    ``Class0 ⊑ TailChain0``) — the adaptive sparse tier's regime:
    late saturation rounds derive exactly one chain hop each, so the
    frontier density collapses while the fixed point keeps running.
    THE shared corpus recipe of the sparse-tail / pipelined / sharded
    A/B probes and their parity tests — one definition so every
    consumer measures the same regime.  Dimension defaults follow the
    GALEN shape (``n//10`` anatomy, ``n//12`` locations, ``n//20``
    definitions)."""
    text = synthetic_ontology(
        n_classes=n_classes,
        n_anatomy=n_anatomy if n_anatomy is not None else n_classes // 10,
        n_locations=(
            n_locations if n_locations is not None else n_classes // 12
        ),
        n_definitions=(
            n_definitions if n_definitions is not None else n_classes // 20
        ),
        seed=seed,
    )
    text += "\n" + "\n".join(
        f"SubClassOf(TailChain{i} TailChain{i + 1})"
        for i in range(chain_depth)
    )
    text += "\nSubClassOf(Class0 TailChain0)"
    return text


def snomed_shaped_ontology(
    n_classes: int = 2000,
    n_roles: int = 60,
    n_defs: int | None = None,
    n_assertions: int | None = None,
    seed: int = 42,
) -> str:
    """Deterministic EL+ corpus with SNOMED CT's role structure.

    Shape (mirroring the SNOMED release this framework targets as its
    north-star corpus, BASELINE.md):

    * five top-level areas (finding, procedure, body, substance,
      organism) of multi-parent is-a DAGs — ~20% of classes get a second
      parent, like SNOMED's DAG;
    * ``n_roles`` attributes in a two-level role hierarchy (SNOMED has
      ~60 active attributes, most under a handful of groupers);
    * a transitive partonomy over body structures plus right-identity
      chains (SNOMED's ``direct-substance o has-ingredient``-style
      axioms);
    * fully-defined concepts as role-group conjunctions: parent ∧
      ∃attr.filler [∧ ∃attr'.filler'] — the dominant SNOMED axiom shape;
    * primitive existential assertions for the rest.

    Unlike :func:`synthetic_ontology` (3 roles), the many-role structure
    makes the CR4/CR6 closure masks block-sparse — the realistic regime
    for the tile-skipping matmul kernel."""
    rng = random.Random(seed)
    n_defs = n_classes // 8 if n_defs is None else n_defs
    n_assertions = n_classes // 4 if n_assertions is None else n_assertions
    areas = ["Find", "Proc", "Body", "Subst", "Org"]
    per_area = max(n_classes // len(areas), 2)
    lines: List[str] = []

    # role hierarchy: grouper roles attrG0.. + leaf roles under them
    n_groupers = max(n_roles // 12, 1)
    for g in range(n_groupers):
        lines.append(f"SubObjectPropertyOf(attrG{g} attrG0)")
    for r in range(n_roles):
        g = rng.randrange(n_groupers)
        lines.append(f"SubObjectPropertyOf(attr{r} attrG{g})")
    lines.append("TransitiveObjectProperty(partOf)")
    lines.append("SubObjectPropertyOf(partOf attrG0)")
    # right-identity chains on a few leaf roles (SNOMED has ~10)
    for r in range(0, min(8, n_roles)):
        lines.append(
            f"SubObjectPropertyOf(ObjectPropertyChain(attr{r} partOf) attr{r})"
        )
    lines.append("ObjectPropertyDomain(attr0 Find)")
    lines.append("ObjectPropertyRange(attr0 Body)")

    # multi-parent is-a DAGs per area
    for area in areas:
        for i in range(1, per_area):
            lines.append(f"SubClassOf({area}{i} {area}{i // 2})")
            if i > 3 and rng.random() < 0.2:
                lines.append(
                    f"SubClassOf({area}{i} {area}{rng.randrange(1, i)})"
                )
    # partonomy over body structures
    for i in range(2, per_area):
        if rng.random() < 0.4:
            lines.append(
                f"SubClassOf(Body{i} ObjectSomeValuesFrom(partOf Body{i // 2}))"
            )

    filler_areas = ["Body", "Subst", "Org"]

    def filler(r: random.Random) -> str:
        return f"{r.choice(filler_areas)}{r.randrange(1, per_area)}"

    # fully-defined concepts: parent ∧ ∃attr.filler [∧ ∃attr'.filler']
    for i in range(n_defs):
        area = rng.choice(["Find", "Proc"])
        parent = f"{area}{rng.randrange(1, per_area)}"
        a1, a2 = rng.randrange(n_roles), rng.randrange(n_roles)
        conj = [
            parent,
            f"ObjectSomeValuesFrom(attr{a1} {filler(rng)})",
        ]
        if rng.random() < 0.5:
            conj.append(f"ObjectSomeValuesFrom(attr{a2} {filler(rng)})")
        lines.append(
            f"EquivalentClasses(SCT{i} ObjectIntersectionOf({' '.join(conj)}))"
        )
    # primitive existential assertions
    for _ in range(n_assertions):
        area = rng.choice(areas)
        c = f"{area}{rng.randrange(1, per_area)}"
        a = rng.randrange(n_roles)
        lines.append(
            f"SubClassOf({c} ObjectSomeValuesFrom(attr{a} {filler(rng)}))"
        )
    return "\n".join(lines)


def _rename_atom(e: S.ClassExpression, k: int) -> S.ClassExpression:
    if isinstance(e, S.Class):
        return S.Class(f"{e.iri}__copy{k}")
    if isinstance(e, S.Individual):
        return S.Individual(f"{e.iri}__copy{k}")
    if isinstance(e, S.ObjectIntersectionOf):
        return S.ObjectIntersectionOf(tuple(_rename_atom(o, k) for o in e.operands))
    if isinstance(e, S.ObjectSomeValuesFrom):
        return S.ObjectSomeValuesFrom(_rename_role(e.role, k), _rename_atom(e.filler, k))
    return e  # ⊤/⊥ shared across copies


def _rename_role(r: S.ObjectProperty, k: int) -> S.ObjectProperty:
    return S.ObjectProperty(f"{r.iri}__copy{k}")


def _rename_axiom(ax: S.Axiom, k: int) -> S.Axiom:
    if isinstance(ax, S.SubClassOf):
        return S.SubClassOf(_rename_atom(ax.sub, k), _rename_atom(ax.sup, k))
    if isinstance(ax, S.EquivalentClasses):
        return S.EquivalentClasses(tuple(_rename_atom(o, k) for o in ax.operands))
    if isinstance(ax, S.DisjointClasses):
        return S.DisjointClasses(tuple(_rename_atom(o, k) for o in ax.operands))
    if isinstance(ax, S.SubObjectPropertyOf):
        return S.SubObjectPropertyOf(
            tuple(_rename_role(r, k) for r in ax.chain), _rename_role(ax.sup, k)
        )
    if isinstance(ax, S.EquivalentObjectProperties):
        return S.EquivalentObjectProperties(
            tuple(_rename_role(r, k) for r in ax.operands)
        )
    if isinstance(ax, S.TransitiveObjectProperty):
        return S.TransitiveObjectProperty(_rename_role(ax.role, k))
    if isinstance(ax, S.ObjectPropertyDomain):
        return S.ObjectPropertyDomain(_rename_role(ax.role, k), _rename_atom(ax.domain, k))
    if isinstance(ax, S.ObjectPropertyRange):
        return S.ObjectPropertyRange(_rename_role(ax.role, k), _rename_atom(ax.range, k))
    if isinstance(ax, S.ClassAssertion):
        return S.ClassAssertion(_rename_atom(ax.cls, k), _rename_atom(ax.individual, k))
    if isinstance(ax, S.ObjectPropertyAssertion):
        return S.ObjectPropertyAssertion(
            _rename_role(ax.role, k),
            _rename_atom(ax.subject, k),
            _rename_atom(ax.object, k),
        )
    return ax


def multiply_ontology(onto: S.Ontology, n_copies: int, crossed: bool = False) -> S.Ontology:
    """Weak-scaling corpus builder: n disjoint renamed copies; ``crossed``
    additionally links copy k to copy k+1 with cross-copy conjunctions
    (the reference's A1⊓B2⊑C1 pattern, ``samples/OntologyMultiplier.java:97-``)."""
    out = S.Ontology(iri=onto.iri + f"-x{n_copies}")
    for k in range(n_copies):
        for ax in onto.axioms:
            out.add(_rename_axiom(ax, k))
    if crossed and n_copies >= 2:
        classes = sorted(onto.classes(), key=lambda c: c.iri)[:50]
        for k in range(n_copies - 1):
            for i in range(0, len(classes) - 1, 2):
                a = _rename_atom(classes[i], k)
                b = _rename_atom(classes[i + 1], k + 1)
                c = _rename_atom(classes[i], k + 1)
                out.add(S.SubClassOf(S.ObjectIntersectionOf((a, b)), c))
    return out


def strip_non_el(onto: S.Ontology) -> S.Ontology:
    """Drop axioms containing out-of-profile constructs (reference
    ``init/OntologyModifier.java:21-97`` / ``test/ELAxiomExtractor.java``)."""
    from distel_tpu_torch.frontend.profile_checker import axiom_in_profile

    out = S.Ontology(iri=onto.iri, prefixes=dict(onto.prefixes))
    for ax in onto.axioms:
        if axiom_in_profile(ax):
            out.add(ax)
    return out
