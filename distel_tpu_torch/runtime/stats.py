"""Corpus and result statistics.

Equivalents of the reference's analysis tools (SURVEY.md §2.6):
  * ``ontology_stats``  — axiom-shape census (``misc/OntologyStats.java:56-107``)
  * ``axiom_counts``    — before/after derivation counts
    (``output/analysis/AxiomCounter.java:40-``)
  * ``result_stats``    — avg/max subsumer- and link-set sizes
    (``DataStats.java:12-65``)
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np

from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.owl import loader as owl_loader, syntax as S


def ontology_stats(path_or_text: str) -> Dict:
    if "\n" in path_or_text:
        onto = owl_loader.load(path_or_text)
    else:
        onto = owl_loader.load_file(path_or_text)
    kinds = Counter(type(ax).__name__ for ax in onto.axioms)
    exprs = Counter()
    max_conj = 0
    max_depth = 0

    def depth(e, d=0):
        nonlocal max_conj, max_depth
        max_depth = max(max_depth, d)
        if isinstance(e, S.ObjectIntersectionOf):
            max_conj = max(max_conj, len(e.operands))
            exprs["intersection"] += 1
            for o in e.operands:
                depth(o, d + 1)
        elif isinstance(e, S.ObjectSomeValuesFrom):
            exprs["existential"] += 1
            depth(e.filler, d + 1)

    for ax in onto.axioms:
        if isinstance(ax, S.SubClassOf):
            depth(ax.sub)
            depth(ax.sup)
        elif isinstance(ax, (S.EquivalentClasses, S.DisjointClasses)):
            for o in ax.operands:
                depth(o)
    return {
        "axioms": len(onto.axioms),
        "classes": len(onto.classes()),
        "roles": len(onto.roles()),
        "individuals": len(onto.individuals()),
        "axiom_kinds": dict(kinds),
        "expressions": dict(exprs),
        "max_conjunction_arity": max_conj,
        "max_nesting_depth": max_depth,
    }


def axiom_counts(result: SaturationResult) -> Dict[str, int]:
    """Told vs derived counts (AxiomCounter parity): told = input NF rows,
    derived = closure bits."""
    idx = result.idx
    n = idx.n_concepts
    return {
        "told_nf1": len(idx.nf1),
        "told_nf2": len(idx.nf2),
        "told_nf3": len(idx.nf3),
        "told_nf4": len(idx.nf4),
        "derived_subsumptions": int(result.s[:n, :n].sum()) - 2 * n + 1,
        "derived_role_pairs": int(result.r[:n, : idx.n_links].sum()),
    }


def result_stats(result: SaturationResult) -> Dict[str, float]:
    idx = result.idx
    n = idx.n_concepts
    s_sizes = result.s[:n, :n].sum(axis=1)
    r_sizes = result.r[:n, : idx.n_links].sum(axis=1) if idx.n_links else np.zeros(n)
    return {
        "avg_subsumer_set": float(s_sizes.mean()),
        "max_subsumer_set": int(s_sizes.max()),
        "avg_link_set": float(r_sizes.mean()),
        "max_link_set": int(r_sizes.max()) if len(r_sizes) else 0,
    }
