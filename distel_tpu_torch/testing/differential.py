"""Differential verification: a saturation result against the CPU oracle.

The port of ``distel_tpu/testing/differential.py``: run the independent
reasoner of ``core/oracle.py`` (Python sets, no tensors) on the same
normalized ontology and compare every concept's subsumer set by name.
Like the reference, :func:`diff_engine_vs_oracle` returns every
per-concept discrepancy rather than failing fast.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Set, Tuple

from distel_tpu_torch.core import oracle as oracle_mod
from distel_tpu_torch.core.engine import SaturationEngine, SaturationResult
from distel_tpu_torch.core.indexing import atom_key, index_ontology
from distel_tpu_torch.frontend.normalizer import NormalizedOntology


@dataclass
class DiffReport:
    """Per-concept subsumer differences (engine vs oracle), restricted to
    atoms both sides know (gensym/aux ids that exist only on one side are
    projected away)."""

    missing: Dict[str, Set[str]] = field(default_factory=dict)  # oracle-only
    extra: Dict[str, Set[str]] = field(default_factory=dict)    # engine-only
    compared: int = 0

    @property
    def miss_count(self) -> int:
        return sum(len(v) for v in self.missing.values()) + sum(
            len(v) for v in self.extra.values()
        )

    def ok(self) -> bool:
        return self.miss_count == 0

    def summary(self) -> str:
        if self.ok():
            return f"OK: {self.compared} concepts identical"
        lines = [f"MISMATCH: {self.miss_count} differences"]
        for c, v in sorted(self.missing.items()):
            lines.append(f"  {c}: engine missing {sorted(v)}")
        for c, v in sorted(self.extra.items()):
            lines.append(f"  {c}: engine extra {sorted(v)}")
        return "\n".join(lines)


def diff_engine_vs_oracle(
    norm: NormalizedOntology,
    result: SaturationResult,
    oracle_result: "oracle_mod.OracleResult | None" = None,
) -> DiffReport:
    """Every atom of ``norm`` that ``result``'s index knows: its
    subsumers by name against the oracle's (either engine's result)."""
    if oracle_result is None:
        oracle_result = oracle_mod.saturate(norm)
    idx = result.idx
    s = result.s
    report = DiffReport()
    for atom in sorted(norm.atoms(), key=atom_key):
        name = atom_key(atom)
        cid = idx.concept_ids.get(name)
        if cid is None:
            continue
        engine_sups = {
            idx.concept_names[i]
            for i in s[cid].nonzero()[0].tolist()
            if i < idx.n_concepts
        }
        oracle_sups = {atom_key(a) for a in oracle_result.subsumers.get(atom, set())}
        # project to the shared vocabulary: the oracle knows nothing of
        # the binarization aux concepts
        engine_sups = {n for n in engine_sups if not n.startswith("distel:aux#")}
        report.compared += 1
        miss = oracle_sups - engine_sups
        extra = engine_sups - oracle_sups
        if miss:
            report.missing[name] = miss
        if extra:
            report.extra[name] = extra
    return report


def classify_and_diff(
    norm: NormalizedOntology, *, device="cuda", **engine_kwargs
) -> Tuple[SaturationResult, DiffReport]:
    """Index ``norm``, saturate it on the dense engine on ``device``,
    and diff the result against the oracle."""
    idx = index_ontology(norm)
    result = SaturationEngine(idx, device=device, **engine_kwargs).saturate()
    return result, diff_engine_vs_oracle(norm, result)
