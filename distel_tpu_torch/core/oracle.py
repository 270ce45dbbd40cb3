"""Ground-truth EL+ saturation on the normalized IR (pure Python).

The unit/property-test oracle the reference never had (it tested only
end-to-end against ELK, reference ``test/ELClassifierTest.java:363-446``).
Implements the CR1-CR6 completion rules of "Pushing the EL Envelope"
(the rule set named at reference
``init/AxiomDistributionType.java:3-31``) directly over Python sets, with
R(r) as explicit pair sets — deliberately *different* data structures from
the TPU engine's link-matrix formulation, so differential tests catch
indexing/closure bugs in either side.

Rules (S(X) = subsumer set, R(r) = role pairs):
  CR1  A ⊑ B,        A ∈ S(X)                       → B ∈ S(X)
  CR2  A1⊓...⊓An ⊑ B, Ai ∈ S(X) ∀i                  → B ∈ S(X)
  CR3  A ⊑ ∃r.B,     A ∈ S(X)                       → (X,B) ∈ R(r)
  CR4  ∃r.A ⊑ B,     (X,Y) ∈ R(r), A ∈ S(Y)         → B ∈ S(X)
  CR5  ⊥ ∈ S(Y),     (X,Y) ∈ R(r)                   → ⊥ ∈ S(X)
  CR5' r ⊑ s,        (X,Y) ∈ R(r)                   → (X,Y) ∈ R(s)
  CR6' r∘s ⊑ t,      (X,Y) ∈ R(r), (Y,Z) ∈ R(s)     → (X,Z) ∈ R(t)
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

from distel_tpu_torch.frontend.normalizer import NormalizedOntology
from distel_tpu_torch.owl import syntax as S

Atom = S.ClassExpression
Role = S.ObjectProperty


class OracleResult:
    def __init__(
        self, subsumers: Dict[Atom, Set[Atom]], role_pairs, converged=True
    ):
        self.subsumers = subsumers
        self.role_pairs = role_pairs
        self.converged = converged

    def is_subsumed(self, sub: Atom, sup: Atom) -> bool:
        sups = self.subsumers.get(sub, set())
        # an unsatisfiable class is subsumed by everything
        return sup in sups or S.OWL_NOTHING in sups

    def unsatisfiable(self) -> Set[Atom]:
        return {
            x for x, sups in self.subsumers.items() if S.OWL_NOTHING in sups
        }

    def derivation_count(self) -> int:
        return sum(len(v) for v in self.subsumers.values()) + sum(
            len(v) for v in self.role_pairs.values()
        )

    def derived_count(self) -> int:
        """Facts beyond the S(X)={X,⊤} initialization — the unit the
        engines' ``derivations`` field uses (total bits − init bits), so
        engine/oracle throughput ratios compare like with like.  The
        init holds 2 facts per atom except ⊤ itself ({⊤} only)."""
        init = 2 * len(self.subsumers) - (
            1 if S.OWL_THING in self.subsumers else 0
        )
        return max(self.derivation_count() - init, 0)


def saturate(
    norm: NormalizedOntology,
    max_iters: int = 10_000,
    time_budget_s: Optional[float] = None,
) -> OracleResult:
    """``time_budget_s`` stops after the first iteration that exceeds
    the budget, returning the partial (sound, possibly incomplete)
    result with ``converged=False`` — for bounded baseline throughput
    measurements (bench.py); correctness consumers must leave it None."""
    universe = set(norm.atoms())
    universe.add(S.OWL_THING)
    universe.add(S.OWL_NOTHING)

    # S stored inverted, like the reference result node
    # (`init/AxiomLoader.java:1237-1245`): inv[a] = {x : a ∈ S(x)}
    inv: Dict[Atom, Set[Atom]] = {a: {a} for a in universe}
    inv[S.OWL_THING] = set(universe)
    rp: Dict[Role, Set[Tuple[Atom, Atom]]] = {}

    def size() -> int:
        return sum(len(v) for v in inv.values()) + sum(len(v) for v in rp.values())

    deadline = (
        time.monotonic() + time_budget_s if time_budget_s is not None else None
    )
    prev = -1
    iters = 0
    while size() != prev:
        prev = size()
        iters += 1
        if iters > max_iters:
            raise RuntimeError("oracle failed to converge")

        # NB: snapshots (list/copy) guard the self-referential cases
        # (a ⊑ a-cycles, transitive r∘r⊑r) where source and target alias.
        for a, b in norm.nf1:
            inv.setdefault(b, set()).update(list(inv.get(a, ())))
        for ops, b in norm.nf2:
            acc = set(inv.get(ops[0], ()))
            for op in ops[1:]:
                acc &= inv.get(op, set())
            inv.setdefault(b, set()).update(acc)
        for a, r, b in norm.nf3:
            pairs = rp.setdefault(r, set())
            for x in list(inv.get(a, ())):
                pairs.add((x, b))
        for r, a, b in norm.nf4:
            tgt = inv.setdefault(b, set())
            amembers = inv.get(a, set())
            for (x, y) in list(rp.get(r, ())):
                if y in amembers:
                    tgt.add(x)
        # CR5 bottom propagation
        bot = inv.setdefault(S.OWL_NOTHING, set())
        for r, pairs in rp.items():
            for (x, y) in list(pairs):
                if y in bot:
                    bot.add(x)
        # role hierarchy
        for r, s in norm.nf5:
            rp.setdefault(s, set()).update(list(rp.get(r, ())))
        # role chains
        for r, s, t in norm.nf6:
            rs = rp.get(r, set())
            ss = rp.get(s, set())
            if not rs or not ss:
                continue
            by_first: Dict[Atom, Set[Atom]] = {}
            for (y, z) in ss:
                by_first.setdefault(y, set()).add(z)
            tgt = rp.setdefault(t, set())
            for (x, y) in list(rs):
                for z in by_first.get(y, ()):
                    tgt.add((x, z))
        if deadline is not None and time.monotonic() > deadline:
            break

    # invert back to direct S(X) form (reference ResultRearranger,
    # `test/ResultRearranger.java:57-105`)
    subs: Dict[Atom, Set[Atom]] = {x: set() for x in universe}
    for a, xs in inv.items():
        for x in xs:
            subs.setdefault(x, set()).add(a)
    converged = size() == prev
    return OracleResult(subs, rp, converged)
