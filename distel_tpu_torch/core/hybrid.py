"""Per-rule backend routing — the reference's rule→node plugin boundary.

The port of ``distel_tpu/core/hybrid.py``.  ``ClassifierConfig.
rule_backends`` maps ``"CR1".."CR6"`` to the device backend (the
reference's spellings ``tpu``, ``xla``, ``device``; the default) or to
the host (``host``, ``cpu``, ``oracle``, ``redis``).
:func:`split_backends` and :func:`apply_rules_host` are copies of the
reference's, apart from the imports.

``HybridSaturator`` alternates global rounds: the port's row-packed
engine saturates its rule subset to a fixed point on its device, then
the host applies the routed-out rules to their own fixed point
(vectorized numpy on the transposed bool matrices — the same formulas
as the engines, spec in ``core/oracle.py``), and hands the state back
through the engine's ``embed_state``; convergence is reached when a
host pass derives nothing new.  ``iterations`` and ``derivations`` sum
over the rounds, as in the reference.

On a mesh (``engine_kw={"mesh": ...}``, as the reference's classifier
passes it) the row-packed engine runs the device rules on each rank's
word window; its result is the gathered closure on every rank, so each
rank runs the same host pass over it, and the embed hands every rank
its window of the outcome.

This path exists for the plugin boundary and cross-backend
verification, not speed — routed rules run at host numpy rates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.core.indexing import BOTTOM_ID, IndexedOntology

ALL_RULES = frozenset(f"CR{i}" for i in range(1, 7))
_HOST_ALIASES = {"host", "cpu", "oracle", "redis"}
_TPU_ALIASES = {"tpu", "xla", "device"}


def split_backends(rule_backends: dict) -> Tuple[frozenset, frozenset]:
    """Validate and split ``rule_backends`` → (tpu_rules, host_rules)."""
    host = set()
    for rule, backend in rule_backends.items():
        if rule not in ALL_RULES:
            raise ValueError(
                f"unknown rule {rule!r}: expected one of {sorted(ALL_RULES)}"
            )
        if backend in _HOST_ALIASES:
            host.add(rule)
        elif backend not in _TPU_ALIASES:
            raise ValueError(
                f"unknown backend {backend!r} for {rule}: "
                f"expected one of {sorted(_TPU_ALIASES | _HOST_ALIASES)}"
            )
    return frozenset(ALL_RULES - host), frozenset(host)


def apply_rules_host(
    idx: IndexedOntology, st: np.ndarray, rt: np.ndarray, rules
) -> int:
    """One host pass of ``rules`` over the transposed bool matrices
    ``st`` [a, x] / ``rt`` [l, x] (mutated in place).  Returns the number
    of new bits in live x columns."""
    n = idx.n_concepts
    before = int(st[:, :n].sum()) + int(rt[:, :n].sum())
    h = idx.role_closure
    link_roles = idx.links[:, 0] if idx.n_links else None
    fillers = idx.links[:, 1] if idx.n_links else None
    if "CR1" in rules and len(idx.nf1):
        np.logical_or.at(st, idx.nf1[:, 1], st[idx.nf1[:, 0]])
    if "CR2" in rules and len(idx.nf2):
        np.logical_or.at(
            st, idx.nf2[:, 2], st[idx.nf2[:, 0]] & st[idx.nf2[:, 1]]
        )
    if "CR3" in rules and len(idx.nf3):
        np.logical_or.at(rt, idx.nf3[:, 1], st[idx.nf3[:, 0]])
    if "CR4" in rules and len(idx.nf4) and idx.n_links:
        m4 = h[link_roles][:, idx.nf4[:, 0]].T          # [K4, L]
        f4 = st[idx.nf4[:, 1]][:, fillers]              # [K4, L]
        out = ((m4 & f4).astype(np.float32) @ rt[: len(fillers)].astype(np.float32)) > 0
        np.logical_or.at(st, idx.nf4[:, 2], out)
    if "CR6" in rules and len(idx.chain_pairs) and idx.n_links:
        cp = idx.chain_pairs
        m6 = h[link_roles][:, cp[:, 0]].T               # [P, L]
        f6 = rt[cp[:, 1]][:, fillers]                   # [P, L]
        out = ((m6 & f6).astype(np.float32) @ rt[: len(fillers)].astype(np.float32)) > 0
        np.logical_or.at(rt, cp[:, 2], out)
    if "CR5" in rules and idx.has_bottom_axioms and idx.n_links:
        botf = st[BOTTOM_ID][fillers]                   # [L]
        if botf.any():
            st[BOTTOM_ID] |= rt[: len(fillers)][botf].any(axis=0)
    after = int(st[:, :n].sum()) + int(rt[:, :n].sum())
    return after - before


class HybridSaturator:
    """Saturates with the row-packed engine on ``device`` applying the
    device rules and the host applying ``host_rules``, alternating to a
    global fixed point.  API matches the engines' ``saturate``;
    ``engine_kw``: extra row-packed engine kwargs (``pad_multiple``,
    ``mesh``)."""

    #: delegates embedding to the row-packed engine
    accepts_wire_state = True

    def __init__(
        self,
        idx: IndexedOntology,
        rule_backends: dict,
        *,
        device="cuda",
        engine_kw: Optional[dict] = None,
    ):
        from distel_tpu_torch.core.rowpacked_engine import (
            RowPackedSaturationEngine,
        )

        self.idx = idx
        self.tpu_rules, self.host_rules = split_backends(rule_backends)
        self.engine = RowPackedSaturationEngine(
            idx, rules=self.tpu_rules, device=device, **(engine_kw or {})
        )

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial=None,
        allow_incomplete: bool = False,
        max_rounds: int = 256,
    ) -> SaturationResult:
        state = initial
        iterations = 0
        derivations = 0
        result = None
        converged = False
        for _ in range(max_rounds):
            result = self.engine.saturate(
                max_iters, initial=state, allow_incomplete=allow_incomplete
            )
            iterations += result.iterations
            derivations += result.derivations
            if not self.host_rules:
                converged = True
                break
            st = np.ascontiguousarray(result.s.T)
            rt = np.ascontiguousarray(result.r.T)
            # host-local fixed point of the routed rules — one
            # application per round would make deep host-routed chains
            # need one global round per level
            new = 0
            while True:
                got = apply_rules_host(self.idx, st, rt, self.host_rules)
                new += got
                if got == 0:
                    break
            if new == 0:
                converged = True
                break
            derivations += new
            state = (st.T, rt.T)
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"hybrid saturation did not converge within {max_rounds} rounds"
            )
        result.iterations = iterations
        result.derivations = derivations
        result.converged = converged
        return result
