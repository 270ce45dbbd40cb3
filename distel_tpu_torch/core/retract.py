"""DRed-style retraction: delete told rows, overdelete, re-derive.

The reference has no retraction path at all — deletion means wiping the
Redis stores and re-running the full classification
(``scripts/traffic-data-load-classify.sh``).  This module is the
delete-and-rederive core of the retraction subsystem (ISSUE 16), after
Gupta/Mumick/Subrahmanian's *Maintaining Views Incrementally* (DRed):

1. **Locate** the told rows a previously-ingested axiom text produced.
   ``IncrementalClassifier`` appends each batch's normalized rows onto
   the accumulated corpus in order, so every ingest owns one CONTIGUOUS
   span per NF family — provenance is six ``(start, end)`` pairs, and
   contiguity survives earlier retractions (later spans shift down).
2. **Overdelete**: compute the set of concept rows whose derived bits
   could possibly be supported by the dead rows.  We seed with the
   concepts the dead rows touch (the standard DRed overcount — no
   per-bit provenance is kept) and close under the one cross-row data
   flow of CR1–CR6: every rule that moves a bit between rows moves it
   from a link's FILLER row to the link's HOLDER row (CR4 existential
   discharge, CR5/⊥ propagation, CR6 chain composition), so
   ``x`` is affected whenever ``R[x, l]`` holds and ``filler(l)`` is
   affected.  Whole S/R rows of affected concepts are cleared.
3. **Re-derive**: saturate from the surviving told axioms with the
   cleared state as warm start.  Monotone EL+ makes this sound: cleared
   rows re-derive exactly the survivor-supported closure, and bits in
   unaffected rows were survivor-derivable by construction of the
   overcount.  The caller runs the existing rebuild machinery
   (``IncrementalClassifier._full_rebuild``), which under shape buckets
   is a program-registry hit — a small repair compiles nothing.

Provenance is *enough*, not exact: a retraction is REFUSED (a)
when the text was never ingested (or already retracted), (b) when a
normalization gensym/genrole minted by the dying batch is shared with a
surviving batch (the normalizer memo re-uses gensym names without
re-emitting their defining rows, so the defining rows live only in the
minting batch), or (c) when range-elimination machinery is active
(range retrofits emit rows for OLD axioms into LATER batches, breaking
the span-ownership invariant).  Conservative refusal keeps the repair
byte-identical to a from-scratch classify of the survivors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from distel_tpu_torch.core.indexing import atom_key

#: the NormalizedOntology row families a span covers, in merge order
NF_FAMILIES = ("nf1", "nf2", "nf3", "nf4", "nf5", "nf6")

GENSYM_PREFIXES = ("distel:gensym#", "distel:genrole#")


class RetractionError(ValueError):
    """Base of every refusal the retraction engine can raise; the serve
    plane maps subclasses onto HTTP statuses (404 unknown / 409
    entangled)."""


class UnknownRetraction(RetractionError):
    """The text was never ingested into this classifier (or was already
    retracted) — there are no rows to remove."""


class EntangledRetraction(RetractionError):
    """The batch's rows cannot be removed without breaking surviving
    batches: a shared normalization gensym or active range machinery
    ties them together.  Retracting would silently change survivors'
    semantics, so the engine refuses instead."""


# ------------------------------------------------------------ provenance


def find_ingest(ingests: List[dict], text: str) -> int:
    """Index of the MOST RECENT live ingest of ``text`` (the natural
    reading of "retract what I added"; duplicate ingests retract one at
    a time, newest first)."""
    for k in range(len(ingests) - 1, -1, -1):
        rec = ingests[k]
        if not rec.get("retracted") and rec.get("text") == text:
            return k
    raise UnknownRetraction(
        "text was never ingested (or was already retracted) — "
        "retraction needs the exact text of a live prior add"
    )


def dead_rows(accumulated, spans: Dict[str, Tuple[int, int]]) -> Dict[str, list]:
    """The told rows a span set owns, by NF family (the rows that die)."""
    out = {}
    for fam in NF_FAMILIES:
        start, end = spans[fam]
        out[fam] = list(getattr(accumulated, fam)[start:end])
    return out


def _row_atoms(fam: str, row):
    if fam == "nf1":
        return row
    if fam == "nf2":
        ops, b = row
        return (*ops, b)
    if fam == "nf3":
        a, _r, b = row
        return (a, b)
    if fam == "nf4":
        _r, a, b = row
        return (a, b)
    return ()


def _row_roles(fam: str, row):
    if fam == "nf3":
        return (row[1],)
    if fam == "nf4":
        return (row[0],)
    if fam in ("nf5", "nf6"):
        return tuple(row)
    return ()


def _gensym_names(rows_by_family: Dict[str, list]) -> set:
    names = set()
    for fam, rows in rows_by_family.items():
        for row in rows:
            for a in _row_atoms(fam, row):
                k = atom_key(a)
                if k.startswith(GENSYM_PREFIXES):
                    names.add(k)
            for r in _row_roles(fam, row):
                if r.iri.startswith(GENSYM_PREFIXES):
                    names.add(r.iri)
    return names


def check_entanglement(
    accumulated,
    spans: Dict[str, Tuple[int, int]],
    dead: Dict[str, list],
) -> None:
    """Refuse when a gensym/genrole minted by the dying rows also
    appears in surviving rows: the normalizer memo re-uses gensym names
    across batches WITHOUT re-emitting their defining rows, so removing
    the minting batch would leave survivors referencing an undefined
    name (silent incompleteness).  Conservative by design — shared
    names are rare outside pathological duplicate corpora."""
    dead_syms = _gensym_names(dead)
    if not dead_syms:
        return
    survivors: Dict[str, list] = {}
    for fam in NF_FAMILIES:
        start, end = spans[fam]
        rows = getattr(accumulated, fam)
        survivors[fam] = list(rows[:start]) + list(rows[end:])
    shared = dead_syms & _gensym_names(survivors)
    if shared:
        raise EntangledRetraction(
            "retraction refused: normalization gensyms "
            f"{sorted(shared)[:5]} are shared with surviving batches "
            "(the defining rows live only in the batch being retracted)"
        )


def remove_spans(
    accumulated, ingests: List[dict], k: int
) -> Dict[str, list]:
    """Delete ingest ``k``'s rows from the accumulated corpus, shift
    every LATER ingest's spans down, and mark ``k`` retracted.  Returns
    the removed rows by family.  Caller has already run every refusal
    check — this mutates."""
    spans = ingests[k]["spans"]
    dead = {}
    for fam in NF_FAMILIES:
        start, end = spans[fam]
        rows = getattr(accumulated, fam)
        dead[fam] = list(rows[start:end])
        del rows[start:end]
        removed = end - start
        if removed:
            for later in ingests[k + 1:]:
                if later.get("retracted"):
                    continue
                s2, e2 = later["spans"][fam]
                later["spans"][fam] = (s2 - removed, e2 - removed)
    ingests[k]["retracted"] = True
    ingests[k]["spans"] = None
    dead_syms = _gensym_names(dead)
    for name in dead_syms:
        accumulated.gensyms.pop(name, None)
    return dead


def purge_normalizer_cache(cache: Dict[str, str], dead: Dict[str, list]) -> int:
    """Drop memo entries whose gensym died with the retracted rows, so
    a later re-add of the same text mints a FRESH gensym and re-emits
    its defining rows (the memo contract is "the rows live in the
    corpus the cache came from" — no longer true for dead names).
    Re-use of a dead name's concept id by a future mint is sound: the
    repair cleared the dead concept's S/R row back to the fresh-concept
    init."""
    dead_syms = _gensym_names(dead)
    if not dead_syms:
        return 0
    doomed = [key for key, name in cache.items() if name in dead_syms]
    for key in doomed:
        del cache[key]
    return len(doomed)


# ----------------------------------------------------------- overdeletion


def affected_concepts(idx, s, r, dead: Dict[str, list]) -> np.ndarray:
    """Boolean mask (over the x-major rows of ``s``) of concepts whose
    derived bits could be supported by the dead rows — the DRed
    overdeletion set.

    Seeds per family (``idx``/``s``/``r`` are the PRE-removal index and
    closure — the overcount is over what the old closure could have
    derived):

    - nf1 ``a ⊑ b``: every ``x`` with ``S[x, a]`` (CR1 fired there).
    - nf2 ``a1 ⊓ … ⊓ an ⊑ b``: every ``x`` with ``S[x, a1] ∧ S[x, a2]``
      — every binarized intermediate (shared aux concepts) and the
      final bit all require at least the first two conjuncts.
    - nf3 ``a ⊑ ∃r.b``: every ``x`` with ``S[x, a]`` (CR3 minted links
      there).
    - nf4 ``∃r.a ⊑ b``: every ``x`` holding a link whose role ⊑* r
      (CR4 could have discharged through it).
    - nf5/nf6 (role hierarchy / chains): every ``x`` holding any link —
      coarse, but role-axiom retraction reshapes the whole role closure.

    Plus every concept the dead rows mention (their own rows go back to
    the fresh-concept init — keeps dead gensym/concept ids cleanly
    reusable).  Then the fixpoint: ``x`` is affected whenever
    ``R[x, l]`` with ``filler(l)`` affected — the only cross-row data
    flow in CR1–CR6 (CR4/CR5/CR6 all move bits filler → holder)."""
    s = np.asarray(s, bool)
    r = np.asarray(r, bool)
    nx = s.shape[0]
    aff = np.zeros(nx, bool)

    def cid(atom) -> Optional[int]:
        return idx.concept_ids.get(atom_key(atom))

    for a, _b in dead["nf1"]:
        c = cid(a)
        if c is not None and c < s.shape[1]:
            aff |= s[:, c]
    for ops, _b in dead["nf2"]:
        c0, c1 = cid(ops[0]), cid(ops[1])
        if c0 is not None and c1 is not None:
            aff |= s[:, c0] & s[:, c1]
    for a, _r, _b in dead["nf3"]:
        c = cid(a)
        if c is not None and c < s.shape[1]:
            aff |= s[:, c]
    n_links = len(idx.links)
    rl = r[:, :n_links] if n_links else r[:, :0]
    for ro, _a, _b in dead["nf4"]:
        rid = idx.role_ids.get(ro.iri)
        if rid is None or not n_links:
            continue
        covered = idx.role_closure[idx.links[:, 0], rid].astype(bool)
        if covered.any():
            aff |= rl[:, covered].any(axis=1)
    if (dead["nf5"] or dead["nf6"]) and n_links:
        aff |= rl.any(axis=1)
    for fam in NF_FAMILIES:
        for row in dead[fam]:
            for a in _row_atoms(fam, row):
                c = cid(a)
                if c is not None and c < nx:
                    aff[c] = True
    if n_links:
        fillers = idx.links[:, 1]
        while True:
            hot = aff[fillers]
            if not hot.any():
                break
            grew = rl[:, hot].any(axis=1) & ~aff
            if not grew.any():
                break
            aff |= grew
    return aff


def clear_rows(
    s, r, aff: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Cleared copies of the closure: affected concepts' S and R rows
    zeroed (the saturation engine's embed re-ORs the ``S(x)={x,⊤}``
    init, so a cleared row warm-starts exactly like a fresh concept)."""
    s2 = np.array(s, dtype=bool, copy=True)
    r2 = np.array(r, dtype=bool, copy=True)
    s2[aff, :] = False
    r2[aff, :] = False
    return s2, r2
