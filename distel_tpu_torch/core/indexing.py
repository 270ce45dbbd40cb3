"""Indexing: normalized IR → dense integer tensors for the TPU engine.

The analog of the reference's load plane (``init/AxiomLoader.java``):
  * every entity gets a dense int id (replacing the packed string ids of
    ``misc/Util.java:95-103``), with ⊥=0 / ⊤=1 exactly like the reference's
    ``BOTTOM_ID=0 / TOP_ID=1`` (``misc/Constants.java:30-31``);
  * axioms are categorized by normal form into flat numpy arrays (replacing
    the per-rule Redis shard layout of ``init/AxiomLoader.java:495-577``);
  * n-ary conjunctions are binarized with shared auxiliary concepts so CR2
    becomes a fixed-arity column AND (the reference instead runs an n-way
    ZINTERSTORE Lua, ``base/Type1_2AxiomProcessorBase.java:45-66``).

TPU-first representation — the **link table**: during EL+ saturation every
role pair (X,Y) ∈ R(r) has Y drawn from the finite set of existential
fillers, so instead of per-role boolean matrices ``R[r][X,Y]`` (the naive
translation of the reference's ``Yr → {X}`` key layout,
``RolePairHandler.java:396-444``) we materialize the set of *links*
L = {(r, B)} closed under role-chain targets, and keep one boolean matrix
``R[x, l]``.  All rule applications then become column gathers/scatters or
matmuls over the link axis (see ``core/engine.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from distel_tpu_torch.frontend.normalizer import NormalizedOntology
from distel_tpu_torch.owl import syntax as S

BOTTOM_ID = 0  # reference misc/Constants.java:31
TOP_ID = 1     # reference misc/Constants.java:30

AUX_PREFIX = "distel:aux#"


def atom_key(atom: S.ClassExpression) -> str:
    if atom is S.OWL_THING or atom == S.OWL_THING:
        return "owl:Thing"
    if atom is S.OWL_NOTHING or atom == S.OWL_NOTHING:
        return "owl:Nothing"
    if isinstance(atom, S.Individual):
        return f"ind:{atom.iri}"
    return atom.iri


@dataclass
class IndexedOntology:
    """Flat tensor form of a normalized ontology.

    Array conventions (all int32):
      nf1        [K1, 2]  rows (a, b)          : a ⊑ b
      nf2        [K2, 3]  rows (a1, a2, b)     : a1 ⊓ a2 ⊑ b (binarized)
      nf3        [K3, 2]  rows (a, l)          : a ⊑ ∃role(l).filler(l)
      nf4        [K4, 3]  rows (s, a, b)       : ∃s.a ⊑ b
      links      [L, 2]   rows (role, filler)
      chain_pairs[P, 3]   rows (r_first, l2, lt): precomputed second-leg
                 expansion of every chain axiom r∘s⊑t — for a link l2 whose
                 role ⊑* s, a pair over l2 starting at filler(l1) extends any
                 l1-pair (role(l1) ⊑* r_first) to the link lt=(t, filler(l2)).
      role_closure [Nr, Nr] bool: H[r, s] = r ⊑* s (reflexive-transitive)
    """

    n_concepts: int
    n_roles: int
    concept_names: List[str]
    concept_ids: Dict[str, int]
    role_names: List[str]
    role_ids: Dict[str, int]
    nf1: np.ndarray
    nf2: np.ndarray
    nf3: np.ndarray
    nf4: np.ndarray
    links: np.ndarray
    chain_pairs: np.ndarray
    role_closure: np.ndarray
    #: ids of original (non-gensym, non-aux) named classes — the signature
    #: the taxonomy/export layer projects onto
    original_classes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    has_bottom_axioms: bool = False
    #: out-of-profile axiom kinds dropped during loading (populated by the
    #: native load plane; the Python path reports via NormalizedOntology.removed)
    removed: Dict[str, int] = field(default_factory=dict)

    @property
    def n_links(self) -> int:
        return len(self.links)

    def stats(self) -> Dict[str, int]:
        return {
            "concepts": self.n_concepts,
            "roles": self.n_roles,
            "links": self.n_links,
            "nf1": len(self.nf1),
            "nf2": len(self.nf2),
            "nf3": len(self.nf3),
            "nf4": len(self.nf4),
            "chain_pairs": len(self.chain_pairs),
        }


class Indexer:
    """Entity interning + axiom tensorization.

    An Indexer instance is *persistent*: calling ``index`` again with a
    grown axiom set keeps every previously-assigned concept/role/link id
    stable — the property incremental classification relies on to embed a
    saturated S/R state into the larger arrays (the reference's analog is
    the Redis stores simply persisting across ``CURRENT_INCREMENT`` bumps,
    ``init/AxiomLoader.java:119-129``).
    """

    def __init__(self) -> None:
        self.concept_ids: Dict[str, int] = {"owl:Nothing": BOTTOM_ID, "owl:Thing": TOP_ID}
        self.concept_names: List[str] = ["owl:Nothing", "owl:Thing"]
        self.role_ids: Dict[str, int] = {}
        self.role_names: List[str] = []
        self.link_ids: Dict[Tuple[int, int], int] = {}
        self.link_rows: List[Tuple[int, int]] = []
        self._aux_counter = 0
        self._aux_memo: Dict[Tuple[int, int], int] = {}

    def concept(self, atom: S.ClassExpression) -> int:
        k = atom_key(atom)
        cid = self.concept_ids.get(k)
        if cid is None:
            cid = len(self.concept_names)
            self.concept_ids[k] = cid
            self.concept_names.append(k)
        return cid

    def role(self, r: S.ObjectProperty) -> int:
        rid = self.role_ids.get(r.iri)
        if rid is None:
            rid = len(self.role_names)
            self.role_ids[r.iri] = rid
            self.role_names.append(r.iri)
        return rid

    def _aux_concept(self, a1: int, a2: int) -> int:
        """Shared auxiliary concept for binarization: aux ⊒ a1 ⊓ a2."""
        key = (a1, a2) if a1 <= a2 else (a2, a1)
        cid = self._aux_memo.get(key)
        if cid is None:
            cid = len(self.concept_names)
            name = f"{AUX_PREFIX}{self._aux_counter}"
            self._aux_counter += 1
            self.concept_ids[name] = cid
            self.concept_names.append(name)
            self._aux_memo[key] = cid
        return cid

    def index(self, norm: NormalizedOntology) -> IndexedOntology:
        # intern all atoms first so original classes get stable low ids
        for atom in sorted(norm.atoms(), key=atom_key):
            self.concept(atom)
        for r in sorted(norm.roles(), key=lambda r: r.iri):
            self.role(r)

        nf1_rows: List[Tuple[int, int]] = []
        nf2_rows: List[Tuple[int, int, int]] = []
        nf3_rows: List[Tuple[int, int]] = []  # (a, link)
        nf4_rows: List[Tuple[int, int, int]] = []
        nf5_rows: List[Tuple[int, int]] = []
        nf6_rows: List[Tuple[int, int, int]] = []

        for a, b in norm.nf1:
            nf1_rows.append((self.concept(a), self.concept(b)))
        for ops, b in norm.nf2:
            ids = [self.concept(o) for o in ops]
            # left-fold with shared aux concepts: a1⊓a2⊑x12, x12⊓a3⊑x123, ...
            acc = ids[0]
            for i in range(1, len(ids) - 1):
                aux = self._aux_concept(acc, ids[i])
                nf2_rows.append((acc, ids[i], aux))
                acc = aux
            nf2_rows.append((acc, ids[-1], self.concept(b)))
        for r, s in norm.nf5:
            nf5_rows.append((self.role(r), self.role(s)))
        for r, s, t in norm.nf6:
            nf6_rows.append((self.role(r), self.role(s), self.role(t)))

        n_roles = len(self.role_names)
        closure = _role_closure(n_roles, nf5_rows)

        # link table: distinct (role, filler) from NF3, then closed under
        # chain targets (t, filler(l2)) — the finite universe of R-columns.
        link_ids = self.link_ids
        links = self.link_rows

        def link(r: int, f: int) -> int:
            lid = link_ids.get((r, f))
            if lid is None:
                lid = len(links)
                link_ids[(r, f)] = lid
                links.append((r, f))
            return lid

        # intern NEW links sorted by role: with link rows grouped by role,
        # the CR4/CR6 operand's nonzeros (closure-mask ∧ bit-table)
        # cluster into role-diagonal tiles, which the tile-skipping matmul
        # kernel then skips (measured 0.94 → 0.066 live-tile fraction on a
        # 66-role corpus).  Previously-interned ids stay put — increments
        # only append, preserving the stable-id contract above.
        new_pairs = set()
        for a, r, b in norm.nf3:
            pair = (self.role(r), self.concept(b))
            if pair not in link_ids:
                new_pairs.add(pair)
        for r, f in sorted(new_pairs):
            link(r, f)

        for a, r, b in norm.nf3:
            nf3_rows.append((self.concept(a), link(self.role(r), self.concept(b))))

        # close links under chain heads; compute chain_pairs.  Links are
        # bucketed by role with a per-(chain, role) cursor so every
        # (chain axiom, link) pair is visited ONCE — the naive rescan of
        # the whole link table per chain per round is O(chains x links x
        # rounds), which is quadratic in copies on multiplied corpora
        # (measured: 17 s to index 512 GALEN copies, dominated by this
        # loop).  Same output set; chain_pairs are sorted below, so the
        # emitted order is unchanged.
        chain_pairs: List[Tuple[int, int, int]] = []
        if nf6_rows:
            by_role: Dict[int, List[int]] = {}
            for li, (r2, _f2) in enumerate(links):
                by_role.setdefault(r2, []).append(li)

            def link_b(r: int, f: int) -> int:
                """link() that also maintains the role buckets."""
                n_before = len(links)
                lid = link(r, f)
                if lid == n_before:
                    by_role.setdefault(r, []).append(lid)
                return lid

            seen_pairs = set()
            cursors: Dict[Tuple[int, int], int] = {}
            # relevant source roles per chain row: rho ⊑* s
            relevant = [
                np.flatnonzero(closure[:, s]) for (_r, s, _t) in nf6_rows
            ]
            changed = True
            while changed:
                changed = False
                for ci, (r, s, t) in enumerate(nf6_rows):
                    for rho in relevant[ci]:
                        bucket = by_role.get(int(rho))
                        if not bucket:
                            continue
                        cur = cursors.get((ci, int(rho)), 0)
                        while cur < len(bucket):
                            l2 = bucket[cur]
                            cur += 1
                            lt = link_b(t, links[l2][1])
                            key2 = (r, l2, lt)
                            if key2 not in seen_pairs:
                                seen_pairs.add(key2)
                                chain_pairs.append(key2)
                                changed = True
                        cursors[(ci, int(rho))] = cur

        for r, a, b in norm.nf4:
            nf4_rows.append((self.role(r), self.concept(a), self.concept(b)))
        # same tile-clustering for the operand ROW axis: the engines'
        # matmul rows follow these arrays' order, so group them by role
        nf4_rows.sort()
        chain_pairs.sort()

        n_concepts = len(self.concept_names)
        # original classes = concepts the CURRENT corpus still mentions.
        # The name roster is append-only (stable-id contract), so after a
        # retraction a dead concept keeps its id and its row in
        # ``concept_names`` — membership in the live atom set is what
        # decides whether the taxonomy should speak for it.  Add-only
        # histories are unaffected: every interned non-aux name came from
        # some batch's atoms, and the accumulated corpus only grows.
        live = {atom_key(a) for a in norm.atoms()}
        live.add("owl:Nothing")
        live.add("owl:Thing")
        original = [
            i
            for i, name in enumerate(self.concept_names)
            if name in live
            and not name.startswith(("distel:gensym#", AUX_PREFIX, "ind:"))
        ]

        has_bottom = any(b == BOTTOM_ID for _, b in nf1_rows) or any(
            b == BOTTOM_ID for _, _, b in nf2_rows
        ) or any(b == BOTTOM_ID for _, _, b in nf4_rows)

        def arr(rows, width):
            if not rows:
                return np.zeros((0, width), np.int32)
            return np.asarray(rows, np.int32)

        return IndexedOntology(
            n_concepts=n_concepts,
            n_roles=max(n_roles, 1),
            concept_names=self.concept_names,
            concept_ids=self.concept_ids,
            role_names=self.role_names,
            role_ids=self.role_ids,
            nf1=arr(nf1_rows, 2),
            nf2=arr(nf2_rows, 3),
            nf3=arr(nf3_rows, 2),
            nf4=arr(nf4_rows, 3),
            links=arr(links, 2),
            chain_pairs=arr(chain_pairs, 3),
            role_closure=closure,
            original_classes=np.asarray(original, np.int32),
            has_bottom_axioms=has_bottom,
        )


def _role_closure(n_roles: int, edges: List[Tuple[int, int]]) -> np.ndarray:
    """Reflexive-transitive closure H[r, s] = r ⊑* s by repeated
    squaring: log₂(diameter) boolean matmuls (BLAS for normal role
    counts, scipy sparse beyond 4096 — multiplied corpora reach tens of
    thousands of roles, where the old per-k Warshall outer-product loop
    was O(n³) in Python and ran for hours)."""
    n = max(n_roles, 1)
    if not edges:
        return np.eye(n, dtype=bool)
    if n <= 4096:
        h = np.eye(n, dtype=bool)
        e = np.asarray(edges, np.int64)
        h[e[:, 0], e[:, 1]] = True
        while True:
            # f32 accumulation: a uint8 product wraps mod 256, and a
            # witness count that lands on exactly 0 mod 256 would drop
            # a true reachability bit; f32 is exact below 2^24
            h2 = (
                h.astype(np.float32) @ h.astype(np.float32) > 0
            ) | h
            if np.array_equal(h2, h):
                return h
            h = h2
    from scipy.sparse import csr_matrix, eye as speye

    e = np.asarray(edges, np.int64)
    h = (
        csr_matrix(
            (np.ones(len(e), np.float32), (e[:, 0], e[:, 1])), shape=(n, n)
        )
        + speye(n, dtype=np.float32, format="csr")
    )
    h.data[:] = 1.0  # idempotent weights: products count paths, not wrap
    while True:
        h2 = h @ h + h
        h2.data[:] = 1.0
        h2.eliminate_zeros()
        if h2.nnz == h.nnz:
            return h.toarray().astype(bool)
        h = h2


def index_ontology(norm: NormalizedOntology) -> IndexedOntology:
    return Indexer().index(norm)


def role_sort_links(idx: IndexedOntology) -> IndexedOntology:
    """Renumber link ids into role-grouped order and sort the CR4/CR6
    row arrays by role — the tile-clustering contract the Python Indexer
    establishes at interning time, applied as a post-pass for load
    planes that intern in encounter order (the native loader).  NOT for
    the incremental path: renumbering breaks the Indexer's stable-id
    contract that lets a previous closure embed verbatim."""
    import dataclasses

    if idx.n_links == 0:
        return idx
    perm = np.argsort(idx.links[:, 0], kind="stable")
    if (perm == np.arange(len(perm))).all() and _rows_sorted(
        idx.nf4
    ) and _rows_sorted(idx.chain_pairs):
        return idx
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    nf3 = idx.nf3.copy()
    if len(nf3):
        nf3[:, 1] = inv[nf3[:, 1]]
    cp = idx.chain_pairs.copy()
    if len(cp):
        cp[:, 1] = inv[cp[:, 1]]
        cp[:, 2] = inv[cp[:, 2]]
        cp = cp[np.lexsort((cp[:, 2], cp[:, 1], cp[:, 0]))]
    nf4 = idx.nf4
    if len(nf4):
        nf4 = nf4[np.lexsort((nf4[:, 2], nf4[:, 1], nf4[:, 0]))]
    return dataclasses.replace(
        idx, links=idx.links[perm], nf3=nf3, nf4=nf4, chain_pairs=cp
    )


def _rows_sorted(a: np.ndarray) -> bool:
    """Role-grouped check: first column (the role) non-decreasing."""
    return len(a) < 2 or bool((np.diff(a[:, 0]) >= 0).all())
