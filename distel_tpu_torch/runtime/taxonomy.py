"""Taxonomy extraction from a saturated S matrix.

Projects S onto the original class signature and computes the ELK-style
taxonomy: equivalence classes, unsatisfiable classes, and direct
(transitively-reduced) superclasses.  Two paths, which give the same
:class:`Taxonomy`:

* **device** (``_extract_device_blocked``): the port of the reference's
  blocked bit-packed program.  The projected subsumption matrix lives
  packed on the result's device ([n, n/32] words, rows = first index,
  bits = second), built and consumed in ``_TAX_BLOCK``-row blocks; the
  transitive-reduction product runs through the dense packed-columns
  kernel.  Only compact arrays cross to the host: canonical-
  representative ids, the unsat mask and the direct-parent edges (the
  nonzero positions of each block's reduced rows, however many a class
  has).
* **host** (``_extract_host``): the numpy implementation over the
  unpacked closure — for small signatures and the CPU tests.  Its n²
  boolean square does not fit host memory sensibly at full width.

The reference's unblocked dense device program is not ported: every
path gives the same taxonomy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID
from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.ops.bitpack import (
    bit_lookup,
    bit_lookup_from,
    pack_bool_columns,
    unpack_words,
)

#: signature size up to which "auto" takes the host path for a result
#: that lies on the CPU (results on a card always take the device path)
_HOST_N_CAP = 24_000
#: row-block size of the blocked device program
_TAX_BLOCK = 4096


class Taxonomy:
    """ELK-style taxonomy.  ``parents`` / ``equivalents`` /
    ``unsatisfiable`` are materialized eagerly (they are small);
    ``subsumers`` — class name → every strict named subsumer — is
    output-sized and may be reconstructed lazily from the reduced DAG."""

    def __init__(
        self,
        subsumers: Optional[Dict[str, List[str]]],
        equivalents: Dict[str, List[str]],
        parents: Dict[str, List[str]],
        unsatisfiable: Optional[List[str]] = None,
    ):
        self._subsumers = subsumers
        self.equivalents = equivalents
        self.parents = parents
        self.unsatisfiable = unsatisfiable or []

    @property
    def subsumers(self) -> Dict[str, List[str]]:
        if self._subsumers is None:
            self._subsumers = self._closure_from_parents()
        return self._subsumers

    def superclasses(self, name: str, direct: bool = False) -> List[str]:
        return self.parents[name] if direct else self.subsumers[name]

    def _closure_from_parents(self) -> Dict[str, List[str]]:
        """All strict subsumers by reachability over the direct-parent DAG
        (transitive reduction preserves reachability), expanding each
        reachable representative by its equivalence class."""
        memo: Dict[str, frozenset] = {}

        def ancestors(name: str) -> frozenset:
            got = memo.get(name)
            if got is not None:
                return got
            # iterative DFS (deep hierarchies overflow recursion)
            stack = [name]
            while stack:
                cur = stack[-1]
                ps = self.parents.get(cur, ())
                pending = [p for p in ps if p not in memo]
                if pending:
                    stack.extend(pending)
                    continue
                acc = set()
                for p in ps:
                    acc.add(p)
                    acc |= memo[p]
                memo[cur] = frozenset(acc)
                stack.pop()
            return memo[name]

        all_names = list(self.parents.keys())
        unsat = set(self.unsatisfiable)
        eq_of = self.equivalents
        out: Dict[str, List[str]] = {}
        for name in all_names:
            if name in unsat:
                out[name] = sorted(set(all_names) - {name})
                continue
            ups = set()
            for rep in ancestors(name):
                ups.update(eq_of.get(rep, (rep,)))
            ups -= set(eq_of.get(name, (name,)))
            out[name] = sorted(ups)
        return out

    def write(self, path: str) -> None:
        """Dump as functional-syntax axioms."""
        with open(path, "w") as f:
            for name in sorted(self.unsatisfiable):
                f.write(f"EquivalentClasses(<{name}> owl:Nothing)\n")
            done = set()
            for name, eqs in sorted(self.equivalents.items()):
                key = tuple(sorted(eqs))
                if len(eqs) > 1 and key not in done:
                    done.add(key)
                    f.write(
                        "EquivalentClasses(" + " ".join(f"<{n}>" for n in key) + ")\n"
                    )
            for name, ps in sorted(self.parents.items()):
                for p in ps:
                    f.write(f"SubClassOf(<{name}> <{p}>)\n")


def _signature(idx):
    orig = idx.original_classes
    orig = orig[(orig != BOTTOM_ID) & (orig != TOP_ID)]
    return orig, [idx.concept_names[i] for i in orig]


def extract_taxonomy(
    result: SaturationResult, method: str = "auto", block: int = _TAX_BLOCK
) -> Taxonomy:
    """``method``: "auto" (the device path for a result on a card or a
    signature past ``_HOST_N_CAP``, else the host path), "device", or
    "host".  ``block``: row-block size of the device path."""
    if method not in ("auto", "device", "host"):
        raise ValueError(
            f"unknown method {method!r}: expected 'auto', 'device' or 'host'"
        )
    orig, names = _signature(result.idx)
    if len(orig) == 0:
        return Taxonomy({}, {}, {}, [])
    on_cpu = result.packed_s.device.type == "cpu"
    if method == "host" or (
        method == "auto" and on_cpu and len(orig) <= _HOST_N_CAP
    ):
        return _extract_host(result, orig, names)
    return _extract_device_blocked(result, orig, names, block)


# ------------------------------------------------------------- device path


def _assemble(orig, names, canon, unsat, edges) -> Taxonomy:
    """Host assembly of the compact device outputs; ``edges`` [E, 2]
    holds (representative, direct parent) pairs."""
    n = len(orig)
    unsat_names = sorted(names[i] for i in np.nonzero(unsat)[0])
    groups: Dict[int, List[int]] = {}
    for i, c in enumerate(canon):
        groups.setdefault(int(c), []).append(i)
    equivalents = {
        names[i]: sorted(names[j] for j in groups[int(canon[i])])
        for i in range(n)
    }
    direct: Dict[int, List[str]] = {}
    for k, j in edges:
        direct.setdefault(int(k), []).append(names[j])
    parents: Dict[str, List[str]] = {}
    for i in range(n):
        if unsat[i]:
            parents[names[i]] = []
            continue
        parents[names[i]] = sorted(direct.get(int(canon[i]), ()))
    return Taxonomy(None, equivalents, parents, unsat_names)


def _blocked_reduction(packed_s: torch.Tensor, orig: np.ndarray, block: int):
    """The cap-independent half of the blocked program: ``(canon,
    unsat, strict_r, blocks)`` on the result's device.

    sub[i, j] ⇔ orig_i ⊑ orig_j.  Two packed forms are built block by
    block: ``subt`` rows i, bits j (a class's parent set) and ``subp``
    rows j, bits i (the mirror, for the symmetry AND).  In the
    transposed state, bit(S_T[a], x) = sub[x, a]."""
    dev = packed_s.device
    o = torch.as_tensor(np.asarray(orig, np.int64)).to(dev)
    n = len(orig)
    npad = ((n + 31) // 32) * 32
    blocks = [(i, min(i + block, n)) for i in range(0, n, block)]
    unsat = bit_lookup(packed_s, np.full(1, BOTTOM_ID), o)[:, 0]   # [n] bool
    unsat_pad = torch.zeros(npad, dtype=torch.bool, device=dev)
    unsat_pad[:n] = unsat
    unsat_packed = pack_bool_columns(unsat_pad[None, :])[0]
    # rows o of the state, transposed once: [wc, n]
    subt_all = packed_s[o].T.contiguous()

    def padded(blk):
        out = torch.zeros((blk.shape[0], npad), dtype=torch.bool, device=dev)
        out[:, :n] = blk
        return out

    subt = torch.zeros((npad, npad // 32), dtype=torch.int32, device=dev)
    subp = torch.zeros_like(subt)
    for lo, hi in blocks:
        ii = torch.arange(hi - lo, device=dev)
        jj = torch.arange(lo, hi, device=dev)
        # rows i: bit_lookup_from(all rows, cols o[lo:hi]) → [hi-lo, n]
        bt = padded(bit_lookup_from(subt_all, o[lo:hi]))
        bt |= unsat[lo:hi, None]
        bt[ii, jj] = True
        subt[lo:hi] = pack_bool_columns(bt)
        # rows j: the state rows o[lo:hi] over cols o → [n, hi-lo] → T
        sub_rows = packed_s[o[lo:hi]].T.contiguous()
        bp = padded(bit_lookup_from(sub_rows, o).T)
        bp[ii, jj] = True
        subp[lo:hi] = pack_bool_columns(bp) | unsat_packed[None, :]
    del subt_all
    eq = subt & subp            # symmetric: serves both orientations
    strict_t = subt & ~eq       # rows i, bits j
    del subt, subp
    # canon[i] = smallest j with eq[i, j] (first max of row i)
    canon = torch.cat(
        [
            torch.argmax(unpack_words(eq[lo:hi], npad, torch.int8), dim=1)
            for lo, hi in blocks
        ]
    )[:n]
    del eq
    is_rep = (canon == torch.arange(n, device=dev)) & ~unsat
    rep_pad = torch.zeros(npad, dtype=torch.bool, device=dev)
    rep_pad[:n] = is_rep
    repmask = pack_bool_columns(rep_pad[None, :])[0]
    strict_r = torch.where(rep_pad[:, None], strict_t & repmask[None, :], 0)
    return canon, unsat, strict_r, blocks


def _extract_device_blocked(result, orig, names, block) -> Taxonomy:
    """Run the blocked program; each block's direct-parent bits leave
    the device as (row, parent) index pairs."""
    canon, unsat, strict_r, blocks = _blocked_reduction(
        result.packed_s, orig, block
    )
    n = len(orig)
    npad = strict_r.shape[0]
    # transitive reduction: indirect[i, j] = ∃q strict[i,q] ∧ strict[q,j]
    # = unpack(strict_r rows i over q) ⊙ strict_r, on the dense kernel
    edges = []
    for lo, hi in blocks:
        a = unpack_words(strict_r[lo:hi], npad, torch.int8)
        mm = PackedColsMatmulPlan(hi - lo, npad, npad // 32, skip_zero_tiles=False)
        direct = strict_r[lo:hi] & ~mm(a, strict_r)
        pairs = unpack_words(direct, n, torch.bool).nonzero()
        pairs[:, 0] += lo
        edges.append(pairs)
    return _assemble(
        orig,
        names,
        canon.cpu().numpy(),
        unsat.cpu().numpy(),
        torch.cat(edges).cpu().numpy(),
    )


# --------------------------------------------------------------- host path


def _extract_host(result, orig, names) -> Taxonomy:
    n = len(orig)
    sub = result.s[np.ix_(orig, orig)]
    unsat_mask = result.s[orig, BOTTOM_ID]
    # unsatisfiable classes are ⊑ everything
    sub = sub | unsat_mask[:, None]
    np.fill_diagonal(sub, True)

    eq = sub & sub.T  # mutual subsumption
    strict = sub & ~eq

    # canonical representative of each equivalence class: smallest index
    canon = np.argmax(eq, axis=1)  # first True per row
    is_canon = canon == np.arange(n)

    # transitive reduction over canonical reps: parent p of c is direct iff
    # no other strict subsumer q of c has p as strict subsumer of q
    reps = np.nonzero(is_canon & ~unsat_mask)[0]
    strict_r = strict[np.ix_(reps, reps)]
    # float32 so numpy dispatches to BLAS sgemm
    sf = strict_r.astype(np.float32)
    indirect = (sf @ sf) > 0
    direct_r = strict_r & ~indirect

    rep_names = [names[i] for i in reps]
    rep_pos = {int(r): k for k, r in enumerate(reps)}

    subsumers = {}
    equivalents = {}
    parents = {}
    unsatisfiable = [names[i] for i in np.nonzero(unsat_mask)[0]]
    unsat_set = set(unsatisfiable)
    for i in range(n):
        name = names[i]
        equivalents[name] = sorted(names[j] for j in np.nonzero(eq[i])[0])
        subsumers[name] = sorted(
            names[j] for j in np.nonzero(strict[i])[0] if names[j] not in unsat_set
        ) if name not in unsat_set else sorted(set(names) - {name})
        if name in unsat_set:
            parents[name] = []
            continue
        k = rep_pos[int(canon[i])]
        parents[name] = sorted(rep_names[m] for m in np.nonzero(direct_r[k])[0])
    return Taxonomy(subsumers, equivalents, parents, sorted(unsatisfiable))
