"""Shape-bucketed programs of the row-packed engine.

A bucketed engine (``RowPackedSaturationEngine(idx, bucket=True)``, the
default through ``ClassifierConfig.shape_buckets``) runs its unobserved
fixed point through a *program*: one ``unroll`` group of the sync-free
gated superstep whose every launch is a pure function of the engine's
bucket rungs, so ontologies of one bucket share it.  On a card the
program is one CUDA graph, captured once and replayed; on the CPU the
same object runs the same code eagerly.  Programs live in the
process-global :data:`~distel_tpu_torch.core.program_cache.PROGRAMS`
registry under ``(bucket_signature, "step")``.

What the step reads, and where it lives:

* the structure (:class:`BucketStruct`) — the state layout ``(nc, nl)``
  on the corpus ladder, the CR1-CR3 seg-OR plans' quantized structures
  (``SegmentedRowOr.quantized``), and per CR4/CR6 table the chunk count,
  the rows a chunk, the window slots a chunk and the slot length, each
  on a ladder rung.  It is the signature; nothing else decides a launch;
* the argument tables (:func:`bucket_plan`) — every ontology-derived
  array at those rung shapes: rule gather indices and seg-OR targets,
  fillers and link roles, the factored masks (their role axis widened
  to a rung), each chunk's source rows, targets and their segment
  tables, each window slot's links and L-chunks, the L-chunk of every
  link.  The program owns card buffers of
  these shapes; an engine copies its content in before a run;
* the state pair (:class:`StatePair`), one per layout and device,
  shared by every program of that layout (a graph keeps the addresses
  it was captured on).  An engine copies its state in and out under the
  pair's lock, which it holds for the whole run, so two tenants of one
  bucket (two serve workers) never interleave.

The step is the engine's own gated step (``RowPackedSaturationEngine.
step``) on the engine's own plan — the same rules in the same order,
the same row chunks, live windows and L-chunk grid, each chunk written
before the next reads — with the gates on the card: every window slot
launches its kernel, which reads its row count (the chunk's rows when
the window is live, 0 when its inputs are clean or the slot is a pad)
from card memory.  So per round the state, and the gate counts over the
real windows, are those of the host-gated step.  Padding is
closure-invisible: pad seg-OR segments OR the dead row into itself
(CR3's, which would OR the dead concept row's one bit into the dead
link row as the reference's do, are masked to nothing, so every row of
the state is the host-gated step's), pad chunk rows carry all-zero
masks and target the dead row, and pad window slots and links contract
nothing.

On a mesh (``struct.n_shards`` > 1) the state pair is a rank's word
window, the program's step exchanges the bit tables, CR5's mask and the
fold through ``parallel/shard_compat.py``, and it runs uncaptured.

A program is a function of its structure and its tables' shapes alone,
so :func:`program_spec` writes it down as plain data and
:meth:`BucketProgram.from_spec` rebuilds it (and on a card captures it)
in another process, with no corpus: the artifact farm's ``"exe"`` tier
(``core/artifacts.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from distel_tpu_torch.core.indexing import BOTTOM_ID
from distel_tpu_torch.core.program_cache import PROGRAMS, bucket_dim, signature_of
from distel_tpu_torch.ops import bitmatmul
from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.core.rowpacked_engine import cr5_reduce
from distel_tpu_torch.ops.bitpack import (
    bit_lookup_from,
    or_into_rows,
    reduce_segments,
)
from distel_tpu_torch.parallel.shard_compat import por_, por_bits, shard_word_base
from distel_tpu_torch.runtime.instrumentation import rule_scope


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class RuleStruct:
    """One CR4/CR6 table's chunk structure: ``chunks`` row chunks of
    ``rows`` rows, each ``slots`` window slots of ``length`` links, and
    ``passes`` doubling passes of its segmented write (the longest run
    of equal targets, as a power of two)."""

    chunks: int
    rows: int
    slots: int
    length: int
    passes: int


@dataclass(frozen=True)
class BucketStruct:
    """Everything that decides a bucketed step's launches."""

    device_type: str
    nc: int
    nl: int
    wc: int
    unroll: int
    gate_cr5: bool
    bottom: bool
    temp_budget: int
    word_block: int
    p1: tuple
    p2: tuple
    p3: tuple
    n_roles_pad: int
    lchunk_slots: int
    cr4: Optional[RuleStruct]
    cr6: Optional[RuleStruct]
    #: the mesh the word axis is sharded over: its size and shape
    #: (``((axis, size),)``; ``()`` off a mesh), as the reference's key
    n_shards: int = 1
    mesh_shape: tuple = ()

    @property
    def wl(self) -> int:
        """The packed words a rank holds."""
        return self.wc // self.n_shards


# ------------------------------------------------------------ the plan


def _seg_tables(targets: np.ndarray, n_real: int):
    """A chunk's segmented write: the stable sort of its targets, the
    sorted targets, and per sorted position its segment's first and
    last position; plus the longest segment.  The pad rows past
    ``n_real`` (all-zero, aimed at the dead row) sort last, each a
    segment of its own, so they never lengthen the scan."""
    n = len(targets)
    key = np.where(np.arange(n) < n_real, targets,
                   targets.max(initial=0) + 1 + np.arange(n))
    perm = np.argsort(key, kind="stable")
    t = targets[perm]
    k = key[perm]
    first = np.r_[True, k[1:] != k[:-1]] if n else np.zeros(0, bool)
    starts = np.flatnonzero(first)
    seg = np.cumsum(first) - 1
    ends = np.r_[starts[1:], n] - 1
    longest = int(np.diff(np.r_[starts, n]).max()) if n else 1
    return perm, t, starts[seg], ends[seg], longest


def bucket_plan(engine) -> Tuple[BucketStruct, Dict[str, np.ndarray]]:
    """The structure and the argument tables of ``engine``'s bucketed
    step, from its current plan (so a rebound closure's masks and
    windows are new content in the same structure)."""
    q = engine._q
    q1 = engine._q1
    idx = engine.idx
    nc, nl, wc = engine.nc, engine.nl, engine.wc
    dead_c, dead_l = engine._dead_c, engine._dead_l
    tabs: Dict[str, np.ndarray] = {}

    # CR1-CR3: quantized seg-OR plans, sources gathered through the
    # plans' order with the dead row appended (pad slots)
    plans = []
    for key, tab, tgt_col, src_cols, pad_target in (
        ("1", engine._sp_nf1, 1, (0,), dead_c),
        ("2", engine._sp_nf2, 2, (0, 1), dead_c),
        ("3", engine._sp_nf3, 1, (0,), dead_l),
    ):
        plan = engine._qplans[key]
        plans.append(plan)
        for i, c in enumerate(src_cols):
            tabs[f"src{key}{'ab'[i] if len(src_cols) > 1 else ''}"] = (
                np.append(tab[:, c], dead_c)[plan.order]
                if plan.k else np.zeros(0, np.int64)
            )
        tabs["t" + key] = np.asarray(plan.targets, np.int64)
    # CR3's pad segments (the dead concept row into the dead link row)
    # write nothing: a word mask a target, so the dead link row stays
    # empty and the state equals the host-gated step's in every row
    t3 = tabs["t3"]
    tabs["keep3"] = np.where(t3 == dead_l, 0, -1).astype(np.int32)
    emission = max(plans[0].k, 2 * plans[1].k, plans[2].k, 1)
    wl = engine.wl
    bw = max(min(engine.temp_budget_bytes // (4 * emission), wl), 1)
    n_blocks = -(-wl // bw)
    bw = -(-wl // n_blocks)

    # link tables; the factored masks' role axis widened to a rung (the
    # sentinel role, all-zero, moves to its end)
    n_roles = idx.role_closure.shape[0]
    nr = bucket_dim(n_roles + 1, engine._bucket_ratio, floor=8)
    fillers = np.array(engine._fillers_np, np.int64)
    roles = np.array(engine._link_roles_np, np.int64)
    roles[roles >= n_roles] = nr - 1
    tabs["fillers"], tabs["link_roles"] = fillers, roles
    n_lc = engine.n_lchunks
    nlc = q1(n_lc + 1)          # at least one trailing, never dirty slot
    lchunk = np.full(nl, nlc - 1, np.int64)
    grid = min(engine._nl_plan, nl)
    lchunk[:grid] = np.arange(grid) // engine.lc
    lchunk[dead_l] = nlc - 1
    tabs["lchunk"] = lchunk
    tabs["dl_valid"] = np.arange(nlc) < n_lc

    def rule(key, spans, chunks, slots, tab, src_col, lcn, mask_np, pad_src,
             pad_target, src_lchunk):
        if not spans:
            return None
        # kept spans carry their chunk's live windows; the others none
        kept = {(a0, a1): c for c, (a0, a1, _n) in enumerate(slots[0])}
        C = q1(len(spans))
        RK = q(max(a1 - a0 for a0, a1 in spans))
        NW = q1(max([n for _a0, _a1, n in slots[0]]
                    + [1 + engine._window_headroom]))
        LW = _pad_up(q(lcn), 32)
        src = np.full((C, RK), pad_src, np.int64)
        lch = np.full((C, RK), nlc - 1, np.int64)
        mask = np.zeros((C, RK, nr), np.int8)
        rk = np.zeros(C, np.int32)
        perm = np.tile(np.arange(RK, dtype=np.int64), (C, 1))
        tsort = np.full((C, RK), pad_target, np.int64)
        sstart = np.zeros((C, RK), np.int64)
        send = np.full((C, RK), RK - 1, np.int64)
        wlink = np.zeros((C, NW, LW), np.int64)
        wlval = np.zeros((C, NW, LW), np.int8)
        wval = np.zeros((C, NW), bool)
        wc0 = np.full((C, NW), nlc - 1, np.int64)
        wc1 = np.full((C, NW), nlc - 1, np.int64)
        longest = 1
        for c, (a0, a1) in enumerate(spans):
            n = a1 - a0
            rk[c] = n
            src[c, :n] = tab[a0:a1, src_col]
            if src_lchunk:
                lch[c, :n] = tab[a0:a1, src_col] // engine.lc
            mask[c, :n, :n_roles] = mask_np[a0:a1, :n_roles]
            tg = np.full(RK, pad_target, np.int64)
            tg[:n] = tab[a0:a1, 2]
            p, t, s, e, lg = _seg_tables(tg, n)
            perm[c], tsort[c], sstart[c], send[c] = p, t, s, e
            longest = max(longest, lg)
            ci = kept.get((a0, a1))
            windows = chunks[ci].windows if ci is not None else []
            for j, (off, end, c0, c1) in enumerate(windows):
                ln = np.arange(off, off + LW)
                wlink[c, j] = np.minimum(ln, nl - 1)
                wlval[c, j] = ln < end
                wval[c, j] = True
                wc0[c, j], wc1[c, j] = c0, c1
        # at least 4 passes (runs of up to 16 equal targets), so small
        # tables of one bucket share their pass count
        passes = max(int(longest - 1).bit_length(), 4)
        tabs.update({
            f"src{key}": src, f"m{key}": mask, f"rk{key}": rk,
            f"perm{key}": perm, f"tsort{key}": tsort,
            f"sstart{key}": sstart, f"send{key}": send,
            f"wlink{key}": wlink, f"wlval{key}": wlval, f"wval{key}": wval,
            f"wc0{key}": wc0, f"wc1{key}": wc1,
        })
        if src_lchunk:
            tabs[f"lch{key}"] = lch
        return RuleStruct(C, RK, NW, LW, passes)

    cr4 = rule("4", engine._spans4, engine._chunks4, engine._slots4, idx.nf4,
               1, engine.lc4, engine._m4_np, dead_c, dead_c, False)
    cr6 = rule("6", engine._spans6, engine._chunks6, engine._slots6,
               idx.chain_pairs, 1, engine.lc, engine._m6_np, dead_l, dead_l,
               True)
    struct = BucketStruct(
        device_type=engine.device.type,
        nc=nc, nl=nl, wc=wc, unroll=engine.unroll,
        gate_cr5=engine._gate_cr5, bottom=engine._bottom,
        temp_budget=engine.temp_budget_bytes, word_block=bw,
        p1=plans[0].structure(), p2=plans[1].structure(),
        p3=plans[2].structure(),
        n_roles_pad=nr, lchunk_slots=nlc, cr4=cr4, cr6=cr6,
        n_shards=engine.n_shards,
        mesh_shape=(tuple(engine.mesh.shape.items())
                    if engine.mesh is not None else ()),
    )
    return struct, tabs


def table_shapes(tabs: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    """Each table's ``(shape, dtype name)``: all a program reads of its
    tables when it is built."""
    return {k: (tuple(int(d) for d in v.shape), str(v.dtype))
            for k, v in tabs.items()}


def signature(struct: BucketStruct, tabs: Dict[str, np.ndarray]) -> str:
    """``signature_of`` the structure and every table's shape and type
    (equal signatures: the same launches over the same buffers)."""
    return shape_signature(struct, table_shapes(tabs))


def shape_signature(struct: BucketStruct, shapes: Dict[str, tuple]) -> str:
    """:func:`signature` from :func:`table_shapes`."""
    parts = tuple(sorted((k, shape, dt) for k, (shape, dt) in shapes.items()))
    return signature_of((1, struct, parts), f"b{struct.nc}x{struct.nl}")


# ------------------------------------------------------------- the spec

#: version of :func:`program_spec`'s document
SPEC_FORMAT = 1


def program_spec(prog: "BucketProgram") -> dict:
    """``prog`` as plain data: its structure and each table's name,
    shape and dtype (JSON-ready)."""
    return {
        "format": SPEC_FORMAT,
        "struct": dataclasses.asdict(prog.struct),
        "tables": [[k, list(shape), dt]
                   for k, (shape, dt) in sorted(prog.shapes.items())],
    }


def _tuples(x):
    """JSON lists back into the tuples a structure holds."""
    return tuple(_tuples(v) for v in x) if isinstance(x, (list, tuple)) else x


def spec_parts(spec: dict) -> Tuple[BucketStruct, Dict[str, tuple]]:
    """The structure and table shapes of a :func:`program_spec`."""
    if spec.get("format") != SPEC_FORMAT:
        raise ValueError(f"program spec format {spec.get('format')!r} != "
                         f"supported {SPEC_FORMAT}")
    d = dict(spec["struct"])
    for key in ("cr4", "cr6"):
        if d[key] is not None:
            d[key] = RuleStruct(**d[key])
    for key in ("p1", "p2", "p3", "mesh_shape"):
        if key in d:
            d[key] = _tuples(d[key])
    shapes = {k: (tuple(int(x) for x in shape), str(np.dtype(dt)))
              for k, shape, dt in spec["tables"]}
    return BucketStruct(**d), shapes


# --------------------------------------------------------- the state pair


class StatePair:
    """The card (or CPU) state a layout's programs run on, with the lock
    a run holds from copy-in to copy-out; with ``lanes`` > 0 a stacked
    state of that many lanes (``[lanes, nc, wc]`` and ``[lanes, nl,
    wc]``: a cohort's, ``core/cohort.py``)."""

    def __init__(self, device, nc: int, nl: int, wc: int, lanes: int = 0):
        lead = (lanes,) if lanes else ()
        self.sp = torch.zeros((*lead, nc, wc), dtype=torch.int32, device=device)
        self.rp = torch.zeros((*lead, nl, wc), dtype=torch.int32, device=device)
        self.lock = threading.RLock()

    @property
    def nbytes(self) -> int:
        """Bytes of the pair on its device."""
        return (self.sp.numel() + self.rp.numel()) * 4


#: one capture at a time in a process: PyTorch captures on a stream its
#: graph class shares, and the fused windows' IF-node capture
#: (``ops/graph_if.py``) keeps per-capture state; concurrent warmup
#: threads overlap their host work and take turns here
CAPTURE_LOCK = threading.Lock()

_PAIRS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_PAIRS_LOCK = threading.Lock()


def state_pair(device, nc: int, nl: int, wc: int, lanes: int = 0) -> StatePair:
    """The pair of this layout (and lane count) on ``device``, shared
    while any program holds it (freed with the last one)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (str(dev), nc, nl, wc, lanes)
    with _PAIRS_LOCK:
        pair = _PAIRS.get(key)
        if pair is None:
            pair = StatePair(dev, nc, nl, wc, lanes)
            _PAIRS[key] = pair
        return pair


# ---------------------------------------------------------------- the step


class _Step:
    """The bucketed superstep over a program's tables ``T``: a function
    of the structure only.  On a mesh of several ranks (``struct.
    n_shards`` > 1) the state is the rank's word window, and
    :attr:`mesh` (set by :meth:`BucketProgram.run`) carries the three
    exchanges of the exact engine: the CR4/CR6 bit tables (one a chunk's
    slots, within the temporary budget), CR5's ⊥-filler mask and the
    fold."""

    def __init__(self, struct: BucketStruct, T: dict, device):
        self.s, self.T = struct, T
        #: the leading lane shape of the state, carries and counts
        #: (``()`` solo; ``(R,)`` a cohort's, ``core/cohort.py``)
        self.lead = ()
        self.word_block = struct.word_block
        self.plans = {}
        self.pos = {}
        #: the mesh of the run, and this rank's first word (None: no
        #: window)
        self.mesh = None
        self.wbase = None
        self.bottom_idx = torch.full((1,), BOTTOM_ID, dtype=torch.int64,
                                     device=device)
        for key in ("4", "6"):
            rs = getattr(struct, "cr" + key)
            if rs is not None:
                self.plans[key] = PackedColsMatmulPlan(
                    rs.rows, rs.length, struct.wl,
                    temp_budget_bytes=struct.temp_budget,
                )
                self.pos[key] = torch.arange(rs.rows, device=device)

    def bind(self, mesh) -> None:
        """Run on ``mesh`` (None off a mesh)."""
        self.mesh = mesh
        self.wbase = shard_word_base(mesh, self.s.wc) if self.s.n_shards > 1 else None

    def _reduce(self, rows, buckets):
        """The seg-OR of gathered ``rows`` [k, W] → [segments, W]."""
        return reduce_segments(rows, buckets)

    def row_rules(self, sp, rp, s_cvs, r_cvs):
        """CR1-CR3 over the (lane-flattened) state, word block by word
        block; each index table read flat."""
        s, T = self.s, self.T
        cv = [None, None, None]
        for off in range(0, s.wl, self.word_block):
            blk = slice(off, min(off + self.word_block, s.wl))
            if s.p1[0]:
                with rule_scope("cr1"):
                    red = self._reduce(sp[T["src1"].view(-1), blk], s.p1[2])
                    c = or_into_rows(sp, T["t1"].view(-1), red, blk)
                cv[0] = c if cv[0] is None else cv[0] | c
            if s.p2[0]:
                with rule_scope("cr2"):
                    red = self._reduce(sp[T["src2a"].view(-1), blk]
                                       & sp[T["src2b"].view(-1), blk], s.p2[2])
                    c = or_into_rows(sp, T["t2"].view(-1), red, blk)
                cv[1] = c if cv[1] is None else cv[1] | c
            if s.p3[0]:
                with rule_scope("cr3"):
                    red = self._reduce(sp[T["src3"].view(-1), blk], s.p3[2]) \
                        & T["keep3"].view(-1)[:, None]
                    c = or_into_rows(rp, T["t3"].view(-1), red, blk)
                cv[2] = c if cv[2] is None else cv[2] | c
        for key, c, out in (("1", cv[0], s_cvs), ("2", cv[1], s_cvs),
                            ("3", cv[2], r_cvs)):
            if c is not None:
                out.append((T["t" + key].view(-1), c))

    def contract(self, key, rs, bits_state, rp, target, flags, dl, cvs):
        """One CR4/CR6 table, chunk by chunk (each written before the
        next reads), every window slot launched with its row count on
        the card.  Returns the live and valid slot counts."""
        T = self.T
        wval = T["wval" + key]
        live = (flags[:, None] | dl[T["wc0" + key]] | dl[T["wc1" + key]]) & wval
        n_rows = (live.to(torch.int32) * T["rk" + key][:, None]).contiguous()
        plan, pos = self.plans[key], self.pos[key]
        # the slots whose bit tables one lookup (on a mesh, one exchange)
        # covers: all of a chunk's that fit half the budget, or one
        per = 1 if self.s.n_shards == 1 else max(min(
            self.s.temp_budget // 2 // max(rs.length * rs.rows, 1), rs.slots), 1)
        # on a mesh of several ranks the step runs uncaptured: the host
        # reads which chunks have a live slot (the same on every rank), and
        # a chunk with none exchanges and launches nothing
        dead = (~live.any(dim=1)).tolist() if self.s.n_shards > 1 else None
        for c in range(rs.chunks):
            if dead is not None and dead[c]:
                continue
            subt = bits_state[T["src" + key][c]].T.contiguous()   # [wl, RK]
            mask = T["m" + key][c]
            acc = torch.zeros((rs.rows, self.s.wl), dtype=torch.int32,
                              device=rp.device)
            for j in range(rs.slots):
                ids = T["wlink" + key][c, j]
                if j % per == 0:
                    group = T["wlink" + key][c, j : j + per].reshape(-1)
                    with rule_scope("bit_table"):
                        fg = por_bits(bit_lookup_from(
                            subt, T["fillers"][group], word_offset=self.wbase,
                            dtype=torch.int8), self.mesh).view(-1, rs.length, rs.rows)
                f = fg[j % per]
                w = mask[:, T["link_roles"][ids]] * (
                    f.T * T["wlval" + key][c, j][None, :]
                )
                plan(w.contiguous(), rp[ids], out=acc,
                     n_rows=n_rows[c, j : j + 1])
            x = acc[T["perm" + key][c]]
            start = T["sstart" + key][c]
            step = 1
            while step < (1 << rs.passes):
                ok = (pos[step:] - step) >= start[step:]
                x = torch.cat([x[:step],
                               x[step:] | torch.where(ok[:, None], x[:-step], 0)])
                step *= 2
            t = T["tsort" + key][c]
            cvs.append((t, or_into_rows(target, t, x[T["send" + key][c]])))
        return live.sum(), wval.sum()

    def cr5(self, sp, rp, ms, dl, s_cvs):
        s, T = self.s, self.T
        red = cr5_reduce(sp, rp, T["fillers"], self.bottom_idx, s.temp_budget,
                         self.mesh, self.wbase)
        if s.gate_cr5:
            run = dl.any() | ms[BOTTOM_ID]
            red = red * run.to(torch.int32)
        else:
            run = torch.ones((), dtype=torch.bool, device=sp.device)
        old = sp[BOTTOM_ID].clone()
        sp[BOTTOM_ID] |= red
        s_cvs.append((self.bottom_idx, (sp[BOTTOM_ID] != old).any()[None]))
        return run

    def __call__(self, sp, rp, ms, dl):
        """One step in place from the frontier ``(ms, dl)``; returns
        ``(changed, ms_next, dl_next, counts)`` on the device, counts
        = [cr4 contracted, skipped, cr6 contracted, skipped, cr5 ran];
        each with the leading lane shape :attr:`lead`.  The row rules
        and the CR4/CR6 tables run on the state flattened over the
        lanes (a cohort's index tables are offset into their lane)."""
        s, T, lead = self.s, self.T, self.lead
        lanes = lead[0] if lead else 1
        dev = sp.device
        spf, rpf = sp.view(-1, s.wl), rp.view(-1, s.wl)
        msf, dlf = ms.reshape(-1), dl.reshape(-1)
        zero = torch.zeros(lead, dtype=torch.int64, device=dev)
        s_cvs, r_cvs = [], []
        self.row_rules(spf, rpf, s_cvs, r_cvs)
        counts = [zero, zero, zero, zero, zero]
        if s.cr4 is not None:
            with rule_scope("cr4"):
                f4 = msf[T["src4"]].any(dim=-1)
                run, valid = self.contract("4", s.cr4, spf, rpf, spf, f4, dlf, s_cvs)
            counts[0], counts[1] = run, valid - run
        if s.cr6 is not None:
            with rule_scope("cr6"):
                f6 = dlf[T["lch6"]].any(dim=-1)
                run, valid = self.contract("6", s.cr6, rpf, rpf, rpf, f6, dlf, r_cvs)
            counts[2], counts[3] = run, valid - run
        if s.bottom:
            with rule_scope("cr5"):
                counts[4] = self.cr5(sp, rp, ms, dl, s_cvs).to(torch.int64)
        with rule_scope("frontier"):
            return self._frontier(s_cvs, r_cvs, lanes, lead, dev, counts)

    def _frontier(self, s_cvs, r_cvs, lanes, lead, dev, counts):
        """The step's end: the changed-S row mask and the dirty L-chunks
        from its change vectors (on a mesh, one exchange), the change
        flag and the gate counts."""
        s, T = self.s, self.T

        def fold(cvs, n):
            m = torch.zeros(lanes * n, dtype=torch.int32, device=dev)
            if cvs:
                m.index_add_(0, torch.cat([t for t, _ in cvs]),
                             torch.cat([c for _, c in cvs]).to(torch.int32))
            return (m > 0).view(*lead, n)

        mask_s = fold(s_cvs, s.nc)
        mask_r = fold(r_cvs, s.nl)
        dl_n = torch.zeros(lanes * s.lchunk_slots, dtype=torch.int32,
                           device=dev)
        dl_n.index_add_(0, T["lchunk"].view(-1), mask_r.view(-1).to(torch.int32))
        dl_n = (dl_n.view(*lead, s.lchunk_slots) > 0) & T["dl_valid"]
        if s.n_shards > 1:
            # one exchange a step: every rank takes the same gates
            both = por_(torch.cat([mask_s, dl_n]), self.mesh)
            mask_s, dl_n = both[: s.nc], both[s.nc :]
        changed = mask_s.any(dim=-1) | dl_n.any(dim=-1)
        return changed, mask_s, dl_n, torch.stack(counts, dim=-1)


# -------------------------------------------------------------- the program


class BucketProgram:
    """A bucket's step group: its argument tables on its device, the
    state pair it runs on, and on a card the CUDA graph of ``unroll``
    steps.  ``flags`` = [changed, then 5 gate counts a step].  With
    ``lanes`` > 0 every buffer has that leading lane axis (a cohort
    program, ``core/cohort.py``)."""

    def __init__(self, struct: BucketStruct, shapes: Dict[str, tuple],
                 device, lanes: int = 0):
        dev = torch.device(device)
        lead = (lanes,) if lanes else ()
        self.struct = struct
        self.shapes = dict(shapes)
        self.device = dev
        self.pair = state_pair(dev, struct.nc, struct.nl, struct.wl,
                               lanes=lanes)
        self.T = {
            k: torch.zeros((*lead, *shape), dtype=_TORCH[dt], device=dev)
            for k, (shape, dt) in self.shapes.items()
        }
        self.ms = torch.zeros((*lead, struct.nc), dtype=torch.bool, device=dev)
        self.dl = torch.zeros((*lead, struct.lchunk_slots), dtype=torch.bool,
                              device=dev)
        self.flags = torch.zeros((*lead, 1 + 5 * struct.unroll),
                                 dtype=torch.int64, device=dev)
        self.step = self._new_step()
        self.graph = None
        self.launches: dict = {}
        self.capture_s = 0.0
        self.graph_bytes = 0

    def _new_step(self) -> _Step:
        return _Step(self.struct, self.T, self.device)

    @classmethod
    def from_spec(cls, spec: dict, device) -> "BucketProgram":
        """The program a :func:`program_spec` describes, on ``device``
        (not captured: :meth:`capture` does that)."""
        struct, shapes = spec_parts(spec)
        return cls(struct, shapes, device)

    @property
    def nbytes(self) -> int:
        """Bytes this program holds on its device: its tables, carries
        and graph pool (the state pair is counted once per layout, by
        :func:`program_bytes`)."""
        own = sum(t.numel() * t.element_size()
                  for t in (*self.T.values(), self.ms, self.dl, self.flags))
        return own + self.graph_bytes

    def load(self, tabs: Dict[str, np.ndarray]) -> None:
        """An engine's table content into the program's buffers."""
        for k, v in tabs.items():
            self.T[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))

    def _group(self) -> None:
        sp, rp = self.pair.sp, self.pair.rp
        ms, dl = self.ms, self.dl
        changed = torch.zeros(self.step.lead, dtype=torch.bool,
                              device=self.device)
        counts = []
        for _ in range(self.struct.unroll):
            ch, ms, dl, c = self.step(sp, rp, ms, dl)
            changed = changed | ch
            counts.append(c)
        self.ms.copy_(ms)
        self.dl.copy_(dl)
        torch.cat([changed.to(torch.int64).unsqueeze(-1),
                   torch.cat(counts, dim=-1)], dim=-1, out=self.flags)

    def capture(self) -> None:
        """Capture one group into a CUDA graph on the pair.  A failed
        capture raises; nothing falls back to eager replay."""
        from distel_tpu_torch.core.rowpacked_engine import _no_gc, _warm_kernels

        dev = self.device
        _warm_kernels(dev)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with CAPTURE_LOCK, _no_gc(), bitmatmul.recording() as rec, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._group()
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: v for k, v in rec.items() if v}
        self.graph = graph
        pool = tuple(graph.pool())
        self.graph_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool
        )

    def run(self, mesh=None) -> np.ndarray:
        """One group from the carries, on ``mesh`` (a program of several
        shards runs uncaptured: a graph cannot hold a collective); the
        flags on the host (the one read a group)."""
        self.step.bind(mesh)
        if self.graph is not None:
            self.graph.replay()
            bitmatmul.add_launches(self.launches)
        else:
            self._group()
        return self.flags.cpu().numpy()


_TORCH = {"int64": torch.int64, "int32": torch.int32, "int8": torch.int8,
          "bool": torch.bool}


def get_program(struct, tabs, sig: str, device):
    """``(program, CompileStats)`` for ``sig`` from :data:`PROGRAMS`:
    built (and on a card captured) on a miss, with ``trace_lower_s``
    the buffer build, ``compile_s`` the capture and the persistent-cache
    counters the kernel libraries the capture loaded; all 0 on a hit (a
    program an installed artifact farm hands over is one)."""
    from distel_tpu_torch.runtime.instrumentation import (
        CompileStats,
        library_loads,
    )

    stats = CompileStats(bucket_signature=sig, program="step")

    def build():
        with library_loads(stats):
            t0 = time.perf_counter()
            prog = BucketProgram(struct, table_shapes(tabs), device)
            t1 = time.perf_counter()
            if prog.device.type == "cuda" and struct.n_shards == 1:
                prog.capture()
            stats.trace_lower_s = t1 - t0
            stats.compile_s = time.perf_counter() - t1
        return prog

    prog, hit = PROGRAMS.get_or_build((sig, "step"), build)
    stats.program_cache_hit = hit
    return prog, stats


def _on(p, kind: str) -> bool:
    """Whether registry value ``p`` (a step program or a fused window)
    runs on a device of type ``kind``: its state pair's."""
    return p.pair.sp.device.type == kind


def _held_programs() -> list:
    """The programs an installed artifact farm holds until an engine
    asks for them (``core/artifacts.py``)."""
    src = PROGRAMS.artifact_source
    held = getattr(src, "held_programs", None)
    return held() if held is not None else []


def program_bytes(device="cuda") -> int:
    """Bytes the registry's programs hold on devices of ``device``'s
    type: each step or cohort program's tables, carries and graph pool,
    each fused window's graph pools, and each state pair once (a cohort
    program's is its stacked pair, one per layout and rung); with the
    programs an installed artifact farm still holds."""
    kind = torch.device(device).type
    total, pairs = 0, {}
    with PROGRAMS._lock:
        progs = [p for p in PROGRAMS._programs.values() if _on(p, kind)]
    progs += [p for p in _held_programs() if _on(p, kind)]
    for p in progs:
        total += p.nbytes if isinstance(p, BucketProgram) else p.card_bytes
        pairs[id(p.pair)] = p.pair.nbytes
    return total + sum(pairs.values())


def drop_idle_programs(device="cuda") -> int:
    """Evict from :data:`PROGRAMS` every program on devices of
    ``device``'s type that no live engine uses (engines hold their
    programs and windows weakly, so each weak reference is a user; no
    engine holds a cohort program, so one is idle between cohorts);
    counted as evictions; and every program an installed artifact farm
    still holds (a later request for one builds it from its engine's
    tables).  A memory budget's first resort, before it evicts a tenant:
    programs outlive the tenants that built them.  Returns how many
    went."""
    kind = torch.device(device).type
    with PROGRAMS._lock:
        idle = [k for k, p in PROGRAMS._programs.items()
                if _on(p, kind) and not weakref.getweakrefcount(p)]
        for k in idle:
            del PROGRAMS._programs[k]
        PROGRAMS.evictions += len(idle)
    drop = getattr(PROGRAMS.artifact_source, "drop_held", None)
    return len(idle) + (drop(kind) if drop is not None else 0)
