"""Row-packed saturation engine: transposed, scatter-free, frontier-gated.

The port of ``distel_tpu/core/rowpacked_engine.py``'s exact-shape,
single-device path.  The state is stored **transposed and packed**:

    S_T [a, xw]  int32 — bit x of word xw set iff a ∈ S(x)
    R_T [l, xw]  int32 — bit x set iff (x, filler(l)) ∈ R(role(l))

(int32 words carry the uint32 bit pattern), and every completion rule
writes whole rows:

  CR1  S_T[b]  ∨= S_T[a]                       row gather + seg-OR
  CR2  S_T[b]  ∨= S_T[a1] ∧ S_T[a2]            two gathers + seg-OR
  CR3  R_T[l]  ∨= S_T[a]                       row gather + seg-OR
  CR4  S_T[b_j] ∨= W[j,:] ⊙ R_T                packed-columns kernel
         W[j,l] = H[role(l), s_j] ∧ S_T[a_j, bit filler(l)]
  CR6  R_T[lt_p] ∨= D[p,:] ⊙ R_T               packed-columns kernel
         D[p,l] = H[role(l), r_p] ∧ R_T[l2_p, bit filler(l)]
  CR5  S_T[⊥]  ∨= OR_l botf(l) ? R_T[l]        masked packed OR-reduce

in that order within a step.  The role hierarchy never materializes:
the closure masks are FACTORED (``m[j, ρ] = H[ρ, s_j]``, gathered per
link through its role), and each CR4/CR6 row chunk contracts only the
link windows whose roles can satisfy it (static live windows; chunks
cut at role runs once the tables are big enough for that to pay, as in
the reference).  CR6 runs the live-tile schedule (``core/cr6_tiles.py``)
when its live structure is sparse enough.

**Frontier gating** (the reference's two-sided semi-naive join): every
writer returns its per-target change vector, and after each step one
device fold turns them into the frontier of the next step — the
changed S rows, and per L-chunk (``lc`` links of the link axis) whether
an R row in it changed.  A CR4/CR6 window contracts only when an R row
of an L-chunk it overlaps, or a bit-table source row of its chunk (S
rows ``a_j`` for CR4, the L-chunks of the rows ``l2_p`` for CR6),
changed in the last step; a live-tile slot likewise; with chunk gating
(``gate_chunks``) CR5 runs only when R or the ⊥ row changed.  Skipping
only delays derivations (every rule is a monotone OR, and the loop
stops only after a step that changed nothing), and the per-round states
equal the reference's ``_step`` with its dirty carry when both engines
run the same chunk plan.  The flags reach the host in one small copy
per round, which replaces the convergence read: a window whose inputs
are clean launches nothing.

What differs from the reference, and why:

* The fixed point is a host loop with one flag read per step; there is
  no ``lax.while_loop`` to compile.  It keeps the reference's ``unroll``
  semantics: steps run in groups of ``unroll``, the loop stops only
  after a whole group changed nothing, and ``iterations`` counts whole
  groups against a budget of ``max_iters`` rounded up to ``unroll``.
  A clean step inside a group contracts nothing (its frontier is
  clean).  PyTorch runs eagerly, so there is no scan mode: chunks are a
  Python loop.
* The fold ORs each writer's change vector into the frontier masks by
  an indexed write (targets are unique within a writer); the reference's
  layered permutation gathers exist only because a scatter serialises
  on the TPU.
* Rows are written in place (the state is the largest tensor of a run).
* The link axis is never evened out to the window grid: windows that
  run past its end are cut short (the reference pads the axis with
  inert links instead), so ``nl`` never exceeds the reference engine's
  and snapshots interchange both ways.
* Temporaries are sized against the device's memory (an 80 GB H100)
  rather than the 16 GB v5e the reference's thresholds were measured on
  — see ``core/engine.py``'s :func:`default_temp_budget`.

**The observed fixed point** (:meth:`saturate_observed`) is the
reference's: per-round observation, the adaptive dense/sparse
controller with pipelined dense rounds (``sparse_tail=``,
``pipeline=``), :class:`~distel_tpu_torch.runtime.instrumentation.
FrontierStats` per round.  A dense round is ``unroll`` gated steps; its
last fold also copies the changed-S row mask to the host, which the
controller's density measure and the sparse tier read (the unobserved
:meth:`saturate` copies only the flags).  A sparse round
(:meth:`_sparse_exec`) runs the selected rule rows only, in the dense
step's rule and write-group order, and contracts each write group's
selected CR4/CR6 rows per row chunk, ``[k_selected, window] ⊙ R[window]``,
through the packed-columns kernels; its writes go through
``SegmentedRowOr`` with change tracking, so duplicate targets count
their new bits once, as the reference's sequential writes do.  What
differs from the reference's tier, and why:

* The reference selects rows over its scanned slabs (uniform ``rk``-row
  chunks; a row of a dropped span, or of a chunk with no live window,
  is inert).  The port has no scanned slabs: a row's chunk is its row
  chunk of this engine's plan, inert when dropped at build or left with
  no live window by a rebind.  Where both engines plan one span per
  rule, the counts (``rows_touched``, ``density``) are the reference's.
* The tier runs on every plan (:meth:`_sparse_supported`).  The
  reference's rides its scanned formulation, which its default
  (``shape_buckets = true``) always builds; unbucketed and unscanned
  (for instance 8k on its CPU backend) it takes the plain observed loop
  instead, every round dense.
* Capacity rungs compile nothing here; they keep their meaning: a
  selection past the last rung overflows, and the round runs dense.

**The fused K-round window** (``fused_rounds={"rounds": K}``, K > 1;
:meth:`_saturate_fused`) is the reference's: up to K rounds of the
adaptive controller per dispatch, the tier decision on the card, one
host read a window, every retired round the per-round controller's.
On a card a window is one CUDA graph a ``(K, capacities)`` pair,
captured once and replayed: K round bodies unrolled, each four
conditional (IF) nodes in a row (:meth:`_branch`, ``ops/graph_if.py``):
the round's decision while the window still runs, the dense tier, the
sparse tier, and the round's record, each on a flag the card computed
(PyTorch 2.11 exposes no IF nodes, so ``csrc/graph_if.cu`` adds them;
one level, no nesting).  Every table the body
reads is on the card before the capture; the body reads nothing back:
the device round plan (:meth:`_round_plan_dev`) replaces the host
selection, the compaction is a prefix sum and a scatter
(:meth:`_compact_dev`), the dense step takes each window's liveness as
a card-held row count that the kernels read (:meth:`_step_dev`), and
the sparse step runs at the traced capacities (:meth:`_sparse_exec_dev`)
with duplicate-safe row writes (:meth:`_seg_or_write`).  A host sync in
the body fails the capture, and the run with it.  On the CPU the same
body runs eagerly on the plain versions, under :class:`NoHostReads`,
which raises on the operations that would sync a card.  What differs
from the reference's window, and why:

* The reference contracts a sparse round's selected CR4/CR6 rows one
  row at a time; the port contracts each row chunk's selected rows
  (capacity-sized, the count on the card) through the packed-columns
  kernels, window by window, in the dense step's write groups.
* A graph replays its captured launches without a wrapper call, so the
  launch counts of :data:`~distel_tpu_torch.ops.bitmatmul.LAUNCHES`
  are what the retired rounds' tier bodies captured, added at retire.
* Captured graphs hold the addresses they were captured on: a card
  engine runs its windows on one state pair of its own, copied in at
  the start of a run and out at its end.

**Shape buckets** (``bucket=True``, the default through
``shape_buckets``): the layout quantizes onto the reference's ladder
with a dead row past the corpus on each axis, and :meth:`saturate` runs
the bucket's step program (``core/bucketing.py``) from
:data:`~distel_tpu_torch.core.program_cache.PROGRAMS`: the plan below
(chunks, windows, L-chunk grid, built over the exact-mode layout)
padded to rungs, its content copied into the program's tables, its
gates on the card, on a CUDA graph shared by every engine of the
bucket.  Rounds, ``gate_rounds`` and the closure are the exact-mode
engine's.  What differs from the reference's bucket mode, and why:

* The reference buckets its scanned slabs (uniform ``rk``-row spans,
  deferred group writes); the port has none, so it pads its own plan:
  chunk count, rows a chunk, window slots a chunk and slot length on
  ladder rungs.  Its CR3 pad segments write nothing, where the
  reference's OR the dead concept row's bit into the dead link row.
* The live-tile CR6 stays off (its schedule is not rung-canonical yet).
* Fused windows are keyed by their content (the window body is this
  plan, unpadded), so they are shared by engines with equal tables.

**Sharded execution** (``mesh=``, a :class:`~distel_tpu_torch.parallel.
mesh.Mesh`; the reference's word-axis sharding): the packed word axis is
sharded, each rank holding ``S_T [nc, wc/n]`` and ``R_T [nl, wc/n]``
(the concept axis pads to ``32·n``), and every rank runs the same plan
and host loop.  The row rules, the CR4/CR6 products and CR5's OR are
rank-local; three things cross ranks, through
``parallel/shard_compat.py``: each CR4/CR6 window's filler bit table
(each rank looks up the fillers in its word window, the partials ORed
eight entries a byte, :meth:`_bit_table`), CR5's ⊥-filler mask, and the
step's fold (the changed-S rows and dirty L-chunks ORed once a step, so
every rank takes the same gates and the same vote).  Live bits sum over
the ranks; a run's result is gathered whole on every rank
(:meth:`gather_state`) and keeps the rank's shards.  As in the
reference, the size tiers read a shard's state and tip earlier on a
mesh (a mesh of one too: ``unroll`` and the CR5 gate), and the live-tile
CR6 is off (reason ``"mesh"``).  The bucketed program keys on the mesh
and, on more than one rank, runs uncaptured (a CUDA graph cannot hold a
gloo collective).

``saturate_observed`` runs sharded on every path, as the reference's
does: the host controller is mesh-agnostic, because every rank takes
every branch on values reduced across the ranks.  A sparse round
(:meth:`_sparse_exec`) runs each rule over the replicated selection on
the rank's words, with the dense step's bit-table exchanges, and ends
with one fold (changed rows ORed, gained bits summed); a dense round's
fold is the step's.  The fused window folds each of its rounds the same
way, on the card; on a mesh of one it stays one captured graph, on more
than one rank it runs uncaptured like the bucketed step: its IF
predicates are read by the host (4 a round), where the reference's
window reads the host once a window, and every exchange inside it
waits for the peers.  ``host_reads`` keeps counting the controller's
own reads; the exchanges are counted in ``shard_compat.COLLECTIVES``.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distel_tpu_torch.core.cr6_tiles import (
    TILE_DEFAULTS,
    build_cr6_tile_schedule,
    make_tile_matmul,
)
from distel_tpu_torch.core.engine import (
    SaturationResult,
    _host_bit_total,
    _pad_up,
    default_temp_budget,
    fresh_init_total,
    live_bits,
    observed_loop,
    popcount_rows,
)
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID, IndexedOntology
from distel_tpu_torch.core.program_cache import PROGRAMS, bucket_dim, signature_of
from distel_tpu_torch.ops import bitmatmul, graph_if
from distel_tpu_torch.ops.nosync import NoHostReads
from distel_tpu_torch.parallel.shard_compat import (
    all_gather_words,
    mesh_size,
    por_,
    por_bits,
    psum_,
    shard_word_base,
)
from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.runtime.instrumentation import (
    COHORT_EVENTS,
    CompileStats,
    DISPATCH_EVENTS,
    FRONTIER_EVENTS,
    FrontierStats,
    library_loads,
    rule_scope,
)
from distel_tpu_torch.ops.bitpack import (
    SegmentedRowOr,
    bit_lookup_from,
    or_reduce_any,
)

#: chunk-count ceiling of the role-aware CR4/CR6 chunking: each chunk
#: costs a few launches per live window per round, so merging relaxes
#: (wider waste factors) until the count fits
MAX_ROLE_CHUNKS = 256

#: dense contraction volume (table rows × nl × nc) from which CR4/CR6
#: chunks cut at role runs and windows resolve the link table's role
#: runs — the reference's threshold: below it the whole table is one
#: row-budget chunk over budget-sized windows
ROLE_SPLIT_MIN_VOLUME = 5e11

#: the reference's automatic chunk gating (which adds the CR5 gate):
#: from this many padded concepts, up to :data:`GATE_MAX_STATE_BYTES`
GATE_MIN_CONCEPTS = 32_768
GATE_MAX_STATE_BYTES = 5 << 29

#: the reference's automatic ``unroll`` on one device: 2 steps a group
#: up to this much packed state, 1 past it
UNROLL2_MAX_STATE_BYTES = 9 << 29

#: on a mesh (a mesh of one too), the reference's ``large`` tier: past
#: this much state a shard, ``unroll`` drops to 1 and CR5 runs ungated
MESH_LARGE_STATE_BYTES = 3 << 29


def cr5_reduce(sp, rp, fillers, bottom_idx, temp_budget: int, mesh=None,
               word_base=None) -> torch.Tensor:
    """The OR of the R rows whose filler is unsatisfiable [wc] (in row
    blocks within ``temp_budget``, so the masked copy stays bounded).
    On a mesh, ``sp``/``rp`` hold the word window at ``word_base``: the
    ⊥-filler mask is exchanged (each filler's bit lives on one rank),
    the OR is over the rank's own words."""
    wc = sp.shape[1]
    botf = por_(bit_lookup_from(sp[bottom_idx].T, fillers, word_offset=word_base,
                                dtype=torch.uint8), mesh)[:, 0].bool()
    blk = max(temp_budget // (4 * wc), 1)
    red = torch.zeros(wc, dtype=torch.int32, device=sp.device)
    for i in range(0, rp.shape[0], blk):
        masked = torch.where(botf[i : i + blk, None], rp[i : i + blk], 0)
        red |= or_reduce_any(masked, 0)
    return red


def _factored_closure_tables(h, nf4_roles, chain_roles):
    """``(m4, m6)``: ``h`` extended with one all-zero SENTINEL role row
    (padded links carry the sentinel id, so their mask column is dead),
    gathered per table row: ``m4[j, ρ] = H[ρ, s_j]``, ``m6[p, ρ] =
    H[ρ, r_p]``.  None roles (rule off) give an empty table."""
    n_roles = h.shape[0]
    h2 = np.zeros((n_roles + 1, n_roles), np.int8)
    h2[:n_roles] = h

    def tab(roles):
        if roles is None:
            return np.zeros((0, n_roles + 1), np.int8)
        return np.ascontiguousarray(h2[:, roles].T)

    return tab(nf4_roles), tab(chain_roles)


def _tile_group_bounds(tab_roles: np.ndarray, tile_m: int,
                       max_tiles: int) -> List[int]:
    """Write-group bounds (table rows) of the live-tile CR6 such that no
    group holds more than ``max_tiles`` row tiles, so its deferred
    [tiles × tile_m, wc] output stays within the temporary budget.  A
    row tile never spans two role runs' pieces of ``tile_m`` rows
    (merging only lowers the count), so counting pieces bounds the
    tiles; bounds fall on piece starts, where the schedule cuts too.
    Many short role runs (each a padded tile) make many groups."""
    n = len(tab_roles)
    starts = np.flatnonzero(np.r_[True, tab_roles[1:] != tab_roles[:-1]])
    ends = np.r_[starts[1:], n]
    bounds, tiles = [0], 0
    for s, e in zip(starts.tolist(), ends.tolist()):
        for o in range(s, e, tile_m):
            if tiles == max_tiles:
                bounds.append(o)
                tiles = 0
            tiles += 1
    return bounds + [n]


class RankWindows(NamedTuple):
    """A rank's word windows ``(sp [nc, wl], rp [nl, wl])`` of a sharded
    state, as ``initial=`` of a run of an engine of the same layout on
    the same mesh: it embeds without a gather (the incremental plane's
    hand-over between the engines of one round-robin)."""

    sp: torch.Tensor
    rp: torch.Tensor


class _Chunk(NamedTuple):
    """One CR4/CR6 row chunk of the window formulation."""

    src: torch.Tensor        # [rk] bit-table source rows (a_j / l2_p)
    mask: torch.Tensor       # [rk, n_roles + 1] factored mask rows
    piece: SegmentedRowOr    # the chunk's write plan over its targets
    order: torch.Tensor      # the plan's emission order
    #: live windows ``(off, end, c0, c1)``: links [off, end) and the
    #: first and last L-chunk the (uncut) window overlaps
    windows: List[Tuple[int, int, int, int]]


@dataclass
class Frontier:
    """What changed in the last step, as the next step reads it (host
    flags; ``dirty_l_dev`` is the device copy the live-tile slots read,
    with a trailing always-False slot)."""

    changed: bool
    dirty_l: np.ndarray      # [n_lchunks] an R row of the L-chunk changed
    f4: np.ndarray           # [CR4 chunks] a source S row changed
    f6: np.ndarray           # [CR6 chunks] an L-chunk of a source row did
    fd6: np.ndarray          # [CR6 row tiles] same, per live-tile row tile
    cr5: bool                # R or the ⊥ row changed
    dirty_l_dev: torch.Tensor
    #: [nc] the changed S rows — on the host only where the observed
    #: controller asked for it (``carry``), else None
    mask_s: Optional[np.ndarray] = None


class _OpCount(TorchDispatchMode):
    """Counts the tensor operations run under it (a capture records each
    as one or more graph nodes)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


_WARM = set()
#: captures in progress in this process, under _GC_LOCK: the garbage
#: collector stays off while any runs (no CUDA object may be freed
#: inside a capture) and comes back as it was after the last
_GC_STATE = {"captures": 0, "was_enabled": True}
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_gc():
    with _GC_LOCK:
        if _GC_STATE["captures"] == 0:
            _GC_STATE["was_enabled"] = gc.isenabled()
            gc.collect()
            gc.disable()
        _GC_STATE["captures"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_STATE["captures"] -= 1
            if _GC_STATE["captures"] == 0 and _GC_STATE["was_enabled"]:
                gc.enable()


def _warm_kernels(device) -> None:
    """Load the packed-columns library and launch each kernel a window
    captures once on tiny operands (row count 0), so that no module is
    first loaded inside a capture."""
    key = str(device)
    if key in _WARM:
        return
    a = torch.zeros((64, 64), dtype=torch.int8, device=device)
    b = torch.zeros((64, 8), dtype=torch.int32, device=device)
    c = torch.zeros((64, 8), dtype=torch.int32, device=device)
    n = torch.zeros(1, dtype=torch.int32, device=device)
    for skip in (False, True):
        PackedColsMatmulPlan(64, 64, 8, skip_zero_tiles=skip)(a, b, out=c,
                                                             n_rows=n)
    torch.cuda.synchronize(device)
    _WARM.add(key)


class _WindowOut:
    """One dispatched window's report, changed-S mask and dirty
    L-chunks on their way to the host: on a card, asynchronous copies
    into pinned buffers behind an event; on the CPU, copies."""

    def __init__(self, win):
        srcs = (win.report, win.ms, win.dl)
        if win.report.device.type == "cuda":
            self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         for t in srcs]
            for buf, t in zip(self.bufs, srcs):
                buf.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.bufs = [t.clone() for t in srcs]
            self.event = None

    def wait(self):
        """``(report, mask_s, dirty_l)`` as numpy arrays, once the
        copies landed."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(b.numpy() for b in self.bufs)


class _FusedWindow:
    """One window of K rounds at sparse capacities ``caps``: its carries
    and per-round records as fixed card tensors (a graph reads and
    writes them in place), and on a card its captured graph."""

    def __init__(self, engine, K: int, caps: tuple, state):
        # no reference back to the engine: an engine and its windows
        # must not form a cycle (a cycle frees its card memory only at a
        # garbage collection, which may come in the middle of a capture)
        dev = engine.device
        self.K, self.caps = K, caps
        self.state = state

        def scalar(dtype=torch.int64):
            return torch.zeros((), dtype=dtype, device=dev)

        # carries (loaded at a sync point, chained between windows)
        self.ms = torch.zeros(engine.nc, dtype=torch.bool, device=dev)
        self.dl = torch.zeros(engine.n_lchunks, dtype=torch.bool, device=dev)
        self.below, self.it = scalar(), scalar()
        self.budget, self.below_cut, self.hyst = scalar(), scalar(), scalar()
        self.status, self.rdone = scalar(), scalar()
        # one round's decision and results
        (self.use_dense, self.use_sparse, self.fallout, self.idle,
         self.ch) = (scalar(torch.bool) for _ in range(5))
        self.rows, self.below_next = scalar(), scalar()
        self.bits, self.delta = scalar(), scalar()
        # per-round records, and the report the host reads
        self.tb, self.rb, self.db, self.bb = (
            torch.zeros(K, dtype=torch.int64, device=dev) for _ in range(4)
        )
        self.cb = torch.zeros(K, dtype=torch.bool, device=dev)
        self.report = torch.zeros(4 + 5 * K, dtype=torch.int64, device=dev)
        #: per round, per tier: the kernel launches its body captured
        self.launches = [{} for _ in range(K)]
        self.plan = None
        self.graph = self.pool = None
        self.capture_s = 0.0
        self.captured_ops = 0
        self.card_bytes = 0

    def load(self, s_chg, dirty_l, below, iteration, budget, below_cut,
             hyst) -> None:
        """The host carry of a sync point, into the window's tensors."""
        self.ms.copy_(torch.from_numpy(np.asarray(s_chg, bool)))
        self.dl.copy_(torch.from_numpy(np.asarray(dirty_l, bool)))
        for t, v in ((self.below, below), (self.it, iteration),
                     (self.budget, budget), (self.below_cut, below_cut),
                     (self.hyst, hyst)):
            t.fill_(int(v))

    def chain(self, prev) -> None:
        """Continue from ``prev``'s exit carries, on the card."""
        for name in ("ms", "dl", "below", "it", "budget", "below_cut",
                     "hyst"):
            getattr(self, name).copy_(getattr(prev, name))

    def run(self, engine) -> None:
        if self.graph is not None:
            self.graph.replay()
            # four IF nodes a round, each behind its setter kernel
            graph_if.add_launches(4 * self.K)
        else:
            with NoHostReads():
                engine._window_body(self)
        self.plan = None

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.pool = self.plan = None


class RowPackedSaturationEngine:
    """Compiles an indexed ontology into plans over transposed
    row-packed state on ``device``; :meth:`saturate` runs the fixed
    point.  API mirrors the reference engine: ``initial_state`` /
    ``step`` / ``saturate`` / ``embed_state``."""

    #: :meth:`embed_state` takes the packed transposed (v2 wire) form
    accepts_wire_state = True

    def __init__(
        self,
        idx: IndexedOntology,
        *,
        device="cuda",
        pad_multiple: int = 128,
        temp_budget_bytes: Optional[int] = None,
        rules: Optional[frozenset] = None,
        cr6_tiles: Optional[dict] = None,
        l_chunk: Optional[int] = None,
        l_chunk_cr4: Optional[int] = None,
        gate_chunks: Optional[bool] = None,
        unroll: Optional[int] = None,
        min_concepts: int = 0,
        min_links_pad: int = 0,
        link_window: Optional[Tuple[int, int]] = None,
        window_headroom: int = 0,
        sparse_tail=None,
        pipeline=None,
        fused_rounds=None,
        bucket: bool = False,
        bucket_ratio: float = 1.25,
        state_dims: Optional[Tuple[int, int]] = None,
        mesh=None,
    ):
        """``rules``: subset of {"CR1".."CR6"} this engine applies (None
        = all).  ``cr6_tiles``: live-tile CR6 config (None = off; keys
        ``enable``, ``tile_m``, ``tile_l``, ``density_threshold``).
        ``l_chunk`` / ``l_chunk_cr4``: the L-chunk length (the frontier's
        granularity on the link axis and CR6's window length) and CR4's
        window length (at most ``l_chunk``), as the reference's knobs of
        the same names; None = from the temporary budget.
        ``gate_chunks``: gate CR5 on its inputs' change (None = the
        reference's rule: from 32,768 padded concepts up to 2.5 GiB of
        packed state).  ``unroll``: steps per convergence check (None =
        the reference's rule: 2 up to 4.5 GiB of packed state, else 1).

        The incremental plane's hooks (``core/incremental.py``), with
        the reference's names and meanings: ``min_concepts`` /
        ``min_links_pad`` reserve concept lanes and link rows past the
        corpus (a later delta's concepts and links park there; the link
        axis is never evened out, so ``l_chunk`` cannot move ``nl``);
        ``link_window=(w0, w1)`` restricts CR4/CR6 to links in
        ``[w0, w1)`` (the cross program of a link-creating delta; row
        rules and CR5 are unaffected, and with tiles configured CR6
        takes the live-tile schedule whatever its density);
        ``window_headroom``: live-window slots reserved per CR4/CR6
        chunk (and link tiles per row tile) for
        :meth:`rebind_role_closure`.

        The observed fixed point's knobs, with the reference's names,
        keys and defaults: ``sparse_tail`` (None/False = off, True = the
        defaults, or a dict of ``enable``, ``density_threshold``,
        ``capacity_buckets``, ``hysteresis_rounds``,
        ``capacity_floor``), ``pipeline`` (None = on at depth 2) and
        ``fused_rounds`` (None = K 1; ``enable``, ``rounds`` K,
        ``adaptive``).  Degenerate values raise here, not rounds into
        a run.

        ``bucket``: shape-bucketed mode (``core/bucketing.py``, the
        reference's default through ``shape_buckets``): the state layout
        quantizes onto the ``bucket_dim`` ladder (``bucket_ratio``
        steps) with one dead row past the corpus on each axis, and
        :meth:`saturate` runs a program of :data:`PROGRAMS` whose
        launches are a pure function of :attr:`bucket_signature`, so
        ontologies of one bucket share it (on a card one CUDA graph).
        The plan itself — row chunks, live windows, the L-chunk grid —
        is the one this corpus gives in exact mode, so every round
        equals the exact-mode engine's; the live-tile CR6 is off (its
        structure is not rung-canonical yet).  ``state_dims``: pin the
        layout ``(nc, nl)`` verbatim (the bucketed delta engines pin the
        base's; bucket mode needs the last row of each axis past the
        corpus).

        ``mesh``: a :class:`~distel_tpu_torch.parallel.mesh.Mesh` to
        shard the packed word axis over (see the module docstring); its
        ranks must build their engines from the same index and config.
        The concept axis pads to ``32 · mesh.size``."""
        from distel_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {mesh!r}")
        self.mesh = mesh
        self.n_shards = mesh_size(mesh)
        self._sparse_cfg = self._normalize_sparse_cfg(sparse_tail)
        self._pipeline_cfg = self._normalize_pipeline_cfg(pipeline)
        self._fused_cfg = self._normalize_fused_cfg(fused_rounds)
        if rules is not None:
            unknown = set(rules) - {f"CR{i}" for i in range(1, 7)}
            if unknown:
                raise ValueError(f"unknown rules: {sorted(unknown)}")
        self.idx = idx
        self.device = torch.device(device)
        if temp_budget_bytes is None:
            temp_budget_bytes = default_temp_budget(self.device)
        self.temp_budget_bytes = int(temp_budget_bytes)
        pad_multiple = _pad_up(max(pad_multiple, 32), 32)
        self._bucket = bool(bucket)
        self._bucket_ratio = float(bucket_ratio)
        #: corpus-axis ladder (floor 32) and small-structure ladder
        #: (floor 1: chunk counts, rows, window slots), and the seg-OR
        #: histogram ladder (powers of two from 8), as the reference's
        # (closures over the ratio, not over self: an engine must not sit
        # in a reference cycle)
        ratio = self._bucket_ratio
        self._q = lambda n: bucket_dim(n, ratio)
        self._q1 = lambda n: bucket_dim(n, ratio, floor=1)
        self._qn = lambda n: bucket_dim(n, 2.0, floor=8)
        # the exact-mode layout: the plan (chunks, windows, L-chunk grid)
        # is built over it in both modes
        nc_x = _pad_up(
            _pad_up(max(idx.n_concepts, min_concepts, 2), pad_multiple), 32
        )
        nl_x = max(_pad_up(idx.n_links, 32), 32, _pad_up(min_links_pad, 32))
        if state_dims is not None:
            nc_pin, nl_pin = (int(d) for d in state_dims)
            reserve = 1 if self._bucket else 0
            if nc_pin % (32 * self.n_shards) or nl_pin % 32:
                raise ValueError(
                    f"state_dims {state_dims} must be 32-aligned "
                    f"({32 * self.n_shards} on the concept axis under "
                    f"{self.n_shards} shards)"
                )
            if nc_pin < max(idx.n_concepts + reserve, 2) or nl_pin < max(
                idx.n_links + reserve, 32
            ):
                raise ValueError(
                    f"state_dims {state_dims} too small for "
                    f"{idx.n_concepts} concepts / {idx.n_links} links"
                    + (" (+1 bucket dead-row reserve)" if reserve else "")
                )
            self.nc, self.nl = nc_pin, nl_pin
            nc_x, nl_x = min(nc_x, nc_pin), min(nl_x, nl_pin)
        elif self._bucket:
            # +1 before quantizing: the last row of each axis is past the
            # corpus, the dead row the quantized plans' pads aim at
            self.nc = _pad_up(_pad_up(
                self._q(max(idx.n_concepts + 1, min_concepts, 2)),
                pad_multiple), 32 * self.n_shards)
            self.nl = _pad_up(
                self._q(max(idx.n_links + 1, min_links_pad, 32)), 32
            )
        else:
            self.nc, self.nl = _pad_up(nc_x, 32 * self.n_shards), nl_x
        self._dead_c, self._dead_l = self.nc - 1, self.nl - 1
        #: the link rows the plan's L-chunk grid covers
        self._nl_plan = nl_x
        wc_x = nc_x // 32
        self._link_window = link_window
        self._window_headroom = int(window_headroom)
        self.wc = self.nc // 32
        #: this rank's packed words (all of them off a mesh) and the
        #: first of them; ``_wbase`` is None off a mesh (no window)
        self.wl = self.wc // self.n_shards
        self.word_base = shard_word_base(mesh, self.wc)
        self._wbase = self.word_base if self.n_shards > 1 else None
        dev = self.device
        # the reference's size tiers read the state a shard holds, and
        # tip earlier on a mesh (a mesh of one included)
        state_bytes = (self.nc + self.nl) * self.wc * 4 // self.n_shards
        large = state_bytes > (
            MESH_LARGE_STATE_BYTES if mesh is not None else GATE_MAX_STATE_BYTES
        )
        if unroll is None:
            unroll = 1 if (
                (mesh is not None and large)
                or state_bytes > UNROLL2_MAX_STATE_BYTES
            ) else 2
        self.unroll = max(int(unroll), 1)
        if gate_chunks is None:
            gate_chunks = self.nc >= GATE_MIN_CONCEPTS and not large
        self._gate_cr5 = bool(gate_chunks)

        def on(rule: str) -> bool:
            return rules is None or rule in rules

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        empty2 = np.zeros((0, 2), np.int64)
        empty3 = np.zeros((0, 3), np.int64)

        # ---- CR1-CR3: seg-OR plans, sources permuted into plan order
        def rule_plan(tab, tgt_col, src_cols):
            plan = SegmentedRowOr(tab[:, tgt_col])
            return (plan, *[i64(tab[plan.order, c]) for c in src_cols])

        nf1 = idx.nf1 if on("CR1") else empty2
        self._p1, self._src1 = rule_plan(nf1, 1, (0,))
        nf2 = idx.nf2 if on("CR2") else empty3
        self._p2, self._src2a, self._src2b = rule_plan(nf2, 2, (0, 1))
        nf3 = idx.nf3 if on("CR3") else empty2
        self._p3, self._src3 = rule_plan(nf3, 1, (0,))
        # raw (unpermuted) CR1-CR3 tables: the sparse tier selects rows
        # against these
        self._sp_nf1, self._sp_nf2, self._sp_nf3 = nf1, nf2, nf3
        # word-block sweep: each of CR1-CR3 is column-local (word w of a
        # target row depends only on word w of its sources), so blocks of
        # bw words bound the gathered [k, bw] temporaries
        emission_max = max(self._p1.k, 2 * self._p2.k, self._p3.k, 1)
        bw = max(min(self.temp_budget_bytes // (4 * emission_max), self.wl), 1)
        n_blocks = -(-self.wl // bw)
        self._bw = -(-self.wl // n_blocks)          # even the blocks out

        # ---- link tables: padded links get filler ⊤ (never ⊥, whose
        # CR5 mask bit is set) and the sentinel role (dead mask column)
        h = idx.role_closure
        n_roles = h.shape[0]
        fillers = np.full(self.nl, TOP_ID, np.int64)
        link_roles = np.full(self.nl, n_roles, np.int64)
        if idx.n_links:
            fillers[: idx.n_links] = idx.links[:, 1]
            link_roles[: idx.n_links] = idx.links[:, 0]
        self._fillers_np, self._link_roles_np = fillers, link_roles
        self._fillers, self._link_roles = i64(fillers), i64(link_roles)

        self._has4 = bool(len(idx.nf4) and idx.n_links and on("CR4"))
        self._has6 = bool(len(idx.chain_pairs) and idx.n_links and on("CR6"))
        self._bottom = bool(idx.has_bottom_axioms and idx.n_links and on("CR5"))
        m4, m6 = _factored_closure_tables(
            h,
            idx.nf4[:, 0] if self._has4 else None,
            idx.chain_pairs[:, 0] if self._has6 else None,
        )

        # ---- CR4/CR6 row chunks.  Chunk rows are bounded so one
        # chunk's packed output [rk, wc] fits the budget.  Once a table's
        # dense contraction is big enough for pruning to pay (the
        # reference's threshold), chunks cut at role-run boundaries (the
        # tables arrive role-sorted), so each chunk's live link set stays
        # small; runs merge greedily while the merged (rows × live links)
        # volume stays within ``waste`` of the parts' sum.
        mm_rows = max(self.temp_budget_bytes // (4 * wc_x), 1)
        link_cnt = (
            np.bincount(idx.links[:, 0], minlength=n_roles)
            if idx.n_links
            else np.zeros(n_roles, np.int64)
        )
        rows_max = max(
            len(idx.nf4) if self._has4 else 0,
            len(idx.chain_pairs) if self._has6 else 0,
        )
        big_tables = rows_max * nl_x * nc_x >= ROLE_SPLIT_MIN_VOLUME

        def role_chunks(tab_roles):
            n = len(tab_roles)
            if n == 0:
                return []
            if not big_tables:
                return [(o, min(o + mm_rows, n)) for o in range(0, n, mm_rows)]
            starts = np.flatnonzero(np.r_[True, tab_roles[1:] != tab_roles[:-1]])
            ends = np.r_[starts[1:], n]
            pieces = []
            for s, e in zip(starts, ends):
                rho = int(tab_roles[s])
                for o in range(s, e, mm_rows):
                    pieces.append((o, min(o + mm_rows, e), rho))

            def greedy(waste):
                out, cur = [], None
                for s, e, rho in pieces:
                    rset = h[:, rho] > 0
                    rmacs = (e - s) * int(link_cnt[rset].sum())
                    if cur is None:
                        cur = [s, e, rset.copy(), rmacs]
                        continue
                    nrows = e - cur[0]
                    nset = cur[2] | rset
                    nmacs = nrows * int(link_cnt[nset].sum())
                    if nrows <= mm_rows and nmacs <= waste * (cur[3] + rmacs):
                        cur[1], cur[2], cur[3] = e, nset, cur[3] + rmacs
                    else:
                        out.append((cur[0], cur[1]))
                        cur = [s, e, rset.copy(), rmacs]
                out.append((cur[0], cur[1]))
                return out

            for waste in (1.25, 2.0, 4.0, float("inf")):
                spans = greedy(waste)
                if len(spans) <= MAX_ROLE_CHUNKS:
                    break
            return spans

        spans4 = role_chunks(idx.nf4[:, 0]) if self._has4 else []
        spans6 = role_chunks(idx.chain_pairs[:, 0]) if self._has6 else []
        #: every span, with or without a live window: the bucketed step
        #: keeps them all, so its chunk count follows the table, not the
        #: closure (a cross engine's link window drops spans by content)
        self._spans4, self._spans6 = spans4, spans6
        max_rk = max([a1 - a0 for a0, a1 in spans4 + spans6], default=1)

        # ---- the L-chunk grid: the [rk, lc] int8 operand within half the
        # budget and, with big tables, no longer than the link table's
        # mean role run (with a 256 floor), so windows resolve role runs;
        # then evened out over the chunk count as the reference does.
        # The grid may end past nl: windows there are cut at nl.
        if l_chunk is not None:
            lc = min(_pad_up(max(l_chunk, 32), 32), nl_x)
        else:
            lc = min(
                _pad_up(max(self.temp_budget_bytes // 2 // max_rk, 32), 32),
                nl_x,
            )
            if big_tables:
                n_link_roles = max(
                    len(np.unique(idx.links[:, 0])) if idx.n_links else 1, 1
                )
                lc = min(lc, max(_pad_up(-(-nl_x // n_link_roles), 32), 256))
        self.n_lchunks = -(-nl_x // lc)
        lc = _pad_up(-(-nl_x // self.n_lchunks), 32)
        self.lc = lc
        self._grid_end = self.n_lchunks * lc
        # CR4's windows may be finer; the frontier grid stays lc (a
        # window no wider than one L-chunk overlaps at most two)
        self.lc4 = (
            lc if l_chunk_cr4 is None
            else min(_pad_up(max(l_chunk_cr4, 32), 32), lc)
        )

        def live_windows(role_list, lcn):
            return self._live_windows(role_list, lcn, h)

        self._plans: dict = {}
        plan = self._plan

        def window_spans(spans, tab, lcn):
            """Each span's live windows, kept ``(a0, a1, windows)``, and
            the roles of the spans with none (dropped from the plan)."""
            kept, dropped = [], []
            for a0, a1 in spans:
                wins = live_windows(tab[a0:a1, 0], lcn)
                if wins is None:
                    dropped.append(np.unique(tab[a0:a1, 0]))
                else:
                    kept.append((a0, a1, wins))
            return kept, dropped

        def build_chunks(kept, tab, src_col, mask_tab):
            out = []
            for a0, a1, wins in kept:
                piece = SegmentedRowOr(tab[a0:a1, 2])
                out.append(_Chunk(
                    i64(tab[a0:a1, src_col]),
                    torch.as_tensor(mask_tab[a0:a1]).to(dev),
                    piece,
                    i64(piece.order),
                    wins,
                ))
            return out

        def slots(kept, dropped):
            """What :meth:`rebind_role_closure` may grow into: each kept
            span's window slots (its build-time windows plus the
            headroom), and the dropped spans' roles."""
            hw = self._window_headroom
            return [(a0, a1, len(w) + hw) for a0, a1, w in kept], dropped

        kept4, dropped4 = (
            window_spans(spans4, idx.nf4, self.lc4) if self._has4 else ([], [])
        )
        self._chunks4 = build_chunks(kept4, idx.nf4, 1, m4)
        self._slots4 = slots(kept4, dropped4)

        # ---- CR6: live-tile schedule when its live structure is sparse
        # enough (a link-window engine's always), else the same
        # role-chunked window formulation as CR4.  The window structure
        # is recorded either way: a rebind refuses where the reference's
        # window program would
        self._tiles6 = None
        self.cr6_tiles_stats = {"active": False, "reason": "off"}
        tcfg = self._normalize_cr6_tiles_cfg(cr6_tiles)
        if mesh is not None and tcfg is not None:
            # as the reference's: the tile schedule is single-device
            tcfg = None
            self.cr6_tiles_stats = {"active": False, "reason": "mesh"}
        if self._bucket and tcfg is not None:
            tcfg = None
            self.cr6_tiles_stats = {"active": False, "reason": "bucket mode"}
        self._chunks6 = []
        kept6, dropped6 = (
            window_spans(spans6, idx.chain_pairs, lc) if self._has6 else ([], [])
        )
        self._slots6 = slots(kept6, dropped6)
        if self._has6:
            cp = idx.chain_pairs
            if tcfg is not None:
                tm_eff = max(min(tcfg["tile_m"], _pad_up(len(cp), 8)), 8)
                sched = build_cr6_tile_schedule(
                    cp[:, 0], cp[:, 1], cp[:, 2], link_roles, h,
                    lc=lc, n_lchunks=self.n_lchunks,
                    tile_m=tm_eff, tile_l=tcfg["tile_l"],
                    group_bounds=_tile_group_bounds(
                        cp[:, 0], tm_eff, max(mm_rows // tm_eff, 1)
                    ),
                    link_window=link_window,
                    dead_link=self.nl - 1,
                    tile_headroom=self._window_headroom,
                )
                window_macs = sum(len(w) * lc * (a1 - a0) for a0, a1, w in kept6)
                tile_macs = sched.stats["occupied_slots"] * sched.tile_m
                density = tile_macs / max(float(window_macs), 1.0)
                self.cr6_tiles_stats = {
                    "active": (density <= tcfg["density_threshold"]
                               or link_window is not None),
                    "density": round(density, 4),
                    "window_slot_rows": window_macs,
                    "tile_slot_rows": tile_macs,
                    **sched.stats,
                }
                if self.cr6_tiles_stats["active"]:
                    self._tiles6 = sched
                else:
                    self.cr6_tiles_stats["reason"] = "density above threshold"
            if self._tiles6 is None:
                self._chunks6 = build_chunks(kept6, cp, 1, m6)
        self._t6 = None
        if self._tiles6 is not None:
            self._t6 = self._tile_tables(self._tiles6, m6)

        # ---- frontier reductions: per chunk, which frontier entries its
        # bit table reads (CSR: entry ids and their chunk), reduced on
        # the device so the host copy stays n_chunks + n_lchunks flags;
        # the host copies serve :meth:`_frontier_from_host`
        def csr(sets):
            ids = [np.asarray(s, np.int64) for s in sets]
            seg = [np.full(len(s), i, np.int64) for i, s in enumerate(ids)]
            cat = np.concatenate(ids) if ids else np.zeros(0, np.int64)
            segs = np.concatenate(seg) if seg else np.zeros(0, np.int64)
            return cat, segs

        self._f4_np = csr(
            np.unique(idx.nf4[a0:a1, 1]) for a0, a1, _w in kept4
        )
        self._f6_np = csr(
            np.unique(idx.chain_pairs[a0:a1, 1] // lc)
            for a0, a1, _w in (kept6 if self._chunks6 else ())
        )
        self._f4_csr = tuple(i64(a) for a in self._f4_np)
        self._f6_csr = tuple(i64(a) for a in self._f6_np)
        n_rt = self._tiles6.n_rt if self._tiles6 is not None else 0
        self._flag_sizes = (
            self.n_lchunks, len(self._chunks4), len(self._chunks6), n_rt,
        )

        # live-column word mask: bits for x < n_concepts only
        wmask = np.zeros(self.wc, np.uint32)
        full, rem = divmod(idx.n_concepts, 32)
        wmask[:full] = 0xFFFFFFFF
        if rem:
            wmask[full] = (1 << rem) - 1
        self._wmask_np = wmask
        self._wmask = torch.as_tensor(
            wmask[self.word_base : self.word_base + self.wl].view(np.int32)
        ).to(dev)
        self._m4_np, self._m6_np = m4, m6
        self._build_sparse_tables(m4, m6, kept4, kept6)
        #: per-round :class:`FrontierStats` of the last observed run
        self.frontier_rounds: list = []
        #: per-rule wall seconds accumulated by :meth:`saturate` when
        #: ``profile=True`` (synchronised timings, for breakdowns only)
        self.rule_seconds: dict = {}
        #: per-round gating counts of the last :meth:`saturate`:
        #: ``{"cr4": [run, skipped], "cr6": [...], "cr6_tiles": [...],
        #: "cr5": ran}`` (windows, or link tiles for the live-tile CR6)
        self.gate_rounds: list = []
        #: blocking reads of the card by the host since the last observed
        #: run began: ``flags`` (a step's or a sparse round's frontier, a
        #: fused window's report) and ``bits`` (live-bit totals)
        self.host_reads = {"flags": 0, "bits": 0}
        #: windows of the last fused run (see :meth:`_saturate_fused`)
        self.fused_run_stats = {"windows": [], "fallouts": 0, "dropped": 0}
        self._bottom_idx = torch.full(
            (1,), BOTTOM_ID, dtype=torch.int64, device=dev
        )
        # the fused window's card tables, its captured windows (LRU) and
        # the state pair a card's windows run on (see _saturate_fused)
        self._fused_tab_cache = None
        self._fused_windows: "OrderedDict" = OrderedDict()
        self._fused_state = None
        # ---- the bucketed program (core/bucketing.py): quantized CR1-CR3
        # plans (pads gather the dead row itself), then the structure
        # and argument tables of the step, and its signature
        self._qplans = {}
        self._btables = None
        #: the bucketed windows this engine used, by (K, caps) (weak:
        #: the registry owns them), and the digest that keys them
        self._bucket_windows: dict = {}
        self._digest = None
        if self._bucket:
            for key, tab, col, pad in (
                ("1", nf1, 1, self._dead_c), ("2", nf2, 2, self._dead_c),
                ("3", nf3, 1, self._dead_l),
            ):
                self._qplans[key] = SegmentedRowOr.quantized(
                    tab[:, col], self._qn, pad, len(tab)
                )
            from distel_tpu_torch.core import bucketing

            self._bstruct, self._btables = bucketing.bucket_plan(self)
            self.bucket_signature = bucketing.signature(
                self._bstruct, self._btables
            )
        else:
            self._bstruct = None
            self.bucket_signature = signature_of(
                (self.plan_stats(), self.device.type),
                f"exact{self.nc}x{self.nl}",
            )
        self._stats_lock = threading.Lock()
        #: program-build cost accumulated by this engine (the reference's
        #: record; exact engines build no program and keep zeros)
        self.compile_stats = CompileStats(
            bucket_signature=self.bucket_signature, program="total"
        )
        self.last_compile: Optional[CompileStats] = None

    def _plan(self, m, l) -> PackedColsMatmulPlan:
        """The product plan of an [m, l] operand against the state's
        words, one per shape (a method, not a closure over ``self``: a
        reference cycle would keep the engine's tables on the card past
        the last reference until a garbage collection)."""
        key = (m, l)
        if key not in self._plans:
            self._plans[key] = PackedColsMatmulPlan(
                m, l, self.wl, temp_budget_bytes=self.temp_budget_bytes
            )
        return self._plans[key]

    def _live_windows(self, role_list, lcn, h):
        """Static live windows ``[(off, end, c0, c1)]`` covering the
        links (inside the link window, if any) whose role is a
        (transitive) subrole under closure ``h`` of some role in
        ``role_list``; None when no link can satisfy them.  Window edges
        may include off-role links (their factored-mask entries are 0);
        the tail window clamps to the grid end (re-deriving earlier
        links is idempotent under OR) and is cut at nl."""
        croles = np.unique(role_list)
        rel = np.flatnonzero(h[:, croles].any(axis=1))
        live = np.flatnonzero(np.isin(self._link_roles_np, rel))
        if self._link_window is not None:
            w0, w1 = self._link_window
            live = live[(live >= w0) & (live < w1)]
        if live.size == 0:
            return None
        lc = self.lc
        wins = []
        i = 0
        while i < live.size:
            off = min(int(live[i]), self._grid_end - lcn)
            wins.append((
                off,
                min(off + lcn, self._nl_plan),
                off // lc,
                min((off + lcn - 1) // lc, self.n_lchunks - 1),
            ))
            i = int(np.searchsorted(live, off + lcn))
        return wins

    def _tile_tables(self, t, m6: np.ndarray, mm=None) -> dict:
        """The live-tile CR6 schedule ``t`` as device tables, over the
        factored mask table ``m6``."""
        dev, lc = self.device, self.lc

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        n_tiles = [-(-len(lv) // t.tile_l) for lv in t.live_per_span]
        # per (row tile, link tile): the L-chunks its valid slots read,
        # for the host's launch decision
        tile_lchunks = [
            [np.unique(t.tids[rt, k][t.tval[rt, k]] // lc)
             for k in range(n_tiles[rt])]
            for rt in range(t.n_rt)
        ]
        return {
            "rows": i64(t.rows),
            # the factored mask rows, one all-zero row for pad slots
            "mask": torch.as_tensor(
                np.concatenate([m6, np.zeros((1, m6.shape[1]), np.int8)])
            ).to(dev),
            "mrow_ids": i64(t.mrow_ids),
            "tids": i64(t.tids),
            "tval": torch.as_tensor(t.tval).to(dev),
            "tchunk": i64(t.tids // lc),
            "fdx": i64(t.fdx),
            "n_tiles": n_tiles,
            "lchunks": tile_lchunks,
            "groups": [
                (rt0, rt1, p, i64(order)) for rt0, rt1, p, order, _tg in t.groups
            ],
            "mm": mm or make_tile_matmul(t.tile_m, t.tile_l, self.wc),
        }

    def step_cost_model(self) -> dict:
        """Analytic per-superstep cost from the static plan shapes, for
        roofline reporting (the reference's, ``distel_tpu/core/
        rowpacked_engine.py`` ``step_cost_model``, over this engine's
        plan):

        * ``hbm_bytes`` — packed-state card traffic of one ungated
          superstep: per rule, source-row gathers + target-row
          read-modify-writes (CR1-CR3), each chunk's live R windows +
          bit-table source gather + target RMW (CR4/CR6; live-tile CR6:
          its link-tile rows, source gathers and write groups), and the
          CR5 OR-reduce sweep.  Gating only reduces this, so the figure
          is an upper bound per step.
        * ``mm_dense_equiv_macs`` — the CR4/CR6 contraction size as a
          DENSE product ([Σrk, nl] @ [nl, nc]).
        * ``mm_live_macs`` — the part the plan schedules: live windows
          (live-tile CR6: occupied tile slots) only.

        In exact layout the plan is the reference's window plan, and
        the figures are its.  A bucketed engine's step runs the plan
        padded to its rungs (``core/bucketing.BucketStruct``): every
        chunk launches every window slot of ``length`` links over
        ``rows`` rows, so its figures charge that padded plane, as the
        reference charges its scanned formulation's padded slots."""
        w4 = 4 * self.wc  # bytes per packed row
        rw = 0
        for p in (self._p1, self._p3):
            rw += p.k * w4                               # gathered sources
            rw += 2 * p.n_targets * w4                   # target RMW
        rw += 2 * self._p2.k * w4
        rw += 2 * self._p2.n_targets * w4
        if -(-self.wl // self._bw) > 1:
            # block slice + write-back traffic of the word sweep
            rw += 2 * (self.nc + self.nl) * w4
        macs = 0
        live_macs = 0
        bstruct = self._bstruct if self._bucket else None
        for key, chunks, lcn in (("4", self._chunks4, self.lc4),
                                 ("6", self._chunks6, self.lc)):
            rs = getattr(bstruct, "cr" + key) if bstruct is not None else None
            if rs is not None:
                # the padded plane: chunks × slots windows of `length`
                # links over `rows` rows, every slot launched
                rw += rs.chunks * rs.slots * rs.length * w4
                rw += rs.chunks * rs.rows * w4
                rw += 2 * rs.chunks * rs.rows * w4
                macs += rs.chunks * rs.rows * self.nl * self.nc
                live_macs += rs.chunks * rs.slots * rs.rows * rs.length * self.nc
                continue
            for chunk in chunks:
                n_t = len(chunk.windows)
                rk = int(chunk.src.shape[0])
                rw += n_t * lcn * w4                     # live R windows
                rw += rk * w4                            # subt gather
                rw += 2 * chunk.piece.n_targets * w4     # target RMW
                macs += rk * self.nl * self.nc
                live_macs += rk * n_t * lcn * self.nc
        t6 = self._tiles6
        if t6 is not None:
            # live-tile CR6: the contraction touches the packed live-link
            # tiles only — gathered rows, subt gathers, and the tile
            # write plans' RMW + re-gather traffic
            rw += t6.n_rt * t6.nt * t6.tile_l * w4       # link-tile rows
            rw += t6.n_rt * t6.tile_m * w4               # subt gathers
            for _rt0, _rt1, plan, _o, _t in t6.groups:
                rw += 2 * plan.n_targets * w4
                rw += 2 * plan.k * w4
            macs += len(self.idx.chain_pairs) * self.nl * self.nc
            live_macs += t6.stats["occupied_slots"] * t6.tile_m * self.nc
        if self._bottom:
            rw += (self.nl + 2) * w4
        return {
            "hbm_bytes": rw,
            "mm_dense_equiv_macs": macs,
            # the statically-scheduled portion actually contracted (live
            # role windows only) — what the card really has to beat
            "mm_live_macs": live_macs,
        }

    def plan_stats(self) -> dict:
        """Static plan sizes: state layout, rule table sizes, and the
        CR4/CR6 contraction structure (chunks, windows, tiles)."""
        t6 = self._t6["n_tiles"] if self._t6 is not None else []
        return {
            "nc": self.nc,
            "nl": self.nl,
            "wc": self.wc,
            "n_shards": self.n_shards,
            "lc": self.lc,
            "lc4": self.lc4,
            "n_lchunks": self.n_lchunks,
            "word_block": self._bw,
            "seg_or_rows": [self._p1.k, self._p2.k, self._p3.k],
            "cr4_chunks": len(self._chunks4),
            "cr4_windows": sum(len(c.windows) for c in self._chunks4),
            "cr6_chunks": len(self._chunks6),
            "cr6_windows": sum(len(c.windows) for c in self._chunks6),
            "cr6_row_tiles": len(t6),
            "cr6_link_tiles": sum(t6),
            "cr6_tiles": self.cr6_tiles_stats.get("active", False),
            "cr5_gate": self._gate_cr5,
            "temp_budget_bytes": self.temp_budget_bytes,
        }

    def gate_totals(self) -> dict:
        """:attr:`gate_rounds` summed over the rounds of the last run."""
        out = {"cr4": [0, 0], "cr6": [0, 0], "cr6_tiles": [0, 0], "cr5": [0, 0]}
        for rnd in self.gate_rounds:
            for k in ("cr4", "cr6", "cr6_tiles"):
                out[k][0] += rnd[k][0]
                out[k][1] += rnd[k][1]
            if rnd["cr5"] is not None:
                out["cr5"][0 if rnd["cr5"] else 1] += 1
        return {k: {"contracted": v[0], "skipped": v[1]} for k, v in out.items()}

    @classmethod
    def _normalize_cr6_tiles_cfg(cls, raw) -> Optional[dict]:
        if raw is None:
            return None
        unknown = set(raw) - set(TILE_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown cr6_tiles keys: {sorted(unknown)}")
        cfg = {**TILE_DEFAULTS, **raw}
        if not cfg["enable"]:
            return None
        if cfg["tile_m"] < 1 or cfg["tile_l"] < 1:
            raise ValueError(f"cr6_tiles tile sizes must be >= 1: {cfg}")
        return cfg

    # ------------------------------------------- observed-loop configs

    _SPARSE_DEFAULTS = {
        "enable": True,
        "density_threshold": 0.05,
        "capacity_buckets": 8,
        "hysteresis_rounds": 2,
        "capacity_floor": 64,
    }

    @classmethod
    def _normalize_sparse_cfg(cls, raw) -> Optional[dict]:
        if not raw:
            return None
        cfg = dict(cls._SPARSE_DEFAULTS)
        if raw is not True:
            unknown = set(raw) - set(cfg)
            if unknown:
                raise ValueError(
                    f"unknown sparse_tail keys: {sorted(unknown)}"
                )
            cfg.update(raw)
        if not cfg["enable"]:
            return None
        # reject degenerate values at load, not rounds deep into a run:
        # capacity_buckets < 1 would shift by a negative count in
        # _sparse_rung, capacity_floor < 1 breaks the rung ladder, and
        # hysteresis < 1 silently means "always eligible"
        if int(cfg["capacity_buckets"]) < 1 or int(cfg["capacity_floor"]) < 1:
            raise ValueError(
                "sparse_tail capacity_buckets and capacity_floor must "
                f"be >= 1 (got {cfg['capacity_buckets']!r}, "
                f"{cfg['capacity_floor']!r})"
            )
        if int(cfg["hysteresis_rounds"]) < 1:
            raise ValueError(
                "sparse_tail hysteresis_rounds must be >= 1 "
                f"(got {cfg['hysteresis_rounds']!r})"
            )
        return cfg

    _PIPELINE_DEFAULTS = {"enable": True, "depth": 2}

    @classmethod
    def _normalize_pipeline_cfg(cls, raw) -> dict:
        """Resolved pipelined-observation config.  Unlike
        ``sparse_tail`` (where None means off), None means the
        DEFAULTS — pipelining replays the synchronous loop's rounds
        with only the host fetch deferred, so it is safe on by
        default.  ``False`` / ``{"enable": False}`` / depth 1 restore
        the strictly synchronous loop."""
        cfg = dict(cls._PIPELINE_DEFAULTS)
        if raw is None or raw is True:
            return cfg
        if raw is False:
            cfg["enable"] = False
            return cfg
        unknown = set(raw) - set(cfg)
        if unknown:
            raise ValueError(f"unknown pipeline keys: {sorted(unknown)}")
        cfg.update(raw)
        if int(cfg["depth"]) < 1:
            raise ValueError(
                f"pipeline depth must be >= 1 (got {cfg['depth']!r})"
            )
        cfg["depth"] = int(cfg["depth"])
        cfg["enable"] = bool(cfg["enable"])
        return cfg

    _FUSED_DEFAULTS = {"enable": True, "rounds": 1, "adaptive": False}

    @classmethod
    def _normalize_fused_cfg(cls, raw) -> Optional[dict]:
        """The resolved fused-rounds config, the reference's: ``rounds``
        (K) rounds of the adaptive controller a dispatch, the host
        reading the card at window edges only.  None/True = the
        defaults (K = 1: the per-round controllers run); None when
        disabled."""
        if raw is None or raw is True:
            return dict(cls._FUSED_DEFAULTS)
        if raw is False:
            return None
        cfg = dict(cls._FUSED_DEFAULTS)
        unknown = set(raw) - set(cfg)
        if unknown:
            raise ValueError(f"unknown fused_rounds keys: {sorted(unknown)}")
        cfg.update(raw)
        if not cfg["enable"]:
            return None
        if int(cfg["rounds"]) < 1:
            raise ValueError(
                f"fused_rounds rounds must be >= 1 (got {cfg['rounds']!r})"
            )
        cfg["rounds"] = int(cfg["rounds"])
        cfg["adaptive"] = bool(cfg["adaptive"])
        return cfg

    # ------------------------------------------- the sparse tier's tables

    def _build_sparse_tables(self, m4, m6, kept4, kept6) -> None:
        """Host copies the sparse tier's per-round selection reads: the
        factored masks as bool, which roles each L-chunk carries (dirty
        chunks -> dirty roles -> rows whose masks cover one), each
        table's row activity with every L-chunk dirty, and per CR4/CR6
        table its rows' chunks, the chunks' live windows and its write
        groups (:meth:`_sparse_rule`).  :meth:`rebind_role_closure`
        refreshes the closure-dependent ones."""
        idx = self.idx
        self._m4_full = m4.astype(bool)
        self._m6_full = m6.astype(bool)
        self._chunk_roles_np = np.zeros(
            (self.n_lchunks, m4.shape[1]), bool
        )
        self._chunk_roles_np[
            np.arange(self._nl_plan) // self.lc,
            self._link_roles_np[: self._nl_plan]
        ] = True
        self._max_dirty_roles = self._chunk_roles_np.any(axis=0)
        self._m4_any = (self._m4_full & self._max_dirty_roles).any(axis=1)
        self._m6_any = (self._m6_full & self._max_dirty_roles).any(axis=1)
        #: density denominator of the controller: the rule-table rows a
        #: fully dirty round re-evaluates
        self._sp_total_rows = (
            len(self._sp_nf1) + len(self._sp_nf2) + len(self._sp_nf3)
            + (len(idx.nf4) if self._has4 else 0)
            + (len(idx.chain_pairs) if self._has6 else 0)
            + (1 if self._bottom else 0)
        )
        self._a4 = idx.nf4[:, 1] if self._has4 else None
        self._l26 = idx.chain_pairs[:, 1] if self._has6 else None
        self._sp4 = self._sparse_rule(idx.nf4, kept4, None) if self._has4 else None
        groups6 = None
        if self._tiles6 is not None:
            # the live-tile CR6 writes per tile group: the sparse tier
            # keeps the dense step's write groups
            groups6 = [self._tiles6.spans[g[0]][0] for g in self._tiles6.groups]
        self._sp6 = (
            self._sparse_rule(idx.chain_pairs, kept6, groups6)
            if self._has6 else None
        )

    @staticmethod
    def _sparse_rule(tab, kept, group_starts) -> Optional[dict]:
        """One CR4/CR6 table's sparse structure: ``chunk_of`` [rows]
        (the row chunk of each table row, -1 for a span dropped at
        build), each chunk's live windows, and the write groups as
        their first table rows (None = one group a chunk, the window
        formulation's order).  None when every span was dropped."""
        if not kept:
            return None
        chunk_of = np.full(len(tab), -1, np.int64)
        for i, (a0, a1, _w) in enumerate(kept):
            chunk_of[a0:a1] = i
        if group_starts is None:
            group_starts = [a0 for a0, _a1, _w in kept]
        return {
            "tab": tab,
            "chunk_of": chunk_of,
            "windows": [list(w) for _a0, _a1, w in kept],
            "group_starts": np.asarray(group_starts, np.int64),
        }

    def _sparse_supported(self) -> bool:
        """The tier runs on every plan of the port (see the module
        docstring: the reference's restriction to its scanned
        formulation comes from its slabs, which its default
        bucketed config always builds)."""
        return True

    @staticmethod
    def _sparse_rung(cfg: dict, n: int, floor: int) -> Optional[int]:
        """Smallest workspace rung >= ``n`` on the power-of-two family
        of the program-cache ladder (:func:`bucket_dim`, ratio 2), or
        None when ``n`` overflows the largest of the
        ``capacity_buckets`` configured rungs — the caller then runs the
        dense step for the round."""
        rung = bucket_dim(max(int(n), 1), 2.0, floor=floor)
        if rung > floor << (int(cfg["capacity_buckets"]) - 1):
            return None
        return rung

    # ------------------------------------------------------------- state

    def _to_state(self, sp: np.ndarray, rp: np.ndarray):
        return (
            torch.from_numpy(np.ascontiguousarray(sp).view(np.int32)).to(self.device),
            torch.from_numpy(np.ascontiguousarray(rp).view(np.int32)).to(self.device),
        )

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """S(X) = {X, ⊤}, R empty: the diagonal plus a full ⊤ row —
        padded x columns evolve inertly and are masked from counts.
        Built on the engine's device (:meth:`_fill_initial`)."""
        dev = self.device
        sp = torch.empty((self.nc, self.wl), dtype=torch.int32, device=dev)
        rp = torch.empty((self.nl, self.wl), dtype=torch.int32, device=dev)
        self._fill_initial(sp, rp)
        return sp, rp

    def initial_frontier(self) -> Frontier:
        """Everything dirty: every rule runs on the first step (and on
        the first step of a resume)."""
        n_l, n4, n6, n_rt = self._flag_sizes
        dl = torch.ones(n_l + 1, dtype=torch.bool, device=self.device)
        dl[n_l] = False
        return Frontier(
            True, np.ones(n_l, bool), np.ones(n4, bool), np.ones(n6, bool),
            np.ones(n_rt, bool), True, dl,
        )

    def embed_state(self, s_old, r_old, *, allow_shrink: bool = False):
        """Embed a previous closure into this engine's (possibly larger)
        arrays — the resume path.  Accepts the *packed transposed* wire
        form (uint32 numpy or int32 tensors, e.g. a snapshot's
        ``s_wire``/``r_wire`` or a result's ``packed_s``/``packed_r``)
        or *unpacked x-major* bool arrays.  Rows and words past this
        engine's arrays must be empty padding unless ``allow_shrink``.
        On a mesh the closure is the whole one, and each rank takes its
        word window.
        Packed-row reuse is sound because concept ids are append-only.
        Int32 tensors on this engine's device embed on the device (the
        incremental plane's path: the closure never visits the host);
        the result is always a fresh pair, never the caller's tensors."""
        if (
            isinstance(s_old, torch.Tensor)
            and self._on_device(s_old)
            and s_old.dtype == torch.int32
        ):
            return self._embed_device(s_old, r_old, allow_shrink)
        if isinstance(s_old, torch.Tensor):
            s_old = s_old.detach().cpu().numpy().view(np.uint32)
            r_old = r_old.detach().cpu().numpy().view(np.uint32)
        s_old, r_old = np.asarray(s_old), np.asarray(r_old)
        if s_old.dtype != np.uint32:
            s_old, r_old = self._pack_x_major(s_old, r_old)
        if not allow_shrink:
            for name, old, (nr, nw) in (
                ("S", s_old, (self.nc, self.wc)),
                ("R", r_old, (self.nl, self.wc)),
            ):
                if old[nr:].any() or old[:, nw:].any():
                    raise ValueError(
                        f"embed_state: old {name} state {old.shape} holds "
                        f"bits past this engine's [{nr}, {nw}] arrays; "
                        "realign the snapshot by name "
                        "(load_snapshot_state(path, idx=engine.idx)) or "
                        "pass allow_shrink=True to clip deliberately"
                    )
        return self._embed_device(*self._to_state(s_old, r_old),
                                  allow_shrink=True)

    def _embed_initial(self, initial):
        """The state a run starts from: :class:`RankWindows` taken as this
        rank's windows, anything else through :meth:`embed_state`."""
        if isinstance(initial, RankWindows):
            if self.n_shards == 1 or tuple(initial.sp.shape[1:]) != (self.wl,):
                raise ValueError(
                    f"RankWindows of width {tuple(initial.sp.shape)} given to "
                    f"an engine whose rank holds {self.wl} of {self.wc} words"
                )
            return self._embed_device(initial.sp, initial.rp, True,
                                      windowed=True)
        return self.embed_state(*initial)

    def _on_device(self, t: torch.Tensor) -> bool:
        """Whether ``t`` lies on this engine's device (an engine built
        for ``"cuda"`` runs on the current card, and its tensors report
        that card's index)."""
        dev = t.device
        if dev.type != self.device.type:
            return False
        want = self.device.index
        if want is None and dev.type == "cuda":
            want = torch.cuda.current_device()
        return want is None or dev.index in (want, None)

    def _embed_device(self, s_old, r_old, allow_shrink: bool,
                      windowed: bool = False):
        """:meth:`embed_state` for device tensors: the S(X)={X,⊤} init
        built on the device, the old words ORed (S) or copied (R) in.
        Bits past this engine's arrays are checked only when the old
        arrays are larger (one scalar read).  ``windowed``: the old
        arrays are already this rank's word window."""
        if not allow_shrink:
            for name, old, (nr, nw) in (
                ("S", s_old, (self.nc, self.wc)),
                ("R", r_old, (self.nl, self.wc)),
            ):
                if old.shape[0] > nr or old.shape[1] > nw:
                    if bool(old[nr:].any()) or bool(old[:, nw:].any()):
                        raise ValueError(
                            f"embed_state: old {name} state {tuple(old.shape)} "
                            f"holds bits past this engine's [{nr}, {nw}] arrays"
                        )
        sp, rp = self.initial_state()
        if not windowed:
            w0 = self.word_base
            s_old = s_old[:, w0 : w0 + self.wl]
            r_old = r_old[:, w0 : w0 + self.wl]
        na, nw = min(s_old.shape[0], self.nc), s_old.shape[1]
        sp[:na, :nw] |= s_old[:na, :nw]
        nlr, nwr = min(r_old.shape[0], self.nl), r_old.shape[1]
        rp[:nlr, :nwr] = r_old[:nlr, :nwr]
        return sp, rp

    def _fill_initial(self, sp, rp) -> None:
        """:meth:`initial_state` written into ``sp`` / ``rp`` in place on
        their device: the diagonal and a full ⊤ row, R empty (on a
        mesh, the rank's word window of them)."""
        dev = sp.device
        x0 = 32 * self.word_base
        rows = torch.arange(x0, x0 + 32 * self.wl, device=dev)
        bit = torch.from_numpy(
            (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
        ).to(dev)
        sp.zero_()
        sp[rows, (rows >> 5) - self.word_base] = bit[rows & 31]
        sp[TOP_ID] = -1
        rp.zero_()

    @staticmethod
    def _pack_x_major(s: np.ndarray, r: np.ndarray):
        """x-major bool [x, a] / [x, l] → transposed uint32 wire rows."""
        def pack_rows(m: np.ndarray) -> np.ndarray:
            pad = (-m.shape[1]) % 32
            if pad:
                m = np.pad(m, ((0, 0), (0, pad)))
            b = np.packbits(np.asarray(m, bool), axis=1, bitorder="little")
            return np.ascontiguousarray(b).view(np.uint32)

        return pack_rows(s.T), pack_rows(r.T)

    # ------------------------------------------------------------- rules

    def _timed(self, name, fn, *args):
        """``fn(*args)`` under the profiler scope of ``name`` (the fold
        and its read are the reference's ``frontier``); with
        ``profile=True`` also its synchronised wall in
        :attr:`rule_seconds`."""
        with rule_scope("frontier" if name == "read" else name):
            if not self._profile:
                return fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            out = fn(*args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.rule_seconds[name] = (
            self.rule_seconds.get(name, 0.0) + time.perf_counter() - t0
        )
        return out

    def _row_rules(self, sp, rp, s_cvs, r_cvs):
        """CR1, CR2, CR3 swept over word blocks of the state; each
        rule's change vector is the OR over its blocks."""
        cv = [None, None, None]
        for off in range(0, self.wl, self._bw):
            blk = slice(off, min(off + self._bw, self.wl))
            if self._p1.k:  # CR1: a ⊑ b
                with rule_scope("cr1"):
                    red = self._p1.reduce(sp[self._src1, blk])
                    c = self._p1.write(sp, red, blk, track="rows")
                cv[0] = c if cv[0] is None else cv[0] | c
            if self._p2.k:  # CR2: a1 ⊓ a2 ⊑ b
                with rule_scope("cr2"):
                    red = self._p2.reduce(sp[self._src2a, blk] & sp[self._src2b, blk])
                    c = self._p2.write(sp, red, blk, track="rows")
                cv[1] = c if cv[1] is None else cv[1] | c
            if self._p3.k:  # CR3: a ⊑ ∃link — reads S, writes R
                with rule_scope("cr3"):
                    red = self._p3.reduce(sp[self._src3, blk])
                    c = self._p3.write(rp, red, blk, track="rows")
                cv[2] = c if cv[2] is None else cv[2] | c
        for plan, c, out in (
            (self._p1, cv[0], s_cvs), (self._p2, cv[1], s_cvs),
            (self._p3, cv[2], r_cvs),
        ):
            if c is not None:
                out.append((plan.device_targets(sp.device), c))

    def _contract_chunk(self, bits_state, rp, chunk, live):
        """One CR4/CR6 row chunk: its packed [rk, wc] AND-OR product,
        OR-accumulated over its live windows (a window of R_T rows is a
        contiguous slice — no copy): the first live window writes the
        accumulator, every later one ORs into it in place.  None when
        no window is live (nothing launches)."""
        rk = chunk.src.shape[0]
        subt = None
        acc = None
        for (off, end, _c0, _c1), run in zip(chunk.windows, live):
            if not run:
                continue
            if subt is None:
                subt = bits_state[chunk.src].T.contiguous()   # [wl, rk]
            f = self._bit_table(subt, self._fillers[off:end])   # [l, rk]
            w = chunk.mask[:, self._link_roles[off:end]] * f.T
            acc = self._plan(rk, end - off)(w.contiguous(), rp[off:end], out=acc)
        return acc

    def _bit_table(self, subt, cols) -> torch.Tensor:
        """``bit_lookup_from(subt, cols)`` as int8 0/1 [len(cols), R]; on
        a mesh each rank looks up its word window and the partials are
        exchanged (each bit lives on one rank: their OR is the table)."""
        with rule_scope("bit_table"):
            return por_bits(bit_lookup_from(subt, cols, word_offset=self._wbase,
                                            dtype=torch.int8), self.mesh)

    def _window_live(self, chunk, f, fr):
        dl = fr.dirty_l
        return [bool(f or dl[c0] or dl[c1]) for _o, _e, c0, c1 in chunk.windows]

    def _contract_rule(self, chunks, flags, bits_state, rp, target, fr, cvs,
                       counts):
        for chunk, f in zip(chunks, flags):
            live = self._window_live(chunk, f, fr)
            n_run = sum(live)
            counts[0] += n_run
            counts[1] += len(live) - n_run
            out = self._contract_chunk(bits_state, rp, chunk, live)
            if out is None:
                continue
            piece = chunk.piece
            cv = piece.write(target, piece.reduce(out[chunk.order]), track="rows")
            cvs.append((piece.device_targets(target.device), cv))

    def _cr4(self, sp, rp, fr, s_cvs, counts):
        self._contract_rule(self._chunks4, fr.f4, sp, rp, sp, fr, s_cvs, counts)

    def _cr6_windows(self, rp, fr, r_cvs, counts):
        self._contract_rule(self._chunks6, fr.f6, rp, rp, rp, fr, r_cvs, counts)

    def _cr6_tiles(self, rp, fr, r_cvs, counts):
        """Live-tile CR6: role-run row tiles contract only their densely
        packed live links — the [tile_m, tile_l] operand is (factored
        mask ∧ bit table ∧ slot liveness) against the gathered R rows.
        A slot is live when its link's L-chunk or an L-chunk of its row
        tile's source rows changed; a link tile with no live slot, and a
        row tile with no live link tile, launch nothing."""
        t6 = self._t6
        mm = t6["mm"]
        dl = fr.dirty_l
        for rt0, rt1, plan, order in t6["groups"]:
            outs, any_live = [], False
            for rt in range(rt0, rt1):
                fd = bool(fr.fd6[rt])
                tiles = [
                    k for k in range(t6["n_tiles"][rt])
                    if fd or dl[t6["lchunks"][rt][k]].any()
                ]
                counts[0] += len(tiles)
                counts[1] += t6["n_tiles"][rt] - len(tiles)
                acc = torch.zeros(
                    (mm.m, self.wc), dtype=torch.int32, device=rp.device
                )
                if tiles:
                    any_live = True
                    subt = rp[t6["rows"][rt]].T.contiguous()   # [wc, tile_m]
                for k in tiles:
                    ids = t6["tids"][rt, k]
                    live = t6["tval"][rt, k]
                    if not fd:
                        live = live & fr.dirty_l_dev[t6["tchunk"][rt, k]]
                    f = bit_lookup_from(
                        subt, self._fillers[ids], dtype=torch.int8
                    )                                      # [tile_l, tile_m]
                    w = (
                        t6["mask"][
                            t6["mrow_ids"][rt][:, None],
                            self._link_roles[ids][None, :],
                        ]
                        * f.T
                        * live.to(torch.int8)[None, :]
                    )
                    mm(w.contiguous(), rp[ids], out=acc)
                outs.append(acc)
            if not any_live:
                continue
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            cv = plan.write(rp, plan.reduce(out[order]), track="rows")
            r_cvs.append((plan.device_targets(rp.device), cv))

    def _cr5_reduce(self, sp, rp) -> torch.Tensor:
        return cr5_reduce(sp, rp, self._fillers, self._bottom_idx,
                          self.temp_budget_bytes, self.mesh, self._wbase)

    def _cr5(self, sp, rp, s_cvs):
        """⊥ back-propagation: OR of the R rows whose filler is
        unsatisfiable, into the ⊥ row."""
        red = self._cr5_reduce(sp, rp)
        old = sp[BOTTOM_ID].clone()
        sp[BOTTOM_ID] |= red
        s_cvs.append((
            torch.full((1,), BOTTOM_ID, dtype=torch.int64, device=sp.device),
            (sp[BOTTOM_ID] != old).any()[None],
        ))

    def _fold_masks(self, s_cvs, r_cvs):
        """The changed-S row mask [nc] and the dirty L-chunks [n_lchunks]
        of a step's change vectors, on the device: one indexed OR a
        state matrix (targets are unique within a writer, and the order
        of writers does not matter for an OR)."""
        dev = self.device

        def mask(cvs, n):
            m = torch.zeros(n, dtype=torch.int32, device=dev)
            if cvs:
                t = torch.cat([t for t, _ in cvs])
                v = torch.cat([c for _, c in cvs]).to(torch.int32)
                m.index_add_(0, t, v)
            return m > 0

        mask_s = mask(s_cvs, self.nc)
        dirty_l = mask(r_cvs, self._grid_end).view(self.n_lchunks, self.lc).any(dim=1)
        if self.n_shards > 1:
            # one exchange a step: every rank takes the same gates
            both = por_(torch.cat([mask_s, dirty_l]), self.mesh)
            mask_s, dirty_l = both[: self.nc], both[self.nc :]
        return mask_s, dirty_l

    def _chunk_flags(self, mask_s, dirty_l):
        """What a step's gates read of a frontier ``(mask_s, dirty_l)``,
        on the device: per CR4 chunk whether a source S row changed, per
        CR6 chunk (and live-tile row tile) whether an L-chunk of a
        source row did, ``dirty_l`` with a trailing always-False slot."""
        dev = self.device

        def per_chunk(src, csr, n):
            ids, seg = csr
            out = torch.zeros(n, dtype=torch.int32, device=dev)
            if ids.numel():
                out.index_add_(0, seg, src[ids].to(torch.int32))
            return out > 0

        _n_l, n4, n6, n_rt = self._flag_sizes
        dl_ext = torch.cat([dirty_l, dirty_l.new_zeros(1)])
        fd6 = (
            dl_ext[self._t6["fdx"]].any(dim=1) if n_rt
            else dirty_l.new_zeros(0)
        )
        return (
            per_chunk(mask_s, self._f4_csr, n4),
            per_chunk(dirty_l, self._f6_csr, n6), fd6, dl_ext,
        )

    def _fold(self, s_cvs, r_cvs, carry: bool = False) -> Frontier:
        """The next step's frontier from this step's change vectors
        (:meth:`_fold_masks`, :meth:`_chunk_flags`) and one copy of every
        flag to the host — with ``carry``, of the changed-S row mask too
        (the observed controller's host frontier)."""
        n_l, n4, n6, n_rt = self._flag_sizes
        mask_s, dirty_l = self._fold_masks(s_cvs, r_cvs)
        any_r = dirty_l.any()
        f4, f6, fd6, dl_ext = self._chunk_flags(mask_s, dirty_l)
        parts = [(mask_s.any() | any_r)[None], dirty_l, f4, f6]
        if n_rt:
            parts.append(fd6)
        parts.append((any_r | mask_s[BOTTOM_ID])[None])
        if carry:
            parts.append(mask_s)
        flags = torch.cat(parts).cpu().numpy()
        self.host_reads["flags"] += 1
        o = np.cumsum([1, n_l, n4, n6, n_rt, 1])
        return Frontier(
            bool(flags[0]), flags[o[0]:o[1]], flags[o[1]:o[2]],
            flags[o[2]:o[3]], flags[o[3]:o[4]], bool(flags[o[4]]), dl_ext,
            flags[o[5]:] if carry else None,
        )

    def _frontier_from_host(self, s_chg: np.ndarray,
                            dirty_l: np.ndarray) -> Frontier:
        """The inverse of :meth:`_fold`: the frontier a step would read
        after a step whose changed-S rows are ``s_chg`` and whose dirty
        L-chunks are ``dirty_l`` — the controller's entry into a dense
        round after sparse rounds (the counterpart of the reference's
        ``_host_gate_flags``)."""
        def per_chunk(src, csr, n):
            ids, seg = csr
            return np.bincount(seg, weights=src[ids], minlength=n) > 0

        n_l, n4, n6, n_rt = self._flag_sizes
        any_r = bool(dirty_l.any())
        dl_ext = np.r_[dirty_l, False]
        fd6 = (
            dl_ext[self._tiles6.fdx].any(axis=1) if n_rt
            else np.zeros(0, bool)
        )
        return Frontier(
            bool(s_chg.any()) or any_r, np.asarray(dirty_l, bool),
            per_chunk(s_chg, self._f4_np, n4),
            per_chunk(dirty_l, self._f6_np, n6), fd6,
            any_r or bool(s_chg[BOTTOM_ID]),
            torch.as_tensor(dl_ext).to(self.device),
            np.asarray(s_chg, bool),
        )

    def step(self, sp: torch.Tensor, rp: torch.Tensor,
             frontier: Optional[Frontier] = None, carry: bool = False):
        """One superstep, in place: CR1, CR2, CR3, CR4, CR6, CR5, gated
        on ``frontier`` (None = everything dirty, as on a first step).
        Returns ``(sp, rp, frontier_next)``; ``frontier_next.changed``
        says whether any bit changed (``carry``: see :meth:`_fold`)."""
        fr = self.initial_frontier() if frontier is None else frontier
        s_cvs, r_cvs = [], []
        rnd = {"cr4": [0, 0], "cr6": [0, 0], "cr6_tiles": [0, 0], "cr5": None}
        if self._p1.k or self._p2.k or self._p3.k:
            self._timed("cr1-3", self._row_rules, sp, rp, s_cvs, r_cvs)
        if self._chunks4:
            self._timed("cr4", self._cr4, sp, rp, fr, s_cvs, rnd["cr4"])
        if self._t6 is not None:
            self._timed("cr6", self._cr6_tiles, rp, fr, r_cvs, rnd["cr6_tiles"])
        elif self._chunks6:
            self._timed("cr6", self._cr6_windows, rp, fr, r_cvs, rnd["cr6"])
        if self._bottom:
            run = fr.cr5 or not self._gate_cr5
            rnd["cr5"] = run
            if run:
                self._timed("cr5", self._cr5, sp, rp, s_cvs)
        nxt = self._timed("read", self._fold, s_cvs, r_cvs, carry)
        self.gate_rounds.append(rnd)
        return sp, rp, nxt

    _profile = False

    # ------------------------------------------------- the sparse tier

    def _sparse_round_plan(self, cfg, s_chg, dirty_l, any_r):
        """Host-side measure + active-set selection for one round.
        Returns ``(rows_touched, density, measure, overflow)``;
        ``measure`` holds the selected row sets and is None on workspace
        overflow (``overflow`` True) — the round then runs dense, never
        dropping work.

        Selection replicates the dense step's gating, extended with its
        intra-step cascade: CR1 selects on the previous round's
        changed-S mask (dense CR1 reads pre-step S); CR2 also covers
        readers of active CR1 targets (dense CR2 reads S after CR1's
        writes); CR3 covers CR1/CR2 targets likewise.  CR4/CR6 select at
        ROW granularity: a row is active iff its bit-table source row
        changed (CR4: the S row ``a4[j]``; CR6: the L-chunk of R row
        ``l2[p]``) or its factored mask covers a role present in a
        dirty L-chunk — rows outside that set contribute nothing new
        even in the dense step, so per-round derivations stay those of
        a dense-only run.  Rows of chunks dropped at build, or left
        with no live window, are inert and excluded."""
        nf1, nf2, nf3 = self._sp_nf1, self._sp_nf2, self._sp_nf3
        empty = np.zeros(0, np.int64)
        act1 = np.flatnonzero(s_chg[nf1[:, 0]]) if len(nf1) else empty
        s1 = s_chg
        if act1.size:
            s1 = s_chg.copy()
            s1[nf1[act1, 1]] = True
        act2 = (
            np.flatnonzero(s1[nf2[:, 0]] | s1[nf2[:, 1]])
            if len(nf2)
            else empty
        )
        s2 = s1
        if act2.size:
            s2 = s1.copy() if s1 is s_chg else s1
            s2[nf2[act2, 2]] = True
        act3 = np.flatnonzero(s2[nf3[:, 0]]) if len(nf3) else empty

        # dirty chunks -> dirty roles: the role-granular over-
        # approximation of "some link this row's mask covers changed"
        dirty_roles = self._chunk_roles_np[dirty_l].any(axis=0)

        def row_act(d, mask_tab, mask_any, fd_rows):
            if np.array_equal(dirty_roles, self._max_dirty_roles):
                masked = mask_any
            else:
                masked = (mask_tab & dirty_roles).any(axis=1)
            ch = d["chunk_of"]
            has_win = np.asarray([len(w) > 0 for w in d["windows"]], bool)
            ok = (ch >= 0) & has_win[np.clip(ch, 0, None)]
            return np.flatnonzero((fd_rows | masked) & ok)

        act4 = act6 = empty
        fd4 = fd6 = None
        if self._sp4 is not None:
            fd4 = s_chg[self._a4]
            act4 = row_act(self._sp4, self._m4_full, self._m4_any, fd4)
        if self._sp6 is not None:
            fd6 = dirty_l[self._l26 // self.lc]
            act6 = row_act(self._sp6, self._m6_full, self._m6_any, fd6)
        run5 = bool(self._bottom and (any_r or s_chg[BOTTOM_ID]))
        rows_touched = int(
            act1.size + act2.size + act3.size + act4.size + act6.size
            + (1 if run5 else 0)
        )
        density = rows_touched / max(self._sp_total_rows, 1)
        floor = cfg["capacity_floor"]
        c123 = self._sparse_rung(
            cfg, max(act1.size, act2.size, act3.size), floor
        )
        a4 = self._sparse_rung(cfg, act4.size, floor) if act4.size else 0
        a6 = self._sparse_rung(cfg, act6.size, floor) if act6.size else 0
        if c123 is None or a4 is None or a6 is None:
            return rows_touched, density, None, True
        measure = {
            "act1": act1, "act2": act2, "act3": act3,
            "act4": act4, "act6": act6, "fd4": fd4, "fd6": fd6,
            "run5": run5, "key": (c123, a4, a6),
        }
        return rows_touched, density, measure, False

    def _sparse_write(self, state, plan, red, cols, mvec):
        """OR the reduced rows ``red`` into ``state[targets, cols]`` in
        place, mark the rows that gained a bit in ``mvec`` and return
        the count of live-column bits gained (a 0-d tensor on the
        device)."""
        t = plan.device_targets(state.device)
        old = state[t, cols]
        merged = old | red
        state[t, cols] = merged
        gained = merged ^ old
        mvec[t] |= (gained != 0).any(dim=1)
        return popcount_rows(gained, self._wmask[cols]).sum()

    def _sparse_contract(self, d, rows, fd_rows, mask_tab, bits_state,
                         rp, dl, plans):
        """The selected rows ``rows`` (one row chunk of ``d``) against
        that chunk's live windows: ``[k, window] ⊙ R[window]``, ORed
        over the windows, through the packed-columns plans.  A window
        is live for every row when an L-chunk it overlaps is dirty, else
        only for the rows whose source changed (``fd_rows``), the
        reference's per-row liveness.  None when no window is live.  On a
        mesh the products are the rank's word window, and each window's
        bit table is exchanged (:meth:`_bit_table`); the host's skips
        read replicated values, so every rank runs the same exchanges."""
        tab = d["tab"]
        k = len(rows)
        dev = self.device
        subt = acc = live_dev = mask = None
        for off, end, c0, c1 in d["windows"][int(d["chunk_of"][rows[0]])]:
            all_live = bool(dl[c0] or dl[c1])
            if not all_live and not fd_rows.any():
                continue
            if subt is None:
                src = torch.as_tensor(tab[rows, 1]).to(dev)
                subt = bits_state[src].T.contiguous()      # [wl, k]
                mask = torch.as_tensor(
                    mask_tab[rows].view(np.int8)
                ).to(dev)                                  # [k, roles+1]
            f = self._bit_table(subt, self._fillers[off:end])   # [l, k]
            w = mask[:, self._link_roles[off:end]] * f.T
            if not all_live:
                if live_dev is None:
                    live_dev = torch.as_tensor(
                        fd_rows.astype(np.int8)
                    ).to(dev)
                w = w * live_dev[:, None]
            key = (k, end - off)
            if key not in plans:
                plans[key] = PackedColsMatmulPlan(
                    k, end - off, self.wl,
                    temp_budget_bytes=self.temp_budget_bytes,
                )
            acc = plans[key](w.contiguous(), rp[off:end], out=acc)
        return acc

    def _sparse_rule_pass(self, d, act, fd, mask_tab, bits_state, rp,
                          target, mvec, dl):
        """One CR4/CR6 rule over its selected rows ``act`` (ascending
        table rows), in the dense step's write-group order: per group,
        each row chunk's selected rows contract (reading the state the
        earlier groups left), then one seg-OR write of the group.
        Returns the live bits gained (device 0-d) or None."""
        if not act.size:
            return None
        tab = d["tab"]
        gid = np.searchsorted(d["group_starts"], act, side="right") - 1
        cut = np.flatnonzero(np.r_[True, gid[1:] != gid[:-1], True])
        plans: dict = {}
        delta = None
        for g0, g1 in zip(cut[:-1], cut[1:]):
            rows_g = act[g0:g1]
            fd_g = fd[rows_g]
            ch = d["chunk_of"][rows_g]
            ccut = np.flatnonzero(np.r_[True, ch[1:] != ch[:-1], True])
            outs, tgts = [], []
            for c0, c1 in zip(ccut[:-1], ccut[1:]):
                out = self._sparse_contract(
                    d, rows_g[c0:c1], fd_g[c0:c1], mask_tab, bits_state,
                    rp, dl, plans,
                )
                if out is not None:
                    outs.append(out)
                    tgts.append(tab[rows_g[c0:c1], 2])
            if not outs:
                continue
            plan = SegmentedRowOr(np.concatenate(tgts))
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            order = torch.as_tensor(plan.order).to(self.device)
            dd = self._sparse_write(
                target, plan, plan.reduce(out[order]), slice(None), mvec
            )
            delta = dd if delta is None else delta + dd
        return delta

    def _sparse_exec(self, sp, rp, measure, dirty_l):
        """One frontier-compacted superstep, in place — the counterpart
        of the reference's ``_sparse_exec``.  Rule order and read/write
        structure mirror :meth:`step`: CR1 → CR2 → CR3 over the
        compacted rows (word blocks, each rule gathering before its
        writes), CR4 then CR6 over the selected rows in the dense
        step's write-group order, CR5 when its inputs changed
        (``run5``).  Returns ``(changed, delta_bits, mask_s, any_r,
        dirty_l_next)`` on the host, from one read of the round's fold;
        ``delta_bits`` counts new live-column bits, so sparse rounds
        skip the full live-bits sweep.

        On a mesh (the reference's ``_sparse_exec(axis_name=)``) each
        rank runs every rule on its own word window with the selection
        replicated, the bit tables exchanged as in :meth:`step`, and the
        round ends with one fold: the changed-row masks ORed and the
        gained bits summed across the ranks, so the host controller
        reads the same values on every rank."""
        dev = self.device
        mask_s = torch.zeros(self.nc, dtype=torch.bool, device=dev)
        mask_r = torch.zeros(self._grid_end, dtype=torch.bool, device=dev)
        deltas = []

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        row_rules = []
        for tab, act, tgt_col, src_cols, state, mvec in (
            (self._sp_nf1, measure["act1"], 1, (0,), sp, mask_s),
            (self._sp_nf2, measure["act2"], 2, (0, 1), sp, mask_s),
            (self._sp_nf3, measure["act3"], 1, (0,), rp, mask_r),
        ):
            if act.size:
                plan = SegmentedRowOr(tab[act, tgt_col])
                srcs = [i64(tab[act[plan.order], c]) for c in src_cols]
                row_rules.append((plan, srcs, state, mvec))
        if row_rules:
            emission = max(p.k * len(srcs) for p, srcs, _s, _m in row_rules)
            bw = max(min(self.temp_budget_bytes // (4 * emission), self.wl), 1)
            for off in range(0, self.wl, bw):
                blk = slice(off, min(off + bw, self.wl))
                for plan, srcs, state, mvec in row_rules:
                    g = sp[srcs[0], blk]
                    if len(srcs) == 2:
                        g = g & sp[srcs[1], blk]
                    deltas.append(self._sparse_write(
                        state, plan, plan.reduce(g), blk, mvec
                    ))
        dl = dirty_l
        if self._sp4 is not None:
            deltas.append(self._sparse_rule_pass(
                self._sp4, measure["act4"], measure["fd4"], self._m4_full,
                sp, rp, sp, mask_s, dl,
            ))
        if self._sp6 is not None:
            deltas.append(self._sparse_rule_pass(
                self._sp6, measure["act6"], measure["fd6"], self._m6_full,
                rp, rp, rp, mask_r, dl,
            ))
        if self._bottom and measure["run5"]:
            red = self._cr5_reduce(sp, rp)[None]
            one = SegmentedRowOr(np.full(1, BOTTOM_ID))
            deltas.append(self._sparse_write(sp, one, red, slice(None), mask_s))
        deltas = [x for x in deltas if x is not None]
        delta = (
            torch.stack(deltas).sum() if deltas
            else torch.zeros((), dtype=torch.int64, device=dev)
        )
        dirty_next = mask_r.view(self.n_lchunks, self.lc).any(dim=1)
        flags, delta = self._fold_round(mask_s, dirty_next, delta)
        flags = flags.cpu().numpy()
        self.host_reads["flags"] += 1
        s_chg, dl_next = flags[: self.nc], flags[self.nc:]
        any_r = bool(dl_next.any())
        changed = bool(s_chg.any()) or any_r
        return changed, int(delta), s_chg, any_r, dl_next


    def _fold_round(self, mask_s, dirty_l, delta):
        """A sparse round's fold: ``(cat([mask_s, dirty_l]), delta)``, on
        a mesh the masks ORed and the gained bits summed across the
        ranks (one exchange each)."""
        both = torch.cat([mask_s, dirty_l])
        if self.n_shards > 1:
            both = por_(both, self.mesh)
            delta = psum_(delta.reshape(1), self.mesh)[0]
        return both, delta

    def rebind_role_closure(self, new_closure) -> bool:
        """Swap in a grown role closure: the factored masks, each
        chunk's live windows and the live-tile schedule are recomputed
        under ``new_closure``; chunks, write plans and frontier maps
        stay.  The caller re-enters the fixed point from the old state,
        a sound warm start because the closure only grew.

        Returns False, leaving the engine untouched, where the
        reference's unrolled program refuses: the closure is not a
        superset or has another shape, a span dropped at build (no live
        window) comes alive, or a span needs more windows than its
        build-time ones plus ``window_headroom`` — and, with the
        live-tile CR6, where the reference's tile re-fit refuses: a row
        tile needs more link tiles than the schedule has.  The port has
        no compiled program and could always rebind; refusing where the
        reference does keeps the incremental plane's ``path`` and
        ``iterations`` the reference's."""
        import dataclasses

        idx = self.idx
        h_old = np.asarray(idx.role_closure)
        h_new = np.asarray(new_closure, dtype=h_old.dtype)
        if h_new.shape != h_old.shape:
            return False
        ob, nb = h_old.astype(bool), h_new.astype(bool)
        if np.any(ob & ~nb):
            return False
        if np.array_equal(ob, nb):
            return True
        m4, m6 = _factored_closure_tables(
            h_new,
            idx.nf4[:, 0] if self._has4 else None,
            idx.chain_pairs[:, 0] if self._has6 else None,
        )
        windows = {}
        for key, (kept, dropped), tab, lcn in (
            ("cr4", self._slots4, idx.nf4, self.lc4),
            ("cr6", self._slots6, idx.chain_pairs, self.lc),
        ):
            for roles in dropped:
                if self._live_windows(roles, lcn, h_new) is not None:
                    return False        # a dead span came alive
            wins = []
            for a0, a1, n_slots in kept:
                w = self._live_windows(tab[a0:a1, 0], lcn, h_new) or []
                if len(w) > n_slots:
                    return False        # window slots exhausted
                wins.append((a0, a1, w))
            windows[key] = wins
        tiles6 = None
        if self._tiles6 is not None:
            cp = idx.chain_pairs
            t = self._tiles6
            tiles6 = build_cr6_tile_schedule(
                cp[:, 0], cp[:, 1], cp[:, 2], self._link_roles_np, h_old,
                lc=self.lc, n_lchunks=self.n_lchunks,
                tile_m=t.tile_m, tile_l=t.tile_l, group_bounds=[],
                link_window=self._link_window, dead_link=self.nl - 1,
                h_override=h_new, fit_schedule=t,
            )
            if tiles6 is None:
                return False            # link-tile slots exhausted
        # ---- every check passed: swap
        dev = self.device

        def rechunk(chunks, wins, m):
            return [
                c._replace(mask=torch.as_tensor(m[a0:a1]).to(dev), windows=w)
                for c, (a0, a1, w) in zip(chunks, wins)
            ]

        self._chunks4 = rechunk(self._chunks4, windows["cr4"], m4)
        if self._chunks6:
            self._chunks6 = rechunk(self._chunks6, windows["cr6"], m6)
        if tiles6 is not None:
            self._tiles6 = tiles6
            self._t6 = self._tile_tables(tiles6, m6, mm=self._t6["mm"])
            self.cr6_tiles_stats = dict(self.cr6_tiles_stats, **tiles6.stats)
        # the sparse tier's host selection reads the factored masks and
        # each chunk's live windows: refresh them under the grown closure
        # (chunk -> role coverage is closure-independent and stays put)
        self._m4_full = m4.astype(bool)
        self._m6_full = m6.astype(bool)
        self._m4_any = (self._m4_full & self._max_dirty_roles).any(axis=1)
        self._m6_any = (self._m6_full & self._max_dirty_roles).any(axis=1)
        for d, key in ((self._sp4, "cr4"), (self._sp6, "cr6")):
            if d is not None:
                d["windows"] = [list(w) for _a0, _a1, w in windows[key]]
        # the fused window's tables and captured windows read the masks
        # and windows: rebuild them on next use
        self._fused_tab_cache = None
        self._fused_windows.clear()
        # the bucketed step reads masks and windows as table content
        # (same structure, same signature); fused windows key on content
        self._m4_np, self._m6_np = m4, m6
        self._btables = None
        self._bucket_windows = {}
        self._digest = None
        self.idx = dataclasses.replace(idx, role_closure=h_new)
        return True

    def count_live_bits(self, sp, rp) -> int:
        """Set bits of the live concepts' columns in ``sp`` and ``rp``
        (on a mesh, summed over the ranks' windows)."""
        self.host_reads["bits"] += 1
        if self.n_shards == 1:
            return _host_bit_total(live_bits(sp, rp, self._wmask))
        return int(psum_(live_bits(sp, rp, self._wmask).sum().reshape(1),
                         self.mesh).item())

    def gather_state(self, sp, rp):
        """The whole packed pair ``(S_T [nc, wc], R_T [nl, wc])`` on every
        rank from the ranks' word windows (the reference's
        ``fetch_global``; every rank must call it).  Off a mesh,
        ``(sp, rp)``."""
        return all_gather_words(sp, self.mesh), all_gather_words(rp, self.mesh)

    def _result(self, sp, rp, iterations, derivations, converged,
                gather: bool = True):
        """The run's :class:`SaturationResult`: the whole closure on every
        rank, the rank's own windows in ``shards`` on a mesh (with
        ``gather`` False, the windows only: ``packed_s``/``packed_r``
        None)."""
        if gather or self.n_shards == 1:
            full_s, full_r = self.gather_state(sp, rp)
        else:
            full_s = full_r = None
        return SaturationResult(
            packed_s=full_s,
            packed_r=full_r,
            iterations=iterations,
            derivations=derivations,
            idx=self.idx,
            converged=converged,
            shards=(sp, rp) if self.n_shards > 1 else None,
        )

    # -------------------------------------------------------- fixed point

    def saturate(
        self,
        max_iters: int = 10_000,
        *,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
        profile: bool = False,
        init_total: Optional[int] = None,
        gather: bool = True,
    ) -> SaturationResult:
        """Groups of ``unroll`` supersteps (one host read of the
        device's frontier flags a step) until a group changes nothing or
        the budget — ``max_iters`` rounded up to ``unroll`` — is spent.
        ``initial``: a previous closure for :meth:`embed_state` (its
        first step runs everything).  ``profile``: accumulate
        synchronised walls of each rule group, the initial state, the
        per-step frontier fold and read and the final bit count into
        :attr:`rule_seconds` (slower; for breakdowns only).
        ``init_total``: with ``initial``, skip the initial live-bit
        count and take this value (the incremental round-robin, which
        recounts under the full universe at the end); the result's
        ``derivations`` then means something only to that caller.
        ``initial`` may be a :class:`RankWindows` on a mesh; ``gather``
        False leaves the result's closure as the rank's windows
        (:meth:`_result`) — both for the incremental round-robin, which
        gathers once at its end."""
        budget = _pad_up(max_iters, self.unroll)
        if self._bucket:
            return self._saturate_bucketed(
                budget, initial, allow_incomplete, profile, init_total,
                gather,
            )
        self._profile = bool(profile)
        self.gate_rounds = []
        try:
            if initial is None:
                sp, rp = self._timed("init", self.initial_state)
                init_total = fresh_init_total(self.idx)
            else:
                sp, rp = self._timed("init", self._embed_initial, initial)
                initial = None  # the embed copied it
                if init_total is None:
                    init_total = self.count_live_bits(sp, rp)
            # one single-tenant fixed-point run: the solo half of the
            # solo-vs-cohort dispatch tally (core/cohort.py)
            COHORT_EVENTS.record_solo()
            it, fr, changed = 0, None, True
            while changed and it < budget:
                changed = False
                for _ in range(self.unroll):
                    sp, rp, fr = self.step(sp, rp, fr)
                    changed |= fr.changed
                it += self.unroll
            total = self._timed("count", self.count_live_bits, sp, rp)
        finally:
            self._profile = False
        converged = not changed
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        return self._result(sp, rp, it, total - init_total, converged,
                            gather)

    # ------------------------------------------------ the bucketed program

    def _note_compile(self, stats: CompileStats) -> None:
        with self._stats_lock:
            self.compile_stats.merge(stats)
            self.last_compile = stats

    def _bucket_program(self):
        """This engine's step program from :data:`PROGRAMS` (built, and
        on a card captured, on a miss).  The engine keeps only a weak
        reference, so a program the registry evicts frees its card
        memory; the next run looks it up again."""
        from distel_tpu_torch.core import bucketing

        tables = self.bucket_tables()
        prog = self._prog_ref() if self._prog_ref is not None else None
        if prog is None:
            prog, stats = bucketing.get_program(
                self._bstruct, tables, self.bucket_signature, self.device,
            )
            self._note_compile(stats)
            self._prog_ref = weakref.ref(prog)
        return prog

    _prog_ref = None

    def bucket_tables(self) -> dict:
        """The argument tables of this engine's bucketed step (rebuilt
        after a rebind), at the shapes its structure fixes."""
        from distel_tpu_torch.core import bucketing

        if self._btables is None:
            struct, self._btables = bucketing.bucket_plan(self)
            if struct != self._bstruct:
                raise AssertionError("a rebind moved the bucket structure")
        return self._btables

    def _saturate_bucketed(self, budget, initial, allow_incomplete, profile,
                           init_total, gather=True) -> SaturationResult:
        """:meth:`saturate` through the bucketed program: under the state
        pair's lock the tables and the state are copied in, groups run
        (one flag read each: the change flag and each step's gate
        counts) until a group changes nothing or the budget is spent,
        and the closure is copied out."""
        prog = self._bucket_program()
        pair = prog.pair
        self._profile = bool(profile)
        self.gate_rounds = []
        try:
            with pair.lock:
                prog.load(self._btables)
                if initial is None:
                    self._timed("init", self._fill_initial, pair.sp, pair.rp)
                    init_total = fresh_init_total(self.idx)
                else:
                    sp, rp = self._timed("init", self._embed_initial, initial)
                    initial = None
                    pair.sp.copy_(sp)
                    pair.rp.copy_(rp)
                    del sp, rp
                    if init_total is None:
                        init_total = self.count_live_bits(pair.sp, pair.rp)
                COHORT_EVENTS.record_solo()
                prog.ms.fill_(True)
                prog.dl.copy_(prog.T["dl_valid"])
                it, changed = 0, True
                while changed and it < budget:
                    flags = self._timed("step", prog.run, self.mesh)
                    self.host_reads["flags"] += 1
                    changed = bool(flags[0])
                    for u in range(self.unroll):
                        c = [int(x) for x in flags[1 + 5 * u : 6 + 5 * u]]
                        self.gate_rounds.append({
                            "cr4": [c[0], c[1]], "cr6": [c[2], c[3]],
                            "cr6_tiles": [0, 0],
                            "cr5": bool(c[4]) if self._bottom else None,
                        })
                    it += self.unroll
                total = self._timed("count", self.count_live_bits,
                                    pair.sp, pair.rp)
                sp, rp = pair.sp.clone(), pair.rp.clone()
        finally:
            self._profile = False
        converged = not changed
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        return self._result(sp, rp, it, total - init_total, converged,
                            gather)

    def precompile(self, max_iters: int = 10_000, *,
                   programs: Tuple[str, ...] = ("run", "step", "fused"),
                   ) -> CompileStats:
        """Build (on a card, capture) this engine's program roster before
        any run needs it — the reference's warmup half: the step program
        (``"run"`` or ``"step"``; the port's fixed point is a host loop
        over it) and, with the fused window configured, its windows at
        the floor capacities for each K the config can dispatch.  Exact
        engines build nothing.  Returns :attr:`compile_stats`.
        ``max_iters`` is the reference's: the port's programs do not
        depend on the budget."""
        if not self._bucket:
            return self.compile_stats
        if "run" in programs or "step" in programs:
            self._bucket_program()
        if "fused" in programs and self._fused_eligible():
            floor = self._sparse_cfg["capacity_floor"]
            caps = (floor, floor if self._sp4 is not None else 0,
                    floor if self._sp6 is not None else 0)
            pair = self._fused_pair()
            with pair.lock:
                for k in self._fused_k_ladder(
                    self._fused_cfg["rounds"], self._fused_cfg["adaptive"]
                ):
                    self._fused_window(k, caps, (pair.sp, pair.rp))
        return self.compile_stats

    def _content_digest(self) -> str:
        """A digest of everything a fused window's captured body reads of
        this engine: the index's tables, the plan's knobs and the
        layout.  Two engines with equal digests hold equal tables."""
        d = self._digest
        if d is None:
            import hashlib

            h = hashlib.sha1()
            idx = self.idx
            for name in ("nf1", "nf2", "nf3", "nf4", "chain_pairs", "links",
                         "role_closure"):
                a = np.ascontiguousarray(getattr(idx, name))
                h.update(repr((name, a.shape, str(a.dtype))).encode())
                h.update(a.tobytes())
            h.update(repr((
                idx.n_concepts, idx.n_roles, idx.has_bottom_axioms,
                self.plan_stats(), self._link_window, self._window_headroom,
                self._sparse_cfg, self._gate_cr5, self.unroll,
                self.device.type,
            )).encode())
            d = self._digest = h.hexdigest()[:16]
        return d

    def _fused_pair(self):
        from distel_tpu_torch.core import bucketing

        return bucketing.state_pair(self.device, self.nc, self.nl, self.wl)

    # ------------------------------------------- the fused K-round window
    #
    # The per-round controller pays a host read of the card's frontier
    # a round.  The fused window moves the round loop onto the card: up
    # to K rounds of the adaptive controller a dispatch, the decision
    # (frontier measure, density and hysteresis, tier, convergence)
    # re-derived there from card copies of the same carries, the host
    # reading the card once a window.  A round whose frontier overflows
    # the window's sparse workspace does not run: the window exits
    # (status 2) and the host replays that one round on the per-round
    # path, so every retired round is the per-round controller's.

    _FUSED_TIERS = {0: "dense", 1: "sparse", 2: "idle"}

    #: captured windows an engine keeps, least recently used first out:
    #: each holds its graph's card memory (:meth:`fused_window_stats`)
    FUSED_CACHE_SIZE = 4

    @staticmethod
    def _fused_k_ladder(K: int, adaptive: bool) -> list:
        """The window sizes this config can dispatch: just K, or — with
        the K-adaptive terminal window on — the halving ladder K, K/2,
        ..., 2."""
        ks = [int(K)]
        if adaptive:
            k = int(K)
            while k > 2:
                k //= 2
                ks.append(k)
        return ks

    def _fused_eligible(self) -> bool:
        """Whether this engine's config routes the fused window (K > 1
        configured, and the sparse tier its round decision is built
        from configured and supported)."""
        return bool(
            self._fused_cfg
            and self._fused_cfg["rounds"] > 1
            and self._sparse_cfg is not None
            and self._sparse_supported()
        )

    def _fused_below_cutoff(self, thr: float) -> int:
        """Largest ``rows_touched`` for which the host controller's f64
        test ``rows / max(total_rows, 1) < thr`` holds — the exact
        integer form of the density test the window runs on the card
        (a division there could disagree with the host at the
        threshold and desync the hysteresis)."""
        total = max(self._sp_total_rows, 1)
        start = int(np.floor(float(thr) * total)) + 2
        for cand in range(start, -1, -1):
            if cand / total < thr:
                return cand
        return -1

    @staticmethod
    def _fused_pieces(d: dict) -> list:
        """A CR4/CR6 table's write pieces ``(group, chunk, r0, r1)`` in
        row order: the rows of one row chunk inside one write group (a
        chunk is one contiguous span of rows; a live-tile group may cut
        it).  A sparse round's selected rows of a piece lie together in
        its workspace, because the workspace is in row order."""
        starts = d["group_starts"]
        out = []
        for c in range(len(d["windows"])):
            rows = np.flatnonzero(d["chunk_of"] == c)
            r0, r1 = int(rows[0]), int(rows[-1]) + 1
            cuts = sorted({r0, r1, *(int(x) for x in starts if r0 < x < r1)})
            for a, b in zip(cuts[:-1], cuts[1:]):
                g = int(np.searchsorted(starts, a, side="right")) - 1
                out.append((g, c, a, b))
        return sorted(out, key=lambda p: p[2])

    def _fused_tables(self) -> dict:
        """The card tables the window's round decision and tiers read —
        the counterparts of :meth:`_sparse_round_plan`'s host arrays
        (rule tables, factored masks, row validity, write pieces) and of
        the dense step's window L-chunks.  Built before any capture (a
        capture may not copy from the host); cached per engine,
        dropped by :meth:`rebind_role_closure`."""
        ft = self._fused_tab_cache
        if ft is not None:
            return ft
        dev = self.device

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        nf1, nf2, nf3 = self._sp_nf1, self._sp_nf2, self._sp_nf3

        def most(tgts):
            """The most rows of one target (a write's longest segment)."""
            return int(np.unique(tgts, return_counts=True)[1].max()) \
                if len(tgts) else 1

        ft = {"croles": torch.as_tensor(self._chunk_roles_np).to(dev),
              "most": {k: most(t[:, c]) for k, t, c in
                       (("1", nf1, 1), ("2", nf2, 2), ("3", nf3, 1))}}
        if len(nf1):
            ft["nf1s"], ft["nf1t"] = i64(nf1[:, 0]), i64(nf1[:, 1])
        if len(nf2):
            ft["nf2a"], ft["nf2b"] = i64(nf2[:, 0]), i64(nf2[:, 1])
            ft["nf2t"] = i64(nf2[:, 2])
        if len(nf3):
            ft["nf3s"], ft["nf3t"] = i64(nf3[:, 0]), i64(nf3[:, 1])
        for key, d, src, mask in (
            ("4", self._sp4, self._a4, self._m4_full),
            ("6", self._sp6,
             None if self._l26 is None else self._l26 // self.lc,
             self._m6_full),
        ):
            if d is None:
                continue
            ch = d["chunk_of"]
            has_win = np.asarray([len(w) > 0 for w in d["windows"]], bool)
            pieces = self._fused_pieces(d)
            piece_of = np.zeros(len(ch), np.int64)
            for pi, (_g, _c, r0, r1) in enumerate(pieces):
                piece_of[r0:r1] = pi
            ft["fd" + key] = i64(src)
            ft["m" + key] = torch.as_tensor(mask).to(dev)
            ft["ok" + key] = torch.as_tensor(
                (ch >= 0) & has_win[np.clip(ch, 0, None)]
            ).to(dev)
            ft["tab" + key] = i64(d["tab"])
            ft["piece" + key] = i64(piece_of)
            ft["pieces" + key] = pieces
            groups = {}
            for _g, _c, r0, r1 in pieces:
                groups.setdefault(_g, []).append(d["tab"][r0:r1, 2])
            ft["most" + key] = {g: most(np.concatenate(t))
                                for g, t in groups.items()}
        for key, chunks in (("4", self._chunks4), ("6", self._chunks6)):
            ft["win" + key] = [
                (i64([w[2] for w in c.windows]), i64([w[3] for w in c.windows]))
                for c in chunks
            ]
        # the write plans' card targets, which the dense step would
        # otherwise copy over on first use
        state_dev = self._wmask.device
        plans = [self._p1, self._p2, self._p3]
        plans += [c.piece for c in self._chunks4 + self._chunks6]
        if self._t6 is not None:
            plans += [g[2] for g in self._t6["groups"]]
        for plan in plans:
            plan.device_targets(state_dev)
        self._fused_tab_cache = ft
        return ft

    # ---- the round decision on the card

    def _round_plan_dev(self, ms, dl) -> dict:
        """The card replica of :meth:`_sparse_round_plan`'s measure from
        the carries ``ms`` (changed S rows) and ``dl`` (dirty L-chunks):
        per-rule activity masks and counts over the full tables, the
        CR1 → CR2 → CR3 cascade, row-level CR4/CR6 liveness and CR5's
        ``run5``.  It must select exactly what the host selects from
        the same carries: the tier, the hysteresis and every
        ``rows_touched`` record hang off it."""
        ft = self._fused_tables()
        dev = self.device
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        plan = {"n1": zero, "n2": zero, "n3": zero, "n4": zero, "n6": zero}

        def scatter_or(base, tgts, act):
            hit = torch.zeros(self.nc, dtype=torch.int32, device=dev)
            hit.index_add_(0, tgts, act.to(torch.int32))
            return base | (hit > 0)

        s1 = ms
        if "nf1s" in ft:
            act1 = ms[ft["nf1s"]]
            plan["act1"], plan["n1"] = act1, act1.sum()
            s1 = scatter_or(ms, ft["nf1t"], act1)
        s2 = s1
        if "nf2a" in ft:
            act2 = s1[ft["nf2a"]] | s1[ft["nf2b"]]
            plan["act2"], plan["n2"] = act2, act2.sum()
            s2 = scatter_or(s1, ft["nf2t"], act2)
        if "nf3s" in ft:
            act3 = s2[ft["nf3s"]]
            plan["act3"], plan["n3"] = act3, act3.sum()
        dirty_roles = (ft["croles"] & dl[:, None]).any(dim=0)
        for key, src in (("4", ms), ("6", dl)):
            if "m" + key not in ft:
                continue
            fd = src[ft["fd" + key]]
            masked = (ft["m" + key] & dirty_roles[None, :]).any(dim=1)
            act = (fd | masked) & ft["ok" + key]
            plan["fd" + key], plan["act" + key] = fd, act
            plan["n" + key] = act.sum()
        rows = plan["n1"] + plan["n2"] + plan["n3"] + plan["n4"] + plan["n6"]
        if self._bottom:
            plan["run5"] = dl.any() | ms[BOTTOM_ID]
            rows = rows + plan["run5"].to(torch.int64)
        plan["rows"] = rows
        return plan

    @staticmethod
    def _compact_dev(mask, cap: int):
        """``(idx, valid)``: the positions of ``mask``'s set entries in
        ascending order (``np.flatnonzero``'s) in a workspace of ``cap``
        slots, pad slots index 0 — a prefix sum and a scatter, with no
        host read (``torch.nonzero`` would read its count back)."""
        n = mask.numel()
        dev = mask.device
        pos = torch.cumsum(mask.to(torch.int64), 0) - 1
        dest = torch.where(mask & (pos < cap), pos, cap)
        slots = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        slots.scatter_(0, dest, torch.arange(n, device=dev))
        valid = torch.arange(cap, device=dev) < mask.sum()
        return torch.where(valid, slots[:cap], 0), valid

    def _fused_sparse_args_dev(self, plan, caps) -> dict:
        """One round's selected row sets compacted into the workspaces of
        the window's capacities ``(c123, a4, a6)`` — the card form of
        :meth:`_sparse_round_args`: CR1-CR3 rows gathered from their
        tables (pad slots: index 0, ``val`` False), the CR4/CR6 table
        rows with their source-changed flags, and per write piece its
        rows' count and first workspace slot."""
        ft = self._fused_tables()
        c123, a4c, a6c = caps
        sa = {}
        for key, cols in (("1", ("nf1s", "nf1t")),
                          ("2", ("nf2a", "nf2b", "nf2t")),
                          ("3", ("nf3s", "nf3t"))):
            if "act" + key not in plan:
                continue
            idx, valid = self._compact_dev(plan["act" + key], c123)
            sa["rows" + key] = [
                torch.where(valid, ft[c][idx], 0) for c in cols
            ]
            sa["val" + key] = valid
        for key, cap in (("4", a4c), ("6", a6c)):
            if "act" + key not in plan:
                continue
            act = plan["act" + key]
            idx, valid = self._compact_dev(act, cap)
            n_p = len(ft["pieces" + key])
            cnt = torch.zeros(n_p, dtype=torch.int64, device=self.device)
            cnt.index_add_(0, ft["piece" + key], act.to(torch.int64))
            sa["sel" + key] = idx
            sa["fd" + key] = valid & plan["fd" + key][idx]
            sa["cnt" + key] = cnt
            sa["start" + key] = torch.cumsum(cnt, 0) - cnt
        if self._bottom:
            sa["run5"] = plan["run5"]
        return sa

    # ---- duplicate-safe row writes on the card

    @staticmethod
    def _seg_plan_dev(tgt, valid) -> tuple:
        """The segments of equal targets of the rows ``valid`` of
        ``tgt`` [n] for :meth:`_seg_or_write`: the stable sort order
        (the other rows, pad slots, last), each position's write target,
        segment start and last valid position, and whether it is that
        position.  Pad slots write the last segment's row with its
        value (the same write twice); with no valid row, row 0 with its
        own value."""
        n = tgt.numel()
        pos = torch.arange(n, device=tgt.device)
        key = torch.where(valid, tgt, torch.iinfo(torch.int64).max)
        order = torch.argsort(key, stable=True)
        key = key[order]
        count = valid.sum()
        lastv = (count - 1).clamp(min=0)
        fill = torch.where(count > 0, key[lastv.view(1)], 0)
        t = torch.where(pos < count, key, fill)
        start = torch.searchsorted(t, t)
        end = torch.minimum(torch.searchsorted(t, t, right=True) - 1, lastv)
        return order, t, start, end, pos == end

    def _seg_or_write(self, state, seg, x, cols, mvec, most: int):
        """``state[tgt[i], cols] |= x[i]`` for every i, duplicate
        targets included, in place: mark the rows that gained a bit in
        ``mvec`` and return the live-column bits gained (a 0-d int64 on
        the device).  The rows are sorted by target; a doubling scan
        ORs each segment's rows together (``most``: the longest segment
        the table can give, which bounds the scan's passes; pad slots
        sort after the valid rows, so no segment's scan runs through
        them); every member of a segment then writes the same merged
        row.  ``x`` must be 0 on pad slots."""
        order, t, start, end, last = seg
        xs = x[order]
        n = xs.shape[0]
        pos = torch.arange(n, device=xs.device)
        step = 1
        while step < min(n, most):
            ok = (pos[step:] - step) >= start[step:]
            xs = torch.cat([
                xs[:step],
                xs[step:] | torch.where(ok[:, None], xs[:-step], 0),
            ])
            step *= 2
        full = xs[end]
        old = state[t, cols]
        merged = old | full
        state[t, cols] = merged
        gained = merged ^ old
        mvec[t] = mvec[t] | (gained != 0).any(dim=1)
        bits = popcount_rows(gained, self._wmask[cols])
        return (bits * last).sum()

    # ---- the tiers without a host read

    def _contract_rule_dev(self, chunks, wins, flags, bits_state, rp,
                           target, dl_ext, cvs):
        """:meth:`_contract_rule` with each window's liveness on the
        card: every window launches, its kernel reading the row count
        (``rk`` when live, 0 when its inputs are clean) from card
        memory; each chunk's accumulator is zeroed once and every
        launch ORs into it; every chunk writes."""
        for i, (chunk, (c0, c1)) in enumerate(zip(chunks, wins)):
            if not chunk.windows:
                continue
            rk = chunk.src.shape[0]
            live = flags[i] | dl_ext[c0] | dl_ext[c1]
            n_rows = live.to(torch.int32) * rk
            subt = bits_state[chunk.src].T.contiguous()       # [wl, rk]
            acc = torch.zeros((rk, self.wl), dtype=torch.int32,
                              device=rp.device)
            for j, (off, end, _c0, _c1) in enumerate(chunk.windows):
                f = self._bit_table(subt, self._fillers[off:end])  # [l, rk]
                w = chunk.mask[:, self._link_roles[off:end]] * f.T
                self._plan(rk, end - off)(
                    w.contiguous(), rp[off:end], out=acc,
                    n_rows=n_rows[j : j + 1],
                )
            piece = chunk.piece
            cv = piece.write(target, piece.reduce(acc[chunk.order]),
                             track="rows")
            cvs.append((piece.device_targets(target.device), cv))

    def _cr6_tiles_dev(self, rp, fd6, dl_ext, r_cvs):
        """:meth:`_cr6_tiles` with the slots' liveness on the card: every
        link tile launches, its slots masked by liveness and its
        kernel's row count 0 when no slot is live; every group
        writes."""
        t6 = self._t6
        mm = t6["mm"]
        for rt0, rt1, plan, order in t6["groups"]:
            outs = []
            for rt in range(rt0, rt1):
                acc = torch.zeros(
                    (mm.m, self.wc), dtype=torch.int32, device=rp.device
                )
                if t6["n_tiles"][rt]:
                    subt = rp[t6["rows"][rt]].T.contiguous()   # [wc, tile_m]
                for k in range(t6["n_tiles"][rt]):
                    ids = t6["tids"][rt, k]
                    live = t6["tval"][rt, k] & (fd6[rt] | dl_ext[t6["tchunk"][rt, k]])
                    f = bit_lookup_from(
                        subt, self._fillers[ids], dtype=torch.int8
                    )                                      # [tile_l, tile_m]
                    w = (
                        t6["mask"][
                            t6["mrow_ids"][rt][:, None],
                            self._link_roles[ids][None, :],
                        ]
                        * f.T
                        * live.to(torch.int8)[None, :]
                    )
                    n_rows = (live.any().to(torch.int32) * mm.m).reshape(1)
                    mm(w.contiguous(), rp[ids], out=acc, n_rows=n_rows)
                outs.append(acc)
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
            cv = plan.write(rp, plan.reduce(out[order]), track="rows")
            r_cvs.append((plan.device_targets(rp.device), cv))

    def _step_dev(self, sp, rp, ms, dl):
        """One gated superstep in place with the frontier ``(ms, dl)`` on
        the card and nothing read back — :meth:`step` as the window
        runs it: the same rules, order and writes, the gates reduced to
        card-held row counts and masks (a clean window's kernel does
        nothing; a write of nothing changes nothing).  Returns
        ``(changed, mask_s, dirty_l)`` on the device."""
        s_cvs, r_cvs = [], []
        f4, f6, fd6, dl_ext = self._chunk_flags(ms, dl)
        if self._p1.k or self._p2.k or self._p3.k:
            self._row_rules(sp, rp, s_cvs, r_cvs)
        ft = self._fused_tables()
        if self._chunks4:
            self._contract_rule_dev(self._chunks4, ft["win4"], f4, sp, rp,
                                    sp, dl_ext, s_cvs)
        if self._t6 is not None:
            self._cr6_tiles_dev(rp, fd6, dl_ext, r_cvs)
        elif self._chunks6:
            self._contract_rule_dev(self._chunks6, ft["win6"], f6, rp, rp,
                                    rp, dl_ext, r_cvs)
        if self._bottom:
            red = self._cr5_reduce(sp, rp)
            if self._gate_cr5:
                run = dl.any() | ms[BOTTOM_ID]
                red = red * run.to(torch.int32)
            old = sp[BOTTOM_ID].clone()
            sp[BOTTOM_ID] |= red
            s_cvs.append((self._bottom_idx, (sp[BOTTOM_ID] != old).any()[None]))
        mask_s, dirty_l = self._fold_masks(s_cvs, r_cvs)
        return mask_s.any() | dirty_l.any(), mask_s, dirty_l

    def _sparse_exec_dev(self, sp, rp, sa, dl):
        """One frontier-compacted superstep in place at the window's
        traced capacities, nothing read back — :meth:`_sparse_exec` as
        the window runs it: CR1 → CR2 → CR3 over the compacted rows
        (word blocks, each rule gathering before its writes), CR4 then
        CR6 piece by piece in the dense step's write groups (each
        piece's selected rows, capacity-sized with their count on the
        card, contracted window by window through the packed-columns
        kernels; a window is live for every row when an L-chunk it
        overlaps is dirty, else for the rows whose source changed), CR5
        when ``run5``.  Returns ``(changed, delta_bits, mask_s,
        dirty_l_next)`` on the device."""
        dev = self.device
        ft = self._fused_tables()
        mask_s = torch.zeros(self.nc, dtype=torch.bool, device=dev)
        mask_r = torch.zeros(self._grid_end, dtype=torch.bool, device=dev)
        deltas = []
        rules = []
        for key, tgt_state, mvec in (("1", sp, mask_s), ("2", sp, mask_s),
                                     ("3", rp, mask_r)):
            if "rows" + key in sa:
                *srcs, tgt = sa["rows" + key]
                valid = sa["val" + key]
                val = valid.to(torch.int32).neg()[:, None]
                rules.append((srcs, val, self._seg_plan_dev(tgt, valid),
                              tgt_state, mvec, ft["most"][key]))
        if rules:
            cap = rules[0][1].shape[0]
            # the gathers, the scan's rows and the write: about 8 row
            # copies of a block alive at once
            bw = max(min(self.temp_budget_bytes // (32 * cap), self.wl), 1)
            for off in range(0, self.wl, bw):
                blk = slice(off, min(off + bw, self.wl))
                for srcs, val, seg, state, mvec, most in rules:
                    g = sp[srcs[0], blk]
                    if len(srcs) == 2:
                        g = g & sp[srcs[1], blk]
                    deltas.append(self._seg_or_write(state, seg, g & val,
                                                     blk, mvec, most))
        dl_ext = torch.cat([dl, dl.new_zeros(1)])
        for key, d, bits_state, target, mvec in (
            ("4", self._sp4, sp, sp, mask_s), ("6", self._sp6, rp, rp, mask_r),
        ):
            if "sel" + key not in sa:
                continue
            deltas.extend(self._sparse_pieces_dev(
                key, d, sa, bits_state, rp, target, mvec, dl_ext
            ))
        if self._bottom:
            red = self._cr5_reduce(sp, rp) * sa["run5"].to(torch.int32)
            old = sp[BOTTOM_ID].clone()
            merged = old | red
            sp[BOTTOM_ID] = merged
            gained = merged ^ old
            mask_s[BOTTOM_ID] = mask_s[BOTTOM_ID] | (gained != 0).any()
            deltas.append(popcount_rows(gained[None], self._wmask).sum())
        delta = (
            torch.stack(deltas).sum() if deltas
            else torch.zeros((), dtype=torch.int64, device=dev)
        )
        dirty_next = mask_r.view(self.n_lchunks, self.lc).any(dim=1)
        # the round's fold (the reference's per-round psums inside the
        # window): every rank carries the same frontier
        both, delta = self._fold_round(mask_s, dirty_next, delta)
        mask_s, dirty_next = both[: self.nc], both[self.nc :]
        return mask_s.any() | dirty_next.any(), delta, mask_s, dirty_next

    def _sparse_pieces_dev(self, key, d, sa, bits_state, rp, target, mvec,
                           dl_ext) -> list:
        """CR4 (``key`` "4") or CR6 ("6") of a window's sparse round over
        the selected rows, group by group; returns the groups' gained
        bits."""
        ft = self._fused_tables()
        dev = self.device
        tab, sel, fdw = ft["tab" + key], sa["sel" + key], sa["fd" + key]
        cnt, start = sa["cnt" + key], sa["start" + key]
        cap = sel.shape[0]
        deltas, outs, tgts, valids = [], [], [], []
        pieces = ft["pieces" + key]
        for pi, (g, c, r0, r1) in enumerate(pieces):
            wins = d["windows"][c]
            if wins:
                m = min(cap, r1 - r0)
                slot = torch.arange(m, device=dev)
                valid = slot < cnt[pi]
                ws = torch.clamp(start[pi] + slot, max=cap - 1)
                rows = sel[ws]
                fd = fdw[ws] & valid
                n_sel = cnt[pi].to(torch.int32).reshape(1)
                subt = bits_state[tab[rows, 1]].T.contiguous()   # [wl, m]
                mask = ft["m" + key][rows].view(torch.int8)       # [m, roles+1]
                acc = torch.zeros((m, self.wl), dtype=torch.int32, device=dev)
                for off, end, c0, c1 in wins:
                    row_live = valid & (dl_ext[c0] | dl_ext[c1] | fd)
                    f = self._bit_table(subt, self._fillers[off:end])  # [l, m]
                    w = (mask[:, self._link_roles[off:end]] * f.T
                         * row_live.to(torch.int8)[:, None])
                    self._plan(m, end - off)(
                        w.contiguous(), rp[off:end], out=acc,
                        n_rows=n_sel * row_live.any().to(torch.int32),
                    )
                outs.append(acc)
                tgts.append(tab[rows, 2])
                valids.append(valid)
            if outs and (pi + 1 == len(pieces) or pieces[pi + 1][0] != g):
                x, tg, ok = (torch.cat(v) if len(v) > 1 else v[0]
                             for v in (outs, tgts, valids))
                deltas.append(self._seg_or_write(
                    target, self._seg_plan_dev(tg, ok), x, slice(None), mvec,
                    ft["most" + key][g],
                ))
                outs, tgts, valids = [], [], []
        return deltas

    # ---- the window

    def _branch(self, pred, body) -> None:
        """Run ``body`` when the 0-d bool ``pred`` holds: on a card, as a
        conditional (IF) node of the graph being captured
        (``ops/graph_if.py``); on the CPU, as a Python ``if`` on the
        value (the one read the CPU path makes).  The only thing the two
        paths do differently."""
        cap = self._capturing
        if cap is not None:
            graph_if.capture_if(pred, body, *cap)
            return
        with NoHostReads.allowed():
            taken = bool(pred)
        if taken:
            body()

    #: ``(child stream, memory pool)`` while a window is being captured
    _capturing = None

    def _window_body(self, win: "_FusedWindow") -> None:
        """Up to ``win.K`` rounds of the adaptive controller on the
        window's carries and the state pair in place (the port of the
        reference's ``_fused_exec``).  Round r runs while the status is
        0 and the iteration is under the budget (a running round r has
        retired r rounds before it): the device round plan, the density
        test against the exact integer cutoff, hysteresis, the tier —
        idle, sparse (when eligible and within the capacities), dense,
        or the fallout exit (eligible but over a capacity: the round
        does not run) — then the tier, then the round's record.  Exit
        status: 0 = K rounds or the budget, 1 = converged, 2 =
        fallout."""
        win.status.zero_()
        win.rdone.zero_()
        for r in range(win.K):
            alive = (win.status == 0) & (win.it < win.budget)
            self._branch(alive, lambda: self._window_decide(win))
            self._branch(alive & win.use_dense,
                         lambda r=r: self._window_tier(win, r, "dense"))
            self._branch(alive & win.use_sparse,
                         lambda r=r: self._window_tier(win, r, "sparse"))
            self._branch(alive, lambda r=r: self._window_retire(win, r))
        torch.cat([win.below.view(1), win.it.view(1), win.rdone.view(1),
                   win.status.view(1), win.tb, win.rb, win.db,
                   win.cb.to(torch.int64), win.bb], out=win.report)

    def _window_decide(self, win) -> None:
        plan = self._round_plan_dev(win.ms, win.dl)
        rows = plan["rows"]
        below_next = torch.where(rows <= win.below_cut, win.below + 1, 0)
        idle = rows == 0
        want = (win.it > 0) & (below_next >= win.hyst)
        c123, a4c, a6c = win.caps
        fits = torch.maximum(torch.maximum(plan["n1"], plan["n2"]),
                             plan["n3"]) <= c123
        if "act4" in plan:
            fits = fits & (plan["n4"] <= a4c)
        if "act6" in plan:
            fits = fits & (plan["n6"] <= a6c)
        use_sparse = want & fits & ~idle
        fallout = want & ~fits & ~idle
        win.use_sparse.copy_(use_sparse)
        win.fallout.copy_(fallout)
        win.idle.copy_(idle)
        win.use_dense.copy_(~(idle | use_sparse | fallout))
        win.rows.copy_(rows)
        win.below_next.copy_(below_next)
        win.plan = plan

    def _window_tier(self, win, r: int, tier: str) -> None:
        rec = bitmatmul.recorded() or {}
        before = dict(rec)
        sp, rp = win.state
        if tier == "dense":
            ms, dl = win.ms, win.dl
            changed = torch.zeros((), dtype=torch.bool, device=self.device)
            for _ in range(self.unroll):
                ch, ms, dl = self._step_dev(sp, rp, ms, dl)
                changed = changed | ch
            bits = live_bits(sp, rp, self._wmask).sum()
            if self.n_shards > 1:
                bits = psum_(bits.reshape(1), self.mesh)[0]
            win.bits.copy_(bits)
        else:
            sa = self._fused_sparse_args_dev(win.plan, win.caps)
            changed, delta, ms, dl = self._sparse_exec_dev(sp, rp, sa, win.dl)
            win.delta.copy_(delta)
        win.ms.copy_(ms)
        win.dl.copy_(dl)
        win.ch.copy_(changed)
        win.launches[r][tier] = {
            k: v - before[k] for k, v in rec.items() if v != before[k]
        }

    def _window_retire(self, win, r: int) -> None:
        ran = win.use_dense | win.use_sparse
        tier = torch.where(win.idle, 2, torch.where(win.use_sparse, 1, 0))
        changed = win.ch & ran
        win.tb[r] = tier
        win.rb[r] = win.rows
        win.db[r] = torch.where(win.use_sparse, win.delta, 0)
        win.cb[r] = changed
        win.bb[r] = torch.where(win.use_dense, win.bits, 0)
        step = torch.where(win.idle | win.use_sparse, 1, self.unroll)
        win.it.add_(torch.where(win.fallout, 0, step))
        win.rdone.add_((~win.fallout).to(torch.int64))
        win.status.copy_(torch.where(
            win.fallout, 2, torch.where(changed, 0, 1)
        ))
        win.below.copy_(torch.where(win.fallout, win.below, win.below_next))

    def _fused_window(self, K: int, caps: tuple, state) -> "_FusedWindow":
        """The window of ``K`` rounds at sparse capacities ``caps`` over
        the state pair ``state``: on a card its CUDA graph, captured on
        first use and kept (LRU, :data:`FUSED_CACHE_SIZE` entries; a
        card's runs all use the engine's own pair); on the CPU the
        eager body.  A bucketed engine's windows live in
        :data:`PROGRAMS` instead, keyed by the bucket signature, K, the
        capacities and :meth:`_content_digest` (the window's body is
        this engine's plan, which is not rung-canonical: windows are
        shared by engines with equal tables), over the layout's state
        pair; a window keeps the capturing engine's tables alive."""
        if self._bucket:
            return self._fused_window_bucketed(K, caps, state)
        key = (int(K), tuple(int(c) for c in caps))
        win = self._fused_windows.get(key)
        if win is not None:
            self._fused_windows.move_to_end(key)
            win.state = state
            return win
        self._fused_tables()
        win = _FusedWindow(self, key[0], key[1], state)
        if self._capture_windows():
            self._capture_window(win)
        self._fused_windows[key] = win
        while len(self._fused_windows) > self.FUSED_CACHE_SIZE:
            _k, old = self._fused_windows.popitem(last=False)
            old.release()
        return win

    def _fused_window_bucketed(self, K, caps, state) -> "_FusedWindow":
        caps = tuple(int(c) for c in caps)
        ref = self._bucket_windows.get((int(K), caps))
        win = ref() if ref is not None else None
        if win is not None and win.state[0] is state[0]:
            return win          # this engine's earlier lookup
        key = (self.bucket_signature, "fused", int(K), caps,
               self._content_digest())
        stats = CompileStats(bucket_signature=self.bucket_signature,
                             program=f"fused[{int(K)}]")

        def build():
            with library_loads(stats):
                return build_window()

        def build_window():
            t0 = time.perf_counter()
            self._fused_tables()
            win = _FusedWindow(self, int(K), caps, state)
            # the layout's pair lives while a window captured on it does
            win.pair = self._fused_pair()
            # everything the body reads, as it is now (a later rebind
            # swaps the engine's tables; the graph keeps reading these)
            win.keep = {k: v for k, v in self.__dict__.items()
                        if k not in ("_bucket_windows", "_fused_windows",
                                     "_prog_ref")}
            stats.trace_lower_s = time.perf_counter() - t0
            if self._capture_windows():
                self._capture_window(win)
                stats.compile_s = win.capture_s
            return win

        win, hit = PROGRAMS.get_or_build(key, build)
        stats.program_cache_hit = hit
        self._note_compile(stats)
        if win.state[0] is not state[0]:
            raise RuntimeError("a fused window runs on its own state pair")
        self._bucket_windows[(int(K), caps)] = weakref.ref(win)
        return win

    def _capture_windows(self) -> bool:
        """Whether windows are captured: on a card off a mesh or on a
        mesh of one.  On more than one rank a window runs uncaptured, as
        the bucketed step does (a CUDA graph cannot hold a gloo
        collective): its IF predicates are read by the host, and each
        exchange inside it is a host sync."""
        return self.device.type == "cuda" and self.n_shards == 1

    def _capture_window(self, win) -> None:
        """Capture ``win``'s body into one CUDA graph on this engine's
        state pair.  A host sync anywhere in the body fails the capture
        and raises, and takes the process down (``ops/graph_if.py``);
        nothing here catches it.  The wrappers record the launches of
        each round's tier bodies (``bitmatmul.recording``); the replays
        add what ran."""
        dev = self.device
        _warm_kernels(dev)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        win.pool = torch.cuda.MemPool()
        child = torch.cuda.Stream(dev)
        t0 = time.perf_counter()
        self._capturing = (child, win.pool)
        from distel_tpu_torch.core.bucketing import CAPTURE_LOCK

        try:
            with CAPTURE_LOCK, _no_gc(), _OpCount() as ops, \
                    bitmatmul.recording(), \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._window_body(win)
        finally:
            self._capturing = None
        win.capture_s = time.perf_counter() - t0
        win.captured_ops = ops.n
        win.graph = graph
        pools = {tuple(graph.pool()), tuple(win.pool.id)}
        win.card_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) in pools
        )

    def fused_window_stats(self) -> list:
        """What each captured window holds: ``K``, the capacities, the
        capture's seconds, the operations it recorded (each one or more
        graph nodes) and the card bytes of its memory pools (the
        graph's and its IF bodies'), as the allocator's segments count
        them."""
        wins = (
            [w for w in (r() for r in self._bucket_windows.values()) if w]
            if self._bucket else self._fused_windows.values()
        )
        return [
            {"K": w.K, "caps": list(w.caps), "capture_s": w.capture_s,
             "captured_ops": w.captured_ops, "card_bytes": w.card_bytes}
            for w in wins
        ]

    def _fused_run_state(self, sp, rp):
        """The state pair a run's windows work on: on a card the
        engine's own pair (the captured graphs' addresses), with the
        run's state copied in; on the CPU the run's own tensors.  A
        bucketed engine's is the layout's shared pair on either device
        (its caller holds the pair's lock)."""
        if self._bucket:
            pair = self._fused_pair()
            pair.sp.copy_(sp)
            pair.rp.copy_(rp)
            return pair.sp, pair.rp
        if self.device.type != "cuda":
            return sp, rp
        if self._fused_state is None:
            self._fused_state = (torch.empty_like(sp), torch.empty_like(rp))
        ws, wr = self._fused_state
        ws.copy_(sp)
        wr.copy_(rp)
        return ws, wr

    def _saturate_fused(self, *args, **kw):
        """:meth:`_saturate_fused_run`, under the layout's state-pair lock
        when bucketed (its windows are shared)."""
        if not self._bucket:
            return self._saturate_fused_run(*args, **kw)
        pair = self._fused_pair()
        with pair.lock:
            return self._saturate_fused_run(*args, **kw)

    def _saturate_fused_run(
        self, cfg, K, sp, rp, init_total, budget, observer,
        frontier_observer, pipeline_depth: int = 1, adaptive: bool = False,
    ):
        """The K-round window controller — the reference's
        ``_saturate_fused``.  Each dispatch runs one window
        (:meth:`_window_body`): up to K rounds of the adaptive
        controller on the card.  Per window the host loads the carry
        (at a sync point), replays, and later reads the window's report
        once: every round's tier, rows touched, delta or live-bit
        total and change flag, from which it rebuilds each retired
        round's :class:`FrontierStats`, stamped ``rounds_in_window`` =
        the rounds the window retired, with the window's walls split
        evenly over them.  The retired rounds are the per-round
        controller's; the two escapes hand control back without
        running a round differently:

        * fallout (status 2): a round's sparse frontier overflowed the
          window's capacities and did not run; the host replays that
          one round on the per-round path (which may pick a bigger
          rung, or the dense step with its overflow flag) and resumes
          windows;
        * convergence (status 1): windows dispatched behind it retire
          only idle rounds and are dropped.

        ``adaptive``: each dispatch takes its K from the halving ladder
        (:meth:`_fused_k_ladder`), smaller once the derivation tail's
        geometric decay predicts fewer rounds than half a window; only
        the window edges move.

        Pipelining (``pipeline_depth`` > 1) keeps up to that many
        windows in flight, each chained on the previous window's carries
        on the card (a window of another K copies them over on the
        card), with no worker thread: each window's report, changed-S
        mask and dirty L-chunks go to pinned host buffers by
        asynchronous copies, behind an event the retire waits on."""
        from distel_tpu_torch.obs import costmodel

        sp_run, rp_run = sp, rp
        sp, rp = self._fused_run_state(sp, rp)
        depth = max(int(pipeline_depth), 1)
        unroll = self.unroll
        s_chg = np.ones(self.nc, bool)
        dirty_l = np.ones(self.n_lchunks, bool)
        any_r = True
        below = 0
        iteration, total, converged = 0, init_total, False
        floor = cfg["capacity_floor"]
        run_consts = (budget,
                      self._fused_below_cutoff(cfg["density_threshold"]),
                      int(cfg["hysteresis_rounds"]))
        pending = deque()          # in-flight windows, oldest first
        latest = [None]            # the newest dispatched window
        self.frontier_rounds = []
        #: the last fused run's windows: rounds each retired window
        #: retired, fallouts replayed on the per-round path, and windows
        #: dropped unretired behind a fallout or convergence
        self.fused_run_stats = {"windows": [], "fallouts": 0, "dropped": 0}
        stats = self.fused_run_stats
        recent_deltas = deque(maxlen=8)
        cur_caps = None

        def finish_round(st, changed):
            nonlocal converged
            recent_deltas.append(st.derivations)
            FRONTIER_EVENTS.record(st)
            self.frontier_rounds.append(st)
            if frontier_observer is not None:
                frontier_observer(st)
            if observer is not None:
                observer(st.iteration, total - init_total, changed)
            if not changed:
                converged = True

        def pick_caps():
            """Sparse capacities for the next window, from the host
            frontier at this sync point; CR4/CR6 get at least the floor
            rung while inactive, so a later activation in the window
            need not fall out."""
            _rows, _den, measure, _over = self._sparse_round_plan(
                cfg, s_chg, dirty_l, any_r
            )
            key = (floor, floor, floor) if measure is None else measure["key"]
            return (
                key[0],
                max(key[1], floor) if self._sp4 is not None else 0,
                max(key[2], floor) if self._sp6 is not None else 0,
            )

        def pick_k():
            """K for the next dispatch: halved down the ladder while half
            a window still covers the rounds the tail's decay predicts
            (floor 2)."""
            if not adaptive:
                return K
            rem = costmodel.geometric_tail_remaining(recent_deltas)
            if rem is None:
                return K
            k = K
            while k > 2 and k // 2 >= rem:
                k //= 2
            return k

        def dispatch_window(caps, kw, sync_point):
            win = self._fused_window(kw, caps, (sp, rp))
            t0 = time.perf_counter()
            if sync_point:
                win.load(s_chg, dirty_l, below, iteration, *run_consts)
            elif latest[0] is not win:
                win.chain(latest[0])
            win.run(self)
            latest[0] = win
            pending.append({
                "win": win, "out": _WindowOut(win),
                "dispatch_s": time.perf_counter() - t0,
                "inflight": len(pending),
            })

        def retire_window():
            nonlocal total, below, iteration, dirty_l, s_chg, any_r
            ent = pending.popleft()
            win = ent["win"]
            t1 = time.perf_counter()
            rep, ms_h, dl_h = ent["out"].wait()
            retire_s = time.perf_counter() - t1
            self.host_reads["flags"] += 1
            stats["windows"].append(int(rep[2]))
            k = win.K
            below_o, it_o, rdone, status = (int(x) for x in rep[:4])
            tb, rb, db, cb, bb = rep[4:].reshape(5, k)
            if rdone:
                DISPATCH_EVENTS.record_fused_window(rdone)
                it_r, run_total = iteration, total
                for r in range(rdone):
                    tier = int(tb[r])
                    if tier == 0:
                        it_r += unroll
                        delta = int(bb[r]) - run_total
                    elif tier == 1:
                        it_r += 1
                        delta = int(db[r])
                    else:
                        it_r += 1
                        delta = 0
                    run_total += delta
                    total = run_total
                    if win.graph is not None and tier != 2:
                        # a replay launches what the capture recorded
                        # (an uncaptured window's wrappers count
                        # themselves)
                        bitmatmul.add_launches(
                            win.launches[r][self._FUSED_TIERS[tier]]
                        )
                    rows = int(rb[r])
                    finish_round(
                        FrontierStats(
                            iteration=it_r,
                            tier=self._FUSED_TIERS[tier],
                            density=rows / max(self._sp_total_rows, 1),
                            rows_touched=rows,
                            total_rows=self._sp_total_rows,
                            derivations=delta,
                            overflow=False,
                            wall_s=(ent["dispatch_s"] + retire_s) / rdone,
                            dispatch_s=ent["dispatch_s"] / rdone,
                            retire_s=retire_s / rdone,
                            inflight=ent["inflight"],
                            rounds_in_window=rdone,
                        ),
                        bool(cb[r]),
                    )
            s_chg, dirty_l = ms_h, dl_h
            any_r = bool(dirty_l.any())
            below, iteration = below_o, it_o
            return status, rdone

        def replay_host_round():
            """One round of the per-round controller on the host
            frontier — the fallout escape."""
            nonlocal total, below, iteration, dirty_l, s_chg, any_r
            t0 = time.perf_counter()
            prev_total = total
            rows_touched, density, measure, over = self._sparse_round_plan(
                cfg, s_chg, dirty_l, any_r
            )
            below = below + 1 if density < cfg["density_threshold"] else 0
            want_sparse = iteration > 0 and below >= cfg["hysteresis_rounds"]
            if rows_touched == 0:
                iteration += 1
                tier, ch = "idle", False
            elif want_sparse and measure is not None:
                DISPATCH_EVENTS.record_sparse()
                ch, delta, s_chg, any_r, dirty_l = self._sparse_exec(
                    sp, rp, measure, dirty_l
                )
                total += delta
                iteration += 1
                tier = "sparse"
            else:
                carry = self._frontier_from_host(s_chg, dirty_l)
                _s, _r, ch, bits, fr = self._observe_round(sp, rp, carry)
                DISPATCH_EVENTS.record_dense()
                total = int(bits)
                dirty_l, s_chg = fr.dirty_l, fr.mask_s
                any_r = bool(dirty_l.any())
                iteration += unroll
                tier = "dense"
            finish_round(
                FrontierStats(
                    iteration=iteration,
                    tier=tier,
                    density=float(density),
                    rows_touched=rows_touched,
                    total_rows=self._sp_total_rows,
                    derivations=total - prev_total,
                    overflow=bool(tier == "dense" and want_sparse
                                  and measure is None and over),
                    wall_s=time.perf_counter() - t0,
                ),
                bool(ch),
            )

        while True:
            if converged:
                break  # drop still-speculative windows (idle no-ops)
            if pending:
                if len(pending) < depth:
                    # a speculative window on the last sync point's
                    # capacities: a wrong guess is a deterministic
                    # fallout, never a different round
                    dispatch_window(cur_caps, pick_k(), False)
                else:
                    status, rdone = retire_window()
                    if status == 2:
                        stats["fallouts"] += 1
                        stats["dropped"] += len(pending)
                        pending.clear()
                        replay_host_round()
                    elif status == 0 and rdone == 0:
                        # the budget was spent on the card
                        stats["dropped"] += len(pending)
                        pending.clear()
                        break
                continue
            if iteration >= budget:
                break
            # ---- the pipeline is drained: a sync point
            cur_caps = pick_caps()
            dispatch_window(cur_caps, pick_k(), True)
        # windows dropped behind a fallout or convergence ran no round:
        # the state pair holds the last retired round's state
        stats["dropped"] += len(pending)
        pending.clear()
        if sp is not sp_run:
            sp_run.copy_(sp)
            rp_run.copy_(rp)
        return sp_run, rp_run, iteration, total, converged

    # ------------------------------------------------ observed fixed point

    def _observe_round(self, sp, rp, fr):
        """One dense round of the observed loops: ``unroll`` gated
        steps in place, the last one folding the host carry.  Returns
        ``(sp, rp, changed, live_bits, frontier)`` with host values."""
        changed = False
        for i in range(self.unroll):
            sp, rp, fr = self.step(sp, rp, fr, carry=i == self.unroll - 1)
            changed |= fr.changed
        return sp, rp, changed, self.count_live_bits(sp, rp), fr

    def _saturate_adaptive(
        self, cfg, sp, rp, init_total, budget, observer, state_observer,
        frontier_observer, pipeline_depth: int = 1,
    ):
        """The dense/sparse controller loop, with pipelined dense rounds
        — the reference's ``_saturate_adaptive``, bookkeeping and all.
        Per retired round: measure density from the frontier the round
        consumed, track hysteresis, and pick the tier — dense (the
        regular ``unroll``-step round) above ``density_threshold`` or on
        workspace overflow; sparse (one frontier-compacted superstep,
        :meth:`_sparse_exec`) once ``hysteresis_rounds`` consecutive
        rounds measured below it (switching back is immediate).  The
        host carries the full frontier (changed-S mask, per-L-chunk
        dirty flags), so the tiers interleave freely; sparse rounds
        return the fold directly plus a live-bit delta.

        While nothing suggests a tier switch the controller keeps up to
        ``pipeline_depth`` dense rounds in flight, each chained on the
        previous round's state and frontier and run when it is
        dispatched; each retire replays the synchronous controller's
        pre-round measure (the host copies hold the PREVIOUS round's
        frontier, because retires happen in dispatch order), so
        per-round records match the synchronous controller's.  Sparse rounds need the host
        selection, so the pipeline drains before any tier switch: the
        decision acts on a frontier stale by at most the depth, which
        can delay a switch by up to depth-1 rounds and never changes
        what a round derives.  On convergence the ≤depth-1
        speculatively dispatched extra rounds are fixed-point no-ops:
        dropped unretired, outside the iteration/derivation accounting.
        A ``state_observer`` forces depth 1 (it reads the live state,
        which a speculative round would be rewriting in place)."""
        depth = max(int(pipeline_depth), 1)
        if state_observer is not None:
            depth = 1
        s_chg = np.ones(self.nc, bool)
        dirty_l = np.ones(self.n_lchunks, bool)
        any_r = True
        carry = self.initial_frontier()
        below = 0
        iteration, total, converged = 0, init_total, False
        dispatched = 0
        pending = deque()  # in-flight dense rounds, oldest first
        self.frontier_rounds = []

        def finish_round(st, changed):
            nonlocal converged
            FRONTIER_EVENTS.record(st)
            self.frontier_rounds.append(st)
            if frontier_observer is not None:
                frontier_observer(st)
            if observer is not None:
                observer(st.iteration, total - init_total, changed)
            if state_observer is not None:
                state_observer(
                    st.iteration, total - init_total, changed, sp, rp
                )
            if not changed:
                converged = True

        def dispatch_dense(plan):
            """Run and enqueue one dense round, chained on the newest
            in-flight round's frontier (on the host carry when none is
            in flight); ``plan`` is the pre-measured ``(rows_touched,
            density, overflow)`` when dispatched from the synchronous
            decision point, None when speculative (measured at retire
            instead)."""
            nonlocal sp, rp, dispatched
            t0 = time.perf_counter()
            fr = pending[-1]["out"][2] if pending else carry
            sp, rp, ch, bits, fr_next = self._observe_round(sp, rp, fr)
            dispatched += self.unroll
            DISPATCH_EVENTS.record_dense()
            pending.append({
                "out": (ch, bits, fr_next),
                "iteration": dispatched,
                "dispatch_s": time.perf_counter() - t0,
                "inflight": len(pending),
                "plan": plan,
            })

        def retire_dense():
            """Retire the oldest in-flight dense round: replay the
            synchronous pre-round measure if it was dispatched
            speculatively, and fold its frontier into the host
            copies."""
            nonlocal total, below, iteration, carry, dirty_l, s_chg, any_r
            ent = pending.popleft()
            if ent["plan"] is None:
                rows_touched, density, measure, over = (
                    self._sparse_round_plan(cfg, s_chg, dirty_l, any_r)
                )
                if density < cfg["density_threshold"]:
                    below += 1
                else:
                    below = 0
                over = bool(
                    below >= cfg["hysteresis_rounds"]
                    and measure is None and over
                )
            else:
                rows_touched, density, over = ent["plan"]
            t1 = time.perf_counter()
            ch, bits, fr = ent["out"]
            retire_s = time.perf_counter() - t1
            prev_total = total
            total = int(bits)
            carry = fr
            dirty_l = fr.dirty_l
            s_chg = fr.mask_s
            any_r = bool(dirty_l.any())
            iteration = ent["iteration"]
            finish_round(
                FrontierStats(
                    iteration=iteration,
                    tier="dense",
                    density=float(density),
                    rows_touched=rows_touched,
                    total_rows=self._sp_total_rows,
                    derivations=total - prev_total,
                    overflow=bool(over),
                    wall_s=ent["dispatch_s"] + retire_s,
                    dispatch_s=ent["dispatch_s"],
                    retire_s=retire_s,
                    inflight=ent["inflight"],
                ),
                bool(ch),
            )

        while True:
            if converged:
                break  # drop any still-speculative in-flight rounds
            if pending:
                # speculative regime: while nothing suggests a tier
                # switch, keep the queue full with dense rounds
                # chained on the previous round; otherwise retire
                # toward the next synchronous decision point
                if (
                    below < cfg["hysteresis_rounds"]
                    and dispatched < budget
                    and len(pending) < depth
                ):
                    dispatch_dense(None)
                else:
                    retire_dense()
                continue
            if iteration >= budget:
                break
            # ---- pipeline drained: the synchronous decision point
            t0 = time.perf_counter()
            prev_total = total
            rows_touched, density, measure, over = self._sparse_round_plan(
                cfg, s_chg, dirty_l, any_r
            )
            if density < cfg["density_threshold"]:
                below += 1
            else:
                below = 0
            want_sparse = (
                iteration > 0 and below >= cfg["hysteresis_rounds"]
            )
            use_sparse = want_sparse and measure is not None
            if rows_touched == 0:
                # empty frontier: either tier's step derives nothing
                # — emit the final no-change round without one
                iteration += 1
                dispatched = iteration
                finish_round(
                    FrontierStats(
                        iteration=iteration,
                        tier="idle",
                        density=float(density),
                        rows_touched=rows_touched,
                        total_rows=self._sp_total_rows,
                        derivations=0,
                        overflow=False,
                        wall_s=time.perf_counter() - t0,
                    ),
                    False,
                )
            elif use_sparse:
                DISPATCH_EVENTS.record_sparse()
                ch, delta, s_chg, any_r, dirty_l = self._sparse_exec(
                    sp, rp, measure, dirty_l
                )
                total += delta
                carry = self._frontier_from_host(s_chg, dirty_l)
                iteration += 1
                dispatched = iteration
                finish_round(
                    FrontierStats(
                        iteration=iteration,
                        tier="sparse",
                        density=float(density),
                        rows_touched=rows_touched,
                        total_rows=self._sp_total_rows,
                        derivations=total - prev_total,
                        overflow=False,
                        wall_s=time.perf_counter() - t0,
                    ),
                    bool(ch),
                )
            else:
                dispatch_dense((
                    rows_touched, density,
                    bool(want_sparse and measure is None and over),
                ))
        return sp, rp, iteration, total, converged

    def saturate_observed(
        self,
        max_iters: int = 10_000,
        *,
        observer=None,
        state_observer=None,
        initial: Optional[Tuple] = None,
        allow_incomplete: bool = False,
        sparse_tail=None,
        frontier_observer=None,
        pipeline=None,
        fused_rounds=None,
    ) -> SaturationResult:
        """Fixed point with per-round observation (the reference's
        progress plane).  ``observer(iteration, derivations_so_far,
        changed)`` after every retired round; ``state_observer`` also
        gets the live packed state (and forces the synchronous loop);
        ``frontier_observer`` each round's :class:`FrontierStats` (also
        kept in :attr:`frontier_rounds` and recorded into
        ``FRONTIER_EVENTS``, which puts them on a traced request's
        span).  Dense rounds are pipelined by default (``pipeline``:
        per-call override of the engine's ``{"enable", "depth"}``).

        ``sparse_tail``: per-call override of the engine's config; when
        active the adaptive controller (:meth:`_saturate_adaptive`)
        runs, else the plain observed loop, every round dense with
        density pinned at 1.0.  ``fused_rounds``: per-call override of
        the engine's ``{"enable", "rounds", "adaptive"}``; with K > 1,
        the sparse tier configured and no ``state_observer`` (which
        needs the live state of every round), the fused K-round window
        runs (:meth:`_saturate_fused`), else the per-round controller
        — the reference's routing.  The closure and ``derivations`` are
        :meth:`saturate`'s; ``iterations`` count ``unroll`` a dense round
        and one a sparse or idle round, as the reference's controller
        counts them.  On a mesh every path runs sharded (see the module
        docstring) and retires the solo run's rounds."""
        self.host_reads = {"flags": 0, "bits": 0}
        if initial is None:
            sp, rp = self.initial_state()
        else:
            sp, rp = self._embed_initial(initial)
            initial = None  # the embed copied it
        init_total = self.count_live_bits(sp, rp)
        budget = _pad_up(max_iters, self.unroll)
        cfg = (
            self._sparse_cfg
            if sparse_tail is None
            else self._normalize_sparse_cfg(sparse_tail)
        )
        pcfg = (
            self._pipeline_cfg
            if pipeline is None
            else self._normalize_pipeline_cfg(pipeline)
        )
        pdepth = pcfg["depth"] if pcfg["enable"] else 1
        kcfg = (
            self._fused_cfg
            if fused_rounds is None
            else self._normalize_fused_cfg(fused_rounds)
        )
        fk = int(kcfg["rounds"]) if kcfg else 1
        self.gate_rounds = []
        if (
            fk > 1
            and cfg is not None
            and self._sparse_supported()
            and state_observer is None
        ):
            sp, rp, iteration, total, converged = self._saturate_fused(
                cfg, fk, sp, rp, init_total, budget, observer,
                frontier_observer, pipeline_depth=pdepth,
                adaptive=bool(kcfg.get("adaptive")),
            )
        elif cfg is not None and self._sparse_supported():
            sp, rp, iteration, total, converged = self._saturate_adaptive(
                cfg, sp, rp, init_total, budget, observer,
                state_observer, frontier_observer, pipeline_depth=pdepth,
            )
        else:
            self.frontier_rounds = []
            box = [None]   # the frontier carried from round to round

            def observe_step(s, r):
                s, r, ch, bits, box[0] = self._observe_round(s, r, box[0])
                return s, r, ch, bits

            def round_stats(it, delta, changed, dispatch_s, retire_s,
                            inflight):
                # dense-tier telemetry from the plain path: no host
                # measure runs here, so density reports the dense sweep
                # itself (every rule-table row re-evaluated)
                st = FrontierStats(
                    iteration=it,
                    tier="dense",
                    density=1.0,
                    rows_touched=self._sp_total_rows,
                    total_rows=self._sp_total_rows,
                    derivations=delta,
                    wall_s=dispatch_s + retire_s,
                    dispatch_s=dispatch_s,
                    retire_s=retire_s,
                    inflight=inflight,
                )
                FRONTIER_EVENTS.record(st)
                self.frontier_rounds.append(st)
                if frontier_observer is not None:
                    frontier_observer(st)

            sp, rp, iteration, total, converged = observed_loop(
                observe_step, sp, rp, init_total, self.unroll, budget,
                observer, state_observer=state_observer,
                pipeline_depth=pdepth, round_stats=round_stats,
            )
        if not converged and not allow_incomplete:
            raise RuntimeError(
                f"saturation did not converge within {budget} iterations"
            )
        return self._result(sp, rp, iteration, total - init_total, converged)
