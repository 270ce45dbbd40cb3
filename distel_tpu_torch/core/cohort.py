"""Cross-tenant cohort execution: one batched step program advances N
same-bucket tenants.

The port of ``distel_tpu/core/cohort.py``.  The steady-delta path pays
one run of its step programs per tenant, although tenants of one bucket
share those programs (``core/bucketing.py``).  A cohort stacks their
packed states along a leading lane axis and runs one *cohort program*
per round-robin position: the bucketed step with every table stacked
``[R, ...]``, the frontier carries ``ms [R, nc]`` and ``dl [R,
lchunk_slots]``, the flags ``[R, 1 + 5·unroll]``, and on a card one CUDA
graph of one ``unroll`` group for all lanes.  The row rules (CR1-CR3
seg-OR, CR5) run on the state flattened to ``[R·nc, wc]`` with
lane-offset indices; the CR4/CR6 window slots go through the batched
row-count kernels (``PackedColsMatmulPlan.batched_rows``: one launch
contracts a slot for every lane, each lane with its own row count, 0
when its window is clean), by the route the solo plan picks for one
lane.  So a cohort group launches what one solo group launches.

Why a cohort run equals the solo runs, byte for byte:

* a bucketed step is a pure function of its signature and its tables
  (``core/bucketing.py``); lanes are independent (every index is offset
  into its own lane), so each lane computes its solo step;
* every lane of a vote starts together under the same budget, as the
  solo vote does: the embed (``S |= {X, ⊤}``, R kept) and the full
  frontier.  A lane that converges early rides as a fixed-point no-op
  (its frontier is empty, so its windows contract 0 rows and its row
  rules derive nothing); only its host counters freeze, at the group
  where its solo run would have stopped;
* cohort sizes pad to a power-of-two ladder (:func:`cohort_rung`; pad
  lanes repeat the last live tenant and are discarded), so a cohort
  program is a function of ``(bucket_signature, rung)``: registry-shared
  under ``(bucket_signature, "cohort_run", budget, rung)`` (the port's
  program does not depend on the budget; the key keeps the reference's
  shape) and warmed by ``core/incremental.warm_delta_programs``.

The stacked state is a state pair per (layout, rung)
(``bucketing.state_pair(..., lanes=rung)``), shared by every cohort
program of that layout and rung: a graph keeps the addresses it was
captured on, and all roster positions of a vote sequence work on one
stacked state, under the pair's lock from copy-in to copy-out.

:func:`execute_delta_cohort` replays the incremental fast path's
round-robin joint fixed point (``IncrementalClassifier.
_execute_delta_plan``) with one cohort run per vote: every tenant runs
the vote sequence it would run solo, with its iterations, streaks and
retirement kept per lane, so closures, iteration counts and history
records equal solo execution of the same plans.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from distel_tpu_torch.core import bucketing
from distel_tpu_torch.core.engine import SaturationResult, live_bits
from distel_tpu_torch.core.indexing import BOTTOM_ID, TOP_ID
from distel_tpu_torch.core.program_cache import PROGRAMS
from distel_tpu_torch.ops.bitpack import (
    or_into_rows,
    or_reduce,
    or_reduce_any,
)
from distel_tpu_torch.runtime.instrumentation import (
    COHORT_EVENTS,
    CompileStats,
    library_loads,
)


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m



def cohort_rung(n: int) -> int:
    """Smallest power of two >= ``n`` — the cohort-size ladder: a cohort
    of 3 pads to 4, of 5 to 8, and every rung's program is shared by
    all cohorts that quantize to it."""
    if n < 1:
        raise ValueError(f"cohort needs at least one member, got {n}")
    r = 1
    while r < n:
        r <<= 1
    return r


def cohort_ready(engine) -> bool:
    """Whether ``engine``'s programs can run under a cohort: a
    shape-bucketed row-packed engine (an exact engine's program holds
    its own ontology's plan, so stacking other tenants under it would
    be unsound) on a single device: the cohort program has no sharded
    form, as the reference's has none."""
    from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine

    return (
        isinstance(engine, RowPackedSaturationEngine)
        and engine.mesh is None
        and bool(getattr(engine, "_bucket", False))
    )


# ------------------------------------------------------ the cohort step

def _offsets(struct: bucketing.BucketStruct) -> dict:
    """Per index table, the lane stride its entries are offset by (the
    rows of the axis it indexes), so lanes index their own rows of the
    flattened state, frontier and accumulators."""
    nc, nl, nlc = struct.nc, struct.nl, struct.lchunk_slots
    off = {"src1": nc, "src2a": nc, "src2b": nc, "src3": nc, "t1": nc,
           "t2": nc, "t3": nl, "lchunk": nlc}
    for key, rs, state in (("4", struct.cr4, nc), ("6", struct.cr6, nl)):
        if rs is None:
            continue
        off.update({f"src{key}": state, f"tsort{key}": state,
                    f"perm{key}": rs.rows, f"send{key}": rs.rows,
                    f"wlink{key}": nl, f"wc0{key}": nlc, f"wc1{key}": nlc})
    if struct.cr6 is not None:
        off["lch6"] = nlc
    return off


def _reduce_lanes(rows: torch.Tensor, buckets) -> torch.Tensor:
    """``reduce_segments`` per lane: rows [R, k, W] → [R·segments, W]."""
    R, _k, W = rows.shape
    outs, pos = [], 0
    for blen, nseg in buckets:
        chunk = rows[:, pos : pos + nseg * blen]
        pos += nseg * blen
        if blen == 1:
            outs.append(chunk)
        else:
            outs.append(or_reduce(chunk.reshape(R, nseg, blen, W), 2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(-1, W)


class _CohortStep(bucketing._Step):
    """The bucketed superstep over ``R`` lanes: the solo step's body
    (``bucketing._Step``: its rules in its order, on the state flattened
    over the lanes, every index offset into its lane) with three parts
    of its own: the seg-OR per lane, each CR4/CR6 window slot one
    batched row-count call for all lanes, and CR5 per lane.  Temporaries
    of the row rules and CR5 stay within the solo step's budget (their
    blocks are ``R`` times narrower); the CR4/CR6 accumulators are one
    chunk per lane."""

    def __init__(self, struct, T: dict, device, lanes: int):
        super().__init__(struct, T, device)
        self.R = lanes
        self.lead = (lanes,)
        wb = max(struct.word_block // lanes, 1)
        n_blocks = -(-struct.wc // wb)
        self.word_block = -(-struct.wc // n_blocks)
        self.cr5_rows = max(struct.temp_budget // (4 * struct.wc * lanes), 1)
        self.bottom_lanes = (
            torch.arange(lanes, device=device) * struct.nc + BOTTOM_ID
        )

    def _reduce(self, rows, buckets):
        return _reduce_lanes(rows.view(self.R, -1, rows.shape[-1]), buckets)

    def contract(self, key, rs, bits_state, rp, target, flags, dl, cvs):
        """One CR4/CR6 table over every lane, chunk by chunk (each written
        before the next reads); each window slot one batched row-count
        call for all lanes.  ``bits_state``, ``rp``, ``target`` and
        ``dl`` are flattened over the lanes, ``flags`` is [R, chunks].
        Returns each lane's live and valid slot counts."""
        T, R, wc = self.T, self.R, self.s.wc
        RK = rs.rows
        wval = T["wval" + key]
        live = (flags[:, :, None] | dl[T["wc0" + key]]
                | dl[T["wc1" + key]]) & wval                 # [R, C, NW]
        n_rows = (live.to(torch.int32) * T["rk" + key][:, :, None]) \
            .permute(1, 2, 0).contiguous()                   # [C, NW, R]
        plan, pos = self.plans[key], self.pos[key]
        fillers, roles = T["fillers"].view(-1), T["link_roles"].view(-1)
        lane_w = (torch.arange(R, device=rp.device) * wc)[:, None]
        for c in range(rs.chunks):
            subt = bits_state[T["src" + key][:, c]].transpose(1, 2) \
                .reshape(R * wc, RK)                          # lanes' [wc, RK]
            mask = T["m" + key][:, c]                         # [R, RK, nr]
            acc = torch.zeros((R, RK, wc), dtype=torch.int32, device=rp.device)
            for j in range(rs.slots):
                ids = T["wlink" + key][:, c, j]               # [R, LW]
                cols = fillers[ids]
                words = subt[(cols >> 5) + lane_w]            # [R, LW, RK]
                f = ((words >> (cols & 31).to(torch.int32)[:, :, None]) & 1) \
                    .to(torch.int8)
                m = torch.gather(mask, 2, roles[ids][:, None, :]
                                 .expand(R, RK, ids.shape[1]))
                w = m * (f.transpose(1, 2)
                         * T["wlval" + key][:, c, j][:, None, :])
                plan.batched_rows(w.contiguous(), rp[ids], acc, n_rows[c, j])
            x = acc.view(R * RK, wc)[T["perm" + key][:, c].reshape(-1)] \
                .view(R, RK, wc)
            start = T["sstart" + key][:, c]
            step = 1
            while step < (1 << rs.passes):
                ok = (pos[step:] - step)[None, :] >= start[:, step:]
                x = torch.cat([x[:, :step],
                               x[:, step:] | torch.where(ok[:, :, None],
                                                         x[:, :-step], 0)], 1)
                step *= 2
            t = T["tsort" + key][:, c].reshape(-1)
            x = x.reshape(R * RK, wc)[T["send" + key][:, c].reshape(-1)]
            cvs.append((t, or_into_rows(target, t, x)))
        return live.sum((1, 2)), wval.sum((1, 2))

    def cr5(self, sp3, rp3, ms, dl, s_cvs):
        s, T, R = self.s, self.T, self.R
        fill = T["fillers"]                                   # [R, nl]
        bot = sp3[:, BOTTOM_ID]                               # [R, wc]
        words = torch.gather(bot, 1, fill >> 5)
        botf = ((words >> (fill & 31).to(torch.int32)) & 1).to(torch.bool)
        red = torch.zeros((R, s.wc), dtype=torch.int32, device=sp3.device)
        for i in range(0, s.nl, self.cr5_rows):
            j = i + self.cr5_rows
            masked = torch.where(botf[:, i:j, None], rp3[:, i:j], 0)
            red |= or_reduce_any(masked, 1)
        if s.gate_cr5:
            run = dl.any(dim=1) | ms[:, BOTTOM_ID]
            red = red * run.to(torch.int32)[:, None]
        else:
            run = torch.ones(R, dtype=torch.bool, device=sp3.device)
        old = bot.clone()
        sp3[:, BOTTOM_ID] |= red
        s_cvs.append((self.bottom_lanes, (sp3[:, BOTTOM_ID] != old).any(dim=1)))
        return run


class CohortProgram(bucketing.BucketProgram):
    """A bucket's step group over ``rung`` lanes: the stacked tables
    (index tables offset into their lane's rows), the carries ``ms``
    [rung, nc] and ``dl`` [rung, lchunk_slots], the flags [rung, 1 +
    5·unroll], the cohort state pair of its layout and rung, and on a
    card the CUDA graph of one group for all lanes.  Counted by
    ``bucketing.program_bytes`` and dropped by ``drop_idle_programs``
    as the solo programs are (no engine holds a cohort program)."""

    def __init__(self, struct: bucketing.BucketStruct, shapes: dict,
                 rung: int, device):
        self.rung = int(rung)
        super().__init__(struct, shapes, device, lanes=self.rung)
        self.offsets = _offsets(struct)

    def _new_step(self) -> _CohortStep:
        return _CohortStep(self.struct, self.T, self.device, self.rung)

    @classmethod
    def from_spec(cls, spec: dict, device) -> "CohortProgram":
        """The program a cohort spec (``program_spec`` with its
        ``cohort`` record) describes, on ``device`` (not captured)."""
        struct, shapes = bucketing.spec_parts(spec)
        return cls(struct, shapes, int(spec["cohort"]["rung"]), device)

    def load(self, lanes: Sequence[dict]) -> None:
        """Each lane's table content (``lanes[i]``: an engine's
        ``bucket_tables()``) into its slice of the stacked buffers, the
        index tables offset into the lane's rows."""
        if len(lanes) != self.rung:
            raise ValueError(f"{len(lanes)} lanes for a rung-{self.rung} program")
        for i, tabs in enumerate(lanes):
            for k, v in tabs.items():
                dst = self.T[k][i]
                dst.copy_(torch.from_numpy(np.ascontiguousarray(v)))
                if i and k in self.offsets:
                    dst += i * self.offsets[k]


def cohort_run_exe(leader, rung: int, budget: int):
    """The cohort program of ``leader``'s bucket at ``rung`` lanes, from
    :data:`PROGRAMS` under ``(bucket_signature, "cohort_run", budget,
    rung)`` (built, and on a card captured, on a miss).  Returns
    ``(program, CompileStats)``: ``trace_lower_s`` the buffer build,
    ``compile_s`` the capture, ``program_cache_hit`` whether this lookup
    hit the registry (both seconds 0.0 then)."""
    if not cohort_ready(leader):
        raise ValueError(
            "cohort programs need a single-device shape-bucketed engine"
        )
    stats = CompileStats(
        bucket_signature=leader.bucket_signature,
        program=f"cohort_run[{rung}x{budget}]",
    )
    struct, tabs = leader._bstruct, leader.bucket_tables()
    device = leader.device

    def build():
        with library_loads(stats):
            t0 = time.perf_counter()
            prog = CohortProgram(struct, bucketing.table_shapes(tabs), rung,
                                 device)
            t1 = time.perf_counter()
            if prog.device.type == "cuda":
                prog.capture()
            stats.trace_lower_s = t1 - t0
            stats.compile_s = time.perf_counter() - t1
        return prog

    key = (leader.bucket_signature, "cohort_run", int(budget), int(rung))
    prog, hit = PROGRAMS.get_or_build(key, build)
    stats.program_cache_hit = hit
    leader._note_compile(stats)
    return prog, stats


def cohort_embed(sp3: torch.Tensor) -> None:
    """The solo vote's embed on every lane in place: ``S |= {X, ⊤}`` (the
    diagonal and a full ⊤ row; R is kept as it is)."""
    nc = sp3.shape[1]
    dev = sp3.device
    rows = torch.arange(nc, device=dev)
    bit = torch.from_numpy(
        (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    ).to(dev)
    sp3[:, rows, rows >> 5] |= bit[rows & 31]
    sp3[:, TOP_ID] = -1


def cohort_embed_count(sp3, rp3, wmasks: Sequence[torch.Tensor],
                       n: int) -> List[int]:
    """The batched embed + count: embed every lane, then the live-bit
    totals of the first ``n`` lanes under each lane's live-column mask,
    read in one host read (the cohort's counterpart of the solo loop's
    ``count_live_bits`` bracketing)."""
    cohort_embed(sp3)
    return cohort_count(sp3, rp3, wmasks, n)


def cohort_count(sp3, rp3, wmasks, n: int) -> List[int]:
    """Live-bit totals of the first ``n`` lanes, one host read."""
    tot = torch.stack([live_bits(sp3[i], rp3[i], wmasks[i]).sum()
                       for i in range(n)])
    return [int(v) for v in tot.cpu().tolist()]


def delta_cohort_ready(inc, plan) -> bool:
    """Whether one tenant's planned increment can join a cohort:
    bucketed delta programs, a bucketed roster, and a packed closure in
    the base layout on the base's device (the stacking precondition — a
    host or differently shaped state takes the solo path)."""
    if plan is None or not plan.bucketed:
        return False
    if not all(cohort_ready(e) for e in plan.engines):
        return False
    state = inc._state
    if state is None:
        return False
    sp, rp = state
    base = plan.base
    return (
        isinstance(sp, torch.Tensor)
        and isinstance(rp, torch.Tensor)
        and sp.dtype == torch.int32
        and base._on_device(sp)
        and tuple(sp.shape) == (base.nc, base.wc)
        and tuple(rp.shape) == (base.nl, base.wc)
    )


class CohortDoesNotFit(RuntimeError):
    """Forming the cohort would need more device memory than is free
    (or than the caller's budget leaves); raised before any member's
    state moves, so every member can run solo."""


def free_bytes(device) -> Optional[int]:
    """Bytes a new allocation on ``device`` can take: the card's free
    memory plus what PyTorch's caching allocator holds unused; None off
    a card (host memory is not budgeted here)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev)
               - torch.cuda.memory_allocated(dev))


def execute_delta_cohort(
    members: Sequence[Tuple[object, object, object]],
    max_iters: Optional[int] = None,
    spare_bytes: Optional[Callable[[], Optional[int]]] = None,
) -> List[SaturationResult]:
    """Advance N tenants' planned increments together and complete each.

    ``members``: ``(classifier, plan, batch)`` triples — ingested and
    planned (``_ingest`` + ``_delta_fast_plan``) but not executed, all
    :func:`delta_cohort_ready` with EQUAL ``plan.roster_key()`` (the
    caller groups; this function checks).  One cohort run per joint
    vote; each member's closure, iteration count and history record
    equal solo execution of its plan; each member's ``last_cohort`` is
    the cohort's record (size, rung, votes, each vote's wall — tables
    in, embed, groups, the host reading the flags once a group — and
    each position's program: signature, capture seconds, card bytes).
    Returns the per-member results in order.

    Memory: the roster's cohort programs (with their stacked state
    pair) are built first; then the members' closures, copied out of
    the pair at the end, must fit the card's free memory
    (:func:`free_bytes`) and ``spare_bytes()`` (a caller's budget, None
    = unbounded), else :class:`CohortDoesNotFit` is raised with no
    state moved.  A member's closure is replaced only when the cohort
    completes: after any failure every member keeps its pre-delta
    closure (its axioms stay ingested, so its next increment's fast
    path derives them)."""
    if len(members) < 2:
        raise ValueError("a cohort needs at least 2 members")
    incs = [m[0] for m in members]
    plans = [m[1] for m in members]
    key0 = plans[0].roster_key()
    for inc, plan in zip(incs, plans):
        if plan.roster_key() != key0:
            raise ValueError(
                "cohort members must share one roster key "
                f"({plan.roster_key()} != {key0})"
            )
        if not delta_cohort_ready(inc, plan):
            raise ValueError("member not cohort-ready (stale grouping?)")
    n = len(members)
    rung = cohort_rung(n)
    pad = rung - n
    k = len(plans[0].engines)
    if max_iters is None:
        max_iters = incs[0].config.max_iterations
    for inc in incs:
        inc.last_compile = None
        inc.last_delta_stats = None
        inc.last_cohort = None
    # every position's cohort program, before any state moves (pad lanes
    # repeat the last live tenant's tables)
    progs, builds, budgets = [], [], []
    for pos in range(k):
        lead = plans[0].engines[pos]
        budget = _pad_up(max_iters, lead.unroll)
        prog, stats = cohort_run_exe(lead, rung, budget)
        progs.append(prog)
        builds.append(stats)
        budgets.append(budget)
    pair = progs[0].pair
    if any(p.pair is not pair for p in progs):
        raise AssertionError("a roster's cohort programs hold different pairs")
    need = n * (pair.nbytes // rung)  # the members' copied-out closures
    for room in (free_bytes(pair.sp.device),
                 spare_bytes() if spare_bytes is not None else None):
        if room is not None and need > room:
            raise CohortDoesNotFit(
                f"a cohort of {n} needs {need} more bytes, {room} spare"
            )
    wmasks = [p.engines[0]._wmask for p in plans]
    iters = [0] * n
    streaks = [0] * n
    votes = 0
    with pair.lock:
        # stack the tenants' closures (a pad lane copies the last one)
        for i in range(rung):
            sp, rp = incs[min(i, n - 1)]._state
            pair.sp[i].copy_(sp)
            pair.rp[i].copy_(rp)
        start = cohort_embed_count(pair.sp, pair.rp, wmasks, n)
        ei = 0
        walls = []
        while min(streaks) < k:
            t0 = time.perf_counter()
            pos = ei % k
            ei += 1
            prog = progs[pos]
            engines = [p.engines[pos] for p in plans]
            tabs = [e.bucket_tables() for e in engines]
            prog.load(tabs + [tabs[-1]] * pad)
            cohort_embed(pair.sp)
            prog.ms.fill_(True)
            prog.dl.copy_(prog.T["dl_valid"])
            live = [i for i in range(n) if streaks[i] < k]
            its = _run_vote(prog, live, budgets[pos])
            walls.append(time.perf_counter() - t0)
            votes += 1
            COHORT_EVENTS.record_cohort(size=len(live), rung=rung)
            for i in live:
                iters[i] += its[i]
                unproductive = its[i] <= engines[i].unroll
                streaks[i] = streaks[i] + 1 if unproductive else 0
        final = cohort_count(pair.sp, pair.rp, wmasks, n)
        states = [(pair.sp[i].clone(), pair.rp[i].clone()) for i in range(n)]
    run = {
        "size": n, "rung": rung, "votes": votes, "vote_walls_s": walls,
        "programs": [{"bucket_signature": st.bucket_signature,
                      "capture_s": p.capture_s, "card_bytes": p.nbytes,
                      "graph_bytes": p.graph_bytes,
                      "hit": st.program_cache_hit}
                     for p, st in zip(progs, builds)],
        "pair_bytes": pair.nbytes,
    }

    # program cost: the build (if any) is charged to member 0; later
    # members ride programs that were registry-resident by then
    all_hit = all(st.program_cache_hit for st in builds)
    results = []
    for i, (inc, plan, batch) in enumerate(members):
        agg = CompileStats(bucket_signature=plan.base.bucket_signature,
                           program="cohort-delta-programs")
        if i == 0:
            for st in builds:
                agg.trace_lower_s += st.trace_lower_s
                agg.compile_s += st.compile_s
                agg.persistent_cache_hits += st.persistent_cache_hits
                agg.persistent_cache_misses += st.persistent_cache_misses
        agg.program_cache_hit = all_hit if i == 0 else True
        inc.last_compile = agg
        inc.last_cohort = run
        inc.last_delta_stats = {
            "delta_bucketed": True,
            # cohort variants of every roster position, base included
            "delta_programs": len(builds),
            "delta_program_hits": (
                sum(bool(st.program_cache_hit) for st in builds)
                if i == 0 else len(builds)
            ),
            "delta_signature": plan.engines[0].bucket_signature,
            "cohort_size": n,
            "cohort_rung": rung,
            "cohort_dispatches": votes,
        }
        sp, rp = states[i]
        states[i] = None
        result = SaturationResult(
            packed_s=sp,
            packed_r=rp,
            iterations=iters[i],
            derivations=final[i] - start[i],
            idx=plan.idx,
            converged=True,
            transposed=True,
        )
        results.append(inc._finish_increment(batch, result, "cohort"))
    COHORT_EVENTS.record_deltas(n)
    return results


def _run_vote(prog: CohortProgram, live: List[int], budget: int) -> dict:
    """One joint vote: groups of the cohort program (one host read of
    the flags each) until no live lane changed or the budget is spent.
    Returns each live lane's iterations — ``unroll`` per group up to and
    including its first quiet one, as its solo run counts them."""
    unroll = prog.struct.unroll
    its = {}
    active = list(live)
    it = 0
    while active and it < budget:
        flags = prog.run()
        it += unroll
        still = []
        for i in active:
            if flags[i, 0]:
                still.append(i)
            else:
                its[i] = it
        active = still
    if active:
        raise RuntimeError(
            f"saturation did not converge within {budget} iterations"
        )
    return its


def warm_cohort_programs(engines, sizes: Sequence[int],
                         max_iters: int) -> List[dict]:
    """Build the cohort programs of an engine roster at the given cohort
    sizes (quantized to the power-of-two ladder), so even the first
    cohort a restarted process forms builds nothing.  Returns one
    record per (engine, rung) program."""
    out = []
    rungs = sorted({cohort_rung(int(s)) for s in sizes if int(s) >= 2})
    for eng in engines:
        if not cohort_ready(eng):
            continue
        budget = _pad_up(max_iters, eng.unroll)
        for rung in rungs:
            _prog, stats = cohort_run_exe(eng, rung, budget)
            rec = stats.as_dict()
            rec["rung"] = rung
            out.append(rec)
    return out
