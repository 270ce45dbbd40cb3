"""Per-phase wall-clock tracing and the process-wide aggregates the
serve plane exports.

The port of ``distel_tpu/runtime/instrumentation.py``'s jax-free part.
What differs from the reference, and why:

* :class:`PhaseTimer` is the port's own: it synchronises the card at
  each phase boundary, so that device work lands in the phase that
  issued it (the reference's XLA dispatch blocks where its results are
  read instead).  The synchronisation is device-wide: with several
  scheduler workers on one card, a phase also waits for the work the
  other workers queued.  As in the reference, a phase run under a
  traced request also lands as a child span.
* :class:`FrontierStats` (the per-round record of the observed fixed
  point), :class:`PhaseAggregate` and the process aggregates
  (:data:`FRONTIER_EVENTS`, :data:`STEP_RULE_EVENTS`,
  :data:`COHORT_EVENTS`, :data:`DISPATCH_EVENTS`) are the reference's.
  The observed loops (``core/engine.py``, ``core/rowpacked_engine.py``)
  record into :data:`FRONTIER_EVENTS` and :data:`DISPATCH_EVENTS`, the
  cohort plane into :data:`COHORT_EVENTS`, and a profiled saturation
  (``runtime/profiling.py``) into :data:`STEP_RULE_EVENTS`.
* :func:`rule_scope` is the port's counterpart of the reference's
  ``jax.named_scope`` around each rule: a ``torch.profiler`` scope
  while a profiler records, nothing otherwise.
* :class:`CompileStats` keeps the reference's fields for the port's
  program builds; its persistent-cache counters count the kernel
  libraries a build loaded — found built (an artifact farm's, or an
  earlier process's) or built by ``nvcc`` — read from
  ``ops/build.CACHE_EVENTS`` (:func:`library_loads`).  The reference's
  ``compile_watch`` and ``trace_to`` capture XLA compilation, which the
  port does not have, so they are not ported.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from distel_tpu_torch.obs import trace as _obs_trace


@dataclass
class PhaseTimer:
    """Wall seconds per named phase (synchronising the card at each
    phase boundary, so device work lands in the phase that issued it)."""

    device: torch.device
    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        # when the calling thread carries a trace span (a traced serve
        # request), each phase also lands as a child span — one
        # thread-local read when untraced, nothing more
        obs_sp = _obs_trace.active_span()
        wall0 = time.time() if obs_sp is not None else 0.0
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if obs_sp is not None:
                _obs_trace.add_phase_span(obs_sp, name, wall0, dt)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1000:.1f}ms" for k, v in self.phases.items())


class PhaseAggregate:
    """Aggregate many :class:`PhaseTimer` runs (or ad-hoc phase
    observations) into per-phase ``count / total_s / max_s`` — the
    bridge from the one-shot classify() tracer to a *resident* service's
    counters.  The serve plane times every request's pipeline stages
    (queue wait, saturate, taxonomy, ...) with a ``PhaseTimer``, absorbs
    it here, and renders the aggregate as Prometheus summaries
    (``distel_tpu/serve/metrics.py``).  Thread-safe: absorbed from
    concurrent scheduler workers."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        #: phase name → [count, total seconds, max seconds]
        self._phases: Dict[str, List[float]] = {}

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            acc = self._phases.setdefault(name, [0, 0.0, 0.0])
            acc[0] += 1
            acc[1] += seconds
            acc[2] = max(acc[2], seconds)

    def absorb(self, timer: PhaseTimer, prefix: str = "") -> None:
        """Fold one finished timer's phases in (each phase counts once:
        the timer already sums re-entries)."""
        for name, total in timer.phases.items():
            self.observe(prefix + name, total)

    def snapshot(self) -> Dict[str, dict]:
        """{phase: {count, total_s, max_s}} — a consistent copy."""
        with self._lock:
            return {
                name: {
                    "count": int(c),
                    "total_s": t,
                    "max_s": mx,
                }
                for name, (c, t, mx) in self._phases.items()
            }


@dataclass
class CompileStats:
    """One program build's cost, with the reference's fields.  In the
    port a program is a shape-bucketed engine's step group or fused
    window (``core/rowpacked_engine.py``): ``trace_lower_s`` is the host
    build of its argument tables at rung shapes, ``compile_s`` its CUDA
    graph capture (on the CPU, where nothing is captured, the eager
    program's allocation); both are 0.0 on a registry hit
    (``program_cache_hit``: the process-global ``PROGRAMS`` served the
    program).  ``persistent_cache_hits`` / ``_misses`` count the
    kernel libraries the build loaded found built / built by ``nvcc``
    (:func:`library_loads`); 0 once a process has loaded them."""

    bucket_signature: str = ""
    program: str = ""
    trace_lower_s: float = 0.0
    compile_s: float = 0.0
    program_cache_hit: bool = False
    persistent_cache_hits: int = 0
    persistent_cache_misses: int = 0

    def as_dict(self) -> dict:
        return {
            "bucket_signature": self.bucket_signature,
            "program": self.program,
            "trace_lower_s": round(self.trace_lower_s, 4),
            "compile_s": round(self.compile_s, 4),
            "program_cache_hit": self.program_cache_hit,
            "persistent_cache_hits": self.persistent_cache_hits,
            "persistent_cache_misses": self.persistent_cache_misses,
        }

    def merge(self, other: "CompileStats") -> "CompileStats":
        """Fold another program's build into this record (an engine
        builds several programs; callers report one total)."""
        self.trace_lower_s += other.trace_lower_s
        self.compile_s += other.compile_s
        self.program_cache_hit = self.program_cache_hit or other.program_cache_hit
        self.persistent_cache_hits += other.persistent_cache_hits
        self.persistent_cache_misses += other.persistent_cache_misses
        return self


@contextlib.contextmanager
def library_loads(stats: CompileStats):
    """Add the kernel-library lookups made inside the block to
    ``stats``'s persistent-cache counters (``ops/build.CACHE_EVENTS``:
    a library found built is a hit, an ``nvcc`` run a miss)."""
    from distel_tpu_torch.ops.build import CACHE_EVENTS

    before = CACHE_EVENTS.snapshot()
    try:
        yield stats
    finally:
        after = CACHE_EVENTS.snapshot()
        stats.persistent_cache_hits += after["hits"] - before["hits"]
        stats.persistent_cache_misses += after["misses"] - before["misses"]


@dataclass
class FrontierStats:
    """One saturation round's frontier record — the telemetry the
    adaptive sparse-tail controller (``RowPackedSaturationEngine.
    saturate_observed``) is steered by and reports.  ``rows_touched``
    is the number of rule-table rows the round actually had to
    re-evaluate (row granularity throughout: CR1-CR3 on the changed-S
    mask + intra-step cascade, CR4/CR6 on changed bit-table sources
    and dirty-L-chunk role coverage); ``density`` is that count over
    the total rule-table rows, the signal the dense/sparse tier
    decision thresholds on.  ``tier`` records what actually ran
    ("dense" | "sparse", or "idle" for the empty-frontier termination
    round, where NO step runs — idle rounds count toward neither tier
    total); ``overflow`` marks a round whose active set exceeded the
    largest sparse workspace rung, forcing the dense fallback.

    Pipelined observation splits the round's blocking host time:
    ``dispatch_s`` is the cost of enqueueing the round's dense step on
    the pipeline's worker, ``retire_s`` the later blocking fetch+fold
    of its results, and ``wall_s`` their sum — the HOST time the round
    cost, which under pipelining is less than the round's wall-clock
    (the worker's rounds overlap other rounds' host work).
    ``inflight`` is the pipeline occupancy when the round was
    dispatched (0 = synchronous dispatch — sparse and idle rounds are
    always 0).  Threaded through the run ledger's round records and
    the serve plane's ``/metrics`` gauges (via
    :data:`FRONTIER_EVENTS`)."""

    iteration: int = 0
    tier: str = "dense"
    density: float = 1.0
    rows_touched: int = 0
    total_rows: int = 0
    derivations: int = 0
    overflow: bool = False
    wall_s: float = 0.0
    dispatch_s: float = 0.0
    retire_s: float = 0.0
    inflight: int = 0
    #: how many retired rounds the surfacing that produced this stat
    #: covered: 1 for the per-round controllers, the rounds a fused
    #: K-round window retired for each of its rounds (whose walls are the
    #: window's split evenly); ledger consumers divide by it
    rounds_in_window: int = 1

    def as_dict(self) -> dict:
        return {
            "iteration": self.iteration,
            "tier": self.tier,
            "density": round(self.density, 5),
            "rows_touched": self.rows_touched,
            "total_rows": self.total_rows,
            "derivations": self.derivations,
            "overflow": self.overflow,
            "wall_s": round(self.wall_s, 4),
            "dispatch_s": round(self.dispatch_s, 4),
            "retire_s": round(self.retire_s, 4),
            "inflight": self.inflight,
            "rounds_in_window": self.rounds_in_window,
        }


class FrontierAggregate:
    """Process-global tally of sparse-tail controller rounds — the
    bridge from per-run :class:`FrontierStats` to a resident service's
    gauges (``serve/server.py`` registers ``distel_frontier_*`` from
    :data:`FRONTIER_EVENTS`).  Thread-safe: concurrent classify calls
    may each run a controller."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.dense_rounds = 0
        self.sparse_rounds = 0
        self.overflow_rounds = 0
        self.last_density = 1.0
        self.last_rows_touched = 0
        #: pipelined-observation telemetry: occupancy of the speculative
        #: dispatch queue when the last round went out, and the
        #: cumulative blocking host seconds split dispatch/retire (the
        #: overlap win is wall-clock minus their sum)
        self.last_inflight = 0
        self.pipelined_rounds = 0
        self.dispatch_seconds = 0.0
        self.retire_seconds = 0.0

    def record(self, st: "FrontierStats") -> None:
        # a traced request's rounds also land as span events on the
        # recording thread's active span (the adaptive/observed
        # controllers record from the thread that ran the classify, so
        # the scheduler's lane-exec span is active here)
        _obs_trace.add_round_event(st)
        with self._lock:
            if st.tier == "sparse":
                self.sparse_rounds += 1
            elif st.tier == "dense":
                self.dense_rounds += 1
            # "idle" (empty-frontier termination, no program ran)
            # counts toward neither tier
            if st.overflow:
                self.overflow_rounds += 1
            self.last_density = st.density
            self.last_rows_touched = st.rows_touched
            self.last_inflight = st.inflight
            if st.inflight > 0:
                self.pipelined_rounds += 1
            self.dispatch_seconds += st.dispatch_s
            self.retire_seconds += st.retire_s

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dense_rounds": self.dense_rounds,
                "sparse_rounds": self.sparse_rounds,
                "overflow_rounds": self.overflow_rounds,
                "last_density": self.last_density,
                "last_rows_touched": self.last_rows_touched,
                "last_inflight": self.last_inflight,
                "pipelined_rounds": self.pipelined_rounds,
                "dispatch_seconds": self.dispatch_seconds,
                "retire_seconds": self.retire_seconds,
            }


FRONTIER_EVENTS = FrontierAggregate()


def rule_scope(name: str):
    """A ``torch.profiler.record_function`` scope named ``name`` while a
    profiler records (``runtime/profiling.py`` attributes the device
    time launched inside it to ``name``), else a no-op.  It never
    synchronises the device."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class StepRuleAggregate:
    """Process-global record of the latest measured per-rule device
    step split — the bridge from a ``runtime/profiling`` capture (the
    only place per-rule wall exists: XLA fuses the whole superstep, so
    host timers can't see rule boundaries) to the serve plane's
    ``distel_step_rule_seconds{rule=...}`` gauges and the bench's
    ``step_profile`` section.  Stores per-rule device seconds PER STEP
    of the most recent capture plus its provenance; zeros until some
    code in the process runs a profiled saturation (bench, a test, or
    an operator-invoked ``profile_saturation``).  Thread-safe."""

    #: phases exported as rules (the engine's named scopes; everything
    #: else a capture reports folds into "other")
    RULES = ("cr1", "cr2", "cr3", "cr4", "cr5", "cr6")

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.per_rule: Dict[str, float] = {}
        self.captures = 0
        self.source = ""

    def record(self, per_step_s: Dict[str, float], source: str = "") -> None:
        """Fold one capture's per-step phase split in: known rule
        scopes keep their name, the rest aggregate into ``other``."""
        split: Dict[str, float] = {}
        for phase, secs in per_step_s.items():
            key = phase if phase in self.RULES else "other"
            split[key] = split.get(key, 0.0) + float(secs)
        with self._lock:
            self.per_rule = split
            self.captures += 1
            self.source = source

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "per_rule": dict(self.per_rule),
                "captures": self.captures,
                "source": self.source,
            }


STEP_RULE_EVENTS = StepRuleAggregate()


class CohortAggregate:
    """Process-global tally of saturation-run DEVICE DISPATCHES, split
    solo vs cohort — the instrumentation the cohort execution path's
    acceptance rests on: "device dispatches per steady delta
    drop from N (one per tenant) to 1 per cohort" must be *counted*,
    not inferred from wall clocks.  ``record_solo`` fires once per
    single-tenant fixed-point dispatch
    (``RowPackedSaturationEngine.saturate``); ``record_cohort`` once
    per vmapped cohort dispatch, carrying how many live tenants the one
    launch advanced.  The serve plane samples :data:`COHORT_EVENTS`
    into the ``distel_cohort_*`` gauges; tests snapshot before/after
    deltas.  Thread-safe: scheduler workers dispatch concurrently."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        #: single-tenant fixed-point run dispatches (one per saturate)
        self.solo_dispatches = 0
        #: vmapped cohort run dispatches (one per joint vote)
        self.cohort_dispatches = 0
        #: tenants advanced summed over cohort dispatches (÷ dispatches
        #: = the measured effective batch per device launch)
        self.cohort_tenant_votes = 0
        #: cohort deltas completed (one per member increment)
        self.cohort_deltas = 0
        #: live tenant count / padded pow2 rung of the last cohort
        self.last_size = 0
        self.last_rung = 0

    def record_solo(self) -> None:
        with self._lock:
            self.solo_dispatches += 1

    def record_cohort(self, size: int, rung: int) -> None:
        with self._lock:
            self.cohort_dispatches += 1
            self.cohort_tenant_votes += size
            self.last_size = size
            self.last_rung = rung

    def record_deltas(self, n: int) -> None:
        with self._lock:
            self.cohort_deltas += n

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "solo_dispatches": self.solo_dispatches,
                "cohort_dispatches": self.cohort_dispatches,
                "cohort_tenant_votes": self.cohort_tenant_votes,
                "cohort_deltas": self.cohort_deltas,
                "last_size": self.last_size,
                "last_rung": self.last_rung,
            }


COHORT_EVENTS = CohortAggregate()


class RoundDispatchAggregate:
    """Process-global tally of saturation ROUND DISPATCHES — the
    counted evidence the fused device-resident fixed point's acceptance
    rests on: "dispatch count collapses ≥ K×" must come from
    counters incremented at the actual ``jit``-call sites, never
    inferred from wall clocks.  ``record_dense`` fires once per dense
    multi-step device launch (the observed loop's and the adaptive
    controller's per-round dispatches), ``record_sparse`` once per
    sparse-tail launch, and ``record_fused_window`` once per fused
    K-round window launch, carrying how many rounds the one dispatch
    retired.  Tests, the tier-1 smoke, and ``bench.py`` snapshot
    before/after deltas: per-round paths pay ``rounds`` dispatches
    where the fused path pays ``ceil(rounds / K)``.  Thread-safe:
    scheduler workers and speculative pipeline workers dispatch
    concurrently."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        #: per-round dense step dispatches (one device launch each)
        self.dense_dispatches = 0
        #: per-round sparse-tail dispatches (one device launch each)
        self.sparse_dispatches = 0
        #: fused multi-round window dispatches (one device launch each)
        self.fused_windows = 0
        #: rounds retired summed over fused windows (÷ windows = the
        #: measured amortization per device launch)
        self.fused_rounds_retired = 0
        #: rounds actually retired in the most recent fused window
        self.last_window_rounds = 0

    def record_dense(self, n: int = 1) -> None:
        with self._lock:
            self.dense_dispatches += n

    def record_sparse(self) -> None:
        with self._lock:
            self.sparse_dispatches += 1

    def record_fused_window(self, rounds_retired: int) -> None:
        with self._lock:
            self.fused_windows += 1
            self.fused_rounds_retired += int(rounds_retired)
            self.last_window_rounds = int(rounds_retired)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "dense_dispatches": self.dense_dispatches,
                "sparse_dispatches": self.sparse_dispatches,
                "fused_windows": self.fused_windows,
                "fused_rounds_retired": self.fused_rounds_retired,
                "last_window_rounds": self.last_window_rounds,
            }


DISPATCH_EVENTS = RoundDispatchAggregate()
