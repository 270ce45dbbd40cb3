"""Observability: end-to-end request tracing, the flight recorder and
the run ledger (stdlib only — importable everywhere, off-path when
disabled).

The port of ``distel_tpu/obs/``::

    trace.py   TraceContext (W3C ``traceparent`` wire form), Span,
               SpanRecorder (bounded ring, config-gated sampling,
               JSONL + Chrome trace-event export), thread-local
               propagation helpers the serve plane, scheduler and
               registry share (a copy of the reference's)
    flight.py  FlightRecorder — bounded structured control-plane event
               log, queryable at ``/debug/events`` and dumped as JSONL
               on shutdown (a copy of the reference's)
    ledger.py  RunLedger — crash-safe append-only JSONL run ledger
               (one record per observed saturation round, plus
               open/snapshot/resume/close chain markers), the
               stall/regression/memory StallWatchdog, the
               ``distel_run_*`` gauge bridge (RUN_EVENTS), and the
               LedgerObserver adapter for ``saturate_observed`` (a copy
               of the reference's; the card's peak memory reads
               ``torch.cuda.max_memory_allocated``)
    costmodel.py  fitted rounds-vs-size cost model (seeded from the
               port's own run ledgers under ``runs/``), the online ETA,
               and the launch budget guard (a copy of the reference's)

Config knobs (``config.ClassifierConfig`` / ``obs.*`` properties):
``obs.enable``, ``obs.sample_rate``, ``obs.ring.capacity``,
``obs.flight.capacity``, ``obs.ledger.enable``, ``obs.ledger.dir``,
``obs.trace_rounds``.
"""

from distel_tpu_torch.obs.flight import FlightRecorder
from distel_tpu_torch.obs.ledger import (
    RUN_EVENTS,
    BudgetExhausted,
    LedgerObserver,
    RunLedger,
    StallWatchdog,
)
from distel_tpu_torch.obs.trace import (
    NOOP,
    Span,
    SpanRecorder,
    TraceContext,
    active_span,
    add_span_event,
    child_span,
    chrome_trace,
    current_context,
)

__all__ = [
    "BudgetExhausted",
    "FlightRecorder",
    "LedgerObserver",
    "NOOP",
    "RUN_EVENTS",
    "RunLedger",
    "StallWatchdog",
    "Span",
    "SpanRecorder",
    "TraceContext",
    "active_span",
    "add_span_event",
    "child_span",
    "chrome_trace",
    "current_context",
]
