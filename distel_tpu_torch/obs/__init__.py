"""Observability: end-to-end request tracing and the flight recorder
(stdlib only — importable everywhere, off-path when disabled).

The port of ``distel_tpu/obs/``'s serving half::

    trace.py   TraceContext (W3C ``traceparent`` wire form), Span,
               SpanRecorder (bounded ring, config-gated sampling,
               JSONL + Chrome trace-event export), thread-local
               propagation helpers the serve plane, scheduler and
               registry share (a copy of the reference's)
    flight.py  FlightRecorder — bounded structured control-plane event
               log, queryable at ``/debug/events`` and dumped as JSONL
               on shutdown (a copy of the reference's)

The reference's ``ledger.py`` (run ledger, stall watchdog,
``RUN_EVENTS``) and ``costmodel.py`` serve the observed fixed-point
loop, which the port does not have yet; they come with it.

Config knobs (``config.ClassifierConfig`` / ``obs.*`` properties):
``obs.enable``, ``obs.sample_rate``, ``obs.ring.capacity``,
``obs.flight.capacity``.
"""

from distel_tpu_torch.obs.flight import FlightRecorder
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
    "FlightRecorder",
    "NOOP",
    "Span",
    "SpanRecorder",
    "TraceContext",
    "active_span",
    "add_span_event",
    "child_span",
    "chrome_trace",
    "current_context",
]
