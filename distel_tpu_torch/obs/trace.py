"""End-to-end request tracing (stdlib only).

The reference's only per-request visibility is nanoTime phase prints per
processor (``base/Type1_1AxiomProcessorBase.java:183-214``); the serve
plane already exceeds that in *aggregate* (Prometheus ``/metrics``,
per-round ``FrontierStats``), but aggregates cannot answer "where did
THIS request spend its time" or "what exactly happened around the
migration at 14:07".  This module is the causal layer: a W3C
``traceparent``-style context minted by the client (or the first server
hop), propagated router → replica → scheduler lane → registry →
classifier phases → per-saturation-round events, recorded into a
bounded in-process ring and exportable as JSONL or Chrome trace-event
JSON (loadable in Perfetto / ``chrome://tracing``).

Design constraints, in order:

* **off-path when disabled** — ``SpanRecorder(enable=False)`` yields a
  shared no-op span without touching the thread-local or the ring; the
  hot-path hooks (``active_span()``) are one ``threading.local`` read;
* **no new deps** — trace ids are ``os.urandom`` hex, the wire format is
  the 55-char ``00-<trace_id>-<span_id>-<flags>`` header, exports are
  plain ``json``;
* **bounded memory** — finished spans land in a ``deque(maxlen=...)``;
  a resident server can trace forever without growing.

Span timestamps are wall-clock epoch seconds (durations are measured
with ``perf_counter`` where precision matters); Chrome export converts
to microseconds, which Perfetto renders directly.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import re
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

#: ``00-<32 hex trace id>-<16 hex span id>-<2 hex flags>`` (W3C
#: traceparent, version 00)
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

#: header name, shared by client / router / replica
TRACEPARENT_HEADER = "traceparent"

#: id minting via the module PRNG (seeded from os.urandom at import):
#: trace ids need uniqueness, not cryptographic strength, and a
#: getrandbits is ~30x cheaper than an os.urandom syscall on the
#: request path
_ids = random.Random(os.urandom(16))
_ids_lock = threading.Lock()


def _hex_id(bits: int) -> str:
    with _ids_lock:
        return format(_ids.getrandbits(bits), "0{}x".format(bits // 4))


#: cached pid: os.getpid() is an unconditional syscall on some kernels
#: (measured 18 µs under the CI sandbox — dominating span creation);
#: refreshed after fork so a forked worker's spans carry its own pid
#: (and its id stream reseeds — forked PRNG state must not collide)
_PID = os.getpid()


def _after_fork():
    global _PID, _ids
    _PID = os.getpid()
    _ids = random.Random(os.urandom(16))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_after_fork)


class TraceContext:
    """Immutable propagation token: what crosses a process boundary."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    @classmethod
    def mint(cls, sampled: bool = True) -> "TraceContext":
        return cls(_hex_id(128), _hex_id(64), sampled)

    @classmethod
    def from_traceparent(cls, header: Optional[str]) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` header; None on absence or any
        malformation (a bad header must never fail the request)."""
        if not header:
            return None
        m = _TRACEPARENT_RE.match(header.strip().lower())
        if m is None:
            return None
        trace_id, span_id, flags = m.groups()
        if trace_id == "0" * 32 or span_id == "0" * 16:
            return None
        try:
            sampled = bool(int(flags, 16) & 1)
        except ValueError:
            return None
        return cls(trace_id, span_id, sampled)

    def to_traceparent(self) -> str:
        return "00-{}-{}-{}".format(
            self.trace_id, self.span_id, "01" if self.sampled else "00"
        )


class Span:
    """One recorded operation.  Mutated only by the thread that opened
    it (events/attrs) until ``finish``, then frozen into the ring as a
    dict."""

    __slots__ = (
        "name", "service", "trace_id", "span_id", "parent_id",
        "start_s", "end_s", "pid", "tid", "attrs", "events", "status",
        "_recorder",
    )

    def __init__(self, name, service, trace_id, span_id, parent_id,
                 start_s, recorder):
        self.name = name
        self.service = service
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_s = start_s
        self.end_s: Optional[float] = None
        self.pid = _PID
        self.tid = threading.get_ident() & 0xFFFFFFFF
        self.attrs: Dict[str, object] = {}
        self.events: List[dict] = []
        self.status = "ok"
        self._recorder = recorder

    #: spans are always sampled once they exist (unsampled requests
    #: never allocate one) — hooks may branch on this uniformly with
    #: the no-op span
    sampled = True

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id, True)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    def add_event(self, name: str, attrs: Optional[dict] = None,
                  ts_s: Optional[float] = None) -> None:
        self.events.append({
            "name": name,
            "ts_s": time.time() if ts_s is None else ts_s,
            "attrs": dict(attrs or {}),
        })

    def as_dict(self) -> dict:
        end = self.end_s if self.end_s is not None else time.time()
        return {
            "name": self.name,
            "service": self.service,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_s": self.start_s,
            "end_s": end,
            "duration_s": round(max(end - self.start_s, 0.0), 6),
            "pid": self.pid,
            "tid": self.tid,
            "status": self.status,
            "attrs": dict(self.attrs),
            "events": list(self.events),
        }


class _NoopSpan:
    """The disabled/unsampled stand-in: every mutator is a no-op, so
    instrumentation sites never branch on enablement themselves."""

    __slots__ = ()
    sampled = False
    trace_id = None
    span_id = None
    _recorder = None

    def context(self):
        return None

    def set_attr(self, key, value):
        pass

    def set_status(self, status):
        pass

    def add_event(self, name, attrs=None, ts_s=None):
        pass


NOOP = _NoopSpan()


class _UnsampledSpan:
    """Context-only carrier for an UNSAMPLED request: records nothing,
    but holds a trace context with ``sampled=False`` so every
    downstream hop (client header injection, router forward, scheduler
    submit) inherits the DON'T-sample decision instead of re-rooting
    its own trace — without this, ``obs.sample_rate=0.1`` would leak
    orphan partial traces at each hop."""

    __slots__ = ("trace_id", "span_id")
    sampled = False
    _recorder = None

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def context(self):
        return TraceContext(self.trace_id, self.span_id, sampled=False)

    def set_attr(self, key, value):
        pass

    def set_status(self, status):
        pass

    def add_event(self, name, attrs=None, ts_s=None):
        pass

#: per-thread active span (the propagation mechanism inside one
#: process; across processes the traceparent header carries it)
_tls = threading.local()


def active_span() -> Optional[Span]:
    """The thread's active span, or None.  One attribute read — safe on
    every hot path."""
    return getattr(_tls, "span", None)


def current_context() -> Optional[TraceContext]:
    sp = active_span()
    return sp.context() if sp is not None else None


@contextlib.contextmanager
def activate(span: Span):
    """Make ``span`` the thread's active span for the block (nesting
    restores the previous one)."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    try:
        yield span
    finally:
        _tls.span = prev


@contextlib.contextmanager
def child_span(name: str, attrs: Optional[dict] = None):
    """A child span of the thread's active span, recorded through the
    same recorder; a no-op when nothing is active (library code calls
    this unconditionally — registry restore, phase timers)."""
    sp = active_span()
    if sp is None or sp._recorder is None:
        yield NOOP
        return
    with sp._recorder.span(name, parent=sp, attrs=attrs) as child:
        yield child


def add_span_event(name: str, attrs: Optional[dict] = None) -> None:
    """Append an event to the thread's active span, if any."""
    sp = active_span()
    if sp is not None:
        sp.add_event(name, attrs)


def add_round_event(st) -> None:
    """Attach one saturation round's ``FrontierStats`` to the active
    span — the hook ``runtime/instrumentation.FRONTIER_EVENTS`` calls so
    a traced classify shows its per-round tier/density/dispatch/retire
    timeline (the PR 5 pipeline's overlap, visible per request)."""
    sp = active_span()
    if sp is not None:
        sp.add_event(
            "saturation.round",
            {
                "iteration": st.iteration,
                "tier": st.tier,
                "density": round(st.density, 5),
                "rows_touched": st.rows_touched,
                "derivations": st.derivations,
                "overflow": st.overflow,
                "dispatch_s": round(st.dispatch_s, 6),
                "retire_s": round(st.retire_s, 6),
                "inflight": st.inflight,
            },
        )


def add_phase_span(parent: Span, name: str, start_s: float,
                   duration_s: float) -> None:
    """Record one finished classifier phase as a complete child span of
    ``parent`` (``runtime/instrumentation.PhaseTimer`` calls this with
    its measured wall — the phases of a traced request nest under its
    lane-exec span)."""
    rec = parent._recorder
    if rec is not None:
        rec.record_complete(
            f"phase:{name}", parent, start_s, start_s + duration_s
        )


class SpanRecorder:
    """Thread-safe bounded span store with config-gated sampling.

    One per process role (replica, router, client harness); finished
    spans freeze into a ``deque(maxlen=capacity)`` of dicts served by
    ``/debug/trace``.  ``enable=False`` makes every entry point yield
    :data:`NOOP` without touching the ring or the thread-local —
    tracing is fully off-path."""

    def __init__(
        self,
        service: str = "distel",
        *,
        capacity: int = 2048,
        enable: bool = True,
        sample_rate: float = 1.0,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError("sample_rate must be in [0, 1]")
        self.service = service
        self.enabled = bool(enable)
        self.sample_rate = float(sample_rate)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)

    # ----------------------------------------------------------- create

    def _sampled(self, parent) -> bool:
        if parent is None:
            return (
                self.sample_rate >= 1.0
                or random.random() < self.sample_rate
            )
        return bool(getattr(parent, "sampled", True))

    def start(
        self,
        name: str,
        parent=None,
        attrs: Optional[dict] = None,
        start_s: Optional[float] = None,
    ) -> Optional[Span]:
        """Open a span (caller must :meth:`finish` it).  ``parent``: a
        :class:`Span`, a :class:`TraceContext`, or None (new root under
        the sampling decision).  Returns None when disabled or
        unsampled."""
        if not self.enabled or not self._sampled(parent):
            return None
        if parent is None:
            trace_id, parent_id = _hex_id(128), None
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        span = Span(
            name, self.service, trace_id, _hex_id(64), parent_id,
            time.time() if start_s is None else start_s, self,
        )
        if attrs:
            span.attrs.update(attrs)
        return span

    def finish(self, span: Span, end_s: Optional[float] = None) -> None:
        span.end_s = time.time() if end_s is None else end_s
        with self._lock:
            self._ring.append(span.as_dict())

    @contextlib.contextmanager
    def span(self, name: str, parent=None, attrs: Optional[dict] = None):
        """Open + activate + record a span around a block; exceptions
        mark ``status="error"`` and re-raise.  Yields :data:`NOOP` when
        disabled; for an enabled-but-unsampled request it yields (and
        ACTIVATES) a context-only carrier so the don't-sample decision
        propagates to every downstream hop."""
        if not self.enabled:
            yield NOOP
            return
        sp = self.start(name, parent=parent, attrs=attrs)
        if sp is None:
            if parent is not None:
                carrier = _UnsampledSpan(parent.trace_id, parent.span_id)
            else:
                carrier = _UnsampledSpan(_hex_id(128), _hex_id(64))
            with activate(carrier):
                yield carrier
            return
        try:
            with activate(sp):
                yield sp
        except BaseException as e:
            sp.status = "error"
            sp.attrs.setdefault("error", f"{type(e).__name__}: {e}"[:200])
            raise
        finally:
            self.finish(sp)

    def record_complete(
        self,
        name: str,
        parent,
        start_s: float,
        end_s: float,
        attrs: Optional[dict] = None,
    ) -> None:
        """Record an already-finished interval (queue waits, phase
        timers) as a span under ``parent`` without activating it."""
        sp = self.start(name, parent=parent, attrs=attrs, start_s=start_s)
        if sp is not None:
            self.finish(sp, end_s=end_s)

    # ------------------------------------------------------------- read

    def spans(
        self, trace_id: Optional[str] = None, limit: Optional[int] = None
    ) -> List[dict]:
        """Finished spans, oldest first, optionally filtered by
        trace_id / bounded to the newest ``limit``."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            # guard limit=0 explicitly: out[-0:] is the WHOLE list
            out = out[-limit:] if limit else []
        return out

    def jsonl(self, trace_id: Optional[str] = None) -> str:
        lines = [json.dumps(s) for s in self.spans(trace_id)]
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


def chrome_trace(spans: Iterable[dict]) -> dict:
    """Convert recorded span dicts (possibly merged across processes —
    the router's stitched view) into Chrome trace-event JSON:
    ``{"traceEvents": [...]}`` with complete (``ph="X"``) events per
    span, instant (``ph="i"``) events per span event, and
    ``process_name`` metadata so Perfetto labels each service's track.
    """
    events: List[dict] = []
    #: (real pid, service) → synthetic display pid: distinct services
    #: sharing one OS process (in-process fleet rigs, the test client
    #: next to the router) must land on SEPARATE Perfetto tracks
    procs: Dict[tuple, int] = {}
    for sp in spans:
        real_pid = int(sp.get("pid", 0))
        tid = int(sp.get("tid", 0))
        svc = str(sp.get("service", "distel"))
        pid = procs.setdefault((real_pid, svc), len(procs) + 1)
        start = float(sp["start_s"])
        end = float(sp.get("end_s") or start)
        args = {
            "trace_id": sp.get("trace_id"),
            "span_id": sp.get("span_id"),
            "parent_id": sp.get("parent_id"),
            "status": sp.get("status", "ok"),
            "os_pid": real_pid,
        }
        args.update(sp.get("attrs") or {})
        events.append({
            "name": sp["name"],
            "cat": svc,
            "ph": "X",
            "ts": round(start * 1e6, 3),
            "dur": round(max(end - start, 0.0) * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
        for ev in sp.get("events") or ():
            events.append({
                "name": ev["name"],
                "cat": svc,
                "ph": "i",
                "s": "t",
                "ts": round(float(ev["ts_s"]) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": ev.get("attrs") or {},
            })
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": disp,
            "args": {"name": f"{svc} (pid {real_pid})"},
        }
        for (real_pid, svc), disp in sorted(
            procs.items(), key=lambda kv: kv[1]
        )
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
