"""Bounded-queue request scheduler for the serve plane.

Shapes (the robustness contract the resident service carries for the
whole stack):

* **per-ontology serialization** — deltas are order-dependent, and the
  registry's classifiers are single-writer; all requests for one
  ontology run in admission order on one lane;
* **cross-ontology concurrency** — a small worker pool drains distinct
  lanes in parallel (the closures are independent device programs);
* **delta batching** — contiguous batchable requests at the head of a
  lane coalesce into ONE executor call (one saturation for k queued
  deltas — the tensor analog of the reference absorbing a burst of
  Redis inserts into one increment);
* **cohort formation** (ISSUE 12) — pending batchable deltas on
  DISTINCT lanes whose ontologies share a bucket signature
  (``cohort_key``) are grouped under a bounded wait
  (``cohort.max_size`` / ``cohort.max_wait_ms``) into one
  ``execute_cohort`` call: the registry advances the whole cohort
  with one vmapped device dispatch per vote instead of one dispatch
  per tenant.  Per-ontology serialization is preserved — every member
  is the head of its lane and all member lanes go active together;
* **admission control** — a full queue rejects at submit
  (:class:`QueueFull` → HTTP 429 + Retry-After) instead of queueing
  unboundedly;
* **deadlines** — a request that expires while queued is failed with
  :class:`Deadline` (→ 503) without ever occupying a worker; a request
  that expires mid-execution returns 503 to the *waiter* while the
  worker finishes the (uninterruptible) device program and recovers.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from distel_tpu_torch.obs import trace as _obs_trace


class QueueFull(Exception):
    """Admission refused: the bounded queue is at capacity."""


class ShuttingDown(Exception):
    """Admission refused: the scheduler is draining for shutdown."""


class Deadline(Exception):
    """The request's deadline passed before a result was produced."""


class Request:
    """A scheduled unit.  ``wait`` blocks the HTTP handler thread; the
    worker resolves via ``_resolve``/``_fail``."""

    __slots__ = (
        "key", "kind", "payload", "deadline", "enqueued", "batchable",
        "_event", "_result", "_error", "batched", "ctx", "enqueued_wall",
    )

    def __init__(self, key, kind, payload, deadline, batchable=False):
        self.key = key
        self.kind = kind
        self.batchable = batchable
        self.payload = payload
        self.deadline = deadline
        self.enqueued = time.monotonic()
        # trace context captured at admission (the HTTP handler thread's
        # active span): the worker re-activates it so queue-wait and
        # lane-exec land on the request's trace
        self.ctx = _obs_trace.current_context()
        self.enqueued_wall = time.time() if self.ctx is not None else 0.0
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self.batched = 1

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def wait(self, timeout: Optional[float]):
        """Result, or raises the worker's error; raises
        :class:`Deadline` when ``timeout`` elapses first (the worker
        keeps running — device programs are uninterruptible — and its
        late result is discarded)."""
        if not self._event.wait(timeout):
            raise Deadline(
                f"request exceeded its deadline after {timeout:.3g}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class RequestScheduler:
    """``execute(key, kind, payloads) -> result`` is the single executor
    callback (the server routes it into the registry); for a coalesced
    batch it receives every payload and its result is shared by all
    requests in the batch."""

    def __init__(
        self,
        execute: Callable[[str, str, List], object],
        *,
        workers: int = 2,
        max_queue: int = 64,
        max_batch: int = 8,
        metrics=None,
        tracer=None,
        cohort_key: Optional[Callable[[str], Optional[str]]] = None,
        execute_cohort: Optional[Callable[[List], Dict]] = None,
        cohort_max_size: int = 8,
        cohort_max_wait_s: float = 0.025,
    ):
        if workers < 1 or max_queue < 1 or max_batch < 1:
            raise ValueError("workers, max_queue, max_batch must be >= 1")
        self._execute = execute
        #: cohort-formation lane (both callbacks required to engage):
        #: ``cohort_key(key) -> signature | None`` is the CHEAP
        #: non-blocking grouping proxy (the registry answers with the
        #: ontology's base bucket signature); ``execute_cohort(members)
        #: -> {key: record | BaseException}`` advances every member —
        #: members are ``(key, payloads)`` pairs, one increment each
        self._cohort_key = (
            self._safe_key_fn(cohort_key) if cohort_key else None
        )
        self._execute_cohort = execute_cohort
        self.cohort_max_size = max(int(cohort_max_size), 1)
        self.cohort_max_wait_s = max(float(cohort_max_wait_s), 0.0)
        self.max_queue = max_queue
        self.max_batch = max_batch
        self.metrics = metrics
        #: optional :class:`~distel_tpu.obs.SpanRecorder` — queue-wait
        #: and lane-exec spans for requests that carried a trace context
        self.tracer = tracer
        self._cv = threading.Condition()
        #: cohort rendezvous: signature → the forming worker's member
        #: list.  A second worker that pops a same-signature delta
        #: while one is forming DONATES its batch into the list (and
        #: the forming worker resolves those requests) instead of
        #: executing solo — without this, N workers racing N tenants'
        #: deltas would each claim one lane and never see the others.
        self._forming: Dict[str, List] = {}
        #: key → FIFO of queued requests (admission order per lane)
        self._lanes: Dict[str, collections.deque] = {}
        #: lane admission order across keys (approximate global FIFO)
        self._order: collections.deque = collections.deque()
        self._active: set = set()  # keys currently on a worker
        self._depth = 0  # queued (not yet executing) requests
        self._stopping = False
        self._workers = [
            threading.Thread(
                target=self._worker_loop, name=f"distel-serve-{i}",
                daemon=True,
            )
            for i in range(workers)
        ]
        for t in self._workers:
            t.start()

    # ---------------------------------------------------------- metrics

    def depth(self) -> int:
        with self._cv:
            return self._depth

    def active(self) -> int:
        with self._cv:
            return len(self._active)

    # --------------------------------------------------------- frontend

    def submit(
        self,
        key: str,
        kind: str,
        payload,
        *,
        deadline_s: Optional[float] = None,
        batchable: bool = False,
    ) -> Request:
        """Admit a request onto ``key``'s lane, or raise
        :class:`QueueFull` / :class:`ShuttingDown`."""
        deadline = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        req = Request(key, kind, payload, deadline, batchable)
        with self._cv:
            if self._stopping:
                raise ShuttingDown("scheduler is draining")
            if self._depth >= self.max_queue:
                if self.metrics is not None:
                    self.metrics.counter_inc("distel_admission_rejected_total")
                raise QueueFull(
                    f"queue full ({self._depth}/{self.max_queue})"
                )
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = collections.deque()
            lane.append(req)
            if key not in self._order:
                self._order.append(key)
            self._depth += 1
            # notify_all, not notify: since the cohort-formation lane,
            # cv waiters are no longer fungible — a forming leader can
            # consume a single wakeup it cannot act on (a query, a
            # non-matching delta) while an idle worker sleeps on, and
            # the request would then stall until the leader's bounded
            # wait expires
            self._cv.notify_all()
        return req

    # ----------------------------------------------------------- worker

    def _pick(self) -> Optional[str]:
        """A key with queued work whose lane is idle (caller holds the
        lock)."""
        for key in self._order:
            if key not in self._active and self._lanes.get(key):
                return key
        return None

    @staticmethod
    def _safe_key_fn(fn):
        """A cohort_key that throws must degrade that request to solo
        execution, never kill the worker thread."""

        def safe(key):
            try:
                return fn(key)
            except Exception:  # noqa: BLE001 — grouping hint only
                return None

        return safe

    def _pop_batch(self, key: str) -> List[Request]:
        """Pop the lane head plus contiguous batchable same-kind
        requests.  Caller holds ``self._cv``."""
        lane = self._lanes[key]
        batch = [lane.popleft()]
        while (
            lane
            and len(batch) < self.max_batch
            and batch[0].batchable
            and lane[0].batchable
            and lane[0].kind == batch[0].kind
        ):
            batch.append(lane.popleft())
        self._depth -= len(batch)
        if not lane:
            self._lanes.pop(key, None)
            try:
                self._order.remove(key)
            except ValueError:
                pass
        return batch

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                key = self._pick()
                while key is None:
                    if self._stopping:
                        return
                    self._cv.wait()
                    key = self._pick()
                batch = self._pop_batch(key)
                self._active.add(key)
                members = [(key, batch)]
                donated = False
                if (
                    self._execute_cohort is not None
                    and self._cohort_key is not None
                    and self.cohort_max_size >= 2
                    and batch[0].batchable
                    and batch[0].kind == "delta"
                ):
                    sig = self._cohort_key(key)
                    forming = (
                        self._forming.get(sig) if sig is not None else None
                    )
                    if (
                        forming is not None
                        and len(forming) < self.cohort_max_size
                    ):
                        # another worker is forming this signature's
                        # cohort: donate our batch (it resolves the
                        # requests and releases the key) and move on
                        forming.append((key, batch))
                        self._cv.notify_all()
                        donated = True
                    elif sig is not None:
                        self._forming[sig] = members
                        try:
                            self._gather_cohort(sig, members)
                        finally:
                            self._forming.pop(sig, None)
            if donated:
                continue
            try:
                if len(members) == 1:
                    self._run_batch(key, batch)
                else:
                    self._run_cohort(members)
            finally:
                with self._cv:
                    for k, _b in members:
                        self._active.discard(k)
                    self._cv.notify_all()

    def _gather_cohort(self, sig: str, members: List) -> None:
        """Cohort-formation lane; mutates ``members`` in place.
        Caller holds ``self._cv``.
        Two intake paths run concurrently until
        ``cohort_max_size`` members or the bounded wait expires: this
        worker scans idle lanes for pending batchable deltas whose
        ontology shares the leader's cohort signature (claiming each —
        the lane goes active, so per-ontology serialization holds), and
        OTHER workers donate same-signature batches they popped through
        the ``_forming`` rendezvous.  The wait releases the lock
        (``cv.wait``), so workers and submissions proceed; every
        submit/donation notifies, so a late-arriving companion is
        claimed the moment it appears."""
        lead_batch = members[0][1]
        deadline = time.monotonic() + self.cohort_max_wait_s
        while True:
            taken = {k for k, _b in members}
            for k2 in list(self._order):
                if len(members) >= self.cohort_max_size:
                    break
                if k2 in self._active or k2 in taken:
                    continue
                lane = self._lanes.get(k2)
                if not lane:
                    continue
                head = lane[0]
                if not (
                    head.batchable and head.kind == lead_batch[0].kind
                ):
                    continue
                if self._cohort_key(k2) != sig:
                    continue
                b2 = self._pop_batch(k2)
                self._active.add(k2)
                members.append((k2, b2))
            if len(members) >= self.cohort_max_size or self._stopping:
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            self._cv.wait(remaining)

    def _run_cohort(self, members: List) -> None:
        """Execute one formed cohort: expire stale requests, hand every
        live member's payloads to ``execute_cohort`` in ONE call, and
        resolve each member's requests from the per-key outcome map
        (``BaseException`` values fail that member alone — a parse
        error in one tenant's delta must not poison its cohort)."""
        now = time.monotonic()
        live: List = []
        for key, batch in members:
            lv = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    if self.metrics is not None:
                        self.metrics.counter_inc(
                            "distel_deadline_expired_total"
                        )
                    req._fail(Deadline("deadline passed while queued"))
                else:
                    lv.append(req)
            if lv:
                live.append((key, lv))
        if not live:
            return
        if len(live) == 1:
            # every companion expired while queued — plain lane batch
            # (re-runs the deadline filter, a no-op for survivors)
            self._run_batch(live[0][0], live[0][1])
            return
        kind = live[0][1][0].kind
        if self.metrics is not None:
            self.metrics.observe(
                "distel_cohort_size",
                len(live),
                buckets=(1, 2, 4, 8, 16),
            )
            self.metrics.observe(
                "distel_queue_wait_seconds",
                now - min(r.enqueued for _k, lv in live for r in lv),
                {"kind": kind},
            )
        lead_ctx = None
        if self.tracer is not None:
            wall = time.time()
            for key, lv in live:
                for req in lv:
                    if req.ctx is not None:
                        if lead_ctx is None and req.ctx.sampled:
                            lead_ctx = req.ctx
                        self.tracer.record_complete(
                            "scheduler.queue", req.ctx, req.enqueued_wall,
                            wall, {"kind": req.kind, "key": key},
                        )
        span_cm = (
            self.tracer.span(
                "scheduler.cohort",
                parent=lead_ctx,
                attrs={
                    "kind": kind,
                    "cohort.size": len(live),
                    "keys": ",".join(k for k, _lv in live)[:200],
                },
            )
            if lead_ctx is not None
            else contextlib.nullcontext(_obs_trace.NOOP)
        )
        with span_cm as lane:
            try:
                results = self._execute_cohort(
                    [(k, [r.payload for r in lv]) for k, lv in live]
                )
            except BaseException as e:  # noqa: BLE001 — relayed to waiters
                lane.set_status("error")
                lane.set_attr("error", f"{type(e).__name__}: {e}"[:200])
                for _k, lv in live:
                    for req in lv:
                        req._fail(e)
                return
        for key, lv in live:
            out = results.get(key) if results else None
            for req in lv:
                req.batched = len(lv)
                if isinstance(out, BaseException):
                    req._fail(out)
                elif out is None:
                    req._fail(
                        RuntimeError(
                            f"cohort executor returned nothing for {key!r}"
                        )
                    )
                else:
                    req._resolve(out)

    def _run_batch(self, key: str, batch: List[Request]) -> None:
        now = time.monotonic()
        live: List[Request] = []
        for req in batch:
            if req.deadline is not None and now > req.deadline:
                # expired while queued: fail fast, never occupy the
                # worker with a result nobody is waiting for
                if self.metrics is not None:
                    self.metrics.counter_inc("distel_deadline_expired_total")
                req._fail(Deadline("deadline passed while queued"))
            else:
                live.append(req)
        if not live:
            return
        kind = live[0].kind
        if self.metrics is not None:
            self.metrics.observe(
                "distel_batch_size",
                len(live),
                {"kind": kind},
                buckets=(1, 2, 4, 8, 16, 32, 64),
            )
            # labeled by kind: the serving dashboards split lane-read
            # wait (legacy subsumers/taxonomy queries stuck behind a
            # delta) from write wait — the gap the snapshot-plane
            # /query endpoints exist to close
            self.metrics.observe(
                "distel_queue_wait_seconds",
                now - min(r.enqueued for r in live),
                {"kind": kind},
            )
        # traced requests: the time spent queued becomes a span per
        # request, and the execution wraps in a lane-exec span ACTIVATED
        # on this worker thread — classifier phases and saturation-round
        # events recorded during the execute nest under it.  The lane
        # span parents on the first SAMPLED request in the batch (not
        # the batch leader): a traced delta coalesced behind an
        # untraced or unsampled one must not lose its exec spans
        lead_ctx = None
        if self.tracer is not None:
            wall = time.time()
            for req in live:
                if req.ctx is not None:
                    if lead_ctx is None and req.ctx.sampled:
                        lead_ctx = req.ctx
                    self.tracer.record_complete(
                        "scheduler.queue", req.ctx, req.enqueued_wall,
                        wall, {"kind": req.kind, "key": key},
                    )
        span_cm = (
            self.tracer.span(
                "scheduler.lane",
                parent=lead_ctx,
                attrs={"kind": kind, "key": key, "batch": len(live)},
            )
            if lead_ctx is not None
            else contextlib.nullcontext(_obs_trace.NOOP)
        )
        with span_cm as lane:
            try:
                result = self._execute(
                    key, kind, [r.payload for r in live]
                )
            except BaseException as e:  # noqa: BLE001 — relayed to waiters
                # caught INSIDE the span block (waiters must still be
                # failed), so mark the span's status by hand — a failed
                # classify must be findable by status=="error"
                lane.set_status("error")
                lane.set_attr("error", f"{type(e).__name__}: {e}"[:200])
                for req in live:
                    req._fail(e)
                return
        for req in live:
            req.batched = len(live)
            req._resolve(result)

    # --------------------------------------------------------- shutdown

    def close(self, drain_s: float = 30.0) -> None:
        """Stop admitting, fail everything still queued (callers get
        :class:`ShuttingDown` → 503), and join the workers — bounded by
        ``drain_s`` per worker so an in-flight saturation cannot wedge
        shutdown."""
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            for lane in self._lanes.values():
                for req in lane:
                    req._fail(ShuttingDown("server shutting down"))
                    self._depth -= 1
            self._lanes.clear()
            self._order.clear()
            self._cv.notify_all()
        for t in self._workers:
            t.join(timeout=drain_s)
