"""Tiny stdlib client for the serve plane (urllib, no new deps).

Used by the tests and handy from a REPL::

    from distel_tpu_torch.serve.client import ServeClient
    c = ServeClient("http://127.0.0.1:8080")
    oid = c.load(open("snomed.ofn").read())["id"]
    c.delta(oid, "SubClassOf(Extra Find3)")
    c.subsumers(oid, "Extra")

Non-2xx responses raise :class:`ServeError` carrying the HTTP status,
the parsed error body, and the response headers (tests assert on 429's
``Retry-After``).

Opt-in retry (``retries > 0``): 429/503 answers — admission refused,
deadline passed, a fleet migration hold outlasted — are retried with
jittered exponential backoff, honoring a ``Retry-After`` header when the
server sent one; transport-level failures (connection refused/reset —
the window where the fleet router is failing a replica over) retry the
same way.  The serve plane's write ops are safe to re-send under this
policy: a 429 was refused at admission, EL+ deltas are monotone
(re-applying an increment that did land is the identity), and queries
are reads.  The one caveat is ``load`` after a 503-deadline or a torn
connection: the abandoned attempt may still complete server-side under
its own id — a leaked resident ontology, never a wrong answer (callers
that cannot tolerate the leak keep ``retries=0`` for loads).
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from typing import Optional

from distel_tpu_torch.obs import trace as obs_trace


class ServeError(Exception):
    def __init__(self, status: int, body, headers=None):
        message = (
            body.get("error") if isinstance(body, dict) else str(body)
        )
        super().__init__(f"HTTP {status}: {message}")
        self.status = status
        self.body = body
        self.headers = dict(headers or {})


#: statuses the serve plane uses for "not admitted — try again":
#: queue-full 429, deadline/draining/migration-hold 503
RETRYABLE_STATUSES = (429, 503)


class ServeClient:
    def __init__(
        self,
        base_url: str,
        timeout: float = 600.0,
        *,
        retries: int = 0,
        backoff_s: float = 0.25,
        max_backoff_s: float = 10.0,
        tracer=None,
    ):
        """``retries=0`` (default) preserves the raise-on-429/503
        behavior; ``retries=N`` re-sends up to N times with jittered
        exponential backoff (base ``backoff_s``, capped at
        ``max_backoff_s``), preferring the server's ``Retry-After``.

        ``tracer``: an optional :class:`~distel_tpu.obs.SpanRecorder` —
        every request then runs inside a client span whose W3C
        ``traceparent`` rides the request headers, so the router and
        replica spans stitch to it by trace_id; the last request's
        trace id is kept on :attr:`last_trace_id` (feed it to
        ``cli trace`` or ``/debug/trace?trace_id=``)."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.tracer = tracer
        #: trace id of the most recent traced request (None untraced)
        self.last_trace_id: Optional[str] = None
        #: per-ontology snapshot-version watermark: the highest version
        #: seen in any write ack or read response.  Read helpers thread
        #: it back as ``min_version``, which buys monotonic reads AND
        #: read-your-writes across a fanned-out fleet (a lagging read
        #: replica answers 412 and the router retries the primary).
        self._versions: dict = {}

    # ------------------------------------------------------------- http

    def _delay(self, attempt: int, retry_after: Optional[str]) -> float:
        if retry_after:
            try:
                return min(float(retry_after), self.max_backoff_s)
            except ValueError:
                pass
        # full jitter: herd-of-clients backoff must decorrelate, or
        # every rejected client re-arrives in the same tick it left
        ceiling = min(
            self.backoff_s * (2 ** attempt), self.max_backoff_s
        )
        return random.uniform(0, ceiling)

    def _request(
        self,
        method: str,
        path: str,
        doc: Optional[dict] = None,
        deadline_s: Optional[float] = None,
        retry_statuses=RETRYABLE_STATUSES,
    ):
        if self.tracer is None or not self.tracer.enabled:
            return self._request_loop(
                method, path, doc, deadline_s, retry_statuses
            )
        # one client span covers the whole logical request (every retry
        # re-sends the same traceparent, so server-side spans of all
        # attempts stitch to it)
        with self.tracer.span(
            f"client {method} {path.split('?', 1)[0]}",
            attrs={"method": method, "path": path},
        ) as span:
            if span.sampled:
                self.last_trace_id = span.trace_id
            return self._request_loop(
                method, path, doc, deadline_s, retry_statuses
            )

    def _request_loop(
        self,
        method: str,
        path: str,
        doc: Optional[dict],
        deadline_s: Optional[float],
        retry_statuses,
    ):
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, doc, deadline_s)
            except ServeError as e:
                if (
                    attempt >= self.retries
                    or e.status not in retry_statuses
                ):
                    raise
                delay = self._delay(
                    attempt, e.headers.get("Retry-After")
                )
            except urllib.error.URLError:
                # connection refused/reset: the router-failover window
                if attempt >= self.retries:
                    raise
                delay = self._delay(attempt, None)
            attempt += 1
            time.sleep(delay)

    def _request_once(
        self,
        method: str,
        path: str,
        doc: Optional[dict] = None,
        deadline_s: Optional[float] = None,
    ):
        url = self.base_url + path
        data = json.dumps(doc).encode("utf-8") if doc is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if deadline_s is not None:
            req.add_header("X-Distel-Deadline-S", str(deadline_s))
        # propagate the calling thread's trace context (the client
        # span opened by _request, or any surrounding server span)
        ctx = obs_trace.current_context()
        if ctx is not None:
            req.add_header(
                obs_trace.TRACEPARENT_HEADER, ctx.to_traceparent()
            )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                ctype = resp.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    return json.loads(raw.decode("utf-8"))
                return raw.decode("utf-8")
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                body = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                body = raw.decode("utf-8", "replace")
            raise ServeError(e.code, body, e.headers) from None

    # -------------------------------------------------------------- API

    def _note_version(self, oid: str, doc) -> None:
        if isinstance(doc, dict) and isinstance(doc.get("version"), int):
            v = doc["version"]
            if v > self._versions.get(oid, 0):
                self._versions[oid] = v

    def watermark(self, oid: str) -> int:
        """Highest snapshot version this client has observed for the
        ontology (0 = none yet) — what read helpers send as
        ``min_version``."""
        return self._versions.get(oid, 0)

    def load(self, text: str, deadline_s: Optional[float] = None) -> dict:
        rec = self._request(
            "POST", "/v1/ontologies", {"text": text}, deadline_s
        )
        if isinstance(rec, dict) and "id" in rec:
            self._note_version(rec["id"], rec)
        return rec

    def delta(
        self, oid: str, text: str, deadline_s: Optional[float] = None
    ) -> dict:
        rec = self._request(
            "POST", f"/v1/ontologies/{oid}/deltas", {"text": text},
            deadline_s,
        )
        self._note_version(oid, rec)
        return rec

    def retract(
        self, oid: str, text: str, deadline_s: Optional[float] = None
    ) -> dict:
        """Retract a previously-applied text (DRed delete-and-rederive;
        the text must byte-match a prior load/delta text).  404: never
        ingested / already retracted; 409: refused as entangled (shared
        normalization gensyms or active range machinery).  The response
        version is the repaired snapshot's — read-your-writes covers
        the retraction like any delta."""
        rec = self._request(
            "POST", f"/v1/ontologies/{oid}/retract", {"text": text},
            deadline_s,
        )
        self._note_version(oid, rec)
        return rec

    def subsumers(
        self, oid: str, cls: str, deadline_s: Optional[float] = None
    ) -> dict:
        from urllib.parse import quote

        return self._request(
            "GET",
            f"/v1/ontologies/{oid}/subsumers?class={quote(cls)}",
            None,
            deadline_s,
        )

    def taxonomy(self, oid: str, deadline_s: Optional[float] = None) -> dict:
        return self._request(
            "GET", f"/v1/ontologies/{oid}/taxonomy", None, deadline_s
        )

    # ------------------------------------- snapshot-plane read helpers

    def _query_read(
        self,
        oid: str,
        op: str,
        params: dict,
        deadline_s: Optional[float],
    ) -> dict:
        from urllib.parse import urlencode

        q = dict(params)
        wm = self.watermark(oid)
        if wm:
            q["min_version"] = wm
        doc = self._request(
            "GET",
            f"/v1/ontologies/{oid}/query/{op}?" + urlencode(q),
            None,
            deadline_s,
            # 412 = a lagging read replica behind this client's
            # watermark: retryable — the fleet router falls back to
            # the primary by itself; a direct replica catches up on
            # the next publish
            retry_statuses=RETRYABLE_STATUSES + (412,),
        )
        self._note_version(oid, doc)
        return doc

    def is_subsumed(
        self, oid: str, sub: str, sup: str,
        deadline_s: Optional[float] = None,
    ) -> dict:
        """O(words) subsumption test off the lock-free snapshot plane
        (never queues behind classify traffic).  The response carries
        the snapshot ``version`` it was answered from."""
        return self._query_read(
            oid, "subsumed", {"sub": sub, "sup": sup}, deadline_s
        )

    def query_subsumers(
        self, oid: str, cls: str, deadline_s: Optional[float] = None
    ) -> dict:
        """A class's strict named subsumers off the snapshot plane
        (same answer set as :meth:`subsumers`, without the scheduler
        lane)."""
        return self._query_read(
            oid, "subsumers", {"class": cls}, deadline_s
        )

    def taxonomy_slice(
        self, oid: str, cls: str, deadline_s: Optional[float] = None
    ) -> dict:
        """One class's taxonomy neighborhood (equivalents, subsumers,
        subsumees, unsat flag) off the snapshot plane."""
        return self._query_read(
            oid, "slice", {"class": cls}, deadline_s
        )

    def snapshot_version(
        self, oid: str, deadline_s: Optional[float] = None
    ) -> dict:
        return self._query_read(oid, "version", {}, deadline_s)

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def metrics_text(self) -> str:
        return self._request("GET", "/metrics")
