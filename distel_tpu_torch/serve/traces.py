"""Replayable traffic traces: record, validate, and replay op streams.

The reference's serving story was a shell script replaying a fixed
traffic file (``scripts/traffic-data-load-classify.sh``); ISSUE 16
upgrades that to a first-class recorded format so one replayer drives
every mixed add/retract/query scenario (``bench_serve --trace <file>``)
instead of a zoo of one-off scenario functions.

Format — JSON Lines, one op per line, blank lines and ``#`` comments
skipped::

    {"t": 0.0, "op": "load",    "ont": "o1", "text": "SubClassOf(A B)"}
    {"t": 0.4, "op": "add",     "ont": "o1", "text": "SubClassOf(C A)"}
    {"t": 0.9, "op": "query",   "ont": "o1", "kind": "taxonomy"}
    {"t": 1.1, "op": "query",   "ont": "o1", "kind": "subsumers",
     "class": "C"}
    {"t": 1.6, "op": "retract", "ont": "o1", "text": "SubClassOf(C A)"}
    {"t": 2.0, "op": "migrate", "ont": "o1"}

``t`` is seconds since trace start (non-decreasing — the recorder's
timestamps; the replayer paces by the deltas when asked to).  ``ont``
is the trace's LOGICAL ontology name: the replayer maps it to the
server-assigned id at ``load`` time, so a trace replays against any
fleet.  ``text`` payloads ride inline (payload-ref indirection via
``text_file`` resolves relative to the trace's directory, for corpora
too big to inline).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional

#: ops a trace line may carry, and the extra fields each requires
OPS = {
    "load": ("text",),
    "add": ("text",),
    "retract": ("text",),
    "query": ("kind",),
    "migrate": (),
}

#: query kinds the replayer can execute (scheduler-lane reads and the
#: lock-free snapshot plane)
QUERY_KINDS = ("taxonomy", "subsumers", "q_subsumers", "version")


class TraceError(ValueError):
    """A trace file failed validation — always carries the 1-based line
    number so a hand-edited trace pinpoints its own typo."""


class TraceRecorder:
    """Collects ops with relative timestamps; ``save`` writes the JSONL
    form ``load_trace`` reads back.  Timestamps are monotonic seconds
    since the recorder was created (first recorded op re-zeroes, so a
    slow harness setup never pads the trace's head)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self.events: List[dict] = []

    def record(self, op: str, ont: str, **fields) -> dict:
        if op not in OPS:
            raise TraceError(f"unknown trace op {op!r}")
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        ev = {"t": round(now - self._t0, 4), "op": op, "ont": ont}
        ev.update(fields)
        self.events.append(ev)
        return ev

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, sort_keys=True) + "\n")


def load_trace(path: str) -> List[dict]:
    """Parse + validate a trace file.  Refuses loudly (``TraceError``
    with the line number) on unknown ops, missing fields, or
    time-travel — a typo'd trace must never replay as a silently
    smaller workload."""
    events: List[dict] = []
    last_t = 0.0
    trace_dir = os.path.dirname(os.path.abspath(path))
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceError(f"{path}:{lineno}: not JSON: {e}")
            if not isinstance(ev, dict):
                raise TraceError(f"{path}:{lineno}: op must be an object")
            op = ev.get("op")
            if op not in OPS:
                raise TraceError(
                    f"{path}:{lineno}: unknown op {op!r} "
                    f"(known: {sorted(OPS)})"
                )
            if not isinstance(ev.get("ont"), str) or not ev["ont"]:
                raise TraceError(f"{path}:{lineno}: missing \"ont\"")
            t = ev.get("t", last_t)
            if not isinstance(t, (int, float)) or t < last_t:
                raise TraceError(
                    f"{path}:{lineno}: \"t\" must be a non-decreasing "
                    f"number (got {t!r} after {last_t})"
                )
            ev["t"] = float(t)
            last_t = ev["t"]
            # payload-ref indirection: resolve text_file to inline text
            if "text_file" in ev and "text" not in ev:
                ref = os.path.join(trace_dir, ev.pop("text_file"))
                try:
                    with open(ref) as tf:
                        ev["text"] = tf.read()
                except OSError as e:
                    raise TraceError(f"{path}:{lineno}: bad text_file: {e}")
            for field in OPS[op]:
                if field not in ev:
                    raise TraceError(
                        f"{path}:{lineno}: op {op!r} needs \"{field}\""
                    )
            if op == "query" and ev["kind"] not in QUERY_KINDS:
                raise TraceError(
                    f"{path}:{lineno}: unknown query kind "
                    f"{ev['kind']!r} (known: {list(QUERY_KINDS)})"
                )
            if (
                op == "query"
                and ev["kind"] in ("subsumers", "q_subsumers")
                and not ev.get("class")
            ):
                raise TraceError(
                    f"{path}:{lineno}: query kind {ev['kind']!r} needs "
                    "\"class\""
                )
            events.append(ev)
    if not events:
        raise TraceError(f"{path}: empty trace")
    return events


def replay_trace(
    events: List[dict],
    client,
    *,
    pace: float = 0.0,
    migrate: Optional[Callable[[str], dict]] = None,
) -> dict:
    """Replay a validated trace against a :class:`ServeClient`.

    ``pace``: multiplier on the recorded inter-op gaps (0 = as fast as
    possible, 1 = recorded cadence).  ``migrate``: callable taking the
    SERVER ontology id (the fleet router's ``migrate``); without one,
    ``migrate`` ops are skipped and counted — a single-replica replay
    has nowhere to migrate to, and the count keeps the record honest.

    Returns per-op ok/failed counts, wall, and the logical→server id
    map.  Request failures (``ServeError``) are counted, not raised:
    the replayer's job is to measure the stream, and the caller
    decides whether ``failed_requests`` must be zero."""
    from distel_tpu_torch.serve.client import ServeError

    oids: Dict[str, str] = {}
    ok: Dict[str, int] = {}
    failed: Dict[str, int] = {}
    skipped_migrates = 0
    t0 = time.monotonic()
    trace_t0 = events[0]["t"]
    for ev in events:
        if pace > 0:
            due = t0 + (ev["t"] - trace_t0) * pace
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        op, ont = ev["op"], ev["ont"]
        try:
            if op == "load":
                rec = client.load(ev["text"])
                oids[ont] = rec["id"]
            else:
                oid = oids.get(ont)
                if oid is None:
                    raise ServeError(
                        0, f"trace op {op!r} before load of {ont!r}", {}
                    )
                if op == "add":
                    client.delta(oid, ev["text"])
                elif op == "retract":
                    client.retract(oid, ev["text"])
                elif op == "migrate":
                    if migrate is None:
                        skipped_migrates += 1
                        continue
                    migrate(oid)
                else:  # query
                    kind = ev["kind"]
                    if kind == "taxonomy":
                        client.taxonomy(oid)
                    elif kind == "subsumers":
                        client.subsumers(oid, ev["class"])
                    elif kind == "q_subsumers":
                        client.query_subsumers(oid, ev["class"])
                    else:  # version
                        client.snapshot_version(oid)
        except ServeError:
            failed[op] = failed.get(op, 0) + 1
        else:
            if not (op == "migrate" and migrate is None):
                ok[op] = ok.get(op, 0) + 1
    wall = time.monotonic() - t0
    return {
        "events": len(events),
        "ok": ok,
        "failed": failed,
        "failed_requests": sum(failed.values()),
        "skipped_migrates": skipped_migrates,
        "wall_s": round(wall, 4),
        "ontologies": dict(oids),
    }
