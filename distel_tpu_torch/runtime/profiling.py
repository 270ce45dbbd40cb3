"""Step profiling: where does a superstep's device time go?

The port of ``distel_tpu/runtime/profiling.py``.  The reference wraps
each rule family in ``jax.named_scope`` and aggregates an xplane
capture's per-op device self-times by scope.  Here the engines open a
``torch.profiler.record_function`` scope named with the reference's
tokens around each rule (``runtime/instrumentation.rule_scope``: only
while a profiler records, and never a synchronisation), and
:func:`profile_saturation` traces one full ``saturate()`` under
``torch.profiler`` and attributes each device event to the innermost
token scope around its launch (:func:`phase_split`).  On the CPU the
device is the CPU: its outermost operators are its kernels.

Captured graphs.  A bucketed engine on a card runs each group of
``unroll`` steps as one CUDA graph replay; the replay's kernels are all
launched by one ``cudaGraphLaunch`` inside the ``step`` scope, so no
rule scope sees them.  They are labelled instead from an eager run of
the same group, traced after the profiled run (twice, at the fixed
point, so it changes nothing; the second run's events are the labels):
its device events (kernels, copies, memsets) in order on the stream,
each with the rule around its launch, are matched one for one to each
replay's device events in start order, every kernel by name
(:func:`group_labels`; a graph may run a copy node as a kernel).  The
split is then the replays' own times (``"captured": true``).  A replay
whose events do not match the labels raises: nothing is guessed.

Collectives: a kernel whose name holds ``nccl`` is ``vote_psum``, or
``bit_table_psum`` inside a ``bit_table`` scope, as the reference
names its all-reduces.  gloo's collectives run on the host and show
in ``host_gap_s``.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: innermost-wins: bit_table nests inside cr4/cr6
_PHASE_TOKENS = (
    "bit_table", "cr1", "cr2", "cr3", "cr4", "cr5", "cr6", "frontier",
)

#: every phase a split can name
PHASES = ("bit_table_psum", "cr1", "cr2", "cr3", "cr4", "cr5", "cr6",
          "frontier", "vote_psum", "other")

#: trace categories of device work on a card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def _phase(token: Optional[str], kernel_name: str = "") -> str:
    if "nccl" in kernel_name.lower():
        return "bit_table_psum" if token == "bit_table" else "vote_psum"
    if token is None:
        return "other"
    return "bit_table_psum" if token == "bit_table" else token


class _Scopes:
    """The token scopes of one thread, for innermost-enclosing lookups
    (record_function scopes on a thread nest properly)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in spans]
        self.spans = spans
        #: each span's innermost enclosing span (-1: none)
        self.parent = []
        stack: List[int] = []
        for i, (s, e, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float) -> Optional[str]:
        """The innermost scope open at ``t``: the latest span starting
        at or before ``t`` or, when it closed before ``t``, its nearest
        enclosing span that is still open (nesting makes every span
        that started earlier and is open at ``t`` an ancestor)."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else None


def _scopes_by_thread(events) -> Dict[Tuple, _Scopes]:
    by: Dict[Tuple, list] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in _PHASE_TOKENS:
            ts = float(e["ts"])
            by.setdefault((e.get("pid"), e.get("tid")), []).append(
                (ts, ts + float(e.get("dur", 0.0)), e["name"]))
    return {k: _Scopes(v) for k, v in by.items()}


def _complete(trace) -> list:
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("ph") == "X"]


def _outermost_cpu_ops(events) -> list:
    """The CPU's kernels: operators not inside another operator on
    their thread."""
    out = []
    by: Dict[Tuple, list] = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            by.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for ops in by.values():
        ops.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        end = float("-inf")
        for e in ops:
            if float(e["ts"]) >= end:
                out.append(e)
                end = float(e["ts"]) + float(e.get("dur", 0.0))
    return out


def _launches(events) -> Dict[int, dict]:
    """Runtime/driver API events by correlation id."""
    return {
        e["args"]["correlation"]: e for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver")
        and "correlation" in e.get("args", {})
    }


def group_labels(trace) -> List[Tuple[str, str, str]]:
    """``[(name, phase, category)]`` of the device events (kernels,
    copies, memsets) of a traced eager run of one step group, in launch
    order: the labels of a captured group's replays."""
    events = _complete(trace)
    scopes = _scopes_by_thread(events)
    launch = _launches(events)
    rows = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        rt = launch.get(e.get("args", {}).get("correlation"))
        tok = None
        if rt is not None:
            sc = scopes.get((rt.get("pid"), rt.get("tid")))
            tok = sc.at(float(rt["ts"])) if sc else None
        # the device's order: one stream runs them as launched
        rows.append((float(e["ts"]), e["name"], _phase(tok, e["name"]), e["cat"]))
    rows.sort(key=lambda r: r[0])
    return [(n, ph, cat) for _, n, ph, cat in rows]


def _labels_match(labels, evs) -> bool:
    """One device event a label, in order, the kernels by name (a copy
    node of a graph may run as a kernel of another name)."""
    return len(labels) == len(evs) and all(
        cat != "kernel" or name == e["name"]
        for (name, _ph, cat), e in zip(labels, evs)
    )


def phase_split(trace, device_type: str = "cuda",
                labels: Optional[Sequence[Tuple[str, str, str]]] = None) -> dict:
    """Aggregate a chrome trace (``torch.profiler``'s export, or its
    ``traceEvents``) into ``{"phases": {phase: s}, "kernels": {name: s},
    "device_total_s", "graph_replays", "device_events"}``.

    On a card the device events are its kernels, copies and memsets,
    each attributed to the innermost token scope open on the host
    thread when it was launched; the kernels of a CUDA graph replay take
    ``labels`` (:func:`group_labels`) in order, and raise when there
    are none or they do not match.  On the CPU (``device_type`` "cpu")
    the device events are the outermost operators, attributed to the
    scope open around them."""
    events = _complete(trace)
    scopes = _scopes_by_thread(events)
    phases: Dict[str, float] = {}
    kernels: Dict[str, float] = {}

    def add(phase, name, dur_us):
        phases[phase] = phases.get(phase, 0.0) + dur_us * 1e-6
        kernels[name] = kernels.get(name, 0.0) + dur_us * 1e-6

    if device_type != "cuda":
        ops = _outermost_cpu_ops(events)
        for e in ops:
            sc = scopes.get((e.get("pid"), e.get("tid")))
            tok = sc.at(float(e["ts"])) if sc else None
            add(_phase(tok), e["name"], float(e.get("dur", 0.0)))
        return {"phases": phases, "kernels": kernels,
                "device_total_s": sum(phases.values()),
                "graph_replays": 0, "device_events": len(ops)}

    launch = _launches(events)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    replays: Dict[int, list] = {}
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        rt = launch.get(corr)
        if rt is not None and rt.get("name") in _GRAPH_LAUNCH:
            replays.setdefault(corr, []).append(e)
            continue
        tok = None
        if rt is not None:
            sc = scopes.get((rt.get("pid"), rt.get("tid")))
            tok = sc.at(float(rt["ts"])) if sc else None
        add(_phase(tok, e["name"]), e["name"], float(e.get("dur", 0.0)))
    for corr, evs in replays.items():
        evs.sort(key=lambda e: float(e["ts"]))
        if labels is None or not _labels_match(labels, evs):
            first = next((i for i, (lab, e) in enumerate(zip(labels or [], evs))
                          if lab[2] == "kernel" and lab[0] != e["name"]), None)
            raise RuntimeError(
                f"a CUDA graph replay (correlation {corr}) ran "
                f"{len(evs)} device events that the eager group's "
                f"{0 if labels is None else len(labels)} labels do not "
                "match in order; its time cannot be split by rule"
                + ("" if first is None else
                   f" (first differing event {first}: label "
                   f"{labels[first][0][:80]!r}, replay {evs[first]['name'][:80]!r})")
            )
        for (_name, phase, _cat), e in zip(labels, evs):
            add(phase, e["name"], float(e.get("dur", 0.0)))
    return {"phases": phases, "kernels": kernels,
            "device_total_s": sum(phases.values()),
            "graph_replays": len(replays), "device_events": len(dev)}


def device_record(device) -> dict:
    """The device a profile ran on: ``"cpu"``, or the card's name,
    count and power limit (``nvidia-smi``; None where it cannot say)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu"}
    rec = {"platform": "gpu", "name": torch.cuda.get_device_name(dev),
           "count": torch.cuda.device_count(), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.strip().splitlines()
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx < len(out):
            rec["power_limit"] = out[idx].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return rec


def _trace(device, fn, path: str, what: str = ""):
    """Run ``fn`` under ``torch.profiler`` (with the card's activity on
    a card) and export the chrome trace to ``path``; returns ``(fn's
    value, wall seconds, trace dict)``.  With ``what``, a progress line
    on standard error says when the traced run is over: the rest is
    host work on the trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        if what:
            print(f"profile: traced {what} done in {wall:.3f} s", file=sys.stderr,
                  flush=True)
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        return out, wall, json.load(f)


def _eager_group_labels(engine, path: str, n_events: int):
    """Trace two eager runs of ``engine``'s bucketed step group at its
    fixed point and return the labels (:func:`group_labels`) of the
    last ``n_events`` device events: the second run's, whatever the
    first run's first launches cost the trace."""
    prog = engine._bucket_program()

    def run():
        with prog.pair.lock:
            prog.step.bind(engine.mesh)
            prog._group()
            prog._group()

    _, _, trace = _trace(engine.device, run, path)
    return group_labels(trace)[-n_events:]


def profile_saturation(
    engine,
    *,
    initial=None,
    trace_dir: Optional[str] = None,
    max_iters: int = 10_000,
) -> dict:
    """Trace one full ``saturate()`` and return the per-phase split.

    Output fields (the reference's): ``phases_s`` (seconds of device
    time per phase over the WHOLE run), ``per_step_s`` (the same over
    the iterations), ``device_total_s``, ``wall_s``, ``host_gap_s``
    (wall less device time: host orchestration), ``iterations``,
    ``derivations``; and the port's: ``device`` (:func:`device_record`),
    ``captured`` (the run replayed CUDA graphs, split by their group's
    labels), ``graph_replays``, ``kernels_s`` (device seconds by kernel
    name; on the CPU by operator), ``idle_share`` (``host_gap_s`` /
    ``wall_s``) and ``step_cost`` (the engine's
    ``step_cost_model()``, where it has one).  On a card a trace with
    no kernel event raises."""
    own = trace_dir is None
    if own:
        trace_dir = tempfile.mkdtemp(prefix="distel_profile_")
    os.makedirs(trace_dir, exist_ok=True)
    dev = torch.device(engine.device)
    t_run = time.perf_counter()
    try:
        result, wall, trace = _trace(
            dev, lambda: engine.saturate(max_iters, initial=initial),
            os.path.join(trace_dir, "saturate.trace.json"), "saturate")
        labels = None
        events = _complete(trace)
        graph_corr = {e["args"]["correlation"] for e in events
                      if e.get("name") in _GRAPH_LAUNCH and "correlation" in e.get("args", {})}
        replays = bool(graph_corr)
        if replays:
            per_replay = {}
            for e in events:
                c = e.get("args", {}).get("correlation")
                if c in graph_corr and e.get("cat") in _DEVICE_CATS:
                    per_replay[c] = per_replay.get(c, 0) + 1
            labels = _eager_group_labels(
                engine, os.path.join(trace_dir, "group.trace.json"),
                max(per_replay.values(), default=0))
        split = phase_split(trace, dev.type, labels)
        overhead = time.perf_counter() - t_run - wall
    finally:
        if own:
            shutil.rmtree(trace_dir, ignore_errors=True)
    if dev.type == "cuda" and not any(
        e.get("cat") == "kernel" for e in _complete(trace)
    ):
        raise RuntimeError(
            "the profiler recorded no CUDA kernel on the card (is CUPTI "
            "tracing available?); a split of zeros is not a profile"
        )
    phases = split["phases"]
    steps = max(result.iterations, 1)
    device_total = split["device_total_s"]
    per_step = {k: round(v / steps, 5) for k, v in sorted(phases.items())}
    # feed the process-global per-rule aggregate: the serve plane's
    # distel_step_rule_seconds{rule=...} gauges export the latest
    # measured split (runtime/instrumentation.STEP_RULE_EVENTS)
    from distel_tpu_torch.runtime.instrumentation import STEP_RULE_EVENTS

    STEP_RULE_EVENTS.record(per_step, source="profile_saturation")
    out = {
        "phases_s": {k: round(v, 4) for k, v in sorted(phases.items())},
        "per_step_s": per_step,
        "device_total_s": round(device_total, 3),
        "wall_s": round(wall, 3),
        "host_gap_s": round(wall - device_total, 3),
        "iterations": int(result.iterations),
        "derivations": int(result.derivations),
        "device": device_record(dev),
        "captured": bool(replays),
        "graph_replays": split["graph_replays"],
        # what the profile cost beyond the traced run: the trace's
        # export and parse, the eager group, the split
        "trace_handling_s": round(overhead, 3),
        "idle_share": round((wall - device_total) / wall, 4) if wall > 0 else None,
        "kernels_s": {k: round(v, 6) for k, v in sorted(
            split["kernels"].items(), key=lambda kv: -kv[1])},
    }
    if hasattr(engine, "step_cost_model"):
        out["step_cost"] = engine.step_cost_model()
    return out
