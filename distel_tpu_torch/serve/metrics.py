"""Prometheus-text metrics for the serve plane (stdlib only).

A deliberately small subset of the Prometheus client model — counters,
gauges (value or callable), histograms with fixed buckets, plus a
renderer for ``PhaseAggregate`` (``runtime/instrumentation.py``) as
summaries — enough for the ops signals the resident service needs
(request rates, queue depth, batch sizes, fast-path vs rebuild ratio,
evictions) without a dependency.  Rendered in text exposition format
(version 0.0.4) by :meth:`Metrics.render`.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Optional, Tuple, Union

#: request-latency buckets (seconds): sub-10 ms queries through
#: multi-minute saturations
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)

_LabelKey = Tuple[Tuple[str, str], ...]

#: ``name`` prefix of one exposition sample line (the label block, when
#: present, is scanned by :func:`split_sample` — a regex over the whole
#: line would mis-split label VALUES containing ``}`` or spaces)
_NAME_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)")

#: suffixes histogram/summary samples hang off their family name
_FAMILY_SUFFIXES = ("_bucket", "_sum", "_count", "_max")


def escape_label_value(value: str) -> str:
    """Text-exposition-format label-value escaping: backslash, double
    quote, and line feed — an ontology id carrying any of them must not
    corrupt the page (one unescaped ``"`` desyncs every later sample)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def escape_help(text: str) -> str:
    """HELP-line escaping per the text format: backslash and line feed
    (quotes are legal in HELP)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def split_sample(line: str):
    """``(name, label_block_or_None, rest)`` for one sample line, or
    None when the line is not a sample.  The label block is scanned
    character-wise respecting quoted values and backslash escapes —
    the one place ``}`` / spaces / escaped quotes inside a label value
    are NOT structure."""
    m = _NAME_RE.match(line)
    if m is None:
        return None
    name = m.group(1)
    i = m.end()
    labels = None
    if i < len(line) and line[i] == "{":
        j = i + 1
        in_quotes = False
        escaped = False
        while j < len(line):
            c = line[j]
            if escaped:
                escaped = False
            elif c == "\\":
                escaped = True
            elif c == '"':
                in_quotes = not in_quotes
            elif c == "}" and not in_quotes:
                break
            j += 1
        if j >= len(line):
            return None  # unterminated label block: not a valid sample
        labels = line[i : j + 1]
        i = j + 1
    rest = line[i:].strip()
    if not rest:
        return None
    return name, labels, rest


def relabel_sample(line: str, extra: str) -> str:
    """Inject pre-formatted label pairs (``'replica="r0"'``) into one
    sample line; comment/blank/unparseable lines pass through
    unchanged."""
    if not line or line.startswith("#"):
        return line
    parts = split_sample(line)
    if parts is None:
        return line
    name, labels, value = parts
    if labels and labels != "{}":
        merged = labels[:-1] + "," + extra + "}"
    else:
        # absent OR empty block: '{,replica=...}' would be malformed
        merged = "{" + extra + "}"
    return f"{name}{merged} {value}"


def aggregate_expositions(pages: Dict[str, str]) -> str:
    """Merge replicas' ``/metrics`` pages into one exposition, every
    sample relabeled with ``replica="<rid>"`` — the router's aggregated
    view of a shared-nothing fleet.  ``pages``: rid → page text.  Same
    metric family across replicas renders as ONE group (HELP/TYPE once,
    first replica's wording wins) so the output stays parseable by a
    single scrape."""
    helps: Dict[str, list] = {}
    samples: Dict[str, list] = {}
    order: list = []
    for rid in sorted(pages):
        extra = f'replica="{rid}"'
        families = set(helps)
        for line in pages[rid].splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                    fam = parts[2]
                    families.add(fam)
                    acc = helps.setdefault(fam, [])
                    if not any(line.split(None, 2)[1] == kept.split(None, 2)[1]
                               for kept in acc):
                        acc.append(line)
                continue
            parts = split_sample(line)
            if parts is None:
                continue
            name = parts[0]
            fam = name
            if name not in families:
                for suf in _FAMILY_SUFFIXES:
                    if name.endswith(suf) and name[: -len(suf)] in families:
                        fam = name[: -len(suf)]
                        break
            if fam not in samples:
                samples[fam] = []
                order.append(fam)
            samples[fam].append(relabel_sample(line, extra))
    lines = []
    for fam in order:
        lines.extend(helps.get(fam, []))
        lines.extend(samples[fam])
    return "\n".join(lines) + ("\n" if lines else "")


_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")


def parse_label_block(block: str) -> Dict[str, str]:
    """Strictly parse one ``{name="value",...}`` label block (escape
    sequences decoded); raises ValueError on any malformation."""
    if not block.startswith("{") or not block.endswith("}"):
        raise ValueError(f"not a label block: {block!r}")
    labels: Dict[str, str] = {}
    i, n = 1, len(block)
    while i < n - 1 or (i == n - 1 and block[i] != "}"):
        m = _LABEL_NAME_RE.match(block, i)
        if m is None:
            raise ValueError(f"bad label name at {i} in {block!r}")
        lname = m.group(0)
        i = m.end()
        if i >= n or block[i] != "=":
            raise ValueError(f"missing '=' after {lname!r} in {block!r}")
        i += 1
        if i >= n or block[i] != '"':
            raise ValueError(f"unquoted value for {lname!r} in {block!r}")
        i += 1
        buf = []
        while i < n:
            c = block[i]
            if c == "\\":
                if i + 1 >= n:
                    raise ValueError(f"dangling escape in {block!r}")
                nxt = block[i + 1]
                if nxt == "n":
                    buf.append("\n")
                elif nxt in ('"', "\\"):
                    buf.append(nxt)
                else:
                    raise ValueError(
                        f"bad escape \\{nxt} in {block!r}"
                    )
                i += 2
            elif c == '"':
                i += 1
                break
            else:
                buf.append(c)
                i += 1
        else:
            raise ValueError(f"unterminated value in {block!r}")
        if lname in labels:
            raise ValueError(f"duplicate label {lname!r} in {block!r}")
        labels[lname] = "".join(buf)
        if i < n and block[i] == ",":
            i += 1
            continue
        if i < n and block[i] == "}":
            break
        raise ValueError(f"junk after value of {lname!r} in {block!r}")
    return labels


def _parse_value(token: str) -> float:
    if token == "+Inf":
        return math.inf
    if token == "-Inf":
        return -math.inf
    if token == "NaN":
        return math.nan
    return float(token)


def parse_exposition(text: str) -> Dict[str, dict]:
    """STRICT text-exposition parser — the guard a real scraper stands
    in for.  Returns ``{family: {"help", "type", "samples":
    [(name, labels, value)]}}`` and raises ValueError on anything a
    conforming scraper would reject:

    * a line that is neither blank, a comment, nor a well-formed sample
      (label values scanned with escape handling);
    * more than one HELP or TYPE line per family;
    * a family's samples split across non-contiguous sections (the
      aggregated fleet page must merge same-named families into ONE
      group);
    * histogram/summary suffix samples (``_bucket``/``_sum``/
      ``_count``/``_max``) attached to a family of the wrong type, or a
      histogram without its ``le="+Inf"`` bucket / ``_sum`` /
      ``_count``.
    """
    families: Dict[str, dict] = {}
    open_fam: Optional[str] = None
    closed: set = set()

    def _family(name: str) -> str:
        # suffix samples fold into their declared histogram/summary
        for suf in _FAMILY_SUFFIXES:
            if name.endswith(suf):
                base = name[: -len(suf)]
                fam = families.get(base)
                if fam is not None and fam["type"] in (
                    "histogram", "summary",
                ):
                    return base
        return name

    def _open(fam: str, line: str) -> dict:
        nonlocal open_fam
        if fam != open_fam:
            if open_fam is not None:
                closed.add(open_fam)
            if fam in closed:
                raise ValueError(
                    f"family {fam!r} re-opened after closing "
                    f"(non-contiguous group) at: {line!r}"
                )
            open_fam = fam
        return families.setdefault(
            fam, {"help": None, "type": "untyped", "samples": []}
        )

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = parts[2]
                rec = _open(fam, line)
                if parts[1] == "HELP":
                    if rec["help"] is not None:
                        raise ValueError(f"duplicate HELP for {fam!r}")
                    rec["help"] = parts[3] if len(parts) > 3 else ""
                else:
                    if rec["samples"]:
                        raise ValueError(
                            f"TYPE for {fam!r} after its samples"
                        )
                    if rec["type"] != "untyped":
                        raise ValueError(f"duplicate TYPE for {fam!r}")
                    if len(parts) < 4:
                        raise ValueError(f"TYPE without a type: {line!r}")
                    rec["type"] = parts[3]
            continue
        parts = split_sample(line)
        if parts is None:
            raise ValueError(f"unparseable sample line: {line!r}")
        name, block, rest = parts
        labels = parse_label_block(block) if block else {}
        tokens = rest.split()
        if len(tokens) not in (1, 2):
            raise ValueError(f"bad value/timestamp in: {line!r}")
        value = _parse_value(tokens[0])
        if len(tokens) == 2:
            int(tokens[1])  # timestamp must be integral milliseconds
        fam = _family(name)
        rec = _open(fam, line)
        if rec["type"] == "histogram":
            if name == fam:
                raise ValueError(
                    f"bare sample {name!r} under histogram family"
                )
            if name.endswith("_bucket") and "le" not in labels:
                raise ValueError(f"_bucket without le label: {line!r}")
        elif name != fam and rec["type"] != "summary":
            # suffixed name that didn't fold: its own untyped family
            pass
        rec["samples"].append((name, labels, value))
    for fam, rec in families.items():
        if rec["type"] != "histogram":
            continue
        kinds = {n[len(fam):] for n, _, _ in rec["samples"]}
        if not {"_bucket", "_sum", "_count"} <= kinds:
            raise ValueError(
                f"histogram {fam!r} missing _bucket/_sum/_count"
            )
        series_keys = {
            tuple(sorted((k, v) for k, v in lb.items() if k != "le"))
            for n, lb, _ in rec["samples"] if n == fam + "_bucket"
        }
        inf_keys = {
            tuple(sorted((k, v) for k, v in lb.items() if k != "le"))
            for n, lb, _ in rec["samples"]
            if n == fam + "_bucket" and lb.get("le") == "+Inf"
        }
        if series_keys != inf_keys:
            raise ValueError(
                f"histogram {fam!r} has a series without an le=\"+Inf\" "
                "bucket"
            )
    return families


def _labels_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


def _fmt_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{escape_label_value(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class Metrics:
    """Thread-safe metric registry.  All mutators are cheap (dict upsert
    under one lock) — safe on the request path."""

    def __init__(self):
        self._lock = threading.Lock()
        #: name → {labels_key → value}
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        #: name → value | zero-arg callable (sampled at render time)
        self._gauges: Dict[str, Union[float, Callable[[], float]]] = {}
        #: name → (buckets, {labels_key → [bucket_counts, sum, count]})
        self._hists: Dict[str, tuple] = {}
        #: callables returning {name → value}, one call per render pass
        self._gauge_groups: list = []
        #: callables returning {name → cumulative value}, sampled once
        #: per render pass and rendered as TYPE counter — for
        #: process-global monotonic tallies owned outside the registry
        #: (the program-cache and artifact-farm aggregates)
        self._counter_groups: list = []
        #: name → (label_name, fn returning {label_value → value}) —
        #: live-sampled LABELED gauge families (one label dimension,
        #: e.g. ``distel_step_rule_seconds{rule=...}``)
        self._labeled_gauge_fns: Dict[str, Tuple[str, Callable]] = {}
        self._help: Dict[str, str] = {}

    # ------------------------------------------------------------ write

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    def counter_inc(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        value: float = 1.0,
    ) -> None:
        key = _labels_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def counter_value(
        self, name: str, labels: Optional[Dict[str, str]] = None
    ) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_labels_key(labels), 0.0)

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_fn(self, name: str, fn: Callable[[], float]) -> None:
        """Register a live-sampled gauge (e.g. queue depth): called at
        render time, so the scrape always sees the current value."""
        with self._lock:
            self._gauges[name] = fn

    def gauge_labeled_fn(
        self, name: str, label: str, fn: Callable[[], Dict[str, float]]
    ) -> None:
        """Register a live-sampled labeled gauge family: ``fn`` returns
        ``{label_value: value}`` and is called once per render pass, so
        one family renders as ``name{label="k"} v`` per entry — the
        per-rule step-attribution gauges
        (``distel_step_rule_seconds{rule=...}``) use this."""
        with self._lock:
            self._labeled_gauge_fns[name] = (label, fn)

    def gauge_group(self, fn: Callable[[], Dict[str, float]]) -> None:
        """Register a group of live-sampled gauges: ``fn`` returns a
        ``{name: value}`` dict and is called ONCE per render pass, so
        every gauge in the group is derived from the same sample —
        mutually consistent within one scrape even under concurrent
        scrapes (each pass gets its own call)."""
        with self._lock:
            self._gauge_groups.append(fn)

    def counter_group(
        self, fn: Callable[[], Dict[str, float]]
    ) -> None:
        """Register a group of live-sampled counters: ``fn`` returns
        ``{name: cumulative_value}`` and is called once per render
        pass.  The counter twin of :meth:`gauge_group`, for monotonic
        process-global tallies that live outside this registry (e.g.
        ``PROGRAMS.stats()`` / ``ARTIFACT_EVENTS.snapshot()``) — the
        families render with ``TYPE counter`` and carry the ``_total``
        naming discipline the exposition lint enforces."""
        with self._lock:
            self._counter_groups.append(fn)

    def observe(
        self,
        name: str,
        value: float,
        labels: Optional[Dict[str, str]] = None,
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> None:
        key = _labels_key(labels)
        with self._lock:
            bks, series = self._hists.setdefault(
                name, (tuple(buckets), {})
            )
            acc = series.get(key)
            if acc is None:
                acc = series[key] = [[0] * len(bks), 0.0, 0]
            counts, _, _ = acc
            # per-bucket storage (render cumulates into le-buckets)
            for i, b in enumerate(bks):
                if value <= b:
                    counts[i] += 1
                    break
            acc[1] += value
            acc[2] += 1

    # ------------------------------------------------------------- read

    def render(self, phase_aggregate=None) -> str:
        """Text exposition format.  ``phase_aggregate``: an optional
        ``PhaseAggregate`` rendered as per-phase summaries
        (``distel_request_phase_seconds{phase=...}``)."""
        with self._lock:
            counters = {
                n: dict(s) for n, s in sorted(self._counters.items())
            }
            gauges = dict(self._gauges)
            groups = list(self._gauge_groups)
            cgroups = list(self._counter_groups)
            labeled = dict(self._labeled_gauge_fns)
            hists = {
                n: (b, {k: (list(c), s, cnt) for k, (c, s, cnt) in se.items()})
                for n, (b, se) in sorted(self._hists.items())
            }
            helps = dict(self._help)
        for fn in groups:
            try:
                gauges.update(fn())
            except Exception:  # a dying group must not kill /metrics
                continue
        for fn in cgroups:
            try:
                sampled = fn()
            except Exception:  # a dying group must not kill /metrics
                continue
            for n, v in sampled.items():
                counters.setdefault(n, {})[()] = float(v)
        gauges = dict(sorted(gauges.items()))
        lines = []
        for name, series in sorted(counters.items()):
            if name in helps:
                lines.append(f"# HELP {name} {escape_help(helps[name])}")
            lines.append(f"# TYPE {name} counter")
            for key, v in sorted(series.items()):
                lines.append(f"{name}{_fmt_labels(key)} {_fmt_value(v)}")
        for name, v in gauges.items():
            if callable(v):
                try:
                    v = float(v())
                except Exception:  # a dying gauge must not kill /metrics
                    continue
            if name in helps:
                lines.append(f"# HELP {name} {escape_help(helps[name])}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt_value(v)}")
        for name, (label, fn) in sorted(labeled.items()):
            try:
                series = {str(k): float(v) for k, v in fn().items()}
            except Exception:  # a dying family must not kill /metrics
                continue
            if name in helps:
                lines.append(f"# HELP {name} {escape_help(helps[name])}")
            lines.append(f"# TYPE {name} gauge")
            for k, v in sorted(series.items()):
                lab = _fmt_labels(_labels_key({label: k}))
                lines.append(f"{name}{lab} {_fmt_value(v)}")
        for name, (bks, series) in hists.items():
            if name in helps:
                lines.append(f"# HELP {name} {escape_help(helps[name])}")
            lines.append(f"# TYPE {name} histogram")
            for key, (counts, total, cnt) in sorted(series.items()):
                cum = 0
                for b, c in zip(bks, counts):
                    cum += c
                    le = 'le="%s"' % _fmt_value(b)
                    lines.append(
                        f"{name}_bucket{_fmt_labels(key, le)} {cum}"
                    )
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_fmt_labels(key, inf)} {cnt}"
                )
                lines.append(
                    f"{name}_sum{_fmt_labels(key)} {_fmt_value(total)}"
                )
                lines.append(f"{name}_count{_fmt_labels(key)} {cnt}")
        if phase_aggregate is not None:
            snap = phase_aggregate.snapshot()
            if snap:
                nm = "distel_request_phase_seconds"
                lines.append(
                    f"# HELP {nm} per-request pipeline phase wall time"
                )
                lines.append(f"# TYPE {nm} summary")
                for phase, acc in sorted(snap.items()):
                    lab = _fmt_labels(_labels_key({"phase": phase}))
                    lines.append(
                        f"{nm}_sum{lab} {_fmt_value(acc['total_s'])}"
                    )
                    lines.append(f"{nm}_count{lab} {acc['count']}")
                    mlab = _fmt_labels(_labels_key({"phase": phase}))
                    lines.append(
                        f"{nm}_max{mlab} {_fmt_value(acc['max_s'])}"
                    )
        return "\n".join(lines) + "\n"
