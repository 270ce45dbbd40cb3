"""Saturation progress observability.

Parity with the reference's progress plane (SURVEY.md §2.5/§5):

* ``worksteal/ProgressMessageHandler.java:74-111`` — a pub-sub listener
  accumulating per-iteration progress fractions per worker, consumed by the
  work stealer to find the laggard.  SPMD has no laggards, but the
  per-superstep derivation telemetry is still the operator's window into a
  long classification run.
* ``misc/ResultSnapshotter.java:22-53`` — timed BGSAVE snapshots used to
  plot completeness-over-time curves.

Here the unit of observation is the superstep of
``SaturationEngine.saturate_observed``: after each fused round the engine
reports ``(iteration, cumulative derivations, changed)``; this module turns
that stream into progress records, a completeness curve, an estimated
completion fraction (the reference's per-worker fraction, globalized), and
optional timed state snapshots.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, TextIO, Tuple


@dataclass
class ProgressRecord:
    iteration: int
    derivations: int
    elapsed_s: float
    changed: bool

    @property
    def rate(self) -> float:
        return self.derivations / self.elapsed_s if self.elapsed_s > 0 else 0.0


@dataclass
class ProgressReporter:
    """Callable observer for ``SaturationEngine.saturate_observed``.

    Collects one :class:`ProgressRecord` per superstep; optionally echoes
    progress lines (the analog of the reference's
    ``iter@host:port:type@fraction`` pub-sub messages,
    ``base/Type1_1AxiomProcessorBase.java:256-263``).  For timed state
    snapshots between incremental batches use
    ``runtime.checkpoint.Snapshotter``.
    """

    echo: bool = False
    stream: TextIO = field(default_factory=lambda: sys.stderr)
    records: List[ProgressRecord] = field(default_factory=list)
    _t0: Optional[float] = None

    def __call__(self, iteration: int, derivations: int, changed: bool) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            # first event: elapsed time counts from observer creation if the
            # caller primed it, else from the first superstep
            self._t0 = now
        rec = ProgressRecord(
            iteration=iteration,
            derivations=derivations,
            elapsed_s=now - self._t0,
            changed=changed,
        )
        self.records.append(rec)
        if self.echo:
            frac = self.completion_fraction()
            print(
                f"iter={iteration} derivations={derivations} "
                f"fraction={frac:.3f} elapsed={rec.elapsed_s:.2f}s",
                file=self.stream,
                flush=True,
            )

    def start(self) -> "ProgressReporter":
        """Prime the clock before the run so the first superstep's elapsed
        time includes its own compute (and compile)."""
        self._t0 = time.perf_counter()
        return self

    # ------------------------------------------------------------ analysis

    def completeness_curve(self) -> List[Tuple[float, int]]:
        """(elapsed_s, cumulative derivations) points — the data behind the
        reference's snapshot-every-2-min completeness plots."""
        return [(r.elapsed_s, r.derivations) for r in self.records]

    def completion_fraction(self) -> float:
        """1.0 once converged; mid-run, the ratio of the previous
        superstep's cumulative derivations to the current one — a growth
        estimate that climbs toward 1 as the frontier drains, matching the
        spirit of the reference's per-iteration fraction (which was
        likewise relative to the work known so far, not the true total)."""
        if not self.records:
            return 0.0
        last = self.records[-1]
        if not last.changed:
            return 1.0
        if len(self.records) == 1 or last.derivations == 0:
            return 0.0
        return self.records[-2].derivations / last.derivations

    def summary(self) -> dict:
        if not self.records:
            return {"supersteps": 0}
        last = self.records[-1]
        return {
            "supersteps": len(self.records),
            "iterations": last.iteration,
            "derivations": last.derivations,
            "elapsed_s": round(last.elapsed_s, 3),
            "derivations_per_s": round(last.rate, 1),
            "converged": not last.changed,
        }
