"""The serving plane — DistEL as a *resident* system.

The reference is not a batch job: Redis stays up, the traffic-data
scenario (``scripts/traffic-data-load-classify.sh``) streams deltas at a
live closure, and workers answer continuously.  This package is the
device-resident analog: a stdlib-only HTTP service that keeps engines
and device-resident closures warm across requests instead of paying
parse+plan per invocation.

Layout::

    registry.py   ontology registry — one IncrementalClassifier per
                  loaded ontology, traffic-driven demotion through the
                  hot/warm/cold storage tiers under a memory budget,
                  per-commit read-snapshot publishing
    scheduler.py  bounded-queue request scheduler — per-ontology
                  serialization, cross-ontology concurrency, delta
                  batching, admission control, deadlines
    query/        read-optimized query plane: lock-free versioned
                  immutable closure snapshots behind the /query/*
                  endpoints (reads never ride the scheduler lane)
    storage/      tier policy: per-ontology read/write EWMA picking
                  eviction victims and prefetch candidates
    metrics.py    Prometheus-text counters/gauges/summaries over the
                  registry/scheduler/instrumentation signals
    server.py     ThreadingHTTPServer app: the /v1 endpoints, /healthz,
                  /metrics, graceful SIGTERM shutdown with final spill
    client.py     tiny stdlib client (urllib) used by the tests, with
                  opt-in jittered retry/backoff honoring Retry-After
                  plus typed snapshot-read helpers carrying a
                  min_version watermark (read-your-writes)

The port of ``distel_tpu/serve/``, with the same exports.  Every module
is a copy of the reference's apart from its imports, except
``registry.py``, ``server.py`` and ``query/snapshot.py``, whose
docstrings say what differs.  The fleet (``fleet/``: router, replicas,
placement, supervisor; ``cli fleet``) is not ported yet.

Entry point: ``python -m distel_tpu_torch.cli serve --port 8080``
(one process, on the first CUDA device unless ``--device`` says
otherwise).
"""

from distel_tpu_torch.serve.query import (
    OntologySnapshot,
    SnapshotMiss,
    SnapshotStore,
    StaleSnapshot,
)
from distel_tpu_torch.serve.registry import ColdSpillCorrupted, OntologyRegistry
from distel_tpu_torch.serve.scheduler import (
    Deadline,
    QueueFull,
    RequestScheduler,
    ShuttingDown,
)
from distel_tpu_torch.serve.server import ServeApp, make_server

__all__ = [
    "ColdSpillCorrupted",
    "Deadline",
    "OntologyRegistry",
    "OntologySnapshot",
    "QueueFull",
    "RequestScheduler",
    "ServeApp",
    "ShuttingDown",
    "SnapshotMiss",
    "SnapshotStore",
    "StaleSnapshot",
    "make_server",
]
