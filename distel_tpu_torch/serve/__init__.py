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
    fleet/        horizontal scale-out: router + shared-nothing replica
                  processes — affinity placement, live ontology
                  migration over the registry's spill/restore wire,
                  heartbeat eject-and-respawn, queue-depth rebalance,
                  read-snapshot replication + /query fan-out

The port of ``distel_tpu/serve/``, with the same exports.  Every module
is a copy of the reference's apart from its imports, except
``registry.py``, ``server.py``, ``query/snapshot.py`` and
``fleet/supervisor.py``, whose docstrings say what differs.

Entry points: ``python -m distel_tpu_torch.cli serve --port 8080`` (one
process) and ``python -m distel_tpu_torch.cli fleet --replicas 4
--spill-dir /var/tmp/distel-spill`` (router + replicas).  Every process
runs on the first CUDA device unless ``--device`` says otherwise; the
replicas of a fleet all run on the one device its ``--device`` names.
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
