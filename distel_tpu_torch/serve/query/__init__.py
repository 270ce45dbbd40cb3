"""Read-optimized query plane: lock-free versioned closure snapshots
served off the scheduler lane (see ``snapshot.py`` for the design)."""

from distel_tpu_torch.serve.query.snapshot import (
    OntologySnapshot,
    SnapshotMiss,
    SnapshotStore,
    StaleSnapshot,
)

__all__ = [
    "OntologySnapshot",
    "SnapshotMiss",
    "SnapshotStore",
    "StaleSnapshot",
]
