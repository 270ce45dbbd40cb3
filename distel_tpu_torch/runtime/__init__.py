"""Runtime: the end-to-end classifier, taxonomy and snapshots."""
