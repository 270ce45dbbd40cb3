"""Frontend passes: normalization and synthetic corpora."""
