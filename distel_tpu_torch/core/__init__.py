"""Core: indexing and the row-packed saturation engine."""
