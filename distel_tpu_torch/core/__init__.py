"""Core: indexing, the saturation engines and the CPU oracle."""
