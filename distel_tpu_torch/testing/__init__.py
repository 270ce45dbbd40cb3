"""Verification helpers: the differential check against the CPU oracle."""
