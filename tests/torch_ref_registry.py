"""A fixture for the port's test modules that run the reference.

The reference's program registry (``distel_tpu.core.program_cache.
PROGRAMS``) is process-wide, and under ``pytest -n --dist loadfile`` a
reference test file may run after a port test module in the same
worker: ``tests/test_bucketing.py::test_same_bucket_different_ontology_
shares_program`` times a cold build of a bucket that
``tests/test_torch_bucketing.py`` also runs through the reference.  A
module that imports :func:`reference_registry_as_found` leaves the
registry as it found it: the programs its reference runs built leave
when the module ends, and the counters and the farm hooks are put back.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def reference_registry_as_found():
    from distel_tpu.core.program_cache import PROGRAMS

    with PROGRAMS._lock:
        keys = set(PROGRAMS._programs)
        counters = (PROGRAMS.hits, PROGRAMS.misses, PROGRAMS.evictions)
    hooks = (PROGRAMS.artifact_source, PROGRAMS.artifact_sink)
    yield
    with PROGRAMS._lock:
        for key in [k for k in PROGRAMS._programs if k not in keys]:
            del PROGRAMS._programs[key]
        PROGRAMS.hits, PROGRAMS.misses, PROGRAMS.evictions = counters
    PROGRAMS.artifact_source, PROGRAMS.artifact_sink = hooks
