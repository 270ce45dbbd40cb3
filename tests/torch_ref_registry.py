"""A fixture for the port's test modules that run the reference.

The reference's program registry (``distel_tpu.core.program_cache.
PROGRAMS``) is process-wide, and under ``pytest -n --dist loadfile`` a
port test module may share a worker with reference test files, before
or after them.  Two faults follow:

* after a port module: ``tests/test_bucketing.py::test_same_bucket_
  different_ontology_shares_program`` times a cold build of a bucket
  that ``tests/test_torch_bucketing.py`` also runs through the
  reference;
* before a port module: ``tests/test_artifacts.py``'s farm leaves
  deserialized programs in the registry, built for another device
  count, and a reference run inside a port test that hits one of them
  dies (``execute_sharded_on_local_devices`` expecting 8 shards).

A module that imports :func:`reference_registry_as_found` therefore
runs its reference on an EMPTY registry: at module start the programs
found there are set aside, the counters zeroed and the farm hooks
detached; at module end the module's own programs leave and all of it
is put back.  The persistent compile cache
(``distel_tpu.config.enable_compile_cache``) is left alone: its entries
are keyed by the program and the devices it was built for, and no
failure traced to it.
"""

import contextlib

import pytest


@contextlib.contextmanager
def empty_reference_registry():
    """Run the body on an empty reference ``PROGRAMS`` (counters zeroed,
    farm hooks detached); afterwards the body's programs leave and what
    was found is put back."""
    from distel_tpu.core.program_cache import PROGRAMS

    with PROGRAMS._lock:
        found = dict(PROGRAMS._programs)
        counters = (PROGRAMS.hits, PROGRAMS.misses, PROGRAMS.evictions)
        PROGRAMS._programs.clear()
        PROGRAMS.hits = PROGRAMS.misses = PROGRAMS.evictions = 0
    hooks = (PROGRAMS.artifact_source, PROGRAMS.artifact_sink)
    PROGRAMS.artifact_source = PROGRAMS.artifact_sink = None
    try:
        yield
    finally:
        with PROGRAMS._lock:
            PROGRAMS._programs.clear()
            PROGRAMS._programs.update(found)
            PROGRAMS.hits, PROGRAMS.misses, PROGRAMS.evictions = counters
        PROGRAMS.artifact_source, PROGRAMS.artifact_sink = hooks


@pytest.fixture(autouse=True, scope="module")
def reference_registry_as_found():
    with empty_reference_registry():
        yield
