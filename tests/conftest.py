"""Test config: run JAX on a virtual 8-device CPU mesh, and arm the
runtime lockdep shim for the concurrency suites.

Mirrors the reference's single-host-multi-shard test mode ("minimum of 7
Redis instances ... on the single machine", reference README.md:43): real
GSPMD partitioning, virtual devices.

The recipe itself (env pinning, backend-factory drop, pallas import order)
lives in distel_tpu.testing.cpumesh so the driver's multichip-gate
subprocess (__graft_entry__._dryrun_child) uses the identical code path.
"""

import pytest

from distel_tpu.testing.cpumesh import force_cpu_mesh

force_cpu_mesh(8, exact=True)

#: test modules whose whole point is concurrent locking — they run
#: under the runtime lockdep shim (distel_tpu/testing/lockdep.py): an
#: acquisition-order inversion observed on ANY schedule fails the
#: test, even when this run's interleaving didn't deadlock
_LOCKDEP_MODULES = ("test_serve_concurrency", "test_fleet")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "no_lockdep: opt out of the runtime lockdep shim (for tests "
        "that intentionally seed inversions or contend on raw locks)",
    )
    config.addinivalue_line(
        "markers",
        "slow: opt-in stress/soak harnesses excluded from tier-1 "
        "(`-m 'not slow'`); run explicitly, e.g. "
        "`pytest -m slow tests/test_restore_churn_stress.py`",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the distel_tpu_torch kernels have no "
        "CPU mode); skips without one — run on a card with "
        "`python -m pytest -m cuda tests/test_torch_*.py`",
    )


@pytest.fixture(autouse=True)
def _lockdep_guard(request):
    mod = getattr(request.node, "module", None)
    name = getattr(mod, "__name__", "")
    if (
        not any(name.endswith(m) for m in _LOCKDEP_MODULES)
        or request.node.get_closest_marker("no_lockdep") is not None
    ):
        yield
        return
    from distel_tpu.testing import lockdep

    lockdep.enable()
    # NO reset here: edges accumulate across the armed modules'
    # tests, so A->B observed in one test and B->A in a later one is
    # still caught as an inversion; check() consumes only the
    # violations, attributing each to the test whose schedule closed
    # the cycle
    try:
        yield
        # fail the test on inversions its schedule didn't deadlock on
        lockdep.check()
    finally:
        lockdep.disable()
