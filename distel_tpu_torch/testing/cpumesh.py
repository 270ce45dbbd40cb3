"""A mesh of N ranks on this host's CPU.

The counterpart of ``distel_tpu/testing/cpumesh.py``, which pins JAX to
a virtual multi-device CPU backend so one process holds an N-device
mesh.  The port's mesh is a process group, one shard a rank, so its
CPU mesh is N gloo ranks: :func:`cpu_mesh_run` is
:func:`~distel_tpu_torch.parallel.mesh.launch_local` on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, List

from distel_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT_S, launch_local


def cpu_mesh_run(n: int, fn: Callable, *args,
                 timeout_s: float = COLLECTIVE_TIMEOUT_S) -> List[Any]:
    """``fn(device, *args)`` on ``n`` gloo ranks on the CPU; every
    rank's result, rank 0 first (a failing rank raises
    :class:`~distel_tpu_torch.parallel.mesh.RankFailed`)."""
    return launch_local(n, fn, *args, device="cpu", timeout_s=timeout_s)
