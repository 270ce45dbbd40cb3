"""The mesh: ranks of one ``torch.distributed`` group, one shard a rank.

The port of ``distel_tpu/parallel/mesh.py``.  The reference builds a
1-D ``jax.sharding.Mesh`` over the (global) device list and joins JAX's
multi-controller runtime when a coordinator is configured.  PyTorch's
idiom for several cards is one process a card: a mesh here is the ranks
of a process group, each holding one shard of the engines' state and
running the same host loop, with NCCL between cards and gloo on the CPU
(or between ranks that share a card, which NCCL refuses).

* :func:`init_distributed` joins a group from the reference's keys
  (``coordinator.address``, ``num.processes``, ``process.id``) over TCP;
  without a coordinator it does nothing, as the reference's does.
* :func:`build_mesh` takes the group's ranks as the mesh.  **One rank is
  one shard**, so inside a group the mesh size is the world size: a
  partial mesh is refused (the reference refuses one under several
  hosts), and so is a mesh larger than the group (where the reference
  would multiply devices per process).  Outside a group only a mesh of
  one exists, in process; a larger one raises, naming the launchers.
* :func:`launch_local` is the local launcher, the counterpart of the
  reference's one process over N local chips: N spawned ranks over a
  ``FileStore`` rendezvous in a temporary directory (no port to race
  for), rank ``r`` on ``cuda:(r % device_count)`` or on the CPU.  A rank
  that fails fails the launch with its traceback; the other ranks are
  terminated.  Nothing retries and nothing falls back to the CPU.

Every collective has the group's timeout, so a rank that diverges fails
its peers instead of hanging them.  The shard primitives live in
:mod:`distel_tpu_torch.parallel.shard_compat`.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

#: seconds a collective (and the rendezvous) may wait for its peers
COLLECTIVE_TIMEOUT_S = 300.0


@dataclass(eq=False)
class Mesh:
    """A 1-D mesh: ``size`` ranks along ``axis``, this process being
    ``rank``; ``group`` is the process group of the collectives (None for
    the in-process mesh of one; a mesh of one runs no collective),
    ``device`` the rank's device."""

    size: int
    rank: int = 0
    axis: str = "c"
    group: Optional[Any] = None
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as the reference's ``mesh.shape``."""
        return {self.axis: self.size}

    @property
    def backend(self) -> Optional[str]:
        """The group's backend (None for the in-process mesh of one)."""
        return dist.get_backend(self.group) if self.group is not None else None


def backend_for(device, world: int) -> str:
    """``nccl`` when each of ``world`` ranks has a card of its own,
    ``gloo`` otherwise (the CPU, or ranks sharing a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _join(init_method: str, world: int, rank: int, device,
          timeout_s: float = COLLECTIVE_TIMEOUT_S) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(dev, world), init_method=init_method,
        world_size=world, rank=rank, timeout=timedelta(seconds=timeout_s),
    )


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cpu",
    timeout_s: float = COLLECTIVE_TIMEOUT_S,
) -> bool:
    """Join the process group the reference's keys describe (idempotent:
    a process already in a group stays in it).  Returns whether a group
    is active.  With no coordinator this does nothing — the
    single-process path.  ``coordinator_address`` is ``host:port`` (or
    a full ``tcp://`` / ``file://`` URL); ``device`` is this rank's;
    ``timeout_s`` bounds each collective of the group."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "coordinator.address needs num.processes and process.id: "
            "every rank of the group names the world size and its rank"
        )
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    _join(url, int(num_processes), int(process_id), device, timeout_s)
    return True


def _rank_device(device) -> torch.device:
    """``device`` as the port's entry points take it: None means the
    card, and raises when there is none."""
    from distel_tpu_torch.runtime.classifier import resolve_device

    return resolve_device(device)


def setup(config, device=None) -> Optional[Mesh]:
    """The classifier's bootstrap: join the group the config names,
    then build the mesh — the world under a coordinator, ``mesh.devices``
    otherwise, or None for a single device.  The order matters:
    :func:`build_mesh` reads the group.  ``device``: this rank's (None =
    the card; raises when there is none).  Outside a group, a config that
    names neither a mesh nor a coordinator builds nothing and reads no
    device."""
    if not (config.coordinator_address or config.mesh_devices
            or dist.is_initialized()):
        return None
    device = _rank_device(device)
    joined = init_distributed(
        config.coordinator_address, config.num_processes, config.process_id,
        device=device,
    )
    if joined or config.mesh_devices:
        return build_mesh(config.mesh_devices or None, device=device)
    return None


def build_mesh(n_devices: Optional[int] = None, axis: str = "c",
               device=None) -> Mesh:
    """A 1-D mesh of ``n_devices`` ranks (None = the whole group).
    Inside a group it is the group itself; outside one, a mesh of one.
    ``device``: this rank's (None = the card; raises when there is
    none)."""
    dev = _rank_device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        n = world if n_devices is None else int(n_devices)
        if n > world:
            raise ValueError(
                f"mesh of {n} devices requested but only {world} ranks are "
                "in the group: one rank is one shard, so a process cannot "
                "hold several devices of the mesh"
            )
        if n != world:
            # every rank runs the same collectives: a rank outside the
            # mesh would wait for them forever
            raise ValueError(
                f"partial mesh ({n} of {world} ranks) is not supported; "
                "omit mesh.devices to span the group"
            )
        return Mesh(size=world, rank=rank, axis=axis, group=dist.group.WORLD,
                    device=dev)
    if n_devices is None or int(n_devices) == 1:
        return Mesh(size=1, rank=0, axis=axis, device=dev)
    raise ValueError(
        f"a mesh of {n_devices} devices needs {n_devices} ranks: run "
        f"`cli classify --mesh {n_devices}` or "
        "parallel.mesh.launch_local, or give the coordinator keys "
        "(coordinator.address, num.processes, process.id) to each rank"
    )


# ------------------------------------------------------------ the launcher


def _rank_main(rank: int, world: int, workdir: str, device: str,
               timeout_s: float, fn, args) -> None:
    """One spawned rank: join the group, run ``fn(device, *args)``, write
    its result (or its traceback) to ``workdir``, leave the group.  The
    result is written before the group is torn down, so a rank that
    finished counts as finished however its teardown goes."""
    out = os.path.join(workdir, f"rank{rank}.pkl")

    def write(rec) -> None:
        with open(out + ".tmp", "wb") as f:
            pickle.dump(rec, f)
        os.replace(out + ".tmp", out)

    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        _join(f"file://{os.path.join(workdir, 'store')}", world, rank, dev,
              timeout_s)
        write(("ok", fn(dev, *args)))
    except BaseException:  # noqa: BLE001 — reported to the launcher, re-raised
        write(("error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankFailed(RuntimeError):
    """A rank of :func:`launch_local` failed; the message holds its
    traceback (or its exit code when it left none)."""


def launch_local(n: int, fn: Callable, *args, device=None,
                 timeout_s: float = COLLECTIVE_TIMEOUT_S) -> List[Any]:
    """Run ``fn(device, *args)`` on ``n`` spawned ranks of one group and
    return every rank's result, rank 0 first.  ``fn`` is a module-level
    function (it is pickled by name).  ``device``: ``"cpu"`` puts every
    rank on the CPU (gloo); otherwise (None = the cards) rank ``r`` runs
    on ``cuda:(r % device_count)``, over NCCL when every rank has a card
    of its own and gloo when ranks share one.  Raises
    :class:`RankFailed` with every failed rank's traceback; the other
    ranks are terminated.  ``timeout_s`` bounds each collective (a
    diverged rank fails its peers); the launch as a whole is not
    bounded."""
    import multiprocessing as mp

    n = int(n)
    if n < 1:
        raise ValueError(f"launch_local needs at least one rank, got {n}")
    if device is not None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "launch_local: no CUDA device; pass device='cpu' to run "
                "the ranks on the CPU"
            )
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(n)]
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="distel_mesh_")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(
                target=_rank_main,
                args=(r, n, workdir, devices[r], timeout_s, fn, args),
                name=f"distel-rank{r}",
            )
            p.start()
            procs.append(p)
        while any(p.is_alive() for p in procs) and all(
            p.exitcode in (None, 0) for p in procs
        ):
            time.sleep(0.02)
        if any(p.exitcode not in (None, 0) for p in procs):
            # a peer of the failed rank fails in its next collective:
            # give the others a moment to leave their own tracebacks
            deadline = time.monotonic() + 5.0
            while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
                time.sleep(0.05)
        results: List[Any] = []
        failures = []
        for r, p in enumerate(procs):
            p.join(timeout=0 if p.exitcode is None else None)
            path = os.path.join(workdir, f"rank{r}.pkl")
            rec = None
            if p.exitcode is not None and os.path.exists(path):
                with open(path, "rb") as f:
                    rec = pickle.load(f)
            if rec is not None and rec[0] == "ok":
                results.append(rec[1])
            elif rec is not None and rec[0] == "error":
                failures.append(f"rank {r} of {n} failed:\n{rec[1]}")
            elif p.exitcode is not None:
                failures.append(f"rank {r} of {n} exited {p.exitcode} "
                                "with no result")
        if failures:
            raise RankFailed("\n".join(failures))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def refuse_mesh(config, plane: str) -> None:
    """Raise ``NotImplementedError`` naming ``plane`` when ``config``
    asks for a mesh or a process group: the planes that have no sharded
    mode refuse it rather than run each rank alone."""
    keys = [k for k, v in (("mesh.devices", config.mesh_devices),
                           ("coordinator.address", config.coordinator_address))
            if v]
    if keys:
        raise NotImplementedError(
            f"{plane} does not run on a mesh ({', '.join(keys)} is set); "
            "classify, stream (the incremental plane), serve (one "
            "registry mirrored on every rank) and the hybrid shard "
            "their fixed points"
        )
