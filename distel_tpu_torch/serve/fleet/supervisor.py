"""Replica process supervisor.

Spawns N shared-nothing replica processes (``cli serve --replica-id``),
each its own Python interpreter — its own GIL, its own CUDA context and
caching allocator, its own scheduler and registry — on one host.  All
replicas share the spill directory (the migration handoff moves a
``.npz`` path, not bytes) and the kernels the tree has built.

The supervisor owns process lifecycle only; health judgment and
placement live in the router (it calls :meth:`respawn` after an
ejection).  Each replica's stdout/stderr goes to a per-replica log file
— the startup line (``{"serving": true, "port": ...}``) is read back
from it to learn the ephemerally bound port.

The port's copy of ``distel_tpu/serve/fleet/supervisor.py``.  What
differs, and why:

* The opening paragraph and :meth:`start` say what a replica is and
  costs here: a CUDA context and the torch import, where the reference
  names a jax runtime, the XLA compile cache it shares and its warmup.
* ``_spawn`` runs ``python -m distel_tpu_torch.cli serve``: the replicas
  are the port's serve processes (there is no compile cache to share).
  The device rides ``extra_args`` (``cli fleet`` passes its
  ``--device`` to every replica).
* ``_farm_args`` is the reference's (its docstring's first line names
  no ticket): a port farm (``core/artifacts.py``) at
  ``<spill_dir>/artifacts`` reaches every spawned and respawned replica
  (a manifest of another environment is refused by each replica's
  install, loudly, and the replica builds).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple


class ReplicaStartupError(RuntimeError):
    """A replica process died or never printed its serving line."""


class _Proc:
    __slots__ = ("rid", "proc", "port", "log_path")

    def __init__(self, rid, proc, port, log_path):
        self.rid = rid
        self.proc = proc
        self.port = port
        self.log_path = log_path


class ReplicaSupervisor:
    def __init__(
        self,
        n: int,
        *,
        spill_dir: str,
        log_dir: Optional[str] = None,
        host: str = "127.0.0.1",
        extra_args: Optional[List[str]] = None,
        env: Optional[Dict[str, str]] = None,
        startup_timeout_s: float = 180.0,
    ):
        if n < 1:
            raise ValueError("a fleet needs at least one replica")
        self.n = n
        self.spill_dir = spill_dir
        self.log_dir = log_dir or os.path.join(spill_dir, "logs")
        self.host = host
        self.extra_args = list(extra_args or ())
        self.env = dict(env) if env is not None else dict(os.environ)
        self.startup_timeout_s = startup_timeout_s
        self._procs: Dict[str, _Proc] = {}
        os.makedirs(self.spill_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)

    # --------------------------------------------------------- lifecycle

    def start(self) -> List[Tuple[str, str]]:
        """Spawn every replica; returns ``[(rid, url), ...]`` for the
        router.  Spawns are issued in parallel (the startup cost is the
        torch import) and awaited together."""
        rids = [f"r{i}" for i in range(self.n)]
        for rid in rids:
            self._spawn(rid)
        return [(rid, self._await_serving(rid)) for rid in rids]

    def respawn(self, rid: str) -> str:
        """Replace a (presumed dead) replica process; returns the new
        url.  The old process, if somehow alive, is killed first — two
        processes must never share a replica id."""
        old = self._procs.get(rid)
        if old is not None and old.proc.poll() is None:
            old.proc.kill()
            old.proc.wait(timeout=30)
        self._spawn(rid)
        return self._await_serving(rid)

    def urls(self) -> List[Tuple[str, str]]:
        return [
            (rid, f"http://{self.host}:{p.port}")
            for rid, p in self._procs.items()
            if p.port is not None
        ]

    def alive(self, rid: str) -> bool:
        p = self._procs.get(rid)
        return p is not None and p.proc.poll() is None

    def stop(self, graceful: bool = True, timeout_s: float = 60.0) -> None:
        """SIGTERM everything (graceful: replicas drain + spill), then
        SIGKILL stragglers."""
        for p in self._procs.values():
            if p.proc.poll() is None:
                p.proc.send_signal(
                    signal.SIGTERM if graceful else signal.SIGKILL
                )
        deadline = time.monotonic() + timeout_s
        for p in self._procs.values():
            left = max(0.1, deadline - time.monotonic())
            try:
                p.proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                p.proc.kill()
                p.proc.wait(timeout=30)

    # ----------------------------------------------------------- spawns

    def _farm_args(self) -> List[str]:
        """The shared spill-dir artifact wire: when the farm
        manifest sits at ``<spill_dir>/artifacts/manifest.json``, every
        spawned/respawned replica consumes it automatically — an
        autoscaled replica serves its first request with zero
        trace/compile without the operator re-plumbing flags.  An
        explicit ``--artifacts-dir`` in ``extra_args`` wins."""
        if "--artifacts-dir" in self.extra_args:
            return []
        farm = os.path.join(self.spill_dir, "artifacts")
        if os.path.exists(os.path.join(farm, "manifest.json")):
            return ["--artifacts-dir", farm]
        return []

    def _spawn(self, rid: str) -> None:
        log_path = os.path.join(self.log_dir, f"{rid}.log")
        log = open(log_path, "w", encoding="utf-8")
        try:
            proc = subprocess.Popen(
                [
                    sys.executable, "-m", "distel_tpu_torch.cli", "serve",
                    "--host", self.host, "--port", "0",
                    "--replica-id", rid,
                    "--spill-dir", self.spill_dir,
                    *self._farm_args(),
                    *self.extra_args,
                ],
                stdout=log,
                stderr=subprocess.STDOUT,
                env=self.env,
            )
        finally:
            # the child inherited the descriptor; the parent's handle
            # would otherwise leak one fd per (re)spawn
            log.close()
        self._procs[rid] = _Proc(rid, proc, None, log_path)

    def _await_serving(self, rid: str) -> str:
        """Poll the replica's log for the startup line and return its
        url."""
        p = self._procs[rid]
        deadline = time.monotonic() + self.startup_timeout_s
        while time.monotonic() < deadline:
            if p.proc.poll() is not None:
                raise ReplicaStartupError(
                    f"replica {rid} exited with {p.proc.returncode} "
                    f"before serving (log: {p.log_path})"
                )
            try:
                with open(p.log_path, "r", encoding="utf-8") as f:
                    for line in f:
                        line = line.strip()
                        if not line.startswith("{"):
                            continue
                        try:
                            doc = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if doc.get("serving"):
                            p.port = int(doc["port"])
                            return f"http://{self.host}:{p.port}"
            except OSError:
                pass
            time.sleep(0.1)
        raise ReplicaStartupError(
            f"replica {rid} never printed its serving line within "
            f"{self.startup_timeout_s:.0f}s (log: {p.log_path})"
        )
