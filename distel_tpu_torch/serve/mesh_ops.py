"""The serve plane's op stream: one registry mirrored on every rank of a mesh.

A torch mesh is N processes (``parallel/mesh.py``: one shard a rank),
and every tenant of a registry on a mesh is an ``IncrementalClassifier``
sharded over all of them, so every rank must run every operation that
touches the card or runs a collective — loads, deltas, retractions,
promotions and restores, demotions, spills, idle-program drops — in one
order, while HTTP arrives at one process only.  This module has no
counterpart in the reference, whose mesh lives in one process.

* Rank 0 (:class:`OpStream`, owned by rank 0's ``OntologyRegistry``)
  publishes ``(seq, op, oid, args)`` records to every other rank, runs
  the operation itself, and collects each rank's answer — all under one
  lock (:attr:`OpStream.lock`, the *mesh lock*), so two tenants'
  collectives never interleave on the group.  Decisions are rank 0's:
  eviction victims, prefetch targets and warm shedding are chosen from
  its own bytes and published as explicit ops naming the tenant.
* Every other rank runs :func:`follow`: it applies the records strictly
  in ``seq`` order against its own registry (no budget, no snapshot
  store) and answers each one.

The channel is a TCP socket a follower, never a collective: a follower
blocks on it with no deadline while the server is idle, and either side
sees the other go at once (end of stream).  The engines' collectives
stay on the group ``parallel/mesh`` joins, built once a process and
shared by every tenant.

No fallback hides a broken mesh.  A follower that exits, an operation
whose outcome differs between ranks (one rank raises where another does
not, or raises another error), or an answer that does not come within
the collective timeout breaks the stream: the write in flight fails
with :class:`MeshBroken`, and every later operation raises it at once.
Rank 0 never carries on writing alone.

Start-up: with ``mesh.devices = N`` and no coordinator, rank 0 (the
process that builds the registry) spawns the N - 1 followers itself
(``cli serve``); with the coordinator keys each rank is started by the
user, ``process.id = 0`` builds the registry and serves HTTP, and every
other process runs :func:`follow` (``cli serve`` does so).  Rank 0 sends
each follower its registry's settings, and when there is a spill
directory a marker file every follower must read there: a spill
directory some rank cannot see is refused at start-up, by name.
"""

from __future__ import annotations

import os
import pickle
import queue
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
import uuid
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

#: what a follower sends back after each write: nothing more than the
#: tenant's history record (None), the closure's ``live_digest`` of
#: every rank ("digest"), or the live S and R themselves ("state";
#: small ontologies only: the tests hold every rank to the reference)
REPORTS = (None, "digest", "state")

#: the operations that commit a new closure for their tenant
WRITES = ("load", "delta", "retract", "resident")


class MeshBroken(RuntimeError):
    """The serve plane's mesh lost a rank or diverged; the server
    answers writes and ``/healthz`` with 503 from then on."""


# ------------------------------------------------------------ the wire


def _send(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("!Q", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise EOFError("the peer closed the op stream")
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket):
    (n,) = struct.unpack("!Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


# ------------------------------------------------------------- reports


def op_report(registry, op: str, oid: Optional[str], mode) -> dict:
    """What a rank answers after ``op`` on ``oid``: for a write, the
    tenant's last history record, and per ``mode`` its closure's digest
    or live S and R (:data:`REPORTS`)."""
    import numpy as np

    if op not in WRITES or oid is None:
        return {}
    entry = registry._entries.get(oid)
    inc = entry.inc if entry is not None else None
    if inc is None or not inc.history or inc.last_result is None:
        return {}
    res = inc.last_result
    rec = {"history": dict(inc.history[-1])}
    if mode == "digest":
        rec["digest"] = res.live_digest()
    elif mode == "state":
        n, nl = res.idx.n_concepts, res.idx.n_links
        rec["s"] = np.asarray(res.s)[:n, :n].copy()
        rec["r"] = np.asarray(res.r)[:n, :nl].copy()
    return rec


def _counters() -> tuple:
    """This process's collective and kernel-launch counts."""
    from distel_tpu_torch.ops import bitmatmul
    from distel_tpu_torch.parallel.shard_compat import COLLECTIVES

    return COLLECTIVES.snapshot(), dict(bitmatmul.LAUNCHES)


def rank_summary(device, since: tuple) -> dict:
    """A rank's counters at close: collectives (calls, bytes, host
    seconds) and kernel launches since ``since`` (:func:`_counters` when
    the stream started), and the process's peak card allocation."""
    (coll0, launch0), (coll, launch) = since, _counters()
    dev = torch.device(device)
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else None)
    zero = {"calls": 0, "bytes": 0, "seconds": 0.0}
    return {
        "pid": os.getpid(),
        "collectives": {op: {k: v[k] - coll0.get(op, zero)[k] for k in zero}
                        for op, v in coll.items()},
        "launches": {k: v - launch0.get(k, 0) for k, v in launch.items()
                     if v - launch0.get(k, 0)},
        "max_memory_allocated": peak,
    }


def _outcome(err: Optional[BaseException]):
    return None if err is None else type(err).__name__


# ------------------------------------------------------------- rank 0


#: seconds the spawned ranks may take to import the port before they
#: join (the group's own timeout, which bounds each collective, may be
#: shorter than an import)
START_TIMEOUT_S = 600.0


def _spawn_followers(world: int, device: torch.device, config,
                     timeout_s: float) -> tuple:
    """Start ranks 1..world-1 (spawned processes running
    :func:`_follower_main`) over a ``FileStore`` rendezvous, and wait
    until each has imported the port; returns ``(processes,
    init_method, workdir)``.  Rank ``r`` runs on the CPU when rank 0
    does, else on ``cuda:(r % device_count)``."""
    import multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="distel_serve_mesh_")
    init_method = f"file://{os.path.join(workdir, 'store')}"
    ctx = mp.get_context("spawn")
    procs = []
    for r in range(1, world):
        if device.type == "cuda":
            dev = f"cuda:{r % torch.cuda.device_count()}"
        else:
            dev = "cpu"
        p = ctx.Process(
            target=_follower_main,
            args=(r, world, init_method, dev, timeout_s, config),
            name=f"distel-serve-rank{r}", daemon=True,
        )
        p.start()
        procs.append(p)
    deadline = time.monotonic() + START_TIMEOUT_S
    waiting = set(range(1, world))
    while waiting:
        waiting = {r for r in waiting
                   if not os.path.exists(os.path.join(workdir, f"ready{r}"))}
        dead = [p for p in procs if p.exitcode is not None]
        if dead or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            raise RuntimeError(
                "the serve mesh did not start: "
                + (f"{dead[0].name} exited {dead[0].exitcode}" if dead else
                   f"ranks {sorted(waiting)} not ready in {START_TIMEOUT_S:g} s"))
        time.sleep(0.02)
    return procs, init_method, workdir


def _listen_host(config) -> str:
    """Where rank 0 listens: the coordinator's host when the ranks are
    started by hand (they may be on other hosts), else the loopback."""
    addr = config.coordinator_address
    if addr and "://" not in addr:
        host = addr.rsplit(":", 1)[0]
        if host not in ("", "localhost"):
            return host
    return "127.0.0.1"


class OpStream:
    """Rank 0's end of the op stream (see the module docstring).
    Built by :meth:`start`; ``registry_kw`` are the settings every
    follower's registry takes (spill directory, fast-path cutoff)."""

    def __init__(self, mesh, socks: dict, procs: list, timeout_s: float,
                 report, workdir: Optional[str]):
        self.mesh = mesh
        #: the mesh lock: held from an operation's publish to its
        #: completion on every rank
        self.lock = threading.RLock()
        self.timeout_s = float(timeout_s)
        self.report = report
        #: why the mesh is broken (None while it is whole)
        self.broken: Optional[str] = None
        #: one record an operation: seq, op, oid, and each rank's answer
        self.log: List[dict] = []
        self.seq = 0
        self._socks = socks
        self._procs = procs
        self._workdir = workdir
        self._closing = False
        #: the counts the close record starts from
        self._since = _counters()
        self._inbox = {r: queue.Queue() for r in socks}
        self._readers = []
        for r, s in socks.items():
            t = threading.Thread(target=self._read, args=(r, s), daemon=True,
                                 name=f"distel-mesh-ack-{r}")
            t.start()
            self._readers.append(t)

    # ---------------------------------------------------------- start-up

    @classmethod
    def start(cls, config, device: torch.device, *, registry_kw: dict,
              timeout_s: Optional[float] = None, report=None) -> Optional["OpStream"]:
        """Join (or, with ``mesh.devices`` and no coordinator, spawn) the
        mesh the config names and connect every follower; None when it
        names a mesh of one.  Raises on any rank that cannot start."""
        from distel_tpu_torch.parallel import mesh as pmesh

        if report not in REPORTS:
            raise ValueError(f"mesh report must be one of {REPORTS}, got {report!r}")
        timeout_s = pmesh.COLLECTIVE_TIMEOUT_S if timeout_s is None else timeout_s
        procs, workdir = [], None
        spawn = (not dist.is_initialized() and not config.coordinator_address
                 and (config.mesh_devices or 0) > 1)
        try:
            if spawn:
                world = int(config.mesh_devices)
                procs, init_method, workdir = _spawn_followers(
                    world, device, config, timeout_s)
                pmesh._join(init_method, world, 0, device, timeout_s)
            elif config.coordinator_address and not dist.is_initialized():
                pmesh.init_distributed(
                    config.coordinator_address, config.num_processes,
                    config.process_id, device=device, timeout_s=timeout_s)
            mesh = pmesh.setup(config, device)
            if mesh is None or mesh.size == 1:
                return None
            if mesh.rank != 0:
                raise RuntimeError(
                    f"rank {mesh.rank} of the mesh follows rank 0's op stream: "
                    "run distel_tpu_torch.serve.mesh_ops.follow (cli serve "
                    "does so for process.id > 0); only rank 0 builds the "
                    "serve registry")
            socks = cls._connect(mesh, config, registry_kw, report, timeout_s)
        except BaseException:
            for p in procs:
                p.kill()
                p.join(timeout=30)
            if dist.is_initialized():
                dist.destroy_process_group()
            raise
        return cls(mesh, socks, procs, timeout_s, report, workdir)

    @staticmethod
    def _connect(mesh, config, registry_kw, report, timeout_s) -> dict:
        """Listen, tell every rank where (one broadcast on the group),
        accept one connection a follower and hand each its settings and
        the spill directory's marker; every follower must answer ready."""
        lsock = socket.create_server((_listen_host(config), 0))
        lsock.settimeout(timeout_s)
        host, port = lsock.getsockname()[:2]
        dist.broadcast_object_list([f"{host}:{port}"], src=0, group=mesh.group)
        spill_dir = registry_kw.get("spill_dir")
        marker = token = None
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            token = uuid.uuid4().hex
            marker = os.path.join(spill_dir, f".mesh-{token}")
            with open(marker, "w") as f:
                f.write(token)
        socks = {}
        try:
            for _ in range(mesh.size - 1):
                conn, _addr = lsock.accept()
                conn.settimeout(timeout_s)
                hello = _recv(conn)
                socks[int(hello["rank"])] = conn
            for r, conn in sorted(socks.items()):
                _send(conn, {"registry_kw": registry_kw, "report": report,
                             "marker": marker, "token": token})
            failures = []
            for r, conn in sorted(socks.items()):
                ready = _recv(conn)
                if ready.get("error"):
                    failures.append(f"rank {r}: {ready['error']}")
                conn.settimeout(None)
            if failures:
                raise RuntimeError(
                    "the serve mesh did not start: " + "; ".join(failures))
        except BaseException:
            for conn in socks.values():
                conn.close()
            raise
        finally:
            lsock.close()
            if marker:
                try:
                    os.unlink(marker)
                except OSError:
                    pass
        return socks

    # ---------------------------------------------------------- running

    def _read(self, rank: int, sock: socket.socket) -> None:
        try:
            while True:
                self._inbox[rank].put(_recv(sock))
        except (EOFError, OSError) as e:
            if not self._closing:
                self._fail(f"rank {rank} of the mesh is gone: its op stream "
                           f"closed ({type(e).__name__}: {e}){self._exit_note(rank)}")
            self._inbox[rank].put(None)

    def _exit_note(self, rank: int) -> str:
        for p in self._procs:
            if p.name.endswith(f"rank{rank}"):
                p.join(timeout=1.0)
                if p.exitcode is not None:
                    return f"; the process exited {p.exitcode}"
        return ""

    def _fail(self, why: str) -> None:
        if self.broken is None:
            self.broken = why
            print(f"distel serve mesh: {why}", file=sys.stderr, flush=True)

    def check(self) -> None:
        """Raise :class:`MeshBroken` when the mesh is broken."""
        if self.broken is not None:
            raise MeshBroken(f"the serve mesh is broken: {self.broken}")

    def run(self, op: str, oid: Optional[str], args: tuple, fn: Callable,
            report: Callable[[], dict]) -> Any:
        """Publish ``op``, run ``fn()`` here, collect every follower's
        answer; return ``fn``'s result (or raise its error when every
        rank raised the same).  Any other outcome breaks the mesh."""
        with self.lock:
            self.check()
            self.seq += 1
            seq = self.seq
            for r, sock in self._socks.items():
                try:
                    _send(sock, (seq, op, oid, args))
                except OSError as e:
                    self._fail(f"rank {r} of the mesh is gone: publishing op "
                               f"{seq} ({op}) failed: {e}")
                    self.check()
            t0 = time.perf_counter()
            err, out = None, None
            try:
                out = fn()
            except BaseException as e:  # noqa: BLE001 — compared with the followers'
                err = e
            mine = {"rank": 0, "ok": err is None, "error": _outcome(err),
                    "wall_s": time.perf_counter() - t0}
            if err is None:
                mine.update(report())
            ranks = [mine]
            deadline = time.monotonic() + self.timeout_s
            for r in sorted(self._socks):
                try:
                    ack = self._inbox[r].get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    ack = None
                    self._fail(f"rank {r} did not answer op {seq} ({op} "
                               f"{oid}) within {self.timeout_s:g} s")
                if ack is None:
                    self._fail(f"rank {r} of the mesh is gone (op {seq}, "
                               f"{op} {oid}){self._exit_note(r)}")
                    break
                ranks.append(ack)
                if ack["seq"] != seq or ack["error"] != mine["error"]:
                    self._fail(
                        f"the ranks diverged at op {seq} ({op} {oid}): rank 0 "
                        f"{'raised ' + mine['error'] if err else 'succeeded'}, "
                        f"rank {r} "
                        f"{'raised ' + ack['error'] + ': ' + ack['message'] if ack['error'] else 'succeeded'}")
            self.log.append({"seq": seq, "op": op, "oid": oid, "ranks": ranks})
            if self.broken is not None:
                raise MeshBroken(
                    f"the serve mesh is broken: {self.broken}") from err
            if err is not None:
                raise err
            return out

    # ---------------------------------------------------------- closing

    def close(self, device) -> List[dict]:
        """Publish ``close``, collect every follower's summary
        (:func:`rank_summary` and its op walls), wait for each spawned
        follower to exit, and leave the group.  Returns one record a
        rank, rank 0 first; a follower that did not close cleanly has
        ``"error"``."""
        with self.lock:
            self._closing = True
            out = [{"rank": 0, **rank_summary(device, self._since),
                    "walls": [(e["seq"], e["op"], e["oid"], e["ranks"][0]["wall_s"])
                              for e in self.log]}]
            for r, sock in sorted(self._socks.items()):
                try:
                    _send(sock, (None, "close", None, ()))
                except OSError:
                    pass
            for r in sorted(self._socks):
                rec = None
                if self.broken is None:
                    try:
                        rec = self._inbox[r].get(timeout=self.timeout_s)
                    except queue.Empty:
                        rec = None
                out.append(rec if rec is not None else
                           {"rank": r, "error": self.broken or "no close record"})
            for sock in self._socks.values():
                try:
                    sock.close()
                except OSError:
                    pass
            for p in self._procs:
                p.join(timeout=self.timeout_s if self.broken is None else 5.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
                r = int(p.name.rsplit("rank", 1)[1])
                out[r]["exitcode"] = p.exitcode
            if dist.is_initialized():
                dist.destroy_process_group()
            if self._workdir:
                import shutil

                shutil.rmtree(self._workdir, ignore_errors=True)
            return out


# ----------------------------------------------------------- followers


def _follower_main(rank: int, world: int, init_method: str, device: str,
                   timeout_s: float, config) -> None:
    """A spawned follower: join the group, :func:`follow`, exit 0 after
    a clean close (1 with the traceback on standard error otherwise)."""
    from distel_tpu_torch.parallel import mesh as pmesh
    from distel_tpu_torch.serve import registry  # noqa: F401 — imported before the join

    code = 1
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        workdir = os.path.dirname(init_method[len("file://"):])
        with open(os.path.join(workdir, f"ready{rank}"), "w"):
            pass
        pmesh._join(init_method, world, rank, dev, timeout_s)
        follow(config, dev)
        code = 0
    except BaseException:  # noqa: BLE001 — reported, then the exit code
        traceback.print_exc()
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 — leaving anyway
                pass
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def follow(config, device=None) -> dict:
    """Follow rank 0's op stream on this rank until rank 0 publishes
    ``close``: connect, build this rank's registry from rank 0's
    settings, apply every record in order and answer it.  Joins the
    group from the coordinator keys when not in one yet.  Returns this
    rank's close record; raises when rank 0 goes away."""
    from distel_tpu_torch.core import artifacts
    from distel_tpu_torch.parallel import mesh as pmesh
    from distel_tpu_torch.runtime.classifier import resolve_device
    from distel_tpu_torch.serve.registry import OntologyRegistry

    dev = resolve_device(device)
    mesh = pmesh.setup(config, dev)
    if mesh is None or mesh.size == 1 or mesh.rank == 0:
        raise RuntimeError("follow() runs on the ranks of a mesh other than rank 0")
    box = [None]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    host, port = box[0].rsplit(":", 1)
    sock = socket.create_connection((host, int(port)))
    _send(sock, {"rank": mesh.rank, "pid": os.getpid()})
    setup = _recv(sock)
    ready: dict = {}
    registry = None
    try:
        if setup["marker"]:
            with open(setup["marker"]) as f:
                if f.read() != setup["token"]:
                    raise RuntimeError("the marker holds another token")
    except (OSError, RuntimeError) as e:
        ready["error"] = (
            f"the spill directory {setup['registry_kw'].get('spill_dir')!r} is "
            f"not visible from rank {mesh.rank} ({socket.gethostname()}): "
            f"rank 0's marker {setup['marker']!r} could not be read "
            f"({type(e).__name__}: {e}); every rank must see one spill dir")
    if not ready:
        try:
            artifacts.install_from_config(config, device=dev)
            registry = OntologyRegistry(config, device=dev, follower=True,
                                        **setup["registry_kw"])
        except Exception as e:  # noqa: BLE001 — reported to rank 0
            ready["error"] = f"{type(e).__name__}: {e}"
    _send(sock, ready)
    if ready:
        sock.close()
        raise RuntimeError(ready["error"])
    walls = []
    since = _counters()
    while True:
        seq, op, oid, args = _recv(sock)
        if op == "close":
            rec = {"rank": mesh.rank, **rank_summary(dev, since), "walls": walls}
            _send(sock, rec)
            sock.close()
            return rec
        t0 = time.perf_counter()
        ack = {"seq": seq, "rank": mesh.rank, "ok": True, "error": None,
               "message": ""}
        try:
            registry.apply(op, oid, args)
        except Exception as e:  # noqa: BLE001 — compared with rank 0's
            ack.update(ok=False, error=type(e).__name__,
                       message=str(e)[:500])
        ack["wall_s"] = time.perf_counter() - t0
        walls.append((seq, op, oid, ack["wall_s"]))
        if ack["ok"]:
            ack.update(op_report(registry, op, oid, setup["report"]))
        _send(sock, ack)
