"""The shard primitives: every collective the sharded engines run.

The name is the reference's (``distel_tpu/parallel/shard_compat.py``),
so a reader finds the counterpart; that file is a shim that papers over
``shard_map``'s spelling across jax pins, and nothing of it carries
over but the idea of one place for the shard primitives.  Here they are
``torch.distributed`` collectives over a :class:`~distel_tpu_torch.
parallel.mesh.Mesh`, each the identity on a mesh of one (or no mesh):

* :func:`psum_` — an in-place sum across the ranks (the reference's
  ``lax.psum``): live-bit partials, and the packed engine's filler rows,
  each of which lives on one rank (so the sum is that rank's row);
* :func:`por_` — the OR of 0/1 tensors (bool masks) as an in-place MAX
  of one byte an entry: the frontier fold and the changed vote;
* :func:`por_bits` — the OR of a 0/1 table whose every entry is set on
  one rank at most (the filler bit tables: a filler's bit lives in one
  rank's words), eight entries a byte on the wire;
* :func:`shard_word_base` — the first packed word of a rank's window;
* :func:`all_gather_words` / :func:`all_gather_rows` — a sharded state
  assembled on every rank (the reference's ``fetch_global``).

gloo reduces card tensors (it stages them through host memory itself)
but does not gather them, so a gather of card tensors on a gloo group
goes through host memory here.

:data:`COLLECTIVES` counts every call: how many, the bytes each rank
contributed, and the host seconds spent in them (each of these waits
for its peers).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch
import torch.distributed as dist


class CollectiveStats:
    """Collectives run in this process: ``{op: [calls, bytes, seconds]}``
    (bytes: this rank's contribution)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ops: dict = {}

    def tally(self, op: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            rec = self.ops.setdefault(op, [0, 0, 0.0])
            rec[0] += 1
            rec[1] += int(nbytes)
            rec[2] += seconds

    def reset(self) -> None:
        with self._lock:
            self.ops = {}

    def snapshot(self) -> dict:
        """``{op: {"calls", "bytes", "seconds"}, "total": {...}}``."""
        with self._lock:
            out = {op: {"calls": c, "bytes": b, "seconds": s}
                   for op, (c, b, s) in sorted(self.ops.items())}
        out["total"] = {
            k: sum(v[k] for v in out.values()) for k in ("calls", "bytes", "seconds")
        }
        return out


COLLECTIVES = CollectiveStats()


def _active(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def psum_(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed across the mesh's ranks, in place; returns ``t``."""
    if not _active(mesh):
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    COLLECTIVES.tally("psum", t.numel() * t.element_size(), time.perf_counter() - t0)
    return t


def por_(t: torch.Tensor, mesh) -> torch.Tensor:
    """The OR across the mesh's ranks of a tensor of 0/1 entries (bool,
    int8 or uint8), one byte an entry on the wire.  Integer tensors are
    reduced in place and returned; a bool tensor returns a new one."""
    if not _active(mesh):
        return t
    t0 = time.perf_counter()
    buf = t.view(torch.uint8) if t.dtype == torch.bool else t
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=mesh.group)
    COLLECTIVES.tally("por", buf.numel(), time.perf_counter() - t0)
    return buf.view(torch.bool) if t.dtype == torch.bool else buf


_SHIFTS = torch.arange(8, dtype=torch.uint8)


def por_bits(t: torch.Tensor, mesh) -> torch.Tensor:
    """The OR across the mesh's ranks of a 0/1 table ``t`` [L, ...]
    (int8 or bool) whose every entry is set on one rank at most: packed
    eight rows a byte for the wire, where the sum of disjoint bits is
    their OR, and unpacked to ``t``'s dtype (a new tensor)."""
    if not _active(mesh):
        return t
    t0 = time.perf_counter()
    n, rest = t.shape[0], t.shape[1:]
    x = t.to(torch.uint8)
    if n % 8:
        x = torch.cat([x, x.new_zeros((8 - n % 8, *rest))])
    shifts = _SHIFTS.to(t.device).view(1, 8, *([1] * len(rest)))
    packed = (x.view(-1, 8, *rest) << shifts).sum(1, dtype=torch.uint8)
    dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=mesh.group)
    out = ((packed.unsqueeze(1) >> shifts) & 1).view(-1, *rest)[:n].to(t.dtype)
    COLLECTIVES.tally("por_bits", packed.numel(), time.perf_counter() - t0)
    return out


def shard_word_base(mesh, wc: int) -> int:
    """The first word of this rank's window of ``wc`` packed words (the
    engines pad ``wc`` to a multiple of the mesh size)."""
    if mesh is None:
        return 0
    return mesh.rank * (wc // mesh.size)


def _gather(t: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    t0 = time.perf_counter()
    src = t.contiguous()
    staged = src.device.type == "cuda" and mesh.backend == "gloo"
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(t.device)
    COLLECTIVES.tally("gather", src.numel() * src.element_size(),
                    time.perf_counter() - t0)
    return out


def all_gather_words(t: torch.Tensor, mesh) -> torch.Tensor:
    """Word-sharded ``[rows, wc / n]`` windows → ``[rows, wc]`` on every
    rank (rank order is word order)."""
    return _gather(t, mesh, 1) if _active(mesh) else t


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Row-sharded ``[rows / n, W]`` blocks → ``[rows, W]`` on every
    rank."""
    return _gather(t, mesh, 0) if _active(mesh) else t


def mesh_size(mesh: Optional[object]) -> int:
    """Shards of ``mesh`` (1 for None)."""
    return 1 if mesh is None else int(mesh.size)
