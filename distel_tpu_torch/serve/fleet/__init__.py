"""The serve fleet — horizontal scale-out of ``distel_tpu/serve/``.

One serve process is one GIL and one HBM pool; the fleet is the jax
analog of the reference's cluster config + Lua-scripted work stealing
(SURVEY.md L1 ``ShardInfo`` / L5 ``worksteal/WorkStealer``): a thin HTTP
router in front of N shared-nothing replica processes.

Layout::

    placement.py   ontology→replica affinity table + the rebalance
                   decision (queue-depth divergence → migration pick) —
                   pure logic, no sockets
    replica.py     ReplicaApp: ServeApp plus the /fleet admin plane
                   (load-with-id, migrate-out, adopt) and replica
                   identity on /healthz
    router.py      RouterApp: client-facing proxy with affinity
                   placement, per-ontology hold during migration,
                   heartbeat health tracking with journal-replay
                   recovery, queue-depth rebalance, and an aggregated
                   /metrics re-exporting every replica under a
                   ``replica=`` label
    supervisor.py  ReplicaSupervisor: spawns/monitors/respawns the
                   replica subprocesses (shared spill dir + persistent
                   compile cache make respawn a warm start)

Entry point: ``python -m distel_tpu.cli fleet --replicas 4`` boots the
supervisor, the replicas, and the router; ``bench_serve.py`` drives a
traffic-shaped load at it.
"""

from distel_tpu_torch.serve.fleet.placement import PlacementTable, ReplicaState
from distel_tpu_torch.serve.fleet.replica import ReplicaApp
from distel_tpu_torch.serve.fleet.router import RouterApp
from distel_tpu_torch.serve.fleet.supervisor import ReplicaSupervisor

__all__ = [
    "PlacementTable",
    "ReplicaApp",
    "ReplicaState",
    "ReplicaSupervisor",
    "RouterApp",
]
