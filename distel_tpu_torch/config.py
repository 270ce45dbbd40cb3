"""Configuration: the ``ClassifierConfig`` fields the port reads.

A subset of ``distel_tpu/config.py``'s ``ClassifierConfig`` with the
same names and defaults where the port implements the knob: the engine
(``auto`` = ``rowpacked``, ``packed`` or ``dense``), the native load
plane (on by default, as in the reference), the normalizer's gensym
cache, the per-rule backends (``backend.CRn``, the hybrid of
``core/hybrid.py``), the live-tile CR6 knobs and the serve plane's
(``obs.*`` tracing, ``query.*`` snapshots, ``storage.*`` tiers,
``cohort.*`` formation), the serve fleet's (``fleet.*``) and the
observed fixed point's (``sparse_tail.*``, ``pipeline.*``,
``obs.trace_rounds``, ``obs.ledger.*``) with its fused K-round window
(``fused.rounds.*``), shape buckets (``shape.buckets``, on by
default as in the reference, and ``bucket.ratio``), the artifact
farm (``artifacts.dir``, ``artifacts.require``; ``compile.cache.dir``
names the directory the kernel libraries build into, see
:func:`enable_compile_cache`) and the mesh plane
(``parallel/mesh.py``): ``mesh.devices`` / ``NODES_LIST`` (the mesh
size; a node list counts its nodes) and the multi-process keys
``coordinator.address``, ``num.processes`` and ``process.id`` (one rank
of a process group, one shard a rank).
The reference's ``matmul.dtype`` has no meaning for the port's exact
bit kernels and is ignored with the other unknown keys.

``from_properties`` parses java-style ``key = value`` files with the
reference's key spellings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


def enable_compile_cache(cache_dir: Optional[str] = None) -> None:
    """Point the kernel libraries' build directory at ``cache_dir`` (the
    config's ``compile.cache.dir``): libraries built there, by this
    process, an earlier one or an installed artifact farm, load without
    ``nvcc``.  None keeps the default (``build/torch_kernels/``);
    ``DISTEL_TORCH_BUILD_DIR`` wins when set.  Called by the entry points
    (classify, serve, fleet, warmup, farm-build), never on import."""
    if cache_dir:
        from distel_tpu_torch.ops import build

        build.set_cache_dir(cache_dir)


#: the reference's multi-controller keys: with a coordinator a process
#: joins a process group as one of its ranks (``parallel/mesh.py``)
MULTI_PROCESS_KEYS = ("coordinator.address", "num.processes", "process.id")


@dataclass
class ClassifierConfig:
    #: ranks of the mesh the fixed point shards over (None = a single
    #: device; ``parallel/mesh.py``)
    mesh_devices: Optional[int] = None
    #: a process group's rendezvous (``host:port``), its size and this
    #: process's rank: with them the classifier joins the group and
    #: shards over its ranks
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    #: concept-axis padding granularity of the packed state
    pad_multiple: int = 128
    max_iterations: int = 10_000
    #: per-phase wall-clock tracing, printed after each classify
    instrumentation: bool = False
    #: "auto" (= "rowpacked"), "rowpacked", "packed" or "dense"
    engine: str = "auto"
    #: OFN text through the C++ load plane (``owl/native_loader.py``);
    #: classify falls back to the Python plane only for XML input, for
    #: ``verify=True`` and with a normalizer cache, as the reference does
    use_native_loader: bool = True
    #: persistable gensym cache of the Python normalizer (the
    #: reference's NORMALIZE_CACHE): read before and written after
    #: normalizing
    normalize_cache_path: Optional[str] = None
    #: per-rule backend, the reference's rule→node plugin boundary:
    #: {"CR4": "host", ...}; rules routed to the host run through the
    #: hybrid saturator (``core/hybrid.py``, row-packed engine only)
    rule_backends: Dict[str, str] = field(default_factory=dict)
    #: shape-bucketed programs (the reference's default): the row-packed
    #: engine's layout and step structure quantize onto the
    #: ``core/program_cache.bucket_dim`` ladder, so ontologies of one
    #: bucket share one program — on a card one captured CUDA graph — in
    #: the process-global ``PROGRAMS`` registry.  Bucketing never
    #: changes a closure
    shape_buckets: bool = True
    #: the ladder's step (properties key ``bucket.ratio``): coarser
    #: buckets share more programs and pad more
    bucket_ratio: float = 1.25
    #: directory the kernel libraries build into and load from
    #: (properties key ``compile.cache.dir``; None = the default under
    #: ``build/torch_kernels/``)
    compile_cache_dir: Optional[str] = None
    #: base concepts below which the incremental plane
    #: (``core/incremental.py``) rebuilds every increment instead of
    #: taking the delta fast path (properties key
    #: ``fast.path.min.concepts``; the reference's default)
    fast_path_min_concepts: int = 2_048
    #: live-tile CR6 formulation (``core/cr6_tiles.py``)
    cr6_tiles: bool = True
    #: row-tile height of the live-tile CR6 schedule
    cr6_tiles_tile_m: int = 512
    #: link-tile width (live links packed per contraction tile)
    cr6_tiles_tile_l: int = 256
    #: tiled-vs-window MAC-volume ratio above which the engine keeps the
    #: window formulation
    cr6_tiles_density_threshold: float = 0.5
    #: adaptive sparse-tail execution of observed runs (row-packed
    #: engine): once a round's frontier density stays below
    #: ``sparse_density_threshold`` for ``sparse_hysteresis_rounds``
    #: rounds, the controller runs the frontier-compacted sparse step
    #: instead of the dense one
    sparse_tail: bool = True
    #: frontier density (active rule rows / total rule rows) below which
    #: a round is eligible for the sparse tier
    sparse_density_threshold: float = 0.05
    #: capacity rungs of the sparse tier: rung i holds ``floor * 2**i``
    #: rows; an active set past the largest runs dense for that round
    sparse_capacity_buckets: int = 8
    #: consecutive below-threshold rounds before the sparse tier
    #: (switching back to dense is immediate)
    sparse_hysteresis_rounds: int = 2
    #: pipelined observation of observed runs: up to ``pipeline_depth``
    #: dense rounds dispatched before the host retires the oldest one's
    #: fold (the retired rounds are the synchronous loop's)
    pipeline: bool = True
    #: maximum in-flight observed rounds (1 = synchronous)
    pipeline_depth: int = 2
    #: the fused K-round window of observed runs (row-packed engine):
    #: with ``fused_rounds_k`` > 1 one captured window runs up to K
    #: rounds of the adaptive controller on the card (tier pick,
    #: density/hysteresis and convergence there too) and the host reads
    #: the card once a window; the retired rounds are the per-round
    #: controller's, and a round that overflows the window's sparse
    #: workspace runs on the per-round path
    fused_rounds: bool = True
    #: rounds per window (K); 1 = the per-round controller
    fused_rounds_k: int = 1
    #: halve K down the ladder K, K/2, ..., 2 once the derivation tail's
    #: geometric decay predicts fewer rounds than half a window
    fused_rounds_adaptive: bool = False
    #: artifact farm (``core/artifacts.py``): a ``cli farm-build``
    #: output — the kernel libraries and the bucket programs' specs
    #: under a checksummed manifest.  Set, every entry point installs it
    #: before traffic, so covered programs come with ``compile_s == 0.0``
    #: and no ``nvcc`` runs; None = build as before
    artifacts_dir: Optional[str] = None
    #: refuse to start when ``artifacts_dir`` is set but the farm cannot
    #: be installed whole (missing or corrupt manifest, a checksum, a
    #: foreign environment); default: warn and build
    artifacts_require: bool = False
    #: request tracing (``obs/trace.py``): ``obs_enable=False`` takes
    #: every span off-path; the flight recorder stays on
    obs_enable: bool = True
    #: fraction of root requests that record spans
    obs_sample_rate: float = 1.0
    #: run traced REBUILD saturations through the observed loop, so each
    #: round lands as a span event on the request's trace
    obs_trace_rounds: bool = False
    #: run ledger (``obs/ledger.py``): REBUILD saturations run the
    #: observed loop and append one JSONL record a round to a
    #: per-process ledger under ``obs_ledger_dir``
    obs_ledger: bool = False
    #: directory rebuild ledgers land in (created on demand; one
    #: ``rebuild-<pid>.ledger.jsonl`` per process)
    obs_ledger_dir: str = "runs"
    #: finished-span ring capacity per process
    obs_ring_capacity: int = 2048
    #: flight-recorder event ring capacity per process
    obs_flight_capacity: int = 4096
    #: read-optimized query plane (``serve/query/``): every commit
    #: publishes an immutable versioned host snapshot of the closure
    #: that the ``/query/*`` endpoints answer from.  Off: they 404
    query_enable: bool = True
    #: decoded-row LRU capacity per snapshot
    query_row_cache: int = 256
    #: the scheduler's cohort-formation lane (``serve/scheduler.py``)
    #: and the cohort plane (``core/cohort.py``): same-bucket tenants'
    #: deltas advanced by one batched step program a vote.  It forms
    #: only over bucketed base programs (exact-shape engines run every
    #: delta solo); cohorts pad to a power-of-two rung, so
    #: ``cohort_max_size`` also bounds the cohort programs' rungs
    cohort_enable: bool = True
    cohort_max_size: int = 8
    cohort_max_wait_ms: float = 25.0
    #: comma-separated cohort sizes ``warm_delta_programs`` builds the
    #: canonical delta roster's cohort programs for ("" = none): a
    #: warmed process's first cohort then builds nothing
    cohort_warm_sizes: str = ""
    #: compress registry cold spills (``np.savez_compressed``)
    storage_compress_spills: bool = True
    #: host-RAM warm-tier budget (MiB); 0 = hot evictions spill
    #: straight to cold
    storage_warm_budget_mb: float = 0.0
    #: halflife of the per-ontology read/write traffic EWMA that picks
    #: eviction victims and prefetch candidates
    storage_ewma_halflife_s: float = 60.0
    #: period of the background tier promoter; 0 disables it
    storage_prefetch_interval_s: float = 5.0
    #: serve fleet (``serve/fleet/``): replica processes behind the
    #: router, all on the one device ``cli fleet --device`` names
    fleet_replicas: int = 2
    #: queue-depth divergence (hot − cool) that triggers a live
    #: ontology migration toward the cooler replica
    fleet_depth_divergence: int = 8
    #: router heartbeat period against each replica's /healthz
    fleet_heartbeat_interval_s: float = 1.0
    #: consecutive heartbeat failures before a replica is ejected (and
    #: respawned when a supervisor is attached)
    fleet_eject_failures: int = 3
    #: rebalance sweep period (each sweep migrates at most one ontology)
    fleet_rebalance_interval_s: float = 2.0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.engine not in ("auto", "rowpacked", "packed", "dense"):
            raise ValueError(
                f"unknown engine {self.engine!r}: expected 'auto', "
                "'rowpacked', 'packed' or 'dense'"
            )
        if not self.bucket_ratio > 1.0:
            # bucket_dim's own check, at load rather than inside the
            # first engine build
            raise ValueError(f"bucket ratio must be > 1, got {self.bucket_ratio}")
        from distel_tpu_torch.core.hybrid import split_backends

        split_backends(self.rule_backends)

    @classmethod
    def from_properties(cls, path: str) -> "ClassifierConfig":
        """Parse a java-properties-style file (``key = value``, ``#``/``!``
        comments), accepting the reference's keys for these fields."""
        raw: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", "!")):
                    continue
                if "=" in line:
                    k, v = line.split("=", 1)
                    raw[k.strip()] = v.strip()

        def flag(key: str) -> bool:
            return raw[key].lower() == "true"

        cfg = cls()
        if "mesh.devices" in raw:
            cfg.mesh_devices = int(raw["mesh.devices"])
        elif "NODES_LIST" in raw:  # reference spelling: count the nodes
            cfg.mesh_devices = len([n for n in raw["NODES_LIST"].split(",") if n])
        if "coordinator.address" in raw:
            cfg.coordinator_address = raw["coordinator.address"]
        if "num.processes" in raw:
            cfg.num_processes = int(raw["num.processes"])
        if "process.id" in raw:
            cfg.process_id = int(raw["process.id"])
        if "pad.multiple" in raw:
            cfg.pad_multiple = int(raw["pad.multiple"])
        elif "chunk.size" in raw:  # nearest reference analog
            cfg.pad_multiple = max(8, min(int(raw["chunk.size"]), 1024))
        if "max.iterations" in raw:
            cfg.max_iterations = int(raw["max.iterations"])
        for key in ("instrumentation.enabled", "instrumentation"):
            if key in raw:
                cfg.instrumentation = flag(key)
        if "normalize.cache.path" in raw:
            cfg.normalize_cache_path = raw["normalize.cache.path"]
        if "native.loader" in raw:
            cfg.use_native_loader = flag("native.loader")
        if "engine" in raw:
            cfg.engine = raw["engine"]
        if "shape.buckets" in raw:
            cfg.shape_buckets = flag("shape.buckets")
        if "bucket.ratio" in raw:
            cfg.bucket_ratio = float(raw["bucket.ratio"])
        if "compile.cache.dir" in raw:
            cfg.compile_cache_dir = raw["compile.cache.dir"]
        if "fast.path.min.concepts" in raw:
            cfg.fast_path_min_concepts = int(raw["fast.path.min.concepts"])
        if "cr6.tiles.enable" in raw:
            cfg.cr6_tiles = flag("cr6.tiles.enable")
        if "cr6.tiles.tile_m" in raw:
            cfg.cr6_tiles_tile_m = int(raw["cr6.tiles.tile_m"])
        if "cr6.tiles.tile_l" in raw:
            cfg.cr6_tiles_tile_l = int(raw["cr6.tiles.tile_l"])
        if "cr6.tiles.density_threshold" in raw:
            cfg.cr6_tiles_density_threshold = float(
                raw["cr6.tiles.density_threshold"]
            )
        if "sparse_tail.enable" in raw:
            cfg.sparse_tail = flag("sparse_tail.enable")
        if "sparse_tail.density_threshold" in raw:
            cfg.sparse_density_threshold = float(
                raw["sparse_tail.density_threshold"]
            )
        if "sparse_tail.capacity_buckets" in raw:
            cfg.sparse_capacity_buckets = int(
                raw["sparse_tail.capacity_buckets"]
            )
        if "sparse_tail.hysteresis_rounds" in raw:
            cfg.sparse_hysteresis_rounds = int(
                raw["sparse_tail.hysteresis_rounds"]
            )
        if "pipeline.enable" in raw:
            cfg.pipeline = flag("pipeline.enable")
        if "pipeline.depth" in raw:
            cfg.pipeline_depth = int(raw["pipeline.depth"])
        if "fused.rounds.enable" in raw:
            cfg.fused_rounds = flag("fused.rounds.enable")
        if "fused.rounds.k" in raw:
            cfg.fused_rounds_k = int(raw["fused.rounds.k"])
        if "fused.rounds.adaptive" in raw:
            cfg.fused_rounds_adaptive = flag("fused.rounds.adaptive")
        if "obs.enable" in raw:
            cfg.obs_enable = flag("obs.enable")
        if "obs.sample_rate" in raw:
            cfg.obs_sample_rate = float(raw["obs.sample_rate"])
        if "obs.trace_rounds" in raw:
            cfg.obs_trace_rounds = flag("obs.trace_rounds")
        if "obs.ledger.enable" in raw:
            cfg.obs_ledger = flag("obs.ledger.enable")
        if "obs.ledger.dir" in raw:
            cfg.obs_ledger_dir = raw["obs.ledger.dir"]
        if "obs.ring.capacity" in raw:
            cfg.obs_ring_capacity = int(raw["obs.ring.capacity"])
        if "obs.flight.capacity" in raw:
            cfg.obs_flight_capacity = int(raw["obs.flight.capacity"])
        if "artifacts.dir" in raw:
            cfg.artifacts_dir = raw["artifacts.dir"]
        if "artifacts.require" in raw:
            cfg.artifacts_require = flag("artifacts.require")
        if "query.enable" in raw:
            cfg.query_enable = flag("query.enable")
        if "query.row.cache" in raw:
            cfg.query_row_cache = int(raw["query.row.cache"])
        if "cohort.enable" in raw:
            cfg.cohort_enable = flag("cohort.enable")
        if "cohort.max_size" in raw:
            cfg.cohort_max_size = int(raw["cohort.max_size"])
        if "cohort.max_wait_ms" in raw:
            cfg.cohort_max_wait_ms = float(raw["cohort.max_wait_ms"])
        if "cohort.warm.sizes" in raw:
            cfg.cohort_warm_sizes = raw["cohort.warm.sizes"]
        if "storage.compress.spills" in raw:
            cfg.storage_compress_spills = flag("storage.compress.spills")
        if "storage.warm.budget.mb" in raw:
            cfg.storage_warm_budget_mb = float(raw["storage.warm.budget.mb"])
        if "storage.ewma.halflife_s" in raw:
            cfg.storage_ewma_halflife_s = float(raw["storage.ewma.halflife_s"])
        if "storage.prefetch.interval_s" in raw:
            cfg.storage_prefetch_interval_s = float(
                raw["storage.prefetch.interval_s"]
            )
        if "fleet.replicas" in raw:
            cfg.fleet_replicas = int(raw["fleet.replicas"])
        if "fleet.depth.divergence" in raw:
            cfg.fleet_depth_divergence = int(raw["fleet.depth.divergence"])
        if "fleet.heartbeat.interval_s" in raw:
            cfg.fleet_heartbeat_interval_s = float(
                raw["fleet.heartbeat.interval_s"]
            )
        if "fleet.eject.failures" in raw:
            cfg.fleet_eject_failures = int(raw["fleet.eject.failures"])
        if "fleet.rebalance.interval_s" in raw:
            cfg.fleet_rebalance_interval_s = float(
                raw["fleet.rebalance.interval_s"]
            )
        for k, v in raw.items():
            if k.startswith("backend."):  # backend.CR1 = tpu
                cfg.rule_backends[k[len("backend."):]] = v
        cfg.validate()
        return cfg

    def cohort_warm_size_list(self) -> list:
        """Parsed ``cohort.warm.sizes`` (empty = no cohort warmup)."""
        return [
            int(s)
            for s in self.cohort_warm_sizes.replace(",", " ").split()
            if s
        ]

    def sparse_tail_config(self) -> Optional[dict]:
        """The row-packed engine's ``sparse_tail=`` kwarg for this
        config (None = tier disabled)."""
        if not self.sparse_tail:
            return None
        return {
            "enable": True,
            "density_threshold": self.sparse_density_threshold,
            "capacity_buckets": self.sparse_capacity_buckets,
            "hysteresis_rounds": self.sparse_hysteresis_rounds,
        }

    def pipeline_config(self) -> dict:
        """The row-packed engine's ``pipeline=`` kwarg for this config
        (``{"enable": False}`` restores the synchronous loop)."""
        return {
            "enable": self.pipeline,
            "depth": self.pipeline_depth,
        }

    def fused_rounds_config(self) -> Optional[dict]:
        """The row-packed engine's ``fused_rounds=`` kwarg for this
        config (None = the per-round controller; the engine also routes
        per round when K is 1)."""
        if not self.fused_rounds:
            return None
        return {
            "enable": True,
            "rounds": self.fused_rounds_k,
            "adaptive": self.fused_rounds_adaptive,
        }

    def cr6_tiles_config(self) -> Optional[dict]:
        """The engine's ``cr6_tiles=`` kwarg for this config (None =
        window formulation)."""
        if not self.cr6_tiles:
            return None
        return {
            "enable": True,
            "tile_m": self.cr6_tiles_tile_m,
            "tile_l": self.cr6_tiles_tile_l,
            "density_threshold": self.cr6_tiles_density_threshold,
        }

    def tracer_kwargs(self) -> dict:
        """The :class:`~distel_tpu_torch.obs.SpanRecorder` construction
        kwargs for this config (the serve app builds its recorder from
        it)."""
        return {
            "enable": self.obs_enable,
            "sample_rate": self.obs_sample_rate,
            "capacity": self.obs_ring_capacity,
        }
