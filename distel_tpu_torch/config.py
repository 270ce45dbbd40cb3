"""Configuration: the ``ClassifierConfig`` fields the port reads.

A subset of ``distel_tpu/config.py``'s ``ClassifierConfig`` with the
same names and defaults where the port implements the knob: the engine
(``auto`` = ``rowpacked``, ``packed`` or ``dense``), the native load
plane (on by default, as in the reference), the normalizer's gensym
cache, the per-rule backends (``backend.CRn``, the hybrid of
``core/hybrid.py``), the live-tile CR6 knobs and the serve plane's
(``obs.*`` tracing, ``query.*`` snapshots, ``storage.*`` tiers,
``cohort.*`` formation).  Knobs of paths the port does not have yet
(mesh, shape buckets, the observed loop, the artifact farm, the fleet)
are absent, or refused where a reference config could carry them over:
``shape_buckets`` must be off, ``mesh.devices`` / ``NODES_LIST`` may
name no device (a mesh of one device still changes the reference's
automatic rules, so it is refused too), and ``obs.trace_rounds``,
``obs.ledger.enable`` (both run the observed loop) and
``artifacts.dir`` raise naming the key.  The reference's ``matmul.dtype`` has no
meaning for the port's exact bit kernels and is ignored with the other
unknown keys.

``from_properties`` parses java-style ``key = value`` files with the
reference's key spellings.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ClassifierConfig:
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
    #: shape-bucketed programs exist to share compiled XLA executables;
    #: the port runs eagerly and has no counterpart yet, so only False
    #: is accepted (bucketing never changes a closure)
    shape_buckets: bool = False
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
    #: request tracing (``obs/trace.py``): ``obs_enable=False`` takes
    #: every span off-path; the flight recorder stays on
    obs_enable: bool = True
    #: fraction of root requests that record spans
    obs_sample_rate: float = 1.0
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
    #: the scheduler's cohort-formation lane (``serve/scheduler.py``):
    #: it forms only over bucketed base programs, so with the port's
    #: exact-shape engines every delta runs solo
    cohort_enable: bool = True
    cohort_max_size: int = 8
    cohort_max_wait_ms: float = 25.0
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

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.engine not in ("auto", "rowpacked", "packed", "dense"):
            raise ValueError(
                f"unknown engine {self.engine!r}: expected 'auto', "
                "'rowpacked', 'packed' or 'dense'"
            )
        if self.shape_buckets:
            raise ValueError(
                "shape_buckets=True is not supported by distel_tpu_torch yet"
            )
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
            mesh_key, devices = "mesh.devices", int(raw["mesh.devices"])
        elif "NODES_LIST" in raw:  # reference spelling: count the nodes
            mesh_key = "NODES_LIST"
            devices = len([n for n in raw["NODES_LIST"].split(",") if n])
        else:
            mesh_key, devices = None, 0
        if devices:
            raise ValueError(
                f"{mesh_key} = {raw[mesh_key]} asks for a mesh of {devices} "
                "device(s); distel_tpu_torch has no mesh path"
            )
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
        if "obs.enable" in raw:
            cfg.obs_enable = flag("obs.enable")
        if "obs.sample_rate" in raw:
            cfg.obs_sample_rate = float(raw["obs.sample_rate"])
        for key in ("obs.trace_rounds", "obs.ledger.enable"):
            if key in raw and flag(key):
                raise ValueError(
                    f"{key} = true runs the observed fixed-point loop, "
                    "which distel_tpu_torch does not have yet"
                )
        if "obs.ring.capacity" in raw:
            cfg.obs_ring_capacity = int(raw["obs.ring.capacity"])
        if "obs.flight.capacity" in raw:
            cfg.obs_flight_capacity = int(raw["obs.flight.capacity"])
        if "artifacts.dir" in raw:
            raise ValueError(
                f"artifacts.dir = {raw['artifacts.dir']} names an AOT artifact "
                "farm of compiled XLA programs; distel_tpu_torch has none"
            )
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
        for k, v in raw.items():
            if k.startswith("backend."):  # backend.CR1 = tpu
                cfg.rule_backends[k[len("backend."):]] = v
        cfg.validate()
        return cfg

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
