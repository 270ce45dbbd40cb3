"""Configuration: the ``ClassifierConfig`` fields the port reads.

A subset of ``distel_tpu/config.py``'s ``ClassifierConfig`` with the
same names and defaults where the port implements the knob: the engine
(``auto`` = ``rowpacked``, ``packed`` or ``dense``), the native load
plane (on by default, as in the reference), the normalizer's gensym
cache, and the live-tile CR6 knobs.  Knobs of paths the port does not
have yet (mesh, serving, shape buckets) are absent, or refused where a
reference config could carry them over: ``shape_buckets`` must be off.
The reference's ``matmul.dtype`` has no meaning for the port's exact
bit kernels and is ignored with the other unknown keys.

``from_properties`` parses java-style ``key = value`` files with the
reference's key spellings.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    #: shape-bucketed programs exist to share compiled XLA executables;
    #: the port runs eagerly and has no counterpart yet, so only False
    #: is accepted (bucketing never changes a closure)
    shape_buckets: bool = False
    #: live-tile CR6 formulation (``core/cr6_tiles.py``)
    cr6_tiles: bool = True
    #: row-tile height of the live-tile CR6 schedule
    cr6_tiles_tile_m: int = 512
    #: link-tile width (live links packed per contraction tile)
    cr6_tiles_tile_l: int = 256
    #: tiled-vs-window MAC-volume ratio above which the engine keeps the
    #: window formulation
    cr6_tiles_density_threshold: float = 0.5

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
