"""The end-to-end classifier: load → saturate → taxonomy, with
per-phase wall-clock timers.

The port of ``distel_tpu/runtime/classifier.py``'s one-shot path
(``ELClassifier.classify_text`` / ``classify_file``, with
``resume_from=`` and ``verify=``).  OFN text goes through the C++ load
plane (phase ``load(native)``) unless the config turns it off, the input
is XML (RDF/XML or OWL/XML), ``verify=True`` asks for the oracle diff
(which reads the Python plane's normalized ontology) or a normalizer
cache is configured; then parse → normalize → index run in Python, with
the cache.  The engine is the row-packed one
(``engine="auto"``/``"rowpacked"``), the packed one (``engine="packed"``)
or the dense one (``engine="dense"``); ``rule_backends`` that route a
rule to the host wrap the row-packed engine in the hybrid saturator.
Everything runs on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no device given, construction raises.  Shape buckets
are on by default (``shape_buckets``): the row-packed engine's program
is built (on a card captured) in a phase of its own, ``compile``, which
a registry hit makes ~0, and the result carries its
:class:`~distel_tpu_torch.runtime.instrumentation.CompileStats`.

The classifier owns the mesh (``parallel/mesh.setup``): with
``mesh.devices`` or the coordinator keys each rank of a process group
builds the same index and plan, runs the fixed point on its shard, and
holds the gathered closure and the taxonomy.  Mesh engines skip
``precompile``, as the reference's classifier does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core.engine import SaturationEngine, SaturationResult
from distel_tpu_torch.core.hybrid import HybridSaturator, split_backends
from distel_tpu_torch.core.indexing import Indexer, IndexedOntology
from distel_tpu_torch.core.packed_engine import PackedSaturationEngine
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import Normalizer, NormalizedOntology
from distel_tpu_torch.owl import loader as owl_loader
from distel_tpu_torch.runtime.instrumentation import PhaseTimer
from distel_tpu_torch.runtime.taxonomy import Taxonomy, extract_taxonomy


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the first card, and
    raises when there is none (the port never falls back to the CPU on
    its own)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "distel_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


@dataclass
class ClassificationResult:
    result: SaturationResult
    taxonomy: Taxonomy
    #: None when the native load plane ran (it keeps no Python IR)
    norm: Optional[NormalizedOntology]
    idx: IndexedOntology
    timer: PhaseTimer
    #: the engine that ran the fixed point (its plan statistics)
    engine: Optional[
        Union[RowPackedSaturationEngine, PackedSaturationEngine,
              SaturationEngine, HybridSaturator]
    ] = None
    #: program-build record (row-packed engines; None otherwise): bucket
    #: signature, build and capture walls, program-cache hit
    compile_stats: Optional[object] = None

    def summary(self) -> dict:
        if self.norm is not None:
            normalized = self.norm.axiom_count()
            removed = sum(self.norm.removed.values())
        else:
            # native plane: the indexed normal-form rows (nf2 includes
            # the binarization rows; role axioms are folded into the
            # role closure and the chain pairs)
            normalized = int(
                len(self.idx.nf1) + len(self.idx.nf2) + len(self.idx.nf3)
                + len(self.idx.nf4) + len(self.idx.chain_pairs)
            )
            removed = sum(self.idx.removed.values())
        return {
            "concepts": self.idx.n_concepts,
            "roles": self.idx.n_roles,
            "links": self.idx.n_links,
            "normalized_axioms": normalized,
            "removed_axioms": removed,
            "iterations": self.result.iterations,
            "derivations": self.result.derivations,
            "unsatisfiable": len(self.taxonomy.unsatisfiable),
            "device": str(self.timer.device),
            "phases_ms": {
                k: round(v * 1000, 1) for k, v in self.timer.phases.items()
            },
        }


def make_engine(
    config: ClassifierConfig, idx: IndexedOntology, device, mesh=None,
    **rowpacked_kw
):
    """The engine ``config.engine`` names, on ``device``: the row-packed
    engine for "auto" and "rowpacked", the packed engine for "packed",
    the dense engine for "dense"; the hybrid saturator over the
    row-packed engine when ``rule_backends`` routes a rule to the
    host.  ``rowpacked_kw``: extra row-packed engine kwargs (the
    incremental plane's reservations ``min_concepts``,
    ``min_links_pad``, ``window_headroom``), which the other engines
    and the hybrid ignore, as the reference's do.  The row-packed
    engine also gets the config's ``sparse_tail``, ``pipeline`` and
    ``fused_rounds`` (its observed runs' controller).  ``mesh``: the
    :class:`~distel_tpu_torch.parallel.mesh.Mesh` all three engines
    shard over (the hybrid's row-packed engine too, as the reference
    passes it through ``engine_kw``)."""
    config.validate()
    _, host_rules = split_backends(config.rule_backends)
    if host_rules:
        if config.engine not in ("auto", "rowpacked"):
            raise ValueError(
                "rule_backends routing rules to the host requires the "
                f"rowpacked engine, but engine={config.engine!r}"
            )
        return HybridSaturator(
            idx, config.rule_backends, device=device,
            engine_kw={"pad_multiple": config.pad_multiple, "mesh": mesh},
        )
    if config.engine == "packed":
        return PackedSaturationEngine(
            idx, device=device, pad_multiple=config.pad_multiple,
            bucket=config.shape_buckets, bucket_ratio=config.bucket_ratio,
            mesh=mesh,
        )
    if config.engine == "dense":
        return SaturationEngine(
            idx, device=device, pad_multiple=config.pad_multiple, mesh=mesh
        )
    # the adaptive sparse tail and pipelined observation act in
    # observed runs only (saturate_observed), as in the reference
    rowpacked_kw.setdefault("sparse_tail", config.sparse_tail_config())
    rowpacked_kw.setdefault("pipeline", config.pipeline_config())
    # the fused K-round window: rebuilds, stream, serve and the fleet's
    # replicas inherit K through here
    rowpacked_kw.setdefault("fused_rounds", config.fused_rounds_config())
    # shape-bucketed programs: the config-driven builds (classify, the
    # incremental rebuild, serve loads) quantize; callers that pin exact
    # layouts construct directly
    rowpacked_kw.setdefault("bucket", config.shape_buckets)
    rowpacked_kw.setdefault("bucket_ratio", config.bucket_ratio)
    return RowPackedSaturationEngine(
        idx,
        device=device,
        pad_multiple=config.pad_multiple,
        cr6_tiles=config.cr6_tiles_config(),
        mesh=mesh,
        **rowpacked_kw,
    )


class ELClassifier:
    """One classifier instance per config and device; owns the mesh
    (None off a mesh)."""

    def __init__(self, config: Optional[ClassifierConfig] = None, device=None):
        from distel_tpu_torch.parallel.mesh import setup

        self.config = config or ClassifierConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self.mesh = setup(self.config, self.device)

    def classify_text(
        self, text: str, *, verify: bool = False,
        resume_from: Optional[str] = None,
    ) -> ClassificationResult:
        """``verify``: diff the closure against the CPU oracle
        (``testing/differential.py``) in a phase of its own, raising
        ``AssertionError`` with the report on a mismatch.
        ``resume_from``: path of a v1 or v2 snapshot (either package's
        ``save_snapshot``) to warm-start saturation from, realigned by
        name onto this corpus's numbering.  Precondition: the snapshot's
        corpus is a *subset* of this one — saturation is monotone, so
        consequences of since-retracted axioms would survive."""
        timer = PhaseTimer(self.device)
        cfg = self.config
        norm = None
        if (
            cfg.use_native_loader
            and owl_loader.detect_format(text) == "ofn"
            and not verify
            and not cfg.normalize_cache_path
        ):
            from distel_tpu_torch.owl import native_loader

            with timer.phase("load(native)"):
                idx = native_loader.load_indexed(text)
        else:
            with timer.phase("parse"):
                onto = owl_loader.load(text)
            cache = None
            if cfg.normalize_cache_path:
                try:
                    cache = Normalizer.load_cache(cfg.normalize_cache_path)
                except FileNotFoundError:
                    cache = None
            with timer.phase("normalize"):
                normalizer = Normalizer(cache=cache)
                norm = normalizer.normalize(onto)
            if cfg.normalize_cache_path:
                normalizer.save_cache(cfg.normalize_cache_path)
            with timer.phase("index"):
                idx = Indexer().index(norm)
        with timer.phase("plan"):
            engine = make_engine(cfg, idx, self.device, mesh=self.mesh)
        # the program build as its own phase: a warm bucket (a registry
        # hit) shows as compile ~0, apart from the saturation's time
        if hasattr(engine, "precompile") and self.mesh is None:
            with timer.phase("compile"):
                engine.precompile(cfg.max_iterations, programs=("run",))
        initial = None
        if resume_from is not None:
            with timer.phase("resume(align)"):
                from distel_tpu_torch.runtime.checkpoint import load_snapshot_state

                # the wire-packed (v2) form re-embeds without densifying,
                # but only an engine that takes wire state gets it; the
                # packed engine gets the x-major bool view
                initial, _info = load_snapshot_state(
                    resume_from,
                    idx=idx,
                    unpack=not engine.accepts_wire_state,
                )
        with timer.phase("saturate"):
            result = engine.saturate(cfg.max_iterations, initial=initial)
        with timer.phase("taxonomy"):
            taxonomy = extract_taxonomy(result)
        if verify:
            with timer.phase("verify"):
                from distel_tpu_torch.testing.differential import (
                    diff_engine_vs_oracle,
                )

                report = diff_engine_vs_oracle(norm, result)
                if not report.ok():
                    raise AssertionError(
                        f"differential check failed:\n{report.summary()}"
                    )
        if cfg.instrumentation:
            print(timer.report(), flush=True)
        return ClassificationResult(
            result, taxonomy, norm, idx, timer, engine,
            compile_stats=getattr(engine, "compile_stats", None),
        )

    def classify_file(self, path: str, **kw) -> ClassificationResult:
        with open(path, "r", encoding="utf-8-sig") as f:
            return self.classify_text(f.read(), **kw)
