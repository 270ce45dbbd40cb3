"""Warmup: build the program registry before traffic.

The port of ``distel_tpu/runtime/warmup.py``.  With shape buckets every
ontology of a bucket asks for the same programs, so a resident
deployment can build them before the first request: feed this module
sample corpora (one per bucket traffic is expected in) and it builds
each bucket's roster into ``core/program_cache.PROGRAMS`` — on a card
each program's CUDA graph is captured here.  Ontologies that later land
in a warmed bucket classify with ``compile_s == 0.0`` (a registry hit).
Nothing survives the process; ``cli farm-build`` runs this module with
the artifact farm (``core/artifacts.py``) as the registry's sink, so the
programs' specs do, and each record attributes the farm's share of its
roster (``artifact_*``: hits off an installed farm, specs written).

Two construction profiles, as in the reference:

* ``"serve"`` (default) — the incremental full rebuild's engine
  (``core/incremental.rebuild_engine``: concept-lane and link-row
  headroom, rebind window slots), i.e. the programs serve loads, deltas
  and restores ask for, plus the delta plane's roster
  (``warm_delta_programs``, with the canonical roster's cohort programs
  at the rungs of ``cohort.warm.sizes``);
* ``"classify"`` — ``runtime/classifier.make_engine``'s, as
  ``cli classify`` builds it.

Entry points: ``python -m distel_tpu_torch.cli warmup`` and the serve
plane's background warmup (``ServeApp(warmup_paths=...)``).  Corpora
warm on a thread pool, as in the reference; their card captures take
one process-wide lock (``core/bucketing.CAPTURE_LOCK``), so only the
host work (load, index, tables) overlaps.
"""

from __future__ import annotations

import time
from typing import List, Optional

from distel_tpu_torch.config import ClassifierConfig


def _index_text(text: str, config: ClassifierConfig):
    """Text → IndexedOntology through the load plane classify uses (the
    native one for OFN unless the config turns it off)."""
    from distel_tpu_torch.owl import loader as owl_loader

    if config.use_native_loader and owl_loader.detect_format(text) == "ofn":
        from distel_tpu_torch.owl import native_loader

        return native_loader.load_indexed(text)
    from distel_tpu_torch.core.indexing import index_ontology
    from distel_tpu_torch.frontend.normalizer import normalize

    return index_ontology(normalize(owl_loader.load(text)))


def warmup_text(
    text: str,
    config: Optional[ClassifierConfig] = None,
    *,
    profile: str = "serve",
    max_iters: Optional[int] = None,
    device=None,
) -> dict:
    """Build the programs one sample corpus resolves to, on ``device``
    (None = the first card; raises when there is none).  Returns the
    resolved ``bucket_signature`` and the build's
    :class:`~distel_tpu_torch.runtime.instrumentation.CompileStats`
    fields (all 0 when the bucket was warm), with the delta roster's
    count and build seconds."""
    from distel_tpu_torch.runtime.classifier import resolve_device

    from distel_tpu_torch.core.artifacts import ARTIFACT_EVENTS

    config = config or ClassifierConfig()
    dev = resolve_device(device)
    t0 = time.monotonic()
    art0 = ARTIFACT_EVENTS.snapshot()
    idx = _index_text(text, config)
    if profile == "serve":
        from distel_tpu_torch.core.incremental import rebuild_engine

        engine = rebuild_engine(config, idx, dev)
    elif profile == "classify":
        from distel_tpu_torch.runtime.classifier import make_engine

        engine = make_engine(config, idx, dev)
    else:
        raise ValueError(
            f"unknown warmup profile {profile!r}: 'serve' or 'classify'"
        )
    # as the reference's classifier: a mesh's engine builds in its run
    if hasattr(engine, "precompile") and getattr(engine, "mesh", None) is None:
        stats = engine.precompile(max_iters or config.max_iterations)
    else:
        from distel_tpu_torch.runtime.instrumentation import CompileStats

        stats = CompileStats()
    delta_recs = []
    if profile == "serve":
        from distel_tpu_torch.core.incremental import warm_delta_programs

        delta_recs = warm_delta_programs(config, engine, idx,
                                         max_iters=max_iters)
    # the artifact farm's share of this corpus's roster: hits off an
    # installed farm, or specs a bake wrote (counts of the process-wide
    # aggregate over this call)
    art1 = ARTIFACT_EVENTS.snapshot()
    art = {
        k: art1[k] - art0[k]
        for k in ("exe_hits", "hlo_hits", "serialized", "unserializable")
    }
    return {
        "profile": profile,
        "concepts": idx.n_concepts,
        "links": idx.n_links,
        "wall_s": round(time.monotonic() - t0, 3),
        "artifact_exe_hits": art["exe_hits"],
        "artifact_hlo_hits": art["hlo_hits"],
        "artifact_serialized": art["serialized"],
        "artifact_unserializable": art["unserializable"],
        "sparse_programs": 0,
        "fused_programs": len(getattr(engine, "fused_window_stats",
                                      lambda: [])()),
        "delta_programs": len(delta_recs),
        "delta_compile_s": round(
            sum(r["compile_s"] + r["trace_lower_s"] for r in delta_recs), 4
        ),
        **stats.as_dict(),
    }


def warmup_texts(
    texts: List[str],
    config: Optional[ClassifierConfig] = None,
    *,
    profile: str = "serve",
    max_iters: Optional[int] = None,
    parallel: bool = True,
    max_workers: Optional[int] = None,
    device=None,
) -> List[dict]:
    """Warm every bucket in ``texts`` (one sample corpus each), on a
    thread pool by default (the registry's per-key lock builds a shared
    key once)."""
    config = config or ClassifierConfig()

    def one(t):
        return warmup_text(t, config, profile=profile, max_iters=max_iters,
                           device=device)

    if not parallel or len(texts) <= 1:
        return [one(t) for t in texts]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_workers or min(len(texts), 4)) as pool:
        return list(pool.map(one, texts))


def warmup_paths(
    paths: List[str],
    config: Optional[ClassifierConfig] = None,
    **kw,
) -> List[dict]:
    """File-path convenience over :func:`warmup_texts`."""
    texts = []
    for p in paths:
        with open(p, "r", encoding="utf-8-sig") as f:
            texts.append(f.read())
    recs = warmup_texts(texts, config, **kw)
    for p, r in zip(paths, recs):
        r["file"] = p
    return recs
