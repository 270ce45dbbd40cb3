"""Incremental classification: add axiom batches to a saturated closure,
and retract them.

The port of ``distel_tpu/core/incremental.py``'s exact-layout
(unbucketed) plane — the reference's streaming mode
(``scripts/traffic-data-load-classify.sh``, driven by ``cli stream``).
EL+ saturation is monotone, so the previous closure S/R is a sound
starting point: the persistent ``Indexer`` keeps ids append-only, the
old state embeds into the grown arrays, and the fixed point runs again.

The **delta fast path** reuses the last full rebuild's row-packed engine
(the *base*): its rules work on subsumer and link ROWS, so a delta's new
concepts are new bit lanes inside the base's concept padding and its new
links park in the base's reserved link rows, where the base's stale
tables keep them inert (sentinel role, ⊤ filler).  Beside the base run

* the delta engine (B): the delta's own axiom rows against the full
  state;
* the cross engine (A, link-creating deltas): the FULL CR4/CR6 tables
  against only the new-link window (the two one-sided halves of the
  reference's T3₂ increment join);

and the engines round-robin to a joint fixed point over one packed state
on the device.  A delta that grows the closure between EXISTING roles
rebinds the base's masks (``rebind_role_closure``); one the rebind
cannot express, or one that overflows a reservation, takes the full
rebuild.  Every state stays on the engines' device between increments.

:meth:`IncrementalClassifier.retract` is DRed delete-and-rederive
(``core/retract.py``, a copy of the reference's): the overdeletion reads
the unpacked closure on the host, then a full rebuild re-derives from
the survivors.

Not ported yet: shape-bucketed delta programs and
``warm_delta_programs``, the cohort plane's canonical roster, and the
observed rebuild (``obs.trace_rounds`` / ``obs.ledger``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import retract as retract_mod
from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.core.indexing import Indexer
from distel_tpu_torch.core.rowpacked_engine import RowPackedSaturationEngine
from distel_tpu_torch.frontend.normalizer import NormalizedOntology, Normalizer
from distel_tpu_torch.owl import loader as owl_loader
from distel_tpu_torch.runtime.classifier import (
    PhaseTimer,
    make_engine,
    resolve_device,
)


def _merge(into: NormalizedOntology, batch: NormalizedOntology) -> None:
    into.nf1.extend(batch.nf1)
    into.nf2.extend(batch.nf2)
    into.nf3.extend(batch.nf3)
    into.nf4.extend(batch.nf4)
    into.nf5.extend(batch.nf5)
    into.nf6.extend(batch.nf6)
    into.removed.update(batch.removed)
    into.gensyms.update(batch.gensyms)


def rebuild_engine(
    config: ClassifierConfig,
    idx,
    device,
    *,
    capacity_pad: Optional[int] = None,
    link_pad: Optional[int] = None,
    window_headroom: Optional[int] = None,
):
    """The engine of the incremental full rebuild: the config's engine
    with concept-lane and link-row headroom and rebind window slots
    (the row-packed engine takes them; the others ignore them)."""
    if capacity_pad is None:
        capacity_pad = IncrementalClassifier._CAPACITY_PAD
    if link_pad is None:
        link_pad = IncrementalClassifier._LINK_PAD
    if window_headroom is None:
        window_headroom = IncrementalClassifier._WINDOW_HEADROOM
    cfg = dataclasses.replace(
        config, pad_multiple=max(config.pad_multiple, capacity_pad)
    )
    return make_engine(
        cfg,
        idx,
        device,
        min_concepts=idx.n_concepts + capacity_pad,
        min_links_pad=idx.n_links + link_pad,
        window_headroom=window_headroom,
    )


def delta_program_kwargs(config: ClassifierConfig, base, *, bucket: bool) -> dict:
    """The shape interlock of a delta or cross engine against the base:
    the base's state layout ``(nc, nl)`` exactly (the engines round-robin
    over ONE packed state) and its L-chunk length, on its device, with
    the CR6 formulation the config selects.  ``bucket=True`` (the
    reference's shape-bucketed delta programs) is not ported."""
    if bucket:
        raise ValueError("shape-bucketed delta engines are not ported")
    return dict(
        pad_multiple=base.nc,
        min_links_pad=base.nl,
        l_chunk=base.lc,
        device=base.device,
        cr6_tiles=config.cr6_tiles_config(),
    )


class DeltaPlan:
    """One increment's fast-path roster: ``engines`` in round-robin
    order — the delta (B) engine, the cross engine when links grew, and
    the BASE engine last."""

    __slots__ = ("engines", "base", "idx")

    def __init__(self, engines, base, idx):
        self.engines = engines
        self.base = base
        self.idx = idx


class IncrementalClassifier:
    """Owns the persistent Normalizer cache (the reference's
    NORMALIZE_CACHE role), the persistent Indexer (stable ids), and the
    running closure, on ``device`` (None = the first card; raises when
    there is none)."""

    #: extra concept-id headroom built into the rebuild's engine so later
    #: class-only deltas fit its concept lanes
    _CAPACITY_PAD = 2048

    #: extra link-ROW headroom reserved by the full rebuild: a later
    #: link-creating delta parks its new links there
    _LINK_PAD = 2048

    #: below this many base concepts the full rebuild is taken; the
    #: instance copies ``config.fast_path_min_concepts``, and tests may
    #: assign the instance attribute to force a path
    _FAST_PATH_MIN_CONCEPTS = 2_048

    #: live-window slots reserved per CR4/CR6 chunk of the base engine so
    #: a later closure-growing role delta rebinds instead of rebuilding
    _WINDOW_HEADROOM = 2

    def __init__(self, config: Optional[ClassifierConfig] = None, device=None):
        self.config = config or ClassifierConfig()
        self.config.validate()
        self.device = resolve_device(device)
        self._FAST_PATH_MIN_CONCEPTS = int(self.config.fast_path_min_concepts)
        self.indexer = Indexer()
        self.accumulated = NormalizedOntology()
        self._normalizer_cache: dict = {}
        #: cross-increment range-elimination state and the per-role
        #: effective range sets as of the last increment
        self._range_state = None
        self._range_eff: dict = {}
        #: the closure between increments: device tensors (packed,
        #: transposed) for the row-packed engines, host bool x-major
        #: arrays for the packed and dense engines
        self._state = None
        self.increment = 0  # the reference's CURRENT_INCREMENT counter
        self.history: List[dict] = []
        self.last_result: Optional[SaturationResult] = None
        #: the engine of the last full rebuild and the index it was built
        #: at (the fast path's base)
        self._base_engine = None
        self._base_idx = None
        #: fast-path accounting of the last increment (None on a rebuild)
        self.last_delta_stats: Optional[dict] = None
        #: the reference's program-build record of the last increment;
        #: the port compiles no programs, so it stays None (the serve
        #: registry's compile counters then record nothing)
        self.last_compile = None
        #: the index :meth:`demote` keeps for :meth:`promote`
        self._warm_idx = None
        #: one record per ingest: ``{"text", "spans": {nf: (start, end)}
        #: | None, "retracted"}`` — the provenance :meth:`retract` reads
        self._ingests: List[dict] = []
        #: wall seconds per phase of the last operation (``ingest``,
        #: ``plan``, ``saturate``; a retraction's ``overdelete`` and
        #: ``clear``), the card synchronised at each boundary
        self.timer = PhaseTimer(self.device)

    @property
    def last_phases(self) -> dict:
        return dict(self.timer.phases)

    def _wire_state(self) -> bool:
        """Whether the config's engine takes the packed wire state (the
        row-packed engine and the hybrid) rather than x-major bools."""
        return self.config.engine in ("auto", "rowpacked")

    def _keep(self, result: SaturationResult):
        if result.transposed and self._wire_state():
            return (result.packed_s, result.packed_r)
        return (result.s, result.r)

    def add_text(self, text: str) -> SaturationResult:
        return self.add_ontology(owl_loader.load(text), source_text=text)

    def drop_base_program(self) -> None:
        """Forget the base engine so the NEXT delta takes the full
        rebuild (to time or compare the rebuild)."""
        self._base_engine = self._base_idx = None

    def _pop_state(self):
        state, self._state = self._state, None
        return state

    # ------------------------------------------------- warm tier (serve)

    def demote(self) -> int:
        """Drop the engine and every device tensor, keeping host state:
        the frontend caches, the retained index, and the closure as host
        arrays.  :meth:`promote` rebuilds from them without replaying
        the frontend.  Returns the retained state's bytes."""
        if self.last_result is None:
            raise ValueError("nothing to demote: no increment has completed")
        res = self.last_result
        if res.transposed and self._wire_state():
            state = res.wire()
        else:
            state = (np.asarray(res.s), np.asarray(res.r))
        self._state = state
        self._warm_idx = res.idx
        self._base_engine = self._base_idx = None
        self.last_result = None
        self.last_delta_stats = None
        return int(state[0].nbytes + state[1].nbytes)

    def promote(self) -> SaturationResult:
        """Rebuild the engine over the index :meth:`demote` kept and
        warm-start from the host state (one quiet pass)."""
        if self._warm_idx is None:
            raise ValueError("promote needs a prior demote")
        idx, self._warm_idx = self._warm_idx, None
        self.timer = PhaseTimer(self.device)
        result = self._full_rebuild(idx)
        self._state = self._keep(result)
        self.history.append(
            {
                "increment": self.increment,
                "iterations": result.iterations,
                "new_derivations": result.derivations,
                "path": "promote",
            }
        )
        self.last_result = result
        return result

    def _ingest(self, onto, source_text: Optional[str] = None):
        """Frontend half of an increment: normalize the batch under the
        persistent caches, merge it into the accumulated corpus (with
        the batch's row spans for :meth:`retract`), re-index.  Returns
        ``(idx, batch)``."""
        normalizer = Normalizer(
            cache=self._normalizer_cache, range_state=self._range_state
        )
        batch = normalizer.normalize(onto)
        # append-only range retrofit of earlier increments' rows (they
        # land in ``batch``, so they are attributed to this ingest: the
        # reason retract refuses while range machinery is active)
        normalizer.retrofit_ranges(self.accumulated.nf3, self._range_eff)
        self._normalizer_cache = normalizer.export_cache()
        self._range_state = normalizer.export_range_state()
        families = retract_mod.NF_FAMILIES
        before = {fam: len(getattr(self.accumulated, fam)) for fam in families}
        _merge(self.accumulated, batch)
        self._ingests.append(
            {
                "text": source_text,
                "spans": {
                    fam: (before[fam], len(getattr(self.accumulated, fam)))
                    for fam in families
                },
                "retracted": False,
            }
        )
        self._range_eff = {
            r: normalizer.effective_ranges(r) for r in self.accumulated.roles()
        }
        return self.indexer.index(self.accumulated), batch

    def add_ontology(self, onto, source_text: Optional[str] = None) -> SaturationResult:
        self.timer = PhaseTimer(self.device)
        with self.timer.phase("ingest"):
            idx, batch = self._ingest(onto, source_text=source_text)
        self.last_delta_stats = None
        result = self._delta_fast_path(idx)
        path = "fast" if result is not None else "rebuild"
        if result is None:
            result = self._full_rebuild(idx)
        return self._finish_increment(batch, result, path)

    def _finish_increment(self, batch, result: SaturationResult, path: str):
        self._state = self._keep(result)
        self.increment += 1
        self.history.append(
            {
                "increment": self.increment,
                "batch_axioms": batch.axiom_count(),
                "iterations": result.iterations,
                "new_derivations": result.derivations,
                # "fast": base engine reused; "rebuild": a fresh engine
                "path": path,
                **(self.last_delta_stats or {}),
            }
        )
        self.last_result = result
        return result

    # --------------------------------------------------------- retraction

    def retract(self, text: str) -> SaturationResult:
        """Retract a previously added axiom text and repair the closure
        (DRed delete-and-rederive, ``core/retract.py``).  The text must
        equal a live prior ``add_text`` source exactly; refusals
        (``RetractionError`` subclasses) mutate nothing.  The repair is
        equal to a from-scratch classify of the surviving texts.  The
        overdeletion reads the unpacked closure on the host."""
        if self.last_result is None:
            raise retract_mod.RetractionError(
                "retract needs a saturated closure "
                "(no increment has completed)"
            )
        k = retract_mod.find_ingest(self._ingests, text)
        self.timer = PhaseTimer(self.device)
        if (self._range_state and self._range_state[0]) or any(
            self._range_eff.values()
        ):
            raise retract_mod.EntangledRetraction(
                "retraction refused: range-elimination machinery is "
                "active — range retrofits re-emit rows for OLD axioms "
                "into later batches, so span provenance cannot "
                "attribute rows to texts"
            )
        spans = self._ingests[k]["spans"]
        dead = retract_mod.dead_rows(self.accumulated, spans)
        retract_mod.check_entanglement(self.accumulated, spans, dead)
        # ---- all refusal checks passed: mutate
        res = self.last_result
        with self.timer.phase("overdelete"):
            aff = retract_mod.affected_concepts(res.idx, res.s, res.r, dead)
        with self.timer.phase("ingest"):
            retract_mod.remove_spans(self.accumulated, self._ingests, k)
            retract_mod.purge_normalizer_cache(self._normalizer_cache, dead)
            # ids are append-only and the survivors a subset: same universe
            idx = self.indexer.index(self.accumulated)
        with self.timer.phase("clear"):
            self._state = retract_mod.clear_rows(res.s, res.r, aff)
        del res
        self.last_delta_stats = None
        result = self._full_rebuild(idx)
        self._state = self._keep(result)
        self.increment += 1
        self.history.append(
            {
                "increment": self.increment,
                "retracted_rows": sum(len(v) for v in dead.values()),
                "affected_concepts": int(aff.sum()),
                "iterations": result.iterations,
                "new_derivations": result.derivations,
                "path": "retract",
            }
        )
        self.last_result = result
        return result

    def _replay_retract(self, text: str) -> None:
        """Frontend-only retraction replay for :meth:`restore`."""
        k = retract_mod.find_ingest(self._ingests, text)
        dead = retract_mod.dead_rows(self.accumulated, self._ingests[k]["spans"])
        retract_mod.remove_spans(self.accumulated, self._ingests, k)
        retract_mod.purge_normalizer_cache(self._normalizer_cache, dead)

    # --------------------------------------------------- spill / restore

    def snapshot(self, path: str, compressed: bool = True) -> None:
        """Spill the running closure (``runtime/checkpoint``'s ``.npz``
        forms, which either package restores)."""
        from distel_tpu_torch.runtime.checkpoint import save_snapshot

        if self.last_result is None:
            raise ValueError("nothing to snapshot: no increment has completed")
        save_snapshot(path, self.last_result, compressed=compressed)

    @classmethod
    def restore(
        cls,
        texts: List,
        snapshot_path: str,
        config: Optional[ClassifierConfig] = None,
        device=None,
    ) -> "IncrementalClassifier":
        """Rebuild a live classifier from its spilled closure: ``texts``
        (the texts fed to :meth:`add_text`, in order, and retraction
        markers ``{"op": "retract", "text": ...}``) replay through the
        frontend only, which reproduces the numbering the snapshot was
        taken under; one full rebuild then warm-starts from the
        snapshot (one quiet pass)."""
        from distel_tpu_torch.runtime.checkpoint import load_snapshot_state

        inc = cls(config, device=device)
        idx = None
        inc.timer = PhaseTimer(inc.device)
        with inc.timer.phase("ingest"):
            for entry in texts:
                if isinstance(entry, dict):
                    if entry.get("op") != "retract":
                        raise ValueError(
                            f"unknown op-log entry in restore: {entry!r}"
                        )
                    inc._replay_retract(entry["text"])
                    idx = inc.indexer.index(inc.accumulated)
                else:
                    idx, _ = inc._ingest(
                        owl_loader.load(entry), source_text=entry
                    )
                inc.increment += 1
        if idx is None:
            raise ValueError("restore needs at least one replayed text")
        with inc.timer.phase("load"):
            state, _info = load_snapshot_state(
                snapshot_path, idx=idx, unpack=not inc._wire_state()
            )
        inc._state = state
        result = inc._full_rebuild(idx)
        inc._state = inc._keep(result)
        inc.history.append(
            {
                "increment": inc.increment,
                "restored_from": snapshot_path,
                "iterations": result.iterations,
                "new_derivations": result.derivations,
                "path": "restore",
            }
        )
        inc.last_result = result
        return inc

    def _full_rebuild(self, idx) -> SaturationResult:
        """A fresh engine for the whole accumulated corpus (with the
        reservations later deltas reuse), saturated from the previous
        closure."""
        # the stale base engine's tables are useless once a rebuild
        # starts: free them before the new engine allocates
        self._base_engine = self._base_idx = None
        self._warm_idx = None
        with self.timer.phase("plan"):
            engine = rebuild_engine(
                self.config,
                idx,
                self.device,
                capacity_pad=self._CAPACITY_PAD,
                link_pad=self._LINK_PAD,
                window_headroom=self._WINDOW_HEADROOM,
            )
        # hand the old closure over without keeping a reference here:
        # holding it through the run would add a full state to the peak
        self.last_result = None
        with self.timer.phase("saturate"):
            result = engine.saturate(
                self.config.max_iterations, initial=self._pop_state()
            )
        if isinstance(engine, RowPackedSaturationEngine):
            self._base_engine, self._base_idx = engine, idx
        return result

    def _delta_fast_path(self, idx) -> Optional[SaturationResult]:
        """Plan and run the delta fast path (None = take the rebuild)."""
        with self.timer.phase("plan"):
            plan = self._delta_fast_plan(idx)
        if plan is None:
            return None
        with self.timer.phase("saturate"):
            return self._execute_delta_plan(plan)

    def _delta_fast_plan(self, idx) -> Optional[DeltaPlan]:
        """The fast path's guards and engine roster.  May rebind the base
        engine's closure, so a returned plan must be executed.

        Eligible when the delta's concepts fit the base's concept lanes,
        its new links the reserved link rows, and the base tables
        survive as a prefix (nf1-nf3, links) or a subset (the sorted
        nf4 and chain pairs).  New roles are invisible to the base
        engine; a closure grown between base roles is rebound."""
        base, b = self._base_engine, self._base_idx
        if base is None or self._state is None:
            return None
        if b.n_concepts < self._FAST_PATH_MIN_CONCEPTS:
            return None
        links_grew = idx.n_links > b.n_links
        if (
            idx.n_concepts > base.nc
            or idx.n_links < b.n_links
            or idx.n_links > base.nl  # new links must fit the reserved rows
            or idx.n_roles < b.n_roles
            or len(idx.chain_pairs) < len(b.chain_pairs)
        ):
            return None
        clo_new = idx.role_closure[: b.n_roles, : b.n_roles]
        closure_changed = not np.array_equal(clo_new, b.role_closure)
        # the slicing below assumes every base row survives re-indexing
        # as a prefix (the indexer's append-only contract)
        for new, old in (
            (idx.nf1, b.nf1),
            (idx.nf2, b.nf2),
            (idx.nf3, b.nf3),
            (idx.links, b.links),
        ):
            if len(new) < len(old) or not np.array_equal(new[: len(old)], old):
                return None

        # nf4 / chain_pairs are globally SORTED by the indexer, so their
        # deltas are SET DIFFERENCES (a new row may sort into the prefix)
        span = np.int64(max(idx.n_concepts, idx.n_links, idx.n_roles, 2))

        def _sorted_delta(new, old):
            """(delta_rows, base_rows_all_survive)."""
            key = lambda t: (  # noqa: E731
                t[:, 0].astype(np.int64) * span + t[:, 1]
            ) * span + t[:, 2]
            if len(old) == 0:
                return new, True
            kn, ko = key(new), key(old)
            return new[~np.isin(kn, ko)], bool(np.isin(ko, kn).all())

        nf4_delta, nf4_ok = _sorted_delta(idx.nf4, b.nf4)
        cp_delta, cp_ok = _sorted_delta(idx.chain_pairs, b.chain_pairs)
        if not (nf4_ok and cp_ok):
            return None

        delta_idx = dataclasses.replace(
            idx,
            nf1=idx.nf1[len(b.nf1):],
            nf2=idx.nf2[len(b.nf2):],
            nf3=idx.nf3[len(b.nf3):],
            nf4=nf4_delta,
            chain_pairs=cp_delta,
        )
        rules = set()
        for name, tab in (
            ("CR1", delta_idx.nf1),
            ("CR2", delta_idx.nf2),
            ("CR3", delta_idx.nf3),
            ("CR4", delta_idx.nf4),
            ("CR6", delta_idx.chain_pairs),
        ):
            if len(tab):
                rules.add(name)
        # CR5 sweeps the full link table: the delta engine carries it
        # when the base never had it, or when new links exist that the
        # base's stale filler table cannot see
        if idx.has_bottom_axioms and (links_grew or not base._bottom):
            rules.add("CR5")
        shape_kw = delta_program_kwargs(self.config, base, bucket=False)
        engines = []
        if rules:
            engines.append(
                RowPackedSaturationEngine(
                    delta_idx, rules=frozenset(rules), **shape_kw
                )
            )
        if links_grew:
            cross_rules = set()
            if len(idx.nf4):
                cross_rules.add("CR4")
            if len(idx.chain_pairs):
                cross_rules.add("CR6")
            if cross_rules:
                engines.append(
                    RowPackedSaturationEngine(
                        idx,  # FULL tables × the new-link window only
                        rules=frozenset(cross_rules),
                        link_window=(b.n_links, idx.n_links),
                        **shape_kw,
                    )
                )
        if not engines and not closure_changed:
            return None  # nothing new for the engines: rebuild path
        if any((e.nc, e.nl) != (base.nc, base.nl) for e in engines):
            return None  # layouts diverge: take the rebuild path
        if closure_changed:
            # LAST, after every other guard: it mutates the base engine
            if not base.rebind_role_closure(clo_new):
                return None
            self._base_idx = b = dataclasses.replace(
                b, role_closure=np.asarray(clo_new)
            )
        engines.append(base)
        return DeltaPlan(engines=engines, base=base, idx=idx)

    def _execute_delta_plan(self, plan: DeltaPlan) -> SaturationResult:
        """The round-robin joint fixed point over the delta/cross engines
        and the base engine, on one state that stays on the device."""
        engines = plan.engines
        self.last_result = None
        # a one-slot box keeps this frame from pinning a state through a
        # saturate call (a held reference would add a full state)
        box = [engines[0].embed_state(*self._pop_state())]
        # engines[0] was built from the full index: its live mask covers
        # the whole universe (the base's masks lanes past its own)
        count = engines[0].count_live_bits
        start_total = count(*box[0])
        iters = 0
        streak = 0
        ei = 0
        # stop once every engine in turn reports a quiet vote; the vote
        # is the raw change signal (iterations <= unroll), never a
        # count, which the base engine masks past its own universe
        while streak < len(engines):
            eng = engines[ei % len(engines)]
            ei += 1
            r = eng.saturate(
                self.config.max_iterations, initial=box.pop(), init_total=0
            )
            iters += r.iterations
            unproductive = r.iterations <= eng.unroll
            box.append((r.packed_s, r.packed_r))
            del r
            streak = streak + 1 if unproductive else 0
        final_total = count(*box[0])
        self.last_delta_stats = {
            "delta_bucketed": False,
            "delta_programs": len(engines) - 1,
        }
        return SaturationResult(
            packed_s=box[0][0],
            packed_r=box[0][1],
            iterations=iters,
            derivations=final_total - start_total,
            idx=plan.idx,
            converged=True,
            transposed=True,
        )
