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

With ``shape_buckets`` (the default) the rebuild's base engine is
bucketed and the delta and cross engines are too, with the base's layout
pinned (:func:`delta_program_kwargs`): their programs are pure functions
of their bucket signatures and come from ``core/program_cache.PROGRAMS``,
so a delta of a shape the process has run before builds nothing, and
:func:`warm_delta_programs` builds the steady-state roster ahead of
traffic.  At the reservation edge (the corpus grown into the base's last
row) a delta runs the exact-shape engines, as in the reference
(``_bucket_delta_eligible``); ``DISTEL_EXACT_DELTA_PROGRAMS=1`` forces
them.

The cohort plane (``core/cohort.py``) reuses the planner per tenant and
replaces only the executor: ``_delta_fast_plan(idx, cohort_shape=True)``
normalises a small delta to the canonical roster
(:meth:`IncrementalClassifier._canonical_delta_tables`), so class-only,
link and mixed deltas of one bucket share a roster key, and
``execute_delta_cohort`` runs one batched step program a vote for the
whole cohort.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from distel_tpu_torch.config import ClassifierConfig
from distel_tpu_torch.core import retract as retract_mod
from distel_tpu_torch.core.engine import SaturationResult
from distel_tpu_torch.core.indexing import Indexer
from distel_tpu_torch.core.rowpacked_engine import (
    RankWindows,
    RowPackedSaturationEngine,
)
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
    mesh=None,
    *,
    capacity_pad: Optional[int] = None,
    link_pad: Optional[int] = None,
    window_headroom: Optional[int] = None,
):
    """The engine of the incremental full rebuild: the config's engine
    with concept-lane and link-row headroom and rebind window slots
    (the row-packed engine takes them; the others ignore them), sharded
    over ``mesh`` (None off a mesh)."""
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
        mesh=mesh,
        min_concepts=idx.n_concepts + capacity_pad,
        min_links_pad=idx.n_links + link_pad,
        window_headroom=window_headroom,
    )


def delta_program_kwargs(config: ClassifierConfig, base, *, bucket: bool) -> dict:
    """The shape interlock of a delta or cross engine against the base:
    the base's state layout ``(nc, nl)`` exactly (the engines round-robin
    over ONE packed state) and its L-chunk length, on its device and its
    mesh, with the CR6 formulation the config selects.  Shared by the fast path and
    :func:`warm_delta_programs`: a warmed program pays off only when it
    is the one live traffic asks for.  ``bucket=True`` (the reference's
    steady-state posture) also makes the delta engines shape-bucketed
    with the base layout pinned verbatim (``state_dims``), so their
    programs are pure functions of their bucket signatures."""
    kw = dict(
        pad_multiple=base.nc,
        min_links_pad=base.nl,
        l_chunk=base.lc,
        device=base.device,
        mesh=base.mesh,
        cr6_tiles=config.cr6_tiles_config(),
    )
    if bucket:
        kw.update(
            bucket=True,
            bucket_ratio=config.bucket_ratio,
            state_dims=(base.nc, base.nl),
        )
    return kw


class DeltaPlan:
    """One increment's fast-path roster: ``engines`` in round-robin
    order — the delta (B) engine, the cross engine when links grew, and
    the BASE engine last; ``bucketed``: whether the delta engines run
    shape-bucketed programs."""

    __slots__ = ("engines", "base", "bucketed", "idx")

    def __init__(self, engines, base, bucketed, idx):
        self.engines = engines
        self.base = base
        self.bucketed = bool(bucketed)
        self.idx = idx

    def roster_key(self) -> tuple:
        """Position-wise bucket signatures (equal keys: the same program
        at every round-robin position)."""
        return tuple(e.bucket_signature for e in self.engines)

    def tile_stats(self) -> List[dict]:
        """Each delta engine's CR6 formulation (the base's is its
        rebuild's): whether it is the cross program, whether it runs the
        live-tile schedule, and the schedule's density and rungs."""
        out = []
        for e in self.engines:
            st = getattr(e, "cr6_tiles_stats", None)
            if e is self.base or st is None:
                continue
            out.append({
                "cross": getattr(e, "_link_window", None) is not None,
                **{k: st.get(k) for k in ("active", "reason", "density",
                                           "n_row_tiles", "n_link_tiles",
                                           "live_links")},
            })
        return out


def warm_delta_programs(
    config: ClassifierConfig,
    base_engine,
    idx,
    max_iters: Optional[int] = None,
    cohort_sizes: Optional[List[int]] = None,
) -> List[dict]:
    """Build the steady-state delta programs of a warmed base ahead of
    traffic, so even the first delta a restarted replica serves builds
    nothing — the reference's roster: the B program of a class-only
    delta (one NF1 row), of a link-creating one (one NF3 row, with CR6
    over a chain row and CR5 when the corpus has bottom axioms), of the
    two mixed, and the cross program (the full CR4/CR6 tables against a
    one-link window over the link whose role joins the most table
    families).  Content is irrelevant to a bucketed program, so
    one-row tables over the base corpus give the rungs live deltas ask
    for.  Returns one record per program.  ``cohort_sizes`` (None =
    ``config.cohort_warm_size_list()``): also build the cohort programs
    (``core/cohort.py``) of the canonical roster — the mixed delta
    program, the cross program and the base program — at those sizes'
    rungs, so a warmed process's first cohort builds nothing.  The delta
    programs are built on the base engine's mesh; on a mesh no cohort
    program is (the cohort refuses a mesh engine, as the reference's
    ``cohort_ready`` does)."""
    if not config.shape_buckets or base_engine is None:
        return []
    if not isinstance(base_engine, RowPackedSaturationEngine):
        return []
    if idx.n_concepts >= base_engine.nc or idx.n_links >= base_engine.nl:
        return []  # no dead-row reserve: live deltas would run exact
    kw = delta_program_kwargs(config, base_engine, bucket=True)
    budget = max_iters or config.max_iterations
    empty2 = np.zeros((0, 2), np.int64)
    empty3 = np.zeros((0, 3), np.int64)
    blank = dataclasses.replace(
        idx, nf1=empty2, nf2=empty3, nf3=empty2, nf4=empty3,
        chain_pairs=empty3,
    )

    def row_of(tab, width):
        return (np.asarray(tab[:1]) if len(tab)
                else np.zeros((1, width), np.int64))

    one_nf1 = row_of(idx.nf1, 2)
    link_tables = {"nf3": row_of(idx.nf3, 2)}
    link_rules = {"CR3"}
    if len(idx.chain_pairs):
        link_tables["chain_pairs"] = row_of(idx.chain_pairs, 3)
        link_rules.add("CR6")
    if idx.has_bottom_axioms:
        link_rules.add("CR5")
    rosters = [
        ("delta[CR1]", dataclasses.replace(blank, nf1=one_nf1),
         frozenset({"CR1"}), None),
        ("delta[link]", dataclasses.replace(blank, **link_tables),
         frozenset(link_rules), None),
        ("delta[mixed]",
         dataclasses.replace(blank, nf1=one_nf1, **link_tables),
         frozenset(link_rules | {"CR1"}), None),
    ]
    cross_rules = set()
    if len(idx.nf4):
        cross_rules.add("CR4")
    if len(idx.chain_pairs):
        cross_rules.add("CR6")
    if cross_rules and idx.n_links:
        h = np.asarray(idx.role_closure).astype(bool)

        def covered(roles):
            if not len(roles):
                return np.zeros(h.shape[0], bool)
            return h[:, np.unique(np.asarray(roles))].any(axis=1)

        in4 = covered(idx.nf4[:, 0] if len(idx.nf4) else ())
        in6 = covered(idx.chain_pairs[:, 0] if len(idx.chain_pairs) else ())
        link_roles = np.asarray(idx.links[:, 0])
        score = in4[link_roles].astype(int) + in6[link_roles].astype(int)
        best = int(np.argmax(score))
        rosters.append(("cross", idx, frozenset(cross_rules), (best, best + 1)))
    out = []
    engines = []
    for name, eng_idx, rules, window in rosters:
        eng = RowPackedSaturationEngine(
            eng_idx, rules=rules,
            **(dict(kw, link_window=window) if window else kw),
        )
        rec = eng.precompile(budget, programs=("run",)).as_dict()
        rec["program"] = name
        rec["bucket_signature"] = eng.bucket_signature
        out.append(rec)
        engines.append((name, eng))
    if cohort_sizes is None:
        cohort_sizes = config.cohort_warm_size_list()
    if cohort_sizes and config.cohort_enable and base_engine.mesh is None:
        from distel_tpu_torch.core.cohort import warm_cohort_programs

        # cohort traffic asks for the CANONICAL roster (the planner's
        # cohort_shape resolves every small delta to the delta[mixed]
        # shape, the cross program and the base program)
        warm_names = {"delta[mixed]", "cross"}
        roster = [(name, eng) for name, eng in engines
                  if name in warm_names] + [("base", base_engine)]
        for name, eng in roster:
            for rec in warm_cohort_programs([eng], cohort_sizes, budget):
                rec["program"] = f"cohort[{name}x{rec['rung']}]"
                out.append(rec)
    return out


class IncrementalClassifier:
    """Owns the persistent Normalizer cache (the reference's
    NORMALIZE_CACHE role), the persistent Indexer (stable ids), and the
    running closure, on ``device`` (None = the first card; raises when
    there is none).

    With ``mesh.devices`` or the coordinator keys it owns the mesh too
    (``parallel/mesh.setup``, as the classifier does) and every engine
    it builds shards over it: every rank of the group runs the same
    increments.  The running closure is the whole one on every rank (a
    run's result gathers it), so the retraction's host overdeletion
    reads it and the next rebuild embeds the survivors into each rank's
    window; the round-robin of a delta hands each rank's windows from
    engine to engine (:class:`~distel_tpu_torch.core.rowpacked_engine.
    RankWindows`) and gathers once at its end.  Rank 0 writes the
    snapshots, of the whole closure: a snapshot taken on a mesh restores
    on a mesh of any size, or on none."""

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
        from distel_tpu_torch.parallel.mesh import setup

        self.config = config or ClassifierConfig()
        self.config.validate()
        self.device = resolve_device(device)
        #: the mesh every engine shards over (None off a mesh)
        self._mesh = setup(self.config, self.device)
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
        #: the last fast-path plan's delta engines' CR6 formulations
        #: (:meth:`DeltaPlan.tile_stats`; reports only, not the history)
        self.last_delta_tiles: List[dict] = []
        #: the record of the cohort the last increment ran in
        #: (``core/cohort.execute_delta_cohort``; None when it ran solo)
        self.last_cohort: Optional[dict] = None
        #: program-build record of the last increment: the rebuild
        #: engine's ``compile_stats``, or on the fast path the delta
        #: programs' summed (the serve registry exports it to /metrics)
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
        the frontend.  Returns the retained state's bytes.  On a mesh
        each rank keeps its own word windows (:class:`RankWindows` of
        host tensors), which :meth:`warm_closure` gathers; the bytes are
        then the whole closure's (every rank holds one window of equal
        width), which the serve registry's budgets count as off a mesh."""
        if self.last_result is None:
            raise ValueError("nothing to demote: no increment has completed")
        res = self.last_result
        if res.transposed and self._wire_state() and res.shards is not None:
            state = RankWindows(*(t.detach().cpu() for t in res.shards))
        elif res.transposed and self._wire_state():
            state = res.wire()
        else:
            state = (np.asarray(res.s), np.asarray(res.r))
        self._state = state
        self._warm_idx = res.idx
        self._base_engine = self._base_idx = None
        self.last_result = None
        self.last_delta_stats = None
        nbytes = int(state[0].nbytes + state[1].nbytes)
        return nbytes * self._mesh.size if isinstance(state, RankWindows) else nbytes

    def promote(self) -> SaturationResult:
        """Rebuild the engine over the index :meth:`demote` kept and
        warm-start from the host state (one quiet pass)."""
        if self._warm_idx is None:
            raise ValueError("promote needs a prior demote")
        self._state = self.warm_closure()
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

    def warm_closure(self):
        """The demoted closure, whole, as host arrays.  On a mesh the
        ranks' windows are gathered: every rank calls it."""
        state = self._state
        if not isinstance(state, RankWindows):
            return state
        from distel_tpu_torch.parallel.shard_compat import all_gather_words

        return tuple(
            all_gather_words(t.to(self.device), self._mesh)
            .cpu().numpy().view(np.uint32)
            for t in state
        )

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
        self.last_cohort = None
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
                **(
                    self.last_compile.as_dict()
                    if self.last_compile is not None
                    else {}
                ),
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

    def snapshot(self, path: str, compressed: bool = True,
                 result: Optional[SaturationResult] = None) -> None:
        """Spill the running closure (``runtime/checkpoint``'s ``.npz``
        forms, which either package restores), or ``result`` (the serve
        registry's view of a demoted closure).  On a mesh every rank
        calls it: rank 0 writes the whole closure, and no rank returns
        before the file is there."""
        from distel_tpu_torch.runtime.checkpoint import save_snapshot

        result = result if result is not None else self.last_result
        if result is None:
            raise ValueError("nothing to snapshot: no increment has completed")
        mesh = self._mesh
        if mesh is None or mesh.rank == 0:
            save_snapshot(path, result, compressed=compressed)
        if mesh is not None and mesh.size > 1:
            from distel_tpu_torch.parallel.shard_compat import psum_

            psum_(torch.zeros(1, device=self.device), mesh)   # the barrier

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
                self._mesh,
                capacity_pad=self._CAPACITY_PAD,
                link_pad=self._LINK_PAD,
                window_headroom=self._WINDOW_HEADROOM,
            )
        # hand the old closure over without keeping a reference here:
        # holding it through the run would add a full state to the peak
        self.last_result = None
        with self.timer.phase("saturate"):
            result = self._rebuild_saturate(engine, idx)
        self.last_compile = getattr(engine, "compile_stats", None)
        if isinstance(engine, RowPackedSaturationEngine):
            self._base_engine, self._base_idx = engine, idx
        return result

    def _bucket_delta_eligible(self, idx, base) -> bool:
        """Whether this delta's B and cross engines run bucketed programs
        (shared through the registry) rather than exact-shape ones.  The
        bucketed plans OR their pad segments into the base layout's last
        concept and link rows, which must lie past the corpus; at the
        reservation edge the delta runs exact-shape engines — the same
        closure, not shared, counted as ``delta_bucketed: false``.
        ``DISTEL_EXACT_DELTA_PROGRAMS=1`` forces the exact-shape path."""
        if not self.config.shape_buckets:
            return False
        if os.environ.get("DISTEL_EXACT_DELTA_PROGRAMS"):
            return False
        return idx.n_concepts < base.nc and idx.n_links < base.nl

    def _rebuild_saturate(self, engine, idx) -> SaturationResult:
        """The rebuild's fixed point: the observed loop for a traced
        request under ``obs.trace_rounds`` (each round a span event on
        its trace) and/or a ledgered rebuild (``obs.ledger.enable``, one
        run-ledger record a round), where the engine has one (the
        row-packed and dense engines; the packed engine and the hybrid
        stay unobserved, as in the reference); else :meth:`saturate`.
        Either way the closure and derivations are the same (the
        adaptive controller counts a sparse round as one iteration)."""
        from distel_tpu_torch.obs import trace as obs_trace

        observable = hasattr(engine, "saturate_observed")
        sp = obs_trace.active_span()
        traced_rounds = (
            self.config.obs_trace_rounds
            and sp is not None
            and sp.sampled  # an unsampled carrier records nothing
            and observable
        )
        ledger_obs = None
        if self.config.obs_ledger and observable:
            from distel_tpu_torch.obs.ledger import rebuild_ledger_observer

            ledger_obs = rebuild_ledger_observer(
                self.config,
                meta={
                    "kind": "rebuild",
                    "increment": self.increment,
                    # n_classes keys the cost-model fit
                    "n_classes": int(len(idx.original_classes)),
                    "n_concepts": idx.n_concepts,
                    "n_links": idx.n_links,
                    # the mesh keys the cost-model fit's shards: 1-shard
                    # and N-shard seconds a round must not mix
                    "n_shards": int(getattr(engine, "n_shards", 1) or 1),
                },
            )
        if not (traced_rounds or ledger_obs is not None):
            return engine.saturate(
                self.config.max_iterations, initial=self._pop_state()
            )
        kw = {}
        if ledger_obs is not None:
            kw["observer"] = ledger_obs.observer
            if isinstance(engine, RowPackedSaturationEngine):
                # tier/density/dispatch telemetry: only the row-packed
                # controller has the frontier hook
                kw["frontier_observer"] = ledger_obs.frontier_observer
        try:
            result = engine.saturate_observed(
                self.config.max_iterations, initial=self._pop_state(), **kw
            )
        except BaseException:
            if ledger_obs is not None:
                ledger_obs.close("error")
                ledger_obs.ledger.close()
            raise
        if ledger_obs is not None:
            ledger_obs.close(
                "converged" if result.converged else "incomplete",
                iterations=int(result.iterations),
                derivations=int(result.derivations),
            )
            ledger_obs.ledger.close()
        return result

    def _delta_fast_path(self, idx) -> Optional[SaturationResult]:
        """Plan and run the delta fast path (None = take the rebuild)."""
        with self.timer.phase("plan"):
            plan = self._delta_fast_plan(idx)
        if plan is None:
            return None
        with self.timer.phase("saturate"):
            return self._execute_delta_plan(plan)

    def _canonical_delta_tables(self, idx, b, delta_idx, links_grew):
        """The canonical cohort roster's tables, or None when this delta
        cannot take the canonical shape (the reference's rule).

        Canonical = the base-structure-determined union of the two
        traffic shapes of the reference's streaming scenario (class
        assertions and property assertions) — the ``delta[mixed]``
        roster :func:`warm_delta_programs` warms.  A member whose delta
        lacks a family rides an INERT REPLAY row of the base instead:
        re-deriving a base axiom against a closure that holds its
        consequences sets no new bit (monotone, idempotent), so padding
        changes neither the fixed point nor the solo run of the same
        plan; it aligns the tables' rungs so heterogeneous deltas share
        one signature.  A family's rows still quantize on the seg-OR
        ladder, so deltas share a key only while each family stays
        within the ladder's floor rung (8 segments a level).  Returns
        ``(canon_idx, rules, link_window | None)``."""
        from distel_tpu_torch.core.indexing import TOP_ID

        # only the canonical families can be padded; a delta carrying
        # nf2/nf4 rows (or chain axioms over a chainless base, where no
        # inert chain row exists for its peers) keeps its content shape
        if len(delta_idx.nf2) or len(delta_idx.nf4):
            return None
        if len(delta_idx.chain_pairs) and not len(b.chain_pairs):
            return None
        tables = {}
        rules = {"CR1"}
        inert1 = (
            np.asarray(b.nf1[:1])
            if len(b.nf1)
            else np.asarray([[TOP_ID, TOP_ID]], np.int64)
        )
        tables["nf1"] = (
            np.asarray(delta_idx.nf1) if len(delta_idx.nf1) else inert1
        )
        if len(b.nf3):
            rules.add("CR3")
            tables["nf3"] = (
                np.asarray(delta_idx.nf3)
                if len(delta_idx.nf3)
                else np.asarray(b.nf3[:1])
            )
            if len(b.chain_pairs):
                rules.add("CR6")
                tables["chain_pairs"] = (
                    np.asarray(delta_idx.chain_pairs)
                    if len(delta_idx.chain_pairs)
                    else np.asarray(b.chain_pairs[:1])
                )
        elif len(delta_idx.nf3):
            # link-creating delta over an nf3-less base: class-only
            # peers would have no inert nf3 row to pad with
            return None
        if idx.has_bottom_axioms:
            # uniform across link-creating and class-only members (the
            # solo roster gates CR5 on links_grew; the extra sweep here
            # is an idempotent re-derivation)
            rules.add("CR5")
        canon_idx = dataclasses.replace(
            delta_idx,  # nf2/nf4 stay the (guarded) empty delta tables
            nf1=tables["nf1"],
            nf3=tables.get("nf3", delta_idx.nf3),
            chain_pairs=tables.get("chain_pairs", delta_idx.chain_pairs),
        )
        # the cross program joins the FULL nf4/chain tables against a
        # link window: the delta's new links when they exist, else ONE
        # existing base link (inert replay) so class-only members share
        # the cross position too (window bounds are table content)
        window = None
        if len(idx.nf4) or len(idx.chain_pairs):
            if links_grew:
                window = (b.n_links, idx.n_links)
            elif b.n_links:
                window = (b.n_links - 1, b.n_links)
        return canon_idx, rules, window

    def _delta_fast_plan(self, idx, *, cohort_shape: bool = False
                         ) -> Optional[DeltaPlan]:
        """The fast path's guards and engine roster.  May rebind the base
        engine's closure, so a returned plan must be executed.

        Eligible when the delta's concepts fit the base's concept lanes,
        its new links the reserved link rows, and the base tables
        survive as a prefix (nf1-nf3, links) or a subset (the sorted
        nf4 and chain pairs).  New roles are invisible to the base
        engine; a closure grown between base roles is rebound.
        ``cohort_shape``: normalise the roster to the canonical cohort
        shape (:meth:`_canonical_delta_tables`) when the delta programs
        are bucketed and the delta allows it; else the content roster."""
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
        bucket_delta = self._bucket_delta_eligible(idx, base)
        shape_kw = delta_program_kwargs(self.config, base, bucket=bucket_delta)
        canon = None
        if cohort_shape and bucket_delta:
            canon = self._canonical_delta_tables(idx, b, delta_idx, links_grew)
        cross_rules = set()
        if len(idx.nf4):
            cross_rules.add("CR4")
        if len(idx.chain_pairs):
            cross_rules.add("CR6")
        engines = []
        if canon is not None:
            canon_idx, canon_rules, window = canon
            engines.append(
                RowPackedSaturationEngine(
                    canon_idx, rules=frozenset(canon_rules), **shape_kw
                )
            )
            if window is not None:
                engines.append(
                    RowPackedSaturationEngine(
                        idx,  # FULL tables × the (possibly inert) window
                        rules=frozenset(cross_rules),
                        link_window=window,
                        **shape_kw,
                    )
                )
        else:
            if rules:
                engines.append(
                    RowPackedSaturationEngine(
                        delta_idx, rules=frozenset(rules), **shape_kw
                    )
                )
            if links_grew and cross_rules:
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
        plan = DeltaPlan(engines=engines, base=base, bucketed=bucket_delta,
                         idx=idx)
        self.last_delta_tiles = plan.tile_stats()
        return plan

    def _execute_delta_plan(self, plan: DeltaPlan) -> SaturationResult:
        """The round-robin joint fixed point over the delta/cross engines
        and the base engine, on one state that stays on the device (on a
        mesh, each rank's windows, gathered once at the end)."""
        engines = plan.engines
        sharded = plan.base.n_shards > 1
        self.last_result = None
        # a one-slot box keeps this frame from pinning a state through a
        # saturate call (a held reference would add a full state)
        box = [engines[0].embed_state(*self._pop_state())]
        if sharded:
            box = [RankWindows(*box[0])]
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
                self.config.max_iterations, initial=box.pop(), init_total=0,
                gather=not sharded,
            )
            iters += r.iterations
            unproductive = r.iterations <= eng.unroll
            box.append(RankWindows(*r.shards) if sharded
                       else (r.packed_s, r.packed_r))
            del r
            streak = streak + 1 if unproductive else 0
        final_total = count(*box[0])
        # the increment's program cost: the delta programs only (the
        # base's build was charged to its rebuild); compile-free only
        # when every delta program hit the registry
        from distel_tpu_torch.runtime.instrumentation import CompileStats

        base = plan.base
        agg = CompileStats(bucket_signature=base.bucket_signature,
                           program="delta-programs")
        n_programs = hits = 0
        delta_sig = ""
        for eng in engines:
            if eng is not base:
                agg.merge(eng.compile_stats)
                n_programs += 1
                hits += bool(eng.compile_stats.program_cache_hit)
                delta_sig = delta_sig or eng.bucket_signature
        agg.program_cache_hit = n_programs > 0 and hits == n_programs
        self.last_compile = agg
        self.last_delta_stats = {
            "delta_bucketed": plan.bucketed,
            "delta_programs": n_programs,
            "delta_program_hits": hits,
            "delta_signature": delta_sig,
        }
        sp, rp = box.pop()
        shards = (sp, rp) if sharded else None
        sp, rp = base.gather_state(sp, rp)
        return SaturationResult(
            packed_s=sp,
            packed_r=rp,
            iterations=iters,
            derivations=final_total - start_total,
            idx=plan.idx,
            converged=True,
            transposed=True,
            shards=shards,
        )
