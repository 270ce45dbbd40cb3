"""Calibrated rounds-vs-size cost model + online ETA (stdlib only).

The SCALE_r05 128k run was launched on a hand-waved 5-10 h band,
under-estimated by >=45%, and killed blind after 14h22m.  This module
is the calibration layer that ROADMAP item asks for:

* :func:`load_probe_lines` — back-compat reader for the tracked
  ``SCALE_r04_probes.jsonl`` / ``SCALE_r05_probes.jsonl`` line formats
  (flat compile probes, flat exec records incl. resumed tails, and the
  r04 component-partitioned record with its nested ``exec`` block) —
  they seed the first fitted model;
* :func:`load_ledger_observations` — the same observations from run
  ledgers (``distel_tpu/obs/ledger.py``), so every completed observed
  run sharpens the next launch's prediction;
* :func:`fit_cost_model` — power-law fits of rounds-vs-size and
  seconds-per-round-vs-size (log-log least squares past two distinct
  sizes; a single observation anchors the documented default
  exponents, which reproduce the measured 128k behavior from the 64k
  point: ~34 min/round and ~14 h total);
* :class:`OnlineEta` — the in-flight estimate re-stamped into the
  ledger each round: rolling round-wall median x remaining-rounds from
  the derivation-curve tail (geometric decay extrapolation), falling
  back to the fitted model while the frontier is still growing;
* :func:`guard_launch` — the launch budget guard ``scale_probe`` and
  ``cli classify --budget-s`` refuse over-budget runs with.
"""

from __future__ import annotations

import glob
import json
import math
import os
import statistics
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

#: anchored-fit exponents used when the basis holds only ONE executed
#: size (a regression needs two).  seconds-per-round ~ n^2: the packed
#: step is bit-table matmuls over an O(n^2)-bit state (64k galen
#: measured 516 s/round -> predicts ~34 min/round at 128k, matching
#: SCALE_r05's observed ~40 min rounds).  rounds ~ n^0.3: fixed-point
#: depth grows with taxonomy depth, far sublinearly with size (64k's 20
#: rounds -> ~25 at 128k; the killed run had burned ~21 without
#: converging).
DEFAULT_ROUNDS_EXP = 0.3
DEFAULT_SPR_EXP = 2.0
#: compile-wall ~ n^0.7: BENCH_r03's 64k cold-minus-warm gap puts the
#: compile near 60 s where compile300k_512_cold_r5.log measured
#: 148-209 s at 300k — a ~3x wall over a ~4.7x size step
DEFAULT_COMPILE_EXP = 0.7


def geometric_tail_remaining(
    deltas: Sequence[int], decay_ceiling: float = 0.98
) -> Optional[int]:
    """Remaining-rounds estimate from the derivation-curve tail: EL+
    saturation frontiers drain roughly geometrically, so the median
    decay ratio of recent per-round derivation deltas predicts how
    many more rounds until the frontier empties.  None while the curve
    is too short or not draining (ratio >= ``decay_ceiling``) —
    extrapolating a growing curve would lie.  Shared by
    :class:`OnlineEta` (the in-flight ETA) and the rowpacked engine's
    K-adaptive fused terminal window."""
    ds = [d for d in deltas if d > 0]
    if len(ds) < 3:
        return None
    ratios = [b / a for a, b in zip(ds, ds[1:])]
    r = statistics.median(ratios)
    if r >= decay_ceiling:
        return None
    remaining = math.ceil(math.log(max(ds[-1], 2.0)) / -math.log(r))
    return max(1, min(remaining, 100_000))


@dataclass
class ProbeObs:
    """One normalized historical observation.

    ``kind``: ``"exec"`` (an observed fixed-point execution — the only
    kind the model fits), ``"compile"`` (an AOT compile-only probe), or
    ``"partitioned"`` (the r04 component-partitioned batch execution —
    parsed for completeness, excluded from the superstep fit because
    its rounds are per-component, not whole-corpus supersteps)."""

    n: int
    kind: str
    source: str
    #: rounds PAIRED with ``wall_s`` (a resumed session's tail) — the
    #: seconds-per-round fit's consistent pairing
    rounds: Optional[int] = None
    wall_s: Optional[float] = None
    #: cumulative rounds of the whole logical run/chain when known —
    #: the rounds-vs-size fit must see run TOTALS, or resumed tails
    #: would systematically under-predict round counts (and walls)
    rounds_total: Optional[int] = None
    compile_s: Optional[float] = None
    #: mesh shape of the run (1 = single device).  A dimension of the
    #: seconds-per-round signal, NOT a free covariate: sharded rounds
    #: cost differently per shard (on a real mesh, less; on a 1-core
    #: virtual mesh, more), so a fit must never silently pool 1-shard
    #: and N-shard points — see :func:`fit_cost_model`'s ``shards``.
    shards: int = 1

    @property
    def s_per_round(self) -> Optional[float]:
        """Wall per round, NET of any recorded compile seconds: a cold
        process's session wall includes the trace+compile roster, and
        pooling that into s/round systematically over-prices every
        warm (or artifact-farmed) launch.  When the recorded compile
        is nonsensically >= the wall, the raw pairing stands — bad
        splits must not zero the signal."""
        if self.rounds and self.wall_s:
            w = self.wall_s - (self.compile_s or 0.0)
            if w <= 0:
                w = self.wall_s
            return w / self.rounds
        return None

    @property
    def run_rounds(self) -> Optional[int]:
        return self.rounds_total if self.rounds_total else self.rounds


def _obs_from_probe_doc(doc: dict, source: str) -> List[ProbeObs]:
    """Normalize one historical probe line (any vintage) into
    observations; unrecognized shapes yield nothing rather than an
    error — this reader must keep accepting every line ever appended
    to the tracked probe files."""
    out: List[ProbeObs] = []
    if not isinstance(doc, dict):
        return out
    # the mesh dimension: modern records carry n_shards explicitly;
    # historical scale_probe lines recorded their virtual mesh size as
    # `devices` (0/absent = single device)
    shards = int(doc.get("n_shards") or doc.get("devices") or 1)
    # r04 component-partitioned record: nested exec block, classes_total
    ex = doc.get("exec")
    if isinstance(ex, dict) and "wall_s" in ex:
        n = doc.get("classes_total") or doc.get("n_classes")
        if n:
            out.append(
                ProbeObs(
                    n=int(n),
                    kind="partitioned",
                    source=source,
                    rounds=int(ex.get("iterations") or 0) or None,
                    wall_s=float(ex["wall_s"]),
                    shards=shards,
                )
            )
        return out
    n = doc.get("n_classes")
    if not n:
        return out
    n = int(n)
    # flat exec record: `iterations`/`exec_wall_s` are the POST-RESUME
    # tail on resumed runs (a consistent rounds/wall pairing either
    # way, which is exactly what a seconds-per-round fit wants)
    if doc.get("exec_wall_s") is not None and doc.get("iterations"):
        out.append(
            ProbeObs(
                n=n,
                kind="exec",
                source=source,
                rounds=int(doc["iterations"]),
                wall_s=float(doc["exec_wall_s"]),
                # resumed records carry the chain's cumulative count
                rounds_total=int(doc.get("iterations_total") or 0) or None,
                # a record that split its compile out lets s_per_round
                # price execution alone (and seeds the compile fit)
                compile_s=float(
                    doc.get("compile_s") or doc.get("step_compile_s") or 0
                ) or None,
                shards=shards,
            )
        )
    elif doc.get("step_compile_s") is not None:
        out.append(
            ProbeObs(
                n=n,
                kind="compile",
                source=source,
                compile_s=float(doc["step_compile_s"]),
                shards=shards,
            )
        )
    return out


def load_probe_lines(path: str) -> List[ProbeObs]:
    """Parse one ``SCALE_r0N_probes.jsonl``-style file.  Tolerant by
    contract: unknown line shapes are skipped (the files accumulated
    across probe-script generations), a torn final line is a crash
    artifact, never an error."""
    out: List[ProbeObs] = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.extend(
                _obs_from_probe_doc(doc, f"{os.path.basename(path)}:{lineno}")
            )
    return out


def load_ledger_observations(path: str) -> List[ProbeObs]:
    """Exec observations from a run-ledger file: ONE per chain, not
    per session — a resumed chain's sessions are tails of one logical
    run, and feeding tail round counts into the rounds-vs-size fit
    would systematically under-predict (the SCALE_r05 failure mode).
    ``rounds``/``wall_s`` pair the chain's recorded rounds with the
    summed session walls (the seconds-per-round signal);
    ``rounds_total`` is the last cumulative round index (the
    rounds-fit signal).  Crashed sessions contribute their last round's
    elapsed — partial progress is still calibration signal."""
    from distel_tpu_torch.obs import ledger as _ledger

    out: List[ProbeObs] = []
    records = _ledger.read_ledger(path, strict=False)
    for chain_id, recs in _ledger.chains(records).items():
        opens = [r for r in recs if r.get("ev") == "open"]
        if not opens:
            continue
        meta = opens[0].get("meta") or {}
        n = meta.get("n_classes")
        if not n:
            continue
        shards = int(meta.get("n_shards") or meta.get("devices") or 1)
        rounds_ = [r for r in recs if r.get("ev") == "round"]
        if not rounds_:
            continue
        closes = {
            r.get("run_id"): r for r in recs if r.get("ev") == "close"
        }
        wall = 0.0
        compile_s = 0.0
        for op in opens:
            rid = op.get("run_id")
            close = closes.get(rid)
            if close is not None and close.get("wall_s"):
                wall += float(close["wall_s"])
                # sessions that split their compile wall out (cold
                # starts) let s_per_round price execution alone
                compile_s += float(close.get("compile_s") or 0.0)
            else:
                tail = [r for r in rounds_ if r.get("run_id") == rid]
                if tail and tail[-1].get("elapsed_s"):
                    wall += float(tail[-1]["elapsed_s"])
        if wall <= 0:
            continue
        out.append(
            ProbeObs(
                n=int(n),
                kind="exec",
                source=f"{os.path.basename(path)}#{chain_id}",
                # a fused-window record covers rounds_in_window retired
                # rounds (ISSUE 17) — count rounds, not records, or the
                # s/round signal inflates K×
                rounds=sum(
                    int(r.get("rounds_in_window") or 1) for r in rounds_
                ),
                wall_s=wall,
                # max, not last-in-file: a crashed tail can outrank the
                # resumed session's newest record
                rounds_total=max(
                    int(r.get("round") or 0) for r in rounds_
                ) or None,
                compile_s=compile_s or None,
                shards=shards,
            )
        )
    return out


def _is_ledger_file(path: str) -> bool:
    """Sniff: ledger records carry an ``ev`` field on line 1."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            first = f.readline().strip()
        return bool(first) and "ev" in json.loads(first)
    except (OSError, json.JSONDecodeError):
        return False


def gather_observations(paths: Sequence[str]) -> List[ProbeObs]:
    out: List[ProbeObs] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        if _is_ledger_file(p):
            out.extend(load_ledger_observations(p))
        else:
            out.extend(load_probe_lines(p))
    return out


def default_basis_paths(root: str = ".") -> List[str]:
    """The calibration basis a launch guard fits from when none is
    given: every ledger under ``runs/`` — the port's own observed runs
    (``DISTEL_COSTMODEL_BASIS`` overrides, colon-separated).  The
    port's adaptation: the reference also reads its tracked
    ``SCALE_r04/r05_probes.jsonl``, which are the JAX package's runs,
    not the card's.  With no ledger the basis is empty and
    :func:`guard_launch` allows the launch and says so."""
    env = os.environ.get("DISTEL_COSTMODEL_BASIS")
    if env:
        return [p for p in env.split(":") if p]
    paths = sorted(glob.glob(os.path.join(root, "runs", "*.ledger.jsonl")))
    return [p for p in paths if os.path.exists(p)]


def _fit_power(
    pts: Sequence[Tuple[float, float]], default_exp: float
) -> Tuple[float, float]:
    """Least-squares power-law fit ``y = coef * x**exp`` in log space;
    with a single distinct x the curve is anchored through the median
    point at ``default_exp``."""
    pts = [(x, y) for x, y in pts if x > 0 and y > 0]
    xs = sorted({x for x, _ in pts})
    if len(xs) >= 2:
        lx = [math.log(x) for x, _ in pts]
        ly = [math.log(y) for _, y in pts]
        mx, my = statistics.fmean(lx), statistics.fmean(ly)
        den = sum((a - mx) ** 2 for a in lx)
        exp = sum((a - mx) * (b - my) for a, b in zip(lx, ly)) / den
        coef = math.exp(my - exp * mx)
        return coef, exp
    x, y = sorted(pts)[len(pts) // 2]
    return y / (x**default_exp), default_exp


@dataclass
class CostModel:
    """Fitted rounds-vs-size and seconds-per-round-vs-size curves
    (power laws; ``basis`` records every observation that shaped them,
    so a refused launch can print WHY it was refused)."""

    rounds_coef: float
    rounds_exp: float
    spr_coef: float
    spr_exp: float
    #: fitted compile-wall curve, a SEPARATE term from s/round: a cold
    #: process pays it once before round 1, a warm process (in-registry
    #: programs, or an AOT artifact farm covering the roster) pays
    #: zero.  None when the basis holds no compile observation — the
    #: prediction then prices execution only, as before.
    compile_coef: Optional[float] = None
    compile_exp: Optional[float] = None
    basis: List[dict] = field(default_factory=list)
    #: the mesh shape this model was fitted FOR: the shard count whose
    #: observations exclusively shaped the fit, or None when the basis
    #: pooled mixed shard counts (either no ``shards`` was requested,
    #: or nothing matched and the fit fell back — ``mixed_shards``
    #: marks the fallback so a launch record shows the prediction is
    #: cross-mesh extrapolation, not same-shape calibration)
    shards: Optional[int] = None
    mixed_shards: bool = False

    def predict_rounds(self, n: int) -> float:
        return max(1.0, self.rounds_coef * float(n) ** self.rounds_exp)

    def predict_seconds_per_round(self, n: int) -> float:
        return self.spr_coef * float(n) ** self.spr_exp

    def predict_wall_s(self, n: int) -> float:
        """Execution wall (rounds x s/round) — compile is priced by
        :meth:`predict_compile_s` and added by the launch guard, which
        knows whether the process will actually pay it."""
        return self.predict_rounds(n) * self.predict_seconds_per_round(n)

    def predict_compile_s(self, n: int) -> float:
        """The cold-process trace+compile wall (0.0 with no compile
        observations in the basis)."""
        if self.compile_coef is None or self.compile_exp is None:
            return 0.0
        return self.compile_coef * float(n) ** self.compile_exp

    def describe(self, n: int) -> dict:
        return {
            "n_classes": int(n),
            "predicted_rounds": round(self.predict_rounds(n), 1),
            "predicted_s_per_round": round(
                self.predict_seconds_per_round(n), 2
            ),
            "predicted_wall_s": round(self.predict_wall_s(n), 1),
            "predicted_compile_s": round(self.predict_compile_s(n), 1),
            "rounds_fit": [round(self.rounds_coef, 6), round(self.rounds_exp, 4)],
            "spr_fit": [round(self.spr_coef, 10), round(self.spr_exp, 4)],
            "shards": self.shards,
            "mixed_shards": self.mixed_shards,
            "basis": self.basis,
        }

    def as_dict(self) -> dict:
        return {
            "rounds_coef": self.rounds_coef,
            "rounds_exp": self.rounds_exp,
            "spr_coef": self.spr_coef,
            "spr_exp": self.spr_exp,
            "compile_coef": self.compile_coef,
            "compile_exp": self.compile_exp,
            "shards": self.shards,
            "mixed_shards": self.mixed_shards,
            "basis": self.basis,
        }


def fit_cost_model(
    observations: Sequence[ProbeObs], shards: Optional[int] = None
) -> Optional[CostModel]:
    """Fit from executed observations; None when the basis holds no
    executed run at all (a guard without a model must say so, not
    invent numbers).

    ``shards`` selects the mesh dimension: seconds-per-round is a
    per-mesh-shape quantity (an N-shard round and a 1-shard round of
    the same corpus are different programs on different silicon), so a
    launch prediction fits ONLY from observations of the launching
    run's shard count when any exist.  With none matching, the fit
    falls back to the full pool — explicitly marked ``mixed_shards``
    in the model and the launch record, never silently — because a
    cross-mesh extrapolated guard still beats no guard (the SCALE_r05
    failure mode was a hand-waved band, not a mis-dimensioned fit)."""
    ex = [
        o
        for o in observations
        if o.kind == "exec" and o.n and o.rounds and o.wall_s
    ]
    if not ex:
        return None
    mixed = False
    if shards is not None:
        matching = [o for o in ex if o.shards == int(shards)]
        if matching:
            ex = matching
        else:
            mixed = True
    # rounds fit: whole-run totals (a resumed tail's count would
    # under-predict); spr fit: the consistently paired tail rounds/wall
    rounds_coef, rounds_exp = _fit_power(
        [(o.n, o.run_rounds) for o in ex], DEFAULT_ROUNDS_EXP
    )
    spr_coef, spr_exp = _fit_power(
        [(o.n, o.s_per_round) for o in ex], DEFAULT_SPR_EXP
    )
    # the compile fit pools ALL observations that recorded a compile
    # wall (compile-only probes AND split exec records): compile cost
    # is a property of the program roster at a size, not of the mesh
    # selection above
    cpts = [
        (o.n, o.compile_s)
        for o in observations
        if o.n and o.compile_s
    ]
    compile_coef = compile_exp = None
    if cpts:
        compile_coef, compile_exp = _fit_power(cpts, DEFAULT_COMPILE_EXP)
    basis = [
        {
            "source": o.source,
            "n_classes": o.n,
            "rounds": o.run_rounds,
            "s_per_round": round(o.s_per_round, 2),
            "shards": o.shards,
        }
        for o in ex
    ]
    return CostModel(
        rounds_coef, rounds_exp, spr_coef, spr_exp,
        compile_coef=compile_coef, compile_exp=compile_exp,
        basis=basis,
        shards=(None if mixed or shards is None else int(shards)),
        mixed_shards=mixed,
    )


def fit_from_paths(
    paths: Sequence[str], shards: Optional[int] = None
) -> Optional[CostModel]:
    return fit_cost_model(gather_observations(paths), shards=shards)


def guard_launch(
    model: Optional[CostModel],
    n: int,
    budget_s: float,
    force: bool = False,
    warm_artifacts: bool = False,
) -> dict:
    """The launch budget decision: predict the wall from the fitted
    model and decide whether the run fits ``budget_s``.  Returns the
    full decision record (the caller prints it and refuses on
    ``allowed=False``); with no model the launch is allowed but the
    record says the prediction basis was empty.

    ``warm_artifacts``: the launching process consumes an AOT artifact
    farm (or an already-warm registry) covering its roster, so the
    compile wall is ZERO — the fitted compile term is priced out of
    the total instead of over-refusing the launch (the pre-farm bug:
    compile seconds pooled into s/round charged every warm run a cold
    compile per round)."""
    rec = {
        "budget_s": float(budget_s),
        "forced": bool(force),
        "warm_artifacts": bool(warm_artifacts),
    }
    if model is None:
        rec.update(
            allowed=True,
            fits=None,
            reason="no executed observations in the calibration basis",
        )
        return rec
    rec.update(model.describe(n))
    if warm_artifacts:
        rec["predicted_compile_s"] = 0.0
    rec["predicted_total_s"] = round(
        rec["predicted_wall_s"] + rec["predicted_compile_s"], 1
    )
    fits = rec["predicted_total_s"] <= budget_s
    rec["fits"] = fits
    rec["allowed"] = bool(fits or force)
    if not fits:
        rec["reason"] = (
            f"predicted wall {rec['predicted_total_s']:.0f}s "
            f"(exec {rec['predicted_wall_s']:.0f}s + compile "
            f"{rec['predicted_compile_s']:.0f}s) exceeds the "
            f"stage budget {budget_s:.0f}s"
            + (" (forced past the guard)" if force else "; pass --force to override")
        )
    return rec


class OnlineEta:
    """In-flight completion estimate, re-computed every observed round.

    ``eta_s = median(recent round walls) x remaining_rounds``, where
    the remaining-rounds estimate extrapolates the derivation-curve
    tail: EL+ saturation frontiers drain roughly geometrically, so the
    median decay ratio of the recent per-round derivation deltas
    predicts how many more rounds until the frontier empties.  While
    the curve is still growing (ratio >= ~1) the fitted model's
    rounds-vs-size prediction stands in; with neither, the ETA is
    honestly unknown (None, rendered as -1 in gauges)."""

    def __init__(
        self,
        model: Optional[CostModel] = None,
        n: Optional[int] = None,
        window: int = 8,
    ):
        self._model = model
        self._n = n
        self._walls: deque = deque(maxlen=window)
        self._deltas: deque = deque(maxlen=window)
        self.rounds = 0

    def _tail_remaining(self) -> Optional[int]:
        return geometric_tail_remaining(self._deltas)

    def update(
        self, round_wall_s: float, deriv_delta: int
    ) -> Tuple[Optional[float], Optional[int]]:
        """Feed one retired round; returns ``(eta_s, remaining_rounds)``
        (None, None while unknowable)."""
        self.rounds += 1
        if round_wall_s > 0:
            self._walls.append(float(round_wall_s))
        self._deltas.append(int(deriv_delta))
        remaining = self._tail_remaining()
        if remaining is None and self._model is not None and self._n:
            remaining = max(
                1, int(round(self._model.predict_rounds(self._n))) - self.rounds
            )
        if remaining is None or not self._walls:
            return None, remaining
        return statistics.median(self._walls) * remaining, remaining
