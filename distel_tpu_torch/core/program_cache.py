"""Shape-bucket ladder + in-process compiled-program registry.

The cold-start compile problem (BENCH_r03: 66.3 s cold vs 6.56 s warm at
64k; compile300k_512_cold_r5.log: 148-209 s at 300k, ~95% XLA pass time)
exists because every corpus used to compile a unique program: the
engine's static shapes were derived from *exact* corpus sizes, so the
persistent XLA cache almost never hit across ontologies.  Two pieces fix
that:

* :func:`bucket_dim` — quantize a size onto a small geometric ladder
  (default ×1.25 steps), so nearby corpus sizes resolve to the same
  padded static shape.  The ladder is a fixed global sequence (never
  derived from the input), which makes the quantized value — and every
  shape computed from it — a pure function of the bucket rung.

* :class:`ProgramCache` — a process-global registry of compiled XLA
  executables keyed by ``(bucket_signature, program, budget)``.  A
  bucketed engine's traced program depends ONLY on its signature (all
  ontology content rides in runtime arguments), so an executable
  compiled for one ontology is byte-for-byte the right program for any
  other ontology in the same bucket: the registry skips trace+lower+XLA
  entirely on a hit, and on a miss the XLA compile itself is usually a
  persistent-disk-cache hit (identical HLO ⇒ identical cache key).

The registry is the serving plane's warm-program store for *programs*
(the ontology registry in ``serve/registry.py`` stores warm *closures*);
``runtime/warmup.py`` populates it before traffic arrives.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Tuple

#: default geometric ladder step — coarse enough that similar corpora
#: collide into one bucket, fine enough that padding waste stays ≤ ~25%
#: on any single dimension (and far less after the engine's own 2048-row
#: pad_multiple rounding at incremental-serving scale)
DEFAULT_RATIO = 1.25

#: smallest ladder rung for corpus-sized dimensions — below this every
#: size quantizes to one bucket
_FLOOR = 32


def bucket_dim(n: int, ratio: float = DEFAULT_RATIO, floor: int = _FLOOR) -> int:
    """Smallest rung of the fixed geometric ladder that is >= ``n``.

    The ladder is ``floor * ratio**k`` rounded up to an int, for k = 0,
    1, 2, ... — a global sequence independent of ``n``, so every caller
    that lands between the same two rungs resolves to the identical
    padded size.  ``n <= 0`` maps to 0 (an absent dimension is its own
    bucket).  ``floor`` picks the ladder family: 32 for corpus-sized
    axes (rows, links, table rows), 1 for small structural counts
    (window slots, frontier layers) where a 32-slot floor would
    multiply real per-step work."""
    if not ratio > 1.0:
        # a config typo (bucket.ratio <= 1) would otherwise divide by
        # log(1) or spin the rung walk forever INSIDE a serve worker's
        # engine build — fail loudly at the first quantize instead
        raise ValueError(f"bucket ratio must be > 1, got {ratio}")
    if n <= 0:
        return 0
    if n <= floor:
        return floor
    # k from the closed form, then walk to correct float rounding
    k = max(int(math.floor(math.log(n / floor, ratio))) - 1, 0)
    rung = int(math.ceil(floor * ratio**k))
    while rung < n:
        k += 1
        rung = int(math.ceil(floor * ratio**k))
    return rung


class ProgramCache:
    """Process-global map ``key -> compiled executable`` with hit/miss
    counters.  Keys are ``(bucket_signature, program_name, extra...)``
    tuples; values are the objects returned by
    ``jax.jit(...).lower(...).compile()`` (callable, donation
    semantics preserved from the jit they were lowered from).

    Thread-safe; a concurrent miss on the same key compiles once (the
    per-key lock serializes builders) so parallel warmup threads never
    duplicate an XLA compile.

    Bounded: at most ``capacity`` executables stay resident, evicted
    LRU — a resident server facing a long tail of distinct buckets
    must not grow memory monotonically (the evicted program's next use
    recompiles, normally a cheap persistent-disk-cache deserialization;
    an engine that already holds the executable in its own
    ``_aot_runs`` keeps running it regardless).  ``capacity`` defaults
    to 32 (``DISTEL_PROGRAM_CACHE_CAPACITY`` overrides)."""

    def __init__(self, capacity: Optional[int] = None):
        import os

        if capacity is None:
            capacity = int(
                os.environ.get("DISTEL_PROGRAM_CACHE_CAPACITY", "32")
            )
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        #: insertion/recency-ordered (dict preserves order; hits
        #: re-append) — front = LRU victim
        self._programs: Dict[Tuple, object] = {}
        self._key_locks: Dict[Tuple, threading.Lock] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        #: AOT artifact farm hooks (``core/artifacts.py``): ``source``
        #: is consulted on every registry miss BEFORE ``build`` runs (a
        #: deserialized artifact counts as a hit — no trace/compile
        #: happened); ``sink`` captures every freshly built executable
        #: (``cli farm-build``).  Both survive :meth:`clear` — the
        #: attachment is process posture, not cached state.
        self.artifact_source = None
        self.artifact_sink = None

    def _touch(self, key: Tuple, exe) -> None:
        """Re-append for LRU recency.  Caller holds ``self._lock``."""
        self._programs.pop(key, None)
        self._programs[key] = exe

    def _evict_over_capacity(self) -> None:
        """Drop LRU entries past capacity.  Caller holds
        ``self._lock``."""
        while len(self._programs) > self.capacity:
            victim = next(iter(self._programs))
            self._programs.pop(victim)
            self.evictions += 1

    def lookup(self, key: Tuple):
        with self._lock:
            exe = self._programs.get(key)
            if exe is not None:
                self.hits += 1
                self._touch(key, exe)
            return exe

    def get_or_build(self, key: Tuple, build: Callable[[], object]):
        """Return ``(executable, was_hit)``; ``build`` runs at most once
        per key across threads."""
        with self._lock:
            exe = self._programs.get(key)
            if exe is not None:
                self.hits += 1
                self._touch(key, exe)
                return exe, True
            klock = self._key_locks.setdefault(key, threading.Lock())
        with klock:
            with self._lock:
                exe = self._programs.get(key)
                if exe is not None:
                    self.hits += 1
                    self._touch(key, exe)
                    return exe, True
            src = self.artifact_source
            if src is not None:
                exe = src.load(key)
                if exe is not None:
                    # a farm artifact: no build ran, so the caller's
                    # CompileStats stay at compile_s == 0.0 — the same
                    # contract as an in-process registry hit
                    with self._lock:
                        self._programs[key] = exe
                        self.hits += 1
                        self._key_locks.pop(key, None)
                        self._evict_over_capacity()
                    return exe, True
            exe = build()
            snk = self.artifact_sink
            if snk is not None:
                try:
                    snk.save(key, exe)
                except Exception as e:
                    import warnings

                    # the farm must never break the build it captures
                    warnings.warn(
                        f"artifact capture failed for {key[:2]}: {e}",
                        RuntimeWarning,
                    )
            with self._lock:
                self._programs[key] = exe
                self.misses += 1
                self._key_locks.pop(key, None)
                self._evict_over_capacity()
            return exe, False

    def stats(self) -> dict:
        with self._lock:
            return {
                "programs": len(self._programs),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            }

    def clear(self) -> None:
        """Drop every cached executable (tests; also frees the compiled
        programs' device constants)."""
        with self._lock:
            self._programs.clear()
            self._key_locks.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0


#: THE process-global registry (one per process, like jax's own caches)
PROGRAMS = ProgramCache()


def signature_of(parts, prefix: str) -> str:
    """Stable short signature string from structural metadata: a
    human-greppable prefix (the headline shapes) + a sha1 over the full
    ``repr`` of ``parts`` (every structural determinant of the traced
    program — belt and suspenders against two engines colliding on the
    headline shapes while differing somewhere subtle)."""
    import hashlib

    digest = hashlib.sha1(repr(parts).encode()).hexdigest()[:12]
    return f"{prefix}-{digest}"
