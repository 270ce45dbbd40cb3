"""Runtime lockdep: the dynamic counterpart of the static lock-order
rule (``distel_tpu/analysis/lockorder.py``).

The static pass sees the lock graph the CODE can express; this shim
records the graph the PROGRAM actually walks.  While enabled, every
``threading.Lock`` / ``threading.RLock`` (and the RLock inside a
default ``threading.Condition``) allocated from project code is
wrapped; each *blocking* acquisition adds ordered edges from every
lock the thread already holds to the one being acquired.  Lock
identity is the **allocation site** (``file:line``), Linux-lockdep
style — all ``_Entry.lock`` instances are one class — so a single
observed ``A→B`` plus a single observed ``B→A``, on any instances, in
any two tests, on any schedule, is an inversion: two threads COULD
take them in opposite orders and deadlock, even though this run
happened not to.  That is the point: the concurrency tests then fail
on ordering bugs their schedule didn't hit.

Usage (the conftest fixture does exactly this)::

    from distel_tpu_torch.testing import lockdep
    lockdep.enable()
    try:
        ... run threaded code ...
        lockdep.check()      # raises LockOrderViolation on inversions
    finally:
        lockdep.disable()

Scope: only locks allocated from files under ``distel_tpu/`` or
``tests/`` while enabled are tracked (jax/stdlib internals stay on raw
primitives); a same-site self-edge (two sibling instances of one lock
class nested) is reported too — same-class nesting without a
hierarchy is the textbook ABBA seed.  Non-blocking ``acquire(False)``
records the hold (later acquisitions order after it) but adds no
edge itself — a try-acquire cannot block, so it cannot deadlock.

The port's copy of ``distel_tpu/testing/lockdep.py``.  What differs,
and why: ``_TRACKED_PATHS`` names ``distel_tpu_torch/`` (and
``tests/``) where the reference names ``distel_tpu/`` — under the
reference's list no lock the port allocates would be tracked.  There is
no static lock-order pass beside it in the port.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderViolation",
    "check",
    "disable",
    "enable",
    "enabled",
    "reset",
    "violations",
]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

#: path fragments whose allocations are tracked
_TRACKED_PATHS = (
    os.sep + "distel_tpu_torch" + os.sep,
    os.sep + "tests" + os.sep,
)

_state_lock = _REAL_LOCK()
_enabled = False
#: (site_a, site_b) → witness dict for the first observation
_edges: Dict[Tuple[str, str], dict] = {}
#: recorded inversions (grow-only until reset)
_violations: List[dict] = []
_tls = threading.local()


class LockOrderViolation(AssertionError):
    """Observed lock-order inversion (or same-class nesting)."""


def _held_stack() -> List[str]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _alloc_site() -> Optional[str]:
    """file:line of the first non-threading, non-lockdep frame — the
    allocation site that names this lock's class.  None = untracked."""
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        base = os.path.basename(fn)
        if base in ("lockdep.py", "threading.py"):
            continue
        if any(p in fn for p in _TRACKED_PATHS):
            rel = fn
            for p in _TRACKED_PATHS:
                i = fn.rfind(p)
                if i >= 0:
                    rel = fn[i + 1:]
                    break
            return f"{rel}:{frame.lineno}"
        return None
    return None


def _note_acquire(site: str, blocking: bool) -> None:
    held = _held_stack()
    # the held stack stays balanced even when disabled (tracked locks
    # outlive a disable()); only edge RECORDING is gated
    if blocking and _enabled:
        for h in held:
            if h == site:
                # same allocation-site class nested — only flag when
                # the instances differ; instance identity is checked
                # by the caller (re-entrant RLock is fine), so a
                # repeated site here IS two instances
                _record_edge(h, site, same_class=True)
            else:
                _record_edge(h, site, same_class=False)
    held.append(site)


def _note_release(site: str) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            return


def _record_edge(a: str, b: str, same_class: bool) -> None:
    # cheap freshness probe FIRST: the common case (an edge seen on
    # every request of a hot loop) must not pay stack formatting
    if not same_class:
        with _state_lock:
            if (a, b) in _edges:
                return
    stack = "".join(traceback.format_stack(limit=12)[:-3])
    tname = threading.current_thread().name
    with _state_lock:
        if same_class:
            _violations.append({
                "kind": "same-class-nesting",
                "a": a,
                "b": b,
                "thread": tname,
                "stack": stack,
            })
            return
        key = (a, b)
        if key in _edges:  # raced another thread between the probes
            return
        _edges[key] = {"thread": tname, "stack": stack}
        # a new edge may close a cycle through any path b ⇝ a
        path = _find_path(b, a)
        if path is not None:
            rev = _edges.get((path[0], path[1])) if len(path) > 1 else None
            _violations.append({
                "kind": "inversion",
                "a": a,
                "b": b,
                "cycle": [a] + path,
                "thread": tname,
                "stack": stack,
                "reverse_witness": (rev or {}).get("stack", ""),
            })


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """Path src → dst through the observed edge graph (caller holds
    ``_state_lock``)."""
    adj: Dict[str, Set[str]] = {}
    for (a, b) in _edges:
        adj.setdefault(a, set()).add(b)
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, trail = stack.pop()
        if node == dst:
            return trail
        for nxt in adj.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, trail + [nxt]))
    return None


class _TrackedLock:
    """Wrapper over a raw lock primitive carrying its allocation-site
    class.  Forwards ``_release_save``/``_acquire_restore``/
    ``_is_owned`` so a ``threading.Condition`` built over it (or over
    the RLock it wraps) waits correctly — with the bookkeeping popped
    during the wait and re-pushed on wakeup."""

    __slots__ = ("_inner", "_site", "_rlock")

    def __init__(self, inner, site: str, rlock: bool):
        self._inner = inner
        self._site = site
        self._rlock = rlock

    # ------------------------------------------------------ primitives

    def acquire(self, blocking: bool = True, timeout: float = -1):
        reentrant = self._rlock and self._is_owned()
        got = self._inner.acquire(blocking, timeout)
        if got and not reentrant:
            _note_acquire(self._site, blocking)
        return got

    def release(self) -> None:
        still_owned = False
        if self._rlock:
            # popping the site only on the OUTERMOST release keeps the
            # held stack balanced across recursion
            self._inner.release()
            still_owned = self._is_owned()
        else:
            self._inner.release()
        if not still_owned:
            _note_release(self._site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -------------------------------------- Condition integration

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        # plain Lock: Condition's own fallback probe
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # Condition.wait: the lock is fully released while waiting —
        # drop the bookkeeping too, or the waiter would appear to hold
        # it across someone else's critical section
        _note_release(self._site)
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, saved) -> None:
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        _note_acquire(self._site, blocking=True)

    def __repr__(self) -> str:
        return f"<lockdep {self._site} over {self._inner!r}>"


def _make_lock():
    if not _enabled:
        return _REAL_LOCK()
    site = _alloc_site()
    if site is None:
        return _REAL_LOCK()
    return _TrackedLock(_REAL_LOCK(), site, rlock=False)


def _make_rlock():
    if not _enabled:
        return _REAL_RLOCK()
    site = _alloc_site()
    if site is None:
        return _REAL_RLOCK()
    return _TrackedLock(_REAL_RLOCK(), site, rlock=True)


# ------------------------------------------------------------- control

def enable() -> None:
    """Patch ``threading.Lock``/``RLock`` so project allocations come
    back tracked.  Locks created before enable() stay raw (and
    invisible) — enable before constructing the objects under test."""
    global _enabled
    with _state_lock:
        _enabled = True
    threading.Lock = _make_lock
    threading.RLock = _make_rlock


def disable() -> None:
    """Restore the raw primitives (existing tracked locks keep working
    — they wrap real primitives — but record nothing new)."""
    global _enabled
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    with _state_lock:
        _enabled = False


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Drop recorded edges and violations (between tests)."""
    with _state_lock:
        _edges.clear()
        _violations.clear()


def violations() -> List[dict]:
    with _state_lock:
        return list(_violations)


def edges() -> List[Tuple[str, str]]:
    with _state_lock:
        return sorted(_edges)


def check() -> None:
    """Raise :class:`LockOrderViolation` if any inversion (or
    same-class nesting) was observed since the last :func:`reset` or
    :func:`check`.  Violations are CONSUMED by the raise; the edge
    graph is kept — the conftest guard checks per test while edges
    accumulate across a module, so A→B in one test and B→A in a later
    one is still an inversion."""
    with _state_lock:
        vs = list(_violations)
        _violations.clear()
    if not vs:
        return
    lines = [f"{len(vs)} lock-order violation(s) observed:"]
    for v in vs:
        if v["kind"] == "inversion":
            lines.append(
                "  inversion: " + " -> ".join(v["cycle"])
                + f" (closing edge seen on thread {v['thread']})"
            )
        else:
            lines.append(
                f"  same-class nesting: {v['a']} taken twice on "
                f"thread {v['thread']} (sibling instances of one "
                "lock class nested without a hierarchy)"
            )
        tail = [
            ln for ln in v["stack"].splitlines() if ln.strip()
        ][-4:]
        lines.extend("    " + ln.strip() for ln in tail)
    raise LockOrderViolation("\n".join(lines))
