"""Artifact farm: the card's kernel libraries and the bucket programs'
specs, baked once (``cli farm-build``) and installed by every fresh
process (``--artifacts-dir`` / ``artifacts.dir``).

The port of ``distel_tpu/core/artifacts.py``.  A fresh process (a
respawned fleet replica, an autoscaled worker) pays two costs before
its first answer: the ``nvcc`` build of the kernel libraries
(``ops/build.py``; it also needs a CUDA toolkit on the host) and the
build of every program its tenants ask for.  The reference serializes
its compiled XLA executables; a CUDA graph cannot be written to disk
(it holds the addresses of the buffers it was captured on).  But a
bucketed step program is a pure function of its structure: it reads its
tables only for their shapes when it is built, and it is captured on
zero tables (``core/bucketing.py``).  So the farm ships what rebuilds
it, and the consumer rebuilds and captures it at install, before
traffic and with no corpus.  Per entry, recorded in the manifest:

* ``"exe"`` — a step program's spec (``bucketing.program_spec``: its
  ``BucketStruct`` and each table's name, shape and dtype), for every
  ``(bucket_signature, "step")`` key the bake built: the base step, the
  serve rebuild's engine, the delta plane's programs; and a cohort
  program's (``core/cohort.py``, every ``(bucket_signature,
  "cohort_run", budget, rung)`` key the bake's ``cohort.warm.sizes``
  built) as the solo program's spec plus ``{"cohort": {"rung",
  "budget"}}``.  :func:`install`
  builds each one on the device (on a card, captures it, under
  ``bucketing.CAPTURE_LOCK``) and holds it; the first engine that asks
  the ``PROGRAMS`` registry for the key is handed it, so no build runs
  in the request: ``CompileStats.compile_s == 0.0``, counted as an
  ``exe_hit``.  The store then drops its own reference: a program that
  was handed over and later evicted is a ``miss`` and builds from its
  engine's tables, because :meth:`ArtifactStore.load` never builds (a
  build there would go unreported).  The capture is paid at install and
  reported there (``install_s``, each program's ``capture_s`` and
  ``bytes``).
* ``"hlo-cache"`` — a key recorded with no file: a fused window is
  keyed by its engine's table content (its body is that engine's plan,
  which is not rung-canonical), so no spec can rebuild it.  A lookup
  counts an ``hlo_hit`` and the engine builds the window from its own
  tables, as the reference's consumer still traces that tier.
* kernel libraries — each ``csrc/*.cu`` library under the name
  ``ops/build.lib_name`` computes from its source and flags, with its
  ``ptxas`` report.  :func:`install` copies each verified library into
  the build directory before any kernel loads, so ``ops/build.load``
  finds it (a persistent-cache hit) and the process runs no ``nvcc``.
  A CPU bake ships none.

Keying: an artifact id is a sha256 over ``repr`` of the ``PROGRAMS``
key, as in the reference; the environment half is the card's
(:func:`runtime_env`: backend, torch and CUDA runtime versions, device
name, capability, device count), and a bake that shipped libraries
records its ``nvcc`` release.  The manifest is checksummed whole and
per file.  A missing, corrupt or foreign manifest, a library or spec
whose checksum or name fails, or a spec whose signature does not
recompute its key, warns once, counts a rejection and leaves the
process building as if the farm (or that entry) did not exist; under
``require`` it raises :class:`ArtifactError`.  Nothing falls back to
the plain versions on a card: without a usable library and without
``nvcc``, ``ops/build`` raises as it always did.  Libraries are loaded
with ``ctypes``: point a process only at farms you baked.

The programs the store holds are card memory:
``bucketing.program_bytes`` counts them and
``bucketing.drop_idle_programs`` drops them, so a serve registry's
budget bounds the process.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1

#: the environment half of every key (:func:`runtime_env`)
ENV_FIELDS = ("backend", "torch_version", "cuda_runtime", "device_name",
              "capability", "n_devices")

#: manifest fields covered by the whole-manifest digest, in canonical
#: order (everything except the digest itself)
_DIGEST_FIELDS = ("format", *ENV_FIELDS, "nvcc", "artifacts", "kernels")

#: why a fused window is recorded at the ``"hlo-cache"`` tier
FUSED_REASON = ("a fused window is keyed by its engine's table content "
                "(not rung-canonical): no spec rebuilds it; it builds from "
                "the engine's tables")


class ArtifactError(RuntimeError):
    """A farm directory that cannot be trusted: unreadable/corrupt
    manifest, checksum mismatch, or an environment mismatch under
    ``require=True``."""


class ArtifactAggregate:
    """Process-global artifact-event tallies (thread-safe), one per
    process like the aggregates in ``runtime/instrumentation.py``.  The
    serve plane renders them as the ``distel_artifact_*`` counter
    families; the smoke and the tests assert on these — counted hits,
    never wall-clock inference.  ``serialized`` counts specs and
    libraries written, ``unserializable`` keys recorded at the
    ``"hlo-cache"`` tier."""

    _FIELDS = (
        "exe_hits", "hlo_hits", "misses", "rejected", "serialized",
        "unserializable",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)

    def record(self, field: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


#: the process-global tally (one per process, like PROGRAMS)
ARTIFACT_EVENTS = ArtifactAggregate()


def _device(device):
    from distel_tpu_torch.runtime.classifier import resolve_device

    return resolve_device(device)


def runtime_env(device=None) -> Dict[str, object]:
    """The environment half of the artifact key, for ``device`` (None =
    the first card): a captured program and a kernel library are valid
    only on the backend, torch and CUDA runtime, card model and device
    count they were baked with."""
    import torch

    dev = _device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(index)
        name, cap = torch.cuda.get_device_name(index), f"{major}.{minor}"
        n = torch.cuda.device_count()
    else:
        name, cap, n = dev.type, None, 1
    return {
        "backend": dev.type,
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "device_name": name,
        "capability": cap,
        "n_devices": n,
    }


def artifact_id(key: Tuple) -> str:
    """Stable id from the PROGRAMS registry key.  ``repr`` of the key
    tuple is deterministic here: keys are built from str/int/tuple
    structural metadata only (the same property ``signature_of``
    already leans on)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


def describe_key(key: Tuple) -> Dict[str, object]:
    """Human-greppable manifest fields best-effort extracted from a
    registry key ``(bucket_signature, program_kind, extras...)`` —
    reporting only; the id hashes the full key."""
    desc: Dict[str, object] = {"key": repr(key)}
    if isinstance(key, tuple) and key:
        if isinstance(key[0], str):
            desc["bucket_signature"] = key[0]
        if len(key) > 1 and isinstance(key[1], str):
            desc["kind"] = key[1]
            if key[1] == "fused" and len(key) > 2 and isinstance(
                key[2], tuple
            ) and key[2]:
                desc["fused_k"] = int(key[2][0])
            if key[1] == "fused" and len(key) > 2 and isinstance(key[2], int):
                desc["fused_k"] = key[2]
            if key[1] == "sparse" and len(key) > 2 and isinstance(
                key[2], tuple
            ):
                desc["rung"] = list(map(int, key[2]))
            if key[1] == "cohort_run" and len(key) > 3:
                desc["rung"] = int(key[3])
    return desc


def _sha256_bytes(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_digest(doc: dict) -> str:
    body = json.dumps(
        {f: doc.get(f) for f in _DIGEST_FIELDS}, sort_keys=True
    )
    return _sha256_bytes(body.encode())


def _copy(src: str, dst: str) -> None:
    """``src`` to ``dst`` through a temporary file (a reader never sees
    a torn library)."""
    tmp = f"{dst}.tmp.{os.getpid()}"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


class ArtifactStore:
    """One farm directory: ``manifest.json`` + ``exe/<id>.json`` (the
    program specs) + ``kernels/`` (the kernel libraries).

    Read side (a consuming process): :meth:`install_libraries` and
    :meth:`build_programs` at install, then :meth:`load` under the
    PROGRAMS per-key build lock.  Write side (``cli farm-build``):
    :meth:`save` as the registry's post-build sink,
    :meth:`adopt_libraries` and :meth:`flush` at the end of the bake.
    Thread-safe: warmup builds the roster on a thread pool."""

    def __init__(self, root: str, writable: bool = False, device=None):
        self.root = os.path.abspath(root)
        self.writable = bool(writable)
        self._lock = threading.Lock()
        self.written = 0  # specs and libraries newly written by THIS process
        self._warned: set = set()
        #: artifact id -> the program built from its spec, until handed over
        self._held: Dict[str, object] = {}
        #: ids whose spec failed its checks (counted once, at install)
        self._rejected: set = set()
        mpath = os.path.join(self.root, MANIFEST_NAME)
        if os.path.exists(mpath):
            try:
                with open(mpath, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise ArtifactError(
                    f"unreadable artifact manifest {mpath}: {e}"
                )
            if not isinstance(doc, dict) or doc.get("format") != FORMAT_VERSION:
                raise ArtifactError(
                    f"artifact manifest format "
                    f"{doc.get('format') if isinstance(doc, dict) else doc!r} "
                    f"!= supported {FORMAT_VERSION}"
                )
            if _manifest_digest(doc) != doc.get("checksum"):
                raise ArtifactError(
                    f"artifact manifest checksum mismatch in {mpath} "
                    "(tampered or torn write)"
                )
            self._doc = doc
            self._dirty = False
        elif writable:
            for sub in ("exe", "kernels"):
                os.makedirs(os.path.join(self.root, sub), exist_ok=True)
            self._doc = {
                "format": FORMAT_VERSION,
                **runtime_env(device),
                "nvcc": None,
                "artifacts": {},
                "kernels": {},
            }
            self._dirty = True
        else:
            raise ArtifactError(
                f"no artifact manifest at {mpath} (run `cli farm-build` "
                "first, or fix --artifacts-dir)"
            )

    # ------------------------------------------------------------ env

    def env_mismatch(self, device=None) -> Optional[str]:
        """None when a process on ``device`` can consume the store; else
        the human reason it must not (the caller warns and builds as if
        no farm existed)."""
        env = runtime_env(device)
        for k, v in env.items():
            if self._doc.get(k) != v:
                return (
                    f"artifact manifest {k}={self._doc.get(k)!r} != "
                    f"this process's {v!r}"
                )
        return None

    def _reject(self, token: str, msg: str, require: bool) -> None:
        """Count a rejection; raise under ``require``, else warn once."""
        ARTIFACT_EVENTS.record("rejected")
        if require:
            raise ArtifactError(msg)
        with self._lock:
            if token in self._warned:
                return
            self._warned.add(token)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    # ---------------------------------------------------------- read

    def covers(self, key: Tuple) -> Optional[str]:
        """The manifest tier for a registry key (``"exe"`` /
        ``"hlo-cache"``) or None."""
        ent = self._doc["artifacts"].get(artifact_id(key))
        return ent["tier"] if ent else None

    def load(self, key: Tuple):
        """The program built at install for ``key``, handed over once
        (an ``exe_hit``); None on a miss — a key the manifest does not
        cover, or whose program was handed over before — and for an
        ``"hlo-cache"`` entry (an ``hlo_hit``: the engine builds it from
        its own tables) or a spec rejected at install (counted there).
        Never builds."""
        aid = artifact_id(key)
        ent = self._doc["artifacts"].get(aid)
        if ent is None:
            ARTIFACT_EVENTS.record("misses")
            return None
        if ent["tier"] == "hlo-cache":
            ARTIFACT_EVENTS.record("hlo_hits")
            return None
        with self._lock:
            prog = self._held.pop(aid, None)
            rejected = aid in self._rejected
        if prog is None:
            if not rejected:
                ARTIFACT_EVENTS.record("misses")
            return None
        ARTIFACT_EVENTS.record("exe_hits")
        return prog

    def held_programs(self) -> list:
        """The programs built at install and not handed over yet."""
        with self._lock:
            return list(self._held.values())

    def drop_held(self, kind: str) -> int:
        """Drop the held programs on devices of type ``kind`` (a memory
        budget's first resort); a later request for one of their keys is
        a miss and builds.  Returns how many went."""
        with self._lock:
            gone = [a for a, p in self._held.items()
                    if p.pair.sp.device.type == kind]
            for a in gone:
                del self._held[a]
        return len(gone)

    def install_libraries(self, require: bool = False) -> List[str]:
        """Copy each verified kernel library (and its ``ptxas`` report)
        into the build directory under the name this checkout's source
        gives it, before any kernel loads; returns the names installed.
        A library whose checksum fails, or that was built from another
        source, is rejected."""
        from distel_tpu_torch.ops import build

        dest = build.build_dir()
        names = []
        for name, ent in sorted(self._doc.get("kernels", {}).items()):
            try:
                if name not in build.sources():
                    raise ArtifactError(
                        f"this checkout has no kernel source csrc/{name}.cu"
                    )
                want = build.lib_name(name)
                if os.path.basename(ent["file"]) != want:
                    raise ArtifactError(
                        f"built from another csrc/{name}.cu (this "
                        f"checkout's library is {want})"
                    )
                src = os.path.join(self.root, ent["file"])
                if _sha256_file(src) != ent["sha256"]:
                    raise ArtifactError("sha256 mismatch")
                dst = os.path.join(dest, want)
                if not os.path.exists(dst):
                    if ent.get("ptxas"):
                        _copy(os.path.join(self.root, ent["ptxas"]),
                              dst + ".ptxas.txt")
                    _copy(src, dst)
            except (OSError, KeyError, ArtifactError) as e:
                self._reject(
                    ent.get("file", name),
                    f"rejecting kernel library {ent.get('file', name)}: {e}; "
                    "it builds with nvcc at first use",
                    require,
                )
                continue
            names.append(name)
        return names

    def build_programs(self, device, require: bool = False) -> List[dict]:
        """Build (on a card, capture) the program of every ``"exe"``
        spec on ``device`` and hold it until an engine asks for its key.
        A spec whose checksum fails, or whose signature does not
        recompute the key it was filed under, is rejected.  Returns one
        record per program: signature, build and capture seconds,
        bytes."""
        from distel_tpu_torch.core.bucketing import (
            BucketProgram,
            shape_signature,
            spec_parts,
        )
        from distel_tpu_torch.core.cohort import CohortProgram

        dev = _device(device)
        recs = []
        for aid, ent in sorted(self._doc["artifacts"].items()):
            if ent["tier"] != "exe":
                continue
            with self._lock:
                if aid in self._held:
                    continue
            try:
                with open(os.path.join(self.root, ent["file"]), "rb") as f:
                    blob = f.read()
                if _sha256_bytes(blob) != ent["sha256"]:
                    raise ArtifactError("sha256 mismatch")
                spec = json.loads(blob)
                struct, shapes = spec_parts(spec)
                sig = shape_signature(struct, shapes)
                cohort = spec.get("cohort")
                key = (sig, "step") if cohort is None else (
                    sig, "cohort_run", int(cohort["budget"]),
                    int(cohort["rung"]))
                if artifact_id(key) != aid:
                    raise ArtifactError(
                        f"its signature {sig} does not recompute the key it "
                        "was filed under"
                    )
                if struct.device_type != dev.type:
                    raise ArtifactError(
                        f"a {struct.device_type} program, not {dev.type}"
                    )
            except (OSError, ValueError, KeyError, TypeError,
                    ArtifactError) as e:
                with self._lock:
                    self._rejected.add(aid)
                self._reject(
                    ent["file"],
                    f"rejecting artifact {ent['file']} for key "
                    f"{ent.get('kind', '?')}: {e}; that program builds "
                    "from its engine's tables",
                    require,
                )
                continue
            t0 = time.perf_counter()
            prog = (BucketProgram(struct, shapes, dev) if cohort is None
                    else CohortProgram(struct, shapes, key[3], dev))
            if dev.type == "cuda":
                prog.capture()
            recs.append({
                "bucket_signature": sig,
                **({} if cohort is None else {"rung": key[3]}),
                "build_s": round(time.perf_counter() - t0, 4),
                "capture_s": round(prog.capture_s, 4),
                "bytes": prog.nbytes,
            })
            with self._lock:
                self._held[aid] = prog
        return recs

    # --------------------------------------------------------- write

    def save(self, key: Tuple, prog) -> str:
        """Registry post-build sink: write ``prog``'s spec under ``key``
        (a step program), or record the key at the ``"hlo-cache"`` tier
        (a fused window).  Returns the recorded tier; idempotent — a key
        already in the manifest writes nothing."""
        if not self.writable:
            return self._doc["artifacts"].get(
                artifact_id(key), {}
            ).get("tier", "")
        from distel_tpu_torch.core.bucketing import BucketProgram, program_spec
        from distel_tpu_torch.core.cohort import CohortProgram

        aid = artifact_id(key)
        with self._lock:
            ent = self._doc["artifacts"].get(aid)
        if ent is not None:
            return ent["tier"]
        step = (type(prog) is BucketProgram and len(key) == 2
                and key[1] == "step")
        cohort = (isinstance(prog, CohortProgram) and len(key) == 4
                  and key[1] == "cohort_run")
        if not (step or cohort):
            # a fused window: the registry holds only step and cohort
            # programs and fused windows
            ARTIFACT_EVENTS.record("unserializable")
            ent = {
                **describe_key(key),
                "tier": "hlo-cache",
                "file": None,
                "reason": FUSED_REASON,
            }
            with self._lock:
                self._doc["artifacts"].setdefault(aid, ent)
                self._dirty = True
            return "hlo-cache"
        spec = program_spec(prog)
        if cohort:
            spec["cohort"] = {"rung": int(key[3]), "budget": int(key[2])}
        blob = json.dumps(spec, sort_keys=True).encode()
        rel = os.path.join("exe", f"{aid}.json")
        path = os.path.join(self.root, rel)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        ent = {
            **describe_key(key),
            "tier": "exe",
            "file": rel,
            "sha256": _sha256_bytes(blob),
            "bytes": len(blob),
            "program_bytes": prog.nbytes,
            "capture_s": round(prog.capture_s, 4),
        }
        with self._lock:
            if aid in self._doc["artifacts"]:
                return "exe"
            self._doc["artifacts"][aid] = ent
            self.written += 1
            self._dirty = True
        ARTIFACT_EVENTS.record("serialized")
        return "exe"

    def adopt_libraries(self) -> int:
        """Record (checksummed, copied into ``kernels/``) every kernel
        library the build directory holds for this checkout's sources,
        with the bake's ``nvcc`` release.  Returns the number newly
        recorded; one already recorded under its name writes nothing."""
        from distel_tpu_torch.ops import build

        new = 0
        for name in build.sources():
            path = build.lib_path(name)
            base = os.path.basename(path)
            if not os.path.exists(path):
                continue
            with self._lock:
                ent = self._doc["kernels"].get(name)
            if ent is not None and os.path.basename(ent["file"]) == base:
                continue
            rel = os.path.join("kernels", base)
            _copy(path, os.path.join(self.root, rel))
            ent = {
                "file": rel,
                "sha256": _sha256_file(path),
                "bytes": os.path.getsize(path),
                "ptxas": None,
            }
            if os.path.exists(path + ".ptxas.txt"):
                ent["ptxas"] = rel + ".ptxas.txt"
                _copy(path + ".ptxas.txt", os.path.join(self.root, ent["ptxas"]))
            with self._lock:
                self._doc["kernels"][name] = ent
                self.written += 1
                self._dirty = True
            ARTIFACT_EVENTS.record("serialized")
            new += 1
        if new:
            with self._lock:
                self._doc["nvcc"] = build.nvcc_release()
        return new

    def flush(self) -> bool:
        """Write the manifest iff something changed (the idempotence
        contract: a second farm-build over the same roster writes
        nothing).  Returns whether a write happened."""
        with self._lock:
            if not self._dirty:
                return False
            doc = dict(self._doc)
            doc["checksum"] = _manifest_digest(doc)
            path = os.path.join(self.root, MANIFEST_NAME)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
            self._doc = doc
            self._dirty = False
            return True

    def stats(self) -> dict:
        arts = self._doc["artifacts"]
        kernels = self._doc.get("kernels", {})
        return {
            "root": self.root,
            "artifacts": len(arts),
            "exe": sum(1 for a in arts.values() if a["tier"] == "exe"),
            "hlo_cache_keys": sum(
                1 for a in arts.values() if a["tier"] == "hlo-cache"
            ),
            "kernels": len(kernels),
            "bytes": sum(a.get("bytes") or 0 for a in arts.values())
            + sum(k.get("bytes") or 0 for k in kernels.values()),
            "nvcc": self._doc.get("nvcc"),
            "written": self.written,
        }


# ------------------------------------------------------------ install

_ACTIVE: Optional[ArtifactStore] = None
_ACTIVE_LOCK = threading.Lock()


def active_store() -> Optional[ArtifactStore]:
    return _ACTIVE


def install(root: str, *, require: bool = False, device=None) -> dict:
    """Install a farm directory in this process, for ``device`` (None =
    the first card): validate the manifest and the environment, copy
    the kernel libraries into the build directory (and on a card load
    each, so no ``nvcc`` runs), build every program spec on the device,
    then attach the store to the process-global PROGRAMS registry so
    the first build of each covered key is handed its program.  A
    missing or corrupt manifest or an environment mismatch warns loudly
    (raises under ``require=True``), counts a rejection and leaves the
    process building as before.  Returns the record serve prints on its
    start line."""
    global _ACTIVE
    from distel_tpu_torch.core.program_cache import PROGRAMS
    from distel_tpu_torch.ops import build

    t0 = time.perf_counter()
    dev = _device(device)
    cache0 = build.CACHE_EVENTS.snapshot()
    try:
        store = ArtifactStore(root, writable=False)
        reason = store.env_mismatch(dev)
    except ArtifactError as e:
        store, reason = None, str(e)
    if reason is not None:
        ARTIFACT_EVENTS.record("rejected")
        if require:
            raise ArtifactError(reason)
        warnings.warn(
            f"artifact farm NOT installed: {reason}; every program "
            "builds as if no farm existed",
            RuntimeWarning, stacklevel=2,
        )
        return {"installed": False, "root": root, "reason": reason}
    libraries = store.install_libraries(require=require)
    if dev.type == "cuda":
        for name in libraries:
            build.load(name)
    programs = store.build_programs(dev, require=require)
    with _ACTIVE_LOCK:
        _ACTIVE = store
        PROGRAMS.artifact_source = store
    cache1 = build.CACHE_EVENTS.snapshot()
    return {
        "installed": True,
        **store.stats(),
        "libraries": libraries,
        "persistent_cache_hits": cache1["hits"] - cache0["hits"],
        "nvcc_runs": cache1["misses"] - cache0["misses"],
        "programs_built": len(programs),
        "programs": programs,
        "install_s": round(time.perf_counter() - t0, 4),
    }


def install_from_config(config, device=None) -> Optional[dict]:
    """The entry-point hook: point the kernel build directory at
    ``config.compile_cache_dir`` and install ``config.artifacts_dir``
    when set (serve, fleet replicas, classify and warmup all funnel
    through this)."""
    from distel_tpu_torch.config import enable_compile_cache

    enable_compile_cache(getattr(config, "compile_cache_dir", None))
    root = getattr(config, "artifacts_dir", None)
    if not root:
        return None
    return install(
        root, require=bool(getattr(config, "artifacts_require", False)),
        device=device,
    )


def uninstall() -> None:
    """Detach the active store and drop the programs it holds (tests)."""
    global _ACTIVE
    from distel_tpu_torch.core.program_cache import PROGRAMS

    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            with _ACTIVE._lock:
                _ACTIVE._held.clear()
        _ACTIVE = None
        PROGRAMS.artifact_source = None
