"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries land
in the build directory: ``DISTEL_TORCH_BUILD_DIR`` when set, else the
config's ``compile.cache.dir`` (:func:`set_cache_dir`), else
``build/torch_kernels/`` at the repository root.  Each is named by a
hash of its source and flags (:func:`lib_path`), so an edited source
never loads a stale library, and a library another process built — an
artifact farm's (``core/artifacts.py``) — loads without ``nvcc`` once
it lies in the build directory under that name.  :data:`CACHE_EVENTS`
counts each library found built (a persistent-cache hit) and each
``nvcc`` run (a miss); :func:`_compile` is the only path that runs
``nvcc``.

Nothing here runs at import time: the CPU tests import every module, and
this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: the config's ``compile.cache.dir`` (None: the default)
_CACHE_DIR = None


class CacheEvents:
    """Process-wide tallies of library lookups (thread-safe): ``hits``
    found a library built under its name, ``misses`` ran ``nvcc``.
    ``CompileStats`` and serve's ``/metrics`` read them."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def record(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses}


CACHE_EVENTS = CacheEvents()


def set_cache_dir(path) -> None:
    """Point the build directory at ``path`` (the config's
    ``compile.cache.dir``; None restores the default).
    ``DISTEL_TORCH_BUILD_DIR`` still wins when set."""
    global _CACHE_DIR
    _CACHE_DIR = os.path.abspath(os.path.expanduser(path)) if path else None


def build_dir() -> str:
    d = os.environ.get("DISTEL_TORCH_BUILD_DIR") or _CACHE_DIR
    if not d:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))
        d = os.path.join(repo, "build", "torch_kernels")
    os.makedirs(d, exist_ok=True)
    return d


def sources() -> list:
    """The names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "distel_tpu_torch build from source at first use"
    )


def lib_name(name: str) -> str:
    """The library file name of ``csrc/<name>.cu``: a hash of its
    source and flags."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(repr((ARCH_FLAGS, NVCC_FLAGS)).encode())
    return f"lib{name}-{h.hexdigest()[:16]}.so"


def lib_path(name: str) -> str:
    return os.path.join(build_dir(), lib_name(name))


def nvcc_release() -> str:
    """The release line of ``nvcc --version``."""
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                         text=True).stdout
    return next((ln for ln in out.splitlines() if "release" in ln),
                out.strip())


def _compile(name: str) -> float:
    out = lib_path(name)
    if os.path.exists(out):
        CACHE_EVENTS.record(hit=True)
        return 0.0
    src = os.path.join(CSRC, name + ".cu")
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas=-v", "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    with open(out + ".ptxas.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    CACHE_EVENTS.record(hit=False)
    return time.perf_counter() - t0


def build_all(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source at once (one ``nvcc`` each, all
    started together); returns each build's wall seconds."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(_compile, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _compile(name)
            lib = ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
        return lib
