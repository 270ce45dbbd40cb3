"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes.  Libraries land
in ``build/torch_kernels/`` at the repository root (override with
``DISTEL_TORCH_BUILD_DIR``), named by a hash of their source and flags,
so an edited source never loads a stale library.

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


def build_dir() -> str:
    d = os.environ.get("DISTEL_TORCH_BUILD_DIR")
    if not d:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))
        d = os.path.join(repo, "build", "torch_kernels")
    os.makedirs(d, exist_ok=True)
    return d


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


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(repr((ARCH_FLAGS, NVCC_FLAGS)).encode())
    return os.path.join(build_dir(), f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> float:
    out = _lib_path(name)
    if os.path.exists(out):
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
    os.replace(tmp, out)
    with open(out + ".ptxas.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
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
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib
