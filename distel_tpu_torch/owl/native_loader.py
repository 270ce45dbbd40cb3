"""ctypes binding to the native C++ load plane.

OFN text → :class:`IndexedOntology` with no Python AST: parse,
normalize and index in one C++ pass.  The port of
``distel_tpu/owl/native_loader.py`` (same ``_LoadResult`` ABI, same
results); the source is ``distel_tpu_torch/native/distel_loader.cpp``, a
byte-for-byte copy of the reference's ``native/distel_loader.cpp``.

The library builds at first use (never at import) with the host C++
compiler — ``$CXX``, else ``g++``, else ``c++``; a machine with ``nvcc``
has the one ``nvcc`` uses — and the reference Makefile's flags, into
``build/torch_native/`` at the repository root (override with
``DISTEL_TORCH_BUILD_DIR``), named by a hash of the source, compiler and
flags so an edited source never loads a stale library.  The build runs
under a file lock and lands by an atomic rename, so concurrent processes
never load a half-written library.

There is no silent fallback: a failed build or load raises with the
compiler command.  Callers that want the Python load plane ask for it
(``ClassifierConfig(use_native_loader=False)``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from distel_tpu_torch.core.indexing import IndexedOntology, role_sort_links

SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "distel_loader.cpp",
)
#: the reference Makefile's flags (``native/Makefile``) plus ``-shared``
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None


class _LoadResult(ctypes.Structure):
    _fields_ = [
        ("concept_names", ctypes.c_char_p),
        ("concept_names_len", ctypes.c_int64),
        ("n_concepts", ctypes.c_int64),
        ("role_names", ctypes.c_char_p),
        ("role_names_len", ctypes.c_int64),
        ("n_roles", ctypes.c_int64),
        ("nf1", ctypes.POINTER(ctypes.c_int32)), ("k1", ctypes.c_int64),
        ("nf2", ctypes.POINTER(ctypes.c_int32)), ("k2", ctypes.c_int64),
        ("nf3", ctypes.POINTER(ctypes.c_int32)), ("k3", ctypes.c_int64),
        ("nf4", ctypes.POINTER(ctypes.c_int32)), ("k4", ctypes.c_int64),
        ("links", ctypes.POINTER(ctypes.c_int32)), ("n_links", ctypes.c_int64),
        ("chain_pairs", ctypes.POINTER(ctypes.c_int32)),
        ("n_chain_pairs", ctypes.c_int64),
        ("role_closure", ctypes.POINTER(ctypes.c_uint8)),
        ("n_roles_closure", ctypes.c_int64),
        ("removed", ctypes.c_char_p), ("removed_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def build_dir() -> str:
    d = os.environ.get("DISTEL_TORCH_BUILD_DIR")
    if d:
        d = os.path.join(d, "native")
    else:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(SOURCE)))
        d = os.path.join(repo, "build", "torch_native")
    os.makedirs(d, exist_ok=True)
    return d


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler found ($CXX, g++, c++): the native load plane "
        f"builds {SOURCE} at first use; set CXX or pass "
        "use_native_loader=False for the Python load plane"
    )


def build_command(cxx: str, out: str) -> list:
    return [cxx, *CXX_FLAGS, "-o", out, SOURCE]


def library_path(cxx: str) -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(repr((cxx, CXX_FLAGS)).encode())
    return os.path.join(build_dir(), f"libdistel_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless a matching one exists; its path."""
    cxx = compiler()
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    with open(out + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = build_command(cxx, tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(
                f"native load plane build failed: {' '.join(cmd)}: {e}"
            ) from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native load plane build failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


def _get_lib():
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(
                    f"native load plane library {path} does not load: {e} "
                    f"(built by: {' '.join(build_command(compiler(), path))})"
                ) from e
            lib.distel_load.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.distel_load.restype = ctypes.POINTER(_LoadResult)
            lib.distel_free.argtypes = [ctypes.POINTER(_LoadResult)]
            lib.distel_free.restype = None
            _lib = lib
        return _lib


def _arr(ptr, rows: int, cols: int) -> np.ndarray:
    if rows == 0:
        return np.zeros((0, cols), np.int32)
    flat = np.ctypeslib.as_array(ptr, shape=(rows * cols,))
    return flat.astype(np.int32).reshape(rows, cols)  # copy out of C memory


def _removed(r) -> dict:
    out = {}
    if r.removed_len:
        for line in r.removed[: r.removed_len].decode().splitlines():
            k, v = line.rsplit("=", 1)
            out[k] = int(v)
    return out


def _run(text: str, read):
    lib = _get_lib()
    data = text.encode("utf-8")
    res = lib.distel_load(data, len(data))
    try:
        r = res.contents
        if r.error:
            raise ValueError(f"native parse error: {r.error.decode()}")
        return read(r)
    finally:
        lib.distel_free(res)


def _indexed(r) -> IndexedOntology:
    concept_names = (
        r.concept_names[: r.concept_names_len].decode().split("\n")[:-1]
        if r.concept_names_len
        else []
    )
    role_names = (
        r.role_names[: r.role_names_len].decode().split("\n")[:-1]
        if r.role_names_len
        else []
    )
    nr = int(r.n_roles_closure)
    closure_flat = np.ctypeslib.as_array(r.role_closure, shape=(nr * nr,))
    nf1 = _arr(r.nf1, int(r.k1), 2)
    nf2 = _arr(r.nf2, int(r.k2), 3)
    nf4 = _arr(r.nf4, int(r.k4), 3)
    original = [
        i
        for i, name in enumerate(concept_names)
        if not name.startswith(("distel:gensym#", "distel:aux#", "ind:"))
    ]
    has_bottom = (
        bool((nf1[:, 1] == 0).any())
        or bool((nf2[:, 2] == 0).any())
        or bool((nf4[:, 2] == 0).any())
    )
    # the native plane interns links in encounter order; re-group them
    # by role, the order the Python Indexer interns them in
    return role_sort_links(IndexedOntology(
        n_concepts=int(r.n_concepts),
        n_roles=max(int(r.n_roles), 1),
        concept_names=concept_names,
        concept_ids={n: i for i, n in enumerate(concept_names)},
        role_names=role_names,
        role_ids={n: i for i, n in enumerate(role_names)},
        nf1=nf1,
        nf2=nf2,
        nf3=_arr(r.nf3, int(r.k3), 2),
        nf4=nf4,
        links=_arr(r.links, int(r.n_links), 2),
        chain_pairs=_arr(r.chain_pairs, int(r.n_chain_pairs), 3),
        role_closure=closure_flat.astype(bool).reshape(nr, nr).copy(),
        original_classes=np.asarray(original, np.int32),
        has_bottom_axioms=has_bottom,
        removed=_removed(r),
    ))


def load_indexed(text: str) -> IndexedOntology:
    """Parse + normalize + index in native code: the
    :class:`IndexedOntology` the JAX package's native plane gives (the
    Python plane's ids differ; its closure and taxonomy by name do
    not).  Raises ``ValueError`` on a parse error and ``RuntimeError``
    when the library cannot be built or loaded."""
    return _run(text, _indexed)


def removed_report(text: str) -> dict:
    """Out-of-profile axiom counts from the native pass."""
    return _run(text, _removed)
