"""Conditional (IF) nodes inside a PyTorch CUDA-graph capture.

:func:`capture_if` records ``body`` as the child graph of an IF node of
the graph the current stream is capturing: on replay the body runs only
when a bool on the card is true, with no host read.  The row-packed
engine's fused K-round window is built from these
(``core/rowpacked_engine.py``, ``_branch``).  The node comes from
``csrc/graph_if.cu`` (CUDA 12.3 and later: the card-side setter kernel
and the runtime calls that add the node and capture its body), built
at first use like every kernel of the port.  The body is captured on a
second stream, whose capture PyTorch's allocator does not know; its
tensors come from a ``torch.cuda.MemPool`` that the caller keeps as
long as the graph (PyTorch's own graph pool takes one capture at a
time).

A host sync inside a body fails the body's capture: :func:`capture_if`
ends it and raises.  The enclosing capture cannot be unwound cleanly
after that (ending it crashes in the CUDA runtime, instantiating it
leaves PyTorch's allocator routing that it later aborts on), so such a
failure takes the process down with it: loudly, and never with a
wrong graph.

A capture launches nothing: the setter kernel launches when a graph
holding the node is replayed, and whoever replays adds those launches
to :data:`LAUNCHES` (``add_launches``).
"""

from __future__ import annotations

import ctypes
import threading

import torch

#: setter-kernel launches since the last :func:`reset_launches`
LAUNCHES = {"graph_if_set": 0}

#: the body's capture mode (cudaStreamCaptureModeThreadLocal): a
#: synchronising call from this thread inside the body fails the capture
_THREAD_LOCAL = 1

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    with _LOCK:
        LAUNCHES["graph_if_set"] = 0


def add_launches(n: int) -> None:
    with _LOCK:
        LAUNCHES["graph_if_set"] += int(n)


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            from distel_tpu_torch.ops import build

            lib = build.load("graph_if")
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.graph_if_begin.argtypes = [vp, vp, vp, ci]
            lib.graph_if_begin.restype = ci
            lib.graph_if_end.argtypes = [vp]
            lib.graph_if_end.restype = ci
            lib.graph_if_error_string.argtypes = [ci]
            lib.graph_if_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        msg = lib.graph_if_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def capture_if(pred: torch.Tensor, body, child: torch.cuda.Stream,
               pool: "torch.cuda.MemPool") -> None:
    """Capture ``body()`` as an IF node on ``pred`` (a 0-d bool on the
    card) into the graph the current stream is capturing.  The body is
    captured on ``child``, a stream of the same card that is not
    capturing; its allocations come from ``pool``, which must live as
    long as the graph.  A host sync in the body fails the capture and
    raises."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError("the IF node's predicate must be one bool on a card")
    lib = _lib()
    parent = torch.cuda.current_stream(pred.device)
    code = lib.graph_if_begin(parent.cuda_stream, child.cuda_stream,
                              pred.data_ptr(), _THREAD_LOCAL)
    _check(lib, code, "graph_if_begin")
    try:
        with torch.cuda.stream(child), torch.cuda.use_mem_pool(pool):
            body()
    except BaseException:
        # the body's capture failed (a host sync, say): end it and raise
        lib.graph_if_end(child.cuda_stream)
        raise
    _check(lib, lib.graph_if_end(child.cuda_stream), "graph_if_end")
