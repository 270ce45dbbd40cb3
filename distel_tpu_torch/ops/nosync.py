"""A guard against host reads of device values, for code that a card
runs inside a captured CUDA graph (``core/rowpacked_engine.py``'s fused
window), checked on the CPU, where nothing would otherwise catch them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NoHostReads(TorchDispatchMode):
    """Raises on the operations that make a card wait for the host to
    read a value back (``.item()`` and ``bool()`` of a tensor,
    ``nonzero``, boolean-mask indexing, ``unique``, ``masked_select``,
    ``repeat_interleave`` without its output size).  Code that a card
    runs inside a captured CUDA graph runs under it on the CPU, so the
    CPU tests hold that code to the capture's own rule.  :meth:`allowed`
    lifts it for what the card does not run there: the CPU's read of a
    branch's predicate, and the plain versions standing in for the
    kernels (a kernel reads its card-held arguments itself)."""

    _state = threading.local()
    _SYNCS = {
        "_local_scalar_dense", "nonzero", "nonzero_static", "masked_select",
        "_unique", "_unique2", "unique_dim", "unique_consecutive",
    }

    @classmethod
    @contextlib.contextmanager
    def allowed(cls):
        cls._state.allowed = getattr(cls._state, "allowed", 0) + 1
        try:
            yield
        finally:
            cls._state.allowed -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not getattr(self._state, "allowed", 0):
            name = func.overloadpacket.__name__
            bad = name in self._SYNCS or (
                name == "repeat_interleave"
                and kwargs.get("output_size") is None
            )
            if name in ("index", "index_put", "index_put_"):
                bad = any(
                    isinstance(i, torch.Tensor)
                    and i.dtype in (torch.bool, torch.uint8)
                    for i in (args[1] or ())
                    if i is not None
                )
            if bad:
                raise RuntimeError(
                    f"{func} reads the device back inside the fused window"
                )
        return func(*args, **kwargs)
