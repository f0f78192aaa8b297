"""``mx.engine`` -- execution engine knobs.

Counterpart of ``mxnet_tpu/engine.py``.  PyTorch queues CUDA work on a
stream and returns at once, which is what MXNet's threaded engine does;
``NaiveEngine`` (``set_engine_type("NaiveEngine")`` or the
``MXNET_ENGINE_TYPE`` environment variable) makes every imperative op
wait for its stream before it returns (:func:`_sync_outputs`), so a
fault on the card is reported by the op that caused it.  ``bulk`` is a
batching hint that changes nothing here; ``set_bulk_size`` returns the
previous value as MXNet's does.
"""
from __future__ import annotations

import os

import torch

__all__ = ["set_engine_type", "is_naive", "set_bulk_size", "bulk"]

_ASYNC_NAMES = ("ThreadedEngine", "ThreadedEnginePerDevice",
                "ThreadedEnginePooled")
_naive = os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"
_bulk_size = 15


def is_naive():
    """True while every op waits for its outputs (NaiveEngine)."""
    return _naive


def set_engine_type(engine_type):
    """``"NaiveEngine"`` (synchronous) or one of MXNet's threaded engine
    names (asynchronous); an unknown name raises.  Returns the previous
    mode's name."""
    global _naive
    if engine_type != "NaiveEngine" and engine_type not in _ASYNC_NAMES:
        raise ValueError("unknown engine type %r (accepted: NaiveEngine, %s)"
                         % (engine_type, ", ".join(_ASYNC_NAMES)))
    prev = "NaiveEngine" if _naive else "ThreadedEnginePerDevice"
    _naive = engine_type == "NaiveEngine"
    return prev


def _sync_outputs(tensors):
    """Wait for the streams that produce ``tensors`` (CUDA ones; CPU ops
    are done when they return)."""
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


def set_bulk_size(size):
    global _bulk_size
    prev, _bulk_size = _bulk_size, size
    return prev


class bulk:
    """``with mx.engine.bulk(size):`` -- a batching hint."""

    def __init__(self, size):
        self._size = size

    def __enter__(self):
        self._old = set_bulk_size(self._size)
        return self

    def __exit__(self, *exc):
        set_bulk_size(self._old)
