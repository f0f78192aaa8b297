"""Batchify functions: per-field batching policies (counterpart of
``mxnet_tpu/gluon/data/batchify.py``: ``Stack``, ``Pad``, ``Group`` /
``Tuple``).

Called by a user, each returns an NDArray on the current context, as
the reference's do.  Inside a ``DataLoader`` -- in its worker processes,
and in its main process when it has none -- they return numpy arrays
(:func:`on_host`), which run no torch operation, and the loader makes
the one host-to-device copy of the batch."""
from __future__ import annotations

import contextlib
import threading

import numpy as _onp

__all__ = ["Stack", "Pad", "Group", "Tuple", "on_host", "host_batches"]

_STATE = threading.local()


def on_host():
    """True where batchify functions return numpy arrays: in a
    ``DataLoader`` worker, or inside :func:`host_batches`."""
    return getattr(_STATE, "host", False)


@contextlib.contextmanager
def host_batches():
    """Batchify functions return numpy arrays inside (this thread)."""
    prev = on_host()
    _STATE.host = True
    try:
        yield
    finally:
        _STATE.host = prev


def _emit(arr):
    if on_host():
        return arr
    from ... import numpy as mnp
    return mnp.array(arr)


def _asnumpy(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return _onp.asarray(x)


class Stack:
    """Stack equal-shape samples along a new batch axis."""

    def __call__(self, data):
        return _emit(_onp.stack([_asnumpy(d) for d in data]))

    def __repr__(self):
        return "Stack()"


class Pad:
    """Pad samples along ``axis`` to the longest one with ``val``; the
    other axes must match."""

    def __init__(self, axis=0, val=0, dtype=None):
        self._axis = axis
        self._val = val
        self._dtype = dtype

    def __call__(self, data):
        arrs = [_asnumpy(d) for d in data]
        ndim = arrs[0].ndim
        axis = self._axis % ndim
        max_len = max(a.shape[axis] for a in arrs)
        shape = list(arrs[0].shape)
        shape[axis] = max_len
        out = _onp.full([len(arrs)] + shape, self._val,
                        self._dtype or arrs[0].dtype)
        for i, a in enumerate(arrs):
            sl = [i] + [slice(None)] * ndim
            sl[1 + axis] = slice(0, a.shape[axis])
            out[tuple(sl)] = a
        return _emit(out)

    def __repr__(self):
        return "Pad(axis=%d, val=%s)" % (self._axis, self._val)


class Group:
    """One batchify function per field of tuple samples (the reference's
    ``Group`` / ``Tuple``)."""

    def __init__(self, *fns):
        if len(fns) == 1 and isinstance(fns[0], (list, tuple)):
            fns = tuple(fns[0])
        self._fns = fns

    def __call__(self, data):
        assert len(data[0]) == len(self._fns), \
            "sample has %d fields but Group has %d fns" \
            % (len(data[0]), len(self._fns))
        return tuple(fn([d[i] for d in data])
                     for i, fn in enumerate(self._fns))

    def __repr__(self):
        return "Group(%s)" % (", ".join(repr(f) for f in self._fns))


Tuple = Group
