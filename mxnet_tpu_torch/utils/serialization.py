"""Array files: the npz container the JAX package writes.

The port's own copy of what it needs from
``mxnet_tpu/utils/serialization.py``: ``atomic_write`` (:44), ``save``
(:66), ``savez`` (:78) and ``load`` (:103).  Arrays go to numpy; a
bfloat16 array is stored as float32 (exact) with a dtype tag in the
``__bfloat16__`` member (a JSON dict, as uint8 bytes), and a sparse
array (``row_sparse``, ``csr``) as its dense values with a ``stype`` tag
there, from which :func:`load` rebuilds the sparse view, so files cross
between the two packages both ways.
"""
from __future__ import annotations

import contextlib
import json
import os
import zipfile

import numpy as onp
import torch

from ..context import resolve_device
from ..ndarray.ndarray import NDArray

__all__ = ["atomic_write", "save", "savez", "load", "CorruptCheckpointError"]

_META = "__bfloat16__"     # the JAX package's name for the meta member


class CorruptCheckpointError(ValueError):
    """A torn or corrupt array file."""


def _to_numpy(arr):
    """(numpy array, tag): the tag holds ``"dtype": "bfloat16"`` for a
    bf16 array and ``"stype"`` for a sparse one; None when neither."""
    stype = getattr(arr, "stype", "default")
    t = arr._data if isinstance(arr, NDArray) else arr
    if not isinstance(t, torch.Tensor):
        return onp.asarray(t), None
    t = t.detach().cpu()
    tag = {}
    if t.dtype == torch.bfloat16:
        t = t.float()
        tag["dtype"] = "bfloat16"
    if stype in ("row_sparse", "csr"):
        tag["stype"] = stype
    return t.numpy(), (tag or None)


@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Crash-safe file write: the payload goes to ``<path>.tmp.<pid>``,
    is flushed and fsynced, then ``os.replace``d over the target, so a
    crash leaves either the old complete file or the new one."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def save(file, arr):
    """One array, or a list / dict of arrays (NDArrays or tensors)."""
    if isinstance(arr, (NDArray, torch.Tensor)):
        savez(file, arr)
    elif isinstance(arr, (list, tuple)):
        savez(file, *arr)
    elif isinstance(arr, dict):
        savez(file, **arr)
    else:
        raise TypeError("save expects an NDArray, a tensor, a list or a "
                        "dict")


def savez(file, *args, **kwargs):
    """Arrays as ``arr_<i>`` and by name, into one npz; a path is
    written atomically and keeps its exact name (numpy would append
    ``.npz``)."""
    data, meta = {}, {}
    named = [("arr_%d" % i, a) for i, a in enumerate(args)] + \
        list(kwargs.items())
    for k, a in named:
        data[k], tag = _to_numpy(a)
        if tag:
            meta[k] = tag
    data[_META] = onp.frombuffer(json.dumps(meta).encode(), dtype=onp.uint8)
    if isinstance(file, (str, os.PathLike)):
        with atomic_write(os.fspath(file)) as f:
            onp.savez(f, **data)
    else:
        onp.savez(file, **data)


def load(file, device=None):
    """A dict of NDArrays (a list for ``arr_<i>`` names), or one NDArray
    for a ``.npy`` file, on ``device`` (None: the current context).  A
    torn or corrupt file raises :class:`CorruptCheckpointError`."""
    dev = resolve_device(device)

    def nd(a, tag=None):
        t = torch.from_numpy(onp.array(a, copy=True))
        if tag and tag.get("dtype") == "bfloat16":
            t = t.to(torch.bfloat16)
        return NDArray(t.to(dev))
    try:
        z = onp.load(file, allow_pickle=False)
    except (zipfile.BadZipFile, EOFError, ValueError) as e:
        raise CorruptCheckpointError("corrupt or truncated array file %r: %s"
                                     % (file, e)) from e
    if isinstance(z, onp.ndarray):
        return nd(z)
    try:
        with z:
            meta = json.loads(bytes(z[_META]).decode() or "{}") \
                if _META in z.files else {}
            out = {}
            for k in z.files:
                if k == _META:
                    continue
                tag = meta.get(k) or {}
                if isinstance(tag, str):            # older files
                    tag = {"dtype": tag}
                out[k] = nd(z[k], tag)
                if tag.get("stype"):
                    from ..ndarray.sparse import _from_dense
                    out[k] = _from_dense(out[k], tag["stype"])
    except (zipfile.BadZipFile, EOFError, KeyError, ValueError, OSError) as e:
        raise CorruptCheckpointError("corrupt or truncated array file %r: %s"
                                     % (file, e)) from e
    keys = list(out)
    if keys and all(k.startswith("arr_") for k in keys):
        return [out["arr_%d" % i] for i in range(len(keys))]
    return out
