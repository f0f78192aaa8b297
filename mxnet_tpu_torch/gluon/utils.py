"""Gluon utilities (reference ``mxnet_tpu/gluon/utils.py:15-64``):
``split_data``, ``split_and_load`` and ``clip_global_norm``.
``download`` / ``check_sha1`` are not ported: nothing is downloaded."""
from __future__ import annotations

import warnings

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis``; the last
    takes the remainder when ``even_split`` is False."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices along "
            "axis %d." % (str(data.shape), num_slice, batch_axis))
    if num_slice == 1:
        return [data]
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        key = [slice(None)] * data.ndim
        key[batch_axis] = slice(begin, end)
        slices.append(data[tuple(key)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Slice a batch across contexts, each slice on its context."""
    if not isinstance(data, NDArray):
        data = NDArray(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the norm before clipping (a float)."""
    assert len(arrays) > 0
    ts = [a._data if isinstance(a, NDArray) else a for a in arrays]
    total = torch.sqrt(sum((t.detach().float() ** 2).sum().to(ts[0].device)
                           for t in ts))
    total_f = float(total)
    if check_isfinite and not (total_f == total_f and
                               abs(total_f) != float("inf")):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total_f + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for t in ts:
                t.copy_((t.float() * scale).to(t.dtype))
    return total_f
