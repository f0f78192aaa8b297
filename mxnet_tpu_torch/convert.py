"""Carry weights from the JAX package into the port.

The JAX side exports ``{name: onp.asarray(p.data()._data)}`` over
``net.collect_params()``; the port's modules use the same names
(``layer0.attention.wq.weight``, ``norm.gamma``, the MoE blocks'
``layer0.feed_forward.gate`` / ``experts_w1`` / ``experts_w2``, ...)
and shapes, so the dict loads by name; :func:`export_params` is the way
back, so weights after training compare by name.  A parameter sharded by
``parallel.shard_params`` takes its block of the global array, and
exports the global array (gathered: every rank of its mesh calls
:func:`export_params`).  Only numpy crosses over: this module imports
nothing of the JAX package.
"""
from __future__ import annotations

import numpy as onp
import torch

from .gluon.parameter import finish_deferred_init, is_deferred, \
    mark_initialized
from .parallel.sharding import (gather_global, global_shape, local_block,
                                placement)

__all__ = ["load_params", "export_params"]


def load_params(net, params):
    """Fill ``net``'s parameters from ``{name: np.ndarray}``, cast to each
    parameter's dtype and device.  Raises ``KeyError`` on a missing or
    extra name and ``ValueError`` on a shape mismatch, before anything
    is written.  A parameter still waiting for its shape (deferred
    initialization) takes the array's, on the device ``initialize``
    named, as MXNet's ``set_data`` does."""
    own = dict(net.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError("load_params: missing %s, unexpected %s"
                       % (missing, extra))
    for name, p in own.items():
        shape = tuple(onp.shape(params[name]))
        if is_deferred(p):
            continue          # its shape is checked when it is made
        if shape != global_shape(p):
            raise ValueError("load_params: %s has shape %s, the model "
                             "wants %s" % (name, shape, global_shape(p)))
    with torch.no_grad():
        for name, p in own.items():
            arr = onp.asarray(params[name])
            if arr.dtype.name == "bfloat16":   # ml_dtypes, unknown to torch
                arr = arr.astype(onp.float32)
            finish_deferred_init(p, arr.shape)
            t = torch.from_numpy(onp.array(arr, copy=True))
            sh = placement(p)
            if sh is not None:
                t = local_block(t, sh.spec, sh.mesh)
            p.copy_(t)
            mark_initialized(p)
    return net


def export_params(net):
    """``{name: np.ndarray}`` of ``net``'s parameters, the inverse of
    :func:`load_params`; bf16 weights come out as float32 (numpy has no
    bfloat16), which holds them exactly."""
    out = {}
    for name, p in net.named_parameters():
        t = p.detach()
        sh = placement(p)
        if sh is not None:
            t = gather_global(t, sh.spec, sh.mesh)
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out
