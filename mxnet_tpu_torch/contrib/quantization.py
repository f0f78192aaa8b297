"""Per-tensor int8 weights for ``Dense`` layers: the serving replica's
int8 path.

The port's own copy of what it needs from
``mxnet_tpu/contrib/quantization.py`` (``_minmax_scale`` :25), plus the
switch that makes a ``Dense`` compute with an int8 weight.  The weights
are quantized by ``serve.quantize_weights``; :func:`int8_weights` is a
scope inside which each named ``Dense`` reads its int8 weight instead of
its own parameter, which stays as it is, so one process can serve a net
in its own dtype and in int8 at once (the JAX warm pool swaps the
parameters per program instead, ``serve.py:985``).  The route is the
program's: ``"decode"`` runs the W8A16 kernel (``ops.int8``, int8 read
from HBM), ``"prefill"`` dequantizes the weight into a transient and
runs one plain product, as the JAX prefill program does.
"""
from __future__ import annotations

import contextlib
import threading

import torch.nn.functional as F

from ..ops.int8 import dequantize, int8_linear

__all__ = ["Int8Weight", "int8_weights", "int8_forward"]

ROUTES = ("decode", "prefill")


def _minmax_scale(arr, num_bits=8):
    """max|arr| / 127 as a Python float (1 / 127 for an all-zero array);
    ``arr`` a float32 tensor."""
    amax = float(arr.abs().max()) or 1.0
    return amax / (2 ** (num_bits - 1) - 1)


class Int8Weight:
    """One layer's int8 weight: ``q`` (N, K) int8, its per-tensor
    ``scale`` (a Python float) and the compute ``dtype`` (the weight's
    own before quantization)."""

    def __init__(self, q, scale, dtype):
        self.q = q
        self.scale = float(scale)
        self.dtype = dtype


_state = threading.local()


@contextlib.contextmanager
def int8_weights(weights, route):
    """Within the scope (on this thread), each layer of ``weights``
    (``{Dense: Int8Weight}``) computes with its int8 weight through
    ``route``: ``"decode"`` or ``"prefill"``.  An empty ``weights``
    changes nothing."""
    if route not in ROUTES:
        raise ValueError("int8 route must be one of %s, got %r"
                         % (ROUTES, route))
    prev = getattr(_state, "active", None)
    _state.active = (weights, route) if weights else None
    try:
        yield
    finally:
        _state.active = prev


def int8_forward(layer, x, bias, flatten):
    """``layer``'s product with its int8 weight inside an
    :func:`int8_weights` scope, or None when it has none.  ``x`` is cast
    to the compute dtype (never to int8)."""
    active = getattr(_state, "active", None)
    w8 = None if active is None else active[0].get(layer)
    if w8 is None:
        return None
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    x = x.to(w8.dtype)
    if active[1] == "prefill":
        y = F.linear(x, dequantize(w8.q, w8.scale, w8.dtype))
    else:
        y = int8_linear(x.reshape(-1, x.shape[-1]).contiguous(), w8.q,
                        w8.scale).reshape(*x.shape[:-1], w8.q.shape[0])
    return y if bias is None else y + bias
