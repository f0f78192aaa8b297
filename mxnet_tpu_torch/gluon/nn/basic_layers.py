"""Dense, Embedding and RMSNorm as ``torch.nn.Module``s.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py`` (``Dense`` :94,
``Embedding`` :159, ``RMSNorm`` :303).  Parameter names and shapes are
MXNet's -- ``weight`` (Dense: (out, in)), ``bias``, ``gamma`` -- so a
model's ``state_dict()`` keys equal the JAX ``collect_params()`` keys.
Parameters are created empty on ``device``; a loader fills them.  Each
layer is a :class:`~mxnet_tpu_torch.gluon.block.Block`.
``device=None`` means CUDA and raises without a card
(:func:`~mxnet_tpu_torch.context.resolve_device`).
"""
from __future__ import annotations

import torch
from torch import nn

from ...context import resolve_device
from ...ops import nn as F
from ..block import Block

__all__ = ["Dense", "Embedding", "RMSNorm"]


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Dense(Block):
    """``y = x @ W.T + b`` over the trailing dim (``flatten=False``).  The
    input is cast to the weight's dtype, so a bf16 layer runs a bf16
    matmul (fp32 accumulation) on float32 activations."""

    def __init__(self, units, in_units, use_bias=True, dtype="float32",
                 device=None):
        super().__init__()
        kw = {"dtype": _dtype(dtype), "device": resolve_device(device)}
        self.weight = nn.Parameter(torch.empty(units, in_units, **kw))
        self.bias = nn.Parameter(torch.empty(units, **kw)) if use_bias \
            else None

    def forward(self, x):
        return F.dense(x.to(self.weight.dtype), self.weight, self.bias)


class Embedding(Block):
    def __init__(self, input_dim, output_dim, dtype="float32", device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            input_dim, output_dim, dtype=_dtype(dtype),
            device=resolve_device(device)))

    def forward(self, x):
        return F.embedding(x, self.weight)


class RMSNorm(Block):
    """RMS normalization over the last axis.  ``gamma`` is float32 in
    every model, as in the JAX layer, so the output of a norm is float32
    whatever the input's dtype."""

    def __init__(self, in_channels, epsilon=1e-6, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(
            in_channels, dtype=torch.float32, device=resolve_device(device)))

    def forward(self, x):
        return F.rms_norm(x, self.gamma, eps=self._epsilon)
