"""Activation layers.

Counterparts of ``mxnet_tpu/gluon/nn/activations.py:9-82``:
``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``
(erf by default, MXNet's ``npx.gelu``; ``approximation="tanh"`` for the
tanh form), ``Swish``, ``SiLU`` and ``Mish``.
"""
from __future__ import annotations

import torch

from ... import initializer
from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish", "SiLU", "Mish"]


class Activation(HybridBlock):
    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return F.activation(x, self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, "leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """Learned negative slope ``alpha`` of shape (in_channels,),
    broadcast against the input's trailing axes as in the JAX layer."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        self.alpha = Parameter((in_channels,), "float32",
                               init=alpha_initializer
                               or initializer.Constant(0.25),
                               allow_deferred_init=True)

    def forward(self, x):
        return F.leaky_relu(x, "prelu", gamma=self.alpha)


class ELU(HybridBlock):
    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, "elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return F.leaky_relu(x, "selu")


class GELU(HybridBlock):
    def __init__(self, approximation="erf"):
        super().__init__()
        self._act = "gelu_tanh" if approximation == "tanh" else "gelu"

    def forward(self, x):
        return F.activation(x, self._act)


class Swish(HybridBlock):
    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(x * self._beta)


class SiLU(HybridBlock):
    def forward(self, x):
        return F.activation(x, "silu")


class Mish(HybridBlock):
    def forward(self, x):
        return F.activation(x, "mish")
