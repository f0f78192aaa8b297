"""Basic Gluon layers as ``HybridBlock``s.

Counterparts of ``mxnet_tpu/gluon/nn/basic_layers.py``: ``Sequential``
:20, ``HybridSequential`` :58, ``Dense`` :94, ``Dropout`` :144,
``Embedding`` :159, ``Flatten`` :178, ``Identity`` :186, ``BatchNorm``
:195, ``LayerNorm`` :277, ``RMSNorm`` :303, ``GroupNorm`` :321 and
``InstanceNorm`` :344, ``SyncBatchNorm`` :264, ``Lambda`` :372,
``HybridLambda`` :384, ``Concatenate`` :405 and ``HybridConcatenate``
:418.  Parameter names and shapes are MXNet's --
``weight`` (Dense: (out, in)), ``bias``, ``gamma``, ``beta``,
``running_mean``, ``running_var`` -- so ``collect_params()`` keys equal
the JAX package's.  Parameters come from
:func:`~mxnet_tpu_torch.gluon.parameter.Parameter`: a dimension given
as 0 (``in_units=0``, ``in_channels=0``) is taken from the first input.
A layer's parameters get storage from ``initialize(device=...)`` or
``convert.load_params``.

A ``Dense`` or ``Embedding`` whose weight ``parallel.shard_params``
sharded computes with this rank's block and returns the replicated
result (``parallel.sharding.linear`` / ``embedding``).  ``BatchNorm``
inside a ``TrainStep(mesh=)`` whose batch is split over data-parallel
axes reduces its moments over the whole global batch
(``parallel.sharding.batch_moments``), as GSPMD does; so
``SyncBatchNorm`` is that ``BatchNorm`` under MXNet's name.

``Lambda`` / ``HybridLambda`` run a function on NDArrays: a name of
``mx.np`` or a callable (``HybridLambda``'s takes ``F``, the port's
``mx.nd``, first, as ``lambda F, x: F.clip(x, 0, 6)``).
``Concatenate`` / ``HybridConcatenate`` run each child on the same
input and concatenate the outputs along ``axis``.
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ...contrib.quantization import int8_forward
from ...ndarray.ndarray import NDArray
from ...ops import nn as F
from ...parallel import sharding as _sharding
from ..block import Block, HybridBlock, _unwrap
from ..parameter import Parameter, finish_deferred_init

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "Flatten", "Identity", "BatchNorm", "LayerNorm", "RMSNorm",
           "GroupNorm", "InstanceNorm", "SyncBatchNorm", "Lambda",
           "HybridLambda", "Concatenate", "HybridConcatenate"]


class _Stack:
    """Children run in order; a tuple output feeds its tail to the next
    child as extra arguments."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x, *args)
            args = ()
            if isinstance(x, (tuple, list)):
                x, args = x[0], tuple(x[1:])
        return (x,) + args if args else x

    def __getitem__(self, key):
        children = list(self._modules.values())
        if isinstance(key, slice):
            return type(self)(*children[key])
        return children[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    def __init__(self, *blocks):
        Block.__init__(self)
        self.add(*blocks)


class HybridSequential(_Stack, HybridBlock):
    def __init__(self, *blocks):
        HybridBlock.__init__(self)
        self.add(*blocks)


class Dense(HybridBlock):
    """``y = act(x W^T + b)``; ``flatten=True`` collapses every axis after
    the first.  The input is cast to the weight's dtype, so a bf16 layer
    runs a bf16 matmul (fp32 accumulation) on float32 activations.
    Inside ``contrib.quantization.int8_weights`` a layer given an int8
    weight computes with it instead, its input cast to the compute
    dtype."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter((units, in_units), dtype,
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter((units,), dtype, init=bias_initializer,
                              allow_deferred_init=True) \
            if use_bias else None

    def forward(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        finish_deferred_init(self.weight, (self._units, in_units))
        if self.bias is not None:
            finish_deferred_init(self.bias, (self._units,))
        if _sharding.placement(self.weight) is not None:
            out = _sharding.linear(x, self.weight, self.bias, self._flatten,
                                   layer=self)
            return out if self._activation is None else \
                F.activation(out, self._activation)
        out = int8_forward(self, x, self.bias, self._flatten)
        if out is None:
            out = F.fully_connected(x.to(self.weight.dtype), self.weight,
                                    self.bias, self._flatten)
        if self._activation is not None:
            out = F.activation(out, self._activation)
        return out


class Dropout(HybridBlock):
    """Inverted dropout in training mode (``autograd.record()`` /
    ``train_mode()``), the identity otherwise.  The mask comes from the
    device's default generator (``torch.manual_seed``)."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        if self._rate == 0 or not autograd.is_training():
            return x
        return F.dropout(x, self._rate, axes=self._axes)


class Embedding(HybridBlock):
    """``sparse_grad=True`` asks for a ``row_sparse`` gradient, which,
    as in the reference, is held dense: the layer computes the same."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self.weight = Parameter((input_dim, output_dim), dtype,
                                init=weight_initializer,
                                allow_deferred_init=True,
                                grad_stype="row_sparse" if sparse_grad
                                else "default")

    def forward(self, x):
        if _sharding.placement(self.weight) is not None:
            return _sharding.embedding(x, self.weight)
        return F.embedding(x, self.weight)


class Flatten(HybridBlock):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Identity(HybridBlock):
    def forward(self, x):
        return x


def _norm_params(block, in_channels, center, scale, gamma_init, beta_init):
    block.gamma = Parameter((in_channels,), "float32", init=gamma_init,
                            allow_deferred_init=True, differentiable=scale)
    block.beta = Parameter((in_channels,), "float32", init=beta_init,
                           allow_deferred_init=True, differentiable=center)


class BatchNorm(HybridBlock):
    """Batch norm over ``axis`` (-1 for channels-last).

    Training mode (``autograd.is_training()`` and not
    ``use_global_stats``) normalises with the batch statistics, reduced
    in float32, and updates the running ones in place with MXNet's
    momentum, which keeps ``momentum`` of the old value: ``running =
    momentum * running + (1 - momentum) * batch``, the variance being
    the biased batch variance (torch's ``momentum`` means the opposite
    and its running variance is the unbiased one, so the update is done
    here).  Inference uses the running statistics.  ``scale=False``
    fixes the gain at one, ``center=False`` freezes ``beta``.  The
    running statistics are parameters with ``requires_grad=False``, as
    ``collect_params()`` lists them in MXNet; the ``Trainer`` skips
    them."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        _norm_params(self, in_channels, center, scale, gamma_initializer,
                     beta_initializer)
        self.running_mean = Parameter((in_channels,), "float32",
                                      init=running_mean_initializer,
                                      allow_deferred_init=True,
                                      differentiable=False)
        self.running_var = Parameter((in_channels,), "float32",
                                     init=running_variance_initializer,
                                     allow_deferred_init=True,
                                     differentiable=False)

    def forward(self, x):
        ch = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            finish_deferred_init(p, (ch,))
        gamma = self.gamma if self._scale else None
        if autograd.is_training() and not self._use_global_stats:
            batch = _sharding.current_batch()
            if batch is not None and batch[1]:
                out, mean, var = self._global_batch(x, gamma, *batch)
            else:
                out, mean, var = F.batch_norm_train(
                    x, gamma, self.beta, self._epsilon, self._axis)
            m = self._momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
            return out
        return F.batch_norm_inference(x, gamma, self.beta, self.running_mean,
                                      self.running_var, self._epsilon,
                                      self._axis)

    def _global_batch(self, x, gamma, mesh, axes):
        """Training batch norm over the global batch of a data-parallel
        step: (out, mean, var), the moments float32."""
        mean, var = _sharding.batch_moments(x, self._axis, mesh, axes)
        shape = [1] * x.dim()
        shape[self._axis % x.dim()] = -1
        out = (x.float() - mean.view(shape)) * torch.rsqrt(
            var.view(shape) + self._epsilon)
        if gamma is not None:
            out = out * gamma.view(shape)
        out = out + self.beta.view(shape)
        return out.to(x.dtype), mean.detach(), var.detach()


class SyncBatchNorm(BatchNorm):
    """BatchNorm over the batch of every device (reference
    ``SyncBatchNorm``): inside ``TrainStep(mesh=)`` with the batch split
    over data-parallel axes its moments are the global batch's, as every
    ``BatchNorm``'s are there; elsewhere it is ``BatchNorm``.
    ``num_devices`` is accepted and changes nothing."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


class LayerNorm(HybridBlock):
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        _norm_params(self, in_channels, center, scale, gamma_initializer,
                     beta_initializer)

    def forward(self, x):
        ch = x.shape[self._axis]
        finish_deferred_init(self.gamma, (ch,))
        finish_deferred_init(self.beta, (ch,))
        return F.layer_norm(x, self.gamma, self.beta, self._axis,
                            self._epsilon)


class RMSNorm(HybridBlock):
    """RMS normalization over ``axis`` (reference ``RMSNorm(axis=-1,
    epsilon=1e-6, gamma_initializer="ones", in_channels=0)``).  ``gamma``
    is float32 in every model, as in the JAX layer, so the output of a
    norm is float32 whatever the input's dtype."""

    def __init__(self, axis=-1, epsilon=1e-6, gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter((in_channels,), "float32",
                               init=gamma_initializer,
                               allow_deferred_init=True)

    def forward(self, x):
        finish_deferred_init(self.gamma, (x.shape[self._axis],))
        return F.rms_norm(x, self.gamma, axis=self._axis, eps=self._epsilon)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        _norm_params(self, in_channels, center, scale, gamma_initializer,
                     beta_initializer)

    def forward(self, x):
        finish_deferred_init(self.gamma, (x.shape[1],))
        finish_deferred_init(self.beta, (x.shape[1],))
        return F.group_norm(x, self.gamma, self.beta, self._num_groups,
                            self._epsilon)


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        _norm_params(self, in_channels, center, scale, gamma_initializer,
                     beta_initializer)

    def forward(self, x):
        ch = x.shape[self._axis]
        finish_deferred_init(self.gamma, (ch,))
        finish_deferred_init(self.beta, (ch,))
        out = F.instance_norm(x.movedim(self._axis, 1), self.gamma,
                              self.beta, self._epsilon)
        return out.movedim(1, self._axis)


def _np_function(function):
    if isinstance(function, str):
        from ... import numpy as mnp
        return getattr(mnp, function)
    return function


def _on_ndarrays(fn, *args):
    """``fn`` on the arguments as NDArrays; its result as tensors."""
    return _unwrap(fn(*(NDArray(a) if isinstance(a, torch.Tensor) else a
                        for a in args)))


class Lambda(Block):
    """``function(*args)`` as a block: a name of ``mx.np`` (``"tanh"``)
    or a callable over NDArrays."""

    def __init__(self, function):
        super().__init__()
        self._func = _np_function(function)

    def forward(self, *args):
        return _on_ndarrays(self._func, *args)


class HybridLambda(HybridBlock):
    """A hybridizable ``Lambda``: a name of ``mx.np``, or a callable
    ``function(F, *args)`` handed the port's ``mx.nd`` as ``F``."""

    def __init__(self, function):
        super().__init__()
        if isinstance(function, str):
            self._func = _np_function(function)
        else:
            from ... import ndarray as nd
            self._func = lambda *args: function(nd, *args)

    def forward(self, *args):
        return _on_ndarrays(self._func, *args)


def _concat(block, x, axis):
    return torch.cat([child(x) for child in block], dim=axis)


class Concatenate(Sequential):
    """Each child on the same input, the outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat(self, x, self.axis)


class HybridConcatenate(HybridSequential):
    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat(self, x, self.axis)
