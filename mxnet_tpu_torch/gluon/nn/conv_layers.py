"""Convolution and pooling layers.

Counterparts of ``mxnet_tpu/gluon/nn/conv_layers.py:22-282``:
``Conv1D/2D/3D``, ``Conv1D/2D/3DTranspose``, ``Max/Avg/GlobalMax/
GlobalAvgPool1D/2D/3D`` and ``ReflectionPad2D``.  A convolution's
weight is (channels, in_channels / groups, *kernel) in NC+spatial
layouts and (channels, *kernel, in_channels / groups) in the
channels-last ones (NWC, NHWC, NDHWC), as in the JAX package; the
transposed convolutions take NC+spatial layouts only.  A max or avg
pool with ``ceil_mode=True`` takes MXNet's "full" convention (the last
window of an axis may hang over its end: ``ops.nn.pooling``); the JAX
package accepts the option and ignores it.
"""
from __future__ import annotations

import torch.nn.functional as torch_F

from ...ops import nn as F
from ..block import HybridBlock
from ..parameter import Parameter, finish_deferred_init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tuple(x, n):
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError("expected %d values, got %r" % (n, x))
        return tuple(x)
    return (x,) * n


def _check_layout(layout):
    if layout is not None and not (layout.startswith("NC")
                                   or F.channels_last(layout)):
        raise NotImplementedError(
            "Layout must be NC* or channels-last N*C; got %s" % layout)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", dtype="float32", ndim=2,
                 transpose=False, output_padding=0):
        super().__init__()
        _check_layout(layout)
        self._channels = channels
        self._kernel = _tuple(kernel_size, ndim)
        self._strides = _tuple(strides, ndim)
        self._padding = _tuple(padding, ndim)
        self._dilation = _tuple(dilation, ndim)
        self._groups = groups
        self._activation = activation
        self._transpose = transpose
        self._output_padding = _tuple(output_padding, ndim)
        self._layout = layout
        self._channels_last = F.channels_last(layout)
        if transpose and self._channels_last:
            raise NotImplementedError(
                "Transposed conv supports NC* layouts only")
        self.weight = Parameter(self._weight_shape(in_channels), dtype,
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter((channels,), dtype, init=bias_initializer,
                              allow_deferred_init=True) \
            if use_bias else None

    def _weight_shape(self, in_ch):
        if self._transpose:
            return (in_ch, self._channels // self._groups) + self._kernel
        in_g = in_ch // self._groups
        if self._channels_last:
            return (self._channels,) + self._kernel + (in_g,)
        return (self._channels, in_g) + self._kernel

    def forward(self, x):
        in_ch = x.shape[-1] if self._channels_last else x.shape[1]
        finish_deferred_init(self.weight, self._weight_shape(in_ch))
        if self.bias is not None:
            finish_deferred_init(self.bias, (self._channels,))
        if self._transpose:
            out = F.deconvolution(x, self.weight, self.bias, self._strides,
                                  self._padding, self._dilation,
                                  self._groups, self._output_padding)
        else:
            out = F.convolution(x, self.weight, self.bias, self._strides,
                                self._padding, self._dilation, self._groups,
                                self._layout)
        if self._activation is not None:
            out = F.activation(out, self._activation)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=1,
                         transpose=True, output_padding=output_padding)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=2,
                         transpose=True, output_padding=output_padding)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, dtype="float32"):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, dtype, ndim=3,
                         transpose=True, output_padding=output_padding)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ndim, global_pool,
                 pool_type, layout, count_include_pad=True, ceil_mode=False):
        super().__init__()
        _check_layout(layout)
        self._kernel = _tuple(pool_size, ndim)
        self._stride = _tuple(strides if strides is not None else pool_size,
                              ndim)
        self._pad = _tuple(padding, ndim)
        self._global = global_pool
        self._pool_type = pool_type
        self._count_include_pad = count_include_pad
        self._ceil_mode = ceil_mode
        self._layout = layout

    def forward(self, x):
        return F.pooling(x, self._kernel, self._pool_type, self._stride,
                         self._pad, self._global, self._count_include_pad,
                         self._layout, self._ceil_mode)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, 1, False, "max", layout,
                         ceil_mode=ceil_mode)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, 2, False, "max", layout,
                         ceil_mode=ceil_mode)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(pool_size, strides, padding, 3, False, "max", layout,
                         ceil_mode=ceil_mode)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 layout="NCW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 1, False, "avg", layout,
                         count_include_pad, ceil_mode)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 2, False, "avg", layout,
                         count_include_pad, ceil_mode)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(pool_size, strides, padding, 3, False, "avg", layout,
                         count_include_pad, ceil_mode)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, 1, True, "max", layout)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, 2, True, "max", layout)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, 3, True, "max", layout)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, None, 0, 1, True, "avg", layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, 2, True, "avg", layout)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, 3, True, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """Reflect-pad the last two axes of an NCHW input by ``padding``: one
    int, or (left, right, top, bottom)."""

    def __init__(self, padding=0):
        super().__init__()
        if isinstance(padding, int):
            padding = (padding,) * 4
        self._padding = tuple(padding) + (0,) * (4 - len(padding))

    def forward(self, x):
        return torch_F.pad(x, self._padding, mode="reflect")
