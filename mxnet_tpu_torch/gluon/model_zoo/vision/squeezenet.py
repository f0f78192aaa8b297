"""SqueezeNet 1.0 / 1.1.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: the
same module tree, so the same parameter names.  A fire module's two
expand paths are a ``HybridConcatenate`` over the channels.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, Conv2D, Dropout, Flatten, GlobalAvgPool2D,
                   HybridConcatenate, HybridSequential, MaxPool2D)
from ._common import no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    paths = HybridConcatenate(axis=1)
    paths.add(_make_fire_conv(expand1x1_channels, 1),
              _make_fire_conv(expand3x3_channels, 3, 1))
    return HybridSequential(_make_fire_conv(squeeze_channels, 1), paths)


def _make_fire_conv(channels, kernel_size, padding=0):
    return HybridSequential(Conv2D(channels, kernel_size, padding=padding),
                            Activation("relu"))


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000):
        super().__init__()
        if version not in ("1.0", "1.1"):
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % (version,))
        self.features = HybridSequential()
        if version == "1.0":
            self.features.add(
                Conv2D(96, kernel_size=7, strides=2), Activation("relu"),
                MaxPool2D(pool_size=3, strides=2, padding=(0, 0)),
                _make_fire(16, 64, 64), _make_fire(16, 64, 64),
                _make_fire(32, 128, 128),
                MaxPool2D(pool_size=3, strides=2),
                _make_fire(32, 128, 128), _make_fire(48, 192, 192),
                _make_fire(48, 192, 192), _make_fire(64, 256, 256),
                MaxPool2D(pool_size=3, strides=2),
                _make_fire(64, 256, 256))
        else:
            self.features.add(
                Conv2D(64, kernel_size=3, strides=2), Activation("relu"),
                MaxPool2D(pool_size=3, strides=2),
                _make_fire(16, 64, 64), _make_fire(16, 64, 64),
                MaxPool2D(pool_size=3, strides=2),
                _make_fire(32, 128, 128), _make_fire(32, 128, 128),
                MaxPool2D(pool_size=3, strides=2),
                _make_fire(48, 192, 192), _make_fire(48, 192, 192),
                _make_fire(64, 256, 256), _make_fire(64, 256, 256))
        self.features.add(Dropout(0.5))
        self.output = HybridSequential(
            Conv2D(classes, kernel_size=1), Activation("relu"),
            GlobalAvgPool2D(), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
