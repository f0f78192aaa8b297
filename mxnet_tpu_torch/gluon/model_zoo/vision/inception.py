"""Inception v3.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``: the
same module tree, so the same parameter names.  Each mixed block is a
``HybridConcatenate`` of its branches over the channels; the net takes
299 x 299 images (its final 8 x 8 average pool needs them).
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   HybridConcatenate, HybridSequential, MaxPool2D)
from ._common import no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    return HybridSequential(Conv2D(use_bias=False, **kwargs),
                            BatchNorm(epsilon=0.001), Activation("relu"))


_SETTING_NAMES = ("channels", "kernel_size", "strides", "padding")


def _make_branch(use_pool, *conv_settings):
    out = HybridSequential()
    if use_pool == "avg":
        out.add(AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        out.add(_make_basic_conv(**{k: v for k, v in zip(_SETTING_NAMES,
                                                         setting)
                                    if v is not None}))
    return out


def _concat(*branches):
    out = HybridConcatenate(axis=1)
    out.add(*branches)
    return out


def _make_A(pool_features):
    return _concat(
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)))


def _make_B():
    return _concat(
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"))


def _make_C(channels_7x7):
    return _concat(
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)))


def _make_D():
    return _concat(
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None),
                     (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)),
                     (192, 3, 2, None)),
        _make_branch("max"))


def _make_E():
    branch_3x3 = HybridSequential(
        _make_branch(None, (384, 1, None, None)),
        _concat(_make_branch(None, (384, (1, 3), None, (0, 1))),
                _make_branch(None, (384, (3, 1), None, (1, 0)))))
    branch_3x3dbl = HybridSequential(
        _make_branch(None, (448, 1, None, None), (384, 3, None, 1)),
        _concat(_make_branch(None, (384, (1, 3), None, (0, 1))),
                _make_branch(None, (384, (3, 1), None, (1, 0)))))
    return _concat(_make_branch(None, (320, 1, None, None)), branch_3x3,
                   branch_3x3dbl, _make_branch("avg", (192, 1, None, None)))


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = HybridSequential(
            _make_basic_conv(channels=32, kernel_size=3, strides=2),
            _make_basic_conv(channels=32, kernel_size=3),
            _make_basic_conv(channels=64, kernel_size=3, padding=1),
            MaxPool2D(pool_size=3, strides=2),
            _make_basic_conv(channels=80, kernel_size=1),
            _make_basic_conv(channels=192, kernel_size=3),
            MaxPool2D(pool_size=3, strides=2),
            _make_A(32), _make_A(64), _make_A(64), _make_B(),
            _make_C(128), _make_C(160), _make_C(160), _make_C(192),
            _make_D(), _make_E(), _make_E(),
            AvgPool2D(pool_size=8), Dropout(0.5))
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return Inception3(**kwargs)
