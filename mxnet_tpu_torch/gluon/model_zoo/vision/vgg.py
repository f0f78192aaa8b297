"""VGG 11 / 13 / 16 / 19, with and without BatchNorm.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: the same
module tree, so the same parameter names.
"""
from __future__ import annotations

from ....initializer import Xavier
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Dropout,
                   HybridSequential, MaxPool2D)
from ._common import no_pretrained

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn"]


class VGG(HybridBlock):
    """``layers[i]`` 3x3 convolutions of ``filters[i]`` channels, then a
    2x2 max pool, for each stage; three Dense layers."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        if len(layers) != len(filters):
            raise ValueError("VGG: %d stages of layers, %d of filters"
                             % (len(layers), len(filters)))
        self.features = self._make_features(layers, filters, batch_norm)
        self.features.add(
            Dense(4096, activation="relu", weight_initializer="normal",
                  bias_initializer="zeros"), Dropout(rate=0.5),
            Dense(4096, activation="relu", weight_initializer="normal",
                  bias_initializer="zeros"), Dropout(rate=0.5))
        self.output = Dense(classes, weight_initializer="normal",
                            bias_initializer="zeros")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = HybridSequential()
        for num, channels in zip(layers, filters):
            for _ in range(num):
                featurizer.add(Conv2D(
                    channels, kernel_size=3, padding=1,
                    weight_initializer=Xavier(rnd_type="gaussian",
                                              factor_type="out", magnitude=2),
                    bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(BatchNorm())
                featurizer.add(Activation("relu"))
            featurizer.add(MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, **kwargs):
    layers, filters = vgg_spec[num_layers]
    no_pretrained(pretrained)
    return VGG(layers, filters, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


def vgg11_bn(**kw):
    return get_vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return get_vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return get_vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return get_vgg(19, batch_norm=True, **kw)
