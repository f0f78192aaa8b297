"""DenseNet 121 / 161 / 169 / 201.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: the
same module tree, so the same parameter names.
"""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout,
                   Flatten, GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ._common import no_pretrained

__all__ = ["DenseNet", "get_densenet", "densenet121", "densenet161",
           "densenet169", "densenet201"]


class _DenseLayer(HybridBlock):
    """BN, relu, 1x1 conv, BN, relu, 3x3 conv; its ``growth_rate``
    channels concatenated after the input's."""

    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = HybridSequential(
            BatchNorm(), Activation("relu"),
            Conv2D(bn_size * growth_rate, kernel_size=1, use_bias=False),
            BatchNorm(), Activation("relu"),
            Conv2D(growth_rate, kernel_size=3, padding=1, use_bias=False))
        if dropout:
            self.body.add(Dropout(dropout))

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    return HybridSequential(*(_DenseLayer(growth_rate, bn_size, dropout)
                              for _ in range(num_layers)))


def _make_transition(num_output_features):
    return HybridSequential(
        BatchNorm(), Activation("relu"),
        Conv2D(num_output_features, kernel_size=1, use_bias=False),
        AvgPool2D(pool_size=2, strides=2))


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = HybridSequential(
            Conv2D(num_init_features, kernel_size=7, strides=2, padding=3,
                   use_bias=False),
            BatchNorm(), Activation("relu"),
            MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                self.features.add(_make_transition(num_features // 2))
                num_features = num_features // 2
        self.features.add(BatchNorm(), Activation("relu"), GlobalAvgPool2D(),
                          Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, **kwargs):
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    no_pretrained(pretrained)
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kw):
    return get_densenet(121, **kw)


def densenet161(**kw):
    return get_densenet(161, **kw)


def densenet169(**kw):
    return get_densenet(169, **kw)


def densenet201(**kw):
    return get_densenet(201, **kw)
