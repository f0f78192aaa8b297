"""ResNet V1 / V2.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py:28-293``:
``BasicBlockV1/V2``, ``BottleneckV1/V2``, ``ResNetV1/V2``, ``get_resnet``
and the ten ``resnetNN_vK`` factories, with the same module tree and so
the same parameter names.  V1 is the b variant (stride on the 3x3).
``layout="NHWC"`` builds the channels-last net: the same names, conv
weights stored OHWI, BatchNorm over the trailing axis, every layer
working on views of the (N, H, W, C) activations.
"""
from __future__ import annotations

from ....ops import nn as F
from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)
from ._common import no_pretrained

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]


def _bn_axis(layout):
    return -1 if F.channels_last(layout) else 1


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, layout=layout)


def _downsample_v1(channels, stride, in_channels, layout):
    return HybridSequential(
        Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
               in_channels=in_channels, layout=layout),
        BatchNorm(axis=_bn_axis(layout)))


class _ResidualV1(HybridBlock):
    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        return F.activation(self.body(x) + residual, "relu")


class BasicBlockV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.body = HybridSequential(
            _conv3x3(channels, stride, in_channels, layout),
            BatchNorm(axis=ax), Activation("relu"),
            _conv3x3(channels, 1, channels, layout), BatchNorm(axis=ax))
        self.downsample = _downsample_v1(channels, stride, in_channels,
                                         layout) if downsample else None


class BottleneckV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.body = HybridSequential(
            Conv2D(channels // 4, kernel_size=1, strides=1, use_bias=False,
                   layout=layout),
            BatchNorm(axis=ax), Activation("relu"),
            _conv3x3(channels // 4, stride, channels // 4, layout),
            BatchNorm(axis=ax), Activation("relu"),
            Conv2D(channels, kernel_size=1, strides=1, use_bias=False,
                   layout=layout),
            BatchNorm(axis=ax))
        self.downsample = _downsample_v1(channels, stride, in_channels,
                                         layout) if downsample else None


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.bn1 = BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = F.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = F.activation(self.bn2(self.conv1(x)), "relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW"):
        super().__init__()
        ax = _bn_axis(layout)
        self.bn1 = BatchNorm(axis=ax)
        self.conv1 = Conv2D(channels // 4, 1, 1, use_bias=False,
                            layout=layout)
        self.bn2 = BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout)
        self.bn3 = BatchNorm(axis=ax)
        self.conv3 = Conv2D(channels, 1, 1, use_bias=False, layout=layout)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = F.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = F.activation(self.bn2(self.conv1(x)), "relu")
        x = F.activation(self.bn3(self.conv2(x)), "relu")
        return self.conv3(x) + residual


def _make_layer(block, layers, channels, stride, in_channels=0,
                layout="NCHW"):
    layer = HybridSequential(block(channels, stride, channels != in_channels,
                                   in_channels=in_channels, layout=layout))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout))
    return layer


def _stem(features, channels, thumbnail, layout):
    if thumbnail:
        features.add(_conv3x3(channels, 1, 0, layout))
    else:
        features.add(Conv2D(channels, 7, 2, 3, use_bias=False, layout=layout),
                     BatchNorm(axis=_bn_axis(layout)), Activation("relu"),
                     MaxPool2D(3, 2, 1, layout=layout))


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW"):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count more than layers")
        self.features = HybridSequential()
        _stem(self.features, channels[0], thumbnail, layout)
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                in_channels=channels[i], layout=layout))
        self.features.add(GlobalAvgPool2D(layout=layout), Flatten())
        self.output = Dense(classes, in_units=channels[-1])

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW"):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("need one channel count more than layers")
        ax = _bn_axis(layout)
        self.features = HybridSequential(BatchNorm(scale=False, center=False,
                                                   axis=ax))
        _stem(self.features, channels[0], thumbnail, layout)
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            self.features.add(_make_layer(
                block, num_layer, channels[i + 1], 1 if i == 0 else 2,
                in_channels=in_channels, layout=layout))
            in_channels = channels[i + 1]
        self.features.add(BatchNorm(axis=ax), Activation("relu"),
                          GlobalAvgPool2D(layout=layout), Flatten())
        self.output = Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers`` (18, 34, 50, 101,
    152); ``kwargs`` go to the net (``classes``, ``thumbnail``,
    ``layout``)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid resnet depth %d" % num_layers)
    if version not in (1, 2):
        raise ValueError("Invalid resnet version %d" % version)
    no_pretrained(pretrained)
    block_type, layers, channels = resnet_spec[num_layers]
    return resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][block_type], layers, channels,
        **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)
