"""MobileNet v1 and v2, at width multipliers 0.25 / 0.5 / 0.75 / 1.0.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``: the
same module tree, so the same parameter names.  The depthwise
convolutions are ``Conv2D`` with ``groups`` = channels; v2's ReLU6 is a
``HybridLambda`` over ``F.clip``, as in the reference.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridLambda, HybridSequential)
from ._common import no_pretrained

__all__ = ["MobileNet", "MobileNetV2", "LinearBottleneck", "get_mobilenet",
           "get_mobilenet_v2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _relu6(F, x):
    return F.clip(x, 0, 6)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False),
            BatchNorm(scale=True))
    if active:
        out.add(HybridLambda(_relu6) if relu6 else Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels=channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """v2's inverted residual: a 1x1 expansion by ``t``, a 3x3 depthwise
    convolution, a linear 1x1 projection, and the shortcut where the
    shape is kept."""

    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = HybridSequential()
        _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride, pad=1,
                  num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        _add_conv(self.features, channels=int(32 * multiplier), kernel=3,
                  pad=1, stride=2)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dw_channels=dwc, channels=c, stride=s)
        self.features.add(GlobalAvgPool2D(), Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                  pad=1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                             + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                          + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2] + [1] * 2 + [2] + [1] * 2 + [2] + [1] * 3 \
            + [1] * 3 + [2] + [1] * 3
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_channels=in_c, channels=c,
                                               t=t, stride=s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(GlobalAvgPool2D())
        self.output = HybridSequential(Conv2D(classes, 1, use_bias=False),
                                       Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return MobileNet(multiplier, **kwargs)


def get_mobilenet_v2(multiplier, pretrained=False, **kwargs):
    no_pretrained(pretrained)
    return MobileNetV2(multiplier, **kwargs)


def mobilenet1_0(**kw):
    return get_mobilenet(1.0, **kw)


def mobilenet0_75(**kw):
    return get_mobilenet(0.75, **kw)


def mobilenet0_5(**kw):
    return get_mobilenet(0.5, **kw)


def mobilenet0_25(**kw):
    return get_mobilenet(0.25, **kw)


def mobilenet_v2_1_0(**kw):
    return get_mobilenet_v2(1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return get_mobilenet_v2(0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return get_mobilenet_v2(0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return get_mobilenet_v2(0.25, **kw)
