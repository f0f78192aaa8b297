"""AlexNet.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``: the same
module tree (``features``, ``output``), so the same parameter names.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D
from ._common import no_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = HybridSequential(
            Conv2D(64, kernel_size=11, strides=4, padding=2,
                   activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Conv2D(192, kernel_size=5, padding=2, activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Conv2D(384, kernel_size=3, padding=1, activation="relu"),
            Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Flatten(),
            Dense(4096, activation="relu"), Dropout(0.5),
            Dense(4096, activation="relu"), Dropout(0.5))
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, **kwargs):
    no_pretrained(pretrained)
    return AlexNet(**kwargs)
