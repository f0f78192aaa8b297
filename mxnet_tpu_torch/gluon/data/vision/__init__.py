"""``mx.gluon.data.vision``: image datasets and transforms (counterpart
of ``mxnet_tpu/gluon/data/vision/``)."""
from . import transforms  # noqa: F401
from .datasets import (CIFAR10, CIFAR100, FashionMNIST,  # noqa: F401
                       ImageFolderDataset, ImageListDataset,
                       ImageRecordDataset, MNIST)
