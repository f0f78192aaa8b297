"""``mx.nd`` -- the NDArray package: :class:`NDArray` over one
``torch.Tensor`` and its creation helpers (counterpart of
``mxnet_tpu/ndarray/__init__.py``; the legacy op namespace, ``sparse``,
``linalg``, ``image``, ``contrib`` and ``op_updates`` wait for ROADMAP
queues 1d and 5)."""
from ..numpy import random  # noqa: F401  (mx.nd.random)
from .ndarray import (NDArray, apply_op, arange, array,  # noqa: F401
                      concatenate, empty, full, ones, stack, waitall, zeros)
