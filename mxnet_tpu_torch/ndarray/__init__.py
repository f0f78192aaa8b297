"""``mx.nd`` -- the NDArray package: :class:`NDArray` over one
``torch.Tensor``, its creation helpers, the optimizer update ops
(``mx.nd.sgd_update`` ..., :mod:`.op_updates`) and ``contrib``'s int8
quantization family (:mod:`.contrib`) (counterpart of
``mxnet_tpu/ndarray/__init__.py``; the legacy op namespace, ``sparse``,
``linalg``, ``image`` and the rest of ``contrib`` wait for ROADMAP
queue 5)."""
from ..numpy import random  # noqa: F401  (mx.nd.random)
from . import contrib, op_updates  # noqa: F401
from .ndarray import (NDArray, apply_op, arange, array,  # noqa: F401
                      concatenate, empty, full, ones, stack, waitall, zeros)
from .op_updates import *  # noqa: F401,F403
