"""``mx.nd`` -- the NDArray package: :class:`NDArray` over one
``torch.Tensor``, its creation helpers, the legacy op namespace
(:mod:`.legacy_ops`: the CamelCase layers, the legacy reshape codes,
``linalg_*``, ``save`` / ``load``, ...), the optimizer update ops
(``mx.nd.sgd_update`` ..., :mod:`.op_updates`) and the ``sparse``,
``linalg``, ``image`` and ``contrib`` submodules (counterpart of
``mxnet_tpu/ndarray/__init__.py``)."""
from ..numpy import random  # noqa: F401  (mx.nd.random)
from .ndarray import (NDArray, apply_op, arange, array,  # noqa: F401
                      concatenate, empty, full, ones, waitall, zeros)
from .legacy_ops import *  # noqa: F401,F403
from .legacy_ops import concat, reshape, split, stack  # noqa: F401
from . import contrib, image, legacy_ops, linalg, op_updates, sparse  # noqa
from .op_updates import *  # noqa: F401,F403
