"""``mx.io``: the legacy DataIter API (counterpart of
``mxnet_tpu/io/``): ``DataIter``, ``DataBatch``, ``DataDesc``,
``NDArrayIter``, ``CSVIter``, ``ImageRecordIter`` (``gluon.data``'s
``ImageRecordDataset`` in ``DataLoader`` workers), ``ResizeIter``,
``PrefetchingIter`` and ``LibSVMIter`` (which refuses: sparse is not
ported)."""
from .io import (CSVIter, DataBatch, DataDesc, DataIter,  # noqa: F401
                 ImageRecordIter, LibSVMIter, NDArrayIter, PrefetchingIter,
                 ResizeIter)
