"""``mx.gluon.data``: datasets, samplers, batchify functions and the
``DataLoader`` (counterpart of ``mxnet_tpu/gluon/data/``).

Decoding and augmentation stay on the host, in numpy and cv2; a
``DataLoader`` makes one host-to-device copy a batch, to the current
context's device (CUDA outside any scope)."""
from . import batchify, vision  # noqa: F401
from .dataloader import (DataLoader, default_batchify_fn,  # noqa: F401
                         default_mp_batchify_fn)
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, FilterSampler, RandomSampler,  # noqa: F401
                      Sampler, SequentialSampler)
