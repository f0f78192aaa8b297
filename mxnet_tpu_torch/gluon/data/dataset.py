"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``).

A dataset's items stay what its data is: numpy arrays, Python values or
NDArrays.  ``RecordFileDataset`` reads raw records through the native
mmap reader (``mxnet_tpu_torch._native``), or through ``recordio`` with
``MXNET_NATIVE_DISABLE=1``; neither touches torch, so a ``DataLoader``
worker may index it."""
from __future__ import annotations

from ...ndarray.ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """The base: ``__getitem__`` and ``__len__``, with ``filter``,
    ``shard``, ``take``, ``sample``, ``transform`` and
    ``transform_first``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        """The samples for which ``fn(sample)`` holds."""
        from .sampler import FilterSampler
        return _SampledDataset(self, FilterSampler(fn, self))

    def shard(self, num_shards, index):
        """The ``index``-th of ``num_shards`` contiguous shards; the first
        ``len % num_shards`` shards hold one more sample."""
        assert 0 <= index < num_shards
        length = len(self)
        shard_len = length // num_shards
        rest = length % num_shards
        start = shard_len * index + min(index, rest)
        end = start + shard_len + (index < rest)
        return _SampledDataset(self, list(range(start, end)))

    def take(self, count):
        """The first ``count`` samples (all of them for None)."""
        if count is None or count > len(self):
            count = len(self)
        return _SampledDataset(self, list(range(count)))

    def sample(self, sampler):
        """The samples at the indices ``sampler`` yields."""
        return _SampledDataset(self, list(sampler))

    def transform(self, fn, lazy=True):
        """``fn`` applied to each sample (to its fields, for a tuple),
        at access time, or now with ``lazy=False``."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """``fn`` applied to the first field of each sample."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over any indexable ``data``."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _SampledDataset(Dataset):
    def __init__(self, dataset, indices):
        self._dataset = dataset
        self._indices = list(indices)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """The zip of equal-length arrays or lists; a one-dimensional NDArray
    is read to the host once, as in the reference."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for data in args:
            assert len(data) == self._length, \
                "All arrays must have the same length; %d vs %d" % (
                    len(data), self._length)
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO ``.rec`` file, by position.

    The native mmap reader needs no ``.idx`` (it scans the file at open);
    with ``MXNET_NATIVE_DISABLE=1`` the ``.idx`` beside the file drives
    ``recordio.MXIndexedRecordIO``.  A native library that fails to build
    or load raises; it is not replaced by the Python reader quietly."""

    def __init__(self, filename):
        self._filename = filename
        self._open()

    def _open(self):
        from ... import _native
        filename = self._filename
        self._native = None
        if _native.enabled():
            self._native = _native.NativeRecordFile(filename)
        else:
            from ...recordio import MXIndexedRecordIO
            idx_file = filename[:filename.rfind(".")] + ".idx"
            self._record = MXIndexedRecordIO(idx_file, filename, "r")

    @property
    def native(self):
        """Whether the native reader serves this dataset."""
        return self._native is not None

    def __getitem__(self, idx):
        if self._native is not None:
            return self._native.read(idx)
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        if self._native is not None:
            return len(self._native)
        return len(self._record.keys)

    def __getstate__(self):
        # the native handle does not pickle: a process that unpickles the
        # dataset opens the file again
        d = dict(self.__dict__)
        d["_native"] = None
        d.pop("_record", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._open()
