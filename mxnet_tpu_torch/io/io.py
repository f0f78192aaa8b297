"""Legacy data iterators (counterpart of ``mxnet_tpu/io/io.py``):
``DataBatch``, ``DataDesc``, ``DataIter``, ``NDArrayIter``, ``CSVIter``,
``ImageRecordIter``, ``ResizeIter``, ``PrefetchingIter`` and
``LibSVMIter`` (CSR batches).

Batches are NDArrays on the current context's device (CUDA outside any
scope).  ``NDArrayIter`` holds its arrays there and gathers each batch on
the device; ``ImageRecordIter`` decodes and augments on the host in
``DataLoader`` workers and copies each batch once."""
from __future__ import annotations

from collections import namedtuple

import numpy as _onp
import torch

from .. import numpy as mnp
from .. import profiler as _profiler
from ..ndarray.ndarray import NDArray

__all__ = ["DataBatch", "DataDesc", "DataIter", "NDArrayIter", "CSVIter",
           "ImageRecordIter", "ResizeIter", "PrefetchingIter", "LibSVMIter"]

DataDesc = namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])
DataDesc.__new__.__defaults__ = (_onp.float32, "NCHW")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple))
        if label is not None:
            assert isinstance(label, (list, tuple))
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        if self.label:
            label_shapes = [l.shape for l in self.label]
        else:
            label_shapes = None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        # every iterator's profiler seam: the fetch time of a batch and
        # the throughput counters
        prof_t0 = _profiler._now_us() if _profiler._DATA else None
        batch = self.next()
        if prof_t0 is not None:
            _profiler.record_duration(
                "%s::next" % type(self).__name__, "data", prof_t0,
                _profiler._now_us() - prof_t0)
            _profiler.counter_add("io::batches", 1, cat="data")
            if self.batch_size:
                # a padded last batch repeats (pad) samples: count real ones
                pad = getattr(batch, "pad", 0) or 0
                _profiler.counter_add("io::samples", self.batch_size - pad,
                                      cat="data")
        return batch

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class NDArrayIter(DataIter):
    """Batches of NDArray / numpy data: one array, a list or a dict of
    them for data and label; ``shuffle`` (numpy's global state); the
    last batch padded from the start, discarded, or rolled over
    (``last_batch_handle`` ``"pad"`` / ``"discard"`` / ``"roll_over"``).
    The arrays live on the current context's device, where each batch
    is gathered."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = self._init_data(data, allow_empty=False, name=data_name)
        self.label = self._init_data(label, allow_empty=True, name=label_name)
        self.idx = _onp.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        self.reset()

    @staticmethod
    def _init_data(data, allow_empty, name):
        if data is None:
            assert allow_empty
            return []
        if isinstance(data, (NDArray, _onp.ndarray)):
            data = [(name, data)]
        elif isinstance(data, (list, tuple)):
            data = [("%s_%d" % (name, i), d) for i, d in enumerate(data)]
        elif isinstance(data, dict):
            data = list(data.items())
        out = []
        for k, v in data:
            if not isinstance(v, NDArray):
                v = mnp.array(v)
            out.append((k, v))
        return out

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            _onp.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < self.num_data:
            self.cursor = self.cursor - self.num_data - self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _take(self, arrs):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[self.cursor:end]
        else:
            if self.last_batch_handle == "discard":
                return None
            pad = end - self.num_data
            sel = _onp.concatenate([self.idx[self.cursor:], self.idx[:pad]])
        return [NDArray(v._data[torch.as_tensor(sel, device=v._data.device)])
                for _, v in arrs]

    def next(self):
        if not self.iter_next():
            raise StopIteration
        end = self.cursor + self.batch_size
        if end > self.num_data and self.last_batch_handle == "discard":
            raise StopIteration
        data = self._take(self.data)
        label = self._take(self.label) if self.label else []
        return DataBatch(data=data, label=label, pad=self.getpad(),
                         index=None)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == "pad" and end > self.num_data:
            return end - self.num_data
        return 0


class CSVIter(DataIter):
    """CSV files read on the host (MXNet's ``src/io/iter_csv.cc``) and
    served by an ``NDArrayIter``."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = _onp.loadtxt(data_csv, delimiter=",", dtype=_onp.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _onp.loadtxt(label_csv, delimiter=",",
                                 dtype=_onp.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad" if round_batch
                                  else "discard")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """LibSVM-format batches as CSR arrays (``src/io/iter_libsvm.cc``;
    reference ``io/io.py:206``).  Each ``data_libsvm`` line is ``<label>
    <idx>:<val> ...`` with 0-based feature indices; with
    ``label_libsvm`` the labels come from that file, one vector a line.
    The file is parsed on the host once; each batch's values are
    scattered into a dense (batch_size, data_shape[0]) float32 array on
    the current context, whose ``CSRNDArray`` view derives its structure
    when first read (DELTAS.md #2).  ``round_batch`` pads the last batch
    by wrapping to the start (``pad`` says how many rows)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        self._rows = []    # (cols int64[], vals float32[]) per example
        self._labels = []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                lead, label = 0, 0.0
                if ":" not in parts[0]:
                    label, lead = float(parts[0]), 1
                pairs = [tok.split(":") for tok in parts[lead:]]
                self._rows.append((
                    _onp.asarray([int(i) for i, _ in pairs], _onp.int64),
                    _onp.asarray([float(v) for _, v in pairs],
                                 _onp.float32)))
                self._labels.append(label)
        if label_libsvm is not None:
            with open(label_libsvm) as f:
                self._labels = [[float(x) for x in line.split()]
                                for line in f if line.strip()]
        self._label_shape = tuple(label_shape) if label_shape else None
        self._round = round_batch
        self.reset()

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        return self._cursor < len(self._rows)

    def next(self):
        from ..context import resolve_device
        from ..ndarray import sparse as _sparse
        if not self.iter_next():
            raise StopIteration
        n = len(self._rows)
        idxs, pad = [], 0
        while len(idxs) < self.batch_size:
            if self._cursor >= n:
                if not self._round or not idxs:
                    break
                idxs.append(pad % n)
                pad += 1
                continue
            idxs.append(self._cursor)
            self._cursor += 1
        rows = [self._rows[i] for i in idxs]
        r = _onp.repeat(_onp.arange(len(rows)), [len(c) for c, _ in rows])
        c = _onp.concatenate([c for c, _ in rows])
        v = _onp.concatenate([v for _, v in rows])
        dev = resolve_device()
        dense = torch.zeros((len(idxs), self._data_shape[0]),
                            dtype=torch.float32, device=dev)
        dense[torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)] = \
            torch.from_numpy(v).to(dev)
        labels = _onp.asarray([self._labels[i] for i in idxs], _onp.float32)
        if self._label_shape:
            labels = labels.reshape((len(idxs),) + self._label_shape)
        return DataBatch(data=[_sparse.csr_matrix(NDArray(dense))],
                         label=[mnp.array(labels)], pad=pad)


class ImageRecordIter(DataIter):
    """Images of a ``.rec`` file (MXNet's ``ImageRecordIter``): decode and
    augmentation (resize of the short side, a center or random crop, a
    random mirror, ``ToTensor`` and the mean / std normalization) in
    ``preprocess_threads`` forked ``DataLoader`` workers with
    ``prefetch_buffer`` batches in flight; each batch (NCHW float32 in
    [0, 1] before normalization, and its labels) arrives on the current
    context's device.  ``round_batch`` rolls the short last batch over
    into the next epoch, else it is discarded."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, rand_crop=False,
                 rand_mirror=False, resize=-1, preprocess_threads=4,
                 prefetch_buffer=4, round_batch=True, **kwargs):
        super().__init__(batch_size)
        from ..gluon.data import DataLoader
        from ..gluon.data.vision import ImageRecordDataset
        from ..gluon.data.vision import transforms as T

        self._data_shape = tuple(data_shape)
        augs = []
        c, h, w = self._data_shape
        if resize > 0:
            augs.append(T.Resize(resize, keep_ratio=True))
        if rand_crop:
            augs.append(T.RandomCrop((w, h)))
        else:
            augs.append(T.CenterCrop((w, h)))
        if rand_mirror:
            augs.append(T.RandomFlipLeftRight())
        augs.append(T.ToTensor())
        if any(v != 0.0 for v in (mean_r, mean_g, mean_b)) or \
                any(v != 1.0 for v in (std_r, std_g, std_b)):
            augs.append(T.Normalize(
                mean=[m / 255.0 for m in (mean_r, mean_g, mean_b)],
                std=[s / 255.0 for s in (std_r, std_g, std_b)]))
        aug = T.Compose(augs)
        dataset = ImageRecordDataset(path_imgrec).transform_first(aug)
        self._loader = DataLoader(
            dataset, batch_size=batch_size, shuffle=shuffle,
            num_workers=preprocess_threads,
            last_batch="rollover" if round_batch else "discard",
            prefetch=prefetch_buffer)
        self._iter = None

    def reset(self):
        self._iter = iter(self._loader)

    def next(self):
        if self._iter is None:
            self.reset()
        try:
            data, label = next(self._iter)
        except StopIteration:
            self._iter = None
            raise
        return DataBatch(data=[data], label=[label], pad=0)


class ResizeIter(DataIter):
    """``size`` batches an epoch of ``data_iter``, restarting it when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """The batches of one iterator (the reference's wrapper, which reads
    them in the calling thread)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        assert len(iters) == 1, "single iter supported"
        super().__init__(iters[0].batch_size)
        self.iter = iters[0]

    def reset(self):
        self.iter.reset()

    def next(self):
        return self.iter.next()
