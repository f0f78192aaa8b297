"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``).

``RandomSampler`` draws from numpy's global random state, as the
reference does, so a seeded ``numpy.random`` gives the same orders in
both packages."""
from __future__ import annotations

import numpy as _onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "FilterSampler",
           "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """``start, start + 1, ..., start + length - 1``."""

    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A permutation of ``range(length)`` from numpy's global state."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(_onp.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    """The indices of the samples of ``dataset`` for which ``fn`` holds."""

    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices of ``sampler``; the short last
    batch is kept, discarded, or rolled over into the next epoch
    (``last_batch`` ``"keep"`` / ``"discard"`` / ``"rollover"``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch
            elif self._last_batch != "discard":
                raise ValueError(
                    "last_batch must be one of 'keep', 'discard', or "
                    "'rollover', but got %s" % self._last_batch)

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        if self._last_batch == "rollover":
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError("invalid last_batch")
