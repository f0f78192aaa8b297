"""``DataLoader`` (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Host and device.  Samples are read, decoded and batched on the host: in
the main process, or with ``num_workers > 0`` in a pool of worker
processes (threads with ``thread_pool=True``).  A worker process hands
each array of 1 MB or more back through POSIX shared memory (one
``/dev/shm`` segment an array, as MXNet's shared-memory NDArrays do),
the rest pickled through the pool's pipe: a pipe moves tens of MB/s on
a sandboxed host, where a batch of 128 images in float32 is 77 MB.  The
main process makes one host-to-device copy of each batch, out of the
shared segment, to the current context's device
(``context.resolve_device``: CUDA outside any scope, the CPU only when
asked for); with ``pin_memory=True`` on CUDA it stages the batch in
pinned memory and copies it with ``non_blocking=True``.

Workers are forked, as the reference's are, and by the time a loader
starts the process may hold a CUDA context.  A forked child must make no
CUDA call and, once the parent's intra-op thread pool has started, may
hang in a torch CPU operation.  So the worker side runs no torch
operation: ``Dataset.__getitem__`` of the host datasets, the vision
transforms on numpy inputs and the batchify functions, which return
numpy in a worker (``batchify.on_host``).  A worker freezes the garbage
collector's view of what it inherited (``gc.freeze``), so no tensor of
the parent is freed in the child.

Workers are supervised as in the reference (:meth:`_supervised_get`,
:meth:`_recover`): a dead worker is detected, the pool is rebuilt once
an epoch, and every batch in flight is resubmitted; a second death in
the epoch raises.  ``fault.dataloader_hook`` (armed by ``mx.fault``'s
``dataloader`` fault) kills a worker of ``pool._pool`` at a submit.

Random augmentation draws from Python's ``random`` and numpy's global
state, as in the reference; forked workers inherit one random state and
are not reseeded (a quirk of the reference), so with workers random
augmentation repeats across workers.
"""
from __future__ import annotations

import ctypes
import gc
import glob
import itertools
import logging
import mmap
import multiprocessing
import multiprocessing.pool
import os
import pickle
import signal
import threading
import time

import numpy as _onp
import torch

from ... import fault as _fault
from ... import profiler as _profiler
from ...context import resolve_device
from ...ndarray.ndarray import NDArray
from . import batchify as _batchify
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

# 64-bit types off, as NDArray's: what numpy data becomes on the device
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}


class _WorkerLost(Exception):
    """A pool worker died while a batch was in flight."""


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays on their device, anything
    else through numpy (an NDArray on the current context, or numpy
    inside a loader); tuple samples give one batch per field."""
    if isinstance(data[0], NDArray):
        from ... import numpy as mnp
        return mnp.stack(data)
    if isinstance(data[0], (tuple, list)):
        return [default_batchify_fn(list(x)) for x in zip(*data)]
    return _batchify._emit(_onp.asarray(data))


def default_mp_batchify_fn(data):
    """Stack samples into numpy batches (the worker side)."""
    if isinstance(data[0], (tuple, list)):
        return [default_mp_batchify_fn(list(x)) for x in zip(*data)]
    if isinstance(data[0], NDArray):
        return _onp.stack([d.asnumpy() for d in data])
    return _onp.asarray(data)


_worker_dataset = None
#: arrays from this size on leave a worker process through shared memory
SHARED_MIN_BYTES = 1 << 20
_SHM_DIR = "/dev/shm"
_seq = itertools.count()


def _keep_freed_blocks():
    """Let glibc keep freed blocks of up to 256 MB in this process's heap
    (``mallopt``): a worker allocates and frees a batch's arrays again
    and again, and a fresh mapping for each costs a page fault every 4
    KB, which a sandboxed kernel makes dear."""
    # the process's own symbols: glibc's where it is the C library
    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        mallopt(-3, 256 << 20)      # M_MMAP_THRESHOLD
        mallopt(-1, 1 << 30)        # M_TRIM_THRESHOLD


def _worker_initializer(dataset):
    global _worker_dataset
    _worker_dataset = dataset
    # nothing inherited from the parent is collected here (a tensor
    # freed in a forked child could reach the CUDA allocator)
    gc.freeze()
    _keep_freed_blocks()
    _batchify._STATE.host = True
    # the parent's signal handlers (a preemption autosaver) stay there:
    # terminate() must kill a worker cleanly
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)


def _thread_initializer():
    _batchify._STATE.host = True


class _Shared:
    """An array a worker process left in the shared segment ``name``."""

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _segment(name, size, create):
    """The shared segment ``/dev/shm/<name>`` mapped with its pages
    populated in one call (``MAP_POPULATE``), not by a fault each."""
    fd = os.open(os.path.join(_SHM_DIR, name), os.O_RDWR | (
        os.O_CREAT | os.O_EXCL if create else 0), 0o600)
    try:
        if create:
            os.ftruncate(fd, size)
        return mmap.mmap(fd, size, flags=mmap.MAP_SHARED | getattr(
            mmap, "MAP_POPULATE", 0))
    finally:
        os.close(fd)


def _share(batch, token):
    """``batch`` with each numpy array of ``SHARED_MIN_BYTES`` or more
    copied into a new shared segment ``mxt_<token>_<pid>_<n>``, which the
    main process unlinks once it has taken the array."""
    if isinstance(batch, _onp.ndarray) and batch.nbytes >= SHARED_MIN_BYTES \
            and batch.dtype != object:
        name = "mxt_%s_%d_%d" % (token, os.getpid(), next(_seq))
        seg = _segment(name, batch.nbytes, True)
        view = _onp.ndarray(batch.shape, batch.dtype, buffer=seg)
        view[...] = batch
        del view
        seg.close()
        return _Shared(name, batch.shape, batch.dtype.str)
    if isinstance(batch, (list, tuple)):
        return type(batch)(_share(b, token) for b in batch)
    return batch


def _worker_fn(samples, batchify_fn, token):
    batch = batchify_fn([_worker_dataset[i] for i in samples])
    return pickle.dumps(_share(batch, token),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _thread_fn(dataset, samples, batchify_fn):
    return batchify_fn([dataset[i] for i in samples])


def _unlink_all(token):
    """Remove the shared segments of ``token`` nobody took (a worker
    killed mid-batch, batches in flight at ``close``)."""
    for path in glob.glob(os.path.join(_SHM_DIR, "mxt_%s_*" % token)):
        try:
            os.unlink(path)
        except OSError:
            pass


def _copy(arr, dev, pin, own):
    """An NDArray on ``dev`` of the numpy ``arr``; ``own`` False means
    ``arr``'s memory is about to go, so the result must not share it."""
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr, own = _onp.array(arr, order="C"), True
    t = torch.from_numpy(arr)
    cast = _CANONICAL.get(t.dtype)
    if dev.type == "cuda":
        out = t.pin_memory().to(dev, non_blocking=True) if pin \
            else t.to(dev)
        if cast is not None:
            out = out.to(cast)
    elif cast is not None:
        out = t.to(cast)
    else:
        out = t if own else t.clone()
    return NDArray(out)


def _to_device(batch, dev, pin):
    """Every numpy array of ``batch`` (and every shared one, whose
    segment is then unlinked) as an NDArray on ``dev``: one copy, staged
    in pinned memory with ``pin`` on CUDA.  Lists and tuples become
    lists, as in the reference."""
    if isinstance(batch, _onp.ndarray):
        return _copy(batch, dev, pin, True)
    if isinstance(batch, _Shared):
        dtype = _onp.dtype(batch.dtype)
        size = dtype.itemsize * int(_onp.prod(batch.shape))
        seg = _segment(batch.name, size, False)
        try:
            view = _onp.ndarray(batch.shape, dtype, buffer=seg)
            out = _copy(view, dev, pin, False)
            del view
        finally:
            seg.close()
            os.unlink(os.path.join(_SHM_DIR, batch.name))
        return out
    if isinstance(batch, (list, tuple)):
        return [_to_device(b, dev, pin) for b in batch]
    return batch


def _batch_len(batch):
    """Leading-axis length of the first array leaf of a batch."""
    while isinstance(batch, (list, tuple)) and batch:
        batch = batch[0]
    shape = getattr(batch, "shape", None)
    return int(shape[0]) if shape else 1


class _ElasticPlanSampler:
    """Batch-sampler view of a ``parallel.EpochPlan`` (anything with
    ``done`` / ``next_for`` / ``remaining``): each step yields this
    rank's global indices and advances the replicated cursor, so an
    elastic fleet reads every index of the epoch once across resizes.
    ``rank`` may be a callable, re-read every step (a resize renumbers
    ranks).  Not thread-safe: one loader per plan."""

    def __init__(self, plan, rank):
        self._plan = plan
        self._rank = rank

    def _rank_now(self):
        r = self._rank
        return int(r() if callable(r) else r)

    def __iter__(self):
        while not self._plan.done():
            yield [int(i) for i in self._plan.next_for(self._rank_now())]

    def __len__(self):
        # steps left at the current world and batch (a resize changes the
        # window, so this is an estimate)
        window = self._plan.world * self._plan.batch_per_rank
        return -(-self._plan.remaining() // max(1, window))


class DataLoader:
    """Mini-batches of a ``Dataset``.

    The reference's arguments: ``batch_size`` / ``shuffle`` / ``sampler``
    / ``last_batch`` (``"keep"``, ``"discard"``, ``"rollover"``) or a
    ``batch_sampler``; ``batchify_fn``; ``num_workers`` forked workers
    with ``prefetch`` batches in flight (default ``2 * num_workers``);
    ``timeout`` seconds for a batch; ``thread_pool=True`` runs the
    workers as threads of this process (cv2's decode and numpy's array
    work release the GIL), whose batches need no transport.
    ``pin_memory`` stages each batch in pinned memory on CUDA
    (``pin_device_id`` and ``try_nopython`` are accepted).  ``elastic_plan=`` drives batching
    from a shared ``parallel.EpochPlan`` (``next_for(elastic_rank)`` a
    batch), exclusive of the batching arguments.

    Each batch arrives as NDArrays on the current context's device.
    With the profiler's data flag on, each fetch records
    ``DataLoader::next`` and counts ``dataloader::batches`` and
    ``dataloader::samples``."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 try_nopython=None, elastic_plan=None, elastic_rank=0):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._timeout = timeout
        if elastic_plan is not None:
            if batch_sampler is not None or batch_size is not None or \
                    shuffle or sampler is not None or last_batch is not None:
                raise ValueError(
                    "elastic_plan drives batching itself: batch_size, "
                    "shuffle, sampler, last_batch and batch_sampler must "
                    "not be specified with it")
            batch_sampler = _ElasticPlanSampler(elastic_plan, elastic_rank)
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        if batchify_fn is None:
            self._batchify_fn = default_mp_batchify_fn \
                if self._num_workers > 0 else default_batchify_fn
        else:
            self._batchify_fn = batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._thread_pool = bool(thread_pool)
        self._token = "%d_%d" % (os.getpid(), next(_seq))
        self._pool = None
        self._worker_pids = ()
        self._rebuilt = False  # supervision rebuilds the pool once an epoch
        if self._num_workers > 0:
            self._make_pool()

    def _make_pool(self):
        if self._thread_pool:
            self._pool = multiprocessing.pool.ThreadPool(
                self._num_workers, initializer=_thread_initializer)
            return
        self._pool = multiprocessing.get_context("fork").Pool(
            self._num_workers, initializer=_worker_initializer,
            initargs=(self._dataset,))
        self._worker_pids = tuple(sorted(w.pid for w in self._pool._pool))

    def _apply(self, samples):
        """Submit one batch's samples to the pool."""
        if self._thread_pool:
            return self._pool.apply_async(
                _thread_fn, (self._dataset, samples, self._batchify_fn))
        return self._pool.apply_async(_worker_fn, (samples, self._batchify_fn,
                                                   self._token))

    def __iter__(self):
        dev = resolve_device()
        pin = bool(self._pin_memory) and dev.type == "cuda"
        # the fetch of each batch is timed (not the consumer's work
        # between fetches); one flag read a batch when profiling is off
        t_fetch = _profiler._now_us() if _profiler._DATA else None
        for batch in self._iter_batches():
            batch = _to_device(batch, dev, pin)
            if _profiler._DATA:
                if t_fetch is not None:
                    _profiler.record_duration(
                        "DataLoader::next", "data", t_fetch,
                        _profiler._now_us() - t_fetch)
                _profiler.counter_add("dataloader::batches", 1, cat="data")
                _profiler.counter_add("dataloader::samples",
                                      _batch_len(batch), cat="data")
            yield batch
            t_fetch = _profiler._now_us() if _profiler._DATA else None

    def _iter_batches(self):
        """The batches as the host makes them (numpy, or NDArrays where
        the samples are)."""
        if self._pool is None:
            for batch in self._batch_sampler:
                with _batchify.host_batches():
                    out = self._batchify_fn([self._dataset[i]
                                             for i in batch])
                yield out
            return

        it = iter(self._batch_sampler)
        # one rebuild an iteration: two deaths in one epoch mean a
        # persistent crash, isolated deaths epochs apart are recoverable
        self._rebuilt = False
        pending = []  # [samples, AsyncResult]: samples kept for a resubmit

        def submit(samples):
            if _fault._ACTIVE and not self._thread_pool:
                _fault.dataloader_hook(self._pool)
            return [samples, self._apply(samples)]

        for _ in range(self._prefetch or 1):
            batch = next(it, None)
            if batch is None:
                break
            pending.append(submit(batch))
        while pending:
            samples, res = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                pending.append(submit(nxt))
            try:
                payload = self._supervised_get(res)
            except _WorkerLost:
                payload = self._recover(samples, pending)
            yield payload if self._thread_pool else pickle.loads(payload)

    def _supervised_get(self, res):
        """Wait for a batch, watching the pool's workers: a worker that
        dies mid-flight (OOM-killed, a native crash, an injected SIGKILL)
        takes its task with it, which would otherwise wait out the whole
        timeout.  Detected by a changed pid set (the pool replaces dead
        workers) or an exit code."""
        deadline = None if self._timeout is None \
            else time.monotonic() + self._timeout
        while True:
            res.wait(0.1)
            if res.ready():
                return res.get()  # re-raises a worker-side exception
            if self._thread_pool:
                continue          # a thread dies only by raising
            procs = list(self._pool._pool)
            if any(w.exitcode is not None for w in procs) or \
                    tuple(sorted(w.pid for w in procs)) != self._worker_pids:
                raise _WorkerLost()
            if deadline is not None and time.monotonic() >= deadline:
                raise RuntimeError(
                    "DataLoader worker timed out after %ds" % self._timeout)

    def _recover(self, samples, pending):
        """A worker died: rebuild the pool (once an epoch) and resubmit
        every batch not yet complete.  A batch is a function of its
        sample indices, so computing it again is safe."""
        if self._rebuilt:
            raise self._persistent_crash_error()
        self._rebuilt = True
        logging.getLogger("mxnet_tpu_torch.data").warning(
            "DataLoader worker died; rebuilding the %d-worker pool and "
            "resubmitting %d in-flight batch(es)", self._num_workers,
            1 + sum(1 for _, r in pending if not r.ready()))
        self._hard_terminate(self._pool)
        self._make_pool()
        _profiler.counter_bump("fault::worker_restarts", 1, cat="fault")
        # resubmits retry fetches already counted: they bypass the
        # injection hook, so they take no fresh fault occurrence
        for entry in pending:
            if not entry[1].ready():  # completed results stay valid
                entry[1] = self._apply(entry[0])
        try:
            return self._supervised_get(self._apply(samples))
        except _WorkerLost:
            raise self._persistent_crash_error() from None

    @staticmethod
    def _persistent_crash_error():
        return RuntimeError(
            "DataLoader worker died again after the pool was already "
            "rebuilt once; dataset workers are crashing persistently "
            "(check for OOM or a native crash in Dataset.__getitem__)")

    @staticmethod
    def _hard_terminate(pool):
        """Tear down a pool whose worker died violently.  A SIGKILLed
        worker can die holding the task queue's read lock, and
        ``Pool.terminate`` then blocks for ever; so the terminate runs in
        a daemon thread with a deadline, after which the remaining
        workers are SIGKILLed and the pool abandoned."""
        done = threading.Event()

        def _terminate():
            try:
                pool.terminate()
                pool.join()
            except Exception:
                pass
            finally:
                done.set()

        threading.Thread(target=_terminate, daemon=True,
                         name="dataloader-pool-reaper").start()
        if done.wait(5.0):
            return
        for w in list(getattr(pool, "_pool", []) or []):
            try:
                os.kill(w.pid, signal.SIGKILL)
            except (AttributeError, OSError, ProcessLookupError):
                pass            # a thread (no pid), or gone already
        done.wait(2.0)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Terminate and join the worker pool (idempotent; also on
        ``__del__`` and at the end of a ``with`` block)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            self._hard_terminate(pool)
            if not self._thread_pool:
                _unlink_all(self._token)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: modules half-gone
            pass
