"""The KVStore engine: a key -> value store with collective aggregation.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py``, with the reference's
arithmetic (``tests/nightly/dist_sync_kvstore.py``):

- ``init`` then ``push`` + ``pull``: the pulled value is the sum of the
  pushed values over the devices of the push and over the workers
  (``kvstore_dist_server.h:325``);
- with an optimizer (``set_optimizer``) or an updater (``set_updater``)
  a push updates the stored weight instead (``ApplyUpdates:346``), and a
  pull returns the updated weight;
- ``pushpull`` fuses the two, and its ``out`` always gets the fresh
  result of the call (``kvstore_local.h:209``).

A dist store sums over the ranks of the default process group with
``all_reduce`` (staged through pinned host memory for a CUDA tensor
under gloo); the launcher sets the group up
(``torch.distributed.init_process_group``).  A value is an ``NDArray``
or a tensor; ``out`` is written in place (a parameter's ``data()`` stays
the parameter's storage).

Each op goes through the fault runtime as the reference's
``_retrying`` does (``kvstore/kvstore.py:33-90``): the armed-fault seam
(``fault.kvstore_check``) fires at the entry of every attempt, and a
transient failure is retried with backoff (``fault.retry_call``,
counters ``fault::retries`` / ``fault::gave_up``); a push or pushpull
with an optimizer or updater retries only an entry-seam
``InjectedFault`` (a re-run would apply the gradient twice).  A store
over more than one worker never retries alone (a solo retry would
re-enter a collective its peers have left): its ops go through
``fault_dist.coordinated_call(op="KVStore.<op>", mutating=..,
lease=True)``, where every worker votes after each attempt and all
re-issue together, or all abort; under an active step lease the
success path skips the per-op vote.  A dist store joins the job from
the launcher's environment at construction (``MX_COORD_ADDR`` /
``MX_NUM_WORKERS`` / ``MX_WORKER_ID`` -> ``fault_dist.initialize``,
reference :102), and :func:`reset_distributed` forgets that join, the
elastic resize's seam (reference :132).  With ``profile_kvstore`` on,
the ops record the reference's spans (``KVStore::push`` / ``pull`` /
``pushpull`` / ``reduce``) and the ``kvstore::push_bytes`` /
``pull_bytes`` counters.
"""
from __future__ import annotations

import functools
import os
import pickle

import torch
import torch.distributed as dist

from .. import fault as _fault
from .. import profiler as _profiler
from ..ndarray.ndarray import NDArray
from ..utils.serialization import CorruptCheckpointError, atomic_write
from .base import KVStoreBase

__all__ = ["KVStore", "create", "reset_distributed"]

_TYPES = ("local", "device", "nccl", "dist_sync", "dist_device_sync",
          "dist_async", "dist", "p3", "horovod", "byteps")


def _retrying(op, mutating=False):
    """Run a store op under the fault runtime (module docstring)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            def attempt():
                _fault.kvstore_check(op)
                return fn(self, *args, **kwargs)
            is_mutating = mutating and (self._updater is not None
                                        or self._optimizer is not None)
            if self.num_workers > 1:
                from .. import fault_dist as _fdist
                return _fdist.coordinated_call(
                    attempt, op="KVStore.%s" % op, mutating=is_mutating,
                    lease=True)
            policy = _fault.entry_only_policy() if is_mutating \
                else _fault.mutating_policy()
            return _fault.retry_call(attempt, op="KVStore.%s" % op,
                                     policy=policy)
        return wrapper
    return deco


_dist_initialized = False


def _maybe_init_distributed():
    """Join the job from the launcher's environment (``MX_COORD_ADDR`` /
    ``MX_NUM_WORKERS`` / ``MX_WORKER_ID``) through the resilient
    bootstrap (``fault_dist.initialize``: retries with backoff, and with
    ``MXNET_FAULT_BOOTSTRAP_FALLBACK=1`` a degrade to one process).
    Without ``MX_COORD_ADDR`` the launcher made the process group (or
    there is none) and nothing happens."""
    global _dist_initialized
    if _dist_initialized:
        return
    coord = os.environ.get("MX_COORD_ADDR")
    if not coord:
        _dist_initialized = True
        return
    n = int(os.environ.get("MX_NUM_WORKERS", "1"))
    rank = int(os.environ.get("MX_WORKER_ID", "0"))
    if n > 1:
        from .. import fault_dist as _fdist
        _fdist.initialize(coordinator_address=coord, num_processes=n,
                          process_id=rank)
    # marked only on success: a raised BootstrapError leaves the next
    # create() free to retry the join
    _dist_initialized = True


def reset_distributed():
    """Forget this process's bootstrap, so the next dist store joins the
    CURRENT world: the elastic re-bootstrap's seam (``mx.fault.elastic``,
    ``Trainer.reset_kvstore``).  The store keeps no group of its own (it
    reduces over the default group), so the latch is all there is."""
    global _dist_initialized
    _dist_initialized = False


def _t(v):
    return v._data if isinstance(v, NDArray) else v


def _nbytes(value):
    """Payload bytes of a value or a per-device list of them."""
    return sum(_t(v).numel() * _t(v).element_size() for v in _aslist(value))


def _aslist(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _write(dst, src):
    """Copy ``src`` into ``dst`` in place, cast to ``dst``'s dtype."""
    d = _t(dst)
    with torch.no_grad():
        d.copy_(src.to(device=d.device, dtype=d.dtype))


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host_collective(t, op):
    """Run ``op`` on ``t`` in place, through pinned host memory when the
    group is gloo and ``t`` lies on a card; returns the result."""
    if dist.get_backend() == "gloo" and t.is_cuda:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        op(buf)
        return buf.to(t.device)
    buf = t.clone()
    op(buf)
    return buf


@KVStoreBase.register
class KVStore(KVStoreBase):
    """One engine for every reference kvstore type."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._opt_states = {}
        self._compression = None
        self._is_dist = kv_type.startswith("dist") or kv_type in (
            "horovod", "byteps", "p3")
        if self._is_dist:
            _maybe_init_distributed()

    @staticmethod
    def is_capable(capability):
        return capability in ("optimizer",)

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return _world()[0] if self._is_dist else 0

    @property
    def num_workers(self):
        return _world()[1] if self._is_dist else 1

    # -- core ops -------------------------------------------------------
    @staticmethod
    def _normalize(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            self._store[k] = NDArray(_t(_aslist(v)[0]).detach().clone())

    def _reduce(self, value, key=None):
        """Sum the per-device copies, pass the sum through the
        compression round trip (a pushed gradient of a known key), then
        sum over the workers."""
        prof_t0 = _profiler._now_us() if _profiler._KVSTORE else None
        vals = _aslist(value)
        acc = _t(vals[0]).detach().clone()
        for v in vals[1:]:
            acc = acc + _t(v).to(acc.device)
        if self._compression is not None and key is not None:
            acc = self._compression.roundtrip(key, acc)
        if self.num_workers > 1:
            acc = _host_collective(acc, dist.all_reduce)
        if prof_t0 is not None:
            _profiler.record_duration(
                "KVStore::reduce", "kvstore", prof_t0,
                _profiler._now_us() - prof_t0,
                args={"key": str(key), "devices": len(vals)})
        return acc

    def _apply(self, k, summed):
        """Update the stored weight of ``k`` by the updater or the
        optimizer, or store ``summed``; the fresh value."""
        stored = self._store[k]
        if self._updater is not None:
            self._updater(self._key_int(k), NDArray(summed), stored)
        elif self._optimizer is not None:
            self._apply_optimizer(k, stored, NDArray(summed))
        else:
            _write(stored, summed)
        return stored._data

    def _check_shape(self, op, k, summed):
        if tuple(summed.shape) != tuple(self._store[k].shape):
            raise ValueError(
                "%s key %r: value shape %s does not match stored shape %s"
                % (op, k, tuple(summed.shape), tuple(self._store[k].shape)))

    @_retrying("push", mutating=True)
    def push(self, key, value, priority=0):
        prof_t0 = _profiler._now_us() if _profiler._KVSTORE else None
        keys, values = self._normalize(key, value)
        if prof_t0 is not None:
            _profiler.counter_add("kvstore::push_bytes",
                                  sum(_nbytes(v) for v in values),
                                  cat="kvstore")
        for k, v in zip(keys, values):
            # the first push of an unseen key stores a value: never
            # compressed (the reference compresses gradient pushes only)
            summed = self._reduce(v, key=k if k in self._store else None)
            if k not in self._store:
                self._store[k] = NDArray(summed)
                continue
            self._check_shape("push", k, summed)
            self._apply(k, summed)
        if prof_t0 is not None:
            _profiler.record_duration(
                "KVStore::push", "kvstore", prof_t0,
                _profiler._now_us() - prof_t0, args={"keys": len(keys)})

    @_retrying("pull")
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        prof_t0 = _profiler._now_us() if _profiler._KVSTORE else None
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise KeyError("key %s has not been initialized" % k)
            for dst in _aslist(o):
                _write(dst, self._store[k]._data)
        if prof_t0 is not None:
            _profiler.counter_add("kvstore::pull_bytes",
                                  sum(_nbytes(o) for o in outs),
                                  cat="kvstore")
            _profiler.record_duration(
                "KVStore::pull", "kvstore", prof_t0,
                _profiler._now_us() - prof_t0, args={"keys": len(keys)})

    @_retrying("pushpull", mutating=True)
    def pushpull(self, key, value, out=None, priority=0):
        """Fused push and pull: ``out`` gets the fresh aggregate, or the
        updated weight with an updater / optimizer."""
        prof_t0 = _profiler._now_us() if _profiler._KVSTORE else None
        keys, values = self._normalize(key, value)
        if prof_t0 is not None:
            _profiler.counter_add("kvstore::push_bytes",
                                  sum(_nbytes(v) for v in values),
                                  cat="kvstore")
        fresh = {}
        for k, v in zip(keys, values):
            summed = self._reduce(v, key=k if k in self._store else None)
            if k in self._store:
                self._check_shape("pushpull", k, summed)
                fresh[k] = self._apply(k, summed)
            else:
                self._store[k] = NDArray(summed)
                fresh[k] = summed
        if out is not None:
            _, outs = self._normalize(key, out)
            for k, o in zip(keys, outs):
                for dst in _aslist(o):
                    _write(dst, fresh[k])
            if prof_t0 is not None:
                _profiler.counter_add("kvstore::pull_bytes",
                                      sum(_nbytes(o) for o in outs),
                                      cat="kvstore")
        if prof_t0 is not None:
            _profiler.record_duration(
                "KVStore::pushpull", "kvstore", prof_t0,
                _profiler._now_us() - prof_t0, args={"keys": len(keys)})

    @_retrying("broadcast")
    def broadcast(self, key, value, out, priority=0):
        """Worker 0's value to every worker, stored, then into ``out``."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            src = _t(_aslist(v)[0]).detach()
            if self.num_workers > 1:
                src = _host_collective(src, lambda b: dist.broadcast(b, 0))
            self._store[k] = NDArray(src.clone())
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of the stored value, zeros elsewhere
        (reference ``PullRowSparseImpl``, dense storage).  ``row_ids`` is
        an array of row indices (a ``CSRNDArray``'s ``indices`` too; a
        repeated row is pulled once) or a ``RowSparseNDArray``, whose
        rows are its ``indices``."""
        if row_ids is None:
            return self.pull(key, out, priority)
        keys, outs = self._normalize(key, out)
        rids = row_ids if isinstance(row_ids, (list, tuple)) \
            else [row_ids] * len(keys)
        for k, o, r in zip(keys, outs, rids):
            src = self._store[k]._data
            if getattr(r, "stype", "default") == "row_sparse":
                r = r.indices
            idx = _t(r).long().reshape(-1).to(src.device)
            new = torch.zeros_like(src)
            new[idx] = src[idx]
            for dst in _aslist(o):
                _write(dst, new)

    # -- optimizer on the store (server-side update) ----------------------
    def set_optimizer(self, optimizer):
        self._optimizer = optimizer

    def _apply_optimizer(self, k, weight, grad):
        if k not in self._opt_states:
            self._opt_states[k] = \
                self._optimizer.create_state_multi_precision(
                    self._key_int(k), weight)
        self._optimizer.update_multi_precision(
            [self._key_int(k)], [weight], [grad], [self._opt_states[k]])

    @staticmethod
    def _key_int(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return abs(hash(k)) % (2 ** 31)

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def set_gradient_compression(self, compression_params):
        """2-bit / 1-bit quantization with error feedback of every
        gradient push's local sum, before the sum over workers."""
        from .compression import GradientCompression
        self._compression = GradientCompression(compression_params)

    def barrier(self):
        if self.num_workers > 1:
            dist.barrier()

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The server-side optimizer states and update counts, pickled
        as numpy (the reference's payload)."""
        from ..optimizer.optimizer import Updater
        payload = {k: Updater._dump_tree(st)
                   for k, st in self._opt_states.items()}
        counts = (dict(self._optimizer._index_update_count),
                  self._optimizer.num_update) \
            if self._optimizer is not None else ({}, 0)
        with atomic_write(fname) as f:
            if dump_optimizer:
                pickle.dump((payload, counts, self._optimizer), f)
            else:
                pickle.dump((payload, counts), f)

    def load_optimizer_states(self, fname):
        """Restore :meth:`save_optimizer_states`' file: a restored
        server resumes its momentum / Adam states."""
        from ..optimizer.optimizer import Updater
        try:
            with open(fname, "rb") as f:
                obj = pickle.load(f)
        except (EOFError, pickle.UnpicklingError, ValueError) as e:
            raise CorruptCheckpointError(
                "corrupt optimizer-state file %r: %s" % (fname, e)) from e
        counts = None

        def _is_counts(c):
            return isinstance(c, tuple) and len(c) == 2 and \
                isinstance(c[0], dict) and isinstance(c[1], int)

        if isinstance(obj, tuple) and len(obj) == 3:
            payload, counts, self._optimizer = obj
        elif isinstance(obj, tuple) and len(obj) == 2 and _is_counts(obj[1]):
            payload, counts = obj
        elif isinstance(obj, tuple) and len(obj) == 2:
            payload, self._optimizer = obj
        else:
            payload = obj
        device = next((v._data.device for v in self._store.values()), None)
        self._opt_states = {k: Updater._load_tree(v, device)
                            for k, v in payload.items()
                            if not isinstance(v, list)}
        if counts is not None and self._optimizer is not None:
            idx_counts, num_update = counts
            cur = self._optimizer._index_update_count
            for idx, c in idx_counts.items():
                cur[idx] = max(cur.get(idx, 0), c)
            self._optimizer.num_update = max(self._optimizer.num_update,
                                             num_update)


def create(name="local"):
    """``mx.kv.create`` (reference ``kvstore.cc:42``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _TYPES and name.lower() not in KVStoreBase.kv_registry:
        raise ValueError("unknown KVStore type %s" % name)
    if name.lower() in KVStoreBase.kv_registry and name not in _TYPES:
        return KVStoreBase.kv_registry[name.lower()]()
    return KVStore(name)
