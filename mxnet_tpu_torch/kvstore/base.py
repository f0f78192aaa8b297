"""KVStore plugin registry (reference ``mxnet_tpu/kvstore/base.py``)."""
from __future__ import annotations

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Abstract KVStore interface; subclasses register by name."""

    kv_registry = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        KVStoreBase.kv_registry[name] = klass
        return klass

    @staticmethod
    def is_capable(capability):
        raise NotImplementedError

    # interface
    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    @property
    def rank(self):
        raise NotImplementedError

    @property
    def num_workers(self):
        raise NotImplementedError

    OPTIMIZER = "optimizer"

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError
