"""``mx.kv``: the KVStore over ``torch.distributed``.

Counterpart of ``mxnet_tpu/kvstore``.  Every reference type name maps
to one engine (:class:`~.kvstore.KVStore`) with a different aggregation
scope:

- ``local`` / ``device`` / ``nccl``: one process; a push of a list of
  per-device values sums them;
- ``dist_sync`` / ``dist_device_sync`` / ``dist`` / ``p3`` /
  ``horovod`` / ``byteps``: that sum is then summed over the ranks of
  the default process group (``all_reduce``; under gloo a CUDA tensor is
  staged through pinned host memory), and ``rank`` / ``num_workers``
  are the group's;
- ``dist_async``: accepted and run synchronously, as in the reference.

``KVStoreBase.register`` plugs in a user's store by class name.
"""
from .base import KVStoreBase  # noqa: F401
from .kvstore import KVStore, create  # noqa: F401
