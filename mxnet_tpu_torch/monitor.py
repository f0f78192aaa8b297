"""``mx.monitor``: a tensor-level training monitor for NaN debugging.

Reference parity: ``python/mxnet/monitor.py`` (``Monitor``: ``interval``,
``stat_func``, ``pattern``, ``sort``; ``install`` / ``tic`` / ``toc`` /
``toc_print``).  ``install(block)`` walks the block tree and registers
one Gluon forward hook per block (``gluon/block.py
register_forward_hook``), so every layer's output is captured under its
structural name: the lower-cased root class name, then ``"." + child
name`` down the tree, with ``_output`` (``_output%d`` for several
outputs) and, with ``monitor_all``, ``_input%d`` suffixes.

Semantics kept from the reference:

- ``tic()`` activates collection only every ``interval``-th call and
  clears the queue; ``toc()`` also takes the stat of every parameter
  matching ``pattern`` (and, with ``monitor_all``, of its gradient),
  deactivates, and returns ``[(step, name, stat_string), ...]``.
- The default stat is the mean absolute value (``|x|.sum() / x.size``,
  the reference's ``asum_stat``), which propagates NaN: the first layer
  whose output went NaN is visible at once in ``toc_print()``.

Where the port differs:

- The default stat stays on the device: each hook queues a
  :class:`DeviceStat`, the float32 sum of ``|x|`` computed where the
  output lives (``torch._foreach_norm``), with no host sync; ``toc()``
  takes all the parameters' sums with one such call per device and
  dtype, brings every sum to the host in one transfer per device
  (:data:`TRANSFERS` counts them) and divides there.  A user
  ``stat_func`` still receives a numpy array, as the reference's
  contract says, and pays its own copy (bfloat16 arrives as float32:
  numpy has no bfloat16).
- A hybridized block on the card runs as a CUDA graph: its warm-ups
  and its capture queue nothing (``cuda_ops.capturing()``), and a
  replay runs no Python for the blocks inside it, so only the
  hybridized block's own output is seen at a replay.  Monitor eagerly,
  or hybridize after debugging, as the reference advises for its
  jit-traced blocks.
"""
from __future__ import annotations

import math
import re

import numpy as _onp
import torch

from .gluon import parameter as _param
from .ndarray.ndarray import NDArray
from .ops import cuda_ops as _cuda_ops

__all__ = ["Monitor", "DeviceStat", "TRANSFERS"]

#: device-to-host transfers ``toc()`` made for the default stat, one per
#: device a batch's stats lived on
TRANSFERS = {"count": 0}


class DeviceStat:
    """The default stat while it is still on the device: ``total``, the
    float32 sum of ``|x|`` (a 0-d tensor), over ``size`` elements;
    ``toc()`` divides on the host, as the reference's ``asum_stat``
    does."""

    __slots__ = ("total", "size")

    def __init__(self, total, size):
        self.total, self.size = total, size


def _floating(x):
    x = x.detach()
    return x if x.is_floating_point() or x.is_complex() else x.float()


def asum_stat(x):
    """:class:`DeviceStat` of ``x`` on its device, no host sync."""
    return _asum_stats([x])[0]


def _asum_stats(tensors):
    """:class:`DeviceStat` of each tensor: one multi-tensor L1-norm call
    per (device, dtype) group.  On CUDA that call reads each bf16 / fp16
    input once, sums in float32 and writes float32 (``linalg.vector_norm``
    with ``dtype=`` would first write a float32 copy of the input)."""
    tensors = [_floating(t) for t in tensors]
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = [None] * len(tensors)
    for idx in groups.values():
        totals = torch._foreach_norm([tensors[i] for i in idx], 1,
                                     dtype=torch.float32)
        for i, total in zip(idx, totals):
            out[i] = DeviceStat(total, tensors[i].numel())
    return out


def _host(t):
    """``t`` as a numpy array (bfloat16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Monitor:
    """Monitor outputs, weights, and gradients for debugging.

    Parameters
    ----------
    interval : int
        Number of batches between collections (``tic`` calls).
    stat_func : callable, optional
        Maps a numpy array to a statistic.  Default: the mean absolute
        value, computed on the device.
    pattern : str
        Regex; only tensor names matching it are collected.
    sort : bool
        Sort the output of ``toc`` by tensor name.
    monitor_all : bool
        Also capture block *inputs* and parameter gradients.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.stat_func = stat_func
        self.interval = interval
        self.sort = sort
        self.monitor_all = monitor_all
        self.queue = []
        self.step = 0
        self.activated = False
        self.re_prog = re.compile(pattern)
        self._blocks = []
        self._handles = []

    # -- collection -------------------------------------------------------
    def stat_helper(self, name, array):
        """Queue the stat of ``array`` under ``name`` if activated and the
        name matches the pattern (reference ``Monitor.stat_helper``).
        Nothing is queued while a CUDA graph is being captured."""
        if not self.activated or not self.re_prog.match(name):
            return
        if _cuda_ops.capturing():
            return      # warm-up or capture: replays would not see it
        array = _tensor(array)
        if self.stat_func is None:
            stat = asum_stat(array)
        else:
            stat = self.stat_func(_host(array))
        self.queue.append((self.step, name, stat))

    def _hook(self, name):
        def forward_hook(block, inputs, outputs):
            if not self.activated:
                return
            if self.monitor_all:
                for i, x in enumerate(_flatten(inputs)):
                    self.stat_helper("%s_input%d" % (name, i), x)
            outs = _flatten(outputs)
            for i, x in enumerate(outs):
                suffix = "_output" if len(outs) == 1 else "_output%d" % i
                self.stat_helper(name + suffix, x)
        return forward_hook

    def install(self, block, monitor_all=None):
        """Register forward hooks on ``block`` and every descendant.
        Returns the hook handles (``detach()`` removes one)."""
        if monitor_all is not None:
            self.monitor_all = monitor_all
        handles = []
        root = type(block).__name__.lower()

        def walk(blk, path):
            handles.append(blk.register_forward_hook(self._hook(path)))
            for cname, child in blk.named_children():
                walk(child, path + "." + cname)

        walk(block, root)
        self._blocks.append(block)
        self._handles.extend(handles)
        return handles

    def uninstall(self):
        """Detach every hook this monitor registered."""
        for h in self._handles:
            (h.detach if hasattr(h, "detach") else h.remove)()
        self._handles = []
        self._blocks = []

    # -- tic/toc ----------------------------------------------------------
    def tic(self):
        """Start collecting stats for the upcoming batch if this step is on
        the interval (reference ``Monitor.tic``)."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """End collection: add parameter stats, return the batch's results
        as ``[(step, name, stat_string), ...]``."""
        if not self.activated:
            return []
        named = []
        for block in self._blocks:
            for name, p in block.collect_params().items():
                if _param.is_deferred(p) or not self.re_prog.match(name):
                    continue
                named.append((name, p.detach()))
                g = _param.grad_of(p)
                if self.monitor_all and g is not None:
                    named.append((name + "_grad", g))
        if self.stat_func is None:
            self.queue.extend(
                (self.step, name, stat) for (name, _), stat in
                zip(named, _asum_stats([t for _, t in named])))
        else:
            for name, t in named:
                self.stat_helper(name, t)
        self.activated = False
        queue = _to_host(self.queue)
        if self.sort:
            queue.sort(key=lambda x: x[1])
        res = []
        for step, name, stat in queue:
            if isinstance(stat, NDArray):
                stat = stat.asnumpy()
            if isinstance(stat, _onp.ndarray) and stat.size == 1:
                stat = stat.reshape(()).item()
            if isinstance(stat, float):
                out = "nan" if math.isnan(stat) else "%.8g" % stat
            else:
                out = str(stat)
            res.append((step, name, out))
        self.queue = []
        return res

    def toc_print(self):
        """End collection and print everything (reference
        ``Monitor.toc_print``)."""
        res = self.toc()
        for step, name, stat in res:
            print("Batch: %7d %30s %s" % (step, name, stat))
        return res


def _to_host(queue):
    """The queue with every :class:`DeviceStat` replaced by its mean as a
    Python float: one stacked copy to the host per device."""
    by_dev = {}
    for i, (_, _, stat) in enumerate(queue):
        if isinstance(stat, DeviceStat):
            by_dev.setdefault(stat.total.device, []).append(i)
    out = list(queue)
    for idx in by_dev.values():
        totals = torch.stack([queue[i][2].total for i in idx]).cpu()
        TRANSFERS["count"] += 1
        for i, v in zip(idx, totals.numpy().tolist()):
            step, name, stat = queue[i]
            out[i] = (step, name, v / max(stat.size, 1))
    return out


def _tensor(array):
    if isinstance(array, NDArray):
        return array._data
    if isinstance(array, torch.Tensor):
        return array
    return torch.as_tensor(_onp.asarray(array))


def _flatten(x):
    if isinstance(x, (list, tuple)):
        out = []
        for v in x:
            out.extend(_flatten(v))
        return out
    return [x] if isinstance(x, (torch.Tensor, NDArray)) else []
