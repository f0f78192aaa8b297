"""Sequence-sharded input: each rank reads only its own tokens.

Counterpart of ``mxnet_tpu/parallel/seq_data.py`` (:37-282).
:func:`shard_token_indices` is the layout contract: shard ``r`` of ``n``
holds the global tokens ``offset + stride * arange(count)`` (striped:
``(r, n, T/n)``; roundrobin: ``(r*T/n, 1, T/n)``), the order in which
``parallel.ring`` shards a sequence.  The JAX package assembles a global
sharded array from per-shard reads; here there is no global array, so
:func:`make_sequence_array` returns this rank's shard, read through
``read_fn`` with this rank's token positions alone.  That shard is what
``ring_attention_local`` takes under ``mesh_scope(mesh)``: the same as
``ring_attention_sharded(..., permute_inputs=False)`` on the striped
global array, and no rank ever holds the whole sequence.
"""
from __future__ import annotations

import numpy as onp
import torch

from .ring import LAYOUTS, ring_axes, ring_size

__all__ = ["shard_token_indices", "token_shards", "make_sequence_array",
           "SeqShardLoader", "EpochPlan"]


def shard_token_indices(shard, n_shards, seq_len, layout="striped"):
    """(offset, stride, count) of the global token positions of shard
    ``shard`` of ``n_shards``."""
    if layout not in LAYOUTS:
        raise ValueError("unknown layout %r" % (layout,))
    if seq_len % n_shards:
        raise ValueError("sequence length %d not divisible by %d shards"
                         % (seq_len, n_shards))
    count = seq_len // n_shards
    if layout == "striped":
        return shard, n_shards, count
    return shard * count, 1, count


def token_shards(n_shards, seq_len, layout="striped"):
    """Every shard's (shard, offset, stride, count): the whole read
    plan."""
    return [(s,) + shard_token_indices(s, n_shards, seq_len, layout)
            for s in range(n_shards)]


def make_sequence_array(read_fn, shape, mesh, axis_name="cp",
                        layout="striped", seq_axis=-2, dtype=None,
                        batch_axis=None, batch_dim=0):
    """This rank's shard of a sequence-sharded array of global ``shape``.

    ``read_fn(indices)`` gets a 1-D numpy array of global token
    positions (this rank's, per :func:`shard_token_indices`; outer-major
    over an (outer, inner) ring) and returns the values of those tokens:
    an array shaped like ``shape`` with the sequence axis ``len(indices)``
    long.  It is called once, never with the whole sequence.  With
    ``batch_axis`` the shard is also this rank's block of ``batch_dim``.
    The result is a tensor on ``mesh.device``."""
    n_total = ring_size(mesh, axis_name)
    seq_axis = seq_axis % len(shape)
    T = shape[seq_axis]
    axes = ring_axes(axis_name)
    shard = mesh.axis_index(axes[0] if len(axes) == 1 else axes)
    off, stride, count = shard_token_indices(shard, n_total, T, layout)
    vals = onp.asarray(read_fn(off + stride * onp.arange(count)))
    want = list(shape)
    want[seq_axis] = count
    if list(vals.shape) != want:
        raise ValueError("read_fn returned shape %s for %d tokens, want %s"
                         % (vals.shape, count, tuple(want)))
    if batch_axis is not None:
        nb = mesh.axis_size(batch_axis)
        size = shape[batch_dim] // nb
        lo = mesh.axis_index(batch_axis) * size
        vals = onp.take(vals, onp.arange(lo, lo + size), axis=batch_dim)
    if dtype is not None:
        vals = vals.astype(dtype)
    return torch.from_numpy(onp.ascontiguousarray(vals)).to(mesh.device)


class SeqShardLoader:
    """Step iterator over sequence-sharded batches: each ``next()`` is
    this rank's shard (:func:`make_sequence_array`) read by
    ``read_fn(step, indices)``."""

    def __init__(self, read_fn, shape, mesh, axis_name="cp",
                 layout="striped", seq_axis=-2, dtype=None,
                 batch_axis=None, batch_dim=0, steps=None):
        self.read_fn = read_fn
        self.shape = tuple(shape)
        self.mesh = mesh
        self.axis_name = axis_name
        self.layout = layout
        self.seq_axis = seq_axis
        self.dtype = dtype
        self.batch_axis = batch_axis
        self.batch_dim = batch_dim
        self.steps = steps
        # a bad layout or length fails here, not at step N
        shard_token_indices(0, ring_size(mesh, axis_name),
                            self.shape[seq_axis % len(self.shape)], layout)

    def __iter__(self):
        step = 0
        while self.steps is None or step < self.steps:
            yield self.load(step)
            step += 1

    def load(self, step):
        return make_sequence_array(
            lambda idx: self.read_fn(step, idx), self.shape, self.mesh,
            axis_name=self.axis_name, layout=self.layout,
            seq_axis=self.seq_axis, dtype=self.dtype,
            batch_axis=self.batch_axis, batch_dim=self.batch_dim)


class EpochPlan:
    """Deterministic read plan over one epoch of ``total`` global sample
    indices that visits every index in ``[start, total)`` exactly once
    across changes of the world size.

    Each step takes one window of ``world * batch_per_rank`` indices off
    the cursor, split over the ranks: striped (rank ``r`` reads
    ``cursor + r + world*k``) or roundrobin (contiguous slabs).  A short
    last window gives the first ``window % world`` ranks one more.
    :meth:`resize` replays the rest of the range under the new world;
    every member calls it at the same step boundary.  The plan is
    replicated state, advanced identically on every rank."""

    def __init__(self, total, world, batch_per_rank, layout="striped",
                 start=0):
        if layout not in LAYOUTS:
            raise ValueError("unknown layout %r" % (layout,))
        self.total = int(total)
        self.world = int(world)
        self.batch_per_rank = int(batch_per_rank)
        self.layout = layout
        self.cursor = int(start)
        if self.world < 1 or self.batch_per_rank < 1:
            raise ValueError("world and batch_per_rank must be >= 1")
        if not 0 <= self.cursor <= self.total:
            raise ValueError("start %d outside [0, %d]"
                             % (self.cursor, self.total))

    def remaining(self):
        return self.total - self.cursor

    def done(self):
        return self.cursor >= self.total

    def _counts(self, window):
        base, extra = divmod(window, self.world)
        return [base + (1 if r < extra else 0) for r in range(self.world)]

    def step_indices(self):
        """Every rank's indices for this step (a list of 1-D numpy
        arrays); advances the cursor by the window."""
        window = min(self.world * self.batch_per_rank, self.remaining())
        counts = self._counts(window)
        out = []
        if self.layout == "striped":
            for r in range(self.world):
                out.append(self.cursor + r
                           + self.world * onp.arange(counts[r]))
        else:
            off = self.cursor
            for r in range(self.world):
                out.append(off + onp.arange(counts[r]))
                off += counts[r]
        self.cursor += window
        return out

    def next_for(self, rank):
        """This rank's indices for this step; call once a step."""
        if not 0 <= int(rank) < self.world:
            raise ValueError("rank %d outside world %d" % (rank, self.world))
        return self.step_indices()[int(rank)]

    def resize(self, world, batch_per_rank=None, layout=None):
        """The world changed: replay the rest under the new stride."""
        world = int(world)
        if world < 1:
            raise ValueError("world must be >= 1")
        self.world = world
        if batch_per_rank is not None:
            self.batch_per_rank = int(batch_per_rank)
        if layout is not None:
            if layout not in LAYOUTS:
                raise ValueError("unknown layout %r" % (layout,))
            self.layout = layout
        return self

    def __repr__(self):
        return ("EpochPlan(total=%d, world=%d, per=%d, layout=%s, "
                "cursor=%d)" % (self.total, self.world, self.batch_per_rank,
                                self.layout, self.cursor))
