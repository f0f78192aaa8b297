"""Meshes over ``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (``create_mesh`` :21,
``local_mesh`` :108, ``current_mesh`` :118, ``mesh_scope`` :123).  A
JAX mesh is the devices reshaped to named axes; here it is the ranks of
the default process group reshaped to named axes, in row-major order
(the last axis varies fastest), with one process subgroup per axis line
through this rank, which the collectives of :mod:`._compat` run over.

Whoever launches the job picks the backend (NCCL or gloo) in
``torch.distributed.init_process_group``; the mesh uses the default
group's.  Without a process group the mesh has one rank, every axis has
size 1 and every collective is the identity, so the same code runs.

The mesh's ``device`` follows the device rule: ``cuda:(rank %
device_count)``, raising without a card, unless the caller asks for the
CPU (``device="cpu"``, or the current context is the CPU).
"""
from __future__ import annotations

import itertools
import threading
from contextlib import contextmanager

import numpy as onp
import torch
import torch.distributed as dist

from ..context import current_context, resolve_device

__all__ = ["Mesh", "create_mesh", "local_mesh", "current_mesh", "mesh_scope"]

_STATE = threading.local()


def _world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Named axes over process ranks.

    ``shape`` maps each axis name to its size, in order; ``ranks`` is
    the array of global ranks in that shape; ``coords`` is this rank's
    index along each axis; ``groups[axis]`` is the process group of the
    axis line through this rank (None on a one-rank mesh) and
    ``line[axis]`` its global ranks in axis order."""

    def __init__(self, names, sizes, device):
        rank, world = _world()
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = int(onp.prod(sizes)) if sizes else 1
        self.ranks = onp.arange(self.size).reshape(sizes)
        self.rank = rank
        self.device = device
        self.backend = dist.get_backend() if world > 1 else None
        here = onp.argwhere(self.ranks == rank)
        if not len(here):
            raise ValueError("rank %d is outside mesh %s" % (rank,
                                                            self.shape))
        self.coords = dict(zip(names, (int(c) for c in here[0])))
        self.groups, self.line = {}, {}
        for i, name in enumerate(names):
            # every rank makes every line's group, in one order, as
            # new_group requires; it keeps the one through itself
            others = [range(s) for j, s in enumerate(sizes) if j != i]
            for idx in itertools.product(*others):
                key = list(idx)
                key.insert(i, slice(None))
                line = [int(r) for r in self.ranks[tuple(key)]]
                group = None
                if len(line) > 1:
                    group = dist.group.WORLD if len(line) == world \
                        else dist.new_group(line)
                if rank in line:
                    self.groups[name], self.line[name] = group, line

    def axis_size(self, axis):
        """Size of one axis, or the product over a tuple of axes."""
        if isinstance(axis, (tuple, list)):
            return int(onp.prod([self.shape[a] for a in axis]))
        return self.shape[axis]

    def axis_index(self, axis):
        """This rank's index along one axis, or along a tuple of axes
        read outer-major (the first axis varies slowest)."""
        if isinstance(axis, (tuple, list)):
            idx = 0
            for a in axis:
                idx = idx * self.shape[a] + self.coords[a]
            return idx
        return self.coords[axis]

    def __repr__(self):
        return "Mesh(%s, rank=%d, device=%s)" % (self.shape, self.rank,
                                                 self.device)


def _mesh_device(device, rank):
    if device is not None:
        return resolve_device(device)
    if current_context().device_type == "cpu":
        return torch.device("cpu")
    dev = resolve_device("cuda")             # raises without a card
    return torch.device(dev.type, rank % torch.cuda.device_count())


def create_mesh(axes=None, device=None, **axis_sizes):
    """A :class:`Mesh` over the default process group's ranks.

    ``create_mesh(dp=2, tp=4)`` or ``create_mesh({'dp': 2, 'tp': 4})``.
    An axis size of -1 absorbs the remaining ranks.  The sizes must
    multiply to the world size."""
    if isinstance(axes, dict):
        axis_sizes = axes
    elif axes is not None and not axis_sizes:
        axis_sizes = dict(axes)
    rank, world = _world()
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = int(onp.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(onp.prod(sizes)) != world:
        raise ValueError("mesh %s needs %d ranks, the process group has %d"
                         % (dict(zip(names, sizes)), int(onp.prod(sizes)),
                            world))
    return Mesh(names, sizes, _mesh_device(device, rank))


def local_mesh(*names, device=None):
    """One axis per name over every rank (the first axis gets all)."""
    names = names or ("dp",)
    return create_mesh({n: (-1 if i == 0 else 1)
                        for i, n in enumerate(names)}, device=device)


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextmanager
def mesh_scope(mesh):
    """Make ``mesh`` the current mesh inside the scope (what the
    collectives of :mod:`._compat` read when given no mesh)."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev
