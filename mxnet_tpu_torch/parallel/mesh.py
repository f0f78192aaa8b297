"""Meshes over ``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel/mesh.py`` (``create_mesh`` :21,
``shrink_mesh`` :47, ``grow_mesh`` :77, ``local_mesh`` :108,
``current_mesh`` :118, ``mesh_scope`` :123).  A JAX mesh is devices
reshaped to named axes; here it is ranks of the default process group
(all of them, or the ``ranks=`` given) reshaped to named axes, in
row-major order (the last axis varies fastest), with one process
subgroup per axis line through this rank, which the collectives of
:mod:`._compat` run over.  A rank outside the mesh takes no part in it
(``mesh.is_member`` is False, it has no coordinates), but it must still
build the mesh: ``torch.distributed.new_group`` is called by every live
process, members or not, in the same order.

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

__all__ = ["Mesh", "create_mesh", "shrink_mesh", "grow_mesh", "local_mesh",
           "current_mesh", "mesh_scope"]

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
    ``line[axis]`` its global ranks in axis order; ``group`` is the
    process group of the whole mesh (None on one rank).  On a rank
    outside the mesh ``is_member`` is False and ``coords`` / ``groups``
    / ``line`` are empty."""

    def __init__(self, names, sizes, device, ranks=None):
        rank, world = _world()
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        self.size = int(onp.prod(sizes)) if sizes else 1
        members = list(range(self.size)) if ranks is None \
            else [int(r) for r in ranks]
        self.ranks = onp.asarray(members).reshape(sizes)
        self.rank = rank
        self.device = device
        self.backend = dist.get_backend() if world > 1 else None
        self.is_member = rank in members
        here = onp.argwhere(self.ranks == rank)
        self.coords = dict(zip(names, (int(c) for c in here[0]))) \
            if self.is_member else {}
        self.group = self._new_group(members, world)
        self.groups, self.line = {}, {}
        for i, name in enumerate(names):
            # every rank makes every line's group, in one order, as
            # new_group requires; it keeps the one through itself
            others = [range(s) for j, s in enumerate(sizes) if j != i]
            for idx in itertools.product(*others):
                key = list(idx)
                key.insert(i, slice(None))
                line = [int(r) for r in self.ranks[tuple(key)]]
                group = self._new_group(line, world)
                if rank in line:
                    self.groups[name], self.line[name] = group, line

    @staticmethod
    def _new_group(line, world):
        if len(line) <= 1:
            return None
        if sorted(line) == list(range(world)):
            return dist.group.WORLD
        return dist.new_group(line)

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

    def member_ranks(self):
        """The mesh's global ranks in row-major order."""
        return [int(r) for r in self.ranks.reshape(-1)]

    def __repr__(self):
        return "Mesh(%s, rank=%d, device=%s%s)" % (
            self.shape, self.rank, self.device,
            "" if self.is_member else ", not a member")


def _mesh_device(device, rank):
    if device is not None:
        return resolve_device(device)
    if current_context().device_type == "cpu":
        return torch.device("cpu")
    dev = resolve_device("cuda")             # raises without a card
    return torch.device(dev.type, rank % torch.cuda.device_count())


def create_mesh(axes=None, ranks=None, device=None, **axis_sizes):
    """A :class:`Mesh` over ranks of the default process group.

    ``create_mesh(dp=2, tp=4)`` or ``create_mesh({'dp': 2, 'tp': 4})``.
    ``ranks`` (default: every rank) are the global ranks to lay out; an
    axis size of -1 absorbs the remaining ones, and the mesh takes the
    first ``prod(sizes)`` of them, as the JAX mesh takes the first
    devices.  Every rank of the world calls this, in the same order,
    members or not."""
    if isinstance(axes, dict):
        axis_sizes = axes
    elif axes is not None and not axis_sizes:
        axis_sizes = dict(axes)
    rank, world = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    bad = [r for r in ranks if not 0 <= r < world]
    if bad or len(set(ranks)) != len(ranks):
        raise ValueError("ranks %s: each must be a distinct rank of the "
                         "%d-rank process group" % (ranks, world))
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = int(onp.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(ranks) // known
    total = int(onp.prod(sizes))
    if total > len(ranks):
        raise ValueError("mesh %s needs %d ranks, have %d"
                         % (dict(zip(names, sizes)), total, len(ranks)))
    return Mesh(names, sizes, _mesh_device(device, rank), ranks[:total])


def _resized(mesh, ranks, axis, what):
    """``mesh``'s axes over ``ranks``, ``axis`` (default the first)
    taking up the change, the others keeping their sizes."""
    rank, world = _world()
    ranks = list(range(world)) if ranks is None else list(ranks)
    sizes = dict(mesh.shape)
    axis = mesh.axis_names[0] if axis is None else axis
    if axis not in sizes:
        raise ValueError("mesh has no axis %r (axes: %s)"
                         % (axis, list(mesh.axis_names)))
    fixed = int(onp.prod([s for a, s in sizes.items() if a != axis]))
    if len(ranks) < fixed:
        raise ValueError("cannot %s mesh %s onto %d rank(s): the non-%s "
                         "axes alone need %d" % (what, sizes, len(ranks),
                                                 axis, fixed))
    sizes[axis] = len(ranks) // fixed
    return create_mesh(sizes, ranks=ranks, device=mesh.device)


def shrink_mesh(mesh, ranks=None, axis=None):
    """``mesh``'s layout over a smaller set of surviving ``ranks``
    (default every rank of the world): the named axis (default the
    first, by convention the data-parallel one) absorbs the change, the
    other axes keep their sizes, and ranks beyond the largest multiple
    of the fixed axes' product idle (outside the new mesh).  Every rank
    of the world calls it, members of the result or not."""
    return _resized(mesh, ranks, axis, "shrink")


def grow_mesh(mesh, ranks=None, axis=None):
    """:func:`shrink_mesh`'s counterpart, over a larger set of ``ranks``
    (ranks that joined the mesh again); the same recompute."""
    return _resized(mesh, ranks, axis, "grow")


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
