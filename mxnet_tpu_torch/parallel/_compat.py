"""Collectives over a :class:`~.mesh.Mesh`'s axes, and a ``shard_map``.

Counterpart of ``mxnet_tpu/parallel/_compat.py`` (``axis_size`` :14,
``shard_map`` :25) and of the ``lax`` collectives its callers use:
``axis_index``, ``ppermute``, ``psum``, ``psum_scatter`` and
``all_gather``.  Each takes the mesh, or reads the current one
(:func:`~.mesh.mesh_scope`; :func:`shard_map` sets it around its body).
An axis may be one name or a tuple of names, read outer-major.

The collectives are explicit, each a ``torch.autograd.Function`` whose
backward is the conjugate collective (GSPMD would insert them from
sharding specs; the port's kernels take plain local tensors, so the
callers place them by hand):

* ``psum`` / ``psum_grad`` for ranks that hold the same loss (tensor
  parallelism): the sum's gradient is the cotangent itself, and the
  entry of a replicated tensor into partial work sums its gradient;
* :func:`psum_partial` for ranks that each hold part of the loss (data
  parallelism: BatchNorm's batch moments): sum forward and backward;
* ``all_gather`` (backward: ``psum_scatter``, the rank's own slice of
  the cotangents summed over the ranks that read it) and
  ``psum_scatter`` (backward: ``all_gather``).  gloo has no
  ``reduce_scatter``: there ``psum_scatter`` is an ``all_reduce`` and
  the rank's own slice; NCCL runs ``reduce_scatter_tensor``;
* :func:`gather` / :func:`split` for replicated activations (a
  column-parallel output): the gather's gradient is the rank's own
  slice of a cotangent every rank holds whole, the split's the gather.

Transport is chosen by the backend of the process group:

* NCCL takes CUDA tensors: ``ppermute`` is one ``batch_isend_irecv``,
  ``psum`` an ``all_reduce``, the gathers ``all_gather``;
* gloo's send and receive take CPU tensors only, so under gloo a CUDA
  tensor goes through a pinned host buffer: copied out, sent or
  reduced there, and copied back.  ``TRANSPORT`` counts those calls,
  their bytes and their milliseconds (host clock, copies included);
* a one-rank axis moves nothing.

Under NCCL, ``psum`` and the gathers on CUDA tensors can be captured in
a CUDA graph (the serving programs of a tensor-parallel replica): they
synchronize nothing with the host, stage nothing, and allocate their
buffers on the capturing stream, so from the graph's pool.  Their
``TRANSPORT`` counts move at capture, which runs nothing, so
``ops.cuda_ops.capture_graph`` takes them off and ``replay_graph`` adds
them on each replay, as it does for ``LAUNCHES``.  A staged (gloo)
collective cannot run inside a capture: it raises.

The differentiable pieces follow the rule that a replicated input is
replicated on every rank and every rank computes the same loss:
``ppermute``'s gradient is the inverse permutation of its cotangent,
``psum``'s is the cotangent itself (each rank's partial sums into one
result), :func:`psum_grad` is the identity whose gradient is the sum
over the axis, and :func:`shard_map`'s slicing of an input has the
gather of the gradient slices as its gradient, its gathering of an
output the rank's own slice of the cotangent (not a sum over ranks,
which would scale the gradient by the axis size).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .mesh import current_mesh, mesh_scope

__all__ = ["axis_size", "axis_index", "ppermute", "ppermute_start", "psum",
           "psum_grad", "psum_partial", "psum_scatter", "all_gather",
           "gather", "split", "broadcast", "exchange", "barrier", "shard_map",
           "TRANSPORT", "reset_transport"]

#: calls, bytes and host ms of the collectives staged through pinned
#: host memory (gloo with CUDA tensors); ``device_calls`` counts those
#: that ran on the tensors' own device (NCCL, or CPU tensors on gloo)
TRANSPORT = {"staged_calls": 0, "staged_bytes": 0, "staged_ms": 0.0,
             "device_calls": 0}


def reset_transport():
    for k in TRANSPORT:
        TRANSPORT[k] = 0.0 if k == "staged_ms" else 0


def _mesh(mesh):
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: pass one or enter parallel.mesh_scope")
    return mesh


def _axes(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(axis, mesh=None):
    """Size of a mesh axis (the product over a tuple of axes)."""
    return _mesh(mesh).axis_size(axis)


def axis_index(axis, mesh=None):
    """This rank's index along a mesh axis (outer-major over a tuple)."""
    return _mesh(mesh).axis_index(axis)


def _staged(mesh, t):
    """Whether a collective on ``t`` goes through pinned host memory
    (raises inside a CUDA graph capture, which such a copy cannot be
    part of)."""
    staged = mesh.backend == "gloo" and t.is_cuda
    if staged and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a gloo collective on CUDA tensors stages through host memory "
            "and cannot be captured in a CUDA graph")
    return staged


def _host(t):
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def _count(mesh, t, t0):
    if t0 is None:
        TRANSPORT["device_calls"] += 1
        return
    TRANSPORT["staged_calls"] += 1
    TRANSPORT["staged_bytes"] += t.numel() * t.element_size()
    TRANSPORT["staged_ms"] += (time.perf_counter() - t0) * 1e3


class _Pending:
    """A started ``ppermute``; :meth:`wait` returns the received tensor."""

    def __init__(self, works, recv, staged, device, t0, mesh):
        self.works, self.recv, self.staged = works, recv, staged
        self.device, self.t0, self.mesh = device, t0, mesh

    def wait(self):
        for w in self.works:
            w.wait()
        out = self.recv.to(self.device)
        if self.works:
            _count(self.mesh, out, self.t0 if self.staged else None)
        return out


def ppermute_start(x, axis, perm, mesh=None):
    """Start sending ``x`` along ``axis`` by ``perm`` (pairs ``(src,
    dst)`` of axis indices) and receiving this rank's new block; the
    returned handle's ``wait()`` gives it.  A rank that no pair sends to
    receives zeros, as ``lax.ppermute`` gives."""
    mesh = _mesh(mesh)
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError("ppermute runs along one mesh axis, got %r"
                         % (axis,))
    axis = axes[0]
    x = x.contiguous()
    me = mesh.coords[axis]
    line = mesh.line[axis]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(line) == 1 or (dst == [me] and src == [me]):
        return _Pending([], x if src else torch.zeros_like(x), False,
                        x.device, None, mesh)
    t0 = time.perf_counter()
    staged = _staged(mesh, x)
    send = _host(x) if staged else x
    recv = torch.empty_like(send) if src else None
    ops = [dist.P2POp(dist.isend, send, line[d], mesh.groups[axis])
           for d in dst]
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, line[src[0]],
                              mesh.groups[axis]))
    works = dist.batch_isend_irecv(ops) if ops else []
    if recv is None:
        recv = torch.zeros_like(send)
    return _Pending(works, recv, staged, x.device, t0, mesh)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.axis, ctx.perm, ctx.mesh = axis, perm, mesh
        return ppermute_start(x, axis, perm, mesh).wait()

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return (ppermute_start(g, ctx.axis, inverse, ctx.mesh).wait(), None,
                None, None)


def ppermute(x, axis, perm, mesh=None):
    """``lax.ppermute``: differentiable, its gradient the inverse
    permutation of the cotangent."""
    return _PPermute.apply(x, axis, perm, _mesh(mesh))


def _all_reduce(x, axis, mesh):
    for a in _axes(axis):
        group = mesh.groups[a]
        if group is None:
            continue
        t0 = time.perf_counter()
        staged = _staged(mesh, x)
        buf = _host(x) if staged else x.clone()
        dist.all_reduce(buf, group=group)
        x = buf.to(x.device)
        _count(mesh, x, t0 if staged else None)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return _all_reduce(x.contiguous(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.axis, ctx.mesh), None, None


def psum(x, axis, mesh=None):
    """Sum of ``x`` over the ranks of ``axis`` (one ``all_reduce`` per
    axis name); its gradient is the cotangent itself."""
    return _PSum.apply(x, axis, _mesh(mesh))


def psum_grad(x, axis, mesh=None):
    """``x`` unchanged, with the sum over ``axis`` of its gradient: the
    entry of a replicated tensor into per-rank partial work (the
    companion of :func:`psum`)."""
    return _PSumGrad.apply(x, axis, _mesh(mesh))


class _PSumPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.axis, ctx.mesh = axis, mesh
        return _all_reduce(x.contiguous(), axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.axis, ctx.mesh), None, None


def psum_partial(x, axis, mesh=None):
    """Sum of ``x`` over ``axis`` where each rank holds part of the
    loss (data parallelism): the gradient is the sum of the ranks'
    cotangents."""
    return _PSumPartial.apply(x, axis, _mesh(mesh))


def _gather_raw(x, dim, axis, mesh):
    """The blocks of ``x`` on the ranks of ``axis``, concatenated along
    ``dim`` in axis order (outer-major over a tuple of axes)."""
    x = x.contiguous()
    for a in reversed(_axes(axis)):        # inner axis first
        group = mesh.groups[a]
        if group is None:
            continue
        n, device = len(mesh.line[a]), x.device
        t0 = time.perf_counter()
        staged = _staged(mesh, x)
        src = _host(x) if staged else x
        if mesh.backend == "nccl":
            # one flat output tensor: the form a CUDA graph captures
            out = torch.empty(n * src.numel(), dtype=src.dtype,
                              device=device)
            dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
            parts = [p.view(src.shape) for p in out.chunk(n)]
        else:
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
        x = torch.cat(parts, dim).to(device)
        _count(mesh, x, t0 if staged else None)
    return x


def _scatter_raw(x, dim, axis, mesh):
    """Sum over ``axis`` and this rank's block of it along ``dim``."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError("dimension %d of size %d does not split over %r "
                         "(%d ranks)" % (dim, x.shape[dim], axis, n))
    axes = _axes(axis)
    if mesh.backend == "nccl" and len(axes) == 1:
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=mesh.groups[axes[0]])
        _count(mesh, out, None)
        return out.movedim(0, dim).contiguous()
    size = x.shape[dim] // n
    total = _all_reduce(x.contiguous(), axis, mesh)
    return total.narrow(dim, mesh.axis_index(axis) * size, size).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _gather_raw(x, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter_raw(g, ctx.dim, ctx.axis, ctx.mesh), None, None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, mesh):
        ctx.dim, ctx.axis, ctx.mesh = dim, axis, mesh
        return _scatter_raw(x, dim, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(g, ctx.dim, ctx.axis, ctx.mesh), None, None, None


def all_gather(x, dim, axis, mesh=None):
    """The blocks of ``x`` on the ranks of ``axis``, concatenated along
    ``dim`` in axis order (outer-major over a tuple of axes).  Its
    gradient is :func:`psum_scatter` of the cotangent: the rank's own
    slice, summed over the ranks that read the gathered tensor."""
    return _AllGather.apply(x, dim, axis, _mesh(mesh))


def psum_scatter(x, dim, axis, mesh=None):
    """The sum of ``x`` over ``axis``, and this rank's block of it along
    ``dim`` (``lax.psum_scatter(..., tiled=True)``); its gradient is the
    :func:`all_gather` of the cotangent.  Under gloo an ``all_reduce``
    and the rank's slice, under NCCL ``reduce_scatter_tensor``."""
    return _PSumScatter.apply(x, dim, axis, _mesh(mesh))


def _spec_at(dim, ndim, axis):
    spec = [None] * ndim
    spec[dim % ndim] = axis
    return tuple(spec)


def gather(x, dim, axis, mesh=None):
    """:func:`all_gather` of a block of a tensor every rank then holds
    whole (a column-parallel product's output): its gradient is the
    rank's own slice of the cotangent, which every rank holds whole."""
    return _Gather.apply(x, _spec_at(dim, x.dim(), axis), _mesh(mesh))


def split(x, dim, axis, mesh=None):
    """This rank's block along ``dim`` of a tensor every rank holds
    whole (a row-parallel product's input): its gradient is the gather
    of the ranks' blocks."""
    return _Shard.apply(x, _spec_at(dim, x.dim(), axis), _mesh(mesh))


def broadcast(x, src=0, axis=None, mesh=None):
    """``x`` of the rank at index ``src`` along ``axis`` (``axis=None``:
    the ``src``-th rank of the whole mesh), on every rank of the axis
    (not differentiable)."""
    mesh = _mesh(mesh)
    if axis is None:
        group, root = mesh.group, mesh.member_ranks()[src]
    else:
        axes = _axes(axis)
        if len(axes) != 1:
            raise ValueError("broadcast runs along one mesh axis, got %r"
                             % (axis,))
        group = mesh.groups.get(axes[0])
        root = mesh.line[axes[0]][src] if group is not None else None
    if group is None:
        return x
    t0 = time.perf_counter()
    staged = _staged(mesh, x)
    buf = _host(x) if staged else x.contiguous().clone()
    dist.broadcast(buf, root, group=group)
    out = buf.to(x.device)
    _count(mesh, out, t0 if staged else None)
    return out


def exchange(sends, recvs, axis, mesh=None):
    """Point-to-point along ``axis``: ``sends`` are ``(tensor, dst,
    tag)``, ``recvs`` are ``(like, src, tag)`` (``like``: a tensor whose
    shape, dtype and device the received one takes), ``dst`` / ``src``
    axis indices.  Returns the received tensors, in order.  Both sides
    list the matching pairs (the pipeline's slot tables give them)."""
    mesh = _mesh(mesh)
    axis = _axes(axis)[0]
    line, group = mesh.line[axis], mesh.groups[axis]
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    staged = mesh.backend == "gloo" and any(
        t.is_cuda for t, _, _ in list(sends) + list(recvs))
    ops, bufs, nbytes = [], [], 0
    for t, dst, tag in sends:
        buf = _host(t.contiguous()) if staged else t.contiguous()
        nbytes += buf.numel() * buf.element_size()
        ops.append(dist.P2POp(dist.isend, buf, line[dst], group, tag))
    for like, src, tag in recvs:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          pin_memory=True) if staged else \
            torch.empty_like(like)
        nbytes += buf.numel() * buf.element_size()
        bufs.append((buf, like.device))
        ops.append(dist.P2POp(dist.irecv, buf, line[src], group, tag))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    out = [b.to(dev) for b, dev in bufs]
    if staged:
        TRANSPORT["staged_calls"] += 1
        TRANSPORT["staged_bytes"] += nbytes
        TRANSPORT["staged_ms"] += (time.perf_counter() - t0) * 1e3
    else:
        TRANSPORT["device_calls"] += 1
    return out


def barrier(mesh=None):
    """Wait for every rank of the mesh (nothing on one rank)."""
    mesh = _mesh(mesh)
    if mesh.group is not None:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def _shard_slice(x, spec, mesh):
    """The rank's block of the global ``x`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError("dimension %d of size %d does not split over "
                             "%r (%d ranks)" % (dim, x.shape[dim], axis, n))
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axis) * size, size)
    return x.contiguous()


def _gather_global(x, spec, mesh):
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = _gather_raw(x, dim, axis, mesh)
    return x


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _shard_slice(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather_global(g.contiguous(), ctx.spec, ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _gather_global(x.contiguous(), spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _shard_slice(g, ctx.spec, ctx.mesh), None, None


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` over each rank's shard of replicated global tensors.

    A spec is a tuple with one entry per dimension: None (replicated),
    an axis name, or a tuple of axis names (outer-major).  The returned
    function slices each input to this rank's block, runs ``fn`` on the
    blocks with ``mesh`` current, and gathers each output back to its
    global shape on every rank."""
    single = not isinstance(out_specs, list)

    def run(*args):
        blocks = [_Shard.apply(a, tuple(s), mesh)
                  for a, s in zip(args, in_specs)]
        with mesh_scope(mesh):
            outs = fn(*blocks)
        if single:
            return _Gather.apply(outs, tuple(out_specs), mesh)
        return [_Gather.apply(o, tuple(s), mesh)
                for o, s in zip(outs, out_specs)]
    return run
