"""Parameter sharding over a mesh of ranks.

Counterpart of ``mxnet_tpu/parallel/sharding.py``: rules are ``(regex,
spec tuple)`` pairs applied to the structural parameter names of
``collect_params()``, and an explicit ``Parameter.shard()`` annotation
wins (:func:`_spec_for`); :func:`_valid_spec` drops the axes a mesh
lacks or a dimension cannot split, warning once per (parameter, axis).

The JAX package hands the specs to GSPMD, which lays each array out
over the devices and inserts the collectives.  The port makes the
placement and the collectives explicit:

* :func:`shard_params` replaces each parameter's data with **this
  rank's block** of it and records its placement, a
  :class:`NamedSharding` (``p.sharding.mesh`` / ``.spec``); the global
  shape stays readable as ``p.global_shape`` (``convert.load_params``
  fills a sharded parameter from a global array, and checkpoints write
  global arrays);
* a layer with a sharded weight computes with its block and returns the
  replicated result: :func:`linear` (``Dense``) and :func:`embedding`
  (``Embedding``), for any spec a rule can give (the out dimension
  sharded: a local product, then a gather; the in dimension: the local
  slice of x, a local product, then a ``psum``; both at once; the
  embedding's vocabulary or width).  A spec naming one of the batch
  axes of the running :class:`~.train_step.TrainStep` (an FSDP-style
  ``("dp", None)``) is gathered whole before the product, and its
  gradient summed over those axes (:class:`_GatherWhole`);
* the transformer's Megatron layout has a fast path of its own
  (``models/transformer.py``).

:func:`batch_scope` names the mesh axes a batch is split over while a
``TrainStep`` runs its forward: ``BatchNorm`` reduces its moments over
them, and :func:`linear` / :func:`embedding` tell a data-parallel axis
from a model-parallel one by them.
"""
from __future__ import annotations

import logging
import re
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as TF

from ..contrib.quantization import int8_forward
from . import _compat

__all__ = ["P", "PartitionSpec", "NamedSharding", "param_sharding",
           "shard_params", "replicate", "apply_sharding_rules", "placement",
           "global_shape", "local_block", "gather_global", "batch_scope",
           "current_batch", "linear", "embedding", "batch_moments"]

_logger = logging.getLogger(__name__)
_warned_drops = set()  # (param, axis, reason): warn once per process
_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), an axis name, or a
    tuple of axis names (outer-major)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class NamedSharding:
    """A placement: ``mesh`` and ``spec``."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    __hash__ = object.__hash__

    def __repr__(self):
        return "NamedSharding(%s, %r)" % (self.mesh.shape, self.spec)


def _spec_for(name, param, rules, default):
    spec = getattr(param, "sharding_spec", None)
    if spec is not None:
        return PartitionSpec(*spec)
    for pattern, spec in (rules or []):
        if re.search(pattern, name):
            return PartitionSpec(*spec)
    return default


def _valid_spec(spec, shape, mesh, param_name=None, warn=True):
    """Drop axis assignments that do not divide the dimension and axes
    the mesh lacks (a tp-annotated model on a dp-only mesh replicates);
    a composite assignment keeps its present axes.  Every parameter drop
    warns once per (parameter, axis); ``warn=False`` for activations."""
    def _warn(ax, reason):
        if not warn:
            return
        key = (param_name, str(ax), reason)
        if key in _warned_drops:
            return
        _warned_drops.add(key)
        _logger.warning(
            "sharding: dropping axis %r of spec for %s (%s) — the "
            "dimension will be REPLICATED on every device", ax,
            param_name or "<param>", reason)

    names = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, names[:len(shape)]):
        if ax is None:
            out.append(None)
            continue
        requested = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in requested if a in mesh.shape)
        for a in requested:
            if a not in mesh.shape:
                _warn(a, "mesh %s has no axis %r" % (dict(mesh.shape), a))
        if not axes:
            out.append(None)
            continue
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        keep = axes if len(axes) > 1 else axes[0]
        if dim % size == 0 and dim >= size:
            out.append(keep)
        else:
            _warn(keep, "dim %d not divisible by axis size %d"
                  % (dim, size))
            out.append(None)
    return PartitionSpec(*out)


def global_shape(p):
    """The parameter's global shape (its own shape when not sharded)."""
    from ..gluon.parameter import global_shape as shape
    return shape(p)


def placement(p):
    """The :class:`NamedSharding` :func:`shard_params` gave ``p``, or
    None."""
    spec = getattr(p, "_mx", None)
    return None if spec is None else spec.placement


def param_sharding(params, mesh, rules=None, default=PartitionSpec()):
    """name -> :class:`NamedSharding` for a ``collect_params()`` dict."""
    out = {}
    for name, p in params.items():
        spec = _spec_for(name, p, rules, default)
        if not _deferred(p):
            spec = _valid_spec(spec, global_shape(p), mesh, param_name=name)
        out[name] = NamedSharding(mesh, spec)
    return out


def _deferred(p):
    from ..gluon.parameter import is_deferred
    return is_deferred(p)


def _axes(ax):
    return ax if isinstance(ax, tuple) else (ax,)


def _sharded(spec, mesh):
    return any(a is not None and mesh.axis_size(a) > 1 for a in spec)


def local_block(t, spec, mesh):
    """This rank's block of the global tensor ``t`` under ``spec``."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = t.shape[dim] // mesh.axis_size(axis)
        t = t.narrow(dim, mesh.axis_index(axis) * size, size)
    return t


def gather_global(t, spec, mesh):
    """The global tensor from every rank's block (a collective over the
    spec's axes; every rank of the mesh calls it)."""
    return _compat._gather_global(t.contiguous(), spec, mesh)


def _set_local(p, data, sharding, gshape):
    from ..gluon.parameter import _SET_DATA, _spec as _pspec
    with torch.no_grad():
        _SET_DATA(p, data.contiguous().clone())
    meta = _pspec(p)
    meta.placement = sharding
    meta.global_shape = gshape
    p.grad = None


def unshard(p):
    """Put the whole of a sharded parameter back on every rank of its
    mesh (a collective) and forget its placement."""
    sh = placement(p)
    if sh is None:
        return
    if sh.mesh.is_member:
        full = gather_global(p.detach(), sh.spec, sh.mesh)
        _set_local(p, full, None, None)


def shard_params(block, mesh, rules=None, default=PartitionSpec()):
    """Give every initialized parameter of ``block`` this rank's block
    under its spec on ``mesh`` (a parameter sharded before is gathered
    from its old placement first: a collective there; one already placed
    so is left as it is).  Returns the
    name -> :class:`NamedSharding` map.  A rank outside ``mesh`` keeps
    whole parameters, with no placement."""
    params = block.collect_params()
    shardings = param_sharding(params, mesh, rules, default)
    for name, p in params.items():
        if _deferred(p) or placement(p) == shardings[name]:
            continue            # already this rank's block there
        unshard(p)
        if not mesh.is_member:
            continue
        spec = shardings[name].spec
        gshape = tuple(p.shape)
        _set_local(p, local_block(p.detach(), spec, mesh), shardings[name],
                   gshape)
    return shardings


def replicate(mesh):
    return NamedSharding(mesh, PartitionSpec())


def apply_sharding_rules(block, rules):
    """Attach sharding specs to parameters by regex (no data moves)."""
    for name, p in block.collect_params().items():
        for pattern, spec in rules:
            if re.search(pattern, name):
                p.shard(spec)
                break
    return block


# ----------------------------------------------------------------------
# the batch axes of a running TrainStep
# ----------------------------------------------------------------------
@contextmanager
def batch_scope(mesh, axes):
    """Inside the scope the batch is split over ``axes`` of ``mesh``."""
    prev = getattr(_STATE, "batch", None)
    _STATE.batch = (mesh, tuple(a for a in axes if mesh.axis_size(a) > 1))
    try:
        yield
    finally:
        _STATE.batch = prev


def current_batch():
    """(mesh, batch axes) of the enclosing :func:`batch_scope`, or
    None."""
    return getattr(_STATE, "batch", None)


def _batch_axes(mesh):
    cur = current_batch()
    if cur is None or cur[0] is not mesh:
        return ()
    return cur[1]


class _GatherWhole(torch.autograd.Function):
    """The whole of a sharded parameter from its blocks; the gradient
    (each rank's, of its own part of the loss along ``sum_axes``) is
    summed over ``sum_axes`` and cut to the rank's block."""

    @staticmethod
    def forward(ctx, w, spec, mesh, sum_axes):
        ctx.spec, ctx.mesh, ctx.sum_axes = spec, mesh, sum_axes
        return gather_global(w, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_axes:
            g = _compat._all_reduce(g.contiguous(), ctx.sum_axes, ctx.mesh)
        return (local_block(g, ctx.spec, ctx.mesh).contiguous(), None, None,
                None)


def _model_spec(w, sh):
    """(weight, spec) to compute with: a spec naming a batch axis is
    gathered whole (its gradient summed over the batch axes in it)."""
    spec = tuple(sh.spec) + (None,) * (w.dim() - len(sh.spec))
    batch = _batch_axes(sh.mesh)
    named = {a for ax in spec if ax is not None for a in _axes(ax)}
    in_batch = tuple(a for a in batch if a in named)
    if in_batch:
        return (_GatherWhole.apply(w, spec, sh.mesh, in_batch),
                (None,) * w.dim())
    return w, spec


def _whole(t, sh):
    """A sharded bias (or any parameter read whole) gathered, its
    gradient the rank's own slice (every rank holds the whole cotangent)."""
    w, spec = _model_spec(t, sh)
    for dim, axis in enumerate(spec):
        if axis is not None and sh.mesh.axis_size(axis) > 1:
            w = _compat.gather(w, dim, axis, sh.mesh)
    return w


def _single(ax, mesh):
    return ax if ax is not None and mesh.axis_size(ax) > 1 else None


def linear(x, weight, bias=None, flatten=True, layer=None):
    """``x W^T + b`` for a weight sharded by :func:`shard_params`,
    replicated in and out: the out dimension sharded is a local product
    then a gather (its input enters through ``psum_grad``), the in
    dimension the local slice of x, a local product and a ``psum``.
    Inside a ``contrib.quantization.int8_weights`` scope that holds
    ``layer``, the local product reads its int8 block."""
    sh = placement(weight)
    mesh = sh.mesh
    w, (out_ax, in_ax) = _model_spec(weight, sh)
    out_ax, in_ax = _single(out_ax, mesh), _single(in_ax, mesh)
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    x = x.to(w.dtype)
    if out_ax is not None:
        x = _compat.psum_grad(x, out_ax, mesh)
    if in_ax is not None:
        x = _compat.split(x, -1, in_ax, mesh)
    y = None if layer is None else int8_forward(layer, x, None, False)
    if y is None:
        y = TF.linear(x, w)
    if in_ax is not None:
        y = _compat.psum(y, in_ax, mesh)
    if out_ax is not None:
        y = _compat.gather(y, -1, out_ax, mesh)
    if bias is not None:
        bsh = placement(bias)
        y = y + (_whole(bias, bsh) if bsh is not None else bias)
    return y


def embedding(ids, weight):
    """Lookup in an embedding table sharded by :func:`shard_params`:
    the vocabulary sharded is a masked local lookup and a ``psum``, the
    width a local lookup and a gather."""
    sh = placement(weight)
    mesh = sh.mesh
    w, (vocab_ax, dim_ax) = _model_spec(weight, sh)
    vocab_ax, dim_ax = _single(vocab_ax, mesh), _single(dim_ax, mesh)
    ids = ids.long()
    if vocab_ax is not None:
        rows = w.shape[0]
        lo = mesh.axis_index(vocab_ax) * rows
        mine = (ids >= lo) & (ids < lo + rows)
        e = w[torch.where(mine, ids - lo, torch.zeros_like(ids))]
        e = e * mine[..., None].to(e.dtype)
        e = _compat.psum(e, vocab_ax, mesh)
    else:
        e = w[ids]
    if dim_ax is not None:
        e = _compat.gather(e, -1, dim_ax, mesh)
    return e


def batch_moments(x, axis, mesh, axes):
    """Mean and biased variance (float32) over every dimension but
    ``axis`` of the global batch split over ``axes``: the float32 sum and
    sum of squares ``psum``-ed over the batch axes (gradients summed
    back), as GSPMD reduces the moments over the whole batch."""
    axis = axis % x.dim()
    dims = [d for d in range(x.dim()) if d != axis]
    xf = x.float()
    sums = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
    sums = _compat.psum_partial(sums, axes, mesh)
    n = (x.numel() // x.shape[axis]) * mesh.axis_size(axes)
    mean = sums[0] / n
    return mean, sums[1] / n - mean * mean
