"""``TrainStep``: forward, loss, backward and optimizer update of a Block
in one call, on one device or over a mesh of ranks.

Counterpart of ``TrainStep`` in ``mxnet_tpu/parallel/train_step.py``.
The JAX step compiles the whole update into one XLA program that GSPMD
partitions; the port runs it eagerly with the same arithmetic:

* the forward runs with grad on and the training flag set:
  ``forward_fn(net, *batch)``, or else ``loss_fn(net(x), y).mean()``;
* the update is one list-form call over every trainable parameter
  (the optimizer's ``_run``: each group of SGD / NAG / Adam / AdamW /
  LAMB one multi-tensor kernel launch on the card, which reads each
  gradient in its own dtype; the other optimizers' ``_rule`` per
  tensor), with the step's own counter ``t`` (:254-255), the
  optimizer's ``learning_rate`` (its scheduler at ``num_update = t``)
  times the parameter's ``lr_mult``, and its wd;
* each gradient is clipped by the optimizer's ``clip_gradient`` inside
  that call (:176-197) -- ``rescale_grad`` is NOT applied here, unlike
  ``Optimizer.update``.

Each weight and its optimizer state are updated in place (the parameter
stays the same tensor), on the parameter's device.

``mesh=`` (reference :166-239): the step's parameters are sharded by
``param_rules`` and their own annotations (``parallel.shard_params``:
each rank holds its block), and each batch input is split over the
mesh axes of ``batch_spec`` (default ``P("dp")``; a ``ValueError`` when
the axes do not divide it).  Each rank runs the forward on its part of
the batch under :func:`~.sharding.batch_scope` (tensor-parallel layers
and BatchNorm read it), its loss is averaged over the batch axes, and
each gradient is ``psum``-ed over the batch axes and divided by their
size.  That equals the reference's global loss only when the loss is a
mean over the batch axis of per-sample terms (the default
``loss_fn(...).mean()`` convention, and the dryrun's ``forward_fn``); a
``sum`` loss comes out the batch axes' size times smaller (ROADMAP
section 3, quirks).

``zero1=True`` (reference :231-239, :296-314) shards each optimizer
state over ``dp`` on dim 0 of the rank's parameter block wherever
``_valid_spec(P("dp"), block shape)`` keeps the axis (a Megatron block
split further over ``dp``: the JAX package applies the spec to the
global shape, GSPMD then co-locates; the update is elementwise, so the
numbers are the same).  Other states stay with their parameter.  One
step then runs ``psum_scatter`` of the gradient over ``dp``, the update
of the shard by ``_run`` (one ``multi_adam`` / ``multi_sgd`` launch per
dtype group over the shards), and an ``all_gather`` of the updated
rows.  LAMB, LANS and LARS read whole-tensor norms, so they are refused
on a sharded parameter or state rather than run on a block.

``save_checkpoint(path)`` / ``load_checkpoint(path)`` (:267, :288) write
and read the parameters, the optimizer states and the step counter
``t`` as one npz (``utils/serialization.py``) in the directory
``path``, atomically and overwriting, as the JAX step's ``force=True``
does.  The arrays are **global**: gathered over the mesh and written by
its first rank; loading cuts each to the blocks of whatever mesh the
restoring step has (dp x tp, dp only, one device).  ``resize(mesh,
checkpoint=None)`` (:347) rebinds the step to another mesh the same way
without a file: the parameters are gathered and re-sharded, the states
created fresh.  With a step heartbeat installed
(``fault_dist.enable_step_heartbeat``) each call beats it first.

``remat=True`` runs the forward under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward, as
``jax.checkpoint`` does (:166-167).  ``aot=True`` compiles against a TPU
topology description and cannot execute: it is not ported, by design
(``NotImplementedError``).  The JAX step's ``donate`` is what the port
always does (weights updated in place) and is not a parameter; the
arguments after ``mesh`` are keyword-only.
"""
from __future__ import annotations

import os
from contextlib import ExitStack

import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd
from .. import fault as _fault
from ..utils import serialization
from . import _compat
from .mesh import mesh_scope
from .sharding import (P, _sharded, _valid_spec, batch_scope,
                       gather_global, local_block, placement, shard_params,
                       unshard)

__all__ = ["TrainStep"]

#: optimizers whose rule reads whole-tensor norms
_NORM_RULES = ("LAMB", "LANS", "LARS")


def _axes(ax):
    return ax if isinstance(ax, tuple) else (ax,)


def _named(spec):
    return {a for ax in spec if ax is not None for a in _axes(ax)}


class TrainStep:
    """``step(*batch) -> loss``: one training step of ``net``.

    Parameters
    ----------
    net : Block whose parameters are initialized
    loss_fn : callable(out, label) -> per-sample loss, or None with
        ``forward_fn``
    optimizer : Optimizer instance (its ``_rule`` is applied)
    mesh : :class:`~.mesh.Mesh` or None (one device)
    param_rules : [(regex, spec tuple)] parameter sharding rules
    batch_spec : spec of each batch input (default ``P("dp")``)
    zero1 : shard optimizer states over ``dp``
    forward_fn : optional callable(net, *batch) -> scalar loss,
        overriding ``loss_fn(net(x), y).mean()``
    remat : recompute the forward's activations in the backward
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, *,
                 param_rules=None, batch_spec=None, zero1=False,
                 forward_fn=None, remat=False, aot=False):
        if aot:
            raise NotImplementedError(
                "mxnet_tpu_torch: TrainStep aot= is not ported, by design "
                "(ROADMAP queue 3): it compiles against a TPU topology "
                "description and cannot execute")
        if mesh is None and (param_rules is not None or
                             batch_spec is not None or zero1):
            raise TypeError("TrainStep: param_rules, batch_spec and zero1 "
                            "shard over a mesh: pass mesh=")
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.forward_fn = forward_fn
        self.remat = remat
        self.mesh = mesh
        self.param_rules = param_rules
        self.zero1 = zero1
        self._batch_spec = P(*batch_spec) if batch_spec is not None \
            else P("dp")
        self._params = list(net.collect_params().items())
        from ..gluon.parameter import is_deferred
        for name, p in self._params:
            if is_deferred(p):
                raise ValueError(
                    "TrainStep requires initialized parameters; %s is not "
                    "(run one forward or pass concrete shapes)" % name)
        self._trainable = [(i, name, p) for i, (name, p)
                           in enumerate(self._params) if p.requires_grad]
        self._t = 0
        self._setup()

    # -- sharding & states ---------------------------------------------
    def _setup(self):
        mesh = self.mesh
        self._zero = {}
        if mesh is not None:
            shard_params(self.net, mesh, self.param_rules)
            batch = [a for ax in self._batch_spec if ax is not None
                     for a in _axes(ax) if a in mesh.shape]
            self._batch_axes = tuple(batch)
            self._ndp = mesh.axis_size(self._batch_axes) if batch else 1
            for _, name, p in self._trainable:
                self._zero[name] = self._zero1_rows(name, p)
        else:
            self._batch_axes, self._ndp = (), 1
        sharded = any(self._zero.values()) or any(
            placement(p) is not None and _sharded(placement(p).spec, mesh)
            for _, _, p in self._trainable)
        if sharded and type(self.optimizer).__name__ in _NORM_RULES:
            raise NotImplementedError(
                "mxnet_tpu_torch: %s reads whole-tensor norms; on a sharded "
                "parameter or a zero1 state it needs their psum, which is "
                "not ported (ROADMAP queue 3)"
                % type(self.optimizer).__name__)
        self._states = {name: self.optimizer.create_state(
            i, self._shard_view(name, p)) for i, name, p in self._trainable}

    def _zero1_rows(self, name, p):
        """Rows of dim 0 of the rank's block each ``dp`` rank updates
        under ``zero1``, or 0 where the state stays whole."""
        mesh = self.mesh
        if not self.zero1 or "dp" not in mesh.shape or p.dim() == 0 \
                or mesh.axis_size("dp") == 1 or not mesh.is_member:
            return 0
        sh = placement(p)
        if sh is not None and set(self._batch_axes) & _named(sh.spec):
            return 0            # already split over a batch axis
        spec = _valid_spec(P("dp"), tuple(p.shape), mesh,
                           param_name=name + ".state")
        return p.shape[0] // mesh.axis_size("dp") if spec[0] == "dp" \
            else 0

    def _shard_view(self, name, p):
        """The rows of ``p``'s block this rank updates (a view)."""
        rows = self._zero.get(name, 0)
        w = p.detach()
        if rows:
            w = w.narrow(0, self.mesh.axis_index("dp") * rows, rows)
        return w

    def _state_spec(self, name):
        """Spec of ``name``'s optimizer state over the rank's parameter
        block: ``P("dp", None, ...)`` where zero1 splits it."""
        p = dict(self._params)[name]
        if self._zero.get(name):
            return P("dp", *([None] * (p.dim() - 1)))
        return P(*([None] * p.dim()))

    # -- the step --------------------------------------------------------
    def _batch(self, batch):
        dev = self._params[0][1].device if self._params else None
        out = []
        for b in batch:
            b = getattr(b, "_data", b)
            if not isinstance(b, torch.Tensor):
                b = torch.as_tensor(b, device=dev)
            out.append(self._split(b) if self.mesh is not None else b)
        return out

    def _split(self, b):
        """This rank's part of a batch input under ``batch_spec``."""
        if b.dim() == 0:
            return b
        mesh = self.mesh
        for dim, ax in enumerate(self._batch_spec[:b.dim()]):
            if ax is None:
                continue
            axes = tuple(a for a in _axes(ax) if a in mesh.shape)
            if not axes:
                continue
            n = mesh.axis_size(axes)
            if b.shape[dim] % n:
                raise ValueError(
                    "TrainStep: batch dimension %d of size %d does not "
                    "split over %r (%d ranks)" % (dim, b.shape[dim], axes,
                                                  n))
            size = b.shape[dim] // n
            b = b.narrow(dim, mesh.axis_index(axes) * size, size)
        return b

    def _forward(self, *batch):
        # the scopes again inside: remat's recompute runs in the backward
        with ExitStack() as scopes:
            scopes.enter_context(autograd.record(train_mode=True))
            if self.mesh is not None:
                scopes.enter_context(mesh_scope(self.mesh))
                scopes.enter_context(batch_scope(self.mesh,
                                                 self._batch_axes))
            if self.forward_fn is not None:
                return self.forward_fn(self.net, *batch)
            return self.loss_fn(self.net(batch[0]), batch[1]).mean()

    def _reduce(self, name, p, g):
        """The gradient of the mean loss over the batch axes, on the
        rows this rank updates."""
        mesh = self.mesh
        sh = placement(p)
        axes = [a for a in self._batch_axes
                if sh is None or a not in _named(sh.spec)]
        if self._zero.get(name):
            rest = tuple(a for a in axes if a != "dp")
            if rest:
                g = _compat._all_reduce(g.contiguous(), rest, mesh)
            g = _compat._scatter_raw(g, 0, "dp", mesh)
        elif axes:
            g = _compat._all_reduce(g.contiguous(), tuple(axes), mesh)
        return g / self._ndp if self._ndp > 1 else g

    def __call__(self, *batch):
        if self.mesh is not None and not self.mesh.is_member:
            raise RuntimeError("TrainStep: rank %d is outside the step's "
                               "mesh" % self.mesh.rank)
        if _fault._DIST_HEARTBEAT is not None:
            # step-boundary peer health (fault_dist): a hung peer shows
            # here, before the step's collectives (reference :246-249)
            _fault._DIST_HEARTBEAT.beat(step=self._t)
        batch = self._batch(batch)
        self._t += 1
        opt = self.optimizer
        opt.num_update = self._t
        lr = opt.learning_rate
        with autograd.record(train_mode=True):
            if self.remat:
                loss = checkpoint(self._forward, *batch, use_reentrant=False)
            else:
                loss = self._forward(*batch)
        grads = torch.autograd.grad(loss, [p for _, _, p in self._trainable])
        with torch.no_grad():
            items = []
            for (i, name, p), g in zip(self._trainable, grads):
                if self.mesh is not None:
                    g = self._reduce(name, p, g)
                items.append((i, self._shard_view(name, p), g,
                              self._states[name], None))
            opt._run(items,
                     [lr * getattr(p, "lr_mult", 1.0)
                      for _, _, p in self._trainable],
                     [opt._get_wd(i) for i, _, _ in self._trainable],
                     [self._t] * len(self._trainable), rescale=1.0)
            for _, name, p in self._trainable:
                if self._zero.get(name):
                    p.copy_(_compat._gather_raw(
                        self._shard_view(name, p), 0, "dp", self.mesh))
        loss = loss.detach()
        if self._batch_axes:
            loss = _compat._all_reduce(loss, self._batch_axes,
                                       self.mesh) / self._ndp
        return loss

    # -- checkpoints -----------------------------------------------------
    _FILE = "train_state.npz"

    def _keys(self):
        """``(key, parameter name, tensor)`` of the whole training state,
        on this rank (blocks where sharded)."""
        out = [("param/" + name, name, p) for name, p in self._params]
        for name, st in self._states.items():
            for j, s in enumerate(st):
                if isinstance(s, tuple):
                    out += [("state/%s/%d/%d" % (name, j, k), name, ss)
                            for k, ss in enumerate(s)]
                else:
                    out.append(("state/%s/%d" % (name, j), name, s))
        return out

    def _layout(self, key, name, t):
        """(zero1-split, spec) of one tensor of the state: how the
        rank's tensor sits in the global array."""
        p = dict(self._params)[name]
        sh = placement(p)
        split = key.startswith("state/") and bool(self._zero.get(name)) \
            and tuple(t.shape) == tuple(self._shard_view(name, p).shape)
        whole = tuple(t.shape) == tuple(p.shape) or split
        spec = sh.spec if sh is not None and whole else None
        return split, spec

    def _global(self, key, name, t):
        t = t.detach()
        if self.mesh is None or not self.mesh.is_member:
            return t
        split, spec = self._layout(key, name, t)
        if split:
            t = _compat._gather_raw(t.contiguous(), 0, "dp", self.mesh)
        if spec is not None:
            t = gather_global(t, spec, self.mesh)
        return t

    def _local(self, key, name, t, arr):
        """The rank's part of the global array ``arr`` for ``t``."""
        if self.mesh is None or not self.mesh.is_member:
            return arr
        split, spec = self._layout(key, name, t)
        if spec is not None:
            arr = local_block(arr, spec, self.mesh)
        if split:
            rows = self._zero[name]
            arr = arr.narrow(0, self.mesh.axis_index("dp") * rows, rows)
        return arr

    def save_checkpoint(self, path):
        """The parameters, optimizer states and step counter, as global
        arrays, into the directory ``path`` (made if missing; an earlier
        checkpoint there is replaced atomically).  Over a mesh every
        rank calls it (the arrays are gathered) and its first rank
        writes."""
        tree = {key: self._global(key, name, t)
                for key, name, t in self._keys()}
        tree["t"] = torch.tensor(self._t, dtype=torch.int64)
        mesh = self.mesh
        if mesh is None or mesh.rank == mesh.member_ranks()[0]:
            os.makedirs(path, exist_ok=True)
            serialization.savez(os.path.join(path, self._FILE), **tree)
        if mesh is not None:
            _compat.barrier(mesh)

    def load_checkpoint(self, path):
        """Restore a :meth:`save_checkpoint` directory, written on any
        mesh, into this step's parameters and states: each global array
        cut to the blocks of this step's mesh, in place, on their own
        devices."""
        loaded = serialization.load(os.path.join(path, self._FILE),
                                    device="cpu")
        keys = self._keys()
        missing = sorted({k for k, _, _ in keys} - set(loaded))
        if missing:
            raise KeyError("load_checkpoint: %s lacks %s" % (path, missing))
        with torch.no_grad():
            for key, name, t in keys:
                t.copy_(self._local(key, name, t, loaded[key]._data))
        self._t = int(loaded["t"]._data.item())
        self.optimizer.num_update = self._t
        return self

    def resize(self, mesh, checkpoint=None):
        """Rebind the step to ``mesh`` (the elastic resize's reshard):
        every parameter is gathered from the old mesh and sharded onto
        the new one, whose first rank's values the others take, and the
        optimizer states are created fresh (momentum restarts), unless
        ``checkpoint`` names a :meth:`save_checkpoint` directory to
        restore.  Every rank of both meshes calls it."""
        with torch.no_grad():
            for _, p in self._params:
                unshard(p)
            if mesh is not None and mesh.group is not None and \
                    mesh.is_member:
                for _, p in self._params:
                    p.copy_(_compat.broadcast(p.detach(), 0, None, mesh))
        self.mesh = mesh
        self._setup()
        if checkpoint is not None and (mesh is None or mesh.is_member):
            self.load_checkpoint(checkpoint)
        return self
