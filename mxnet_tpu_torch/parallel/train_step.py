"""``TrainStep``: forward, loss, backward and optimizer update of a Block
in one call, on one device.

Counterpart of ``TrainStep`` in ``mxnet_tpu/parallel/train_step.py:
31-265`` with ``mesh=None``.  The JAX step compiles the whole update
into one XLA program; the port runs it eagerly with the same
arithmetic:

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

``remat=True`` runs the forward under ``torch.utils.checkpoint``
(non-reentrant): its activations are recomputed in the backward, as
``jax.checkpoint`` does (:166-167).  ``save_checkpoint(path)`` /
``load_checkpoint(path)`` (:267, :288) write and read the parameters,
the optimizer states and the step counter ``t`` as one npz
(``utils/serialization.py``) in the directory ``path``, atomically and
overwriting, as the JAX step's ``force=True`` does.

Not ported yet, and refused with ``NotImplementedError``: ``mesh``,
``zero1``, ``aot`` and ``resize`` (ROADMAP queue 3).  The JAX step's
``param_rules`` and ``batch_spec`` shard over a mesh and come with it;
its ``donate`` is what the port always does (weights updated in place).
None of the three is a parameter here, so passing one is a
``TypeError``; the arguments after ``mesh`` are keyword-only.
"""
from __future__ import annotations

import os

import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd
from ..utils import serialization

__all__ = ["TrainStep"]


def _not_ported(what):
    return NotImplementedError("mxnet_tpu_torch: TrainStep %s is not "
                               "ported yet (ROADMAP queue 3)" % what)


class TrainStep:
    """``step(*batch) -> loss``: one training step of ``net``.

    Parameters
    ----------
    net : Block whose parameters are initialized
    loss_fn : callable(out, label) -> per-sample loss, or None with
        ``forward_fn``
    optimizer : Optimizer instance (its ``_rule`` is applied)
    forward_fn : optional callable(net, *batch) -> scalar loss,
        overriding ``loss_fn(net(x), y).mean()``
    remat : recompute the forward's activations in the backward
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, *, zero1=False,
                 forward_fn=None, remat=False, aot=False):
        for what, on in (("mesh", mesh is not None), ("zero1", zero1),
                         ("aot", aot)):
            if on:
                raise _not_ported("%s=" % what)
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.forward_fn = forward_fn
        self.remat = remat
        self._params = list(net.collect_params().items())
        self._trainable = [(i, name, p) for i, (name, p)
                           in enumerate(self._params) if p.requires_grad]
        self._t = 0
        self._states = {name: optimizer.create_state(i, p)
                        for i, name, p in self._trainable}

    def _batch(self, batch):
        dev = self._params[0][1].device if self._params else None
        return [b if isinstance(b, torch.Tensor)
                else torch.as_tensor(b, device=dev) for b in batch]

    def _forward(self, *batch):
        # the scope again inside: remat's recompute runs in the backward
        with autograd.record(train_mode=True):
            if self.forward_fn is not None:
                return self.forward_fn(self.net, *batch)
            return self.loss_fn(self.net(batch[0]), batch[1]).mean()

    def __call__(self, *batch):
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
            opt._run([(i, p.detach(), g, self._states[name], None)
                      for (i, name, p), g in zip(self._trainable, grads)],
                     [lr * getattr(p, "lr_mult", 1.0)
                      for _, _, p in self._trainable],
                     [opt._get_wd(i) for i, _, _ in self._trainable],
                     [self._t] * len(self._trainable), rescale=1.0)
        return loss.detach()

    _FILE = "train_state.npz"

    def _tree(self):
        """``{key: tensor}`` of the whole training state, by name."""
        tree = {"param/" + name: p for name, p in self._params}
        for name, st in self._states.items():
            for j, s in enumerate(st):
                if isinstance(s, tuple):
                    for k, ss in enumerate(s):
                        tree["state/%s/%d/%d" % (name, j, k)] = ss
                else:
                    tree["state/%s/%d" % (name, j)] = s
        return tree

    def save_checkpoint(self, path):
        """The parameters, optimizer states and step counter into the
        directory ``path`` (made if missing; an earlier checkpoint there
        is replaced atomically)."""
        os.makedirs(path, exist_ok=True)
        tree = self._tree()
        tree["t"] = torch.tensor(self._t, dtype=torch.int64)
        serialization.savez(os.path.join(path, self._FILE), **tree)

    def load_checkpoint(self, path):
        """Restore a :meth:`save_checkpoint` directory into this step's
        parameters and states, in place, on their own devices."""
        loaded = serialization.load(os.path.join(path, self._FILE),
                                    device="cpu")
        tree = self._tree()
        missing = sorted(set(tree) - set(loaded))
        if missing:
            raise KeyError("load_checkpoint: %s lacks %s" % (path, missing))
        with torch.no_grad():
            for key, t in tree.items():
                t.copy_(loaded[key]._data)
        self._t = int(loaded["t"]._data.item())
        self.optimizer.num_update = self._t
        return self

    def resize(self, mesh, checkpoint=None):
        raise _not_ported("resize")
