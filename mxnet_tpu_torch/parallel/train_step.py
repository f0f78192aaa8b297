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
stays the same tensor), on the parameter's device.  Not ported
yet, and refused with ``NotImplementedError``: ``mesh``, ``zero1``,
``aot``, ``remat=True``, ``save_checkpoint``, ``load_checkpoint`` and
``resize`` (ROADMAP queue 3).  The JAX step's ``param_rules`` and
``batch_spec`` shard over a mesh and come with it; its ``donate`` is
what the port always does (weights updated in place).  None of the
three is a parameter here, so passing one is a ``TypeError``; the
arguments after ``mesh`` are keyword-only.
"""
from __future__ import annotations

import torch

from .. import autograd

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
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None, *, zero1=False,
                 forward_fn=None, remat=False, aot=False):
        for what, on in (("mesh", mesh is not None), ("zero1", zero1),
                         ("aot", aot), ("remat", remat)):
            if on:
                raise _not_ported("%s=" % what)
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.forward_fn = forward_fn
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

    def __call__(self, *batch):
        batch = self._batch(batch)
        self._t += 1
        opt = self.optimizer
        opt.num_update = self._t
        lr = opt.learning_rate
        with autograd.record(train_mode=True):
            if self.forward_fn is not None:
                loss = self.forward_fn(self.net, *batch)
            else:
                loss = self.loss_fn(self.net(batch[0]), batch[1]).mean()
        grads = torch.autograd.grad(loss, [p for _, _, p in self._trainable])
        with torch.no_grad():
            opt._run([(i, p.detach(), g, self._states[name], None)
                      for (i, name, p), g in zip(self._trainable, grads)],
                     [lr * getattr(p, "lr_mult", 1.0)
                      for _, _, p in self._trainable],
                     [opt._get_wd(i) for i, _, _ in self._trainable],
                     [self._t] * len(self._trainable), rescale=1.0)
        return loss.detach()

    def save_checkpoint(self, path):
        raise _not_ported("save_checkpoint")

    def load_checkpoint(self, path):
        raise _not_ported("load_checkpoint")

    def resize(self, mesh, checkpoint=None):
        raise _not_ported("resize")
