"""Gluon ``Trainer``: applies an optimizer to a set of parameters on one
device.

Counterpart of ``mxnet_tpu/gluon/trainer.py:20-330`` for one worker.
``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` (:274-286, without the AMP scaler) and
updates every trainable parameter from its ``.grad`` with one
``update_multi_precision`` call over all of them (:385; states from
``create_state_multi_precision``, :105-109), which runs each group of
SGD / NAG / Adam / AdamW / LAMB as one multi-tensor kernel launch on the
card; the update runs on the parameters' own device.

MXNet's ``grad_req="write"`` is not torch's accumulate: a backward in
MXNet overwrites the gradient, torch adds to it.  So after each update
the Trainer sets the updated parameters' ``.grad`` to ``None``, and the
next backward writes them fresh.  ``None`` is also how the Trainer tells
a stale gradient: a trainable parameter that no backward reached since
the last step has ``.grad is None`` and raises the stale-gradient
``UserWarning`` (:241-247), unless ``ignore_stale_grad=True`` skips it.
A parameter with ``grad_req="add"`` keeps its gradient across steps, as
in MXNet: the caller zeroes it (``zero_grad``).

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: a kvstore with more than one worker, ``update_on_kvstore``
and gradient compression (ROADMAP queue 3), and ``skip_nonfinite``
(ROADMAP queue 4).  ``save_states``/``load_states`` wait with the
checkpoints (ROADMAP queue 3).  The port has no AMP loss scaler, fault
guard or profiler hook to attach yet (ROADMAP queues 2 and 4).
"""
from __future__ import annotations

from torch import nn

from .. import optimizer as opt_mod

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "local", "device")


def _not_ported(what, queue):
    return NotImplementedError("mxnet_tpu_torch: %s is not ported yet "
                               "(ROADMAP queue %d)" % (what, queue))


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            self._param_names = list(params.keys())
            params = list(params.values())
        elif isinstance(params, (list, tuple)):
            self._param_names = [str(i) for i in range(len(params))]
            params = list(params)
        else:
            raise ValueError("params must be a dict or list of Parameters, "
                             "got %s" % type(params))
        for p in params:
            if not isinstance(p, nn.Parameter):
                raise ValueError("Invalid parameter %r" % (p,))
        if update_on_kvstore:
            raise _not_ported("update_on_kvstore", 3)
        if compression_params:
            raise _not_ported("gradient compression", 3)
        if kvstore not in _LOCAL_KVSTORES and \
                getattr(kvstore, "num_workers", 2) > 1:
            raise _not_ported("a kvstore with more than one worker "
                              "(%r)" % (kvstore,), 3)
        self._params = params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and \
                    list(optimizer_params) != ["rescale_grad"]:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._states = [None] * len(params)

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def allreduce_grads(self):
        """One worker: the gradients are already the total."""

    def step(self, batch_size, ignore_stale_grad=False,
             skip_nonfinite=False):
        """Update every trainable parameter from its gradient, rescaled
        by ``rescale_grad / batch_size``."""
        self.update(batch_size, ignore_stale_grad, skip_nonfinite)

    def update(self, batch_size, ignore_stale_grad=False,
               skip_nonfinite=False):
        if skip_nonfinite:
            raise _not_ported("skip_nonfinite (the non-finite-step guard)",
                              4)
        self._optimizer.rescale_grad = self._scale / batch_size
        fresh = []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if p.grad is None:
                if not ignore_stale_grad:
                    raise UserWarning(self._stale_msg(self._param_names[i]))
                continue
            fresh.append(i)
        for i in fresh:
            if self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, self._params[i].data)
        if fresh:
            self._optimizer.update_multi_precision(
                fresh, [self._params[i].data for i in fresh],
                [self._params[i].grad for i in fresh],
                [self._states[i] for i in fresh])
        for i in fresh:
            p = self._params[i]
            if getattr(p, "grad_req", "write") != "add":
                p.grad = None   # "write": the next backward writes

    @staticmethod
    def _stale_msg(name):
        return ("Gradient of Parameter `%s` was not updated by backward "
                "since the last trainer step.  If the model "
                "intentionally used only a subset of its parameters "
                "this iteration, call step/update with "
                "ignore_stale_grad=True to skip them." % name)
