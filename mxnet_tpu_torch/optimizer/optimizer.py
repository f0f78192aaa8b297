"""Optimizers as pure update rules over torch tensors.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py:29-212`` (the
``Optimizer`` base: registry, lr/wd with ``lr_mult``/``wd_mult``,
schedulers, ``_update_count``, ``create_state``, ``update``), ``SGD``
(:214-247), ``Adam`` and ``AdamW`` (:391-442).  Each optimizer defines
the same pure ``_rule(w, g, lr, wd, t, scalars, state) -> (new_w,
new_state)`` as the JAX package, so ``parallel.TrainStep`` reuses it.
``update`` applies ``rescale_grad`` and ``clip_gradient`` before the
rule, as the JAX ``_compiled`` body does (:139-143), and runs it under
``torch.no_grad()``: the rule reads the weight as float32, keeps
float32 states, and returns new tensors.  The new weight is copied into
the weight in its own dtype, since the caller holds the parameter
itself.  Each state tensor is repointed at the rule's new tensor with
``Tensor.set_`` -- no copy, the counterpart of the JAX package's handle
swap (``s._data = ns``, :171-172) -- so the old moments are freed and
one copy of each state lives between steps.

Not ported yet: ``multi_precision`` (refused with
``NotImplementedError``) and the other fourteen optimizers of the JAX
package (NAG, SGLD, Signum, DCASGD, AdaGrad, AdaDelta, Adamax, Nadam,
FTML, LAMB, LARS, RMSProp, Ftrl, LANS).  The JAX package's
``aggregate_num``, ``use_fused_step`` and SGD's ``lazy_update`` are not
parameters here, and the base takes no ``**kwargs``: an option the port
does not have is a ``TypeError``, never silently dropped.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]


class Optimizer:
    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None):
        if multi_precision:
            raise NotImplementedError(
                "mxnet_tpu_torch: multi_precision is not ported yet "
                "(ROADMAP queue 1)")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.num_update = 0
        self._index_update_count = {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- registry ---------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- lr/wd ------------------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _mult(self, index, attr, table):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._mult(index, "lr_mult",
                                               self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)

    # -- state and the pure rule (override) -------------------------------
    def create_state(self, index, weight):
        return ()

    def _scalar_args(self, index):
        return ()

    def _rule(self, w, g, lr, wd, t, scalars, state):
        raise NotImplementedError

    # -- stepping ---------------------------------------------------------
    @torch.no_grad()
    def update(self, indices, weights, grads, states):
        """Update each weight (copied in) and its state tuple (each
        tensor repointed, not copied); the list or the single-element
        form."""
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = [indices], [weights], \
                [grads], [states]
        for idx, w, g, st in zip(indices, weights, grads, states):
            self._update_count(idx)
            g = g.float() * self.rescale_grad
            if self.clip_gradient is not None:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            new_w, new_st = self._rule(
                w, g, self._get_lr(idx), self._get_wd(idx),
                self._index_update_count[idx], self._scalar_args(idx),
                st)
            w.copy_(new_w)
            for s, ns in zip(st, new_st):
                s.set_(ns)

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__, self.lr, self.wd)


register = Optimizer.register
create = Optimizer.create_optimizer


def _zeros32(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


@register
class SGD(Optimizer):
    """SGD with momentum."""

    def __init__(self, learning_rate=0.01, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_zeros32(weight),)

    def _scalar_args(self, index):
        return (self.momentum,)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        (momentum,) = scalars
        g = g + wd * w.float()
        if not state:
            return (w.float() - lr * g).to(w.dtype), ()
        (mom,) = state
        mom = momentum * mom - lr * g
        return (w.float() + mom).to(w.dtype), (mom,)


@register
class Adam(Optimizer):
    """Adam with float32 moments; ``correct_bias`` divides by
    1 - beta^t."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.correct_bias = correct_bias

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _scalar_args(self, index):
        return (self.beta1, self.beta2, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        m, v = state
        wf = w.float()
        g = g + wd * wf
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        if self.correct_bias:
            mhat = m / (1 - math.pow(beta1, t))
            vhat = v / (1 - math.pow(beta2, t))
        else:
            mhat, vhat = m, v
        new_w = wf - lr * mhat / (vhat.sqrt() + eps)
        return new_w.to(w.dtype), (m, v)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr * (m_hat / (sqrt(v_hat)
    + eps) + wd * w)."""

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        m, v = state
        wf = w.float()
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        mhat = m / (1 - math.pow(beta1, t))
        vhat = v / (1 - math.pow(beta2, t))
        new_w = wf - lr * (mhat / (vhat.sqrt() + eps) + wd * wf)
        return new_w.to(w.dtype), (m, v)
