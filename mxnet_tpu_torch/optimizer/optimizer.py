"""Optimizers as update rules over torch tensors.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base (:29-207: registry, lr/wd with ``lr_mult``/``wd_mult``, schedulers,
``_update_count``, ``create_state``, ``create_state_multi_precision``,
``update``, ``update_multi_precision``, ``step``, ``fused_step``,
``__getstate__``), its seventeen registered optimizers (:214-717) and
``Updater`` / ``get_updater`` (:719-773).

Each optimizer defines the same pure ``_rule(w, g, lr, wd, t, scalars,
state) -> (new_w, new_state)`` as the JAX package.  ``update`` applies
``rescale_grad`` and ``clip_gradient`` before the rule, as the JAX
``_compiled`` body does (:139-143).  The list form takes a whole list at
once: it groups the list by (device, weight dtype, gradient dtype, state
layout, master weight or not) and sends each group of SGD, NAG, Adam,
AdamW or LAMB to one multi-tensor call (``ops/multi_tensor.py``), the
counterpart of the JAX package's compiled update: a hand-written CUDA
kernel on the card, its plain PyTorch version on the CPU.  The other
twelve optimizers run their ``_rule`` per tensor, in eager PyTorch on
the tensors' device; their fused kernels wait in ROADMAP queue 1d'.

Weights, master weights and states are updated in place: the caller's
tensors keep their storage, where the JAX package swaps each handle for
the rule's new array (``s._data = ns``, :171-172).

``multi_precision=True`` keeps a float32 master copy of each float16
weight (``create_state_multi_precision`` gives ``(w32, state)``,
:118-122); ``update_multi_precision`` runs the rule on the master and
rounds it into the weight (:176-191).  ``aggregate_num`` and
``use_fused_step`` are taken and change no result, as in the JAX
package: on the card every list goes through the kernels either way.
The base takes no ``**kwargs``: an option the port does not have is a
``TypeError``, never silently dropped (SGD's ``lazy_update`` waits for
sparse gradients, ROADMAP queue 5).
"""
from __future__ import annotations

import math
import pickle

import numpy as onp
import torch

from ..ops import multi_tensor as mt

__all__ = ["Optimizer", "Updater", "create", "register", "get_updater",
           "SGD", "SGLD", "Signum", "DCASGD", "NAG", "AdaGrad", "AdaDelta",
           "Adam", "Adamax", "Nadam", "AdamW", "Ftrl", "FTML", "LAMB",
           "LANS", "LARS", "RMSProp"]


def _tensor(x):
    """The tensor of an NDArray (or the tensor itself)."""
    return getattr(x, "_data", x)


class Optimizer:
    opt_registry = {}
    #: the multi-tensor family of the list form (None: ``_rule`` per
    #: tensor)
    _fused = None

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=0,
                 use_fused_step=True):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.aggregate_num = aggregate_num
        self.use_fused_step = use_fused_step
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

    def create_state_multi_precision(self, index, weight):
        """``(float32 master copy, state)`` for a float16 weight under
        ``multi_precision``, else ``create_state``."""
        weight = _tensor(weight)
        if self.multi_precision and weight.dtype == torch.float16:
            w32 = weight.detach().to(torch.float32, copy=True)
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def _scalar_args(self, index):
        return ()

    def _rule(self, w, g, lr, wd, t, scalars, state):
        raise NotImplementedError

    # -- stepping ---------------------------------------------------------
    @torch.no_grad()
    def update(self, indices, weights, grads, states):
        """Update each weight and its state tuple in place; the list or
        the single-element form."""
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = [indices], [weights], \
                [grads], [states]
        self._apply([(i, _tensor(w), _tensor(g), st, None)
                     for i, w, g, st in zip(indices, weights, grads,
                                            states)])

    def _is_mp(self, weight, state):
        return (self.multi_precision and weight.dtype == torch.float16
                and isinstance(state, tuple) and len(state) == 2
                and torch.is_tensor(state[0])
                and state[0].dtype == torch.float32)

    @torch.no_grad()
    def update_multi_precision(self, indices, weights, grads, states):
        """``update``, with the rule run on the float32 master of each
        float16 weight whose state ``create_state_multi_precision`` made,
        and the weight set to its rounding."""
        if not isinstance(indices, (list, tuple)):
            indices, weights, grads, states = [indices], [weights], \
                [grads], [states]
        items = []
        for i, w, g, st in zip(indices, weights, grads, states):
            w, g = _tensor(w), _tensor(g)
            if self._is_mp(w, st):
                items.append((i, w, g, st[1], st[0]))
            else:
                items.append((i, w, g, st, None))
        self._apply(items)

    def step(self, indices, weights, grads, states):
        self.update(indices, weights, grads, states)

    def fused_step(self, indices, weights, grads, states):
        self.update(indices, weights, grads, states)

    def _apply(self, items):
        """Count, then lr / wd / t per item in the JAX loop's order, then
        run the list."""
        lrs, wds, ts = [], [], []
        for idx, *_ in items:
            self._update_count(idx)
            lrs.append(self._get_lr(idx))
            wds.append(self._get_wd(idx))
            ts.append(self._index_update_count[idx])
        self._run(items, lrs, wds, ts, self.rescale_grad)

    def _run(self, items, lrs, wds, ts, rescale):
        """Update ``items`` -- (index, weight, grad, state, float32 master
        or None) -- at per-item lr, wd and t: each group of a fused
        family in one multi-tensor call, the rest by ``_rule``."""
        groups = {}
        for k, (idx, w, g, st, w32) in enumerate(items):
            key = (w.device, w.dtype, g.dtype, tuple(
                s.dtype for s in st), w32 is None)
            groups.setdefault(key, []).append(k)
        for ks in groups.values():
            sel = [items[k] for k in ks]
            if self._fused is not None:
                self._fused_update(sel, [lrs[k] for k in ks],
                                   [wds[k] for k in ks],
                                   [ts[k] for k in ks], rescale)
                continue
            for k in ks:
                self._rule_update(items[k], lrs[k], wds[k], ts[k], rescale)

    def _rule_update(self, item, lr, wd, t, rescale):
        idx, w, g, st, w32 = item
        g = g.float() * rescale
        if self.clip_gradient is not None:
            g = g.clamp(-self.clip_gradient, self.clip_gradient)
        new_w, new_st = self._rule(w if w32 is None else w32, g, lr, wd, t,
                                   self._scalar_args(idx), st)
        if w32 is not None:
            w32.copy_(new_w)
        w.copy_(new_w)
        for s, ns in zip(st, new_st):
            s.copy_(ns)

    def __getstate__(self):
        # nothing process-local to drop: the JAX package drops its jit
        # cache here (:197-201)
        return dict(self.__dict__)

    def __repr__(self):
        return "%s(lr=%s, wd=%s)" % (type(self).__name__, self.lr, self.wd)


register = Optimizer.register
create = Optimizer.create_optimizer


def _om(beta, t=1):
    """1 - beta^t in float32 arithmetic, as the JAX rules compute it from
    their float32 scalars (``multi_tensor.one_minus``)."""
    return mt.one_minus(beta, t, f32=True)


def _zeros32(weight):
    weight = _tensor(weight)
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


def _groups(items, n_states):
    """Multi-tensor groups (weight, grad, states..., master) of ``items``;
    a gradient that is not contiguous is made so (the kernels read
    contiguous tensors)."""
    return [(w, g.contiguous(), *(tuple(st) + (None,) * n_states)[:n_states],
             w32) for _, w, g, st, w32 in items]


@register
class SGD(Optimizer):
    """SGD with momentum (``sgd_update``, ``sgd_mom_update``); a list runs
    as one ``multi_sgd`` call per group.  ``lazy_update`` is accepted and
    changes nothing, as in the reference: gradients are dense, so every
    row is updated."""

    _fused = "sgd"
    _nesterov = False

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=False,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_zeros32(weight),)

    def _scalar_args(self, index):
        return (self.momentum,)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        (momentum,) = scalars
        new_w, mom = mt.sgd_step(w.float(), g, state[0] if state else None,
                                 lr, wd, momentum, self._nesterov)
        return new_w.to(w.dtype), (mom,) if state else ()

    def _fused_update(self, items, lrs, wds, ts, rescale):
        mt.multi_sgd(_groups(items, 1), lrs, wds, momentum=self.momentum,
                     nesterov=self._nesterov, rescale=rescale,
                     clip=self.clip_gradient)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (``nag_mom_update``)."""

    _nesterov = True


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: w -= lr / 2 * (g + wd * w)
    and adds N(0, lr) noise.  The noise comes from ``generator`` (a
    ``torch.Generator`` on the weight's device), else from
    ``mx.np.random``'s generator of that device; the JAX package's comes
    from ``fold_in(key(0), t)``, which torch cannot reproduce."""

    def __init__(self, learning_rate=0.01, generator=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.generator = generator

    def _noise(self, t, w):
        """Standard normal noise of ``w``'s shape for step ``t``."""
        from ..numpy import random as _random
        gen = self.generator if self.generator is not None \
            else _random.generator(w.device)
        return torch.randn(w.shape, generator=gen, dtype=torch.float32,
                           device=w.device)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        wf = w.float()
        g = g + wd * wf
        noise = self._noise(t, w) * math.sqrt(lr)
        return (wf - 0.5 * lr * g + noise).to(w.dtype), ()


@register
class Signum(Optimizer):
    """signSGD with momentum (``signum_update``)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return () if self.momentum == 0.0 else (_zeros32(weight),)

    def _scalar_args(self, index):
        return (self.momentum, self.wd_lh)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        momentum, wd_lh = scalars
        wf = w.float()
        if state:
            (mom,) = state
            mom = momentum * mom - (1 - momentum) * (g + wd * wf)
            new_w = (1 - lr * wd_lh) * wf + lr * torch.sign(mom)
            return new_w.to(w.dtype), (mom,)
        new_w = (1 - lr * wd_lh) * wf - lr * torch.sign(g + wd * wf)
        return new_w.to(w.dtype), ()


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lamda=0.04,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros32(weight),
                _tensor(weight).detach().to(torch.float32, copy=True))

    def _scalar_args(self, index):
        return (self.momentum, self.lamda)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        momentum, lamda = scalars
        mom, prev = state
        wf = w.float()
        g = g + wd * wf
        mom = momentum * mom - lr * (g + lamda * g * g * (wf - prev))
        new_w = wf + mom
        return new_w.to(w.dtype), (mom, new_w)


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-07, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight),)

    def _scalar_args(self, index):
        return (self.epsilon,)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        (eps,) = scalars
        (hist,) = state
        wf = w.float()
        g = g + wd * wf
        hist = hist + g * g
        return (wf - lr * g / (hist.sqrt() + eps)).to(w.dtype), (hist,)


@register
class AdaDelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _scalar_args(self, index):
        return (self.rho, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        rho, eps = scalars
        acc_g, acc_delta = state
        wf = w.float()
        g = g + wd * wf
        acc_g = rho * acc_g + (1 - rho) * g * g
        delta = (acc_delta + eps).sqrt() / (acc_g + eps).sqrt() * g
        acc_delta = rho * acc_delta + (1 - rho) * delta * delta
        return (wf - lr * delta).to(w.dtype), (acc_g, acc_delta)


@register
class Adam(Optimizer):
    """Adam with float32 moments; ``correct_bias`` divides by
    1 - beta^t.  A list runs as one ``multi_adam`` call per group."""

    _fused = "adam"
    _decoupled = False

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

    @property
    def _bias_correction(self):
        return self.correct_bias

    def _lr_eta(self, lr):
        """(lr, eta) of ``adam_step``: Adam scales the step by lr."""
        return lr, 1.0

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        m, v = state
        ic1, ic2 = (mt.inverse(_om(beta1, t)), mt.inverse(_om(beta2, t))) \
            if self._bias_correction else (1.0, 1.0)
        lr, eta = self._lr_eta(lr)
        new_w, m, v = mt.adam_step(
            w.float(), g, m, v, lr=lr, wd=wd, eta=eta, ic1=ic1, ic2=ic2,
            betas=(beta1, beta2, _om(beta1), _om(beta2)), eps=eps,
            decoupled=self._decoupled)
        return new_w.to(w.dtype), (m, v)

    def _fused_update(self, items, lrs, wds, ts, rescale):
        lr_eta = [self._lr_eta(lr) for lr in lrs]
        mt.multi_adam(_groups(items, 2), [a for a, _ in lr_eta], wds,
                      [e for _, e in lr_eta], ts, beta1=self.beta1,
                      beta2=self.beta2, epsilon=self.epsilon,
                      decoupled=self._decoupled,
                      bias_correction=self._bias_correction,
                      rescale=rescale, clip=self.clip_gradient,
                      f32_scalars=True)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay: w -= lr * (m_hat / (sqrt(v_hat)
    + eps) + wd * w), always bias-corrected."""

    _decoupled = True

    @property
    def _bias_correction(self):
        return True

    def _lr_eta(self, lr):
        return 1.0, lr


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _scalar_args(self, index):
        return (self.beta1, self.beta2)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2 = scalars
        m, u = state
        wf = w.float()
        g = g + wd * wf
        m = beta1 * m + (1 - beta1) * g
        u = torch.maximum(beta2 * u, g.abs())
        lr_t = lr / _om(beta1, t)
        return (wf - lr_t * m / (u + 1e-8)).to(w.dtype), (m, u)


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        # (mean, variance, running product of momentum_t)
        return (_zeros32(weight), _zeros32(weight),
                torch.ones((), dtype=torch.float32,
                           device=_tensor(weight).device))

    def _scalar_args(self, index):
        return (self.beta1, self.beta2, self.epsilon, self.schedule_decay)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps, sd = scalars
        m, v, msched = state
        wf = w.float()
        g = g + wd * wf
        mt_ = beta1 * (1 - 0.5 * math.pow(0.96, t * sd))
        mt1 = beta1 * (1 - 0.5 * math.pow(0.96, (t + 1) * sd))
        msched = msched * mt_           # cumulative prod of momentum_i
        msched_next = msched * mt1
        m = beta1 * m + _om(beta1) * g
        v = beta2 * v + _om(beta2) * g * g
        ghat = g / (1 - msched)
        mhat = m / (1 - msched_next)
        vhat = v / _om(beta2, t)
        mbar = (1 - mt_) * ghat + mt1 * mhat
        return (wf - lr * mbar / (vhat.sqrt() + eps)).to(w.dtype), \
            (m, v, msched)


@register
class Ftrl(Optimizer):
    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _scalar_args(self, index):
        return (self.lamda1, self.beta)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        lamda1, beta = scalars
        z, n = state
        wf = w.float()
        n_new = n + g * g
        sigma = (n_new.sqrt() - n.sqrt()) / lr
        z = z + g - sigma * wf
        new_w = torch.where(
            z.abs() > lamda1,
            -(z - torch.sign(z) * lamda1) / ((beta + n_new.sqrt()) / lr + wd),
            torch.zeros_like(z))
        return new_w.to(w.dtype), (z, n_new)


@register
class FTML(Optimizer):
    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return tuple(_zeros32(weight) for _ in range(3))

    def _scalar_args(self, index):
        return (self.beta1, self.beta2, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        d, v, z = state
        wf = w.float()
        g = g + wd * wf
        v = beta2 * v + _om(beta2) * g * g
        d_t = _om(beta1, t) / lr * ((v / _om(beta2, t)).sqrt() + eps)
        sigma = d_t - beta1 * d
        z = beta1 * z + _om(beta1) * g - sigma * wf
        return (-z / d_t).to(w.dtype), (d_t, v, z)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (``lamb_update_phase1/2``); a list runs
    as one ``multi_lamb`` call per group (its two phases)."""

    _fused = "lamb"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros32(weight), _zeros32(weight))

    def _scalar_args(self, index):
        return (self.beta1, self.beta2, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        m, v = state
        wf = w.float()
        ic1, ic2 = (mt.inverse(_om(beta1, t)), mt.inverse(_om(beta2, t))) \
            if self.bias_correction else (1.0, 1.0)
        r, m, v = mt.lamb_direction(wf, g, m, v, wd, ic1, ic2,
                                    (beta1, beta2, _om(beta1), _om(beta2)),
                                    eps)
        ratio = mt.lamb_ratio(wf, r, self.lower_bound, self.upper_bound)
        return (wf - lr * ratio * r).to(w.dtype), (m, v)

    def _fused_update(self, items, lrs, wds, ts, rescale):
        mt.multi_lamb(_groups(items, 2), lrs, wds, ts, beta1=self.beta1,
                      beta2=self.beta2, epsilon=self.epsilon,
                      bias_correction=self.bias_correction,
                      lower_bound=self.lower_bound,
                      upper_bound=self.upper_bound, rescale=rescale,
                      clip=self.clip_gradient, f32_scalars=True)


def _norm(x):
    return torch.linalg.vector_norm(x)


def _trust(num, den):
    one = torch.ones((), dtype=num.dtype, device=num.device)
    return torch.where((num > 0) & (den > 0), num / den, one)


@register
class LANS(LAMB):
    """LAMB with a normalized gradient and a Nesterov-style second
    direction (eager PyTorch, no kernel yet)."""

    _fused = None

    def _rule(self, w, g, lr, wd, t, scalars, state):
        beta1, beta2, eps = scalars
        m, v = state
        wf = w.float()
        g = g / (_norm(g) + 1e-12)
        m = beta1 * m + _om(beta1) * g
        v = beta2 * v + _om(beta2) * g * g
        mhat = m / _om(beta1, t)
        vhat = v / _om(beta2, t)
        w_norm = _norm(wf)
        r1 = mhat / (vhat.sqrt() + eps) + wd * wf
        r2 = g / (vhat.sqrt() + eps) + wd * wf
        ratio1 = _trust(w_norm, _norm(r1))
        ratio2 = _trust(w_norm, _norm(r2))
        new_w = wf - lr * (beta1 * ratio1 * r1 + _om(beta1) * ratio2 * r2)
        return new_w.to(w.dtype), (m, v)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (eager PyTorch, no kernel yet)."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros32(weight),)

    def _scalar_args(self, index):
        return (self.momentum, self.eta, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        momentum, eta, eps = scalars
        (mom,) = state
        wf = w.float()
        w_norm, g_norm = _norm(wf), _norm(g)
        one = torch.ones((), dtype=w_norm.dtype, device=w_norm.device)
        trust = torch.where((w_norm > 0) & (g_norm > 0),
                            eta * w_norm / (g_norm + wd * w_norm + eps), one)
        g = g + wd * wf
        mom = momentum * mom + trust * lr * g
        return (wf - mom).to(w.dtype), (mom,)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho = rho
        self.momentum = momentum
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return tuple(_zeros32(weight)
                     for _ in range(3 if self.centered else 1))

    def _scalar_args(self, index):
        return (self.rho, self.momentum, self.epsilon)

    def _rule(self, w, g, lr, wd, t, scalars, state):
        rho, momentum, eps = scalars
        wf = w.float()
        g = g + wd * wf
        if self.centered:
            n, gbar, mom = state
            n = rho * n + (1 - rho) * g * g
            gbar = rho * gbar + (1 - rho) * g
            mom = momentum * mom - lr * g / (n - gbar * gbar + eps).sqrt()
            new_w = wf + mom
            st = (n, gbar, mom)
        else:
            (n,) = state
            n = rho * n + (1 - rho) * g * g
            new_w = wf - lr * g / (n.sqrt() + eps)
            st = (n,)
        if self.clip_weights:
            new_w = new_w.clamp(-self.clip_weights, self.clip_weights)
        return new_w.to(w.dtype), st


class Updater:
    """Applies an optimizer to (index, grad, weight) pairs, keeping each
    index's state (the JAX package's :719-773, the KVStore server-side
    updater).  ``get_states`` / ``set_states`` pickle a dict of state
    tuples of numpy arrays, the JAX package's payload."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        weight, grad = _tensor(weight), _tensor(grad)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision([index], [weight], [grad],
                                              [self.states[index]])

    @staticmethod
    def _dump_tree(v):
        if isinstance(v, tuple):
            return tuple(Updater._dump_tree(s) for s in v)
        if torch.is_tensor(v):
            return v.detach().cpu().numpy()
        return v

    @staticmethod
    def _load_tree(v, device):
        if isinstance(v, tuple):
            return tuple(Updater._load_tree(s, device) for s in v)
        if isinstance(v, onp.ndarray):
            return torch.tensor(onp.array(v), device=device)
        return v

    def get_states(self, dump_optimizer=False):
        """The pickled states (and the optimizer, with
        ``dump_optimizer``)."""
        payload = {k: self._dump_tree(v) for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((payload, self.optimizer))
        return pickle.dumps(payload)

    def set_states(self, states, device=None):
        """Restore what :meth:`get_states` (of either package, without
        ``dump_optimizer`` for the JAX one) wrote, onto ``device`` (None:
        the current context)."""
        from ..context import resolve_device
        obj = pickle.loads(states)
        if isinstance(obj, tuple) and len(obj) == 2:
            payload, self.optimizer = obj
        else:
            payload = obj
        dev = resolve_device(device)
        self.states = {k: self._load_tree(v, dev) for k, v in payload.items()}


def get_updater(optimizer):
    return Updater(optimizer)
