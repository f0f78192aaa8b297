"""Optimizer update *ops* -- the ``mx.nd.sgd_update`` family.

Counterpart of ``mxnet_tpu/ndarray/op_updates.py`` (all 39 names of its
``__all__``), over the port's :class:`NDArray`.  State arrays (``mom``,
``mean``, ``var``, ``weight32``, ...) are updated in place; ``out=None``
gives a fresh NDArray for the new weight, and ``out=weight`` updates the
weight in place (another ``out`` receives the new weight).  Multi-tensor
variants take the reference's flat interleaved input list and return a
list of outputs.

The SGD family (``sgd_*``, ``mp_sgd_*``, ``nag_*``, ``multi_sgd_*``,
``multi_mp_sgd_*``, ``preloaded_multi_*``), ``adam_update``,
``adamw_update``, ``mp_adamw_update``, ``multi_adamw_update``,
``multi_mp_adamw_update``, ``multi_lamb_update`` and
``multi_mp_lamb_update`` run through ``ops/multi_tensor.py``: one
hand-written kernel launch for the whole list on the card (LAMB: its
two phases), the plain version on the CPU.  They compute in float32 and
round the new weight into the weight's dtype.  The others (FTML, FTRL,
RMSProp, signSGD, Signum, the single LAMB phases, LANS, LARS,
``all_finite``, ``reset_arrays`` and the AdaGrad ops) are plain
PyTorch on the arrays' device.
"""
from __future__ import annotations

import torch

from ..ops import multi_tensor as mt
from .ndarray import NDArray, as_tensor

__all__ = [
    "sgd_update", "sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
    "nag_mom_update", "mp_nag_mom_update", "adam_update", "adamw_update",
    "mp_adamw_update", "ftml_update", "ftrl_update", "rmsprop_update",
    "rmspropalex_update", "signsgd_update", "signum_update",
    "lamb_update_phase1", "lamb_update_phase2", "mp_lamb_update_phase1",
    "mp_lamb_update_phase2", "multi_sgd_update", "multi_sgd_mom_update",
    "multi_mp_sgd_update", "multi_mp_sgd_mom_update",
    "preloaded_multi_sgd_update", "preloaded_multi_sgd_mom_update",
    "preloaded_multi_mp_sgd_update", "preloaded_multi_mp_sgd_mom_update",
    "multi_lamb_update", "multi_mp_lamb_update", "multi_lans_update",
    "multi_mp_lans_update", "multi_adamw_update", "multi_mp_adamw_update",
    "multi_lars", "all_finite", "multi_all_finite", "reset_arrays",
    "sparse_adagrad_update", "group_adagrad_update",
]


def _a(x):
    return x._data if isinstance(x, NDArray) else as_tensor(x)


def _set(nd, t):
    """Write ``t`` into the NDArray ``nd`` in place (its dtype kept)."""
    nd._data.copy_(t)


def _emit(out, t, like):
    """The new weight ``t``: a fresh NDArray of ``like``'s dtype, or
    written into ``out``."""
    if out is None:
        return NDArray(t.to(like._data.dtype))
    _set(out, t)
    return out


def _target(weight, out):
    """(the tensor a kernel-backed op updates, what it returns): a copy of
    the weight for ``out=None``, else ``out`` holding the weight."""
    w = _a(weight)
    if out is None:
        res = NDArray(w.clone())
        return res._data, res
    if out._data.data_ptr() != w.data_ptr():
        _set(out, w)
    return out._data, out


def _clip(clip_gradient):
    return clip_gradient if clip_gradient >= 0 else None


def _grad_rescaled(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    return g


# ----------------------------------------------------------------------
# SGD family: one multi_sgd call
# ----------------------------------------------------------------------
def _sgd_multi(groups, lrs, wds, outs, momentum=0.0, nesterov=False,
               rescale_grad=1.0, clip_gradient=-1.0):
    """``groups`` of (weight, grad, mom or None, weight32 or None)."""
    res, plan = [], []
    for (wt, gr, mom, w32), o in zip(groups, outs):
        t, r = _target(wt, o)
        res.append(r)
        plan.append((t, _a(gr), None if mom is None else _a(mom),
                     None if w32 is None else _a(w32)))
    mt.multi_sgd(plan, lrs, wds, momentum=momentum, nesterov=nesterov,
                 rescale=rescale_grad, clip=_clip(clip_gradient))
    return res


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True, out=None):
    return _sgd_multi([(weight, grad, None, None)], [lr], [wd], [out],
                      rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)[0]


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None):
    return _sgd_multi([(weight, grad, mom, None)], [lr], [wd], [out],
                      momentum, False, rescale_grad, clip_gradient)[0]


def mp_sgd_update(weight, grad, weight32, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True, out=None):
    return _sgd_multi([(weight, grad, None, weight32)], [lr], [wd], [out],
                      rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)[0]


def mp_sgd_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                      out=None):
    return _sgd_multi([(weight, grad, mom, weight32)], [lr], [wd], [out],
                      momentum, False, rescale_grad, clip_gradient)[0]


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, out=None):
    return _sgd_multi([(weight, grad, mom, None)], [lr], [wd], [out],
                      momentum, True, rescale_grad, clip_gradient)[0]


def mp_nag_mom_update(weight, grad, mom, weight32, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, out=None):
    return _sgd_multi([(weight, grad, mom, weight32)], [lr], [wd], [out],
                      momentum, True, rescale_grad, clip_gradient)[0]


# ----------------------------------------------------------------------
# Adam / AdamW: one multi_adam call
# ----------------------------------------------------------------------
def _adam_multi(groups, lrs, wds, etas, outs, beta1, beta2, epsilon,
                decoupled, rescale, clip_gradient):
    """``groups`` of (weight, grad, mean, var, weight32 or None); no bias
    correction (the ops take bias-corrected lr from the caller)."""
    res, plan = [], []
    for (wt, gr, m, v, w32), o in zip(groups, outs):
        t, r = _target(wt, o)
        res.append(r)
        plan.append((t, _a(gr), _a(m), _a(v),
                     None if w32 is None else _a(w32)))
    if isinstance(rescale, NDArray):
        rescale = rescale._data
    mt.multi_adam(plan, lrs, wds, etas, beta1=beta1, beta2=beta2,
                  epsilon=epsilon, decoupled=decoupled,
                  bias_correction=False, rescale=rescale,
                  clip=_clip(clip_gradient))
    return res


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True, out=None):
    return _adam_multi([(weight, grad, mean, var, None)], [lr], [wd], [1.0],
                       [out], beta1, beta2, epsilon, False, rescale_grad,
                       clip_gradient)[0]


def adamw_update(weight, grad, mean, var, rescale_grad, lr, eta, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, clip_gradient=-1.0,
                 out=None):
    """Decoupled weight decay: w -= eta*(lr*m/(sqrt(v)+eps) + wd*w).

    ``rescale_grad`` is an NDArray (the reference passes it as the last
    input so a dynamic loss scale never leaves the device,
    ``adamw-inl.h:71-74``); the kernel reads it on the device."""
    return _adam_multi([(weight, grad, mean, var, None)], [lr], [wd], [eta],
                       [out], beta1, beta2, epsilon, True, rescale_grad,
                       clip_gradient)[0]


def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad, lr, eta,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    clip_gradient=-1.0, out=None):
    return _adam_multi([(weight, grad, mean, var, weight32)], [lr], [wd],
                       [eta], [out], beta1, beta2, epsilon, True,
                       rescale_grad, clip_gradient)[0]


# ----------------------------------------------------------------------
# FTML / FTRL
# ----------------------------------------------------------------------
def ftml_update(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0,
                out=None):
    w, g = _a(weight), _a(grad)
    dd, vv, zz = _a(d), _a(v), _a(z)
    g = _grad_rescaled(g, rescale_grad, clip_grad) + wd * w
    vv = beta2 * vv + (1 - beta2) * g * g
    d_t = (1 - beta1 ** t) / lr * ((vv / (1 - beta2 ** t)).sqrt() + epsilon)
    zz = beta1 * zz + (1 - beta1) * g - (d_t - beta1 * dd) * w
    _set(v, vv)
    _set(z, zz)
    _set(d, d_t)
    return _emit(out, -zz / d_t, weight)


def ftrl_update(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0, out=None):
    w, g = _a(weight), _a(grad)
    zz, nn = _a(z), _a(n)
    g = _grad_rescaled(g, rescale_grad, clip_gradient)
    zz = zz + g - ((nn + g * g).sqrt() - nn.sqrt()) * w / lr
    nn = nn + g * g
    _set(z, zz)
    _set(n, nn)
    d = -torch.sign(zz) * torch.clamp(zz.abs() - lamda1, min=0.0)
    return _emit(out, d / ((beta + nn.sqrt()) / lr + wd), weight)


# ----------------------------------------------------------------------
# RMSProp (and the Alex Graves variant)
# ----------------------------------------------------------------------
def rmsprop_update(weight, grad, n, lr, rho=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0,
                   out=None):
    w, g, nn = _a(weight), _a(grad), _a(n)
    g = _grad_rescaled(g, rescale_grad, clip_gradient) + wd * w
    nn = (1 - rho) * g * g + rho * nn
    _set(n, nn)
    new_w = w - lr * g / (nn.sqrt() + epsilon)
    if clip_weights >= 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return _emit(out, new_w, weight)


def rmspropalex_update(weight, grad, n, g, delta, lr, rho=0.95, momentum=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0, out=None):
    w, gr = _a(weight), _a(grad)
    nn, gg, dd = _a(n), _a(g), _a(delta)
    gr = _grad_rescaled(gr, rescale_grad, clip_gradient) + wd * w
    nn = (1 - rho) * gr * gr + rho * nn
    gg = (1 - rho) * gr + rho * gg
    dd = momentum * dd - lr * gr / (nn - gg * gg + epsilon).sqrt()
    _set(n, nn)
    _set(g, gg)
    _set(delta, dd)
    new_w = w + dd
    if clip_weights >= 0:
        new_w = new_w.clamp(-clip_weights, clip_weights)
    return _emit(out, new_w, weight)


# ----------------------------------------------------------------------
# Sign-based
# ----------------------------------------------------------------------
def signsgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, out=None):
    w, g = _a(weight), _a(grad)
    # rescale / clip before sign: a negative rescale_grad flips the step
    g = _grad_rescaled(g, rescale_grad, clip_gradient)
    return _emit(out, (1 - lr * wd) * w - lr * torch.sign(g), weight)


def signum_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0, out=None):
    w, g, m = _a(weight), _a(grad), _a(mom)
    g = _grad_rescaled(g, rescale_grad, clip_gradient) + wd * w
    m = momentum * m - (1 - momentum) * g
    _set(mom, m)
    return _emit(out, (1 - lr * wd_lh) * w + lr * torch.sign(m), weight)


# ----------------------------------------------------------------------
# LAMB's single phases
# ----------------------------------------------------------------------
def lamb_update_phase1(weight, grad, mean, var, t, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0, out=None):
    w, g = _a(weight), _a(grad)
    g = _grad_rescaled(g, rescale_grad, clip_gradient)
    ic1, ic2 = (mt.inverse(1 - beta1 ** t), mt.inverse(1 - beta2 ** t)) \
        if bias_correction else (1.0, 1.0)
    upd, m, v = mt.lamb_direction(w, g, _a(mean), _a(var), wd, ic1, ic2,
                                  (beta1, beta2, 1 - beta1, 1 - beta2),
                                  epsilon)
    _set(mean, m)
    _set(var, v)
    return _emit(out, upd, weight)


def lamb_update_phase2(weight, g, r1, r2, lr, lower_bound=-1.0,
                       upper_bound=-1.0, out=None):
    w, gg = _a(weight), _a(g)
    r1v, r2v = _a(r1).reshape(()), _a(r2).reshape(())
    if lower_bound >= 0:
        r1v = torch.clamp(r1v, min=lower_bound)
    if upper_bound >= 0:
        r1v = torch.clamp(r1v, max=upper_bound)
    one = torch.ones_like(r1v)
    ratio = torch.where((r1v == 0) | (r2v == 0), one,
                        r1v / torch.where(r2v == 0, one, r2v))
    return _emit(out, w - lr * ratio * gg, weight)


def mp_lamb_update_phase1(weight, grad, mean, var, weight32, t, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, bias_correction=True,
                          wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                          out=None):
    return lamb_update_phase1(weight32, _a(grad).float(), mean, var, t,
                              beta1, beta2, epsilon, bias_correction, wd,
                              rescale_grad, clip_gradient, out=out)


def mp_lamb_update_phase2(weight, g, r1, r2, weight32, lr, lower_bound=-1.0,
                          upper_bound=-1.0, out=None):
    new = lamb_update_phase2(weight32, g, r1, r2, lr, lower_bound,
                             upper_bound)
    _set(weight32, new._data)
    return _emit(out, new._data, weight)


# ----------------------------------------------------------------------
# Multi-tensor SGD family
# ----------------------------------------------------------------------
def _multi(data, stride, num_weights):
    data = list(data)
    assert len(data) >= stride * num_weights, \
        "expected %d arrays, got %d" % (stride * num_weights, len(data))
    return [data[i * stride:(i + 1) * stride] for i in range(num_weights)]


def _outs(out, n):
    """Broadcast the ``out`` argument of a multi-tensor op to n slots."""
    if isinstance(out, (list, tuple)):
        assert len(out) == n, "out list length %d != num tensors %d" \
            % (len(out), n)
        return list(out)
    return [out] * n


def _scalar_list(vals, n):
    vals = list(vals)
    assert len(vals) == n
    return vals


def multi_sgd_update(*data, lrs=None, wds=None, rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1, out=None):
    groups = [(w, g, None, None) for w, g in _multi(data, 2, num_weights)]
    return _sgd_multi(groups, _scalar_list(lrs, num_weights),
                      _scalar_list(wds, num_weights),
                      _outs(out, num_weights), rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)


def multi_sgd_mom_update(*data, lrs=None, wds=None, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0, num_weights=1,
                         out=None):
    groups = [(w, g, m, None) for w, g, m in _multi(data, 3, num_weights)]
    return _sgd_multi(groups, _scalar_list(lrs, num_weights),
                      _scalar_list(wds, num_weights),
                      _outs(out, num_weights), momentum, False, rescale_grad,
                      clip_gradient)


def multi_mp_sgd_update(*data, lrs=None, wds=None, rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1, out=None):
    groups = [(w, g, None, w32)
              for w, g, w32 in _multi(data, 3, num_weights)]
    return _sgd_multi(groups, _scalar_list(lrs, num_weights),
                      _scalar_list(wds, num_weights),
                      _outs(out, num_weights), rescale_grad=rescale_grad,
                      clip_gradient=clip_gradient)


def multi_mp_sgd_mom_update(*data, lrs=None, wds=None, momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1, out=None):
    groups = [tuple(grp) for grp in _multi(data, 4, num_weights)]
    return _sgd_multi(groups, _scalar_list(lrs, num_weights),
                      _scalar_list(wds, num_weights),
                      _outs(out, num_weights), momentum, False, rescale_grad,
                      clip_gradient)


def _preloaded(data, stride, num_weights):
    """Split off the trailing lrs / wds arrays (the preloaded_* variants
    pass hyper-parameters as arrays)."""
    data = list(data)
    assert len(data) == stride * num_weights + 2, \
        "expected %d tensors + trailing lrs/wds arrays, got %d" \
        % (stride * num_weights, len(data))
    lrs = [float(x) for x in _a(data[-2]).reshape(-1).tolist()]
    wds = [float(x) for x in _a(data[-1]).reshape(-1).tolist()]
    return data[:-2], lrs, wds


def preloaded_multi_sgd_update(*data, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=1, out=None):
    arrays, lrs, wds = _preloaded(data, 2, num_weights)
    return multi_sgd_update(*arrays, lrs=lrs, wds=wds,
                            rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient,
                            num_weights=num_weights, out=out)


def preloaded_multi_sgd_mom_update(*data, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1,
                                   out=None):
    arrays, lrs, wds = _preloaded(data, 3, num_weights)
    return multi_sgd_mom_update(*arrays, lrs=lrs, wds=wds, momentum=momentum,
                                rescale_grad=rescale_grad,
                                clip_gradient=clip_gradient,
                                num_weights=num_weights, out=out)


def preloaded_multi_mp_sgd_update(*data, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=1,
                                  out=None):
    arrays, lrs, wds = _preloaded(data, 3, num_weights)
    return multi_mp_sgd_update(*arrays, lrs=lrs, wds=wds,
                               rescale_grad=rescale_grad,
                               clip_gradient=clip_gradient,
                               num_weights=num_weights, out=out)


def preloaded_multi_mp_sgd_mom_update(*data, momentum=0.0, rescale_grad=1.0,
                                      clip_gradient=-1.0, num_weights=1,
                                      out=None):
    arrays, lrs, wds = _preloaded(data, 4, num_weights)
    return multi_mp_sgd_mom_update(*arrays, lrs=lrs, wds=wds,
                                   momentum=momentum,
                                   rescale_grad=rescale_grad,
                                   clip_gradient=clip_gradient,
                                   num_weights=num_weights, out=out)


# ----------------------------------------------------------------------
# Multi-tensor LAMB / LANS / AdamW
# ----------------------------------------------------------------------
def _bound(b):
    return b if b >= 0 else None


def _multi_lamb(data, learning_rates, wds, step_count, num_tensors, beta1,
                beta2, epsilon, rescale_grad, lower_bound, upper_bound,
                clip_gradient, bias_correction, out, mp):
    """multi_lamb / multi_mp_lamb: one multi_lamb call (both phases)."""
    groups = _multi(data, 5 if mp else 4, num_tensors)
    res, plan = [], []
    for grp, o in zip(groups, _outs(out, num_tensors)):
        t, r = _target(grp[0], o)
        res.append(r)
        plan.append((t, _a(grp[1]), _a(grp[2]), _a(grp[3]),
                     _a(grp[4]) if mp else None))
    mt.multi_lamb(plan, _scalar_list(learning_rates, num_tensors),
                  _scalar_list(wds, num_tensors),
                  _scalar_list(step_count, num_tensors), beta1=beta1,
                  beta2=beta2, epsilon=epsilon,
                  bias_correction=bias_correction,
                  lower_bound=_bound(lower_bound),
                  upper_bound=_bound(upper_bound), rescale=rescale_grad,
                  clip=_clip(clip_gradient))
    return res


def multi_lamb_update(*data, learning_rates=None, wds=None, step_count=None,
                      beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                      bias_correction=True, num_tensors=1, out=None):
    return _multi_lamb(data, learning_rates, wds, step_count, num_tensors,
                       beta1, beta2, epsilon, rescale_grad, lower_bound,
                       upper_bound, clip_gradient, bias_correction, out,
                       mp=False)


def multi_mp_lamb_update(*data, learning_rates=None, wds=None,
                         step_count=None, beta1=0.9, beta2=0.999,
                         epsilon=1e-6, rescale_grad=1.0, lower_bound=-1.0,
                         upper_bound=-1.0, clip_gradient=-1.0,
                         bias_correction=True, num_tensors=1, out=None):
    return _multi_lamb(data, learning_rates, wds, step_count, num_tensors,
                       beta1, beta2, epsilon, rescale_grad, lower_bound,
                       upper_bound, clip_gradient, bias_correction, out,
                       mp=True)


def _lans_one(w, g, m, v, lr, wd, step, beta1, beta2, epsilon, rescale_grad,
              clip_gradient, lower_bound, upper_bound):
    """One tensor of multi_lans: (new_w, new_m, new_v)."""
    g = g * rescale_grad
    gnorm = torch.linalg.vector_norm(g)
    g = g / torch.where(gnorm == 0.0, torch.ones_like(gnorm), gnorm)
    if clip_gradient >= 0:
        g = g.clamp(-clip_gradient, clip_gradient)
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    denom = (v / (1 - beta2 ** step)).sqrt() + epsilon
    r1 = torch.linalg.vector_norm(w)
    if lower_bound >= 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound >= 0:
        r1 = torch.clamp(r1, max=upper_bound)

    def ratio(r2):
        one = torch.ones_like(r2)
        return torch.where((r1 == 0.0) | (r2 == 0.0), one,
                           r1 / torch.where(r2 == 0.0, one, r2))

    upd_m = (m / (1 - beta1 ** step)) / denom + wd * w
    upd_g = g / denom + wd * w
    r2m = torch.linalg.vector_norm(upd_m)
    r2g = torch.linalg.vector_norm(upd_g)
    new_w = w - lr * beta1 * ratio(r2m) * upd_m \
        - lr * (1 - beta1) * ratio(r2g) * upd_g
    return new_w, m, v


def _multi_lans(data, learning_rates, wds, step_count, num_tensors, beta1,
                beta2, epsilon, rescale_grad, lower_bound, upper_bound,
                clip_gradient, out, mp):
    groups = _multi(data, 5 if mp else 4, num_tensors)
    res = []
    for grp, lr, wd, t, o in zip(
            groups, _scalar_list(learning_rates, num_tensors),
            _scalar_list(wds, num_tensors),
            _scalar_list(step_count, num_tensors), _outs(out, num_tensors)):
        wt, gr, mean, var = grp[:4]
        w = _a(grp[4]) if mp else _a(wt)
        new_w, m, v = _lans_one(w, _a(gr).to(w.dtype), _a(mean), _a(var), lr,
                                wd, t, beta1, beta2, epsilon, rescale_grad,
                                clip_gradient, lower_bound, upper_bound)
        _set(mean, m)
        _set(var, v)
        if mp:
            _set(grp[4], new_w)
        res.append(_emit(o, new_w, wt))
    return res


def multi_lans_update(*data, learning_rates=None, wds=None, step_count=None,
                      beta1=0.9, beta2=0.999, epsilon=1e-6, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0, clip_gradient=-1.0,
                      num_tensors=1, out=None):
    return _multi_lans(data, learning_rates, wds, step_count, num_tensors,
                       beta1, beta2, epsilon, rescale_grad, lower_bound,
                       upper_bound, clip_gradient, out, mp=False)


def multi_mp_lans_update(*data, learning_rates=None, wds=None,
                         step_count=None, beta1=0.9, beta2=0.999,
                         epsilon=1e-6, rescale_grad=1.0, lower_bound=-1.0,
                         upper_bound=-1.0, clip_gradient=-1.0, num_tensors=1,
                         out=None):
    return _multi_lans(data, learning_rates, wds, step_count, num_tensors,
                       beta1, beta2, epsilon, rescale_grad, lower_bound,
                       upper_bound, clip_gradient, out, mp=True)


def _multi_adamw(data, lrs, wds, etas, beta1, beta2, epsilon, clip_gradient,
                 num_weights, out, mp):
    """Multi-tensor AdamW; the last input is the rescale array
    (``adamw-inl.h:71-74``)."""
    data = list(data)
    groups = [tuple(grp) if mp else tuple(grp) + (None,)
              for grp in _multi(data[:-1], 5 if mp else 4, num_weights)]
    return _adam_multi(groups, _scalar_list(lrs, num_weights),
                       _scalar_list(wds, num_weights),
                       _scalar_list(etas, num_weights),
                       _outs(out, num_weights), beta1, beta2, epsilon, True,
                       data[-1], clip_gradient)


def multi_adamw_update(*data, lrs=None, wds=None, etas=None, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                       num_weights=1, out=None):
    return _multi_adamw(data, lrs, wds, etas, beta1, beta2, epsilon,
                        clip_gradient, num_weights, out, mp=False)


def multi_mp_adamw_update(*data, lrs=None, wds=None, etas=None, beta1=0.9,
                          beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                          num_weights=1, out=None):
    return _multi_adamw(data, lrs, wds, etas, beta1, beta2, epsilon,
                        clip_gradient, num_weights, out, mp=True)


# ----------------------------------------------------------------------
# LARS / finiteness / utility
# ----------------------------------------------------------------------
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta, eps,
               rescale_grad=1.0, out=None):
    lr_a = _a(lrs).float()
    w_sq, g_sq = _a(weights_sum_sq).float(), _a(grads_sum_sq).float()
    wd_a = _a(wds).float()
    w_norm = w_sq.sqrt()
    valid = (w_norm > 0) & (g_sq > 0)
    new = torch.where(
        valid,
        lr_a * eta * w_norm / (g_sq.sqrt() * rescale_grad + wd_a * w_norm
                               + eps), lr_a)
    return _emit(out, new, lrs if isinstance(lrs, NDArray) else NDArray(lr_a))


def _finite_result(ok, init_output, out):
    res = ok.to(torch.float32).reshape(1)
    if out is not None and not init_output:
        res = torch.minimum(res, _a(out).float().reshape(1))
    if out is None:
        return NDArray(res)
    _set(out, res)
    return out


def all_finite(data, init_output=True, out=None):
    return _finite_result(torch.isfinite(_a(data).float()).all(),
                          init_output, out)


def multi_all_finite(*arrays, num_arrays=1, init_output=True, out=None):
    oks = [torch.isfinite(_a(a).float()).all() for a in arrays[:num_arrays]]
    return _finite_result(torch.stack(oks).all(), init_output, out)


def reset_arrays(*arrays, num_arrays=None):
    """Zero each array in place (used to clear gradient buffers between
    accumulation windows)."""
    n = num_arrays if num_arrays is not None else len(arrays)
    for a in arrays[:n]:
        _a(a).zero_()


# ----------------------------------------------------------------------
# AdaGrad (sparse and grouped)
# ----------------------------------------------------------------------
def sparse_adagrad_update(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """Elementwise AdaGrad (the reference's row-sparse op, run dense as
    the JAX package runs it)."""
    w, g, h = _a(weight), _a(grad), _a(history)
    g = _grad_rescaled(g, rescale_grad, clip_gradient) + wd * w
    h = h + g * g
    _set(history, h)
    return _emit(out, w - lr * g / (h.sqrt() + epsilon), weight)


def group_adagrad_update(weight, grad, history, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0, out=None):
    """Per-row (group) AdaGrad: the history holds one value per row."""
    w, g, h = _a(weight), _a(grad), _a(history)
    g = _grad_rescaled(g, rescale_grad, clip_gradient)
    h = h + (g * g).mean(dim=tuple(range(1, g.dim())))
    _set(history, h)
    denom = (h.sqrt() + epsilon).reshape((-1,) + (1,) * (g.dim() - 1))
    return _emit(out, w - lr * g / denom, weight)
