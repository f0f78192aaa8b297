"""``mx.npx`` -- MXNet's extensions to the NumPy namespace.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py``.  Each function
runs the port's plain operator (``ops/nn.py``, torch) through
``apply_op`` on NDArrays.  :func:`flash_attention` (:418) goes through
``ops/cuda_ops.flash_attention``: on the card the Hopper flash kernels
(bf16, head_dim 64 / 128) or the general ones (every other dtype and
head_dim), forward and backward; on the CPU their plain versions.
``dropout`` and the samplers draw from ``mx.np.random``'s generator for
the device.

Not ported here, and raising ``NotImplementedError`` with their ROADMAP
queue (5): ``rnn``, ``ctc_loss``, ``im2col`` / ``col2im`` /
``deformable_convolution``, ``custom``, the ``sldwin_atten_*`` ops and
the SSD ``multibox_*`` ops, whose JAX modules (``ops/{rnn,ctc,
sliding}.py``, ``library.py``, ``ndarray/contrib.py``) or detection
pipeline the port does not have yet.
"""
from __future__ import annotations

import builtins as _b

import numpy as _onp
import torch
import torch.nn.functional as F

from .. import autograd as _ag
from ..context import current_context, num_gpus  # noqa: F401
from ..ndarray.ndarray import NDArray, apply_op, as_tensor, to_torch_dtype
from ..numpy import random as _random
from ..ops import cuda_ops as _co
from ..ops import nn as _nn
from .contrib import (box_iou, box_nms, interleaved_matmul_encdec_qk,  # noqa
                      interleaved_matmul_encdec_valatt,
                      interleaved_matmul_selfatt_qk,
                      interleaved_matmul_selfatt_valatt, roi_align,
                      roi_pooling)
from .control_flow import cond, foreach, while_loop  # noqa: F401


# -- numpy-mode switches (the port always has numpy semantics) ------------
def set_np(shape=True, array=True, dtype=False):
    return None


def reset_np():
    return None


def is_np_array():
    return True


def is_np_shape():
    return True


def is_np_default_dtype():
    return False


def use_np(func):
    return func


use_np_array = use_np
use_np_shape = use_np
current_device = current_context


def waitall():
    from ..ndarray.ndarray import waitall as _w
    _w()


def _dt(dtype):
    return to_torch_dtype(dtype)


# -- nn ops -----------------------------------------------------------------
def _masked_fill_neg(x, mask):
    return torch.where(mask.bool(), x, torch.full((), torch.finfo(
        x.dtype).min, dtype=x.dtype, device=x.device))


def softmax(data, axis=-1, length=None, temperature=None, use_length=False,
            dtype=None):
    def g(x, *ln):
        if temperature is not None and temperature != 1.0:
            x = x / temperature
        if ln:
            pos = torch.arange(x.shape[axis], device=x.device)
            shape = [1] * x.dim()
            shape[axis] = -1
            lshape = list(ln[0].shape) + [1] * (x.dim() - ln[0].dim())
            mask = pos.reshape(shape) < ln[0].reshape(lshape)
            x = x.masked_fill(~mask, float("-inf"))
        return torch.softmax(x, axis)
    ins = [data] + ([length] if use_length and length is not None else [])
    out = apply_op(g, ins, "softmax")
    return out.astype(dtype) if dtype is not None else out


def log_softmax(data, axis=-1, temperature=None, dtype=None):
    out = apply_op(lambda x: _nn.log_softmax(x, axis, temperature), [data],
                   "log_softmax")
    return out.astype(dtype) if dtype is not None else out


def masked_softmax(data, mask, axis=-1, temperature=1.0):
    def g(x, m):
        x = _masked_fill_neg(x / temperature, m)
        return torch.where(m.bool(), torch.softmax(x, axis),
                           torch.zeros((), dtype=x.dtype, device=x.device))
    return apply_op(g, [data, mask], "masked_softmax")


def masked_log_softmax(data, mask, axis=-1, temperature=1.0):
    def g(x, m):
        x = _masked_fill_neg(x / temperature, m)
        return torch.where(m.bool(), torch.log_softmax(x, axis),
                           torch.full((), -float("inf"), dtype=x.dtype,
                                      device=x.device))
    return apply_op(g, [data, mask], "masked_log_softmax")


def activation(data, act_type="relu"):
    return apply_op(lambda x: _nn.activation(x, act_type), [data],
                    "activation")


def relu(data):
    return apply_op(torch.relu, [data], "relu")


def sigmoid(data):
    return apply_op(torch.sigmoid, [data], "sigmoid")


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    if act_type == "prelu" and gamma is not None:
        return apply_op(lambda x, g: _nn.leaky_relu(x, "prelu", gamma=g),
                        [data, gamma], "prelu")
    return apply_op(lambda x: _nn.leaky_relu(
        x, act_type, slope=slope, lower_bound=lower_bound,
        upper_bound=upper_bound), [data], act_type)


def gelu(data, approximate=False):
    return apply_op(lambda x: F.gelu(x, approximate="tanh" if approximate
                                     else "none"), [data], "gelu")


def fully_connected(x, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    ins = [x, weight] + ([] if no_bias or bias is None else [bias])
    return apply_op(lambda a, w, *b: _nn.fully_connected(
        a, w, b[0] if b else None, flatten), ins, "fully_connected")


def convolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None):
    ins = [data, weight] + ([] if no_bias or bias is None else [bias])
    return apply_op(lambda x, w, *b: _nn.convolution(
        x, w, b[0] if b else None, stride, pad, dilate, num_group, layout),
        ins, "convolution")


def deconvolution(data=None, weight=None, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=False, target_shape=None, layout=None):
    ins = [data, weight] + ([] if no_bias or bias is None else [bias])

    def g(x, w, *b):
        a = adj
        if target_shape is not None:       # the adj that reaches it
            nsp = x.dim() - 2
            st, pd, dl = (_b.tuple(v) if v is not None else (dv,) * nsp
                          for v, dv in ((stride, 1), (pad, 0), (dilate, 1)))
            a = _b.tuple(t - ((n - 1) * s - 2 * p + d * (k - 1) + 1)
                         for t, n, s, p, d, k in zip(
                             target_shape, x.shape[2:], st, pd, dl,
                             w.shape[2:]))
        return _nn.deconvolution(x, w, b[0] if b else None, stride, pad,
                                 dilate, num_group, a)
    return apply_op(g, ins, "deconvolution")


def pooling(data, kernel=(1, 1), stride=None, pad=None, pool_type="max",
            global_pool=False, count_include_pad=True,
            pooling_convention="valid", layout=None):
    return apply_op(lambda x: _nn.pooling(
        x, kernel, pool_type, stride, pad, global_pool, count_include_pad,
        layout), [data], "pooling")


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               output_mean_var=False, axis=1):
    """Functional batch norm: batch statistics while training (with
    ``output_mean_var``: also returned), else the running ones."""
    training = _ag.is_training() and not use_global_stats

    def g(a, gm, b, rm, rv):
        if fix_gamma:
            gm = torch.ones_like(gm)
        if training:
            return _nn.batch_norm_train(a, gm, b, eps, axis)
        return _nn.batch_norm_inference(a, gm, b, rm, rv, eps, axis)
    outs = apply_op(g, [x, gamma, beta, running_mean, running_var],
                    "batch_norm")
    if not training:
        return (outs, running_mean, running_var) if output_mean_var else outs
    return tuple(outs) if output_mean_var else outs[0]


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return apply_op(lambda x, g, b: _nn.layer_norm(x, g, b, axis, eps),
                    [data, gamma, beta], "layer_norm")


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    return apply_op(lambda x, g, b: _nn.group_norm(x, g, b, num_groups, eps),
                    [data, gamma, beta], "group_norm")


def instance_norm(data, gamma, beta, eps=1e-5):
    return apply_op(lambda x, g, b: _nn.instance_norm(x, g, b, eps),
                    [data, gamma, beta], "instance_norm")


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    return apply_op(lambda x, g: _nn.rms_norm(x, g, axis, eps),
                    [data, gamma], "rms_norm")


def l2_normalization(data, eps=1e-10, mode="instance"):
    def g(x):
        dims = {"instance": tuple(range(1, x.dim())), "channel": (1,),
                "spatial": tuple(range(2, x.dim()))}[mode]
        return x / torch.sqrt((x * x).sum(dims, keepdim=True) + eps)
    return apply_op(g, [data], "l2_normalization")


def dropout(data, p=0.5, axes=None, mode="training"):
    """Inverted dropout while training (or always, ``mode="always"``),
    the mask drawn from ``mx.np.random``'s generator for the device."""
    if not _ag.is_training() and mode != "always":
        return data
    gen = _random.generator(data._data.device)
    return apply_op(lambda x: _nn.dropout(x, p, gen, axes), [data],
                    "dropout")


def embedding(data, weight, input_dim=None, output_dim=None, dtype=None,
              sparse_grad=False):
    return apply_op(_nn.embedding, [data, weight], "embedding")


def one_hot(data, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """An index outside [0, depth) gives a row of ``off_value``, as
    ``jax.nn.one_hot`` and MXNet do."""
    def f(i):
        hot = i.long()[..., None] == torch.arange(depth, device=i.device)
        return hot.to(_dt(dtype)) * (on_value - off_value) + off_value
    return apply_op(f, [data], "one_hot")


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    return apply_op(lambda x, i: _nn.pick(x, i, axis, keepdims, mode),
                    [data, index], "pick")


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    def g(x):
        vals, idx = torch.topk(x, k, dim=axis, largest=not is_ascend,
                               sorted=True)
        if ret_typ == "value":
            return vals
        if ret_typ == "indices":
            return idx.to(_dt(dtype))
        if ret_typ == "both":
            return vals, idx.to(_dt(dtype))
        if ret_typ == "mask":
            return torch.zeros_like(x, dtype=torch.int32).scatter_(
                axis, idx, 1)
        raise ValueError(ret_typ)
    return apply_op(g, [data], "topk")


def gather_nd(data, indices):
    return apply_op(lambda d, i: d[tuple(i.long())], [data, indices],
                    "gather_nd")


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data

    def g(x, ln):
        shape = [1] * x.dim()
        shape[axis] = -1
        lshape = [1] * x.dim()
        lshape[1 if axis == 0 else 0] = -1
        mask = torch.arange(x.shape[axis], device=x.device).reshape(shape) \
            < ln.reshape(lshape)
        return torch.where(mask, x, torch.full((), value, dtype=x.dtype,
                                               device=x.device))
    return apply_op(g, [data, sequence_length], "sequence_mask")


def reshape_like(lhs, rhs):
    return lhs.reshape(rhs.shape)


def shape_array(data):
    return NDArray(torch.tensor(data.shape, dtype=torch.int64,
                                device=data._data.device))


def cast(data, dtype):
    return data.astype(dtype)


def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    n = data.size if axis is None else data.shape[axis]
    a = start + step * torch.arange(n, dtype=torch.float32,
                                    device=data._data.device)
    return NDArray(a.reshape(data.shape) if axis is None else a)


def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    return lhs.broadcast_to(rhs.shape)


def smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return apply_op(lambda x: torch.where(
        torch.abs(x) < 1.0 / s2, 0.5 * s2 * x * x, torch.abs(x) - 0.5 / s2),
        [data], "smooth_l1")


def erf(data):
    return apply_op(torch.erf, [data], "erf")


def erfinv(data):
    return apply_op(torch.erfinv, [data], "erfinv")


def gamma(data):
    return apply_op(lambda x: torch.exp(torch.lgamma(x)), [data], "gamma")


def gammaln(data):
    return apply_op(torch.lgamma, [data], "gammaln")


def digamma(data):
    return apply_op(torch.digamma, [data], "digamma")


def slice(data, begin, end, step=None):  # noqa: A001
    nd = data.ndim
    begin = tuple(begin) + (None,) * (nd - len(begin))
    end = tuple(end) + (None,) * (nd - len(end))
    step = tuple(step) + (None,) * (nd - len(step)) if step else (None,) * nd
    return data[tuple(_b.slice(b, e, s) for b, e, s in zip(begin, end, step))]


def slice_axis(data, axis, begin, end):
    key = [_b.slice(None)] * data.ndim
    key[axis] = _b.slice(begin, end)
    return data[tuple(key)]


def slice_like(data, shape_like, axes=None):
    like = shape_like.shape
    key = [_b.slice(None)] * data.ndim
    for a in (axes if axes is not None
              else range(min(data.ndim, len(like)))):
        key[a] = _b.slice(0, like[a])
    return data[tuple(key)]


def multi_sum_sq(*arrays, num_arrays=None):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return apply_op(lambda *xs: [(x.float() * x.float()).sum() for x in xs],
                    list(arrays), "multi_sum_sq")


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so their joint 2-norm is at most
    ``max_norm``; returns the norm before scaling."""
    total = torch.sqrt(_b.sum((a._data.float() ** 2).sum() for a in arrays))
    scale = torch.clamp(max_norm / (total + 1e-12), max=1.0)
    for a in arrays:
        a[...] = NDArray((a._data.float() * scale).to(a._data.dtype))
    return float(total)


def flash_attention(query, key, value, causal=False, scale=None,
                    block_q=128, block_k=128):
    """Online-softmax attention over (B, H, T, D) NDArrays, key / value
    with H_kv dividing H; differentiable under ``autograd.record()``.
    On the card: the hand-written flash kernels (Hopper at bf16 with
    head_dim 64 / 128, the general ones otherwise); on the CPU their
    plain versions.  ``block_q`` / ``block_k`` are the TPU kernel's
    tiles and change nothing here."""
    return apply_op(lambda q, k, v: _co.flash_attention(
        q, k, v, causal=causal, scale=scale), [query, key, value],
        "flash_attention")


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
              forward_stype=None):
    def g(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(g, [lhs, rhs], "batch_dot")


def scatter_nd(data, indices, shape):
    def g(d, idx):
        out = torch.zeros(shape, dtype=d.dtype, device=d.device)
        out[tuple(idx.long())] = d
        return out
    return apply_op(g, [data, indices], "scatter_nd")


def index_add(A, ind, val):
    return apply_op(lambda a, i, v: a.index_put(tuple(i.long()), v,
                                                accumulate=True),
                    [A, ind, val], "index_add")


def index_update(A, ind, val):
    return apply_op(lambda a, i, v: a.index_put(tuple(i.long()), v),
                    [A, ind, val], "index_update")


def constraint_check(data, msg="Constraint violated!"):
    if not bool(data._data.all()):
        raise ValueError(msg)
    return NDArray(torch.ones((), dtype=torch.bool,
                              device=data._data.device))


def seed(seed_state, ctx="all"):
    _random.seed(seed_state, ctx)


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              device=None, out=None):
    return _random.bernoulli(prob, logit, size, dtype, ctx, device, out)


def _sample_n(sampler, name):
    def f(a=0.0, b=1.0, batch_shape=None, dtype=None, ctx=None, device=None):
        at = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
        bt = b._data if isinstance(b, NDArray) else torch.as_tensor(b)
        event = torch.broadcast_shapes(at.shape, bt.shape)
        shape = (tuple(batch_shape) if batch_shape is not None else ()) + \
            tuple(event)
        return sampler(a, b, size=shape, dtype=dtype, ctx=ctx, device=device)
    f.__name__ = name
    return f


uniform_n = _sample_n(_random.uniform, "uniform_n")
normal_n = _sample_n(_random.normal, "normal_n")


def save(file, arr):
    """Save an NDArray, or a list / dict of them, as ``.npy`` / ``.npz``."""
    if isinstance(arr, NDArray):
        _onp.save(file, arr.asnumpy())
    elif isinstance(arr, dict):
        _onp.savez(file, **{k: v.asnumpy() for k, v in arr.items()})
    else:
        _onp.savez(file, *[v.asnumpy() for v in arr])


def savez(file, *args, **kwargs):
    _onp.savez(file, *[a.asnumpy() for a in args],
               **{k: v.asnumpy() for k, v in kwargs.items()})


def load(file):
    """An NDArray (``.npy``) or a dict of them (``.npz``), on the current
    context."""
    r = _onp.load(file)
    if isinstance(r, _onp.ndarray):
        return NDArray(as_tensor(r, r.dtype))
    with r:
        return {k: NDArray(as_tensor(r[k], r[k].dtype)) for k in r.files}


def _not_ported(name):
    def f(*args, **kwargs):
        raise NotImplementedError("mxnet_tpu_torch: npx.%s is not ported yet "
                                  "(ROADMAP queue 5)" % name)
    f.__name__ = name
    return f


for _name in ("rnn", "ctc_loss", "im2col", "col2im", "deformable_convolution",
              "custom", "sldwin_atten_score", "sldwin_atten_context",
              "sldwin_atten_mask_like", "multibox_prior", "multibox_target",
              "multibox_detection"):
    globals()[_name] = _not_ported(_name)
