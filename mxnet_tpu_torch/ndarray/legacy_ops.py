"""The legacy ``mx.nd.*`` operator namespace over torch.

Counterpart of ``mxnet_tpu/ndarray/legacy_ops.py``: MXNet 1.x's
CamelCase layers (``FullyConnected``, ``Convolution``, ``BatchNorm``,
...), which are ``mx.npx``'s functions under their old names, and the
legacy-only semantics, reproduced as the reference computes them:

* ``reshape``'s 0 / -1 / -2 / -3 / -4 codes (``_legacy_reshape_shape``);
  ``reverse=True`` is accepted and ignored, as in the reference;
* comparisons (``broadcast_equal``, ``greater``, ...) return the lhs
  dtype, not bool;
* ``take`` always clips its indices, whatever ``mode`` says;
* ``argmax`` / ``argmin`` ignore ``keepdims``;
* ``sort(is_ascend=False)`` is an ascending sort then a flip, so equal
  values come out in reverse order of position (``torch.sort(
  descending=True)`` keeps them in order);
* ``SoftmaxOutput`` is a forward softmax whose gradient is plain
  autograd's through the softmax, not MXNet 1.x's fused cross-entropy
  gradient (ROADMAP section 3);
* ``UpSampling(sample_type="bilinear")`` resizes as ``jax.image.resize``
  does (:func:`resize_like_jax`: half-pixel centres, antialiased when
  shrinking).

``RNN``, ``CTCLoss`` / ``ctc_loss``, ``im2col`` / ``col2im`` and
``DeformableConvolution`` wait for ROADMAP queue 5 item 3 (sequence
models), ``Custom`` for item 5 (``mx.library``): they raise
``NotImplementedError`` naming the item.  Every other op runs on its
inputs' device.
"""
from __future__ import annotations

import builtins as _b

import torch
import torch.nn.functional as F

from .. import numpy_extension as _npx
from ..numpy import random as _random
from ..numpy_extension import contrib as _npx_contrib
from .ndarray import NDArray, apply_op, to_torch_dtype

__all__ = [
    "FullyConnected", "Convolution", "Deconvolution", "Activation",
    "BatchNorm", "Pooling", "Dropout", "Embedding", "LeakyReLU", "RNN",
    "softmax", "log_softmax", "SoftmaxOutput", "SoftmaxActivation",
    "LayerNorm", "InstanceNorm", "L2Normalization", "GroupNorm",
    "concat", "Concat", "reshape", "Reshape", "flatten", "Flatten",
    "transpose", "dot", "batch_dot", "one_hot", "pick", "topk", "sort",
    "argsort", "argmax", "argmin", "clip", "where", "stack", "split",
    "SliceChannel", "tile", "repeat", "expand_dims", "squeeze", "cast",
    "Cast", "norm", "sum", "mean", "max", "min", "prod", "slice",
    "slice_axis", "slice_like", "broadcast_add", "broadcast_sub",
    "broadcast_mul", "broadcast_div", "broadcast_maximum",
    "broadcast_minimum", "broadcast_power", "broadcast_equal",
    "broadcast_not_equal", "broadcast_greater", "broadcast_lesser",
    "broadcast_to", "broadcast_like", "broadcast_axis", "elemwise_add",
    "elemwise_sub", "elemwise_mul", "elemwise_div", "add_n", "UpSampling",
    "SequenceMask", "SequenceLast", "SequenceReverse", "gather_nd",
    "scatter_nd", "take", "sigmoid", "relu", "tanh", "exp", "log", "sqrt",
    "square", "abs", "sign", "round", "ceil", "floor", "rint", "trunc",
    "negative", "reciprocal", "power", "maximum", "minimum", "zeros_like",
    "ones_like", "smooth_l1", "make_loss", "stop_gradient", "BlockGrad",
    "identity", "shape_array", "size_array", "erf", "erfinv", "gamma",
    "gammaln", "logical_not", "batch_take", "diag", "khatri_rao",
    "im2col", "col2im", "CTCLoss", "ctc_loss", "DeformableConvolution",
    "linspace", "eye", "full_like", "swapaxes", "SwapAxis", "flip",
    "reverse", "pad", "Pad", "add", "subtract", "multiply", "divide",
    "mod", "equal", "not_equal", "greater", "lesser", "greater_equal",
    "lesser_equal", "softmax_cross_entropy", "Custom", "random_uniform",
    "random_normal", "random_randint", "random_gamma", "sample_gamma",
    "uniform", "normal", "save", "load", "LRN", "GridGenerator",
    "BilinearSampler", "SpatialTransformer", "ROIPooling", "linalg_gemm",
    "linalg_gemm2", "linalg_potrf", "linalg_syrk", "linalg_trsm",
    "linalg_potri", "linalg_trmm", "linalg_syevd", "linalg_gelqf",
    "linalg_inverse", "linalg_det", "linalg_slogdet", "linalg_sumlogdiag",
    "linalg_extractdiag", "linalg_makediag", "linalg_extracttrian",
    "linalg_maketrian", "Correlation", "moments", "softmin",
    "depth_to_space", "space_to_depth", "argmax_channel", "amp_cast",
    "amp_multicast", "cast_storage", "sample_multinomial", "split_v2"]

# -- mx.npx under the legacy names (same semantics) ------------------------
FullyConnected = _npx.fully_connected
Convolution = _npx.convolution
Deconvolution = _npx.deconvolution
BatchNorm = _npx.batch_norm
Pooling = _npx.pooling
Embedding = _npx.embedding
LeakyReLU = _npx.leaky_relu
softmax = _npx.softmax
log_softmax = _npx.log_softmax
LayerNorm = _npx.layer_norm
InstanceNorm = _npx.instance_norm
GroupNorm = _npx.group_norm
L2Normalization = _npx.l2_normalization
one_hot = _npx.one_hot
pick = _npx.pick
topk = _npx.topk
gather_nd = _npx.gather_nd
smooth_l1 = _npx.smooth_l1
erf = _npx.erf
erfinv = _npx.erfinv
gamma = _npx.gamma
gammaln = _npx.gammaln
slice = _npx.slice  # noqa: A001
slice_axis = _npx.slice_axis
slice_like = _npx.slice_like
SequenceMask = _npx.sequence_mask
shape_array = _npx.shape_array
cast = _npx.cast
Cast = _npx.cast
ROIPooling = _npx_contrib.roi_pooling


def _waits(name, item, what):
    def f(*args, **kwargs):
        raise NotImplementedError(
            "mxnet_tpu_torch: mx.nd.%s is not ported yet (ROADMAP queue 5 "
            "item %d, %s)" % (name, item, what))
    f.__name__ = name
    return f


RNN = _waits("RNN", 3, "sequence models")
im2col = _waits("im2col", 3, "sequence models")
col2im = _waits("col2im", 3, "sequence models")
CTCLoss = ctc_loss = _waits("CTCLoss", 3, "sequence models")
DeformableConvolution = _waits("DeformableConvolution", 3,
                               "sequence models")
Custom = _waits("Custom", 5, "mx.library")


def Activation(data, act_type="relu", **kw):
    return _npx.activation(data, act_type)


def Dropout(data, p=0.5, mode="training", axes=(), **kw):
    return _npx.dropout(data, p=p, axes=axes, mode=mode)


def SoftmaxOutput(data, label=None, grad_scale=1.0, ignore_label=-1,
                  multi_output=False, use_ignore=False, preserve_shape=False,
                  normalization="null", out_grad=False, smooth_alpha=0.0,
                  **kw):
    """Softmax over the last axis (axis 1 with ``multi_output``); its
    gradient is autograd's through the softmax, as in the reference (not
    MXNet 1.x's cross-entropy gradient): compose it with a loss."""
    return _npx.softmax(data, axis=-1 if not multi_output else 1)


SoftmaxActivation = SoftmaxOutput


# -- shapes ----------------------------------------------------------------
def _legacy_reshape_shape(shape_spec, src_shape):
    """The 0 / -1 / -2 / -3 / -4 codes (``matrix_op.cc`` Reshape) against
    the source shape; a -1 stays for torch to infer."""
    out = []
    src = list(src_shape)
    i = j = 0
    spec = list(shape_spec)
    while j < len(spec):
        s = spec[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = spec[j + 1], spec[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    return tuple(out)


def reshape(data, shape=None, reverse=False, **kw):
    """Legacy reshape; ``reverse`` is accepted and ignored, as in the
    reference."""
    if shape is None:
        raise ValueError("shape required")
    spec = tuple(shape)
    new_shape = _legacy_reshape_shape(spec, data.shape) \
        if any(s in (0, -2, -3, -4) for s in spec) else spec
    return apply_op(lambda x: x.reshape(new_shape), [data], "reshape")


Reshape = reshape


def flatten(data, **kw):
    return data.flatten()


Flatten = flatten


def transpose(data, axes=None, **kw):
    return data.transpose(*(axes or ()))


def _dot(a, b):
    """``jnp.dot``: the last axis of ``a`` against the second-to-last of
    ``b`` (its only axis for a vector); a 0-d operand multiplies."""
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [_b.max(b.dim() - 2,
                                                              0)]))


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    def g(a, b):
        if transpose_a:
            a = a.T if a.dim() == 2 else torch.movedim(a, 0, -1)
        if transpose_b:
            b = b.T if b.dim() == 2 else torch.movedim(b, -1, 0)
        return _dot(a, b)
    return apply_op(g, [lhs, rhs], "dot")


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    def g(a, b):
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)
    return apply_op(g, [lhs, rhs], "batch_dot")


def _listed(data):
    if len(data) == 1 and isinstance(data[0], (list, tuple)):
        return tuple(data[0])
    return data


def concat(*data, dim=1, **kw):
    return apply_op(lambda *xs: torch.cat(xs, dim), list(_listed(data)),
                    "concat")


Concat = concat


def stack(*data, axis=0, **kw):
    return apply_op(lambda *xs: torch.stack(xs, axis), list(_listed(data)),
                    "stack")


def _split(x, sections, axis, squeeze_axis):
    n = x.shape[axis]
    if isinstance(sections, int):
        if n % sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        parts = torch.split(x, n // sections, axis)
    else:
        bounds = [0] + [_b.min(_b.max(int(s), 0), n) for s in sections] + [n]
        parts = [x.narrow(axis, lo, _b.max(hi - lo, 0))
                 for lo, hi in zip(bounds[:-1], bounds[1:])]
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return list(parts)


def split(data, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    res = apply_op(lambda x: _split(x, num_outputs, axis, squeeze_axis),
                   [data], "split")
    return list(res) if isinstance(res, (list, tuple)) else [res]


SliceChannel = split


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy-style split (``matrix_op.cc`` _split_v2): a count of equal
    sections or the indices to cut at."""
    return apply_op(lambda x: _split(x, indices_or_sections, axis,
                                     squeeze_axis), [data], "split_v2")


def tile(data, reps, **kw):
    return data.tile(reps)


def repeat(data, repeats, axis=None, **kw):
    return data.repeat(repeats, axis)


def expand_dims(data, axis, **kw):
    return data.expand_dims(axis)


def squeeze(data, axis=None, **kw):
    return data.squeeze(axis)


def swapaxes(data, dim1=0, dim2=1, **kw):
    return apply_op(lambda x: x.transpose(dim1, dim2), [data], "swapaxes")


SwapAxis = swapaxes


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def flip(data, axis=None, **kw):
    return apply_op(lambda x: x.flip(_axes(axis, x.dim())), [data], "flip")


reverse = flip


def _pad_index(n, before, after, mode, device):
    """Source positions of an axis of ``n`` padded by (before, after):
    "edge" repeats the end values, "reflect" mirrors about them (numpy's
    modes)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1) if n > 1 else 1
    i = i.remainder(period)
    return torch.where(i > n - 1, period - i, i)


def pad(data, mode="constant", pad_width=None, constant_value=0.0, **kw):
    """Legacy Pad (``src/operator/pad.cc``): ``pad_width`` is 2 * ndim
    values, (before, after) per axis; modes constant, edge, reflect."""
    pw = tuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)

    def g(x):
        if mode == "constant":
            flat = [v for pair in reversed(pairs) for v in pair]
            return F.pad(x, flat, value=constant_value)
        for ax, (lo, hi) in enumerate(pairs):
            if lo or hi:
                x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                                  x.device))
        return x
    return apply_op(g, [data], "pad")


Pad = pad


# -- reductions, sorting, selection --------------------------------------
def norm(data, ord=2, axis=None, keepdims=False, **kw):  # noqa: A002
    def g(x):
        x = x if x.is_floating_point() or x.is_complex() else x.float()
        if axis is None:
            return torch.linalg.norm(x.reshape(-1), ord=ord, keepdim=keepdims)
        return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)
    return apply_op(g, [data], "norm")


def sum(data, axis=None, keepdims=False, **kw):  # noqa: A001
    return data.sum(axis=axis, keepdims=keepdims)


def mean(data, axis=None, keepdims=False, **kw):
    return data.mean(axis=axis, keepdims=keepdims)


def max(data, axis=None, keepdims=False, **kw):  # noqa: A001
    return data.max(axis=axis, keepdims=keepdims)


def min(data, axis=None, keepdims=False, **kw):  # noqa: A001
    return data.min(axis=axis, keepdims=keepdims)


def prod(data, axis=None, keepdims=False, **kw):
    return data.prod(axis=axis, keepdims=keepdims)


def sort(data, axis=-1, is_ascend=True, **kw):
    """Descending = the ascending sort flipped: ties in reverse order."""
    r = data.sort(axis=axis)
    if not is_ascend:
        return apply_op(lambda x: x.flip(axis), [r], "flip")
    return r


def argsort(data, axis=-1, is_ascend=True, **kw):
    return data.argsort(axis=axis, is_ascend=is_ascend)


def argmax(data, axis=None, keepdims=False, **kw):
    """``keepdims`` is ignored, as in the reference."""
    return data.argmax(axis=axis)


def argmin(data, axis=None, keepdims=False, **kw):
    return data.argmin(axis=axis)


def argmax_channel(data):
    """Argmax along axis 1, in the input's dtype (the Module-era predict
    helper)."""
    return apply_op(lambda x: x.argmax(1).to(x.dtype), [data],
                    "argmax_channel")


def clip(data, a_min, a_max, **kw):
    return data.clip(a_min, a_max)


def where(condition, x, y, **kw):
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b),
                    [condition, x, y], "where")


def take(a, indices, axis=0, mode="clip", **kw):
    """``jnp.take(..., mode="clip")`` whatever ``mode`` says."""
    def g(x, i):
        ax = axis % x.dim()
        idx = i.long().clamp(0, x.shape[ax] - 1)
        out = torch.movedim(x, ax, 0)[idx]
        k = idx.dim()
        return torch.movedim(out, tuple(range(k)), tuple(range(ax, ax + k)))
    return apply_op(g, [a, indices], "take")


def batch_take(a, indices, **kw):
    def g(x, i):
        i = i.long()
        i = torch.where(i < 0, i + x.shape[1], i)
        return torch.gather(x, 1, i[:, None])[:, 0]
    return apply_op(g, [a, indices], "batch_take")


def scatter_nd(data, indices, shape, **kw):
    def g(d, i):
        out = torch.zeros(tuple(shape), dtype=d.dtype, device=d.device)
        out[tuple(i[k].long() for k in range(i.shape[0]))] = d
        return out
    return apply_op(g, [data, indices], "scatter_nd")


# -- the broadcast_* family ----------------------------------------------
def _bin(name, fn):
    def f(lhs, rhs, **kw):
        return apply_op(fn, [lhs, rhs], name)
    f.__name__ = name
    return f


def _cmp(name, fn):
    """A comparison in the lhs dtype (1 / 0), as the reference's."""
    return _bin(name, lambda a, b: fn(a, b).to(a.dtype))


broadcast_add = _bin("broadcast_add", torch.add)
broadcast_sub = _bin("broadcast_sub", torch.sub)
broadcast_mul = _bin("broadcast_mul", torch.mul)
broadcast_div = _bin("broadcast_div", torch.true_divide)
broadcast_maximum = _bin("broadcast_maximum", torch.maximum)
broadcast_minimum = _bin("broadcast_minimum", torch.minimum)
broadcast_power = _bin("broadcast_power", torch.pow)
broadcast_equal = _cmp("broadcast_equal", torch.eq)
broadcast_not_equal = _cmp("broadcast_not_equal", torch.ne)
broadcast_greater = _cmp("broadcast_greater", torch.gt)
broadcast_lesser = _cmp("broadcast_lesser", torch.lt)
elemwise_add = add = broadcast_add
elemwise_sub = subtract = broadcast_sub
elemwise_mul = multiply = broadcast_mul
elemwise_div = divide = broadcast_div
power = broadcast_power
maximum = broadcast_maximum
minimum = broadcast_minimum
equal = broadcast_equal
not_equal = broadcast_not_equal
greater = broadcast_greater
lesser = broadcast_lesser
greater_equal = _cmp("greater_equal", torch.ge)
lesser_equal = _cmp("lesser_equal", torch.le)


def mod(lhs, rhs, **kw):
    """``mx.np.mod``'s (numpy's sign; an integer modulo 0 as JAX gives
    it)."""
    return _np_mod().mod(lhs, rhs)


def broadcast_to(data, shape, **kw):
    return data.broadcast_to(shape)


def broadcast_like(lhs, rhs, **kw):
    return lhs.broadcast_to(rhs.shape)


def broadcast_axis(data, axis=None, size=None, **kw):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    sizes = size if isinstance(size, (list, tuple)) else [size]
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return data.broadcast_to(tuple(shape))


def add_n(*args, **kw):
    def g(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out
    return apply_op(g, list(_listed(args)), "add_n")


ElementWiseSum = add_n


# -- elementwise -----------------------------------------------------------
def _unary(name, fn):
    def f(data, **kw):
        return apply_op(fn, [data], name)
    f.__name__ = name
    return f


def _flt(fn):
    return lambda x: fn(x if x.is_floating_point() else x.float())


sigmoid = _unary("sigmoid", _flt(torch.sigmoid))
relu = _unary("relu", torch.relu)
tanh = _unary("tanh", _flt(torch.tanh))
exp = _unary("exp", _flt(torch.exp))
log = _unary("log", _flt(torch.log))
sqrt = _unary("sqrt", _flt(torch.sqrt))
square = _unary("square", torch.square)
abs = _unary("abs", torch.abs)  # noqa: A001
sign = _unary("sign", torch.sign)
round = _unary("round", torch.round)  # noqa: A001
ceil = _unary("ceil", torch.ceil)
floor = _unary("floor", torch.floor)
rint = _unary("rint", torch.round)
trunc = _unary("trunc", torch.trunc)
negative = _unary("negative", torch.neg)
reciprocal = _unary("reciprocal", torch.reciprocal)
logical_not = _unary("logical_not",
                     lambda x: torch.logical_not(x).to(torch.float32))


def make_loss(data, **kw):
    return data


def stop_gradient(data, **kw):
    return data.detach()


BlockGrad = stop_gradient


def identity(data, **kw):
    return data


def size_array(data, **kw):
    """[size] as int32 (the JAX package's int64 without 64-bit types)."""
    return NDArray(torch.tensor([data.size], dtype=torch.int32,
                                device=data._data.device))


def zeros_like(data, **kw):
    return apply_op(torch.zeros_like, [data], "zeros_like")


def ones_like(data, **kw):
    return apply_op(torch.ones_like, [data], "ones_like")


def diag(data, k=0, **kw):
    return data.diag(k)


def khatri_rao(*args, **kw):
    """Column-wise Kronecker product of matrices with equal column
    counts."""
    def g(*xs):
        out = xs[0]
        for x in xs[1:]:
            out = (out[:, None, :] * x[None, :, :]).reshape(-1, out.shape[-1])
        return out
    return apply_op(g, list(args), "khatri_rao")


# -- creation and random ----------------------------------------------------
def _np_mod():
    from .. import numpy as mnp
    return mnp


def linspace(start, stop, num=50, endpoint=True, ctx=None, dtype=None, **kw):
    return _np_mod().linspace(start, stop, num, endpoint=endpoint,
                              dtype=dtype, ctx=ctx)


def eye(N, M=None, k=0, ctx=None, dtype=None, **kw):
    return _np_mod().eye(N, M, k=k, dtype=dtype, ctx=ctx)


def full_like(data, fill_value, **kw):
    return _np_mod().full_like(data, fill_value)


def random_uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None, **kw):
    return _random.uniform(low, high, size=shape, dtype=dtype, ctx=ctx)


def random_normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None, **kw):
    return _random.normal(loc, scale, size=shape, dtype=dtype, ctx=ctx)


def random_randint(low, high, shape=(1,), dtype=None, ctx=None, **kw):
    return _random.randint(low, high, size=shape, dtype=dtype or "int32",
                           ctx=ctx)


def random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None, **kw):
    return _random.gamma(alpha, beta, size=shape, dtype=dtype, ctx=ctx)


sample_gamma = random_gamma
uniform = random_uniform
normal = random_normal


def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Class indices drawn from probability rows (the last axis), from
    ``mx.np.random``'s generator of the device; out shape
    ``data.shape[:-1] + shape``, with the log-probability of each draw
    when ``get_prob``."""
    extra = tuple(shape) if isinstance(shape, (tuple, list)) \
        else ((shape,) if shape else ())
    n = 1
    for s in extra:
        n *= s
    gen = _random.generator(data._data.device)

    def g(p):
        flat = p.reshape(-1, p.shape[-1]).float()
        draws = torch.multinomial(flat.clamp_min(1e-37), _b.max(n, 1),
                                  replacement=True, generator=gen)
        idx = draws.reshape(p.shape[:-1] + extra).to(to_torch_dtype(dtype))
        if not get_prob:
            return idx
        logp = torch.gather(torch.log(flat.clamp_min(1e-37)), 1, draws)
        return idx, logp.reshape(idx.shape)
    return apply_op(g, [data], "sample_multinomial")


# -- save / load -------------------------------------------------------------
_ND_LIST_SENTINEL = "__mx_nd_list__"


def save(fname, data):
    """An NDArray, or a list / dict of them, into one npz file (the JAX
    package's format: bf16 and sparse storage tagged); a list is marked
    so that it loads back as a list."""
    from ..utils import serialization
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {str(i): v for i, v in enumerate(data)}
        data[_ND_LIST_SENTINEL] = torch.zeros((0,))
    serialization.savez(fname, **data)


def load(fname):
    """The arrays of :func:`save` (either package's) on the current
    context: a list if a list was saved, else a dict."""
    from ..utils import serialization
    d = serialization.load(fname)
    if isinstance(d, list):
        raise ValueError("parameter file %s has no names" % fname)
    if _ND_LIST_SENTINEL in d:
        d.pop(_ND_LIST_SENTINEL)
        return [d[str(i)] for i in range(len(d))]
    return d


# -- layers of the legacy tail ----------------------------------------------
def UpSampling(data, scale=2, sample_type="nearest", num_args=1, **kw):
    if sample_type == "nearest":
        def g(x):
            return x.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    else:
        def g(x):
            n, c, h, w = x.shape
            return resize_like_jax(x, (h * scale, w * scale), "linear")
    return apply_op(g, [data], "upsampling")


def resize_like_jax(x, size, method="linear"):
    """``jax.image.resize`` of an (N, C, H, W) tensor to ``size`` = (h, w),
    computed in float32: "linear" samples at half-pixel centres with a
    triangle kernel widened by the scale when shrinking (antialiased),
    "nearest" at half-pixel centres; the result in ``x``'s dtype."""
    xf = x.float()
    if tuple(size) == tuple(x.shape[-2:]):
        out = xf
    elif method == "nearest":
        out = F.interpolate(xf, size=tuple(size), mode="nearest-exact")
    else:
        out = F.interpolate(xf, size=tuple(size), mode="bilinear",
                            align_corners=False, antialias=True)
    return out.to(x.dtype)


def _seq_first(x, axis):
    return torch.movedim(x, axis, 0)


def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0, **kw):
    def g(x, *ln):
        if not use_sequence_length or not ln:
            return x.select(axis, x.shape[axis] - 1)
        xs = _seq_first(x, axis)                     # (T, B, ...)
        idx = (ln[0] - 1).long().reshape((1, -1) + (1,) * (xs.dim() - 2))
        return torch.gather(xs, 0, idx.expand((1,) + xs.shape[1:]))[0]
    ins = [data] + ([sequence_length] if sequence_length is not None else [])
    return apply_op(g, ins, "SequenceLast")


def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0, **kw):
    def g(x, *ln):
        if not use_sequence_length or not ln:
            return x.flip(axis)
        xs = _seq_first(x, axis)
        T = xs.shape[0]
        steps = torch.arange(T, device=x.device).reshape(
            (-1,) + (1,) * (xs.dim() - 1))
        lens = ln[0].long().reshape((1, -1) + (1,) * (xs.dim() - 2))
        rev = torch.where(steps < lens, lens - 1 - steps, steps)
        out = torch.gather(xs, 0, rev.expand(xs.shape))
        return torch.movedim(out, 0, axis)
    ins = [data] + ([sequence_length] if sequence_length is not None else [])
    return apply_op(g, ins, "SequenceReverse")


def softmax_cross_entropy(data, label, **kw):
    """Summed cross-entropy of softmax(data) against integer labels, as a
    1-element array (``loss_binary_op.cc``)."""
    def g(d, lab):
        lp = torch.log_softmax(d, -1)
        return -torch.gather(lp, -1, lab.long().reshape(-1, 1)).sum() \
            .reshape(1)
    return apply_op(g, [data, label], "softmax_cross_entropy")


def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response norm across channels (``lrn.cc``):
    x / (knorm + alpha / nsize * sum of x^2 over the window)^beta."""
    def g(x):
        half = nsize // 2
        sq = F.pad(torch.square(x).movedim(1, -1), (half, half)) \
            .movedim(-1, 1)
        acc = sq[:, 0:x.shape[1]]
        for i in range(1, nsize):
            acc = acc + sq[:, i:i + x.shape[1]]
        return x / torch.pow(knorm + (alpha / nsize) * acc, beta)
    return apply_op(g, [data], "LRN")


def GridGenerator(data, transform_type="affine", target_shape=None, **kw):
    """Sampling grid (``grid_generator.cc``): ``"affine"`` maps (N, 6)
    parameters onto the normalized (N, 2, H, W) grid of ``target_shape``;
    ``"warp"`` adds a pixel flow (N, 2, H, W) to the pixel grid and
    normalizes it to [-1, 1]."""
    if transform_type == "warp":
        def gw(flow):
            n, _, h, w = flow.shape
            ys = torch.arange(h, dtype=flow.dtype, device=flow.device)
            xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            nx = 2.0 * (gx[None] + flow[:, 0]) / (w - 1 if w > 1 else 1) - 1.0
            ny = 2.0 * (gy[None] + flow[:, 1]) / (h - 1 if h > 1 else 1) - 1.0
            return torch.stack([nx, ny], 1)
        return apply_op(gw, [data], "GridGenerator")
    h, w = target_shape

    def g(theta):
        n = theta.shape[0]
        ys = torch.linspace(-1, 1, h, dtype=theta.dtype, device=theta.device)
        xs = torch.linspace(-1, 1, w, dtype=theta.dtype, device=theta.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)], 0)
        out = torch.einsum("nij,jk->nik", theta.reshape(n, 2, 3), base)
        return out.reshape(n, 2, h, w)
    return apply_op(g, [data], "GridGenerator")


def BilinearSampler(data, grid, **kw):
    """``data`` sampled at the grid's points in [-1, 1] (-1 the first
    pixel's centre, 1 the last's), bilinearly, zero outside
    (``bilinear_sampler.cc``)."""
    def g(x, grd):
        return F.grid_sample(x, grd.permute(0, 2, 3, 1).to(x.dtype),
                             mode="bilinear", padding_mode="zeros",
                             align_corners=True)
    return apply_op(g, [data, grid], "BilinearSampler")


def SpatialTransformer(data, loc, target_shape=None, transform_type="affine",
                       sampler_type="bilinear", **kw):
    """GridGenerator then BilinearSampler (``spatial_transformer.cc``)."""
    return BilinearSampler(data, GridGenerator(loc, transform_type,
                                               target_shape=target_shape))


def Correlation(data1, data2, kernel_size=1, max_displacement=4, stride1=1,
                stride2=1, pad_size=4, is_multiply=True, **kw):
    """FlowNet cost volume (``correlation.cc``), kernel_size 1 and stride1
    1: out[n, d, y, x] is the channel mean of f1[n, :, y, x] times (or
    the absolute difference from) f2 shifted by the d-th displacement."""
    if kernel_size != 1 or stride1 != 1:
        raise NotImplementedError("Correlation: kernel_size=1, stride1=1")
    if pad_size < max_displacement:
        raise NotImplementedError(
            "Correlation: pad_size (%d) must cover max_displacement (%d); "
            "smaller pads would silently clamp the shift window"
            % (pad_size, max_displacement))
    D = max_displacement // stride2

    def g(f1, f2):
        n, c, h, w = f1.shape
        f2p = F.pad(f2, (pad_size,) * 4)
        outs = []
        for dy in range(-D, D + 1):
            for dx in range(-D, D + 1):
                oy, ox = pad_size + dy * stride2, pad_size + dx * stride2
                sh = f2p[:, :, oy:oy + h, ox:ox + w]
                outs.append((f1 * sh).mean(1) if is_multiply
                            else (f1 - sh).abs().mean(1))
        return torch.stack(outs, 1)
    return apply_op(g, [data1, data2], "Correlation")


def moments(data, axes=None, keepdims=False):
    """(mean, var) over ``axes`` (``moments.cc``; var with ddof 0)."""
    ax = (axes,) if isinstance(axes, int) else \
        (tuple(axes) if axes is not None else None)

    def g(x):
        dims = ax if ax is not None else tuple(range(x.dim()))
        return (x.mean(dims, keepdim=keepdims),
                x.var(dims, correction=0, keepdim=keepdims))
    return apply_op(g, [data], "moments")


def softmin(data, axis=-1, temperature=None):
    """softmax(-x / temperature)."""
    def g(x):
        z = -x if temperature is None else -x / temperature
        return torch.softmax(z, axis)
    return apply_op(g, [data], "softmin")


def depth_to_space(data, block_size):
    """NCHW depth to space blocks (``matrix_op.cc:990``)."""
    b = int(block_size)

    def g(x):
        n, c, h, w = x.shape
        y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return y.reshape(n, c // (b * b), h * b, w * b)
    return apply_op(g, [data], "depth_to_space")


def space_to_depth(data, block_size):
    """The inverse of :func:`depth_to_space` (``matrix_op.cc:1047``)."""
    b = int(block_size)

    def g(x):
        n, c, h, w = x.shape
        y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return y.reshape(n, c * b * b, h // b, w // b)
    return apply_op(g, [data], "space_to_depth")


def amp_cast(data, dtype):
    """The cast AMP inserts (``amp_cast.cc``)."""
    dt = to_torch_dtype(dtype)
    return apply_op(lambda x: x.to(dt), [data], "amp_cast")


_AMP_ORDER = {torch.float16: 0, torch.bfloat16: 0, torch.float32: 1,
              torch.float64: 2}


def amp_multicast(*data, num_outputs=None, cast_narrow=False):
    """A group of arrays cast to their widest (or, with ``cast_narrow``,
    narrowest) float type; the first of equals wins."""
    arrays = list(data[:num_outputs] if num_outputs else data)
    dts = [a._data.dtype for a in arrays]
    key = lambda d: _AMP_ORDER.get(d, 1)  # noqa: E731
    pick_dt = _b.min(dts, key=key) if cast_narrow else _b.max(dts, key=key)
    return [apply_op(lambda x: x.to(pick_dt), [a], "amp_multicast")
            for a in arrays]


def cast_storage(data, stype="default"):
    """Storage cast (``cast_storage.cc``): dense storage backs every
    stype, so a sparse stype wraps the same values in its view class and
    ``"default"`` gives the plain array."""
    from . import sparse as _sp
    if stype == "row_sparse":
        return _sp.RowSparseNDArray(data)
    if stype == "csr":
        return _sp.CSRNDArray(data)
    if hasattr(data, "tostype"):
        return data.tostype("default")
    return data


# -- linalg_* (src/operator/tensor/la_op.cc) ------------------------------
def _t2(x):
    return x.transpose(-1, -2)


def linalg_gemm(A, B, C, alpha=1.0, beta=1.0, transpose_a=False,
                transpose_b=False, **kw):
    def g(a, b, c):
        a = _t2(a) if transpose_a else a
        b = _t2(b) if transpose_b else b
        return alpha * torch.matmul(a, b) + beta * c
    return apply_op(g, [A, B, C], "linalg_gemm")


def linalg_gemm2(A, B, alpha=1.0, transpose_a=False, transpose_b=False,
                 **kw):
    def g(a, b):
        a = _t2(a) if transpose_a else a
        b = _t2(b) if transpose_b else b
        return alpha * torch.matmul(a, b)
    return apply_op(g, [A, B], "linalg_gemm2")


def linalg_potrf(A, **kw):
    return apply_op(torch.linalg.cholesky, [A], "linalg_potrf")


def linalg_syrk(A, alpha=1.0, transpose=False, **kw):
    def g(a):
        return alpha * (torch.matmul(_t2(a), a) if transpose
                        else torch.matmul(a, _t2(a)))
    return apply_op(g, [A], "linalg_syrk")


def linalg_trsm(A, B, alpha=1.0, rightside=False, lower=True,
                transpose=False, **kw):
    """alpha * op(A)^-1 B (or B op(A)^-1) with A triangular; only its
    ``lower`` (or upper) triangle is read."""
    def g(a, b):
        a = _t2(a) if transpose else a
        low = lower != transpose
        if rightside:
            xt = torch.linalg.solve_triangular(_t2(a), _t2(b), upper=low)
            return alpha * _t2(xt)
        return alpha * torch.linalg.solve_triangular(a, b, upper=not low)
    return apply_op(g, [A, B], "linalg_trsm")


def linalg_potri(A, **kw):
    """The inverse of B = A A^T from its Cholesky factor A."""
    def g(a):
        eye_ = torch.eye(a.shape[-1], dtype=a.dtype,
                         device=a.device).expand(a.shape)
        ainv = torch.linalg.solve_triangular(a, eye_, upper=False)
        return torch.matmul(_t2(ainv), ainv)
    return apply_op(g, [A], "linalg_potri")


def linalg_trmm(A, B, alpha=1.0, transpose=False, rightside=False,
                lower=True, **kw):
    """alpha * op(A) B (or B op(A)) with A's ``lower`` / upper triangle."""
    def g(a, b):
        a = torch.tril(a) if lower else torch.triu(a)
        a = _t2(a) if transpose else a
        return alpha * (torch.matmul(b, a) if rightside
                        else torch.matmul(a, b))
    return apply_op(g, [A, B], "linalg_trmm")


def linalg_syevd(A, **kw):
    """(U, L) with A = U^T diag(L) U: the rows of U are the eigenvectors
    (the reference's convention), of the symmetrized A."""
    from ..numpy.linalg import _eigh

    def g(a):
        lam, vec = _eigh((a + _t2(a)) / 2)
        return _t2(vec), lam
    return apply_op(g, [A], "linalg_syevd")


def linalg_gelqf(A, **kw):
    """(L, Q) with A = L Q, Q's rows orthonormal (m <= n), from the QR of
    A^T."""
    def g(a):
        q, r = torch.linalg.qr(_t2(a))
        return _t2(r), _t2(q)
    return apply_op(g, [A], "linalg_gelqf")


def linalg_inverse(A, **kw):
    return apply_op(torch.linalg.inv, [A], "linalg_inverse")


def linalg_det(A, **kw):
    return apply_op(torch.linalg.det, [A], "linalg_det")


def linalg_slogdet(A, **kw):
    return apply_op(lambda a: tuple(torch.linalg.slogdet(a)), [A],
                    "linalg_slogdet")


def linalg_sumlogdiag(A, **kw):
    return apply_op(lambda a: torch.log(torch.diagonal(
        a, dim1=-2, dim2=-1)).sum(-1), [A], "linalg_sumlogdiag")


def linalg_extractdiag(A, offset=0, **kw):
    return apply_op(lambda a: torch.diagonal(a, offset, -2, -1).clone(), [A],
                    "linalg_extractdiag")


def linalg_makediag(A, offset=0, **kw):
    def g(a):
        return torch.diag_embed(a, offset=offset, dim1=-2, dim2=-1)
    return apply_op(g, [A], "linalg_makediag")


def _trian_indices(n, offset, lower, device):
    """Row-major indices of the triangle the reference's LaTrianParam
    selects (``la_op.h:151-162``): offset > 0 the upper triangle from the
    offset-th super-diagonal, offset < 0 the lower from the sub-diagonal,
    ``lower`` deciding at offset 0."""
    if offset > 0 or (offset == 0 and not lower):
        return torch.triu_indices(n, n, offset, device=device)
    return torch.tril_indices(n, n, offset, device=device)


def linalg_extracttrian(A, offset=0, lower=True, **kw):
    """The triangle of A from the ``offset`` diagonal, packed row-major."""
    def g(a):
        r, c = _trian_indices(a.shape[-1], offset, lower, a.device)
        return a[..., r, c]
    return apply_op(g, [A], "linalg_extracttrian")


def linalg_maketrian(A, offset=0, lower=True, **kw):
    """The inverse of :func:`linalg_extracttrian`."""
    def g(a):
        k = a.shape[-1]
        t = int((-1 + (1 + 8 * k) ** 0.5) / 2)
        n = t + _b.abs(offset)
        r, c = _trian_indices(n, offset, lower, a.device)
        out = torch.zeros(a.shape[:-1] + (n, n), dtype=a.dtype,
                          device=a.device)
        out[..., r, c] = a
        return out
    return apply_op(g, [A], "linalg_maketrian")
