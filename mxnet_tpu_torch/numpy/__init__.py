"""``mx.np`` -- the NumPy-compatible namespace over NDArray and torch.

Counterpart of ``mxnet_tpu/numpy/__init__.py``.  Each function runs the
torch operator of the same meaning through ``apply_op``, so it records
under ``autograd.record()`` like any op, and returns NDArrays; creation
functions put their result on the current context (``ctx=`` /
``device=`` picks another).  Dtypes follow the JAX package: 64-bit
types are off unless asked for by name, so Python and numpy data become
float32 / int32, ``arange(5)`` is int32, and float results of integer
inputs are float32.

Functions whose output shape depends on the data (``unique``,
``nonzero``, boolean selection) and a long tail torch has no operator
for (``trim_zeros``, ``piecewise``, ``lexsort``, ``apply_along_axis``,
``interp`` with a ``period``) run on the host through numpy, as the JAX
package runs its data-dependent ones; they are not recorded by
autograd.
"""
from __future__ import annotations

import builtins
import functools
import math
import operator

import numpy as onp
import torch
import torch.nn.functional as F

from ..context import current_context, resolve_device  # noqa: F401
from ..ndarray.ndarray import (NDArray, apply_op, as_tensor, to_numpy_dtype,
                               to_torch_dtype)

ndarray = NDArray

float16, float32, float64 = onp.float16, onp.float32, onp.float64


class _ScalarType(type):
    """The type of a scalar type numpy lacks: equal to its torch dtype,
    so it serves as a dtype anywhere one is taken or compared."""

    def __eq__(cls, other):
        return other is cls or other == cls.torch_dtype

    def __hash__(cls):
        return hash(cls.torch_dtype)

    def __repr__(cls):
        return "<class 'mx.np.%s'>" % cls.__name__


class bfloat16(metaclass=_ScalarType):
    """``np.bfloat16(1.5)``: a 0-d bfloat16 array on the current context,
    as the JAX package's scalar type gives; as a dtype, bfloat16."""
    torch_dtype = torch.bfloat16

    def __new__(cls, value=0):
        return array(value, dtype=torch.bfloat16)  # noqa: F821


int8, int16, int32, int64 = onp.int8, onp.int16, onp.int32, onp.int64
uint8, uint16, uint32, uint64 = onp.uint8, onp.uint16, onp.uint32, onp.uint64
bool_ = onp.bool_
pi, e, euler_gamma = onp.pi, onp.e, onp.euler_gamma
inf, nan = onp.inf, onp.nan
newaxis = None
dtype = onp.dtype
integer, floating = onp.integer, onp.floating


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------
def _dev(ctx=None, device=None):
    return resolve_device(ctx if ctx is not None else device)


def _dt(dtype, default=None):
    return to_torch_dtype(dtype) if dtype is not None else default


def _is_arr(x):
    return isinstance(x, (NDArray, torch.Tensor))


def _tensor_of(x, like=None):
    """``x`` as a tensor: NDArrays give theirs; Python / numpy values go
    to ``like``'s device (a 0-d tensor for a scalar, which promotes
    weakly, as a JAX scalar does)."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if like is not None else None
    if isinstance(x, (builtins.int, builtins.float, builtins.bool)):
        return torch.as_tensor(x, device=dev if dev is not None
                               else resolve_device())
    return as_tensor(x, device=dev)


def _float(x):
    """Integer and bool tensors as float32, as numpy's float functions
    (under the JAX package's 64-bit-off rule) take them."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _from_host(arr, like=None):
    dev = like._data.device if isinstance(like, NDArray) else \
        like.device if isinstance(like, torch.Tensor) else None
    return NDArray(as_tensor(onp.asarray(arr), device=dev))


def _first_arr(*xs):
    return next((x for x in xs if _is_arr(x)), None)


def _unary(fn, name, floats=False):
    def f(x, out=None, **kw):
        g = (lambda a: fn(_float(a), **kw)) if floats else \
            (lambda a: fn(a, **kw))
        return apply_op(g, [x if _is_arr(x) else NDArray(x)], name, out)
    f.__name__ = name
    f.__doc__ = "mx.np.%s -- see numpy.%s" % (name, name)
    return f


def _binary(fn, name, floats=False):
    def f(x1, x2, out=None, **kw):
        like = _first_arr(x1, x2)
        if like is None:
            x1 = NDArray(x1)
            like = x1
        like_t = like._data if isinstance(like, NDArray) else like
        a, b = _tensor_of(x1, like_t), _tensor_of(x2, like_t)

        def g(a, b):
            if floats:
                a, b = _float(a), _float(b)
            return fn(a, b, **kw)
        return apply_op(g, [a, b], name, out)
    f.__name__ = name
    f.__doc__ = "mx.np.%s -- see numpy.%s" % (name, name)
    return f


def _axes(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


# ----------------------------------------------------------------------
# elementwise
# ----------------------------------------------------------------------
def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3)


def _spacing(x):
    return torch.nextafter(x, torch.where(x < 0, -math.inf, math.inf)
                           .to(x.dtype)) - x


def _bool_kept(fn):
    """``fn`` for numbers; a bool array unchanged (numpy's ``abs`` /
    ``positive`` of bools)."""
    return lambda x: x if x.dtype == torch.bool else fn(x)


def _exact_kept(fn):
    """``fn`` for floats; integers and bools unchanged, in their dtype
    (``floor`` / ``ceil`` / ``trunc`` / ``fix`` / ``nan_to_num`` of an
    int32 stay int32, of a bool bool)."""
    return lambda x, **kw: fn(x, **kw) if x.is_floating_point() or \
        x.is_complex() else x


def _square(x):
    return torch.square(x.to(torch.int32) if x.dtype == torch.bool else x)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


_UNARY = {
    "negative": torch.neg, "positive": _bool_kept(torch.positive),
    "absolute": _bool_kept(torch.abs), "abs": _bool_kept(torch.abs),
    "sign": torch.sign, "square": _square,
    "logical_not": torch.logical_not,
    "invert": torch.bitwise_not, "bitwise_not": torch.bitwise_not,
    "conjugate": torch.conj_physical, "conj": torch.conj_physical,
    "isnan": torch.isnan, "isinf": torch.isinf, "isfinite": torch.isfinite,
    "isposinf": torch.isposinf, "isneginf": torch.isneginf,
    "real": torch.real, "imag": _imag,
    **{n: _exact_kept(f) for n, f in (
        ("ceil", torch.ceil), ("floor", torch.floor), ("trunc", torch.trunc),
        ("fix", torch.trunc), ("nan_to_num", torch.nan_to_num))},
}
_UNARY_FLOAT = {
    "fabs": torch.abs, "rint": torch.round,
    "sqrt": torch.sqrt, "cbrt": _cbrt, "reciprocal": torch.reciprocal,
    "exp": torch.exp, "expm1": torch.expm1, "exp2": torch.exp2,
    "log": torch.log, "log2": torch.log2, "log10": torch.log10,
    "log1p": torch.log1p, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.arcsin, "arccos": torch.arccos,
    "arctan": torch.arctan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.arcsinh, "arccosh": torch.arccosh,
    "arctanh": torch.arctanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg, "angle": torch.angle, "i0": torch.i0,
    "sinc": torch.sinc, "spacing": _spacing,
}
for _n, _f in _UNARY.items():
    globals()[_n] = _unary(_f, _n)
for _n, _f in _UNARY_FLOAT.items():
    globals()[_n] = _unary(_f, _n, floats=True)


def _floor_divide(a, b):
    return torch.floor_divide(a, b) if not (a.is_floating_point() or
                                            b.is_floating_point()) \
        else torch.floor(a / b)


def _remainder(a, b):
    """numpy's ``mod``: an integer modulo 0 gives 0, not an error."""
    if a.is_floating_point() or b.is_floating_point() or \
            a.is_complex() or b.is_complex():
        return torch.remainder(a, b)
    zero = b == 0
    r = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero, torch.zeros((), dtype=r.dtype,
                                         device=r.device), r)


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "true_divide": torch.true_divide,
    "floor_divide": _floor_divide, "mod": _remainder,
    "remainder": _remainder, "fmod": torch.fmod, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift, "equal": torch.eq,
    "not_equal": torch.ne, "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "gcd": torch.gcd, "lcm": torch.lcm,
    "matmul": torch.matmul, "kron": torch.kron,
}
_BINARY_FLOAT = {
    "float_power": lambda a, b: torch.float_power(a, b).to(
        torch.result_type(a, b) if torch.result_type(a, b)
        .is_floating_point else torch.float32),
    "arctan2": torch.atan2, "hypot": torch.hypot, "fmax": torch.fmax,
    "fmin": torch.fmin, "copysign": torch.copysign,
    "nextafter": torch.nextafter, "logaddexp": torch.logaddexp,
    "logaddexp2": torch.logaddexp2, "heaviside": torch.heaviside,
    "ldexp": lambda a, b: a * torch.pow(2.0, b).to(a.dtype),
}
for _n, _f in _BINARY.items():
    globals()[_n] = _binary(_f, _n)
for _n, _f in _BINARY_FLOAT.items():
    globals()[_n] = _binary(_f, _n, floats=True)


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


dot = _binary(_dot, "dot")
vdot = _binary(lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)), "vdot")
inner = _binary(torch.inner, "inner")
outer = _binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                "outer")
cross = _binary(lambda a, b: torch.linalg.cross(a, b, dim=-1), "cross")


# ----------------------------------------------------------------------
# reductions
# ----------------------------------------------------------------------
def _reduce(fn, name):
    def f(a, axis=None, dtype=None, out=None, keepdims=False, **kw):
        dt = _dt(dtype)
        initial = kw.pop("initial", None)
        if initial is not None and name not in _WITH_INITIAL:
            raise TypeError("%s() got an unexpected keyword argument "
                            "'initial'" % name)

        def g(x):
            if dt is not None:
                x = x.to(dt)
            if axis is None:
                r = fn(x.reshape(-1), 0, **kw)
                r = r.reshape((1,) * x.dim()) if keepdims else r
            else:
                r = fn(x, _axes(axis), keepdim=keepdims, **kw)
            # torch widens integer sums and products to int64
            r = r.to(torch.int32) if r.dtype == torch.int64 and \
                x.dtype != torch.int64 else r
            if initial is not None:   # folded in as one more element
                r = _WITH_INITIAL[name](r, torch.as_tensor(
                    initial, dtype=r.dtype, device=r.device))
            return r
        return apply_op(g, [a], name, out)
    f.__name__ = name
    return f


#: the reductions that take numpy's ``initial=``, and how it folds in
_WITH_INITIAL = dict(
    {n: torch.add for n in ("sum", "nansum")},
    **{n: torch.mul for n in ("prod", "nanprod")},
    **{n: torch.maximum for n in ("max", "amax", "nanmax")},
    **{n: torch.minimum for n in ("min", "amin", "nanmin")})


def _sum(x, dim, keepdim=False):
    if x.dtype in (torch.int8, torch.int16, torch.uint8, torch.bool):
        x = x.to(torch.int32)
    return torch.sum(x, dim, keepdim=keepdim)


def _axis(ax, nd):
    """``ax`` within ``nd`` dimensions, made non-negative; numpy's
    ``AxisError`` (a ValueError and an IndexError) where it is not."""
    if not -nd <= ax < nd:
        raise onp.exceptions.AxisError(ax, nd)
    return ax % nd


def _prod(x, dim, keepdim=False):
    if isinstance(dim, tuple):
        for d in sorted((_axis(d, x.dim()) for d in dim), reverse=True):
            x = torch.prod(x, d, keepdim=keepdim)
        return x
    return torch.prod(x, _axis(dim, x.dim()), keepdim=keepdim)


def _nanprod(x, dim, keepdim=False):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _amax(x, dim, keepdim=False):
    return torch.amax(x, dim, keepdim=keepdim)


def _amin(x, dim, keepdim=False):
    return torch.amin(x, dim, keepdim=keepdim)


def _nanfill(fn, fill):
    def g(x, dim, keepdim=False):
        if x.is_floating_point():       # an integer array holds no NaN
            x = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
        return fn(x, dim, keepdim=keepdim)
    return g


def _all(x, dim, keepdim=False):
    if isinstance(dim, tuple):
        return torch.all(x.bool(), dim=dim, keepdim=keepdim) \
            if dim else x.bool()
    return torch.all(x.bool(), dim, keepdim=keepdim)


def _any(x, dim, keepdim=False):
    if isinstance(dim, tuple):
        return torch.any(x.bool(), dim=dim, keepdim=keepdim) \
            if dim else x.bool()
    return torch.any(x.bool(), dim, keepdim=keepdim)


def _median(x, dim, keepdim=False):
    return torch.quantile(_float(x), 0.5, dim=dim, keepdim=keepdim)


def _nanmedian(x, dim, keepdim=False):
    return torch.nanquantile(_float(x), 0.5, dim=dim, keepdim=keepdim)


def _mean(x, dim, keepdim=False):
    return torch.mean(_float(x), dim, keepdim=keepdim)


def _nanmean(x, dim, keepdim=False):
    return torch.nanmean(_float(x), dim, keepdim=keepdim)


def _var(x, dim, keepdim=False, ddof=0):
    return torch.var(_float(x), dim, correction=ddof, keepdim=keepdim)


def _std(x, dim, keepdim=False, ddof=0):
    return torch.std(_float(x), dim, correction=ddof, keepdim=keepdim)


def _nanvar(x, dim, keepdim=False, ddof=0):
    x = _float(x)
    ok = ~torch.isnan(x)
    n = ok.sum(dim, keepdim=True)
    mu = torch.nansum(x, dim, keepdim=True) / n
    d = torch.where(ok, x - mu, torch.zeros_like(x))
    r = (d * d).sum(dim, keepdim=True) / (n - ddof)
    return r if keepdim else r.squeeze(dim)


def _nanstd(x, dim, keepdim=False, ddof=0):
    return torch.sqrt(_nanvar(x, dim, keepdim, ddof))


for _n, _f in {"sum": _sum, "prod": _prod, "nansum": _nanfill(_sum, 0),
               "nanprod": _nanprod, "max": _amax, "min": _amin,
               "amax": _amax, "amin": _amin,
               "nanmax": _nanfill(_amax, -math.inf),
               "nanmin": _nanfill(_amin, math.inf), "all": _all,
               "any": _any, "median": _median, "nanmedian": _nanmedian,
               "mean": _mean, "nanmean": _nanmean, "var": _var, "std": _std,
               "nanvar": _nanvar, "nanstd": _nanstd}.items():
    globals()[_n] = _reduce(_f, _n)
product = prod  # noqa: F821
sometrue = any  # noqa: F821


def ptp(a, axis=None, out=None, keepdims=False):
    return apply_op(lambda x: _reduce_t(_amax, x, axis, keepdims)
                    - _reduce_t(_amin, x, axis, keepdims), [a], "ptp", out)


def _reduce_t(fn, x, axis, keepdims):
    if axis is None:
        r = fn(x.reshape(-1), 0)
        return r.reshape((1,) * x.dim()) if keepdims else r
    return fn(x, _axes(axis), keepdim=keepdims)


def average(a, axis=None, weights=None, returned=False):
    if weights is None:
        r = mean(a, axis=axis)  # noqa: F821
        if returned:
            cnt = a.size if axis is None else a.shape[axis]
            return r, full((), float(cnt), ctx=a.context)
        return r

    def g(x, w):
        x, w = _float(x), _float(w)
        if axis is None:
            return (x * w).sum() / w.sum()
        if w.dim() == 1 and x.dim() > 1:
            shape = [1] * x.dim()
            shape[axis] = -1
            w = w.reshape(shape)
        w = torch.broadcast_to(w, x.shape)
        return (x * w).sum(axis) / w.sum(axis)
    r = apply_op(g, [a, weights], "average")
    return (r, sum(weights, axis=axis)) if returned else r  # noqa: F821


def _cum(fn, name):
    def f(a, axis=None, dtype=None, out=None):
        dt = _dt(dtype)

        def g(x):
            if axis is None:
                x = x.reshape(-1)
            r = fn(x, 0 if axis is None else axis, dtype=dt)
            return r.to(torch.int32) if dt is None and r.dtype == \
                torch.int64 and x.dtype != torch.int64 else r
        return apply_op(g, [a], name, out)
    f.__name__ = name
    return f


cumsum = _cum(torch.cumsum, "cumsum")
cumprod = _cum(torch.cumprod, "cumprod")


def _arg(fn, name):
    def f(a, axis=None, out=None, keepdims=False):
        def g(x):
            if x.dtype == torch.bool:
                x = x.to(torch.uint8)
            if axis is None:
                r = fn(x.reshape(-1))
                return r.reshape((1,) * x.dim()) if keepdims else r
            return fn(x, axis, keepdim=keepdims)
        return apply_op(lambda x: g(x).to(torch.int32), [a], name, out)
    f.__name__ = name
    return f


argmax = _arg(torch.argmax, "argmax")
argmin = _arg(torch.argmin, "argmin")


def count_nonzero(a, axis=None, keepdims=False):
    return apply_op(lambda x: _reduce_t(_sum, x != 0, axis, keepdims).to(
        torch.int32), [a], "count_nonzero")


def clip(a, a_min, a_max, out=None):
    lo = a_min._data if isinstance(a_min, NDArray) else a_min
    hi = a_max._data if isinstance(a_max, NDArray) else a_max
    return apply_op(lambda x: torch.clamp(x, lo, hi), [a], "clip", out)


def round(a, decimals=0, out=None):  # noqa: A001
    return apply_op(lambda x: torch.round(x, decimals=decimals)
                    if x.is_floating_point() else x, [a], "round", out)


around = round
round_ = round


# ----------------------------------------------------------------------
# creation
# ----------------------------------------------------------------------
def array(obj, dtype=None, ctx=None, device=None):
    return NDArray(as_tensor(obj, dtype, _dev(ctx, device)))


asarray = array


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    return NDArray(torch.zeros(shape, dtype=_dt(dtype, torch.float32),
                               device=_dev(ctx, device)))


def ones(shape, dtype=None, order="C", ctx=None, device=None):
    return NDArray(torch.ones(shape, dtype=_dt(dtype, torch.float32),
                              device=_dev(ctx, device)))


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return _dt(dtype)
    if isinstance(fill_value, builtins.bool):
        return torch.bool
    if isinstance(fill_value, (builtins.int, onp.integer)):
        return torch.int32
    return torch.float32


def full(shape, fill_value, dtype=None, order="C", ctx=None, device=None,
         out=None):
    dev = _dev(ctx, device)
    if isinstance(fill_value, NDArray):
        r = NDArray(torch.broadcast_to(fill_value._data.to(dev), shape)
                    .to(_dt(dtype, fill_value._data.dtype)).clone())
    else:
        r = NDArray(torch.full(shape if isinstance(shape, (tuple, list))
                               else (shape,), fill_value,
                               dtype=_fill_dtype(fill_value, dtype),
                               device=dev))
    if out is not None:
        out[...] = r
        return out
    return r


def empty(shape, dtype=None, order="C", ctx=None, device=None):
    return zeros(shape, dtype=dtype, ctx=ctx, device=device)


def _like(fn, name):
    def f(a, dtype=None, order="C", ctx=None, device=None, **kw):
        t = a._data if isinstance(a, NDArray) else as_tensor(a)
        dev = t.device if ctx is None and device is None \
            else _dev(ctx, device)
        return NDArray(fn(t, dtype=_dt(dtype, t.dtype), device=dev, **kw))
    f.__name__ = name
    return f


zeros_like = _like(lambda t, **kw: torch.zeros(t.shape, **kw), "zeros_like")
ones_like = _like(lambda t, **kw: torch.ones(t.shape, **kw), "ones_like")
empty_like = zeros_like


def full_like(a, fill_value, dtype=None, ctx=None, device=None):
    t = a._data if isinstance(a, NDArray) else as_tensor(a)
    dev = t.device if ctx is None and device is None else _dev(ctx, device)
    return NDArray(torch.full(t.shape, fill_value, dtype=_dt(dtype, t.dtype),
                              device=dev))


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    if stop is None:
        start, stop = 0, start
    ints = builtins.all(isinstance(v, (builtins.int, onp.integer))
                        for v in (start, stop, step))
    dt = _dt(dtype, torch.int32 if ints else torch.float32)
    return NDArray(torch.arange(start, stop, step, dtype=torch.float64
                                if dt.is_floating_point else torch.int64,
                                device=_dev(ctx, device)).to(dt))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    dev = _dev(ctx, device)
    n = num if endpoint else num + 1
    r = torch.linspace(start, stop, n, dtype=torch.float64, device=dev)
    if not endpoint:
        r = r[:-1]
    step = (stop - start) / builtins.max(1, (num - 1) if endpoint else num)
    r = NDArray(r.to(_dt(dtype, torch.float32)))
    return (r, step) if retstep else r


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None, device=None):
    y = linspace(start, stop, num, endpoint, dtype="float64", ctx=ctx,
                 device=device)
    return apply_op(lambda t: torch.pow(base, t).to(
        _dt(dtype, torch.float32)), [y], "logspace")


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              ctx=None, device=None):
    r = onp.geomspace(start, stop, num, endpoint=endpoint)
    return NDArray(as_tensor(r, _dt(dtype, torch.float32), _dev(ctx, device)))


def eye(N, M=None, k=0, dtype=None, ctx=None, device=None):
    M = N if M is None else M
    dev = _dev(ctx, device)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return NDArray((j - i == k).to(_dt(dtype, torch.float32)))


def identity(n, dtype=None, ctx=None, device=None):
    return eye(n, dtype=dtype, ctx=ctx, device=device)


def tri(N, M=None, k=0, dtype=None, ctx=None, device=None):
    M = N if M is None else M
    dev = _dev(ctx, device)
    i = torch.arange(N, device=dev)[:, None]
    j = torch.arange(M, device=dev)[None, :]
    return NDArray((j <= i + k).to(_dt(dtype, torch.float32)))


def meshgrid(*xi, indexing="xy", sparse=False, copy=True):
    if indexing not in ("xy", "ij"):
        raise ValueError("Valid values for indexing are 'xy' and 'ij'.")

    def g(*ts):          # each grid keeps its own input's dtype
        n = len(ts)
        shapes = [[1] * n for _ in ts]
        for i, t in enumerate(ts):
            shapes[i][i] = -1
        if indexing == "xy" and n > 1:
            for s in shapes:
                s[0], s[1] = s[1], s[0]
        grids = [t.reshape(-1).reshape(s) for t, s in zip(ts, shapes)]
        if sparse:
            return grids
        dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
        full = torch.broadcast_shapes(*(gr.shape for gr in grids))
        return [gr.to(dt).expand(full).to(t.dtype).clone()
                for gr, t in zip(grids, ts)]
    outs = apply_op(g, list(xi), "meshgrid")
    return list(outs)


def indices(dimensions, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device)
    grids = torch.meshgrid(*(torch.arange(d, device=dev) for d in dimensions),
                           indexing="ij")
    return NDArray(torch.stack(grids).to(_dt(dtype, torch.int32)))


def fromfunction(function, shape, dtype=float, **kw):
    idx = indices(shape, dtype=dtype)
    return function(*[idx[i] for i in builtins.range(len(shape))], **kw)


def copy(a):
    return apply_op(torch.clone, [a], "copy")


def may_share_memory(a, b, max_work=None):
    ta, tb = _tensor_of(a), _tensor_of(b)
    return ta.untyped_storage().data_ptr() == tb.untyped_storage().data_ptr()


shares_memory = may_share_memory


# ----------------------------------------------------------------------
# shape manipulation
# ----------------------------------------------------------------------
def reshape(a, newshape, order="C"):
    shape = (newshape,) if isinstance(newshape, builtins.int) \
        else tuple(newshape)
    return apply_op(lambda x: torch.reshape(x, shape), [a], "reshape")


def ravel(a, order="C"):
    return apply_op(lambda x: x.reshape(-1), [a], "ravel")


def transpose(a, axes=None):
    return apply_op(lambda x: x.permute(*(axes if axes is not None else
                                          builtins.range(x.dim() - 1, -1, -1)
                                          )), [a], "transpose")


permute_dims = transpose


def swapaxes(a, axis1, axis2):
    return apply_op(lambda x: torch.swapaxes(x, axis1, axis2), [a],
                    "swapaxes")


def moveaxis(a, source, destination):
    return apply_op(lambda x: torch.movedim(x, source, destination), [a],
                    "moveaxis")


def rollaxis(a, axis, start=0):
    def g(x):
        n = x.dim()
        ax = _axis(axis, n)
        if not -n <= start <= n:
            raise onp.exceptions.AxisError(
                "start=%d must satisfy %d<=start<=%d" % (start, -n, n))
        st = start if start >= 0 else start + n
        if ax < st:
            st -= 1
        return torch.movedim(x, ax, st)
    return apply_op(g, [a], "rollaxis")


def expand_dims(a, axis):
    def g(x):
        for ax in sorted(axis if isinstance(axis, (tuple, list)) else [axis]):
            x = torch.unsqueeze(x, ax)
        return x
    return apply_op(g, [a], "expand_dims")


def squeeze(a, axis=None):
    def g(x):
        if axis is None:
            return torch.squeeze(x)
        axes = _axes(axis)
        for ax in axes if isinstance(axes, tuple) else (axes,):
            if x.shape[_axis(ax, x.dim())] != 1:
                raise ValueError("cannot select an axis to squeeze out "
                                 "which has size not equal to one, got "
                                 "shape=%s and axis=%s"
                                 % (tuple(x.shape), axis))
        return torch.squeeze(x, axes)
    return apply_op(g, [a], "squeeze")


def broadcast_to(a, shape):
    return apply_op(lambda x: torch.broadcast_to(x, shape), [a],
                    "broadcast_to")


def broadcast_arrays(*args):
    return list(apply_op(lambda *xs: torch.broadcast_tensors(*xs),
                         list(args), "broadcast_arrays"))


def _atleast(fn, name):
    def f(*arys):
        res = [apply_op(fn, [a], name) for a in arys]
        return res[0] if len(res) == 1 else res
    f.__name__ = name
    return f


atleast_1d = _atleast(torch.atleast_1d, "atleast_1d")
atleast_2d = _atleast(torch.atleast_2d, "atleast_2d")
atleast_3d = _atleast(torch.atleast_3d, "atleast_3d")


def concatenate(seq, axis=0, out=None):
    if axis is None:
        return apply_op(lambda *xs: torch.cat([x.reshape(-1) for x in xs]),
                        list(seq), "concatenate", out)
    return apply_op(lambda *xs: torch.cat(xs, axis), list(seq),
                    "concatenate", out)


concat = concatenate


def stack(arrays, axis=0, out=None):
    return apply_op(lambda *xs: torch.stack(xs, axis), list(arrays), "stack",
                    out)


def vstack(tup):
    return apply_op(lambda *xs: torch.vstack(xs), list(tup), "vstack")


row_stack = vstack


def hstack(tup):
    return apply_op(lambda *xs: torch.hstack(xs), list(tup), "hstack")


def dstack(tup):
    return apply_op(lambda *xs: torch.dstack(xs), list(tup), "dstack")


def column_stack(tup):
    return apply_op(lambda *xs: torch.column_stack(xs), list(tup),
                    "column_stack")


def _split_points(n, spec, even):
    if isinstance(spec, NDArray):
        spec = spec.asnumpy().tolist()
    if isinstance(spec, (builtins.int, onp.integer)):
        if spec < 0:
            raise ValueError("number sections must be larger than 0, got "
                             "%d" % spec)
        if even and n % spec:
            raise ValueError("array split does not result in an equal "
                             "division")
        q, r = divmod(n, spec)
        sizes = [q + 1] * r + [q] * (spec - r)
        return onp.cumsum([0] + sizes).tolist()
    pts = [builtins.min(builtins.max(int(p) if p >= 0 else n + int(p), 0), n)
           for p in spec]
    return [0] + pts + [n]


def _split(a, spec, axis, even, name):
    def g(x):
        pts = _split_points(x.shape[axis], spec, even)
        return [x.narrow(axis, lo, builtins.max(hi - lo, 0))
                for lo, hi in zip(pts[:-1], pts[1:])]
    return list(apply_op(g, [a], name))


def split(a, indices_or_sections, axis=0):
    return _split(a, indices_or_sections, axis, True, "split")


def array_split(a, indices_or_sections, axis=0):
    return _split(a, indices_or_sections, axis, False, "array_split")


def hsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 1 if a.ndim > 1 else 0)


def vsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 0)


def dsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 2)


def tile(a, reps):
    reps = (reps,) if isinstance(reps, builtins.int) else tuple(reps)
    return apply_op(lambda x: torch.tile(x, reps), [a], "tile")


def repeat(a, repeats, axis=None):
    return apply_op(lambda x: torch.repeat_interleave(
        x.reshape(-1) if axis is None else x, repeats,
        dim=0 if axis is None else axis), [a], "repeat")


def flip(a, axis=None):
    return apply_op(lambda x: torch.flip(x, tuple(builtins.range(x.dim()))
                                         if axis is None else
                                         (axis,) if isinstance(axis,
                                                               builtins.int)
                                         else tuple(axis)), [a], "flip")


def fliplr(a):
    return flip(a, 1)


def flipud(a):
    return flip(a, 0)


def roll(a, shift, axis=None):
    if axis is None and isinstance(shift, (tuple, list)):
        shift = builtins.sum(shift)     # the flat array, by every shift
    return apply_op(lambda x: torch.roll(x, shift, axis), [a], "roll")


def rot90(a, k=1, axes=(0, 1)):
    return apply_op(lambda x: torch.rot90(x, k, axes), [a], "rot90")


def _pairs(vals, nd, name):
    """numpy's per-axis (before, after) pairs from a scalar, a pair or
    one pair per axis (``jnp.pad``'s ``_broadcast_to_pairs``)."""
    a = onp.asarray(vals)
    if a.shape == (nd, 2):
        return a
    if a.shape in ((1, 2), (2,)):
        return onp.broadcast_to(a.reshape(1, 2), (nd, 2))
    if a.shape in ((1,), ()):
        return onp.full((nd, 2), a.reshape(-1)[0])
    raise ValueError("pad: %s with nd=%d has unsupported shape %s"
                     % (name, nd, a.shape))


def _pad_reflect(x, i, lo, hi, mode, odd):
    """One axis of ``symmetric`` / ``reflect`` padding, chunk by chunk
    as ``jnp.pad`` builds it: a pad wider than the axis reflects the
    array padded so far, and the odd type reflects about the edge."""
    n = x.shape[i]
    off = 1 if mode == "reflect" and n > 1 else 0
    for padding, before in ((lo, True), (hi, False)):
        edge = x.narrow(i, 0 if before else x.shape[i] - 1, 1)
        while padding > 0:
            cur = builtins.min(padding, n - off)
            padding -= cur
            if before:
                start = off
            else:
                start = x.shape[i] - cur - (0 if mode == "symmetric" or
                                            n == 1 else 1)
            c = x.narrow(i, start, cur).flip(i)
            if odd:
                c = 2 * edge - c
                if n > 1:
                    edge = c.narrow(i, 0 if before else cur - 1, 1)
            x = torch.cat([c, x] if before else [x, c], i)
    return x


_PAD_STATS = {"maximum": lambda x, i: x.amax(i, keepdim=True),
              "minimum": lambda x, i: x.amin(i, keepdim=True),
              "mean": lambda x, i: _float(x).mean(i, keepdim=True),
              "median": lambda x, i: torch.quantile(_float(x), 0.5, dim=i,
                                                    keepdim=True)}


def _pad_axis(x, i, lo, hi, mode, kw):
    n = x.shape[i]
    if mode == "edge":
        parts = [x.narrow(i, 0, 1).repeat_interleave(lo, i), x,
                 x.narrow(i, n - 1, 1).repeat_interleave(hi, i)]
    elif mode == "wrap":
        reps, rl = divmod(lo, n)
        reps_r, rr = divmod(hi, n)
        parts = [x.narrow(i, n - rl, rl)] + [x] * (reps + reps_r + 1) + \
            [x.narrow(i, 0, rr)]
    elif mode in ("symmetric", "reflect"):
        return _pad_reflect(x, i, lo, hi, mode,
                            kw.get("reflect_type", "even") == "odd")
    elif mode in _PAD_STATS:
        st = kw.get("stat_length")
        if st is None:
            before = after = _PAD_STATS[mode](x, i)
        else:
            lb, la = (int(v) for v in _pairs(st, x.dim(), "stat_length")[i])
            if lb == 0 or la == 0:
                raise ValueError("stat_length of 0 yields no value for "
                                 "padding")
            before = _PAD_STATS[mode](x.narrow(i, 0, builtins.min(lb, n)), i)
            after = _PAD_STATS[mode](x.narrow(i, n - builtins.min(la, n),
                                              builtins.min(la, n)), i)
        if not x.is_floating_point():
            before, after = before.round(), after.round()
        parts = [before.to(x.dtype).repeat_interleave(lo, i), x,
                 after.to(x.dtype).repeat_interleave(hi, i)]
    elif mode == "linear_ramp":
        ev = _pairs(kw.get("end_values", 0), x.dim(), "end_values")[i]

        def ramp(end, edge, num):
            t = torch.arange(num, device=x.device, dtype=torch.float64) / \
                builtins.max(num, 1)
            shape = [1] * x.dim()
            shape[i] = num
            r = float(end) + (edge.double() - float(end)) * t.view(shape)
            return (r if x.is_floating_point() else r.floor()).to(x.dtype)
        parts = [ramp(ev[0], x.narrow(i, 0, 1), lo), x,
                 ramp(ev[1], x.narrow(i, n - 1, 1), hi).flip(i)]
    else:                                              # empty: zeros
        sb, sa = list(x.shape), list(x.shape)
        sb[i], sa[i] = lo, hi
        parts = [x.new_zeros(sb), x, x.new_zeros(sa)]
    return torch.cat(parts, i)


_PAD_MODES = ("constant", "edge", "wrap", "reflect", "symmetric", "maximum",
              "minimum", "mean", "median", "linear_ramp", "empty")


def pad(a, pad_width, mode="constant", **kw):
    """numpy's ``pad`` as ``jnp.pad`` computes it: the modes of
    ``_PAD_MODES``, with ``constant_values`` / ``stat_length`` /
    ``end_values`` a scalar, a pair or a pair per axis, and
    ``reflect_type="odd"``; ``empty`` pads with zeros, as JAX does."""
    if mode not in _PAD_MODES:
        raise ValueError("Unimplemented padding mode '%s' for np.pad."
                         % (mode,))

    def g(x):
        if x.dim() == 0:
            return x
        pw = _pairs(pad_width, x.dim(), "pad_width").astype(onp.int64)
        if (pw < 0).any():
            raise ValueError("index can't contain negative values")
        if mode == "constant":
            cv = _pairs(kw.get("constant_values", 0), x.dim(),
                        "constant_values")
            for i, (lo, hi) in enumerate(pw):
                for width, val, before in ((lo, cv[i][0], True),
                                           (hi, cv[i][1], False)):
                    if width:
                        shape = list(x.shape)
                        shape[i] = int(width)
                        c = torch.full(shape, float(val), device=x.device
                                       ).to(x.dtype)
                        x = torch.cat([c, x] if before else [x, c], i)
            return x
        for i, (lo, hi) in enumerate(pw):
            if x.shape[i] == 0:
                if lo or hi:
                    raise ValueError("Cannot apply '%s' padding to empty "
                                     "axis" % mode)
                continue
            if lo or hi:
                x = _pad_axis(x, i, int(lo), int(hi), mode, kw)
        return x
    return apply_op(g, [a], "pad")


def resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, builtins.int) \
        else tuple(new_shape)
    if builtins.any(d < 0 for d in shape):
        raise ValueError("all elements of `new_shape` must be non-negative")
    n = int(onp.prod(shape))
    return apply_op(lambda x: x.reshape(-1).repeat(
        -(-n // builtins.max(x.numel(), 1)))[:n].reshape(shape), [a],
        "resize")


def append(arr, values, axis=None):
    def g(x, v):
        if axis is None:
            return torch.cat([x.reshape(-1), v.reshape(-1)])
        return torch.cat([x, v], axis)
    return apply_op(g, [arr, values if _is_arr(values) else
                        NDArray(values, ctx=arr.context)], "append")


def trim_zeros(filt, trim="fb"):
    return _from_host(onp.trim_zeros(_host(filt), trim), filt)


# ----------------------------------------------------------------------
# indexing and selection
# ----------------------------------------------------------------------
def take(a, indices, axis=None, mode="clip", out=None):
    def g(x, i):
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis
        n = src.shape[ax]
        i = i.long()
        i = torch.remainder(i, n) if mode == "wrap" else i.clamp(0, n - 1)
        return torch.index_select(src, ax, i.reshape(-1)).reshape(
            src.shape[:ax] + i.shape + src.shape[ax + 1:])
    return apply_op(g, [a, indices if _is_arr(indices) else
                        NDArray(indices, ctx=a.context)], "take", out)


def take_along_axis(a, indices, axis):
    return apply_op(lambda x, i: torch.take_along_dim(x, i.long(), axis),
                    [a, indices], "take_along_axis")


def put_along_axis(a, indices, values, axis):
    vals = values if _is_arr(values) else NDArray(values, ctx=a.context)
    new = apply_op(lambda x, i, v: torch.scatter(
        x, axis, i.long(), torch.broadcast_to(v.to(x.dtype), i.shape)),
        [a, indices, vals], "put_along_axis")
    a[...] = new


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    like = _first_arr(condition, x, y)._data if _first_arr(condition, x, y) \
        is not None else None
    return apply_op(lambda c, a, b: torch.where(c.bool(), a, b),
                    [_tensor_of(condition, like), _tensor_of(x, like),
                     _tensor_of(y, like)], "where")


def diag(v, k=0):
    return apply_op(lambda x: torch.diag(x, k), [v], "diag")


def diagonal(a, offset=0, axis1=0, axis2=1):
    return apply_op(lambda x: torch.diagonal(x, offset, axis1, axis2), [a],
                    "diagonal")


def diagflat(v, k=0):
    return apply_op(lambda x: torch.diagflat(x, k), [v], "diagflat")


def diag_indices_from(arr):
    i = arange(arr.shape[0], ctx=arr.context)
    return tuple(i for _ in builtins.range(arr.ndim))


def tril(m, k=0):
    return apply_op(lambda x: torch.tril(x, k), [m], "tril")


def triu(m, k=0):
    return apply_op(lambda x: torch.triu(x, k), [m], "triu")


def tril_indices(n, k=0, m=None, ctx=None, device=None):
    r = torch.tril_indices(n, n if m is None else m, k,
                           device=_dev(ctx, device)).to(torch.int32)
    return NDArray(r[0]), NDArray(r[1])


def triu_indices(n, k=0, m=None, ctx=None, device=None):
    r = torch.triu_indices(n, n if m is None else m, k,
                           device=_dev(ctx, device)).to(torch.int32)
    return NDArray(r[0]), NDArray(r[1])


def triu_indices_from(arr, k=0):
    return triu_indices(arr.shape[0], k, arr.shape[1], ctx=arr.context)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    dt = _dt(dtype)

    def g(x):
        d = torch.diagonal(x, offset, axis1, axis2)
        if dt is not None:
            return d.to(dt).sum(-1, dtype=dt)
        r = _sum(d, -1)           # int32 stays int32, as sum's does
        return r.to(torch.int32) if r.dtype == torch.int64 and \
            d.dtype != torch.int64 else r
    return apply_op(g, [a], "trace", out)


def searchsorted(a, v, side="left", sorter=None):
    like = a._data if isinstance(a, NDArray) else None
    return apply_op(lambda x, q: torch.searchsorted(
        x, q, right=side == "right").to(torch.int32),
        [a, _tensor_of(v, like)], "searchsorted")


def select(condlist, choicelist, default=0):
    n = len(condlist)
    if n != len(choicelist):
        raise ValueError("condlist must have length equal to choicelist "
                         "(%d vs %d)" % (n, len(choicelist)))

    def g(*xs):
        out = torch.full_like(xs[n], default) if not _is_arr(default) \
            else default
        for c, v in zip(reversed(xs[:n]), reversed(xs[n:])):
            out = torch.where(c.bool(), v, out)
        return out
    return apply_op(g, list(condlist) + list(choicelist), "select")


def piecewise(x, condlist, funclist, *args, **kw):
    return _from_host(onp.piecewise(_host(x), [_host(c) for c in condlist],
                                    funclist, *args, **kw), x)


def nonzero(a):
    return tuple(_from_host(i, a) for i in onp.nonzero(_host(a)))


def flatnonzero(a):
    return _from_host(onp.flatnonzero(_host(a)), a)


def argwhere(a):
    return _from_host(onp.argwhere(_host(a)), a)


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    r = onp.unique(_host(ar), return_index=return_index,
                   return_inverse=return_inverse,
                   return_counts=return_counts, axis=axis)
    if isinstance(r, tuple):
        return tuple(_from_host(x, ar) for x in r)
    return _from_host(r, ar)


def delete(arr, obj, axis=None):
    return _from_host(onp.delete(_host(arr), _host(obj) if _is_arr(obj)
                                 else obj, axis=axis), arr)


def insert(arr, obj, values, axis=None):
    return _from_host(onp.insert(_host(arr), _host(obj) if _is_arr(obj)
                                 else obj, _host(values), axis=axis), arr)


def ediff1d(ary, to_end=None, to_begin=None):
    def g(x):
        parts = [x.reshape(-1)[1:] - x.reshape(-1)[:-1]]
        if to_begin is not None:
            parts.insert(0, torch.as_tensor(to_begin, dtype=x.dtype,
                                            device=x.device).reshape(-1))
        if to_end is not None:
            parts.append(torch.as_tensor(to_end, dtype=x.dtype,
                                         device=x.device).reshape(-1))
        return torch.cat(parts)
    return apply_op(g, [ary], "ediff1d")


def diff(a, n=1, axis=-1, prepend=None, append=None):
    return apply_op(lambda x: torch.diff(x, n=n, dim=axis), [a], "diff")


def gradient(f, *varargs, axis=None, edge_order=1):
    sp = [v._data if isinstance(v, NDArray) else v for v in varargs]
    # one scalar spacing serves every axis: torch takes it bare
    spacing = sp[0] if len(sp) == 1 and onp.ndim(sp[0]) == 0 else sp or 1
    res = apply_op(lambda x: torch.gradient(
        _float(x), spacing=spacing,
        dim=_axes(axis) if axis is not None else None,
        edge_order=edge_order), [f], "gradient")
    return res[0] if len(res) == 1 else res


# ----------------------------------------------------------------------
# sorting and searching
# ----------------------------------------------------------------------
def sort(a, axis=-1, kind=None, order=None):
    return apply_op(lambda x: torch.sort(x.reshape(-1) if axis is None else x,
                                         dim=-1 if axis is None else axis,
                                         stable=True)[0], [a], "sort")


def argsort(a, axis=-1, kind=None, order=None):
    return apply_op(lambda x: torch.argsort(
        x.reshape(-1) if axis is None else x, dim=-1 if axis is None
        else axis, stable=True).to(torch.int32), [a], "argsort")


def lexsort(keys, axis=-1):
    return _from_host(onp.lexsort([_host(k) for k in keys], axis=axis),
                      keys[0])


def _kth(x, kth, axis):
    """(x with ``axis`` last, kth in [0, n)): ``jnp``'s canonical kth."""
    x = x.reshape(-1) if axis is None else x.movedim(axis, -1)
    n = x.shape[-1]
    k = operator.index(kth)
    if not -n <= k < n:
        raise ValueError("kth %d out of bounds for an axis of %d" % (k, n))
    return x, k % n


_SAME_WIDTH_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _total_order(y):
    """An integer key that sorts floats in XLA's total order (-0.0
    before 0.0, NaNs with the sign bit first, the others last); integer
    tensors are their own key."""
    if not y.is_floating_point():
        return y
    b = y.view(_SAME_WIDTH_INT[y.element_size()])
    return torch.where(b < 0, b ^ torch.iinfo(b.dtype).max, b)


def _bottom_top(y, k):
    """Indices of the k + 1 smallest of ``y`` along its last axis,
    ascending, and of the n - k - 1 largest, descending: ``lax.top_k``
    of -y and of y, which take the lowest index among ties, as a stable
    sort does."""
    key = _total_order(y)
    bottom = torch.sort(key, dim=-1, stable=True)[1][..., :k + 1]
    top = torch.sort(key, dim=-1, descending=True,
                     stable=True)[1][..., :y.shape[-1] - k - 1]
    return bottom, top


def partition(a, kth, axis=-1):
    """``jnp.partition``'s order, which is not numpy's: the kth + 1
    smallest values ascending, then the largest n - kth - 1 descending.
    Recorded: each value's gradient goes to the index ``lax.top_k``
    takes it from."""
    def f(x):
        y, k = _kth(x, kth, axis)
        out = torch.take_along_dim(y, torch.cat(_bottom_top(y, k), -1), -1)
        return out if axis is None else out.movedim(-1, axis)
    return apply_op(f, [a], "partition")


def argpartition(a, kth, axis=-1):
    """``jnp.argpartition``: the indices of the kth + 1 smallest values,
    then the remaining indices in ascending order; int32."""
    def f(x):
        y, k = _kth(x, kth, axis)
        bottom = _bottom_top(y, k)[0]
        rest = torch.ones(y.shape, dtype=torch.bool,
                          device=y.device).scatter(-1, bottom, False)
        top = torch.arange(y.shape[-1], device=y.device).expand(y.shape)[
            rest].reshape(*y.shape[:-1], -1)
        out = torch.cat([bottom, top], dim=-1).to(torch.int32)
        return out if axis is None else out.movedim(-1, axis)
    return apply_op(f, [a], "argpartition")


def msort(a):
    return sort(a, axis=0)


def _quantile(scale):
    def f(a, q, axis=None, out=None, keepdims=False, interpolation=None,
          method="linear"):
        m = interpolation or method
        qs = q._data if isinstance(q, NDArray) else q

        def g(x):
            qq = torch.as_tensor(qs, dtype=_float(x).dtype,
                                 device=x.device) / scale
            return torch.quantile(_float(x), qq, dim=axis, keepdim=keepdims,
                                  interpolation=m)
        return apply_op(g, [a], "quantile", out)
    return f


quantile = _quantile(1.0)
percentile = _quantile(100.0)


def histogram(a, bins=10, range=None, weights=None, density=None):
    """``jnp.histogram``'s algorithm: counts in the float type of ``a``
    and ``weights`` (not numpy's int64), edges as ``jnp.linspace``
    forms them, values outside the edges dropped.  Not recorded by
    autograd, as the reference's is not."""
    with torch.no_grad():
        x = _float(_tensor_of(a)).reshape(-1)
        w = None if weights is None else _tensor_of(weights, x).reshape(-1)
        dt = x.dtype if w is None else torch.promote_types(
            x.dtype, _float(w).dtype)
        x = x.to(dt)
        w = torch.ones_like(x) if w is None else w.to(dt)
        if _is_arr(bins) or onp.ndim(bins) == 1:
            edges = _tensor_of(bins, x).to(dt)
        else:
            lo, hi = (x.min(), x.max()) if range is None else (
                torch.as_tensor(r, dtype=dt, device=x.device) for r in range)
            if lo == hi:
                lo, hi = lo - 0.5, hi + 0.5
            step = (torch.arange(bins, device=x.device, dtype=dt)
                    / torch.tensor(bins, dtype=dt, device=x.device))
            edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
        n = edges.shape[0]
        idx = torch.searchsorted(edges, x, right=True)
        idx = torch.where(x == edges[-1], n - 1, idx)
        counts = torch.zeros(n + 1, dtype=dt, device=x.device).index_add_(
            0, idx, w)[1:n]
        if density:
            counts = counts / torch.diff(edges) / counts.sum()
    return NDArray(counts), NDArray(edges)


def bincount(x, weights=None, minlength=0):
    return apply_op(lambda i, *w: torch.bincount(
        i.long(), w[0] if w else None, minlength).to(
        torch.int32 if not w else w[0].dtype),
        [x] + ([] if weights is None else [weights]), "bincount")


def _digitize(a, b, right):
    """numpy's ``digitize``: increasing bins (``b[-1] >= b[0]``) by a
    search, decreasing ones by the search of the flipped bins counted
    from the end."""
    if b.numel() and b[-1] < b[0]:
        r = b.numel() - torch.searchsorted(torch.flip(b, (0,)), a,
                                           right=not right)
    else:
        r = torch.bucketize(a, b, right=not right)
    return r.to(torch.int32)


def digitize(x, bins, right=False):
    return apply_op(lambda a, b: _digitize(a, b, right), [x, bins],
                    "digitize")


# ----------------------------------------------------------------------
# logic and types
# ----------------------------------------------------------------------
def array_equal(a1, a2, equal_nan=False):
    x, y = _tensor_of(a1), _tensor_of(a2)
    if x.shape != y.shape:
        return False
    y = y.to(x.device)
    same = x == y
    if equal_nan:
        same = same | (torch.isnan(_float(x)) & torch.isnan(_float(y)))
    return builtins.bool(same.all())


def array_equiv(a1, a2):
    x, y = _tensor_of(a1), _tensor_of(a2)
    try:
        return builtins.bool((x == y.to(x.device)).all())
    except RuntimeError:
        return False


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return builtins.bool(isclose(a, b, rtol, atol, equal_nan)._data.all())


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    like = _first_arr(a, b)
    like = like._data if isinstance(like, NDArray) else like
    return apply_op(lambda x, y: torch.isclose(
        *torch.broadcast_tensors(*(t.to(torch.result_type(x, y))
                                   for t in (x, y))), rtol, atol, equal_nan),
        [_tensor_of(a, like), _tensor_of(b, like)], "isclose")


def isscalar(x):
    return onp.isscalar(x)


def iscomplexobj(x):
    return _tensor_of(x).is_complex() if _is_arr(x) else onp.iscomplexobj(x)


def isrealobj(x):
    return not iscomplexobj(x)


def result_type(*args):
    ts = [a._data if isinstance(a, NDArray) else a for a in args]
    r = ts[0]
    for t in ts[1:]:
        r = torch.empty((), dtype=torch.result_type(r, t))
    return to_numpy_dtype(r.dtype if isinstance(r, torch.Tensor)
                          else torch.result_type(torch.as_tensor(r), r))


def promote_types(t1, t2):
    return to_numpy_dtype(torch.promote_types(to_torch_dtype(t1),
                                              to_torch_dtype(t2)))


def can_cast(from_, to, casting="safe"):
    return onp.can_cast(from_, to, casting=casting)


def shape(a):
    return a.shape if _is_arr(a) else onp.shape(a)


def ndim(a):
    return a.ndim if isinstance(a, NDArray) else onp.ndim(a)


def size(a, axis=None):
    if isinstance(a, NDArray):
        return a.size if axis is None else a.shape[axis]
    return onp.size(a, axis)


# ----------------------------------------------------------------------
# products, interpolation and the rest
# ----------------------------------------------------------------------
def einsum(subscripts, *operands, **kw):
    return apply_op(lambda *xs: torch.einsum(subscripts, *xs),
                    list(operands), "einsum")


def tensordot(a, b, axes=2):
    return apply_op(lambda x, y: torch.tensordot(x, y, dims=axes), [a, b],
                    "tensordot")


def interp(x, xp, fp, left=None, right=None, period=None):
    """Piecewise-linear interpolation over increasing ``xp``, recorded by
    autograd (``period`` runs on the host)."""
    if period is not None:
        return _from_host(onp.interp(_host(x), _host(xp), _host(fp), left,
                                     right, period).astype(onp.float32), x)
    like = _first_arr(x, xp, fp)
    like = like._data if isinstance(like, NDArray) else like

    def g(t, xs, ys):
        t, xs, ys = _float(t), _float(xs), _float(ys)
        i = torch.searchsorted(xs, t.contiguous(), right=True).clamp(
            1, xs.shape[0] - 1)
        x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
        y = y0 + (t - x0) * (y1 - y0) / (x1 - x0)
        lo = ys[0] if left is None else torch.as_tensor(left, dtype=y.dtype)
        hi = ys[-1] if right is None else torch.as_tensor(right,
                                                          dtype=y.dtype)
        return torch.where(t < xs[0], lo, torch.where(t > xs[-1], hi, y))
    return apply_op(g, [_tensor_of(x, like), _tensor_of(xp, like),
                        _tensor_of(fp, like)], "interp")


def _convolve_full(a, v):
    """The full discrete convolution of 1-D ``a`` and ``v`` in their
    promoted dtype (integers summed in float64 and rounded back)."""
    dt = torch.result_type(a, v)
    ct = dt if dt.is_floating_point else torch.float64
    if a.shape[0] < v.shape[0]:
        a, v = v, a
    n = v.shape[0] - 1
    out = F.conv1d(F.pad(a.to(ct)[None, None], (n, n)),
                   v.to(ct).flip(0)[None, None])[0, 0]
    return out if ct == dt else out.round().to(dt)


def _mode_slice(full, n, m, mode):
    if mode == "full":
        return full
    size = builtins.max(n, m) if mode == "same" else \
        builtins.max(n, m) - builtins.min(n, m) + 1
    start = (full.shape[0] - size) // 2 if mode == "same" else \
        builtins.min(n, m) - 1
    return full[start:start + size]


def convolve(a, v, mode="full"):
    return apply_op(lambda x, y: _mode_slice(
        _convolve_full(x, y), x.shape[0], y.shape[0], mode), [a, v],
        "convolve")


def correlate(a, v, mode="valid"):
    """numpy's ``correlate`` of real 1-D inputs: ``convolve(a, v[::-1])``."""
    return apply_op(lambda x, y: _mode_slice(
        _convolve_full(x, y.flip(0)), x.shape[0], y.shape[0], mode), [a, v],
        "correlate")


def vander(x, N=None, increasing=False):
    return apply_op(lambda a: torch.vander(a, N, increasing), [x], "vander")


def unravel_index(indices, shape, order="C"):
    return tuple(_from_host(i, indices if _is_arr(indices) else None)
                 for i in onp.unravel_index(_host(indices), shape, order))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    return _from_host(onp.ravel_multi_index(
        tuple(_host(m) for m in multi_index), dims, mode=mode, order=order),
        _first_arr(*multi_index))


def apply_along_axis(func1d, axis, arr, *args, **kw):
    def host_fn(x):
        r = func1d(NDArray(torch.from_numpy(onp.array(x)).to(
            arr._data.device)), *args, **kw)
        return _host(r) if _is_arr(r) else r
    return _from_host(onp.apply_along_axis(host_fn, axis, _host(arr)), arr)


def polyval(p, x):
    like = _first_arr(p, x)
    like = like._data if isinstance(like, NDArray) else like

    def g(c, t):
        out = torch.zeros_like(_float(t)) + c[0]
        for k in builtins.range(1, c.shape[0]):
            out = out * t + c[k]
        return out
    return apply_op(g, [_tensor_of(p, like), _tensor_of(x, like)], "polyval")


def isin(element, test_elements, assume_unique=False, invert=False):
    like = _first_arr(element, test_elements)
    like = like._data if isinstance(like, NDArray) else like
    return apply_op(lambda a, b: torch.isin(a, b, invert=invert),
                    [_tensor_of(element, like),
                     _tensor_of(test_elements, like)], "isin")


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(ar1, ar2, assume_unique, invert).reshape(-1)


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    def g(a, *b):
        x = _float(a)
        x = x if x.dim() > 1 else x[None]
        if not rowvar:
            x = x.T
        if b:
            yy = _float(b[0])
            yy = yy if yy.dim() > 1 else yy[None]
            x = torch.cat([x, yy if rowvar else yy.T])
        corr = ddof if ddof is not None else (0 if bias else 1)
        return torch.cov(x, correction=corr,
                         fweights=None if fweights is None
                         else _tensor_of(fweights, x),
                         aweights=None if aweights is None
                         else _tensor_of(aweights, x)).squeeze()
    return apply_op(g, [m] + ([] if y is None else [y]), "cov")


def corrcoef(x, y=None, rowvar=True):
    c = cov(x, y, rowvar)
    return apply_op(lambda s: s / torch.sqrt(torch.outer(torch.diagonal(s),
                                                         torch.diagonal(s)))
                    if s.dim() == 2 else s / s, [c], "corrcoef")


def fill_diagonal(a, val, wrap=False):
    """Writes ``val`` on the diagonal of ``a`` in place."""
    host = _host(a)
    onp.fill_diagonal(host, _host(val) if _is_arr(val) else val, wrap=wrap)
    a[...] = _from_host(host, a).astype(a.dtype)


def _window(onp_fn, name):
    def f(M, dtype="float32", ctx=None, device=None):
        return NDArray(as_tensor(onp_fn(M), dtype or "float32",
                                 _dev(ctx, device)))
    f.__name__ = name
    return f


hanning = _window(onp.hanning, "hanning")
hamming = _window(onp.hamming, "hamming")
blackman = _window(onp.blackman, "blackman")


def set_printoptions(**kwargs):
    onp.set_printoptions(**kwargs)


def genfromtxt(*args, **kwargs):
    return NDArray(onp.genfromtxt(*args, **kwargs))


from . import fft, linalg, random  # noqa: E402,F401
