"""The imperative NDArray: a thin handle over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``: ``NDArray`` (:103),
``apply_op`` (:49), the methods of :139-632 (the arithmetic, comparison
and indexing dunders, ``asnumpy``, ``as_in_context``, ``copyto``,
``astype``, the reductions) and ``attach_grad`` / ``grad`` /
``backward`` (:297-316).  The JAX package's handle holds an immutable
``jax.Array`` and swaps it on every write; the port's holds a tensor,
and a write goes into that tensor in place (``a[:] = x``, ``a += b``),
so an NDArray over a parameter (``p.data()``) writes the parameter.
The one exception is a write while ``autograd.record()`` is recording to
a tensor autograd tracks: the handle is rebound to an updated copy, as
autograd needs.

Torch autograd is the tape (there is no second one): operations on
NDArrays under ``autograd.record()`` are recorded by torch, and
``attach_grad`` / ``backward`` / ``grad`` map onto it through
:mod:`mxnet_tpu_torch.autograd`.

Dtypes follow the JAX package (64-bit types off by default): an NDArray
made from Python or numpy data without a dtype holds float32 for floats
and int32 for integers; an explicit dtype, float64 included, is kept.
New arrays go to the current context (``mx.gpu(0)`` outside any
``with mx.cpu():`` scope), which raises without a card.
"""
from __future__ import annotations

import numbers

import numpy as onp
import torch

from .. import engine
from .. import profiler as _profiler
from ..context import Context, current_context, resolve_device

__all__ = ["NDArray", "apply_op", "array", "zeros", "ones", "full", "empty",
           "arange", "concatenate", "stack", "waitall", "to_torch_dtype"]

_BY_NAME = {
    "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "half": torch.float16, "float": torch.float32, "double": torch.float64,
    "bool_": torch.bool,
}
_PY_TYPES = {float: torch.float32, int: torch.int32, bool: torch.bool,
             complex: torch.complex64}
# 64-bit types off: what a Python or numpy value becomes without a dtype
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32,
              torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def to_torch_dtype(dtype):
    """A torch dtype from a name, a numpy dtype or type, a Python type or
    a torch dtype (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if dtype in _PY_TYPES:
        return _PY_TYPES[dtype]
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError("unsupported dtype %r" % (dtype,)) from None


def to_numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    stays ``torch.bfloat16``."""
    if dtype == torch.bfloat16:
        return dtype
    return onp.dtype(str(dtype).replace("torch.", ""))


def as_tensor(obj, dtype=None, device=None):
    """A tensor of ``obj`` (NDArray, tensor, numpy array, Python value) on
    ``device`` (None: the tensor's own, else the current context), in
    ``dtype`` (None: the canonical dtype of Python / numpy data)."""
    dtype = to_torch_dtype(dtype)
    if isinstance(obj, NDArray):
        obj = obj._data
    if isinstance(obj, torch.Tensor):
        dev = obj.device if device is None else resolve_device(device)
        return obj.to(device=dev, dtype=dtype or obj.dtype)
    dev = resolve_device(device)
    if isinstance(obj, (list, tuple)) and any(
            isinstance(o, (NDArray, torch.Tensor)) for o in obj):
        return torch.stack([as_tensor(o, dtype, dev) for o in obj])
    arr = onp.asarray(obj)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array
        arr = arr.astype(onp.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(onp.array(arr, copy=True)) if arr.dtype != object \
        else torch.as_tensor(obj)
    if dtype is None:
        dtype = _CANONICAL.get(t.dtype, t.dtype)
    return t.to(device=dev, dtype=dtype)


def _scalar_or_tensor(x, like):
    """A binary op's other operand: an NDArray's tensor, a Python number
    as is (torch keeps the tensor's dtype, as JAX's weak types do), an
    array as a tensor on ``like``'s device."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (torch.Tensor, numbers.Number)):
        return x
    if isinstance(x, (onp.ndarray, onp.generic, list, tuple)):
        return as_tensor(x, device=like.device)
    return None


def apply_op(fn, inputs, name=None, out=None):
    """Run ``fn`` on the tensors of ``inputs`` (NDArrays, tensors, or
    Python / numpy values, which become tensors on the current context)
    and wrap its tensor results as NDArrays (a tuple or list gives a
    list).  Under ``autograd.record()`` torch records the op.  With
    ``out`` the result is written into that NDArray.  Under
    NaiveEngine the op waits for its outputs before it returns.  With
    the profiler running and ``profile_imperative`` on, each call records
    one op-dispatch event (host time; the device trace has the kernels'),
    as the reference's seam does; off, the cost is one flag read."""
    prof_t0 = _profiler._now_us() if _profiler._IMPERATIVE else None
    args = [x._data if isinstance(x, NDArray) else
            x if isinstance(x, torch.Tensor) else as_tensor(x)
            for x in inputs]
    res = fn(*args)
    multi = isinstance(res, (tuple, list))
    outs = list(res) if multi else [res]
    if engine.is_naive():
        engine._sync_outputs([r for r in outs if isinstance(r, torch.Tensor)])
    wrapped = [NDArray(r) if isinstance(r, torch.Tensor) else r
               for r in outs]
    if prof_t0 is not None:
        _profiler.record_duration(
            name or getattr(fn, "__name__", "op"), "operator",
            prof_t0, _profiler._now_us() - prof_t0,
            args={"inputs": len(args), "outputs": len(outs)})
    if out is not None:
        if multi:
            raise ValueError("out= only supported for single-output ops")
        out[...] = wrapped[0]
        return out
    return wrapped if multi else wrapped[0]


def _np():
    from .. import numpy as mnp
    return mnp


def _negative_steps(key):
    items = key if isinstance(key, tuple) else (key,)
    return any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in items)


def _index(x, key):
    """``x[key]`` with numpy's negative slice steps, which torch refuses:
    each such slice is read as the positive-step slice over the same
    positions, flipped, and the rest of the key is applied after."""
    if not _negative_steps(key):
        return x[key]
    items = key if isinstance(key, tuple) else (key,)
    used = sum(k.dim() if isinstance(k, torch.Tensor) and
               k.dtype == torch.bool else 0 if k is None or k is Ellipsis
               else 1 for k in items)
    first, rest, flip, dim = [], [], [], 0
    for k in items:
        if k is Ellipsis:
            first.append(k)
            rest.append(k)
            dim += x.dim() - used
        elif k is None:
            rest.append(k)
        elif isinstance(k, slice):
            start, stop, step = k.indices(x.shape[dim])
            if step < 0:
                n = len(range(start, stop, step))
                last = start + (n - 1) * step
                k = slice(last, start + 1, -step) if n else slice(0, 0)
                flip.append(dim)
            first.append(k)
            rest.append(slice(None))
            dim += 1
        else:
            width = k.dim() if isinstance(k, torch.Tensor) and \
                k.dtype == torch.bool else 1
            first += [slice(None)] * width
            rest.append(k)
            dim += width
    return x[tuple(first)].flip(flip)[tuple(rest)]


class NDArray:
    """An n-dimensional array on a device: ``NDArray(data, ctx=None,
    dtype=None)`` over a tensor (kept as is), another NDArray (sharing
    its tensor) or Python / numpy data (copied to ``ctx``, else the
    current context)."""

    __slots__ = ("_data", "__weakref__")
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if isinstance(data, torch.Tensor):
            if ctx is not None or dtype is not None:
                data = as_tensor(data, dtype, ctx)
        else:
            data = as_tensor(data, dtype,
                             current_context() if ctx is None else ctx)
        self._data = data

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return to_numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def itemsize(self):
        return self._data.element_size()

    @property
    def context(self):
        return Context(self._data.device)

    ctx = context
    device = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    # -- sync and host copies ------------------------------------------------
    def wait_to_read(self):
        engine._sync_outputs([self._data])

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A writable host copy; bfloat16 comes out as float32, which
        holds it exactly."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(()).item()

    item = asscalar

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __dlpack__(self, **kw):
        return self._data.detach().__dlpack__(**kw)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    # -- autograd --------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable of the tape with a zero gradient
        buffer; ``grad_req`` ``"write"`` (each backward overwrites the
        buffer) or ``"add"`` (each backward adds to it)."""
        from .. import autograd
        autograd.mark_variables([self], None, grad_req)

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else NDArray(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True,
                 create_graph=False):
        """Gradients of this array into every variable's buffer; a
        non-scalar head without ``out_grad`` is seeded with ones."""
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph)

    def detach(self):
        return NDArray(self._data.detach())

    def zero_grad(self):
        if self._data.grad is not None:
            self._data.grad.zero_()

    # -- conversion and movement -------------------------------------------
    def astype(self, dtype, copy=True):
        dt = to_torch_dtype(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return apply_op(lambda x: x.to(dt), [self], "astype")

    def copy(self):
        return apply_op(torch.clone, [self], "copy")

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, in place) or to a context."""
        if isinstance(other, NDArray):
            other[...] = self
            return other
        return self.as_in_context(other)

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if self._data.device == dev:
            return self
        return apply_op(lambda x: x.to(dev), [self], "as_in_context")

    as_in_ctx = as_in_context
    to_device = as_in_context

    def as_np_ndarray(self):
        return self

    def as_nd_ndarray(self):
        return self

    # -- shape -------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _np().reshape(self, shape)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _np().transpose(self, axes or None)

    def flatten(self):
        n = self.shape[0] if self.ndim > 1 else -1
        return self.reshape((n, -1) if self.ndim > 1 else (-1,))

    def ravel(self):
        return _np().ravel(self)

    def squeeze(self, axis=None):
        return _np().squeeze(self, axis)

    def expand_dims(self, axis):
        return _np().expand_dims(self, axis)

    def swapaxes(self, a1, a2):
        return _np().swapaxes(self, a1, a2)

    def broadcast_to(self, shape):
        return _np().broadcast_to(self, shape)

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def repeat(self, repeats, axis=None):
        return _np().repeat(self, repeats, axis)

    def tile(self, reps):
        return _np().tile(self, reps)

    def clip(self, a_min=None, a_max=None):
        return _np().clip(self, a_min, a_max)

    def pad(self, *a, **kw):
        return _np().pad(self, *a, **kw)

    def split(self, *a, **kw):
        return _np().split(self, *a, **kw)

    def take(self, indices, axis=None, mode="clip"):
        return _np().take(self, indices, axis=axis, mode=mode)

    def dot(self, b):
        return _np().dot(self, b)

    def diag(self, k=0):
        return _np().diag(self, k)

    def one_hot(self, depth, **kw):
        from .. import numpy_extension as npx
        return npx.one_hot(self, depth, **kw)

    # -- reductions and math ---------------------------------------------------
    def sum(self, axis=None, dtype=None, keepdims=False):
        return _np().sum(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return _np().mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _np().max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _np().min(self, axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return _np().prod(self, axis=axis, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False):
        return _np().std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return _np().var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def cumsum(self, axis=None, dtype=None):
        return _np().cumsum(self, axis=axis, dtype=dtype)

    def argmax(self, axis=None):
        return _np().argmax(self, axis=axis)

    def argmin(self, axis=None):
        return _np().argmin(self, axis=axis)

    def argsort(self, axis=-1, is_ascend=True):
        idx = _np().argsort(self, axis=axis)
        return idx if is_ascend else _np().flip(idx, axis)

    def sort(self, axis=-1):
        return _np().sort(self, axis=axis)

    def round(self, decimals=0):
        return _np().round(self, decimals)

    def abs(self):
        return _np().abs(self)

    def sqrt(self):
        return _np().sqrt(self)

    def exp(self):
        return _np().exp(self)

    def log(self):
        return _np().log(self)

    def sigmoid(self):
        return apply_op(torch.sigmoid, [self], "sigmoid")

    def tanh(self):
        return _np().tanh(self)

    def relu(self):
        return apply_op(torch.relu, [self], "relu")

    def softmax(self, axis=-1):
        return apply_op(lambda x: torch.softmax(x, axis), [self], "softmax")

    def log_softmax(self, axis=-1):
        return apply_op(lambda x: torch.log_softmax(x, axis), [self],
                        "log_softmax")

    def norm(self, ord=None, axis=None, keepdims=False):  # noqa: A002
        """numpy's ``linalg.norm``: the 2-norm of the flattened array, of
        vectors along an ``axis``, or a matrix norm over two axes."""
        def g(x):
            if axis is None and ord is None:
                r = torch.linalg.vector_norm(x.reshape(-1))
                return r.reshape((1,) * x.dim()) if keepdims else r
            if isinstance(axis, (tuple, list)) and len(axis) == 2:
                return torch.linalg.matrix_norm(x, ord or "fro", axis,
                                                keepdims)
            return torch.linalg.vector_norm(x, 2 if ord is None else ord,
                                            axis, keepdims)
        return apply_op(g, [self], "norm")

    # -- Python protocol ---------------------------------------------------------
    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (self.asnumpy(),
                                         "x".join(map(str, self.shape)),
                                         self.context)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with more than "
                             "one element is ambiguous.")
        return bool(self._data.item())

    def __float__(self):
        return float(self._data.item())

    def __int__(self):
        return int(self._data.item())

    def __index__(self):
        if self._data.is_floating_point():
            raise TypeError("only integer scalar arrays can be converted "
                            "to a scalar index")
        return int(self._data.item())

    def __hash__(self):
        return id(self)

    # -- indexing ------------------------------------------------------------
    @staticmethod
    def _key(key, device):
        """An index with every NDArray, array or list made a tensor."""
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(key, torch.Tensor):
            return key.to(device) if key.dtype == torch.bool \
                else key.to(device, torch.long)
        if isinstance(key, (list, onp.ndarray)):
            return NDArray._key(torch.as_tensor(onp.asarray(key)), device)
        if isinstance(key, tuple):
            return tuple(NDArray._key(k, device) for k in key)
        return key

    def __getitem__(self, key):
        key = self._key(key, self._data.device)
        return apply_op(lambda x: _index(x, key), [self], "getitem")

    def __setitem__(self, key, value):
        key = self._key(key, self._data.device)
        v = value._data if isinstance(value, NDArray) else value
        if not isinstance(v, (torch.Tensor, numbers.Number)):
            v = as_tensor(v, self._data.dtype, self._data.device)
        if isinstance(v, torch.Tensor):
            v = v.to(self._data.dtype)
        if _negative_steps(key):
            # torch slices take no negative step: write through the
            # positions the read of ``key`` gives
            pos = _index(torch.arange(self._data.numel(),
                                      device=self._data.device)
                         .view(self._data.shape), key)
            key = torch.unravel_index(pos, self._data.shape)
            if isinstance(v, torch.Tensor):
                v = v.expand(pos.shape)
        from .. import autograd
        if autograd.is_recording() and (self._data.requires_grad or (
                isinstance(v, torch.Tensor) and v.requires_grad)):
            new = self._data.clone()        # a recorded, out-of-place write
            new[key] = v
            self._data = new
        else:
            with torch.no_grad():
                self._data[key] = v

    # -- arithmetic --------------------------------------------------------------
    def _binop(self, other, fn, reverse=False):
        o = _scalar_or_tensor(other, self._data)
        if o is None:
            return NotImplemented
        if reverse:
            if not isinstance(o, torch.Tensor):     # a 0-d tensor promotes
                o = torch.as_tensor(o, device=self._data.device)  # weakly
            return apply_op(lambda x: fn(o, x), [self])
        return apply_op(lambda x: fn(x, o), [self])

    def __add__(self, o):
        return self._binop(o, torch.add)

    def __radd__(self, o):
        return self._binop(o, torch.add, True)

    def __sub__(self, o):
        return self._binop(o, torch.sub)

    def __rsub__(self, o):
        return self._binop(o, torch.sub, True)

    def __mul__(self, o):
        return self._binop(o, torch.mul)

    def __rmul__(self, o):
        return self._binop(o, torch.mul, True)

    def __truediv__(self, o):
        return self._binop(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._binop(o, torch.true_divide, True)

    def __floordiv__(self, o):
        return self._binop(o, torch.floor_divide)

    def __rfloordiv__(self, o):
        return self._binop(o, torch.floor_divide, True)

    def __mod__(self, o):
        return self._binop(o, torch.remainder)

    def __rmod__(self, o):
        return self._binop(o, torch.remainder, True)

    def __pow__(self, o):
        return self._binop(o, torch.pow)

    def __rpow__(self, o):
        return self._binop(o, torch.pow, True)

    def __matmul__(self, o):
        return self._binop(o, torch.matmul)

    def __rmatmul__(self, o):
        return self._binop(o, torch.matmul, True)

    def __neg__(self):
        return apply_op(torch.neg, [self], "neg")

    def __pos__(self):
        return self

    def __abs__(self):
        return apply_op(torch.abs, [self], "abs")

    def __invert__(self):
        return apply_op(torch.bitwise_not, [self], "invert")

    def __eq__(self, o):
        return self._binop(o, torch.eq)

    def __ne__(self, o):
        return self._binop(o, torch.ne)

    def __lt__(self, o):
        return self._binop(o, torch.lt)

    def __le__(self, o):
        return self._binop(o, torch.le)

    def __gt__(self, o):
        return self._binop(o, torch.gt)

    def __ge__(self, o):
        return self._binop(o, torch.ge)

    def __and__(self, o):
        return self._binop(o, torch.bitwise_and)

    def __or__(self, o):
        return self._binop(o, torch.bitwise_or)

    def __xor__(self, o):
        return self._binop(o, torch.bitwise_xor)

    def __lshift__(self, o):
        return self._binop(o, torch.bitwise_left_shift)

    def __rshift__(self, o):
        return self._binop(o, torch.bitwise_right_shift)

    def _iop(self, other, fn):
        res = self._binop(other, fn)
        if res is NotImplemented:
            return res
        self[...] = res
        return self

    def __iadd__(self, o):
        return self._iop(o, torch.add)

    def __isub__(self, o):
        return self._iop(o, torch.sub)

    def __imul__(self, o):
        return self._iop(o, torch.mul)

    def __itruediv__(self, o):
        return self._iop(o, torch.true_divide)

    def __imod__(self, o):
        return self._iop(o, torch.remainder)


# ----------------------------------------------------------------------
# creation helpers (the full set is in mxnet_tpu_torch.numpy)
# ----------------------------------------------------------------------
def array(obj, dtype=None, ctx=None):
    return NDArray(as_tensor(obj, dtype, ctx if ctx is not None
                             else current_context()))


def zeros(shape, ctx=None, dtype=None):
    return _np().zeros(shape, dtype=dtype, ctx=ctx)


def ones(shape, ctx=None, dtype=None):
    return _np().ones(shape, dtype=dtype, ctx=ctx)


def full(shape, val, ctx=None, dtype=None):
    return _np().full(shape, val, dtype=dtype or "float32", ctx=ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    a = _np().arange(start, stop, step, dtype=dtype or "float32", ctx=ctx)
    return a if repeat == 1 else _np().repeat(a, repeat)


def concatenate(arrays, axis=0):
    return _np().concatenate(arrays, axis=axis)


def stack(arrays, axis=0):
    return _np().stack(arrays, axis=axis)


def waitall():
    """Wait for all queued work on the card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
