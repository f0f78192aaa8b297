"""Gluon parameters with deferred initialization.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (``Parameter`` :26,
``lr_mult`` / ``wd_mult`` :27-35, ``grad_req`` :84, ``initialize``
:104, ``_finish_deferred_init`` :145, the accessors ``data`` /
``list_data`` / ``grad`` / ``set_data`` :176-215, ``cast`` :266,
``Constant`` :290, ``shard`` / ``sharding_spec`` :278-287).  The
port's parameter is a ``torch.nn.Parameter`` (the subclass
:class:`TorchParameter`), so ``collect_params``,
``convert.load_params``, the optimizers and the ``Trainer`` see torch
parameters.  :func:`Parameter` makes one and hangs the MXNet metadata on
it as ``p._mx`` (a :class:`ParamSpec`):

* a shape may hold ``0`` for a dimension not known yet.  Until
  :func:`initialize` and, for such a shape, the first forward
  (:func:`finish_deferred_init`) give it storage, the parameter is an
  uninitialized one (``torch.nn.parameter.UninitializedParameter``),
  which turns itself into a :class:`TorchParameter` in place when
  materialised;
* ``grad_req="null"`` is ``requires_grad=False`` (BatchNorm's running
  statistics, frozen weights); ``"write"`` and ``"add"`` are ``True``.
  Torch adds every backward into ``.grad``: that is ``"add"``, and the
  ``Trainer`` leaves such a gradient alone after a step (the user calls
  ``zero_grad``), where it sets a ``"write"`` gradient to ``None`` so the
  next backward writes it fresh;
* ``lr_mult`` / ``wd_mult`` scale the optimizer's learning rate and
  weight decay for this parameter, read by ``Optimizer._get_lr`` /
  ``_get_wd`` through the Trainer's ``param_dict``;
* the parameter's own initializer (``init``, e.g. a layer's
  ``bias_initializer``) overrides the default one's name-suffix rule.

MXNet reads a parameter through methods where torch has attributes of
the same names: ``p.data()`` and ``p.grad()`` against torch's ``p.data``
and ``p.grad``.  So on a :class:`TorchParameter` both attributes give
torch's tensor as ever (the same storage, for torch code and the
optimizers), and that tensor can also be called: ``p.data()`` is an
``NDArray`` over the parameter itself (sharing its storage, and tracked
by autograd), ``p.grad()`` an ``NDArray`` over its gradient.

Every parameter gets its storage the one way: :func:`initialize` (a
known shape) or :func:`finish_deferred_init` (a shape with a 0, at the
first forward, in ``set_data`` or in ``convert.load_params``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn.parameter import UninitializedParameter

from .. import initializer as init_mod

__all__ = ["Parameter", "Constant", "TorchParameter", "ParamSpec",
           "DeferredInitializationError", "initialize",
           "finish_deferred_init", "global_shape", "is_deferred",
           "mark_initialized", "set_grad_req", "cast"]

_GET_DATA = torch._C.TensorBase.data.__get__
_SET_DATA = torch._C.TensorBase.data.__set__
_GET_GRAD = torch._C.TensorBase.grad.__get__
_SET_GRAD = torch._C.TensorBase.grad.__set__


class DeferredInitializationError(RuntimeError):
    """A parameter is used before ``initialize`` gave it a device and an
    initializer."""


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _requires_grad(grad_req):
    if grad_req not in ("write", "add", "null"):
        raise ValueError("grad_req must be write/add/null, got %r"
                         % (grad_req,))
    return grad_req != "null"


@dataclass
class ParamSpec:
    """MXNet metadata of a parameter: its shape (0 = not known yet), its
    dtype, its own initializer, whether it holds values, the (name,
    default initializer, device, generator) that a deferred
    initialization waits with, ``grad_req`` and the optimizer's
    ``lr_mult`` / ``wd_mult``."""
    shape: tuple
    dtype: torch.dtype
    init: object = None
    initialized: bool = False
    deferred: tuple = None
    grad_req: str = "write"
    lr_mult: float = 1.0
    wd_mult: float = 1.0
    sharding_spec: tuple = None
    placement: object = None
    global_shape: tuple = None


class _Accessor(torch.Tensor):
    """Torch's ``p.data`` / ``p.grad`` tensor (an alias of its storage)
    that MXNet code can also call: ``p.data()``, ``p.grad()``."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    def __call__(self, ctx=None, device=None):
        from ..ndarray.ndarray import NDArray
        return NDArray(self._mx_target)


def _accessor(tensor, target):
    acc = torch.Tensor._make_subclass(_Accessor, tensor)
    acc._mx_target = target
    return acc


def _plain(value):
    """A value set through ``p.data = ...`` / ``p.grad = ...`` as a plain
    tensor (an accessor is unwrapped to an alias of its storage)."""
    if isinstance(value, _Accessor):
        return value.as_subclass(torch.Tensor)
    return value


class _MXParameterMixin:
    """The MXNet side of a port parameter: callable ``data`` / ``grad``,
    ``set_data``, ``list_data``, ``list_grad``, ``zero_grad``, ``cast``
    and the ``grad_req`` / ``lr_mult`` / ``wd_mult`` attributes."""

    @property
    def data(self):
        t = _GET_DATA(self)
        return t if is_deferred(self) else _accessor(t, self)

    @data.setter
    def data(self, value):
        _SET_DATA(self, _plain(value))

    @property
    def grad(self):
        g = _GET_GRAD(self)
        return None if g is None else _accessor(g, g)

    @grad.setter
    def grad(self, value):
        _SET_GRAD(self, _plain(value))

    def _check_initialized(self):
        if is_deferred(self):
            raise DeferredInitializationError(
                "Parameter of shape %s has not been initialized: call "
                ".initialize() on its block, and run a forward for a "
                "shape with an unknown dimension" % (_spec(self).shape,))

    def list_data(self):
        self._check_initialized()
        return [self.data()]

    def list_grad(self):
        return [self.grad()]

    def set_data(self, data):
        """Copy ``data`` (an NDArray, tensor or array) into the
        parameter, cast to its dtype; a deferred parameter takes its
        shape, on the device ``initialize`` named."""
        from ..ndarray.ndarray import NDArray
        src = data._data if isinstance(data, NDArray) else \
            torch.as_tensor(data)
        finish_deferred_init(self, src.shape)
        with torch.no_grad():
            _GET_DATA(self).copy_(src)
        mark_initialized(self)

    def zero_grad(self):
        g = _GET_GRAD(self)
        if g is not None:
            g.zero_()

    def cast(self, dtype):
        cast(self, dtype)

    @property
    def grad_req(self):
        return _spec(self).grad_req

    @grad_req.setter
    def grad_req(self, req):
        set_grad_req(self, req)

    @property
    def lr_mult(self):
        return _spec(self).lr_mult

    @lr_mult.setter
    def lr_mult(self, value):
        _spec(self).lr_mult = value

    @property
    def wd_mult(self):
        return _spec(self).wd_mult

    @wd_mult.setter
    def wd_mult(self, value):
        _spec(self).wd_mult = value

    # -- sharding (reference :278-287) ------------------------------------
    def shard(self, spec):
        """Annotate with a PartitionSpec-like tuple, e.g. ``('tp',
        None)``, for ``parallel.shard_params`` / ``TrainStep(mesh=)``."""
        _spec(self).sharding_spec = tuple(spec)
        return self

    @property
    def sharding_spec(self):
        return _spec(self).sharding_spec

    @property
    def sharding(self):
        """The placement ``parallel.shard_params`` gave the parameter
        (``.mesh``, ``.spec``): its data is then this rank's block of
        the global array; None when it holds the whole array."""
        return _spec(self).placement

    @property
    def global_shape(self):
        """The shape of the whole parameter (``shape`` is this rank's
        block once sharded)."""
        return global_shape(self)


class TorchParameter(_MXParameterMixin, torch.nn.Parameter):
    """A materialised port parameter: a ``torch.nn.Parameter`` with the
    MXNet accessors of :class:`_MXParameterMixin`."""


class _UninitializedParameter(_MXParameterMixin, UninitializedParameter):
    cls_to_become = TorchParameter


def Parameter(shape, dtype="float32", init=None, grad_req="write"):
    """An uninitialized parameter carrying a :class:`ParamSpec`; it
    becomes a :class:`TorchParameter` when given storage."""
    spec = ParamSpec(tuple(shape), _dtype(dtype), init, grad_req=grad_req)
    p = _UninitializedParameter(requires_grad=_requires_grad(grad_req),
                                dtype=spec.dtype)
    p._mx = spec
    return p


def Constant(value):
    """A parameter that holds ``value`` and is never updated
    (``grad_req="null"``); ``Block.initialize`` puts it on the block's
    device."""
    value = torch.as_tensor(value._data if hasattr(value, "_data")
                            else value)
    return Parameter(tuple(value.shape), value.dtype,
                     init_mod.Constant(value.detach().cpu()),
                     grad_req="null")


def _spec(p):
    spec = getattr(p, "_mx", None)
    if spec is None:        # a plain torch parameter: known shape, no init
        spec = p._mx = ParamSpec(tuple(p.shape), p.dtype)
    return spec


def global_shape(p):
    """The whole parameter's shape: its own, or what it was before
    ``parallel.shard_params`` gave this rank a block of it."""
    meta = getattr(p, "_mx", None)
    if meta is not None and meta.global_shape is not None:
        return tuple(meta.global_shape)
    return tuple(p.shape)


def is_deferred(p):
    """True while ``p`` has no storage."""
    return isinstance(p, UninitializedParameter)


def mark_initialized(p):
    """Record that ``p``'s values were set (by a loader)."""
    _spec(p).initialized = True


def _fill(p, name, spec, default_init, generator):
    init = spec.init if spec.init is not None else default_init
    if isinstance(init, str):
        init = init_mod.create(init)
    attrs = {"__init__": init} if spec.init is not None \
        and isinstance(init, init_mod.Initializer) else {}
    init(init_mod.InitDesc(name, attrs), p.data, generator)
    spec.initialized = True


def initialize(p, name, default_init, device, generator=None,
               force_reinit=False):
    """Initialize ``p`` (full name ``name``) on ``device``: a parameter
    with a known shape is filled now, one with an unknown dimension
    waits for its first forward.  A parameter that already holds values
    is left alone unless ``force_reinit``, which refills it where it
    lies."""
    spec = _spec(p)
    if spec.initialized and not force_reinit:
        return
    if is_deferred(p):
        if any(d == 0 for d in spec.shape):
            spec.deferred = (name, default_init, device, generator)
            return
        p.materialize(spec.shape, device=device, dtype=spec.dtype)
    _fill(p, name, spec, default_init, generator)


def finish_deferred_init(p, shape):
    """Give a deferred ``p`` the shape its first input implies, on the
    device ``initialize`` named, and fill it; a parameter that already
    has storage only checks that ``shape`` fits it."""
    shape = tuple(shape)
    if not is_deferred(p):
        have = global_shape(p)
        if have != shape:
            raise ValueError("Expected shape %s is incompatible with given "
                             "shape %s" % (have, shape))
        return
    spec = _spec(p)
    if len(shape) != len(spec.shape) or any(
            old not in (0, new) for old, new in zip(spec.shape, shape)):
        raise ValueError("Expected shape %s is incompatible with given "
                         "shape %s" % (spec.shape, shape))
    if spec.deferred is None:
        raise DeferredInitializationError(
            "Parameter of shape %s has not been initialized: call "
            ".initialize() on its block first" % (spec.shape,))
    name, default_init, device, generator = spec.deferred
    spec.shape, spec.deferred = shape, None
    p.materialize(shape, device=device, dtype=spec.dtype)
    _fill(p, name, spec, default_init, generator)


def set_grad_req(p, grad_req):
    """``"write"`` / ``"add"`` -> trainable, ``"null"`` -> frozen (no
    gradient)."""
    p.requires_grad_(_requires_grad(grad_req))
    _spec(p).grad_req = grad_req
    if not p.requires_grad:
        p.grad = None


def cast(p, dtype):
    """Cast ``p`` to ``dtype``: its storage is replaced (its gradient
    dropped); a deferred parameter will be made in ``dtype``."""
    spec = _spec(p)
    spec.dtype = _dtype(dtype)
    if not is_deferred(p):
        p.grad = None
        p.data = p.data.to(spec.dtype)
