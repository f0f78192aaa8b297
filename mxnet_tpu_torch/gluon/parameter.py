"""Gluon parameters with deferred initialization.

Counterpart of ``mxnet_tpu/gluon/parameter.py`` (``Parameter`` :26,
``grad_req`` :84, ``initialize`` :104, ``_finish_deferred_init`` :145,
``cast`` :266).  The port's parameter is ``torch.nn.Parameter`` itself,
so ``collect_params``, ``convert.load_params``, the optimizers and the
``Trainer`` see plain torch parameters.  :func:`Parameter` makes one and
hangs the MXNet metadata on it as ``p._mx`` (a :class:`ParamSpec`):

* a shape may hold ``0`` for a dimension not known yet.  Until
  :func:`initialize` and, for such a shape, the first forward
  (:func:`finish_deferred_init`) give it storage, the parameter is a
  ``torch.nn.parameter.UninitializedParameter``, which turns itself into
  a ``torch.nn.Parameter`` in place when materialised;
* ``grad_req="null"`` is ``requires_grad=False`` (BatchNorm's running
  statistics, frozen weights); ``"write"`` is ``True``.  MXNet's
  ``"add"`` and ``lr_mult`` / ``wd_mult`` wait for ROADMAP queue 1b';
* the parameter's own initializer (``init``, e.g. a layer's
  ``bias_initializer``) overrides the default one's name-suffix rule.

Every parameter gets its storage the one way: :func:`initialize` (a
known shape) or :func:`finish_deferred_init` (a shape with a 0, at the
first forward or in ``convert.load_params``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn.parameter import UninitializedParameter

from .. import initializer as init_mod

__all__ = ["Parameter", "ParamSpec", "DeferredInitializationError",
           "initialize", "finish_deferred_init", "is_deferred",
           "mark_initialized", "set_grad_req", "cast"]


class DeferredInitializationError(RuntimeError):
    """A parameter is used before ``initialize`` gave it a device and an
    initializer."""


def _dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _requires_grad(grad_req):
    if grad_req == "add":
        raise NotImplementedError("mxnet_tpu_torch: grad_req='add' is not "
                                  "ported yet (ROADMAP queue 1b')")
    if grad_req not in ("write", "null"):
        raise ValueError("grad_req must be write/add/null, got %r"
                         % (grad_req,))
    return grad_req == "write"


@dataclass
class ParamSpec:
    """MXNet metadata of a parameter: its shape (0 = not known yet), its
    dtype, its own initializer, whether it holds values, and the
    (name, default initializer, device, generator) that a deferred
    initialization waits with."""
    shape: tuple
    dtype: torch.dtype
    init: object = None
    initialized: bool = False
    deferred: tuple = None


def Parameter(shape, dtype="float32", init=None, grad_req="write"):
    """An ``UninitializedParameter`` carrying a :class:`ParamSpec`; it
    becomes a ``torch.nn.Parameter`` when given storage."""
    spec = ParamSpec(tuple(shape), _dtype(dtype), init)
    p = UninitializedParameter(requires_grad=_requires_grad(grad_req),
                               dtype=spec.dtype)
    p._mx = spec
    return p


def _spec(p):
    spec = getattr(p, "_mx", None)
    if spec is None:        # a plain torch parameter: known shape, no init
        spec = p._mx = ParamSpec(tuple(p.shape), p.dtype)
    return spec


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
        if tuple(p.shape) != shape:
            raise ValueError("Expected shape %s is incompatible with given "
                             "shape %s" % (tuple(p.shape), shape))
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
    """``"write"`` -> trainable, ``"null"`` -> frozen (no gradient)."""
    p.requires_grad_(_requires_grad(grad_req))
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
