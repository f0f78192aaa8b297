"""``Block`` and ``HybridBlock``: the base of the port's layers and models.

Counterpart of ``mxnet_tpu/gluon/block.py`` (``collect_params`` :78,
``initialize`` :95, ``zero_grad`` :112, ``cast`` :122, ``HybridBlock``
:346 with ``_CachedGraph`` / ``_build_cache`` / ``_call_cached``
:332-494) over ``torch.nn.Module``.  A parameter is a
``torch.nn.Parameter`` (:mod:`.parameter`); ``state_dict()`` keys and
``collect_params()`` names are the same structural paths
(``features.4.0.body.0.weight``, ``layer0.attention.wq.weight``), which
are the JAX package's names.

A block takes ``NDArray`` inputs as well as tensors: called with one (or
with one given to ``forward`` directly, as ``net.forward(NDArray(x))``),
it runs on the tensors the NDArrays hold and returns NDArrays, so the
torch-tensor paths stay as they are.  ``initialize()`` without a
generator draws from ``mx.np.random``'s generator for the device, which
``mx.np.random.seed`` seeds.
"""
from __future__ import annotations

import functools
import re
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from .. import initializer as init_mod
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ops import cuda_ops
from . import parameter as param_mod

__all__ = ["Block", "HybridBlock"]


def _has_nd(args, kwargs):
    """Whether an argument (or an item of a list / tuple argument) is an
    NDArray; on every forward, so kept cheap."""
    for a in (args if not kwargs else (*args, *kwargs.values())):
        if isinstance(a, NDArray) or (isinstance(a, (list, tuple)) and any(
                isinstance(x, NDArray) for x in a)):
            return True
    return False


def _unwrap(obj):
    """``obj`` with every NDArray of the nest replaced by its tensor."""
    if isinstance(obj, NDArray):
        return obj._data
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unwrap(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _unwrap(v) for k, v in obj.items()}
    return obj


def _wrap(obj):
    return _map(NDArray, obj)


def _nd_call(fn, args, kwargs):
    """``fn`` on the tensors of NDArray arguments, its tensors back as
    NDArrays."""
    return _wrap(fn(*_unwrap(args), **_unwrap(kwargs)))


def _nd_forward(forward):
    """``forward`` taking NDArrays too (for ``net.forward(NDArray(x))``,
    which bypasses ``__call__``)."""
    @functools.wraps(forward)
    def wrapped(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _nd_call(functools.partial(forward, self), args, kwargs)
        return forward(self, *args, **kwargs)
    wrapped._mx_nd = True
    return wrapped


class Block(nn.Module):

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fwd = cls.__dict__.get("forward")
        if fwd is not None and not getattr(fwd, "_mx_nd", False):
            cls.forward = _nd_forward(fwd)

    def __call__(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _nd_call(self.__call__, args, kwargs)
        return super().__call__(*args, **kwargs)

    def collect_params(self, select=None):
        """Ordered ``{name: Parameter}``; ``select`` is a regular
        expression matched at the start of each name."""
        pattern = re.compile(select) if select else None
        return OrderedDict((name, p) for name, p in self.named_parameters()
                           if pattern is None or pattern.match(name))

    def initialize(self, init=None, device=None, generator=None,
                   force_reinit=False):
        """Initialize every parameter on ``device`` (``None`` = the
        current context: CUDA outside any scope, raising without a card)
        with its own initializer, else ``init`` (default
        ``Uniform(0.07)``), drawing from ``generator`` (default:
        ``mx.np.random``'s generator for the device).  A parameter with
        an unknown dimension is filled at the block's first forward.
        Returns the block."""
        if init is None or isinstance(init, str):
            init = init_mod.create(init or "uniform")
        device = resolve_device(device)
        if generator is None:
            from ..numpy import random as np_random
            generator = np_random.generator(device)
        for name, p in self.collect_params().items():
            param_mod.initialize(p, name, init, device, generator,
                                 force_reinit)
        return self

    def cast(self, dtype):
        """Cast every parameter (BatchNorm's statistics included) to
        ``dtype``."""
        for p in self.parameters():
            param_mod.cast(p, dtype)
        return self

    def setattr(self, name, value):
        """Set an attribute on every parameter: ``grad_req``,
        ``lr_mult``, ``wd_mult``."""
        if name not in ("grad_req", "lr_mult", "wd_mult"):
            raise AttributeError("a parameter has no MXNet attribute %r"
                                 % (name,))
        for p in self.parameters():
            if name == "grad_req":
                param_mod.set_grad_req(p, value)
            else:
                setattr(param_mod._spec(p), name, value)

    def share_parameters(self, shared):
        """Use the parameters of ``shared`` (``{name: Parameter}``, as
        ``collect_params()`` gives) in place of this block's own of the
        same names; returns the block."""
        own = self.collect_params()
        for name, p in shared.items():
            if name in own:
                *path, leaf = name.split(".")
                blk = self
                for part in path:
                    blk = getattr(blk, part)
                setattr(blk, leaf, p)
        return self

    def hybridize(self, active=True, **kwargs):
        """A plain Block passes ``hybridize`` on to its children."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    def zero_grad(self):
        """Set every gradient that exists to zero, in place."""
        for p in self.parameters():
            if p.grad is not None:
                p.grad.zero_()


def _tensors(obj):
    """The tensors of a nest of tuples, lists and dicts, in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from _tensors(obj[k])


def _map(fn, obj):
    """``obj`` with ``fn`` applied to each tensor of the nest."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(fn, o) for o in obj)
    if isinstance(obj, dict):
        return {k: _map(fn, v) for k, v in obj.items()}
    return obj


def _key(obj):
    """Hashable signature of an argument nest: each tensor by shape,
    strides, dtype and device, anything else by value."""
    if isinstance(obj, torch.Tensor):
        return ("t", tuple(obj.shape), obj.stride(), obj.dtype, obj.device)
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(_key(o) for o in obj)
    if isinstance(obj, dict):
        return ("d",) + tuple((k, _key(obj[k])) for k in sorted(obj))
    return ("v", obj)


class _CachedGraph:
    """One captured CUDA graph of a HybridBlock's forward: the counterpart
    of the JAX package's ``_CachedGraph`` (block.py:332), one per input
    signature and training flag.  ``inputs`` are the static buffers the
    graph reads, ``out`` the static output it writes, ``ptrs`` the
    storage of every parameter at capture."""

    def __init__(self, graph, inputs, out, ptrs, launches):
        self.graph, self.inputs, self.out, self.ptrs = graph, inputs, out, ptrs
        self.launches = launches    # kernel launches per replay


class HybridBlock(Block):
    """A Block that ``hybridize()`` runs as captured CUDA graphs.

    The port's counterpart of the JAX package's per-signature ``jax.jit``
    (block.py:404-494) is a CUDA graph per signature: the shapes, strides,
    dtypes and device of the tensor arguments, every other argument's
    value, and the training flag.  The first call with a signature runs
    eagerly (materialising deferred parameters; its result is returned),
    warms up on a side stream and captures the forward; later calls copy
    their tensors into the graph's static inputs, replay it and return a
    clone of its output, so a result stays valid after the next call.

    A graph is used wherever autograd is not recording, that is outside
    any ``autograd.record()`` (MXNet's default) or inside an
    ``autograd.pause()``; capture and replay run under
    ``torch.no_grad()``, so the result carries no autograd history.
    Under ``record()`` the block runs eagerly, because torch autograd is
    the port's tape and its backward is torch's.  On the CPU, which the
    caller asked for by name, the block always runs eagerly: CUDA graphs
    are CUDA-only.

    In training mode (``autograd.train_mode()``) a BatchNorm's running
    statistics are updated in place inside the graph, once per replay,
    as eagerly; warm-up and capture leave them as the first call left
    them.  A parameter whose storage is replaced (``p.data = ...``,
    ``cast``) invalidates the graphs that read it; ``load_params`` and
    the optimizers write in place, which the graphs read.  Only the
    outermost hybridized block captures; its children run inside it.
    """

    def __init__(self):
        super().__init__()
        self._active = False
        self._graphs = {}

    def hybridize(self, active=True, **kwargs):
        """Run this block as captured CUDA graphs (``active``) or eagerly;
        either way the cached graphs are dropped.  Static allocation and
        shapes are what a CUDA graph is, so ``static_alloc`` /
        ``static_shape`` are accepted and change nothing."""
        self._active = active
        self._graphs.clear()
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(False)

    def reset_cache(self):
        self._graphs.clear()

    def __call__(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _nd_call(self.__call__, args, kwargs)
        if self._active and not autograd.is_recording():
            tensors = list(_tensors((args, kwargs)))
            if tensors and all(t.is_cuda for t in tensors):
                with torch.no_grad():
                    return self._call_cached(args, kwargs)
        return nn.Module.__call__(self, *args, **kwargs)

    def _call_cached(self, args, kwargs):
        sig = (autograd.is_training(), _key(args), _key(kwargs))
        g = self._graphs.get(sig)
        if g is not None and g.ptrs != [p.data_ptr()
                                        for p in self.parameters()]:
            g = None                # a parameter's storage was replaced
        if g is None:
            out, self._graphs[sig] = self._capture(args, kwargs)
            return out
        for buf, t in zip(g.inputs, _tensors((args, kwargs))):
            buf.copy_(t)
        cuda_ops.replay_graph(g.graph, g.launches)
        return _map(torch.clone, g.out)

    def _capture(self, args, kwargs):
        out = super().__call__(*args, **kwargs)      # materialises params
        aux = [p for p in self.parameters() if not p.requires_grad] \
            if autograd.is_training() else []
        saved = [p.detach().clone() for p in aux]
        s_args, s_kwargs = _map(torch.clone, (args, kwargs))
        graph, s_out, launches = cuda_ops.capture_graph(
            functools.partial(super().__call__, *s_args, **s_kwargs))
        for p, v in zip(aux, saved):
            p.detach().copy_(v)
        return out, _CachedGraph(graph, list(_tensors((s_args, s_kwargs))),
                                 s_out, [p.data_ptr()
                                         for p in self.parameters()],
                                 launches)
