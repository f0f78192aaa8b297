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

Forward hooks are MXNet's (reference :155-164, :293-297, :495-500):
``register_forward_pre_hook(hook)`` runs ``hook(block, args)`` before
the forward and ``register_forward_hook(hook)`` runs ``hook(block, args,
out)`` after it, ``args`` as the caller passed them (NDArrays stay
NDArrays); each returns a handle whose ``detach()`` (or ``remove()``)
removes the hook.  They replace torch's own hooks of the same names on
these blocks (a hook's return value is ignored, as in MXNet).  A
hybridized block runs its hooks on the host around the graph replay; the
hooks of the blocks inside a captured graph run when it is captured,
not at each replay, as the reference's run when its graph is traced.

Parameter files are the reference's (:166-274): ``save_parameters``
writes the npz of ``utils.serialization`` (bf16 tagged, so a file
crosses between the packages both ways) and refreshes a sibling
``<stem>.manifest.json`` (``fault.write_manifest``'s) where one lists
the file; ``load_parameters`` verifies that manifest before anything
is read, then ``load_dict`` checks every name and shape before any
parameter is written.  ``HybridBlock.export`` (:505-560) writes the
same parameter file and, where the reference writes a StableHLO
program, a ``torch.export`` program that takes the parameters as
inputs (``-symbol.pt2``), which ``SymbolBlock.imports`` runs without
the model's Python code.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import re
from collections import OrderedDict

import torch
from torch import nn

from .. import autograd
from .. import initializer as init_mod
from ..context import resolve_device
from ..ndarray.ndarray import NDArray
from ..ops import cuda_ops
from ..utils import serialization
from . import parameter as param_mod

__all__ = ["Block", "HybridBlock"]

#: the member of an exported program that holds its header
SYMBOL_HEADER = "mxnet_header.json"


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


class _HookHandle:
    """A hook registered in ``hooks``; ``detach()`` (or torch's
    spelling, ``remove()``) removes it."""

    _ids = itertools.count()

    def __init__(self, hooks, hook):
        self._hooks, self._id = hooks, next(self._ids)
        hooks[self._id] = hook

    def detach(self):
        self._hooks.pop(self._id, None)

    remove = detach


class Block(nn.Module):

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fwd = cls.__dict__.get("forward")
        if fwd is not None and not getattr(fwd, "_mx_nd", False):
            cls.forward = _nd_forward(fwd)

    def __call__(self, *args, **kwargs):
        hooks = self.__dict__.get("_mx_hooks")
        if not hooks or not (hooks[0] or hooks[1]):
            return self._mx_call(*args, **kwargs)
        for hook in list(hooks[0].values()):
            hook(self, args)
        out = self._mx_call(*args, **kwargs)
        for hook in list(hooks[1].values()):
            hook(self, args, out)
        return out

    def _mx_call(self, *args, **kwargs):
        """The call without the hooks."""
        if _has_nd(args, kwargs):
            return _nd_call(self._mx_call, args, kwargs)
        return nn.Module.__call__(self, *args, **kwargs)

    def _hook_table(self, kind):
        """The pre-hooks (0) or the hooks (1), in registration order."""
        return self.__dict__.setdefault(
            "_mx_hooks", (OrderedDict(), OrderedDict()))[kind]

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, args)`` before each forward; returns a
        handle whose ``detach()`` removes it."""
        return _HookHandle(self._hook_table(0), hook)

    def register_forward_hook(self, hook):
        """Run ``hook(block, args, out)`` after each forward; returns a
        handle whose ``detach()`` removes it."""
        return _HookHandle(self._hook_table(1), hook)

    def _param_items(self):
        """(name, parameter) under every name, a shared one under each."""
        return self.named_parameters(remove_duplicate=False)

    def collect_params(self, select=None):
        """Ordered ``{name: Parameter}``; ``select`` is a regular
        expression matched at the start of each name."""
        pattern = re.compile(select) if select else None
        out, seen = OrderedDict(), set()
        for name, p in self._param_items():
            if id(p) not in seen and (pattern is None or pattern.match(name)):
                out[name] = p
            seen.add(id(p))
        return out

    def initialize(self, init=None, device=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter on ``device`` (``ctx`` is its MXNet
        alias; ``None`` = the current context: CUDA outside any scope,
        raising without a card) with its own initializer, else ``init``
        (default ``Uniform(0.07)``), drawing from ``generator`` (default:
        ``mx.np.random``'s generator for the device).  A parameter with
        an unknown dimension is filled at the block's first forward.
        ``verbose`` is accepted, as the reference's is.  Returns the
        block."""
        if init is None or isinstance(init, str):
            init = init_mod.create(init or "uniform")
        device = resolve_device(device if device is not None else ctx)
        if generator is None:
            from ..numpy import random as np_random
            generator = np_random.generator(device)
        for name, p in self.collect_params().items():
            param_mod.initialize(p, name, init, device, generator,
                                 force_reinit)
        return self

    def __setattr__(self, name, value):
        if isinstance(value, param_mod.Parameter) and \
                param_mod._spec(value).name is None:
            param_mod._spec(value).name = name
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        """Hold ``block`` as a child under ``name`` (default: the number
        of children so far)."""
        self.add_module(name or str(len(self._modules)), block)

    @property
    def params(self):
        """This block's own parameters (not its children's), by name."""
        return OrderedDict((k, p) for k, p in self._parameters.items()
                           if p is not None)

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx`` (its gradient dropped); a
        deferred one will be made there.  The captured graphs are
        dropped."""
        dev = torch.empty(0, device=resolve_device(ctx)).device
        with torch.no_grad():
            for p in self.parameters():
                spec = param_mod._spec(p)
                if param_mod.is_deferred(p):
                    if spec.deferred is not None:
                        spec.deferred = spec.deferred[:2] + (dev,) + \
                            spec.deferred[3:]
                elif p.device != dev:
                    p.grad = None
                    p.data = p.data.to(dev)
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m.reset_cache()

    reset_device = reset_ctx

    def summary(self, *inputs):
        """Print each parameter's name, shape and size, and the total (the
        reference's table; ``inputs`` are accepted and not run)."""
        lines = ["-" * 64,
                 "%-28s %-24s %s" % ("Layer", "Param shape", "#Params"),
                 "=" * 64]
        total = 0
        for name, p in self.collect_params().items():
            shape = param_mod._spec(p).shape if param_mod.is_deferred(p) \
                else tuple(p.shape)
            n = 1
            for d in (shape or ()):
                n *= max(d, 0)
            total += n
            lines.append("%-28s %-24s %d" % (name, str(shape), n))
        lines.append("=" * 64)
        lines.append("Total params: %d" % total)
        print("\n".join(lines))

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
            g = param_mod.grad_of(p)
            if g is not None:
                g.zero_()

    # -- parameter files (reference :166-274) ------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter that holds values to ``filename`` (the
        npz of ``utils.serialization``) under its ``collect_params``
        name; a parameter shared under several names is written under
        each, or with ``deduplicate`` under its first only.  A sharded
        parameter is written whole (every rank of its mesh calls this).
        A ``<stem>.manifest.json`` that lists the file gets its new
        checksum."""
        from ..parallel import sharding as _sharding
        arrays, seen = {}, set()
        for name, p in self._param_items():
            if param_mod.is_deferred(p) or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            t = p.detach()
            sh = _sharding.placement(p)
            if sh is not None:
                t = _sharding.gather_global(t, sh.spec, sh.mesh)
            arrays[name] = t
        serialization.savez(filename, **arrays)
        _refresh_manifest(filename)

    def load_parameters(self, filename, device=None, ctx=None,
                        allow_missing=False, ignore_extra=False,
                        cast_dtype=False, dtype_source="current"):
        """Read the parameters ``save_parameters`` wrote (the reference's
        files too) into this block; see :meth:`load_dict` for the
        options.  A ``<stem>.manifest.json`` beside the file is verified
        first: a torn or stale file raises
        ``fault.CorruptCheckpointError`` with the block untouched."""
        if isinstance(filename, (str, os.PathLike)):
            filename = os.fspath(filename)
            manifest = _manifest_of(filename)
            if os.path.exists(manifest):
                from .. import fault
                ok, bad = fault.verify_manifest(
                    manifest, only=[os.path.basename(filename)])
                if not ok:
                    raise fault.CorruptCheckpointError(
                        "checkpoint %s failed manifest verification: %s"
                        % (filename, ", ".join(bad)))
        loaded = serialization.load(filename, device="cpu")
        if isinstance(loaded, (list, NDArray)):
            raise ValueError("parameter file %s has no names" % (filename,))
        self._load(loaded, device if device is not None else ctx,
                   allow_missing, ignore_extra, cast_dtype, dtype_source,
                   "file %s" % (filename,))

    def load_dict(self, param_dict, device=None, allow_missing=False,
                  ignore_extra=False, cast_dtype=False,
                  dtype_source="current"):
        """Set the parameters from ``{name: array}`` (NDArrays, tensors or
        numpy arrays).  Every name and shape is checked before any value
        is written: a parameter with no value raises ``AssertionError``
        unless ``allow_missing`` (a parameter shared under several names
        needs one of them), a value no parameter takes raises
        ``AssertionError`` unless ``ignore_extra``, and a shape that
        does not fit raises ``ValueError``.  A value is cast to the
        parameter's dtype, or with ``cast_dtype`` and ``dtype_source=
        "saved"`` the parameter takes the value's.  ``device`` places the
        parameters (None: where they are; a deferred one on the device
        ``initialize`` named, else the current context), and a deferred
        parameter takes the value's shape.  The block's captured graphs
        are dropped."""
        self._load(param_dict, device, allow_missing, ignore_extra,
                   cast_dtype, dtype_source, "param_dict")

    def _load(self, loaded, device, allow_missing, ignore_extra, cast_dtype,
              dtype_source, where):
        named = list(self._param_items())
        names = {}
        for name, p in named:
            names.setdefault(id(p), []).append(name)
        if not allow_missing:
            for name, p in named:
                if not any(n in loaded for n in names[id(p)]):
                    raise AssertionError("Parameter %s is missing in %s"
                                         % (name, where))
        own = dict(named)
        if not ignore_extra:
            for name in loaded:
                if name not in own:
                    raise AssertionError(
                        "Parameter %s loaded from %s is not present in this "
                        "block" % (name, where))
        values = {}
        for name, p in named:
            if name not in loaded or id(p) in values:
                continue
            v = loaded[name]
            t = v._data if isinstance(v, NDArray) else torch.as_tensor(
                v.astype("float32") if getattr(v, "dtype", None) is not None
                and v.dtype.name == "bfloat16" else v)
            want = param_mod._spec(p).shape if param_mod.is_deferred(p) \
                else param_mod.global_shape(p)
            if want is not None and (len(want) != t.dim() or any(
                    w not in (0, d) for w, d in zip(want, t.shape))):
                raise ValueError("Parameter %s has shape %s in %s; the block "
                                 "wants %s" % (name, tuple(t.shape), where,
                                               tuple(want)))
            values[id(p)] = (p, t)
        # a tensor's device names its index ("cuda:0"), as p.device does
        dev = None if device is None else torch.empty(
            0, device=resolve_device(device)).device
        with torch.no_grad():
            for p, t in values.values():
                _load_one(p, t, dev, cast_dtype and dtype_source == "saved")
        for m in self.modules():
            if isinstance(m, HybridBlock):
                m.reset_cache()


def _manifest_of(filename):
    stem = filename[:-len(".params")] if filename.endswith(".params") \
        else filename
    return stem + ".manifest.json"


def _refresh_manifest(filename):
    """Give a sibling manifest that lists ``filename`` its new checksum,
    so a verified load still takes the file; an unreadable manifest is
    removed rather than left to refuse the new file for ever."""
    if not isinstance(filename, (str, os.PathLike)):
        return
    filename = os.fspath(filename)
    manifest = _manifest_of(filename)
    if not os.path.exists(manifest):
        return
    from .. import fault
    try:
        with open(manifest, "rb") as f:
            data = json.loads(f.read().decode())
        entries = data["files"]
    except (OSError, ValueError, KeyError, UnicodeDecodeError):
        os.remove(manifest)
        return
    rel = os.path.relpath(os.path.abspath(filename),
                          os.path.dirname(os.path.abspath(manifest)))
    if rel in entries:
        entries[rel] = {"sha256": fault.file_sha256(filename),
                        "bytes": os.path.getsize(filename)}
        fault._atomic_write_bytes(manifest, json.dumps(data, indent=1)
                                  .encode())


def _load_one(p, t, device, take_dtype):
    """Write ``t`` into ``p``: in place where ``p`` stays on its device
    and in its dtype, else as new storage (a deferred ``p`` is made with
    ``t``'s shape)."""
    from ..parallel import sharding as _sharding
    spec = param_mod._spec(p)
    if take_dtype:
        spec.dtype = t.dtype
    if param_mod.is_deferred(p):
        if spec.deferred is not None and device is None:
            device = spec.deferred[2]
        spec.shape, spec.deferred = tuple(t.shape), None
        p.materialize(spec.shape, device=resolve_device(device),
                      dtype=spec.dtype)
    sh = _sharding.placement(p)
    if sh is not None:
        t = _sharding.local_block(t, sh.spec, sh.mesh)
    device = p.device if device is None else device
    if p.device == device and p.dtype == spec.dtype:
        p.copy_(t)
    else:
        p.grad = None
        p.data = t.to(device=device, dtype=spec.dtype, copy=True)
    param_mod.mark_initialized(p)


@contextlib.contextmanager
def _eager(block):
    """Every HybridBlock of ``block`` runs eagerly inside: no graph is
    captured or replayed."""
    active = [(m, m._active) for m in block.modules()
              if isinstance(m, HybridBlock)]
    for m, _ in active:
        m._active = False
    try:
        yield
    finally:
        for m, a in active:
            m._active = a


class _Deploy(nn.Module):
    """The forward ``export`` traces: the parameters are inputs (a list
    in ``names`` order), so the program holds none of them; the net's
    buffers (a quantized layer's int8 weight) are its constants."""

    def __init__(self, net, names):
        super().__init__()
        object.__setattr__(self, "net", net)    # not a submodule
        self.names = names

    def forward(self, params, *inputs):
        return torch.func.functional_call(
            self.net, dict(zip(self.names, params)), inputs)


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

    def optimize_for(self, x, *args, backend=None, clear=True, **kwargs):
        """``hybridize()`` and one call on ``(x, *args)``, whose output it
        returns: on CUDA that call captures the graph.  The port has no
        partitioning backends: ``backend`` must be None."""
        if backend is not None:
            raise ValueError("mxnet_tpu_torch has no partitioning backend "
                             "%r: CUDA graphs are its one" % (backend,))
        self.hybridize(True, **kwargs)
        return self(x, *args)

    def infer_shape(self, *args):
        """Give every deferred parameter its shape: one forward on
        ``args`` under ``pause``, with no gradient and no graph
        captured."""
        with autograd.pause(), torch.no_grad(), _eager(self):
            nn.Module.__call__(self, *_unwrap(args))

    def export(self, path, epoch=0, remove_amp_cast=True,
               example_inputs=None):
        """Write ``path-%04d.params`` (as ``save_parameters``) and
        ``path-symbol.pt2``, a ``torch.export`` program of the inference
        forward on ``example_inputs`` (a tuple, or one input) that takes
        the parameters as inputs, with the header ``{"param_names":
        [...]}``; returns ``(sym_file, param_file)``.
        ``SymbolBlock.imports`` runs it on any device.  The program
        keeps the example inputs' shapes.  A forward that reaches a
        kernel with no ``torch.library`` op (the flash forward,
        ``paged_decode``, ``int8_linear``, ``int8_dequant``) raises
        ``NotImplementedError`` before any file is written;
        post-training quantization's K2 / K3
        are the ops ``mxnet_tpu_torch::int8_quantize``,
        ``::int8_quantize_im2col`` and ``::int8_conv``."""
        if example_inputs is None:
            raise ValueError(
                "export requires example_inputs=(x, ...) to trace the "
                "deployment graph (pass the inputs you called the block "
                "with)")
        if not isinstance(example_inputs, (list, tuple)):
            example_inputs = (example_inputs,)
        inputs = tuple(_unwrap(list(example_inputs)))
        if any(param_mod.is_deferred(p) for p in self.parameters()):
            self.infer_shape(*inputs)
        params = self.collect_params()
        names = list(params)
        with autograd.pause(), torch.no_grad(), _eager(self):
            program = torch.export.export(
                _Deploy(self, names),
                ([p.detach() for p in params.values()],) + inputs,
                strict=False)
        param_file = "%s-%04d.params" % (path, epoch)
        self.save_parameters(param_file)
        sym_file = "%s-symbol.pt2" % path
        with serialization.atomic_write(sym_file) as f:
            torch.export.save(program, f, extra_files={
                SYMBOL_HEADER: json.dumps({"param_names": names})})
        return sym_file, param_file

    def _mx_call(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return _nd_call(self._mx_call, args, kwargs)
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
        out = nn.Module.__call__(self, *args, **kwargs)   # materialises
        aux = [p for p in self.parameters() if not p.requires_grad] \
            if autograd.is_training() else []
        saved = [p.detach().clone() for p in aux]
        s_args, s_kwargs = _map(torch.clone, (args, kwargs))
        graph, s_out, launches = cuda_ops.capture_graph(
            functools.partial(nn.Module.__call__, self, *s_args,
                              **s_kwargs))
        for p, v in zip(aux, saved):
            p.detach().copy_(v)
        return out, _CachedGraph(graph, list(_tensors((s_args, s_kwargs))),
                                 s_out, [p.data_ptr()
                                         for p in self.parameters()],
                                 launches)
