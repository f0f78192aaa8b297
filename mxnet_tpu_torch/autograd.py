"""``autograd`` scopes over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py:18-110`` (``record``, ``pause``,
``train_mode``, ``predict_mode``, ``backward``, ``grad``).  The port
keeps no tape of its own: torch autograd is the tape, and
``backward`` / ``grad`` call ``torch.autograd``.  A custom
differentiable function is MXNet's :class:`Function` (:113): its
``forward`` and ``backward`` run on NDArrays (or tensors, as given),
bridged onto torch autograd by a ``torch.autograd.Function``.

The recording state is MXNet's: off by default, on inside ``record()``
and off again inside a ``pause()``.  The scopes set torch's grad mode
with it (``record`` on, ``pause`` off) and restore both on exit, so
outside any scope torch's grad mode stays torch's own default and plain
torch code is unaffected.  A hybridized block reads the recording
state: it replays a captured graph wherever no ``record()`` is active.

The training flag (``is_training``, set by ``record``, ``train_mode``
and their opposites) is the port's one train/eval state: ``Dropout``
and ``BatchNorm`` read it, as the JAX package's layers do, and the port
never reads torch's ``Module.training``.

MXNet's ``loss.backward()`` on a non-scalar loss seeds every element
with 1; torch's ``Tensor.backward`` takes only a scalar, so a per-sample
loss goes through :func:`backward` here, which seeds with ones.

The imperative surface (``mxnet_tpu/_tape.py``) maps onto the same tape:
:func:`mark_variables` (``NDArray.attach_grad``) makes an array a leaf
with a zero gradient buffer; :func:`backward` and :func:`grad` take
NDArrays as well as tensors.  A variable's ``grad_req`` is MXNet's:
``"add"`` is torch's accumulation; ``"write"`` zeroes the buffer, in
place, as each backward reaches the variable, so the buffer holds that
backward's gradient and every handle on it stays valid.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "is_recording", "is_training", "set_recording",
           "set_training", "mark_variables", "Function"]

_state = threading.local()


def is_recording():
    return getattr(_state, "recording", False)


def is_training():
    return getattr(_state, "training", False)


def set_recording(is_recording):  # noqa: A002
    """Set the recording state and torch's grad mode with it; returns
    the previous recording state."""
    prev = getattr(_state, "recording", False)
    _state.recording = bool(is_recording)
    torch.set_grad_enabled(bool(is_recording))
    return prev


def set_training(train_mode):
    """Set the training flag; returns the previous value."""
    prev = is_training()
    _state.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = (is_recording(), torch.is_grad_enabled())
            set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            _state.recording = self._prev_is_record[0]
            torch.set_grad_enabled(self._prev_is_record[1])
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope: record operations for backward (grad mode on)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    """Scope: stop recording (grad mode off)."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _tensor(x):
    from .ndarray.ndarray import NDArray
    return x._data if isinstance(x, NDArray) else x


def _seeded(heads, head_grads):
    if not isinstance(heads, (list, tuple)):
        heads = [heads]
        head_grads = None if head_grads is None else [head_grads]
    heads = [_tensor(h) for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = [torch.ones_like(h) if g is None else _tensor(g)
                  for h, g in zip(heads, head_grads)]
    return heads, head_grads


def _write_hook(leaf):
    """Zero ``leaf``'s gradient buffer before a backward adds into it."""
    def hook(g):
        if leaf.grad is not None:
            leaf.grad.zero_()
        return g
    return hook


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf of the tape (a detached
    alias of its storage), with ``gradients`` (NDArrays) as its buffers or
    zero ones, and ``grad_reqs`` (``"write"``, ``"add"`` or ``"null"``,
    one or one each)."""
    from .ndarray.ndarray import NDArray
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    if gradients is None:
        gradients = [None] * len(variables)
    for var, buf, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write/add/null, got %r"
                             % (req,))
        leaf = var._data.detach().requires_grad_(req != "null")
        if req != "null":
            leaf.grad = torch.zeros_like(leaf) if buf is None \
                else _tensor(buf)
            if req == "write":
                leaf.register_hook(_write_hook(leaf))
        if isinstance(var, NDArray):
            var._data = leaf


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (tensors or NDArrays) into the ``.grad`` of
    every leaf that requires one; a head without a head gradient is
    seeded with ones."""
    heads, head_grads = _seeded(heads, head_grads)
    torch.autograd.backward(heads, head_grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned
    (not accumulated); one for a single variable.  NDArray variables get
    NDArray gradients.  ``train_mode`` is accepted, as ``backward``'s is:
    torch's backward replays the graph recorded, in the mode it was
    recorded in."""
    from .ndarray.ndarray import NDArray
    heads, head_grads = _seeded(heads, head_grads)
    single = not isinstance(variables, (list, tuple))
    variables = [variables] if single else list(variables)
    res = torch.autograd.grad(heads, [_tensor(v) for v in variables],
                              head_grads, retain_graph=retain_graph,
                              create_graph=create_graph)
    res = [NDArray(g) if isinstance(v, NDArray) else g
           for v, g in zip(variables, res)]
    return res[0] if single else res


class Function:
    """A differentiable function with a hand-written backward (reference
    ``autograd.Function``).  Subclass it and define ``forward`` and
    ``backward``::

        class sigmoid(Function):
            def forward(self, x):
                y = 1 / (1 + mx.np.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

    ``forward`` runs under ``pause`` with the training flag kept, and
    returns one array or a tuple; ``backward`` takes one gradient per
    output and returns one per input.  Both see NDArrays where the call
    was given NDArrays, else tensors.  Inside ``record()`` the call is
    one node of torch's tape whose backward is ``backward`` (under
    ``pause`` too); outside it only ``forward`` runs."""

    def __init__(self):
        self.saved_tensors = ()

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        nd = any(isinstance(x, NDArray) for x in inputs)
        if not is_recording():
            with pause(train_mode=is_training()):
                return self.forward(*inputs)
        outs = _FunctionNode.apply(self, nd, *(_tensor(x) for x in inputs))
        if not nd:
            return outs
        return NDArray(outs) if isinstance(outs, torch.Tensor) else \
            tuple(NDArray(o) for o in outs)


def _as(nd, tensors):
    from .ndarray.ndarray import NDArray
    return [NDArray(t) if nd and isinstance(t, torch.Tensor) else t
            for t in tensors]


class _FunctionNode(torch.autograd.Function):
    """A :class:`Function` call on torch's tape."""

    @staticmethod
    def forward(ctx, func, nd, *tensors):
        ctx.func, ctx.nd, ctx.training = func, nd, is_training()
        with pause(train_mode=ctx.training):
            out = func.forward(*_as(nd, tensors))
        ctx.single = not isinstance(out, (tuple, list))
        outs = [_tensor(o) for o in ([out] if ctx.single else out)]
        return outs[0] if ctx.single else tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        with pause(train_mode=ctx.training):
            res = ctx.func.backward(*_as(ctx.nd, grads))
        res = [res] if not isinstance(res, (tuple, list)) else res
        return (None, None) + tuple(_tensor(g) for g in res)
