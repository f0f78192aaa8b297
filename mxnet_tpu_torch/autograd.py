"""``autograd`` scopes over torch autograd.

Counterpart of ``mxnet_tpu/autograd.py:18-110`` (``record``, ``pause``,
``train_mode``, ``predict_mode``, ``backward``, ``grad``).  The port
keeps no tape of its own: ``record`` turns torch's grad mode on and sets
the training flag, ``pause`` turns grad mode off, and ``backward`` /
``grad`` call ``torch.autograd``.  A custom differentiable function is
a ``torch.autograd.Function``, the port's idiom for what
``autograd.Function`` (:113) does in the JAX package.

The training flag (``is_training``, set by ``record``, ``train_mode``
and their opposites) is kept for the MXNet API: a layer that acts
differently in training reads it, as the JAX package's layers do.  No
layer of the port does yet (there is no dropout or batch norm on the
ported paths), and the port never reads torch's ``Module.training``, so
this flag is the one train/eval state.

MXNet's ``loss.backward()`` on a non-scalar loss seeds every element
with 1; torch's ``Tensor.backward`` takes only a scalar, so a per-sample
loss goes through :func:`backward` here, which seeds with ones.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "backward",
           "grad", "is_recording", "is_training", "set_recording",
           "set_training"]

_state = threading.local()


def is_recording():
    return torch.is_grad_enabled()


def is_training():
    return getattr(_state, "training", False)


def set_recording(is_recording):  # noqa: A002
    """Set grad mode; returns the previous value."""
    prev = torch.is_grad_enabled()
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
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
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


def _seeded(heads, head_grads):
    if isinstance(heads, torch.Tensor):
        heads = [heads]
        head_grads = None if head_grads is None else [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    head_grads = [torch.ones_like(h) if g is None else g
                  for h, g in zip(heads, head_grads)]
    return heads, head_grads


def backward(heads, head_grads=None, retain_graph=False):
    """Gradients of ``heads`` into the ``.grad`` of every leaf that
    requires one; a head without a head gradient is seeded with ones."""
    heads, head_grads = _seeded(heads, head_grads)
    torch.autograd.backward(heads, head_grads, retain_graph=retain_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False):
    """Gradients of ``heads`` with respect to ``variables``, returned
    (not accumulated); one tensor for a single variable."""
    heads, head_grads = _seeded(heads, head_grads)
    single = isinstance(variables, torch.Tensor)
    res = torch.autograd.grad(heads, [variables] if single else
                              list(variables), head_grads,
                              retain_graph=retain_graph,
                              create_graph=create_graph)
    return res[0] if single else list(res)
