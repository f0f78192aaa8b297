"""Device contexts of the PyTorch/CUDA port.

Counterpart of ``mxnet_tpu/context.py:46-169``: ``Context`` with
``cpu()`` / ``gpu()`` and ``with ctx:`` scopes, mapped to
``torch.device``.  The port runs on an NVIDIA GPU, so the default
context is ``gpu(0)``: every entry point takes ``device=None``, which
means the current context, and outside any scope that is CUDA -- without
a card that raises, and the port never carries on quietly on the CPU.
The CPU is used only when a caller asks for it by name: ``device="cpu"``,
or a ``with mx.cpu():`` scope, as the tests do.  ``tpu()`` raises: the
port's accelerator is the GPU.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "Device", "cpu", "gpu", "tpu", "cpu_pinned", "device",
           "current_context", "current_device", "num_gpus",
           "resolve_device"]

_NO_CARD = ("mxnet_tpu_torch needs a CUDA device (none is available); "
            "pass device='cpu', or run under `with mx.cpu():`, for the "
            "plain PyTorch path on the CPU")


class Context:
    """A device context: ``Context("gpu", 0)``, ``Context("cpu")``.

    ``device_type`` is ``"cpu"`` (also ``"cpu_pinned"`` /
    ``"cpu_shared"``, which are the CPU here) or ``"gpu"``; ``torch_device``
    is the ``torch.device`` it names.  As a ``with`` scope it sets the
    current context of this thread."""

    _default = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, \
                device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = (
                "gpu" if device_type.type == "cuda" else device_type.type,
                device_type.index or 0)
        if device_type == "tpu":
            raise ValueError("mxnet_tpu_torch runs on a CUDA GPU, not a TPU: "
                             "use mx.gpu()")
        if device_type not in ("cpu", "gpu", "cpu_pinned", "cpu_shared"):
            raise ValueError("unknown device type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self):
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    @property
    def index(self):
        return self.device_id

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return isinstance(other, Context) and \
            self.device_type == other.device_type and \
            self.device_id == other.device_id

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __repr__(self):
        return "Context(%s)" % self

    def __enter__(self):
        stack = Context._default.__dict__.setdefault("stack", [])
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()

    def empty_cache(self):
        """Release the card's cached allocator blocks."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            torch.cuda.empty_cache()


Device = Context


def cpu(device_id=0):
    return Context("cpu", device_id)


def cpu_pinned(device_id=0):
    return Context("cpu_pinned", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Raises: the port's accelerator is the GPU (``mx.gpu()``)."""
    return Context("tpu", device_id)


def device(dev_type, device_id=0):
    return Context(dev_type, device_id)


def num_gpus():
    return torch.cuda.device_count()


def current_context():
    """The innermost ``with ctx:`` scope of this thread, else ``gpu(0)``."""
    stack = getattr(Context._default, "stack", None)
    return stack[-1] if stack else Context("gpu", 0)


current_device = current_context


def resolve_device(device=None):
    """The ``torch.device`` an entry point runs on.  ``None`` is the
    current context (CUDA outside any scope), raising ``RuntimeError``
    when that is CUDA and no card is present; any other value is taken
    as asked (``"cpu"``, ``"cuda:1"``, a ``torch.device``, a
    ``Context``)."""
    if device is None:
        device = current_context()
    dev = device.torch_device if isinstance(device, Context) \
        else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD)
    return dev
