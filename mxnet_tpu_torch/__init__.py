"""mxnet_tpu_torch -- the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with its module layout and names:
``context``, ``ops`` (plain PyTorch ops and the hand-written CUDA
attention kernels under ``csrc/``), ``autograd`` (record/pause scopes
over torch autograd), ``initializer`` (also ``init``), ``gluon``
(``Block`` / ``HybridBlock`` with parameter files and ``export``,
``SymbolBlock``, ``Parameter``, ``nn`` layers, the vision ``model_zoo``'s
34 nets, ``loss``, ``Trainer``, ``utils``), ``optimizer``,
``lr_scheduler``, ``kvstore`` (also ``kv``), ``parallel`` (meshes of
ranks, parameter sharding, ``TrainStep``, the pipeline, ring attention,
the MoE), ``models`` (the Llama-class
``TransformerLM`` and its paged KV cache, BERT), ``serve`` (the
continuous-batching server, tensor-parallel over a mesh) and
``convert`` (weights to and from the JAX package, as numpy); the control
plane ``profiler``, ``telemetry``, ``flightrec`` and ``fault``,
``amp`` (mixed precision with dynamic loss scaling) and the data
pipeline (``io``, ``recordio``, ``image``, ``metric``), loaded on first
use, as the JAX package's lazy table loads them (``serve_router``
is imported as ``mxnet_tpu_torch.serve_router``, as there); and the
imperative MXNet surface: ``nd``
(``NDArray``), ``np`` (with ``np.random``), ``npx``, ``engine`` and the
contexts ``cpu()`` / ``gpu()``.  ``import mxnet_tpu_torch as mx`` reads
like the JAX package.  It imports ``torch`` and never ``jax`` or
``mxnet_tpu``.

Device rule: entry points take ``device=None``, meaning the current
context -- CUDA outside any scope, raising ``RuntimeError`` when no card
is present; the CPU runs only when asked for by name (``device="cpu"``
or ``with mx.cpu():``), and then every kernel runs its plain PyTorch
version.
"""
from __future__ import annotations

from . import (autograd, context, convert, engine, gluon,  # noqa: F401
               initializer, kvstore, lr_scheduler, models, ndarray, numpy,
               numpy_extension, ops, optimizer, parallel, serve)
from .context import (Context, Device, cpu, current_context,  # noqa: F401
                      current_device, gpu, num_gpus, resolve_device, tpu)
from .ndarray import NDArray, waitall  # noqa: F401

init = initializer
kv = kvstore
nd = ndarray
np = numpy
npx = numpy_extension
random = numpy.random

__version__ = "2.0.0.torch0"

#: the control-plane modules, ``amp``, ``monitor`` (also ``mon``),
#: ``analysis`` and the data pipeline (``io``, ``recordio``, ``image``,
#: ``metric``), loaded on first attribute access
_LAZY = {"profiler": ".profiler", "telemetry": ".telemetry",
         "flightrec": ".flightrec", "fault": ".fault", "amp": ".amp",
         "monitor": ".monitor", "mon": ".monitor",
         "analysis": ".analysis", "io": ".io", "recordio": ".recordio",
         "image": ".image", "metric": ".gluon.metric"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
