"""mxnet_tpu_torch -- the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with its module layout and names:
``context``, ``ops`` (plain PyTorch ops and the hand-written CUDA
attention kernels under ``csrc/``), ``autograd`` (record/pause scopes
over torch autograd), ``initializer`` (also ``init``), ``gluon``
(``Block`` / ``HybridBlock``, ``Parameter``, ``nn`` layers, the vision
``model_zoo``, ``loss``, ``Trainer``), ``optimizer``, ``lr_scheduler``,
``parallel`` (``TrainStep``), ``models`` (the Llama-class
``TransformerLM`` and its paged KV cache, BERT), ``serve`` (the
continuous-batching server) and ``convert`` (weights to and from the
JAX package, as numpy).  It
imports ``torch`` and never ``jax`` or ``mxnet_tpu``.

Device rule: entry points take ``device=None``, meaning CUDA, and raise
``RuntimeError`` when no card is present; the CPU runs only when asked
for by name (``device="cpu"``), and then every kernel runs its plain
PyTorch version.
"""
from __future__ import annotations

from . import (autograd, context, convert, gluon,  # noqa: F401
               initializer, lr_scheduler, models, ops, optimizer, parallel,
               serve)
from .context import resolve_device  # noqa: F401

init = initializer

__version__ = "2.0.0.torch0"
