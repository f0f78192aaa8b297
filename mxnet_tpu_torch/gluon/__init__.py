"""Gluon of the port: ``Block`` / ``HybridBlock``, ``SymbolBlock``,
``Parameter``, layers (``nn``), the vision model zoo, losses, the
``Trainer`` and ``utils``; ``data`` and ``metric`` load on first
access, as the reference's ``gluon/__init__.py:11-17`` loads them."""
from . import loss, model_zoo, nn, parameter, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .loss import (CosineEmbeddingLoss, HingeLoss, HuberLoss,  # noqa: F401
                   KLDivLoss, L1Loss, L2Loss, LogisticLoss, PoissonNLLLoss,
                   SDMLLoss, SigmoidBCELoss, SigmoidBinaryCrossEntropyLoss,
                   SoftmaxCELoss, SoftmaxCrossEntropyLoss, SquaredHingeLoss,
                   TripletLoss)
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter)
from .symbol_block import SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401


def __getattr__(name):
    if name in ("data", "metric"):
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
