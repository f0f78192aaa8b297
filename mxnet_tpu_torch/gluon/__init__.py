"""Gluon of the port: ``Block`` / ``HybridBlock``, ``Parameter``, layers
(``nn``), the vision model zoo, losses and the ``Trainer``."""
from . import loss, model_zoo, nn, parameter  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import DeferredInitializationError, Parameter  # noqa: F401
from .trainer import Trainer  # noqa: F401
