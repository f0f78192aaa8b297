"""Gluon of the port: ``Block`` / ``HybridBlock``, ``Parameter``, layers
(``nn``), the vision model zoo, losses, the ``Trainer`` and ``utils``."""
from . import loss, model_zoo, nn, parameter, utils  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (Constant, DeferredInitializationError,  # noqa: F401
                        Parameter)
from .trainer import Trainer  # noqa: F401
