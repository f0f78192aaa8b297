"""Gluon of the port: the ``Block`` base, layers (``nn``), losses and
the ``Trainer``."""
from . import loss, nn  # noqa: F401
from .block import Block  # noqa: F401
from .trainer import Trainer  # noqa: F401
