"""Optimizers of the port (``SGD``, ``Adam``, ``AdamW``) and their
registry."""
from .optimizer import (SGD, Adam, AdamW, Optimizer, create,  # noqa: F401
                        register)

opt_registry = Optimizer.opt_registry
