"""``mx.optimizer`` -- the seventeen optimizers of the JAX package, the
registry, ``Updater`` and ``get_updater``."""
from .optimizer import (DCASGD, FTML, LAMB, LANS, LARS, NAG,  # noqa: F401
                        SGD, SGLD, AdaDelta, AdaGrad, Adam, Adamax, AdamW,
                        Ftrl, Nadam, Optimizer, RMSProp, Signum, Updater,
                        create, get_updater, register)

opt_registry = Optimizer.opt_registry
