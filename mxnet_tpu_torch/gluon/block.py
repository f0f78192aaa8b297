"""``Block``: the base of the port's layers and models.

Counterpart of the parameter side of ``mxnet_tpu/gluon/block.py``
(``collect_params`` :78, ``zero_grad`` :112) over ``torch.nn.Module``.
A Parameter is a ``torch.nn.Parameter``; its MXNet ``grad_req`` maps to
``requires_grad`` ("null" = False).  ``state_dict()`` keys and
``collect_params()`` names are the same structural paths
(``layer0.attention.wq.weight``), which are the JAX package's names.
"""
from __future__ import annotations

import re
from collections import OrderedDict

from torch import nn

__all__ = ["Block"]


class Block(nn.Module):

    def collect_params(self, select=None):
        """Ordered ``{name: Parameter}``; ``select`` is a regular
        expression matched at the start of each name."""
        pattern = re.compile(select) if select else None
        return OrderedDict((name, p) for name, p in self.named_parameters()
                           if pattern is None or pattern.match(name))

    def zero_grad(self):
        """Set every gradient that exists to zero, in place."""
        for p in self.parameters():
            if p.grad is not None:
                p.grad.zero_()
