"""``SymbolBlock``: run an exported model without its Python code.

Counterpart of ``mxnet_tpu/gluon/symbol_block.py``.  ``HybridBlock.export``
writes ``path-symbol.pt2``, a ``torch.export`` program of the inference
forward that takes the parameters as inputs, with the header
``{"param_names": [...]}``, beside ``path-%04d.params``;
:meth:`SymbolBlock.imports` loads both and runs the program on the device
asked for (a program traced on another device is moved there by
``torch.export``'s device pass).  The parameters are the block's own,
frozen (``collect_params()`` gives them under their names), so they can
be read, saved or loaded as any block's.  A program holding the int8 ops of
post-training quantization (``mxnet_tpu_torch::int8_quantize``, ...)
runs their kernels on CUDA and their plain versions on the CPU.
"""
from __future__ import annotations

import json

import torch

from ..context import resolve_device
from ..ops import int8 as _int8  # noqa: F401  (registers the int8 ops)
from ..utils import serialization
from .block import SYMBOL_HEADER, HybridBlock
from .parameter import TorchParameter, mark_initialized

__all__ = ["SymbolBlock"]


class SymbolBlock(HybridBlock):
    """An exported program and its parameters as a block."""

    def __init__(self, program, param_names, params):
        super().__init__()
        self._program = program
        self._names = list(param_names)
        self._plist = torch.nn.ParameterList(
            [TorchParameter(params[n].detach(), requires_grad=False)
             for n in self._names])
        for p in self._plist:
            mark_initialized(p)

    @staticmethod
    def imports(symbol_file, input_names=None, param_file=None, device=None,
                ctx=None):
        """The block of ``symbol_file`` (``export``'s ``-symbol.pt2``)
        with the parameters of ``param_file``, on ``device`` (None: the
        current context).  ``input_names`` is accepted as the
        reference's and unused: the program takes its inputs in order."""
        dev = torch.empty(0, device=resolve_device(
            device if device is not None else ctx)).device
        extra = {SYMBOL_HEADER: ""}
        program = torch.export.load(symbol_file, extra_files=extra)
        names = json.loads(extra[SYMBOL_HEADER])["param_names"]
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, dev)
        params = {}
        if param_file is not None:
            params = {k: v._data for k, v in serialization.load(
                param_file, device=dev).items()}
        missing = [n for n in names if n not in params]
        if missing:
            raise ValueError("SymbolBlock.imports: %s holds no value for %s"
                             % (param_file, missing[:5]))
        return SymbolBlock(program.module(), names, params)

    def _param_items(self):
        return zip(self._names, self._plist)

    def forward(self, *args):
        return self._program(list(self._plist), *args)
