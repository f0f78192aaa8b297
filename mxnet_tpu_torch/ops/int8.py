"""The int8 weight product of the serving decode: a hand-written CUDA
kernel on the card, its plain PyTorch version on the CPU.

``int8_linear(x, q, scale)`` computes ``x @ dequantize(q, scale)ᵀ`` for
an int8 weight ``q`` with one per-tensor scale, the product the JAX
package's int8 decode leaves XLA to fuse (``_dequant`` then the matmul,
``mxnet_tpu/serve.py:902-938``).  On CUDA tensors it launches
``csrc/int8_linear.cu`` (W8A16: int8 read from HBM, dequantized in
registers) or raises; on CPU tensors it runs :func:`int8_linear_plain`.
The dequantized weight is ``q.to(dtype) * scale``, rounded in the
compute dtype, exactly as the JAX ``_dequant`` rounds it; the prefill
programs take it whole from :func:`dequantize` (the ``int8_dequant``
kernel on CUDA) and run one plain product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .cuda_ops import GENERAL_DTYPES, LAUNCHES, _is_cuda

__all__ = ["dequantize", "dequantize_plain", "int8_linear",
           "int8_linear_plain"]


def dequantize_plain(q, scale, dtype):
    """The plain dequantize: ``q * dtype(scale)`` in ``dtype`` (the JAX
    ``_dequant``): the product casts each int8 on the fly (exact: q has
    at most 7 bits) and rounds once in ``dtype``."""
    return q * torch.tensor(scale, dtype=dtype).to(q.device)


def dequantize(q, scale, dtype):
    """``q`` (any shape, int8) dequantized into ``dtype`` with the
    per-tensor ``scale`` (a Python float): on CUDA the ``int8_dequant``
    kernel of ``csrc/int8_linear.cu`` (one pass: int8 read, ``dtype``
    written), on the CPU :func:`dequantize_plain`; the same bits."""
    if q.dtype != torch.int8:
        raise TypeError("dequantize: q must be int8, got %s" % q.dtype)
    if not q.is_cuda:
        return dequantize_plain(q, scale, dtype)
    code = GENERAL_DTYPES.get(dtype)
    if code is None:
        raise TypeError("dequantize takes float16, bfloat16, float32 or "
                        "float64, got %s" % dtype)
    if not q.is_contiguous():
        raise ValueError("dequantize: q must be contiguous")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    s = torch.tensor(scale, dtype=dtype).item()
    err = _build.library("int8_linear").mx_int8_dequant(
        q.data_ptr(), out.data_ptr(), q.numel(), s, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("int8_dequant kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["int8_dequant"] += 1
    return out


def int8_linear_plain(x, q, scale):
    """The plain version: ``F.linear(x, dequantize_plain(q, scale))``."""
    return F.linear(x, dequantize_plain(q, scale, x.dtype))


def int8_linear(x, q, scale):
    """``y = x @ dequantize(q, scale)ᵀ``.

    ``x``: (M, K) float16, bfloat16, float32 or float64; ``q``: (N, K)
    int8; ``scale``: the weight's per-tensor scale, a Python float,
    rounded to ``x``'s dtype before use.  ``y``: (M, N) in ``x``'s dtype,
    summed in float32 (float64 for float64).  On CUDA both are
    contiguous and ``q`` starts on a 16-byte boundary (its rows are read
    in 16-byte loads when K is a multiple of 16); anything else raises."""
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[1]:
        raise ValueError("int8_linear: x %s and q %s are not (M, K) and "
                         "(N, K)" % (tuple(x.shape), tuple(q.shape)))
    if q.dtype != torch.int8:
        raise TypeError("int8_linear: q must be int8, got %s" % q.dtype)
    if not _is_cuda(x, q):
        return int8_linear_plain(x, q, scale)
    code = GENERAL_DTYPES.get(x.dtype)
    if code is None:
        raise TypeError("int8_linear takes float16, bfloat16, float32 or "
                        "float64 x, got %s" % x.dtype)
    for name, t in (("x", x), ("q", q)):
        if not t.is_contiguous():
            raise ValueError("int8_linear: %s must be contiguous" % name)
    if q.data_ptr() % 16:
        raise ValueError("int8_linear: the rows of q must start on a "
                         "16-byte boundary")
    M, K = x.shape
    N = q.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    s = torch.tensor(scale, dtype=x.dtype).item()
    err = _build.library("int8_linear").mx_int8_linear(
        x.data_ptr(), q.data_ptr(), y.data_ptr(), M, N, K, s, code,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_linear kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["int8_linear"] += 1
    return y
