"""int8 kernels: the serving decode's int8 weight product, and
post-training quantization's quantize pass and int8 convolution;
hand-written CUDA on the card, their plain PyTorch versions on the CPU.

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

Post-training quantization (``contrib.quantization``'s quantized layers,
``nd.contrib``'s int8 family) runs two kernels of ``csrc/int8_conv.cu``:
:func:`int8_quantize` (``clip(round(x / scale), -127, 127)`` to int8,
written NHWC with each group's channels padded to a multiple of 4) and
:func:`int8_conv` (the int8 x int8 -> int32 convolution on the tensor
cores, with a raw int32 or a scaled float epilogue; a Dense product is
its 1 x 1 convolution over (M, K, 1, 1)).  Weights are quantized and
repacked once by :func:`pack_conv_weight`.  Each equals its plain
version bit for bit.
"""
from __future__ import annotations

import math

import numpy as onp
import torch
import torch.nn.functional as F

from . import _build
from .cuda_ops import GENERAL_DTYPES, LAUNCHES, _is_cuda

__all__ = ["dequantize", "dequantize_plain", "int8_linear",
           "int8_linear_plain", "int8_quantize", "int8_quantize_plain",
           "int8_conv", "int8_conv_plain", "pack_conv_weight",
           "padded_channels", "quantize_tensor"]


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


# ---------------------------------------------------------------------------
# post-training quantization: K2 (quantize) and K3 (int8 convolution)
# ---------------------------------------------------------------------------

#: dtype codes of ``mx_int8_quantize``'s x and ``ConvArgs.out_kind``
QUANT_DTYPES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
                torch.int8: 3}
OUT_KINDS = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
             torch.int32: 3}
#: the convolution's depth step (``BK`` of csrc/int8_conv.cu): a packed
#: weight row is padded to a multiple of it
CONV_BK = 64
_CONV_ARGS = onp.dtype(
    [(k, "<u8") for k in ("x", "w", "out", "scale", "bias", "bias_i32")]
    + [(k, "<i8") for k in ("sN", "sC", "sP")]
    + [(k, "<i4") for k in ("N", "H", "W", "G", "Cgp", "Og", "KH", "KW",
                            "OH", "OW", "sh", "sw", "ph", "pw", "dh", "dw",
                            "Kreal", "Kp", "M", "out_kind", "relu")],
    align=True)


def padded_channels(cg):
    """A group's ``cg`` channels padded to the multiple of 4 the
    convolution reads in 4-byte words."""
    return (cg + 3) // 4 * 4


def quantize_tensor(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8, in ``x``'s layout:
    float32 arithmetic, the division by a 0-dim float32 tensor on x's
    device (a true IEEE division: ATen divides by a Python scalar as a
    product with its reciprocal on CUDA), round half to even."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _nhwc_groups(q, groups):
    """(N, C, *spatial) -> (N, *spatial, G * Cgp), each group's channels
    padded with zeros."""
    N, C, sp = q.shape[0], q.shape[1], q.shape[2:]
    cg = C // groups
    q = q.reshape(N, groups, cg, -1).permute(0, 3, 1, 2)
    q = F.pad(q, (0, padded_channels(cg) - cg))
    return q.reshape(N, *sp, groups * padded_channels(cg)).contiguous()


def _int8_scale(x, scale):
    if x.dtype == torch.int8 and scale != 1.0:
        raise ValueError("int8_quantize: an int8 x is only laid out, at "
                         "scale 1, not %r" % (scale,))


def int8_quantize_plain(x, scale, groups=1):
    """The plain version of :func:`int8_quantize`, on any device."""
    _int8_scale(x, scale)
    q = x if x.dtype == torch.int8 else quantize_tensor(x, scale)
    return _nhwc_groups(q, groups)


def int8_quantize(x, scale, groups=1):
    """``x`` (N, C, *spatial) -- NCHW, or (M, K) -- in float16, bfloat16,
    float32 or int8, quantized with ``scale`` (a Python float, rounded to
    float32) into (N, *spatial, G * Cgp) int8: channels last, each of the
    ``groups`` groups' C / G channels padded with zeros to
    :func:`padded_channels`.  An int8 ``x`` takes ``scale`` 1 and is only
    laid out, its values (-128 included) unchanged.  The
    ``int8_quantize`` kernel on CUDA (one launch),
    :func:`int8_quantize_plain` on the CPU; the same bits."""
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError("int8_quantize: x of shape %s does not split into "
                         "%d groups of channels" % (tuple(x.shape), groups))
    _int8_scale(x, scale)
    if not x.is_cuda:
        return int8_quantize_plain(x, scale, groups)
    code = QUANT_DTYPES.get(x.dtype)
    if code is None:
        raise TypeError("int8_quantize takes float16, bfloat16, float32 or "
                        "int8 x, got %s" % x.dtype)
    if not x.is_contiguous():
        raise ValueError("int8_quantize: x must be contiguous")
    N, C, sp = x.shape[0], x.shape[1], x.shape[2:]
    cgp = padded_channels(C // groups)
    q = torch.empty((N, *sp, groups * cgp), dtype=torch.int8,
                    device=x.device)
    if q.numel() == 0:
        return q
    err = _build.library("int8_conv").mx_int8_quantize(
        x.data_ptr(), q.data_ptr(), code, N, C, math.prod(sp), groups, cgp,
        scale, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_quantize kernel launch failed: CUDA error "
                           "%d" % err)
    LAUNCHES["int8_quantize"] += 1
    return q


def pack_conv_weight(wq, groups):
    """An int8 weight (O, I / G, KH, KW) repacked for :func:`int8_conv`:
    (G, O / G, Kp) with the depth (kh, kw, c) c fastest, each group's
    channels padded to :func:`padded_channels` and the row padded with
    zeros to a multiple of ``CONV_BK``."""
    O, cg, kh, kw = wq.shape
    og, cgp = O // groups, padded_channels(cg)
    w = wq.reshape(groups, og, cg, kh, kw).permute(0, 1, 3, 4, 2)
    w = F.pad(w, (0, cgp - cg)).reshape(groups, og, kh * kw * cgp)
    kp = -(-kh * kw * cgp // CONV_BK) * CONV_BK
    return F.pad(w, (0, kp - kh * kw * cgp)).contiguous()


def _out_size(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _conv_args(xq, wpk, kernel, stride, padding, dilation, groups):
    """Check the operands; (N, H, W, Cgp, O, OH, OW)."""
    if xq.dtype != torch.int8 or wpk.dtype != torch.int8:
        raise TypeError("int8_conv: xq and the packed weight must be int8, "
                        "got %s / %s" % (xq.dtype, wpk.dtype))
    if xq.dim() != 4 or wpk.dim() != 3 or wpk.shape[0] != groups or \
            xq.shape[3] % groups:
        raise ValueError("int8_conv: xq %s is not (N, H, W, G * Cgp) or the "
                         "weight %s not (G, O / G, Kp) for %d groups"
                         % (tuple(xq.shape), tuple(wpk.shape), groups))
    N, H, W, ctot = xq.shape
    cgp = ctot // groups
    kh, kw = kernel
    if cgp % 4 or wpk.shape[2] % CONV_BK or wpk.shape[2] < kh * kw * cgp:
        raise ValueError("int8_conv: %d channels a group and a weight row "
                         "of %d for a %dx%d kernel" % (cgp, wpk.shape[2], kh,
                                                        kw))
    OH = _out_size(H, kh, stride[0], padding[0], dilation[0])
    OW = _out_size(W, kw, stride[1], padding[1], dilation[1])
    return N, H, W, cgp, groups * wpk.shape[1], OH, OW


def int8_conv_plain(xq, wpk, kernel, stride=(1, 1), padding=(0, 0),
                    dilation=(1, 1), groups=1, scale=None, bias=None,
                    relu=False, out_dtype=torch.float32, bias_i32=None,
                    channels_last=False):
    """The plain version of :func:`int8_conv`, on any device: the
    convolution in float64 (exact for these sums) rounded to int32, then
    the epilogue, one PyTorch op per rounding."""
    N, H, W, cgp, O, OH, OW = _conv_args(xq, wpk, kernel, stride, padding,
                                         dilation, groups)
    kh, kw = kernel
    x = xq.permute(0, 3, 1, 2).double()
    w = wpk[:, :, :kh * kw * cgp].reshape(groups, -1, kh, kw, cgp)
    w = w.permute(0, 1, 4, 2, 3).reshape(O, cgp, kh, kw).double()
    acc = F.conv2d(x, w, None, tuple(stride), tuple(padding),
                   tuple(dilation), groups).round().to(torch.int32)
    if out_dtype == torch.int32:
        y = acc if bias_i32 is None else acc + bias_i32.reshape(1, -1, 1, 1)
    else:
        y = acc.float() * scale.reshape(1, -1, 1, 1)
        if bias is not None:
            y = y + bias.reshape(1, -1, 1, 1)
        if relu:
            y = torch.relu(y)
        y = y.to(out_dtype)
    return y.permute(0, 2, 3, 1).contiguous() if channels_last else y


def int8_conv(xq, wpk, kernel, stride=(1, 1), padding=(0, 0),
              dilation=(1, 1), groups=1, scale=None, bias=None, relu=False,
              out_dtype=torch.float32, bias_i32=None, channels_last=False):
    """The int8 convolution of ``xq`` ((N, H, W, G * Cgp) int8, from
    :func:`int8_quantize`) with ``wpk`` (:func:`pack_conv_weight`), its
    int32 sums (exact) finished by one of two epilogues:

    * ``out_dtype=torch.int32``: the sums plus ``bias_i32`` (O int32, or
      None);
    * float16 / bfloat16 / float32: ``f32(acc) * scale[o]`` (O float32),
      plus ``bias[o]`` (O float32, or None), then relu if ``relu``, each
      operation rounded once, then rounded to ``out_dtype``.

    The output is (N, O, OH, OW), or (N, OH, OW, O) with
    ``channels_last``.  The ``int8_conv`` kernel on CUDA (one launch),
    :func:`int8_conv_plain` on the CPU; the same bits."""
    N, H, W, cgp, O, OH, OW = _conv_args(xq, wpk, kernel, stride, padding,
                                         dilation, groups)
    if not _is_cuda(xq, wpk):
        return int8_conv_plain(xq, wpk, kernel, stride, padding, dilation,
                               groups, scale, bias, relu, out_dtype,
                               bias_i32, channels_last)
    kind = OUT_KINDS.get(out_dtype)
    if kind is None:
        raise TypeError("int8_conv writes float16, bfloat16, float32 or "
                        "int32, got %s" % out_dtype)
    vecs = {"scale": (scale, torch.float32), "bias": (bias, torch.float32),
            "bias_i32": (bias_i32, torch.int32)}
    if kind != 3 and scale is None:
        raise ValueError("int8_conv: a float epilogue needs the scales")
    for name, (v, dt) in vecs.items():
        if v is not None and (v.dtype != dt or v.numel() != O or
                              v.device != xq.device or
                              not v.is_contiguous()):
            raise ValueError("int8_conv: %s must be %d contiguous %s values "
                             "on %s" % (name, O, dt, xq.device))
    for name, t in (("xq", xq), ("the packed weight", wpk)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8_conv: %s must be contiguous and start on "
                             "a 16-byte boundary" % name)
    shape = (N, OH, OW, O) if channels_last else (N, O, OH, OW)
    out = torch.empty(shape, dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    P = OH * OW
    strides = (P * O, 1, O) if channels_last else (P * O, P, 1)
    a = onp.zeros((), dtype=_CONV_ARGS)
    for name, t in (("x", xq), ("w", wpk), ("out", out),
                    ("scale", scale), ("bias", bias),
                    ("bias_i32", bias_i32)):
        a[name] = 0 if t is None else t.data_ptr()
    a["sN"], a["sC"], a["sP"] = strides
    kh, kw = kernel
    for name, v in zip(("N", "H", "W", "G", "Cgp", "Og", "KH", "KW", "OH",
                        "OW", "sh", "sw", "ph", "pw", "dh", "dw", "Kreal",
                        "Kp", "M", "out_kind", "relu"),
                       (N, H, W, groups, cgp, O // groups, kh, kw, OH, OW,
                        *stride, *padding, *dilation, kh * kw * cgp,
                        wpk.shape[2], N * P, kind, int(bool(relu)))):
        a[name] = v
    lib = _build.library("int8_conv")
    size = lib.mx_int8_conv_args_size()
    if size != _CONV_ARGS.itemsize:
        raise RuntimeError("int8_conv.cu's ConvArgs (%d bytes) differs from "
                           "the host's (%d)" % (size, _CONV_ARGS.itemsize))
    err = lib.mx_int8_conv(a.ctypes.data, a.nbytes,
                           torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError("int8_conv kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["int8_conv"] += 1
    return out
