"""``mx.nd.contrib`` -- the op-level int8 quantization family.

Counterpart of ``mxnet_tpu/ndarray/contrib.py:465-742`` (the reference's
``src/operator/quantization/``).  Ranges follow the zero-centered int8
convention: scale = 127 / max(|min|, |max|), and a product's int32
range is QuantizationRangeForMultiplication.  ``quantized_conv`` and
``quantized_fully_connected`` return the raw int32 sums (plus the bias
shifted to the int32 scale) from the ``int8_conv`` kernel on CUDA (its
raw epilogue; the int8 data reach it through the ``int8_quantize``
kernel at scale 1, which only lays them out channels last), the plain
version on the CPU.  The others are plain PyTorch on the arrays' device,
each rounding where the JAX op does: float32 arithmetic, a Python scalar
rounded to float32 first, a cast to an integer type truncating.

The rest of the reference's ``nd.contrib`` (detection, resizing, the
sliding-window attention, the graph ops, ...) waits for ROADMAP queue 5;
its names raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..ops import int8 as _int8
from ..ops import nn as _nn
from .ndarray import NDArray

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "calibrate_entropy", "quantized_conv", "quantized_fully_connected",
           "quantized_pooling", "quantized_flatten", "quantized_act",
           "quantized_elemwise_add", "quantized_elemwise_mul",
           "quantized_concat", "quantized_embedding", "quantized_batch_norm"]

_INT8_RANGE = 127.0
_INT32_RANGE = 2147483647.0

#: the reference's other nd.contrib names (ROADMAP queue 5)
_QUEUE5 = frozenset((
    "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "box_encode",
    "box_decode", "bipartite_matching", "AdaptiveAvgPooling2D",
    "BilinearResize2D", "SyncBatchNorm", "BatchNormWithReLU", "quadratic",
    "index_copy", "index_array", "getnnz", "boolean_mask",
    "dynamic_reshape", "div_sqrt_dim", "allclose", "fft", "ifft",
    "count_sketch", "khatri_rao", "gradientmultiplier", "round_ste",
    "sign_ste", "psroi_pooling", "deformable_psroi_pooling", "proposal",
    "multi_proposal", "RROIAlign", "IdentityAttachKLSparseReg", "hawkesll",
    "sldwin_atten_score", "sldwin_atten_context", "sldwin_atten_mask_like",
    "dgl_csr_neighbor_uniform_sample",
    "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph", "dgl_adjacency",
    "dgl_graph_compact", "edge_id", "im2col", "col2im",
    "deformable_convolution"))


def __getattr__(name):
    if name in _QUEUE5:
        raise NotImplementedError(
            "mx.nd.contrib.%s is not ported yet (ROADMAP queue 5)" % name)
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


def _t(x):
    """A tensor of ``x``; a Python or numpy value becomes one as the JAX
    package's NDArray makes it (64-bit types narrowed to 32)."""
    if isinstance(x, NDArray):
        return x._data
    if torch.is_tensor(x):
        return x
    a = _onp.asarray(x)
    if a.dtype in (_onp.float64, _onp.int64):
        a = a.astype(_onp.float32 if a.dtype == _onp.float64 else _onp.int32)
    return torch.as_tensor(a)


def _range_scalar(x):
    if isinstance(x, (int, float)):
        return float(x)
    return float(_t(x).reshape(-1)[0])


def _f32(v, like):
    """``v`` as a 0-dim float32 tensor on ``like``'s device (what a
    Python scalar becomes in a JAX op on a float32 array; a tensor
    divisor, because ATen's CUDA division by a Python scalar is a product
    with its reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _three(q, lo, hi):
    return NDArray(q), NDArray(_f32(lo, q)), NDArray(_f32(hi, q))


def _sym_quantize(f, scale):
    """``sign(f) * min(|f| * scale + 0.5, 127)`` truncated to int8."""
    return (torch.sign(f) * torch.clamp(f.abs() * _f32(scale, f)
                                        + _f32(0.5, f), max=127.0)) \
        .to(torch.int8)


def quantize(data, min_range, max_range, out_type="uint8"):
    """Affine (uint8) / zero-centered (int8) quantization
    (``quantize-inl.h``).  Returns (q, min, max)."""
    lo, hi = _range_scalar(min_range), _range_scalar(max_range)
    x = _t(data).float()
    if out_type == "uint8":
        scale = 255.0 / (hi - lo)
        q = torch.clamp(torch.floor((x - _f32(lo, x)) * _f32(scale, x)
                                    + _f32(0.5, x)), 0, 255)
        return _three(q.to(torch.uint8), lo, hi)
    real = max(abs(lo), abs(hi))
    return _three(_sym_quantize(x, _INT8_RANGE / real), -real, real)


def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """Quantize with the calibrated range, or the data's own min and max
    when none is given (``quantize_v2-inl.h``)."""
    if min_calib_range is None or max_calib_range is None:
        x = _t(data)
        lo, hi = float(x.min()), float(x.max())
    else:
        lo, hi = float(min_calib_range), float(max_calib_range)
    return quantize(data, lo, hi, out_type=out_type)


def dequantize(data, min_range, max_range, out_type="float32"):
    """Quantized -> float32 (``dequantize-inl.h``); the quantized range
    follows the dtype (int8: 127, int32: 2^31 - 1, uint8: affine)."""
    lo, hi = _range_scalar(min_range), _range_scalar(max_range)
    real = max(abs(lo), abs(hi))
    q = _t(data)
    f = q.float()
    if q.dtype == torch.uint8:
        return NDArray(f * _f32((hi - lo) / 255.0, f) + _f32(lo, f))
    qrange = _INT32_RANGE if q.dtype == torch.int32 else _INT8_RANGE
    return NDArray(f * _f32(real / qrange, f))


def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None, out_type="int8"):
    """int32 -> int8 at the calibrated output range, or the data's own
    (``requantize-inl.h``).  Returns (q, min, max)."""
    lo, hi = _range_scalar(min_range), _range_scalar(max_range)
    real32 = max(abs(lo), abs(hi))
    q = _t(data)
    if min_calib_range is None:
        arr = q.cpu().numpy().astype("float64") * (real32 / _INT32_RANGE)
        calib = max(abs(float(arr.min())), abs(float(arr.max()))) or 1.0
    else:
        calib = max(abs(float(min_calib_range)),
                    abs(float(max_calib_range)))
    f = q.float() * _f32(real32 / _INT32_RANGE, q)
    return _three(_sym_quantize(f, _INT8_RANGE / calib), -calib, calib)


def calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """The KL-divergence threshold (``calibrate.cc``): (threshold,
    divergence), each a float32 NDArray."""
    from ..contrib.quantization import optimal_threshold
    th, div = optimal_threshold(_t(hist).cpu().numpy(),
                                _t(hist_edges).cpu().numpy(),
                                num_quantized_bins)
    return (NDArray(torch.tensor(th, dtype=torch.float32)),
            NDArray(torch.tensor(div, dtype=torch.float32)))


def _mul_out_range(min_a, max_a, min_b, max_b):
    a1 = max(abs(_range_scalar(min_a)), abs(_range_scalar(max_a))) \
        / _INT8_RANGE
    b1 = max(abs(_range_scalar(min_b)), abs(_range_scalar(max_b))) \
        / _INT8_RANGE
    mx_c = a1 * b1 * _INT32_RANGE
    return -mx_c, mx_c


def _bias_i32(bias, min_bias, max_bias, hi, like):
    """The bias at the int32 accumulator's scale (the reference's shift):
    round(b * b_scale / out_scale)."""
    b = _t(bias).float()
    b_scale = max(abs(_range_scalar(min_bias)),
                  abs(_range_scalar(max_bias))) / _INT8_RANGE
    out_scale = hi / _INT32_RANGE
    return torch.round(b * _f32(b_scale, b) / _f32(out_scale, b)) \
        .to(torch.int32).to(like.device).contiguous()


def _tuple(v, n, default):
    if v is None:
        return (default,) * n
    v = tuple(v) if isinstance(v, (list, tuple)) else (v,) * n
    return v if len(v) == n else (v[0],) * n


def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=None,
                   stride=None, pad=None, dilate=None, num_filter=None,
                   num_group=1, layout=None, **kw):
    """int8 convolution with int32 sums (``quantized_conv.cc``): 1-D or
    2-D, NC* or channels-last; returns (out int32, min_out, max_out)."""
    lo, hi = _mul_out_range(min_data, max_data, min_weight, max_weight)
    d = _t(data).to(torch.int8)
    w = _t(weight).to(torch.int8)
    nsp = d.dim() - 2
    if nsp not in (1, 2):
        raise NotImplementedError(
            "quantized_conv: %d-D convolutions are not ported (1-D and "
            "2-D are)" % nsp)
    last = _nn.channels_last(layout)
    if last:
        d, w = d.movedim(-1, 1), w.movedim(-1, 1)
    stride, pad, dilate = (_tuple(stride, nsp, 1), _tuple(pad, nsp, 0),
                           _tuple(dilate, nsp, 1))
    if nsp == 1:
        d, w = d.unsqueeze(2), w.unsqueeze(2)
        stride, pad, dilate = ((1,) + stride, (0,) + pad, (1,) + dilate)
    xq = _int8.int8_quantize(d.contiguous(), 1.0, num_group)
    b = None if bias is None else _bias_i32(bias, min_bias, max_bias, hi, d)
    y = _int8.int8_conv(xq, _int8.pack_conv_weight(w, num_group),
                        tuple(w.shape[2:]), stride, pad, dilate, num_group,
                        out_dtype=torch.int32, bias_i32=b,
                        channels_last=last)
    if nsp == 1:
        y = y.squeeze(1 if last else 2)
    return _three(y, lo, hi)


def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=None, no_bias=False,
                              flatten=True, **kw):
    """int8 product -> int32 (``quantized_fully_connected.cc``): the
    ``int8_conv`` kernel's 1 x 1 convolution over (M, K, 1, 1)."""
    lo, hi = _mul_out_range(min_data, max_data, min_weight, max_weight)
    x = _t(data).to(torch.int8)
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    w = _t(weight).to(torch.int8)
    lead, K = x.shape[:-1], x.shape[-1]
    xq = _int8.int8_quantize(x.reshape(-1, K).contiguous(), 1.0)
    b = None if (no_bias or bias is None) else \
        _bias_i32(bias, min_bias, max_bias, hi, x)
    y = _int8.int8_conv(xq.reshape(xq.shape[0], 1, 1, xq.shape[1]),
                        _int8.pack_conv_weight(w.reshape(*w.shape, 1, 1), 1),
                        (1, 1), out_dtype=torch.int32, bias_i32=b)
    return _three(y.reshape(*lead, w.shape[0]), lo, hi)


def quantized_pooling(data, min_data, max_data, kernel=None,
                      pool_type="max", stride=None, pad=None,
                      global_pool=False, layout=None, **kw):
    """Pooling on the int8 values, the range passing through
    (``quantized_pooling.cc``): max and sum exact, avg the float32
    quotient truncated back to int8."""
    d = _t(data)
    x = d.double()
    nsp = d.dim() - 2
    if global_pool:
        sp = d.shape[1:-1] if _nn.channels_last(layout) else d.shape[2:]
        kernel, stride, pad = tuple(sp), (1,) * nsp, (0,) * nsp
    kernel = tuple(kernel)
    if pool_type in ("max", "sum", "lp"):
        y = _nn.pooling(x, kernel, pool_type, stride, pad, layout=layout)
        y = y.float() if pool_type == "lp" else y.to(torch.int32)
    elif pool_type == "avg":
        s = _nn.pooling(x, kernel, "sum", stride, pad, layout=layout)
        denom = 1
        for k in kernel:
            denom *= k
        y = s.float() / _f32(float(denom), s)
    else:
        raise ValueError("unknown pool_type %r" % pool_type)
    return NDArray(y.to(d.dtype)), NDArray(_t(min_data)), \
        NDArray(_t(max_data))


def quantized_flatten(data, min_data, max_data):
    d = _t(data)
    return NDArray(d.reshape(d.shape[0], -1)), NDArray(_t(min_data)), \
        NDArray(_t(max_data))


def quantized_act(data, min_data, max_data, act_type="relu"):
    """ReLU on zero-centered int8 is max(q, 0)
    (``quantized_activation.cc``)."""
    if act_type != "relu":
        raise NotImplementedError("quantized_act supports relu")
    d = _t(data)
    return NDArray(torch.clamp(d, min=0)), NDArray(_t(min_data)), \
        NDArray(_t(max_data))


def quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 + int8 -> int32 at the common range
    (``quantized_elemwise_add.cc``)."""
    la = max(abs(_range_scalar(lhs_min)), abs(_range_scalar(lhs_max)))
    ra = max(abs(_range_scalar(rhs_min)), abs(_range_scalar(rhs_max)))
    out_range = la + ra
    a, b = _t(lhs).float(), _t(rhs).float()
    f = a * _f32(la / _INT8_RANGE, a) + b * _f32(ra / _INT8_RANGE, b)
    q = torch.round(f / _f32(out_range, f) * _f32(_INT32_RANGE, f))
    return _three(q.to(torch.int32), -out_range, out_range)


def quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    lo, hi = _mul_out_range(lhs_min, lhs_max, rhs_min, rhs_max)
    q = _t(lhs).to(torch.int32) * _t(rhs).to(torch.int32)
    return _three(q, lo, hi)


def quantized_concat(*data, dim=1, num_args=None):
    """Concatenate int8 tensors after rescaling to the widest range
    (``quantized_concat.cc``); ``data`` = [x0 .. xn-1, min0, max0, ..,
    minn-1, maxn-1], the reference's input layout."""
    n = num_args if num_args is not None else len(data) // 3
    xs = [_t(x) for x in data[:n]]
    reals = [max(abs(_range_scalar(data[n + 2 * i])),
                 abs(_range_scalar(data[n + 2 * i + 1]))) for i in range(n)]
    out_real = max(reals)
    outs = []
    for a, r in zip(xs, reals):
        f = a.float() * _f32(r / _INT8_RANGE, a)
        outs.append(_sym_quantize(f, _INT8_RANGE / out_real))
    return _three(torch.cat(outs, dim=dim), -out_real, out_real)


def quantized_embedding(data, weight, min_weight, max_weight,
                        input_dim=None, output_dim=None, **kw):
    """int8 embedding lookup, the range passing through
    (``quantized_indexing_op.cc``)."""
    idx, w = _t(data).to(torch.int64), _t(weight)
    return NDArray(w[idx]), NDArray(_t(min_weight)), NDArray(_t(max_weight))


def quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                         min_data, max_data, eps=1e-3,
                         min_calib_range=None, max_calib_range=None, **kw):
    """Inference BatchNorm in the int8 domain with a calibrated output
    range (``quantized_batch_norm.cc``): dequantize, normalise,
    requantize to int8."""
    real_in = max(abs(_range_scalar(min_data)), abs(_range_scalar(max_data)))
    calib = max(abs(float(min_calib_range)), abs(float(max_calib_range))) \
        if min_calib_range is not None else real_in
    d = _t(data)
    f = d.float() * _f32(real_in / _INT8_RANGE, d)
    shape = (1, -1) + (1,) * (f.dim() - 2)
    inv = torch.rsqrt(_t(moving_var).float() + _f32(eps, f)).reshape(shape)
    f = (f - _t(moving_mean).float().reshape(shape)) * inv \
        * _t(gamma).float().reshape(shape) + _t(beta).float().reshape(shape)
    return _three(_sym_quantize(f, _INT8_RANGE / calib), -calib, calib)
