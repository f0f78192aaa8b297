"""``mx.nd.contrib``: MXNet's contrib operators over torch.

Counterpart of ``mxnet_tpu/ndarray/contrib.py``:

* the op-level int8 quantization family (:465-742 there, the reference's
  ``src/operator/quantization/``).  Ranges follow the zero-centered int8
  convention: scale = 127 / max(|min|, |max|), and a product's int32
  range is QuantizationRangeForMultiplication.  ``quantized_conv`` and
  ``quantized_fully_connected`` return the raw int32 sums (plus the bias
  shifted to the int32 scale) from the ``int8_conv`` kernel on CUDA (its
  raw epilogue; the int8 data reach it through the ``int8_quantize``
  kernel at scale 1, which only lays them out channels last, or as im2col
  rows where ``ops.int8.int8_conv_mode`` says so), the plain version on
  the CPU.  The others are plain PyTorch on the arrays' device, each
  rounding where the JAX op does: float32 arithmetic, a Python scalar
  rounded to float32 first, a cast to an integer type truncating;
* detection (:mod:`._detection`: the SSD MultiBox family, box encode /
  decode, bipartite matching, proposals, the PS-ROI poolings,
  ``RROIAlign``) and ``npx.contrib``'s ROI / box / interleaved-attention
  ops under their ``nd.contrib`` names;
* layers (``AdaptiveAvgPooling2D``, ``BilinearResize2D``,
  ``SyncBatchNorm``, ``BatchNormWithReLU``), tensor utilities, the
  custom-gradient ops (``gradientmultiplier``, ``round_ste``,
  ``sign_ste``, ``IdentityAttachKLSparseReg``, each a
  ``torch.autograd.Function``) and ``hawkesll``;
* DGL's graph ops on ``CSRNDArray`` graphs (:mod:`._dgl`).

Host-numpy ops (data-dependent control flow, as in the reference) say
so and return on their input's device.  ``sldwin_atten_*``, ``im2col``
/ ``col2im`` and ``deformable_convolution`` wait for ROADMAP queue 5
item 3 (sequence models) and raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..numpy_extension.contrib import (  # noqa: F401
    box_iou, box_nms, interleaved_matmul_encdec_qk,
    interleaved_matmul_encdec_valatt, interleaved_matmul_selfatt_qk,
    interleaved_matmul_selfatt_valatt, roi_align, roi_pooling)
from ..ops import int8 as _int8
from ..ops import nn as _nn
from ._detection import (MultiBoxDetection, MultiBoxPrior,  # noqa: F401
                         MultiBoxTarget, MultiProposal, Proposal, RROIAlign,
                         bipartite_matching, box_decode, box_encode,
                         deformable_psroi_pooling, multi_proposal, proposal,
                         psroi_pooling)
from ._dgl import (dgl_adjacency, dgl_csr_neighbor_non_uniform_sample,  # noqa
                   dgl_csr_neighbor_uniform_sample, dgl_graph_compact,
                   dgl_subgraph, edge_id)
from .legacy_ops import _waits, khatri_rao, resize_like_jax  # noqa: F401
from .ndarray import NDArray, apply_op

__all__ = [
    "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "ROIAlign",
    "AdaptiveAvgPooling2D", "BilinearResize2D", "SyncBatchNorm",
    "BatchNormWithReLU", "quadratic", "index_copy", "index_array",
    "edge_id", "getnnz", "boolean_mask", "dynamic_reshape",
    "box_encode", "box_decode", "bipartite_matching", "hawkesll",
    "sldwin_atten_score", "sldwin_atten_context", "sldwin_atten_mask_like",
    "div_sqrt_dim", "box_iou", "box_nms", "roi_align", "roi_pooling",
    "quantize", "quantize_v2", "dequantize", "requantize",
    "calibrate_entropy", "quantized_conv", "quantized_fully_connected",
    "quantized_pooling", "quantized_flatten", "quantized_act",
    "quantized_elemwise_add", "quantized_elemwise_mul", "quantized_concat",
    "quantized_embedding", "quantized_batch_norm", "RROIAlign",
    "IdentityAttachKLSparseReg", "allclose", "fft", "ifft", "count_sketch",
    "khatri_rao", "gradientmultiplier", "round_ste", "sign_ste",
    "psroi_pooling", "deformable_psroi_pooling", "proposal",
    "multi_proposal", "Proposal", "MultiProposal",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
]

_INT8_RANGE = 127.0
_INT32_RANGE = 2147483647.0

ROIAlign = roi_align
sldwin_atten_score = _waits("contrib.sldwin_atten_score", 3,
                            "sequence models")
sldwin_atten_context = _waits("contrib.sldwin_atten_context", 3,
                              "sequence models")
sldwin_atten_mask_like = _waits("contrib.sldwin_atten_mask_like", 3,
                                "sequence models")
im2col = _waits("contrib.im2col", 3, "sequence models")
col2im = _waits("contrib.col2im", 3, "sequence models")
deformable_convolution = _waits("contrib.deformable_convolution", 3,
                                "sequence models")


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
    b = None if bias is None else _bias_i32(bias, min_bias, max_bias, hi, d)
    y = _int8.quantized_conv(d.contiguous(), 1.0,
                             _int8.pack_conv_weight(w, num_group),
                             tuple(w.shape[2:]), stride, pad, dilate,
                             num_group, out_dtype=torch.int32, bias_i32=b,
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


# ----------------------------------------------------------------------
# pooling, resizing and normalization layers
# ----------------------------------------------------------------------
def AdaptiveAvgPooling2D(data, output_size=1):
    return apply_op(lambda x: _nn.adaptive_avg_pool2d(x, output_size),
                    [data], "AdaptiveAvgPooling2D")


def BilinearResize2D(data, height=1, width=1, scale_height=None,
                     scale_width=None, mode="size"):
    """NCHW bilinear resize as ``jax.image.resize(method="linear")``
    (antialiased when it shrinks), in float32 and back to the dtype."""
    def g(x):
        _, _, h, w = x.shape
        if scale_height is not None:
            nh = int(h * scale_height)
            nw = int(w * (scale_width or scale_height))
        else:
            nh, nw = height, width
        return resize_like_jax(x, (nh, nw), "linear")
    return apply_op(g, [data], "BilinearResize2D")


def SyncBatchNorm(data, gamma, beta, moving_mean, moving_var, key=None,
                  eps=1e-3, momentum=0.9, fix_gamma=True,
                  use_global_stats=False, output_mean_var=False, ndev=1,
                  **kw):
    """Cross-device batch norm as an imperative op on one device: batch
    norm (the reference's semantics with ndev=1; a mesh's synchronized
    statistics are ``parallel.sharding.batch_scope``'s)."""
    from .. import numpy_extension as npx
    return npx.batch_norm(data, gamma, beta, moving_mean, moving_var,
                          eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                          use_global_stats=use_global_stats,
                          output_mean_var=output_mean_var)


def BatchNormWithReLU(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                      momentum=0.9, fix_gamma=True, use_global_stats=False,
                      **kw):
    """Batch norm then ReLU (``contrib/batch_norm_relu.cc``)."""
    from .. import numpy_extension as npx
    return npx.relu(npx.batch_norm(data, gamma, beta, moving_mean,
                                   moving_var, eps=eps, momentum=momentum,
                                   fix_gamma=fix_gamma,
                                   use_global_stats=use_global_stats))


# ----------------------------------------------------------------------
# tensor utilities
# ----------------------------------------------------------------------
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c (``contrib/quadratic_op.cc``)."""
    return apply_op(lambda x: a * x * x + b * x + c, [data], "quadratic")


def index_copy(old_tensor, index_vector, new_tensor):
    """``old_tensor`` with the rows ``index_vector`` replaced by
    ``new_tensor``'s (a new array)."""
    def g(old, idx, new):
        out = old.clone()
        out[idx.long()] = new.to(old.dtype)
        return out
    return apply_op(g, [old_tensor, index_vector, new_tensor], "index_copy")


def index_array(data, axes=None):
    """out[i0, ..., ik, :] = (i0, ..., ik) over ``axes`` (all by
    default), int32 (the reference's int64 with 64-bit types off)."""
    def g(x):
        grids = torch.meshgrid(*[torch.arange(s, device=x.device)
                                 for s in x.shape], indexing="ij")
        ax = axes if axes is not None else range(x.dim())
        return torch.stack([grids[a] for a in ax], -1).to(torch.int32)
    return apply_op(g, [data], "index_array")


def getnnz(data, axis=None):
    """The count of nonzeros (over ``axis``), int32."""
    return apply_op(lambda x: (x != 0).sum(axis).to(torch.int32)
                    if axis is not None else (x != 0).sum().to(torch.int32),
                    [data], "getnnz")


def boolean_mask(data, index, axis=0):
    """The slices along ``axis`` where ``index`` is nonzero.  Its shape
    depends on the data: the selection is computed on the device and
    read by the host once."""
    def g(x, i):
        return x.index_select(axis, torch.nonzero(i.reshape(-1) != 0)
                              .reshape(-1))
    return apply_op(g, [data, index], "boolean_mask")


def dynamic_reshape(data, shape_like):
    """``data`` reshaped to the shape held in ``shape_like`` (read by the
    host)."""
    shp = [int(s) for s in (shape_like.asnumpy() if isinstance(
        shape_like, NDArray) else _onp.asarray(shape_like)).reshape(-1)]
    return apply_op(lambda x: x.reshape(shp), [data], "dynamic_reshape")


def div_sqrt_dim(data):
    """data / sqrt(data.shape[-1])."""
    return apply_op(lambda x: x / torch.tensor(
        _onp.sqrt(float(x.shape[-1])), dtype=x.dtype, device=x.device),
        [data], "div_sqrt_dim")


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    """1.0 or 0.0, float32 (``contrib/allclose_op.cc``)."""
    return apply_op(lambda x, y: torch.isclose(
        x, y.to(x.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan).all()
        .to(torch.float32), [a, b], "allclose")


def fft(data, compute_size=128):
    """The 1-D FFT of real rows, real and imaginary parts interleaved:
    (..., d) -> (..., 2d) float32."""
    def g(x):
        spec = torch.fft.fft(x.to(torch.complex64), dim=-1)
        return torch.view_as_real(spec).reshape(x.shape[:-1] +
                                                (2 * x.shape[-1],))
    return apply_op(g, [data], "fft")


def ifft(data, compute_size=128):
    """The inverse of :func:`fft`: interleaved (..., 2d) -> the real part
    (..., d), scaled by 1/d."""
    def g(x):
        d = x.shape[-1] // 2
        pairs = x.float().reshape(x.shape[:-1] + (d, 2)).contiguous()
        return torch.fft.ifft(torch.view_as_complex(pairs), dim=-1).real
    return apply_op(g, [data], "ifft")


def count_sketch(data, h, s, out_dim, processing_batch_size=32):
    """out[..., h[i]] += s[i] * data[..., i] (``count_sketch.cc``)."""
    def g(x, hh, ss):
        flat = x.reshape(-1, x.shape[-1])
        out = torch.zeros((flat.shape[0], int(out_dim)), dtype=x.dtype,
                          device=x.device)
        out.index_add_(1, hh.reshape(-1).long(),
                       flat * ss.reshape(-1).to(x.dtype)[None, :])
        return out.reshape(x.shape[:-1] + (int(out_dim),))
    return apply_op(g, [data, h, s], "count_sketch")


# ----------------------------------------------------------------------
# custom gradients
# ----------------------------------------------------------------------
class _GradScale(torch.autograd.Function):
    """Identity forward; the backward multiplies by ``scalar``."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return gy * ctx.scalar, None


def gradientmultiplier(data, scalar=1.0):
    """Identity forward, gradient times ``scalar`` (the gradient reversal
    layer's building block, ``gradient_multiplier_op.cc``)."""
    return apply_op(lambda x: _GradScale.apply(x, scalar), [data],
                    "gradientmultiplier")


class _STE(torch.autograd.Function):
    """``fn`` forward, the identity's gradient backward."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def round_ste(data):
    """round with a straight-through gradient (``stes_op.cc``)."""
    return apply_op(lambda x: _STE.apply(x, torch.round), [data],
                    "round_ste")


def sign_ste(data):
    """sign with a straight-through gradient (``stes_op.cc``)."""
    return apply_op(lambda x: _STE.apply(x, torch.sign), [data], "sign_ste")


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; the backward adds the KL sparseness penalty's
    gradient at the batch's mean activation."""

    @staticmethod
    def forward(ctx, x, target, penalty):
        ctx.save_for_backward(x.mean(0))
        ctx.target, ctx.penalty = target, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        (rho_hat,) = ctx.saved_tensors
        rho = ctx.target
        r = rho_hat.clamp(1e-6, 1 - 1e-6)
        pen = ctx.penalty * (-rho / r + (1 - rho) / (1 - r))
        return gy + pen[None] / gy.shape[0], None, None


def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    """Identity forward; the backward adds the KL-sparseness gradient of
    the batch's mean activation (``identity_attach_KL_sparse_reg.cc``).
    ``momentum`` is accepted and unused, as in the reference, which keeps
    no moving average across calls (DELTAS.md #14)."""
    return apply_op(lambda x: _KLSparseReg.apply(x, sparseness_target,
                                                 penalty), [data],
                    "IdentityAttachKLSparseReg")


# ----------------------------------------------------------------------
# Hawkes process log-likelihood (contrib/hawkes_ll-inl.h)
# ----------------------------------------------------------------------
def hawkesll(lda, alpha, beta, state, lags, marks, valid_length, max_time):
    """Log-likelihood of a marked multivariate Hawkes process with an
    exponential kernel, and the state after it: (loglik (N,), state (N,
    K)).  Each mark's excitation decays from its own last event; the
    compensators settle at ``max_time``.  A loop over the T events."""
    def g(mu, a, b, st, lg, mk, vl, mt):
        N, T = lg.shape
        K = mu.shape[1]
        rows = torch.arange(N, device=mu.device)
        ll = torch.zeros(N, dtype=mu.dtype, device=mu.device)
        state_t = st.clone()
        last = torch.zeros((N, K), dtype=mu.dtype, device=mu.device)
        t = torch.zeros(N, dtype=mu.dtype, device=mu.device)
        for j in range(T):
            ci = mk[:, j].long()
            valid = (j < vl).to(mu.dtype)
            t_new = t + lg[:, j]
            d = t_new - last[rows, ci]
            ed = torch.exp(-b[ci] * d)
            s_ci = state_t[rows, ci]
            lam = mu[rows, ci] + a[ci] * b[ci] * s_ci * ed
            comp = mu[rows, ci] * d + a[ci] * s_ci * (1 - ed)
            ll = ll + valid * (torch.log(torch.clamp(lam, min=1e-30)) - comp)
            on = valid > 0
            state_t = state_t.index_put((rows, ci),
                                        torch.where(on, 1 + s_ci * ed, s_ci))
            last = last.index_put((rows, ci),
                                  torch.where(on, t_new, last[rows, ci]))
            t = torch.where(on, t_new, t)
        d = mt[:, None] - last
        ed = torch.exp(-b[None, :] * d)
        ll = ll - (mu * d + a[None, :] * state_t * (1 - ed)).sum(1)
        return ll, state_t * ed
    return apply_op(g, [lda, alpha, beta, state, lags, marks, valid_length,
                        max_time], "hawkesll")
