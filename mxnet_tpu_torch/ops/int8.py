"""int8 kernels: the serving decode's int8 weight product, and
post-training quantization's quantize pass and int8 convolution;
hand-written CUDA on the card, their plain PyTorch versions on the CPU.

``int8_linear(x, q, scale)`` computes ``x @ dequantize(q, scale)ᵀ`` for
an int8 weight ``q`` with one per-tensor scale, the product the JAX
package's int8 decode leaves XLA to fuse (``_dequant`` then the matmul,
``mxnet_tpu/serve.py:902-938``).  On CUDA tensors it launches
``csrc/int8_linear.cu`` (W8A16: int8 read from HBM, dequantized in
registers) or raises; on CPU tensors it runs :func:`int8_linear_plain`.
:func:`int8_linear_group` runs up to three weights stacked by rows,
each with its own scale, in one launch (the decode's products that read
the same x).
The dequantized weight is ``q.to(dtype) * scale``, rounded in the
compute dtype, exactly as the JAX ``_dequant`` rounds it; the prefill
programs take it whole from :func:`dequantize` (the ``int8_dequant``
kernel on CUDA) and run one plain product.

Post-training quantization (``contrib.quantization``'s quantized layers,
``nd.contrib``'s int8 family) runs two kernels of ``csrc/int8_conv.cu``:
:func:`int8_quantize` (``clip(round(x / scale), -127, 127)`` to int8,
written NHWC with each group's channels padded to a multiple of 4 -- a
group of one channel, a depthwise layer's input, is not padded: its C
channels lie as one group, the row padded at its end -- tiled as
:func:`int8_quantize_plan` says) or :func:`int8_quantize_im2col` (the
same values as im2col rows, for one group of a channel count that is not
a multiple of 32: the stem), and :func:`int8_conv` (the int8 x int8 ->
int32 convolution, with a raw int32 or a scaled float epilogue; a Dense
product is its 1 x 1 convolution over (M, K, 1, 1), the im2col rows'
too), on the route :func:`int8_conv_route` picks (``wgmma`` for one
group of a multiple of 32 channels, planned by :func:`int8_conv_plan`; a
stencil for one channel a group, planned by :func:`int8_depthwise_plan`;
else ``mma.sync``).  :func:`int8_conv_mode` chooses between the two
quantize layouts from a layer's geometry, and :func:`quantized_conv`
runs the pair.  Weights are quantized and repacked once by
:func:`pack_conv_weight`.  Each equals its plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import math

import numpy as onp
import torch
import torch.nn.functional as F

from . import _build
from .cuda_ops import GENERAL_DTYPES, LAUNCHES, _is_cuda, refuse_export

__all__ = ["dequantize", "dequantize_plain", "int8_linear",
           "int8_linear_group", "int8_linear_group_plain",
           "int8_linear_plain", "int8_linear_plan", "int8_quantize",
           "int8_quantize_plain", "int8_quantize_plan",
           "int8_quantize_im2col", "int8_quantize_im2col_plain",
           "int8_conv", "int8_conv_plain", "int8_conv_mode",
           "int8_conv_route", "int8_conv_plan", "int8_depthwise_plan",
           "group_bytes", "pack_conv_weight", "padded_channels",
           "quantize_tensor", "quantized_conv"]


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
    refuse_export("int8_dequant")
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


#: the card's SMs (an H100 SXM), which the split-K plans fill
SMS = 132
#: most CTAs of a cluster splitting the depth (the portable limit)
MAX_SPLITS = 8
#: weight rows and k of one CTA stage of ``int8_linear``'s tensor-core
#: route (``LROWS``, ``LBK`` of csrc/int8_linear.cu), and the x rows a CTA
LINEAR_ROWS, LINEAR_BK, LINEAR_MT = 64, 128, 8
#: most weights one ``int8_linear`` launch takes (``MAX_SEGS``)
MAX_GROUP = 3


def int8_linear_plan(M, N, K):
    """The tensor-core route's launch: ``n_tiles`` x ``splits`` CTAs
    along x (a cluster of ``splits`` splits K's ``kt`` stages evenly:
    split ``s`` takes stages ``s * kt // splits`` up to ``(s + 1) * kt //
    splits``) by ``m_tiles`` along y.  K is split, in powers of two up to
    MAX_SPLITS, while the CTAs are fewer than the SMS (one CTA an SM:
    on the H100 faster than two or four) and every split keeps 2 stages
    or more."""
    n_tiles, m_tiles = -(-N // LINEAR_ROWS), -(-M // LINEAR_MT)
    kt = -(-K // LINEAR_BK)
    splits = 1
    while (splits < MAX_SPLITS and n_tiles * m_tiles * splits < SMS and
           kt >= 4 * splits):
        splits *= 2
    return {"n_tiles": n_tiles, "m_tiles": m_tiles, "splits": splits,
            "kt": kt}


def int8_linear_blocks(plan, M, N):
    """Each CTA of a tensor-core launch as ``(m0, m1, n0, n1, k0, k1)``:
    the x rows, weight rows and stages it sums, clipped to the problem,
    from the same index math as ``int8_linear_mma``."""
    S = plan["splits"]
    for by in range(plan["m_tiles"]):
        for bx in range(plan["n_tiles"] * S):
            split, n0 = bx % S, bx // S * LINEAR_ROWS
            yield (by * LINEAR_MT, min(M, by * LINEAR_MT + LINEAR_MT), n0,
                   min(N, n0 + LINEAR_ROWS), split * plan["kt"] // S,
                   (split + 1) * plan["kt"] // S)


def int8_linear(x, q, scale):
    """``y = x @ dequantize(q, scale)ᵀ``.

    ``x``: (M, K) float16, bfloat16, float32 or float64; ``q``: (N, K)
    int8; ``scale``: the weight's per-tensor scale, a Python float,
    rounded to ``x``'s dtype before use.  ``y``: (M, N) in ``x``'s dtype,
    summed in float32 (float64 for float64).  On CUDA both are
    contiguous and ``q`` starts on a 16-byte boundary; anything else
    raises.  float16 / bfloat16 with K a positive multiple of 16 on a
    16-byte boundary take the tensor-core kernel, its K split as
    :func:`int8_linear_plan` says; the rest the SIMT one."""
    return int8_linear_group(x, q, None, (scale,))[0]


def int8_linear_group_plain(x, q, rows, scales):
    """:func:`int8_linear_group` by :func:`int8_linear_plain`, a weight at
    a time."""
    out, r0 = [], 0
    for r, s in zip(rows, scales):
        out.append(int8_linear_plain(x, q[r0:r0 + r], s))
        r0 += r
    return tuple(out)


def int8_linear_group(x, q, rows, scales):
    """``x @ dequantize(q_i, s_i)ᵀ`` for up to MAX_GROUP weights ``q_i``
    stacked by rows in ``q`` (N, K): ``rows`` their row counts (None: one
    weight), ``scales`` their per-tensor scales.  A tuple of (M, rows_i)
    results, from one launch on CUDA: the decode's products that read
    the same x (wq, wk, wv; w1, w3) share the launch's ramp and tail.
    Each result is :func:`int8_linear`'s for its weight alone up to the
    order of the float32 sums (the depth split follows the stacked N);
    the plain version's exactly."""
    refuse_export("int8_linear")
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[1]:
        raise ValueError("int8_linear: x %s and q %s are not (M, K) and "
                         "(N, K)" % (tuple(x.shape), tuple(q.shape)))
    if q.dtype != torch.int8:
        raise TypeError("int8_linear: q must be int8, got %s" % q.dtype)
    M, K = x.shape
    N = q.shape[0]
    rows = (N,) if rows is None else tuple(int(r) for r in rows)
    if (not 1 <= len(rows) <= MAX_GROUP or len(scales) != len(rows) or
            sum(rows) != N or (len(rows) > 1 and min(rows) <= 0)):
        raise ValueError("int8_linear: rows %s and %d scales do not split "
                         "the %d rows of q into 1 to %d weights"
                         % (rows, len(scales), N, MAX_GROUP))
    if not _is_cuda(x, q):
        return int8_linear_group_plain(x, q, rows, scales)
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
    ys = tuple(torch.empty((M, r), dtype=x.dtype, device=x.device)
               for r in rows)
    if M == 0 or N == 0:
        return ys
    splits = int8_linear_plan(M, N, K)["splits"]
    n = len(rows)
    ptrs = (ctypes.c_void_p * n)(*(y.data_ptr() for y in ys))
    counts = (ctypes.c_int * n)(*rows)
    rounded = (ctypes.c_double * n)(*(torch.tensor(s, dtype=x.dtype).item()
                                      for s in scales))
    err = _build.library("int8_linear").mx_int8_linear(
        x.data_ptr(), q.data_ptr(), ctypes.addressof(ptrs),
        ctypes.addressof(counts), ctypes.addressof(rounded), n, M, N, K,
        code, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_linear kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["int8_linear"] += 1
    return ys


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
#: K2's tile, output bytes (``QTILE``): TP positions x TCB channels
QUANT_TILE = 4096
#: K2's threads a CTA (``QNT``) and the most CTAs its row kernel starts
QUANT_THREADS, QUANT_GRID_CAP = 256, 132 * 16
#: depth bytes an im2col row may hold (``COL_WORDS`` x 4); its rows are
#: padded to a multiple of IM2COL_ALIGN, the hopper route's channel step
IM2COL_MAX_K, IM2COL_ALIGN = 2048, 32
#: the quantized input patch an im2col CTA holds (``COL_PATCH``), and the
#: output positions a CTA aims at
IM2COL_PATCH, IM2COL_ROWS = 24576, 512
_CONV_ARGS = onp.dtype(
    [(k, "<u8") for k in ("x", "w", "out", "scale", "bias", "bias_i32")]
    + [(k, "<i8") for k in ("sN", "sC", "sP")]
    + [(k, "<i4") for k in ("N", "H", "W", "G", "Cgp", "Og", "KH", "KW",
                            "OH", "OW", "sh", "sw", "ph", "pw", "dh", "dw",
                            "Kreal", "Kp", "M", "out_kind", "relu",
                            "route", "cfg", "splits", "ctas", "th", "tw",
                            "cb")],
    align=True)
#: K3's routes (``ConvArgs.route``)
CONV_ROUTES = {"general": 0, "hopper": 1, "depthwise": 2}
#: depth bytes of one stage of the hopper route (``HBK``)
HOPPER_BK = 128
#: the hopper route's tile shapes (``ConvArgs.cfg``, ``HCfg`` of
#: csrc/int8_conv.cu): (consumer warpgroups, wgmma N, operands swapped,
#: CTAs an SM).  Unswapped, a tile is 64 x warpgroups positions by N
#: output channels; swapped (small M), 64 output channels by N positions.
HOPPER_CFGS = ((2, 64, False, 2), (2, 128, False, 1), (1, 32, True, 2),
               (1, 64, True, 2))


def padded_channels(cg):
    """A group's ``cg`` channels padded to the multiple of 4 the
    convolution reads in 4-byte words."""
    return (cg + 3) // 4 * 4


def group_bytes(C, groups):
    """The bytes one of ``groups`` groups of ``C`` channels takes in K2's
    NHWC layout: 1 where each group is one channel (a depthwise layer's
    input: its C channels unpadded, the row padded to a multiple of 4 at
    its end), else the group's channels padded to a multiple of 4."""
    return 1 if groups > 1 and C == groups else padded_channels(C // groups)


def _layout(C, groups):
    """K2's layout of C channels in ``groups`` groups as (groups, bytes a
    group): one-channel groups lie as one group of C channels."""
    if group_bytes(C, groups) == 1:
        return 1, padded_channels(C)
    return groups, padded_channels(C // groups)


def quantize_tensor(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8, in ``x``'s layout:
    float32 arithmetic, the division by a 0-dim float32 tensor on x's
    device (a true IEEE division: ATen divides by a Python scalar as a
    product with its reciprocal on CUDA), round half to even."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _nhwc_groups(q, groups):
    """(N, C, *spatial) -> (N, *spatial, G * Cgp) in K2's layout
    (:func:`_layout`), each group's channels padded with zeros."""
    N, C, sp = q.shape[0], q.shape[1], q.shape[2:]
    groups, cgp = _layout(C, groups)
    cg = C // groups
    q = q.reshape(N, groups, cg, -1).permute(0, 3, 1, 2)
    q = F.pad(q, (0, cgp - cg))
    return q.reshape(N, *sp, groups * cgp).contiguous()


def _int8_scale(x, scale):
    if x.dtype == torch.int8 and scale != 1.0:
        raise ValueError("int8_quantize: an int8 x is only laid out, at "
                         "scale 1, not %r" % (scale,))


def int8_quantize_plain(x, scale, groups=1):
    """The plain version of :func:`int8_quantize`, on any device."""
    _int8_scale(x, scale)
    q = x if x.dtype == torch.int8 else quantize_tensor(x, scale)
    return _nhwc_groups(q, groups)


def int8_quantize_plan(N, C, P, groups=1):
    """K2's launch for x (N, C, P) -> (N, P, G * Cgp).  ``"rows"`` where
    P == 1 (the Dense's (M, K)) or an output row is under 16 bytes (the
    stem's 4): ``quantize_kernel``, a thread a 4-byte word of one row,
    consecutive threads consecutive words, at most QUANT_GRID_CAP CTAs;
    else ``"tile"`` (``quantize_tile``): a CTA transposes ``positions``
    x ``tcb`` output bytes of one image, QUANT_TILE in all, ``tcb`` 128
    for rows wider than 64 bytes (a 128-byte line of each position),
    else the row rounded up to 16, 32 or 64; ``ptiles`` x ``ctiles``
    tiles an image, ``ctas`` in all.  One-channel groups take the layout
    of one group (:func:`_layout`)."""
    groups, cgp = _layout(C, groups)
    ctot = groups * cgp
    if P == 1 or ctot < 16:
        words = N * P * ctot // 4
        return {"kind": "rows", "tcb": 0, "ctas": min(
            -(-words // QUANT_THREADS), QUANT_GRID_CAP)}
    tcb = next(w for w in (16, 32, 64, 128) if ctot <= w or w == 128)
    tp = QUANT_TILE // tcb
    ptiles, ctiles = -(-P // tp), -(-ctot // tcb)
    return {"kind": "tile", "tcb": tcb, "positions": tp, "ptiles": ptiles,
            "ctiles": ctiles, "ctas": N * ptiles * ctiles}


def _quant_code(x, name):
    code = QUANT_DTYPES.get(x.dtype)
    if code is None:
        raise TypeError("%s takes float16, bfloat16, float32 or int8 x, got "
                        "%s" % (name, x.dtype))
    if not x.is_contiguous():
        raise ValueError("%s: x must be contiguous" % name)
    return code


def int8_quantize(x, scale, groups=1):
    """``x`` (N, C, *spatial) -- NCHW, or (M, K) -- in float16, bfloat16,
    float32 or int8, quantized with ``scale`` (a Python float, rounded to
    float32) into (N, *spatial, G * Cgp) int8: channels last, each of the
    ``groups`` groups' C / G channels padded with zeros to
    :func:`padded_channels`; where each group is one channel (depthwise),
    the C channels unpadded, as one group (G = 1, Cgp =
    ``padded_channels(C)``).  An int8 ``x`` takes ``scale`` 1 and is only
    laid out, its values (-128 included) unchanged.  The
    ``int8_quantize`` kernel on CUDA (one launch, planned by
    :func:`int8_quantize_plan`), :func:`int8_quantize_plain` on the CPU;
    the same bits.  Traced by ``torch.export``, it is the op
    ``mxnet_tpu_torch::int8_quantize``."""
    if torch.compiler.is_exporting():
        return torch.ops.mxnet_tpu_torch.int8_quantize(x, float(scale),
                                                       groups)
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError("int8_quantize: x of shape %s does not split into "
                         "%d groups of channels" % (tuple(x.shape), groups))
    _int8_scale(x, scale)
    if not x.is_cuda:
        return int8_quantize_plain(x, scale, groups)
    code = _quant_code(x, "int8_quantize")
    N, C, sp = x.shape[0], x.shape[1], x.shape[2:]
    groups, cgp = _layout(C, groups)
    q = torch.empty((N, *sp, groups * cgp), dtype=torch.int8,
                    device=x.device)
    if q.numel() == 0:
        return q
    P = math.prod(sp)
    err = _build.library("int8_conv").mx_int8_quantize(
        x.data_ptr(), q.data_ptr(), code, N, C, P, groups, cgp,
        int8_quantize_plan(N, C, P, groups)["tcb"], scale,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_quantize kernel launch failed: CUDA error "
                           "%d" % err)
    LAUNCHES["int8_quantize"] += 1
    return q


def _patch_bytes(geo, th, tw):
    kh, kw, sh, sw, dh, dw = (geo[i] for i in (5, 6, 7, 8, 11, 12))
    return ((th - 1) * sh + (kh - 1) * dh + 1) * \
        ((tw - 1) * sw + (kw - 1) * dw + 1) * geo[4]


def int8_im2col_plan(geo):
    """The im2col mode's launch for ``geo`` (:func:`_col_geometry`): a
    CTA takes ``th`` x ``tw`` output positions of one image, its input
    patch quantized into at most IM2COL_PATCH bytes of shared memory:
    whole output rows where their patch fits (else the widest share of a
    row, halving), then rows doubled while the patch fits, up to
    IM2COL_ROWS positions.  None where one position's patch is too
    big."""
    OH, OW = geo[13], geo[14]
    if _patch_bytes(geo, 1, 1) > IM2COL_PATCH:
        return None
    tw = OW
    while _patch_bytes(geo, 1, tw) > IM2COL_PATCH:
        tw = (tw + 1) // 2
    th = 1
    while (th < OH and th * tw < IM2COL_ROWS and
           _patch_bytes(geo, 2 * th, tw) <= IM2COL_PATCH):
        th *= 2
    ctas = geo[0] * -(-OH // th) * -(-OW // tw)
    return {"th": th, "tw": tw, "patch": _patch_bytes(geo, th, tw),
            "ctas": ctas}


def _col_geometry(shape, kernel, stride, padding, dilation):
    """The im2col rows' geometry for x of ``shape`` (N, C, H, W): (N, C,
    H, W, Cgp, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, Kc), the first 16
    ints of ``ColGeo`` of csrc/int8_conv.cu."""
    if len(shape) != 4:
        raise ValueError("int8_quantize_im2col: x of shape %s is not (N, C, "
                         "H, W)" % (tuple(shape),))
    N, C, H, W = shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, padding, dilation
    cgp = padded_channels(C)
    kc = -(-kh * kw * cgp // IM2COL_ALIGN) * IM2COL_ALIGN
    return (N, C, H, W, cgp, kh, kw, sh, sw, ph, pw, dh, dw,
            _out_size(H, kh, sh, ph, dh), _out_size(W, kw, sw, pw, dw), kc)


def int8_quantize_im2col_plain(x, scale, kernel, stride=(1, 1),
                               padding=(0, 0), dilation=(1, 1)):
    """The plain version of :func:`int8_quantize_im2col`, on any device:
    the quantized values (exact in float32) unfolded, each tap's channels
    padded to Cgp, the depth reordered to (kh, kw, c) c fastest and
    padded to Kc."""
    _int8_scale(x, scale)
    N, C, H, W, cgp, kh, kw, *_, OH, OW, kc = _col_geometry(
        x.shape, kernel, stride, padding, dilation)
    q = x if x.dtype == torch.int8 else quantize_tensor(x, scale)
    q = F.pad(q.float(), (0, 0, 0, 0, 0, cgp - C))
    cols = F.unfold(q, (kh, kw), dilation, padding, stride)
    cols = cols.reshape(N, cgp, kh * kw, OH * OW).permute(0, 3, 2, 1)
    cols = F.pad(cols.reshape(N, OH, OW, kh * kw * cgp),
                 (0, kc - kh * kw * cgp))
    return cols.to(torch.int8).contiguous()


def int8_quantize_im2col(x, scale, kernel, stride=(1, 1), padding=(0, 0),
                         dilation=(1, 1)):
    """``x`` (N, C, H, W) in float16, bfloat16, float32 or int8 (one
    group), quantized as :func:`int8_quantize` does and laid out as the
    im2col rows of a ``kernel`` convolution: (N, OH, OW, Kc) int8, the
    depth (kh, kw, c) c fastest with the channels padded to Cgp (the
    order of a :func:`pack_conv_weight` row), zeros outside the image and
    past KH * KW * Cgp, Kc that depth rounded up to IM2COL_ALIGN.  A 1 x
    1 :func:`int8_conv` of these rows with the layer's packed weight is
    the layer's convolution.  The ``int8_quantize`` kernel's im2col mode
    on CUDA (one launch), :func:`int8_quantize_im2col_plain` on the CPU;
    the same bits.  Traced by ``torch.export``, it is the op
    ``mxnet_tpu_torch::int8_quantize_im2col``."""
    if torch.compiler.is_exporting():
        return torch.ops.mxnet_tpu_torch.int8_quantize_im2col(
            x, float(scale), kernel, stride, padding, dilation)
    geo = _col_geometry(x.shape, kernel, stride, padding, dilation)
    _int8_scale(x, scale)
    if not x.is_cuda:
        return int8_quantize_im2col_plain(x, scale, kernel, stride, padding,
                                          dilation)
    code = _quant_code(x, "int8_quantize_im2col")
    N, OH, OW, kc = geo[0], geo[13], geo[14], geo[15]
    plan = int8_im2col_plan(geo)
    if kc > IM2COL_MAX_K or plan is None or \
            min(geo[:9] + geo[11:]) <= 0 or min(geo[9:11]) < 0:
        raise ValueError("int8_quantize_im2col: geometry %s has no im2col "
                         "rows (depth at most %d bytes, a position's "
                         "patch at most %d)" % (geo, IM2COL_MAX_K,
                                                IM2COL_PATCH))
    q = torch.empty((N, OH, OW, kc), dtype=torch.int8, device=x.device)
    ints = (ctypes.c_int * 18)(*geo, plan["th"], plan["tw"])   # alive
    err = _build.library("int8_conv").mx_int8_quantize_im2col(
        x.data_ptr(), q.data_ptr(), code, ctypes.addressof(ints), scale,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("int8_quantize im2col kernel launch failed: CUDA "
                           "error %d" % err)
    LAUNCHES["int8_quantize"] += 1
    LAUNCHES["int8_quantize_im2col"] += 1
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
    """Check the operands; (N, H, W, Cgp, O, OH, OW), Cgp the bytes of a
    group in xq (1 for one unpadded channel a group: a depthwise
    layer's input, (N, H, W, padded_channels(G)))."""
    if xq.dtype != torch.int8 or wpk.dtype != torch.int8:
        raise TypeError("int8_conv: xq and the packed weight must be int8, "
                        "got %s / %s" % (xq.dtype, wpk.dtype))
    ctot = xq.shape[-1] if xq.dim() else 0
    depthwise = groups > 1 and ctot == padded_channels(groups)
    if xq.dim() != 4 or wpk.dim() != 3 or wpk.shape[0] != groups or \
            (ctot % groups and not depthwise):
        raise ValueError("int8_conv: xq %s is not (N, H, W, G * Cgp) or the "
                         "weight %s not (G, O / G, Kp) for %d groups"
                         % (tuple(xq.shape), tuple(wpk.shape), groups))
    N, H, W, _ = xq.shape
    cgp = 1 if depthwise else ctot // groups
    kh, kw = kernel
    if (cgp % 4 and not depthwise) or wpk.shape[2] % CONV_BK or \
            wpk.shape[2] < kh * kw * padded_channels(cgp):
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
    wc = padded_channels(cgp)                    # a tap of a weight row
    x = xq[..., :groups * cgp].permute(0, 3, 1, 2).double()
    w = wpk[:, :, :kh * kw * wc].reshape(groups, -1, kh, kw, wc)[..., :cgp]
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


def int8_conv_route(N, H, W, cgp, groups):
    """K3's route for an input (N, H, W, G * Cgp), ``cgp`` the bytes of a
    group (:func:`group_bytes`): ``"depthwise"`` (``conv_depthwise``) for
    one unpadded channel a group; ``"hopper"`` (wgmma) for one group
    whose channels are a multiple of 32 and whose input has fewer than
    2^31 bytes; else ``"general"`` (``conv_kernel``: groups of two or
    more channels, odd channel counts)."""
    if groups > 1 and cgp == 1:
        return "depthwise"
    if groups == 1 and cgp % 32 == 0 and N * H * W * cgp < 2 ** 31:
        return "hopper"
    return "general"


#: the depthwise route's channels a tile (``DW_CB`` of csrc/int8_conv.cu)
#: and the most shared memory a CTA may take
DEPTHWISE_CB, DEPTHWISE_SMEM = 32, 232448


def _dw_patch(th, tw, cb, kernel, stride, dilation):
    """The input patch of th x tw output positions: (rows, columns, words
    a channel's row, words a channel (odd), bytes of its cb channels)."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    ph = (th - 1) * sh + (kh - 1) * dh + 1
    pw = (tw - 1) * sw + (kw - 1) * dw + 1
    rw = -(-pw // 4)
    plane = ph * rw | 1
    return ph, pw, rw, plane, 4 * cb * plane


def int8_depthwise_plan(N, C, OH, OW, kernel, stride=(1, 1),
                        dilation=(1, 1)):
    """The depthwise route's launch for C one-channel groups: a CTA of
    256 threads takes a tile of one image, ``cb`` channels (DEPTHWISE_CB)
    and ``th`` x ``tw`` output positions (``tw`` 32, halved to 16 or 8
    for narrower rows; ``th`` 8, or 4 at stride 2 and more with ``tw``
    32), its input patch staged channel-major in ``smem`` bytes of shared
    memory (``ph`` rows of ``rw`` words a channel, ``plane`` words a
    channel); the rows, then the channels, halve until the patch fits in
    DEPTHWISE_SMEM.  ``ctas`` = N x ``c_tiles`` x ``h_tiles`` x
    ``w_tiles``.  None where one row of 4 channels does not fit."""
    tw = 32
    while tw > 8 and tw // 2 >= OW:
        tw //= 2
    th, cb = 8 if stride[0] == 1 or tw < 32 else 4, DEPTHWISE_CB
    while (_dw_patch(th, tw, cb, kernel, stride, dilation)[4] >
           DEPTHWISE_SMEM and (th > 1 or cb > 4)):
        if th > 1:
            th //= 2
        else:
            cb //= 2
    ph, pw, rw, plane, smem = _dw_patch(th, tw, cb, kernel, stride,
                                        dilation)
    if smem > DEPTHWISE_SMEM:
        return None
    c_tiles = -(-C // cb)
    h_tiles, w_tiles = -(-OH // th), -(-OW // tw)
    return {"th": th, "tw": tw, "cb": cb, "ph": ph, "pw": pw, "rw": rw,
            "plane": plane, "smem": smem, "c_tiles": c_tiles,
            "h_tiles": h_tiles, "w_tiles": w_tiles,
            "ctas": N * c_tiles * h_tiles * w_tiles}


def int8_depthwise_blocks(plan, C, OH, OW, kernel, stride=(1, 1),
                          padding=(0, 0), dilation=(1, 1)):
    """Each CTA of a depthwise launch, from the same index math as
    ``conv_depthwise``, as a dict: its image ``n``, channels [c0, c1) and
    output tile [oh0, oh1) x [ow0, ow1), clipped to the problem; the
    input corner of its patch (``ih0``, ``iw0``); ``units``, the staging
    units in the order the kernel numbers them, each (channel quad,
    position quad, patch row, the word of its first channel); and
    ``taps``, the byte of a channel's staged patch that the tap (r, q)
    of the tile's output (i, j) reads, (th, tw, kh, kw)."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    th, tw, cb, rw = plan["th"], plan["tw"], plan["cb"], plan["rw"]
    u = onp.arange(plan["ph"] * rw * (cb // 4))
    cq, rest = u % (cb // 4), u // (cb // 4)
    pq, pr = rest % rw, rest // rw
    units = onp.stack([cq, pq, pr, 4 * cq * plan["plane"] + pr * rw + pq], 1)
    i, j, r, q = onp.ogrid[:th, :tw, :kh, :kw]
    taps = (i * sh + r * dh) * rw * 4 + j * sw + q * dw
    for b in range(plan["ctas"]):
        t_w, rest = b % plan["w_tiles"], b // plan["w_tiles"]
        t_h, rest = rest % plan["h_tiles"], rest // plan["h_tiles"]
        c_t, n = rest % plan["c_tiles"], rest // plan["c_tiles"]
        oh0, ow0 = t_h * th, t_w * tw
        yield {"n": n, "c0": c_t * cb, "c1": min(C, c_t * cb + cb),
               "oh0": oh0, "oh1": min(OH, oh0 + th), "ow0": ow0,
               "ow1": min(OW, ow0 + tw), "ih0": oh0 * sh - padding[0],
               "iw0": ow0 * sw - padding[1], "units": units, "taps": taps}


def int8_conv_mode(N, C, H, W, kernel, stride=(1, 1), padding=(0, 0),
                   dilation=(1, 1), groups=1):
    """How a quantized convolution of x (N, C, H, W) reads its input, and
    on which K3 route: ``("nhwc", "depthwise")`` for one channel a group;
    ``("im2col", "hopper")`` for one group whose padded channels are not
    a multiple of 32 (the stem's 3 -> 4), where the im2col rows fit
    (depth at most IM2COL_MAX_K, one position's patch in IM2COL_PATCH
    bytes, int offsets): a 1 x 1 convolution over Kc channels, which the
    hopper route takes; else ``("nhwc", int8_conv_route(...))``."""
    cgp = group_bytes(C, groups)
    if groups == 1 and cgp % 32:
        geo = _col_geometry((N, C, H, W), kernel, stride, padding, dilation)
        OH, OW, kc = geo[13:]
        if (kc <= IM2COL_MAX_K and OH > 0 and OW > 0 and
                int8_im2col_plan(geo) is not None and C * H * W < 2 ** 31 and
                int8_conv_route(N, OH, OW, kc, 1) == "hopper"):
            return "im2col", "hopper"
    return "nhwc", int8_conv_route(N, H, W, cgp, groups)


def quantized_conv(x, act_scale, wpk, kernel, stride=(1, 1), padding=(0, 0),
                   dilation=(1, 1), groups=1, **epilogue):
    """``x`` (N, C, H, W) quantized with ``act_scale`` and convolved with
    the packed weight ``wpk``: :func:`int8_quantize` then
    :func:`int8_conv`, or where :func:`int8_conv_mode` says so
    :func:`int8_quantize_im2col` then the rows' 1 x 1 :func:`int8_conv`
    (the same bits).  ``epilogue``: :func:`int8_conv`'s keywords."""
    N, C, H, W = x.shape
    mode, _ = int8_conv_mode(N, C, H, W, kernel, stride, padding, dilation,
                             groups)
    if mode == "im2col":
        cols = int8_quantize_im2col(x, act_scale, kernel, stride, padding,
                                    dilation)
        return int8_conv(cols, wpk, (1, 1), **epilogue)
    xq = int8_quantize(x, act_scale, groups)
    return int8_conv(xq, wpk, kernel, stride, padding, dilation, groups,
                     **epilogue)


def int8_conv_plan(M, O, Kp):
    """The hopper route's launch: a dict of the tile shape ``cfg`` (an
    index of HOPPER_CFGS), the tiles of positions and channels, the depth
    split and the CTAs.  ``splits`` CTAs (a power of two up to
    MAX_SPLITS, one cluster) split each tile's ``kt`` stages, split ``s``
    taking stages ``s * kt // splits`` up to ``(s + 1) * kt // splits``;
    then there are ``ctas`` = tiles x splits, one tile a cluster.
    Unsplit, ``ctas`` persistent CTAs (as many as the card holds at
    once, at most one a tile) take tiles c, c + ctas, ...

    M <= 64 positions (the Dense) swap the operands.  Otherwise a tile is
    128 positions by 128 channels, or by 64 where O <= 64 or the wider
    tiles would leave SMs idle.  Where the tiles fill less than the
    card's CTA slots, the depth is split while every split keeps 2
    stages or more."""
    kt = -(-Kp // HOPPER_BK)
    if M <= 64:
        cfg = 2 if M <= 32 else 3
    elif O <= 64 or -(-M // 128) * -(-O // 128) < SMS:
        cfg = 0
    else:
        cfg = 1
    nwg, n, swap, per_sm = HOPPER_CFGS[cfg]
    pr, wr = (n, 64 * nwg) if swap else (64 * nwg, n)
    m_tiles, o_tiles = -(-M // pr), -(-O // wr)
    tiles = m_tiles * o_tiles
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits * 2 <= SMS * per_sm and
           kt >= 4 * splits):
        splits *= 2
    ctas = tiles * splits if splits > 1 else min(tiles, SMS * per_sm)
    return {"cfg": cfg, "swap": swap, "positions": pr, "channels": wr,
            "m_tiles": m_tiles, "o_tiles": o_tiles, "splits": splits,
            "kt": kt, "ctas": ctas}


def int8_conv_blocks(plan, M, O):
    """Each (CTA, tile) of a hopper launch as ``(m0, m1, o0, o1, k0,
    k1)``: the positions, output channels and depth stages it sums,
    clipped to the problem, from the same index math as
    ``conv_hopper``."""
    pr, wr, S = plan["positions"], plan["channels"], plan["splits"]
    b_tiles = plan["m_tiles"] if plan["swap"] else plan["o_tiles"]
    tiles = plan["m_tiles"] * plan["o_tiles"]
    clusters = plan["ctas"] // S
    for bx in range(plan["ctas"]):
        split, cluster = bx % S, bx // S
        for t in range(cluster, tiles, clusters):
            a, b = t // b_tiles, t % b_tiles
            mt, ot = (b, a) if plan["swap"] else (a, b)
            yield (mt * pr, min(M, mt * pr + pr), ot * wr,
                   min(O, ot * wr + wr), split * plan["kt"] // S,
                   (split + 1) * plan["kt"] // S)


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
    ``channels_last``.  On CUDA one launch of the ``int8_conv`` kernel on
    the route :func:`int8_conv_route` picks, :func:`int8_conv_plain` on
    the CPU; the same bits.  Traced by ``torch.export``, it is the op
    ``mxnet_tpu_torch::int8_conv``."""
    if torch.compiler.is_exporting():
        return torch.ops.mxnet_tpu_torch.int8_conv(
            xq, wpk, kernel, stride, padding, dilation, groups, scale, bias,
            bool(relu), out_dtype, bias_i32, bool(channels_last))
    return _int8_conv(xq, wpk, kernel, stride, padding, dilation, groups,
                      scale, bias, relu, out_dtype, bias_i32, channels_last)


def _int8_conv(xq, wpk, kernel, stride=(1, 1), padding=(0, 0),
               dilation=(1, 1), groups=1, scale=None, bias=None, relu=False,
               out_dtype=torch.float32, bias_i32=None, channels_last=False,
               route=None):
    """:func:`int8_conv` on ``route`` (None: :func:`int8_conv_route`'s;
    ``"general"`` forces the general kernel, which the card's checks time
    beside the other routes -- on a depthwise input through a copy with
    each channel padded to the 4 bytes that kernel reads; ``"hopper"`` or
    ``"depthwise"`` on a shape it does not take raises)."""
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
    own = int8_conv_route(N, H, W, cgp, groups)
    if route is None:
        route = own
    if route not in CONV_ROUTES or route not in ("general", own):
        raise ValueError("int8_conv: no route %r for %d groups of %d "
                         "channels" % (route, groups, cgp))
    plan = None
    if route == "depthwise":
        plan = int8_depthwise_plan(N, groups, OH, OW, kernel, stride,
                                   dilation)
        if plan is None:
            raise ValueError("int8_conv: a %dx%d kernel (dilation %s) has "
                             "a patch larger than a CTA's shared memory"
                             % (*kernel, tuple(dilation)))
    elif own == "depthwise":
        xq = F.pad(xq[..., :groups, None], (0, 3)).reshape(N, H, W,
                                                         4 * groups)
        cgp = 4
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
                        "Kp", "M", "out_kind", "relu", "route"),
                       (N, H, W, groups, cgp, O // groups, kh, kw, OH, OW,
                        *stride, *padding, *dilation,
                        kh * kw * padded_channels(cgp), wpk.shape[2], N * P,
                        kind, int(bool(relu)), CONV_ROUTES[route])):
        a[name] = v
    if route == "hopper":
        plan = int8_conv_plan(N * P, O, wpk.shape[2])
        for name in ("cfg", "splits", "ctas"):
            a[name] = plan[name]
    elif route == "depthwise":
        for name in ("th", "tw", "cb", "ctas"):
            a[name] = plan[name]
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
    LAUNCHES["int8_conv_" + route] += 1
    return out


# ---------------------------------------------------------------------------
# K2 and K3 as torch.library ops, for programs ``torch.export`` writes
# ---------------------------------------------------------------------------
# An exported forward (``HybridBlock.export``) holds each K2 / K3 call as
# one of these ops: the CPU runs the plain version, CUDA the kernel, and
# the fake version gives the output's shape while the forward is traced.
# Eager calls do not pass through them.
_LIB = "mxnet_tpu_torch::"


def _op(name, schema, cpu, cuda, fake):
    op = torch.library.custom_op(_LIB + name, cpu, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)


def _quantize_fake(x, scale, groups):
    groups, cgp = _layout(x.shape[1], groups)
    return x.new_empty((x.shape[0], *x.shape[2:], groups * cgp),
                       dtype=torch.int8)


def _im2col_fake(x, scale, kernel, stride, padding, dilation):
    geo = _col_geometry(x.shape, kernel, stride, padding, dilation)
    return x.new_empty((geo[0], geo[13], geo[14], geo[15]),
                       dtype=torch.int8)


def _conv_fake(xq, wpk, kernel, stride, padding, dilation, groups, scale,
               bias, relu, out_dtype, bias_i32, channels_last):
    N, H, W, _, O, OH, OW = _conv_args(xq, wpk, kernel, stride, padding,
                                       dilation, groups)
    return xq.new_empty((N, OH, OW, O) if channels_last else (N, O, OH, OW),
                        dtype=out_dtype)


_op("int8_quantize", "(Tensor x, float scale, int groups) -> Tensor",
    int8_quantize_plain, int8_quantize, _quantize_fake)
_op("int8_quantize_im2col", "(Tensor x, float scale, int[] kernel, "
    "int[] stride, int[] padding, int[] dilation) -> Tensor",
    int8_quantize_im2col_plain, int8_quantize_im2col, _im2col_fake)
_op("int8_conv", "(Tensor xq, Tensor wpk, int[] kernel, int[] stride, "
    "int[] padding, int[] dilation, int groups, Tensor? scale, "
    "Tensor? bias, bool relu, ScalarType out_dtype, Tensor? bias_i32, "
    "bool channels_last) -> Tensor", int8_conv_plain, _int8_conv,
    _conv_fake)
