"""Post-training int8 quantization, and the int8 weights of serving.

Counterpart of ``mxnet_tpu/contrib/quantization.py`` (the reference's
``python/mxnet/contrib/quantization.py``):

* the calibration math on the host, in numpy, the reference's algorithm
  as the JAX package writes it: :func:`_smooth_distribution`,
  :func:`_kl_divergence`, :func:`optimal_threshold` (the KL threshold
  search) and :func:`_entropy_scale`;
* :func:`quantize_array` (``clip(round(x / scale), -127, 127)``);
* :class:`QuantizedDense` and :class:`QuantizedConv2D`, ``HybridBlock``s
  that quantize their input with the ``int8_quantize`` kernel and run the
  ``int8_conv`` kernel (int8 x int8 -> int32 on the tensor cores, then
  the scaled float epilogue): a Dense product is its 1 x 1 convolution.
  Hybridized, both are captured into the net's CUDA graphs;
* :func:`quantize_net`, which calibrates activation scales through
  forward pre-hooks (``calib_mode`` "naive": running max |x|; "entropy":
  a histogram re-binned as the range grows, then the KL threshold) and
  swaps each supported layer in place;
* :func:`quantized_elemwise_add`, :func:`quantized_concat` and
  :func:`quantize_model` (which raises, as the reference's does).

The scales round as the reference's do: a convolution's per-channel
``w_scale`` is float32 ``max(absmax, 1e-12) / 127`` and its output scale
``f32(a_scale) * w_scale`` in float32; a Dense's weight scale is
``max|w| / 127`` and its output scale ``f32(a_scale * w_scale)``, the
product taken in float64.  The reference's ``QuantizedConv2D`` computes
NCHW / OIHW whatever the layer's layout, which is wrong for a
channels-last layer; the port refuses one.

The serving replica's int8 path: per-tensor int8 weights for ``Dense``
layers.  The weights are quantized by ``serve.quantize_weights``;
:func:`int8_weights` is a scope inside which each named ``Dense`` reads
its int8 weight instead of its own parameter, which stays as it is, so
one process can serve a net in its own dtype and in int8 at once (the
JAX warm pool swaps the parameters per program instead,
``serve.py:985``).  The route is the program's: ``"decode"`` runs the
W8A16 kernel (``ops.int8``, int8 read from HBM), ``"prefill"``
dequantizes the weight into a transient and runs one plain product, as
the JAX prefill program does.
"""
from __future__ import annotations

import contextlib
import re
import threading

import numpy as _onp
import torch
import torch.nn.functional as F

from ..gluon.block import HybridBlock
from ..gluon.parameter import is_deferred
from ..ndarray.contrib import _f32, _range_scalar, _t
from ..ndarray.ndarray import NDArray
from ..ops import int8 as _int8
from ..ops import nn as _nn
from ..ops.int8 import dequantize, int8_linear, int8_linear_group

__all__ = ["Int8Weight", "int8_weights", "int8_forward", "optimal_threshold",
           "quantize_array", "QuantizedDense", "QuantizedConv2D",
           "quantize_net", "quantized_elemwise_add", "quantized_concat",
           "quantize_model"]

ROUTES = ("decode", "prefill")


def _minmax_scale(arr, num_bits=8):
    """max|arr| / 127 as a Python float (1 / 127 for an all-zero array);
    ``arr`` a tensor or a numpy array."""
    amax = float(arr.abs().max() if torch.is_tensor(arr)
                 else _onp.abs(arr).max()) or 1.0
    return amax / (2 ** (num_bits - 1) - 1)


def _smooth_distribution(p, eps=1e-4):
    """Replace zeros with eps mass taken off the nonzero entries
    (reference ``calibrate.cc:37`` SmoothDistribution); None for a
    malformed (all-zero) distribution."""
    is_zero = p == 0
    n_zeros = int(is_zero.sum())
    n_nonzeros = p.size - n_zeros
    if n_nonzeros == 0:
        return None
    eps1 = eps * n_zeros / n_nonzeros
    if eps1 >= 1.0:
        return None
    return p + eps * is_zero - eps1 * (~is_zero)


def _kl_divergence(p, q):
    p = p / p.sum()
    q = q / q.sum()
    mask = (p > 0) & (q > 0)
    return float((p[mask] * _onp.log(p[mask] / q[mask])).sum())


def optimal_threshold(hist, hist_edges, num_quantized_bins=255):
    """The reference's entropy (KL) threshold search
    (``src/operator/quantization/calibrate.cc:88-167``) on a symmetric
    histogram over [-th, th]: for each candidate truncation, the clipped
    distribution p (outliers folded into the edge bins) against its
    ``num_quantized_bins``-level re-quantization q; the threshold of the
    least KL(p || q) wins.  Returns (threshold, divergence)."""
    hist = _onp.asarray(hist, _onp.float64)
    hist_edges = _onp.asarray(hist_edges, _onp.float64)
    num_bins = hist.size
    zero_bin = num_bins // 2
    half_q = num_quantized_bins // 2
    best_div, best_t = float("inf"), hist_edges[-1]
    for i in range(half_q, zero_bin + 1):
        start = zero_bin - i
        stop = zero_bin + i + 1
        threshold = hist_edges[stop]
        sliced = hist[start:stop].copy()
        p = sliced.copy()
        # the tails fold into the edge bins; the first in-slice bin is the
        # boundary (the reference puts hist[start] into p[0] and leaves
        # sliced[0] = 0)
        p[0] = hist[:start + 1].sum()
        sliced[0] = 0
        p[-1] += hist[stop:].sum()
        num_merged = sliced.size // num_quantized_bins
        if num_merged == 0:
            continue
        # merge into the quantized distribution, the tail into the last
        # level
        qbins = _onp.add.reduceat(
            sliced[:num_quantized_bins * num_merged],
            _onp.arange(num_quantized_bins) * num_merged)
        qbins[-1] += sliced[num_quantized_bins * num_merged:].sum()
        # each level spread uniformly over its nonzero source bins
        nz = (sliced != 0).astype(_onp.int64)
        starts = _onp.arange(num_quantized_bins) * num_merged
        norms = _onp.add.reduceat(nz[:num_quantized_bins * num_merged],
                                  starts)
        norms[-1] += nz[num_quantized_bins * num_merged:].sum()
        seg_lens = _onp.full(num_quantized_bins, num_merged)
        seg_lens[-1] = sliced.size - (num_quantized_bins - 1) * num_merged
        vals = _onp.where(norms > 0, qbins / _onp.maximum(norms, 1), 0.0)
        q = _onp.where(p != 0, _onp.repeat(vals, seg_lens), 0.0)
        ps = _smooth_distribution(p)
        qs = _smooth_distribution(q)
        div = float("inf") if qs is None or ps is None \
            else _kl_divergence(ps, qs)
        if div < best_div:
            best_div, best_t = div, threshold
    return best_t, best_div


def _entropy_scale(arr, num_bins=8001, num_quantized_bins=255):
    """KL-divergence calibration over a symmetric histogram (reference
    ``quantization.py:247`` get_optimal_threshold)."""
    arr = _onp.asarray(arr).ravel()
    th = float(max(abs(arr.min()), abs(arr.max()))) or 1.0
    hist, edges = _onp.histogram(arr, bins=num_bins, range=(-th, th))
    t, _ = optimal_threshold(hist, edges, num_quantized_bins)
    return t / 127.0


def quantize_array(x, scale):
    """``clip(round(x / scale), -127, 127)`` as int8 (``x`` a tensor, an
    NDArray or a numpy array; an NDArray in gives an NDArray out): the
    ``ops.int8.quantize_tensor`` arithmetic, float32 with an IEEE
    division and round half to even."""
    q = _int8.quantize_tensor(_t(x), scale)
    return NDArray(q) if isinstance(x, NDArray) else q


def _epilogue(y, act, dtype):
    """The activation the kernel does not apply (all but relu), then the
    output dtype."""
    if act is not None and act != "relu":
        y = _nn.activation(y, act)
    return y.to(dtype)


class QuantizedDense(HybridBlock):
    """int8 x int8 -> int32 Dense with static scales: the input quantized
    with ``act_scale`` (the ``int8_quantize`` kernel), the weight with its
    per-tensor max (once), the product the ``int8_conv`` kernel's 1 x 1
    convolution over (M, K, 1, 1) with the float epilogue."""

    def __init__(self, dense, act_scale):
        super().__init__()
        w = dense.weight.detach().float()
        self._w_scale = _minmax_scale(w)
        wq = _int8.quantize_tensor(w, self._w_scale)
        self._units, self._in_units = wq.shape
        self.register_buffer("_wpk", _int8.pack_conv_weight(
            wq.reshape(*wq.shape, 1, 1), 1), persistent=False)
        self._act_scale = act_scale
        self.register_buffer("_scale", torch.full(
            (self._units,), act_scale * self._w_scale, dtype=torch.float32,
            device=w.device), persistent=False)
        self.register_buffer("_bias", None if dense.bias is None else
                             dense.bias.detach().float().clone(),
                             persistent=False)
        self._flatten = dense._flatten
        self._activation = dense._activation

    def forward(self, x):
        if self._flatten and x.dim() > 2:
            x = x.reshape(x.shape[0], -1)
        lead = x.shape[:-1]
        a = x.reshape(-1, x.shape[-1])
        xq = _int8.int8_quantize(a, self._act_scale)
        act = self._activation
        y = _int8.int8_conv(
            xq.reshape(xq.shape[0], 1, 1, xq.shape[1]), self._wpk, (1, 1),
            scale=self._scale, bias=self._bias, relu=act == "relu",
            out_dtype=x.dtype if act in (None, "relu") else torch.float32)
        return _epilogue(y.reshape(*lead, self._units), act, x.dtype)


class QuantizedConv2D(HybridBlock):
    """int8 x int8 -> int32 convolution with per-output-channel weight
    scales (reference ``src/operator/quantization/quantized_conv.cc:1``;
    channel-wise weight scaling as the oneDNN backend does): the
    ``int8_quantize`` kernel (in its im2col mode where
    ``ops.int8.int8_conv_mode`` says so: the stem), then the ``int8_conv``
    kernel on the tensor cores, its float epilogue writing NCHW in the
    input's dtype.  NCHW layers only."""

    def __init__(self, conv, act_scale):
        super().__init__()
        if conv._channels_last:
            raise NotImplementedError(
                "QuantizedConv2D takes NCHW convolutions; this one is %s "
                "(the JAX package's QuantizedConv2D computes NCHW / OIHW "
                "whatever the layout, which is wrong for channels-last)"
                % conv._layout)
        w = conv.weight.detach().float()
        absmax = _onp.abs(w.cpu().numpy()).reshape(w.shape[0], -1) \
            .max(axis=1)
        self._w_scale = (_onp.maximum(absmax, 1e-12) / 127.0) \
            .astype(_onp.float32)
        ws = torch.from_numpy(self._w_scale).to(w.device)
        wq = torch.clamp(torch.round(w / ws.reshape(-1, 1, 1, 1)), -127,
                         127).to(torch.int8)
        self._groups = conv._groups
        self.register_buffer("_wpk", _int8.pack_conv_weight(
            wq, self._groups), persistent=False)
        self._act_scale = float(act_scale)
        self.register_buffer("_scale", torch.from_numpy(
            (_onp.float32(self._act_scale) * self._w_scale)
            .astype(_onp.float32)).to(w.device), persistent=False)
        self.register_buffer("_bias", None if conv.bias is None else
                             conv.bias.detach().float().clone(),
                             persistent=False)
        self._kernel = tuple(w.shape[2:])
        self._strides = conv._strides
        self._padding = conv._padding
        self._dilation = conv._dilation
        self._activation = conv._activation

    def forward(self, x):
        act = self._activation
        y = _int8.quantized_conv(
            x, self._act_scale, self._wpk, self._kernel, self._strides,
            self._padding, self._dilation, self._groups, scale=self._scale,
            bias=self._bias, relu=act == "relu",
            out_dtype=x.dtype if act in (None, "relu") else torch.float32)
        return _epilogue(y, act, x.dtype)


class _Collector:
    """Streaming activation-range collector (calib_mode minmax /
    entropy): minmax keeps a running max |x|, entropy a running symmetric
    histogram re-binned on range growth (the reference's
    ``_LayerHistogramCollector.combine_histogram``), in numpy on the
    host."""

    NUM_BINS = 8001

    def __init__(self, mode):
        self.mode = mode
        self.stats = {}

    def hook(self, name):
        def _h(block, inputs):
            x = inputs[0]
            if isinstance(x, NDArray):
                x = x._data
            if torch.is_tensor(x):
                self._update(name, x)
        return _h

    def _update(self, name, x):
        if self.mode != "entropy":
            amax = float(x.detach().abs().max())
            self.stats[name] = max(self.stats.get(name, 0.0), amax)
            return
        x = x.detach()
        arr = (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
        th = float(max(abs(float(arr.min())), abs(float(arr.max())))) \
            or 1e-8
        if name not in self.stats:
            hist, _ = _onp.histogram(arr, bins=self.NUM_BINS,
                                     range=(-th, th))
            self.stats[name] = [hist.astype(_onp.int64), th]
            return
        hist, old_th = self.stats[name]
        if th <= old_th:
            h2, _ = _onp.histogram(arr, bins=hist.size,
                                   range=(-old_th, old_th))
            self.stats[name][0] = hist + h2
        else:
            old_step = 2 * old_th / hist.size
            half_inc = int((th - old_th) // old_step + 1)
            new_num = 2 * half_inc + hist.size
            new_th = half_inc * old_step + old_th
            h2, _ = _onp.histogram(arr, bins=new_num, range=(-new_th,
                                                             new_th))
            h2 = h2.astype(_onp.int64)
            h2[half_inc:new_num - half_inc] += hist
            self.stats[name] = [h2, new_th]

    def scale(self, name):
        if self.mode != "entropy":
            return (self.stats[name] or 1.0) / 127.0
        hist, th = self.stats[name]
        edges = _onp.linspace(-th, th, hist.size + 1)
        t, _ = optimal_threshold(hist, edges)
        return t / 127.0


def quantize_net(network, quantized_dtype="int8", quantize_mode="smart",
                 exclude_layers=None, exclude_layers_match=None,
                 calib_data=None, calib_mode="naive", num_calib_batches=None,
                 ctx=None, device=None, logger=None):
    """Quantize the supported layers (``Dense``, NCHW ``Conv2D``) of a
    Gluon net in place (reference ``quantization.py`` quantize_net).

    ``calib_mode``: "naive" (minmax) or "entropy"; ``calib_data``: an
    iterable of input batches (tensors, NDArrays or (data, label)),
    ``num_calib_batches`` of them at most; ``exclude_layers`` (names as
    ``collect_params`` paths) and ``exclude_layers_match`` (regular
    expressions) keep layers in float.  A layer whose weight still waits
    for its shape (no forward yet), or that the calibration did not
    reach, stays as it was, as in the reference.  Returns the net, its
    cached graphs dropped."""
    from ..gluon.nn import Conv2D, Dense
    if quantized_dtype != "int8":
        raise ValueError("only int8 supported")
    exclude_layers = set(exclude_layers or [])
    exclude_patterns = [re.compile(p) for p in (exclude_layers_match or [])]
    collector = _Collector("entropy" if calib_mode == "entropy"
                           else "minmax")

    targets = []

    def walk(block, prefix):
        for cname, child in block.named_children():
            path = (prefix + "." if prefix else "") + cname
            excluded = path in exclude_layers or \
                any(p.search(path) for p in exclude_patterns)
            if isinstance(child, (Dense, Conv2D)) \
                    and not getattr(child, "_transpose", False) \
                    and not excluded and not is_deferred(child.weight):
                targets.append((block, cname, path, child))
            else:
                walk(child, path)

    walk(network, "")
    if not targets:
        return network

    handles = [child.register_forward_pre_hook(collector.hook(path))
               for _, _, path, child in targets]
    try:
        if calib_data is not None:
            n = 0
            with torch.no_grad():
                for batch in calib_data:
                    network(batch[0] if isinstance(batch, (tuple, list))
                            else batch)
                    n += 1
                    if num_calib_batches is not None and \
                            n >= num_calib_batches:
                        break
    finally:
        for h in handles:
            h.detach()

    # pooling, activation and BatchNorm stay as they are: each quantized
    # layer dequantizes its own output
    for parent, cname, path, child in targets:
        if path not in collector.stats:
            continue
        cls = QuantizedConv2D if isinstance(child, Conv2D) else \
            QuantizedDense
        setattr(parent, cname, cls(child, collector.scale(path)))
    if hasattr(network, "reset_cache"):
        network.reset_cache()
    return network


# -- int8 tensor ops (reference src/operator/quantization/) -----------------
def quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """int8 + int8 -> int8 at the analytically known output range
    (``quantized_elemwise_add.cc``): both operands rescaled into float32,
    summed, requantized.  Returns (out, out_min, out_max) as NDArrays."""
    l_scale = max(abs(_range_scalar(lhs_min)),
                  abs(_range_scalar(lhs_max))) / 127.0
    r_scale = max(abs(_range_scalar(rhs_min)),
                  abs(_range_scalar(rhs_max))) / 127.0
    o_absmax = 127.0 * (l_scale + r_scale)
    o_scale = o_absmax / 127.0 or 1e-12
    a, b = _t(lhs), _t(rhs)
    acc = a.float() * _f32(l_scale, a) + b.float() * _f32(r_scale, b)
    out = torch.clamp(torch.round(acc / _f32(o_scale, a)), -127, 127) \
        .to(torch.int8)
    return NDArray(out), NDArray(_f32(-o_absmax, a)), \
        NDArray(_f32(o_absmax, a))


def quantized_concat(*data, dim=1):
    """Concatenate int8 tensors given as (arr, min, max) triples
    (``quantized_concat.cc``): each rescaled to the widest range, so one
    output scale is exact for every input.  Returns (out, out_min,
    out_max) as NDArrays."""
    if len(data) % 3:
        raise ValueError("quantized_concat takes (arr, min, max) triples")
    arrs = [_t(a) for a in data[0::3]]
    mins = [_range_scalar(m) for m in data[1::3]]
    maxs = [_range_scalar(m) for m in data[2::3]]
    scales = [max(abs(lo), abs(hi)) / 127.0 for lo, hi in zip(mins, maxs)]
    o_scale = max(scales) or 1e-12
    parts = [torch.clamp(torch.round(x.float() * _f32(s, x)
                                     / _f32(o_scale, x)), -127, 127)
             .to(torch.int8) for x, s in zip(arrs, scales)]
    out = torch.cat(parts, dim=dim)
    return NDArray(out), NDArray(_f32(-o_scale * 127.0, out)), \
        NDArray(_f32(o_scale * 127.0, out))


def quantize_model(*args, **kwargs):
    raise NotImplementedError(
        "symbol-file quantization is superseded by quantize_net on Gluon "
        "blocks in 2.0 (the reference's quantize_model operates on exported "
        "symbols)")


class Int8Weight:
    """One layer's int8 weight: ``q`` (N, K) int8, its per-tensor
    ``scale`` (a Python float) and the compute ``dtype`` (the weight's
    own before quantization); ``group``, the :class:`Int8Group` whose
    stacked tensor ``q`` is a block of, or None."""

    def __init__(self, q, scale, dtype, group=None):
        self.q = q
        self.scale = float(scale)
        self.dtype = dtype
        self.group = group


class Int8Group:
    """Layers that read the same input, their int8 weights stacked by
    rows in ``q`` (``rows`` each, with their ``scales``), so that the
    decode runs their products as one ``int8_linear_group`` launch."""

    def __init__(self, layers, q, rows, scales):
        self.layers = tuple(layers)
        self.q = q
        self.rows = tuple(rows)
        self.scales = tuple(scales)


_state = threading.local()


@contextlib.contextmanager
def int8_weights(weights, route):
    """Within the scope (on this thread), each layer of ``weights``
    (``{Dense: Int8Weight}``) computes with its int8 weight through
    ``route``: ``"decode"`` or ``"prefill"``.  An empty ``weights``
    changes nothing."""
    if route not in ROUTES:
        raise ValueError("int8 route must be one of %s, got %r"
                         % (ROUTES, route))
    prev = getattr(_state, "active", None), getattr(_state, "pending", None)
    _state.active = (weights, route) if weights else None
    _state.pending = {}
    try:
        yield
    finally:
        _state.active, _state.pending = prev


def _group_product(group, layer, key, x):
    """``layer``'s result of one launch over ``group``'s weights: the
    first member called with the input object ``key`` launches for all
    of them, and each other member called with that same object takes
    its result."""
    pending = _state.pending
    entry = pending.get(group)
    if entry is None or entry[0] is not key or layer not in entry[1]:
        ys = int8_linear_group(x.reshape(-1, x.shape[-1]).contiguous(),
                               group.q, group.rows, group.scales)
        entry = (key, {m: y.reshape(*x.shape[:-1], y.shape[-1])
                       for m, y in zip(group.layers, ys)})
        pending[group] = entry
    y = entry[1].pop(layer)
    if not entry[1]:
        del pending[group]
    return y


def int8_forward(layer, x, bias, flatten):
    """``layer``'s product with its int8 weight inside an
    :func:`int8_weights` scope, or None when it has none.  ``x`` is cast
    to the compute dtype (never to int8)."""
    active = getattr(_state, "active", None)
    w8 = None if active is None else active[0].get(layer)
    if w8 is None:
        return None
    key = x
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    x = x.to(w8.dtype)
    if active[1] == "prefill":
        y = F.linear(x, dequantize(w8.q, w8.scale, w8.dtype))
    elif w8.group is not None:
        y = _group_product(w8.group, layer, key, x)
    else:
        y = int8_linear(x.reshape(-1, x.shape[-1]).contiguous(), w8.q,
                        w8.scale).reshape(*x.shape[:-1], w8.q.shape[0])
    return y if bias is None else y + bias
