"""The port's post-training int8 quantization
(``mxnet_tpu_torch/contrib/quantization.py``, ``ndarray/contrib.py``, the
``int8_quantize`` / ``int8_conv`` kernels' plain versions) and its
all-finite check against the JAX package's, on the CPU; with the forward
hooks that calibration runs through.

The same numpy-seeded inputs and weights (``convert.load_params``) go
through both packages.  Bit for bit: the calibration math (threshold,
smoothing, divergence), ``quantize_array`` (.5 ties included), the
quantized weights and the int32 accumulators of every convolution and
product, the ``nd.contrib`` int8 results (``quantized_batch_norm`` to one
int8 step: its rsqrt rounds differently in the two libraries), the
all-finite flags.  Quantized layer outputs: 1e-6 relative (the same
float32 epilogue, one rounding per operation).  A quantized net: each
layer's activation scale comes from the float net's activations, which
the two packages round differently after the first layer, so scales
agree to 1e-6 relative and outputs to 1e-3 of their range (an input near
a rounding boundary can take the neighbouring int8 value).
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as j_nn
from mxnet_tpu.ndarray.ndarray import NDArray as JND
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon import nn as t_nn
from mxnet_tpu_torch.ndarray import NDArray as TND
from mxnet_tpu_torch.ops import int8 as ti8
from mxnet_tpu_torch.ops import multi_tensor as tmt

REL = 1e-6


def _rand(seed, *shape, scale=1.0):
    return (onp.random.RandomState(seed).randn(*shape) * scale) \
        .astype(onp.float32)


def _np(x):
    if isinstance(x, JND):
        return onp.asarray(x._data)
    if isinstance(x, TND):
        x = x._data
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def _jparams(jnet):
    return {k: onp.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}


def _pair(jlayer, tlayer, x):
    jlayer.initialize()
    jlayer(mx.np.array(x))
    return jlayer, load_params(tlayer.initialize(device="cpu"),
                               _jparams(jlayer))


def _rel(got, want):
    got, want = _np(got).astype(onp.float64), _np(want).astype(onp.float64)
    return onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30)


# ----------------------------------------------------------------------
# the calibration math
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dist", ["normal", "outlier", "narrow"])
def test_threshold_search_bit_for_bit(dist):
    rs = onp.random.RandomState(7)
    arr = {"normal": rs.normal(0, 1, 20000),
           "outlier": onp.concatenate([rs.normal(0, 1, 20000), [60.0]]),
           "narrow": rs.uniform(-1, 1, 500)}[dist]
    th = float(onp.abs(arr).max())
    bins = 1001 if dist != "narrow" else 511
    hist, edges = onp.histogram(arr, bins=bins, range=(-th, th))
    assert tq.optimal_threshold(hist, edges) == \
        jq.optimal_threshold(hist, edges)
    if dist == "outlier":           # the 8001-bin search of calibration
        assert tq._entropy_scale(arr) == jq._entropy_scale(arr)
    p = hist.astype(onp.float64)
    onp.testing.assert_array_equal(tq._smooth_distribution(p),
                                   jq._smooth_distribution(p))
    q = onp.roll(p, 3) + 1
    assert tq._kl_divergence(tq._smooth_distribution(p), q) == \
        jq._kl_divergence(jq._smooth_distribution(p), q)
    assert tq._smooth_distribution(onp.zeros(4)) is None


@pytest.mark.parametrize("scale", [0.5, 1 / 3, 0.0123, 3.0 / 127.0, 1e-3])
def test_quantize_array_bit_for_bit_with_ties(scale):
    x = _rand(1, 4000, scale=50 * scale)
    # exact .5 multiples of the scale where float32 holds them, and values
    # beyond the int8 range
    ties = (onp.arange(-300, 300, dtype=onp.float32) + 0.5) * \
        onp.float32(scale)
    x = onp.concatenate([x, ties, -ties, [1e30, -1e30, 0.0]]) \
        .astype(onp.float32)
    want = onp.asarray(jq.quantize_array(jnp.asarray(x), scale))
    got = tq.quantize_array(torch.from_numpy(x), scale).numpy()
    onp.testing.assert_array_equal(got, want)
    # the kernel's plain version: NHWC, channels padded
    g2 = ti8.int8_quantize(torch.from_numpy(x[:4000].reshape(2, 5, 20, 20)),
                           scale).numpy()
    onp.testing.assert_array_equal(
        g2[..., :5], want[:4000].reshape(2, 5, 20, 20).transpose(0, 2, 3, 1))
    assert (g2[..., 5:] == 0).all()
    assert isinstance(tq.quantize_array(TND(torch.from_numpy(x)), scale),
                      TND)


# ----------------------------------------------------------------------
# the quantized layers
# ----------------------------------------------------------------------
# (C, O, kernel, stride, pad, dilation, groups, bias, activation)
CONV_CASES = [(4, 8, 3, 1, 1, 1, 1, True, None),
              (3, 8, 3, 2, 0, 1, 1, False, "relu"),
              (4, 6, 3, 1, 1, 2, 2, True, "relu"),
              (6, 6, 3, 2, 1, 1, 6, True, "sigmoid")]


def _unpack(tl, cg):
    """The port's packed weight back to (O, I / G, KH, KW)."""
    wpk = tl._wpk
    G, og = wpk.shape[:2]
    kh, kw = tl._kernel
    cgp = ti8.padded_channels(cg)
    w = wpk[:, :, :kh * kw * cgp].reshape(G, og, kh, kw, cgp)[..., :cg]
    return w.permute(0, 1, 4, 2, 3).reshape(G * og, cg, kh, kw).numpy()


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=["c%d_o%d_k%d_s%d_p%d_d%d_g%d_%s_%s" % c
                              for c in CONV_CASES])
def test_quantized_conv2d(case):
    C, O, k, s, p, d, g, bias, act = case
    x = _rand(2, 2, C, 11, 11)
    kw = dict(strides=s, padding=p, dilation=d, groups=g, in_channels=C,
              use_bias=bias, activation=act)
    jc, tc = _pair(j_nn.Conv2D(O, k, **kw), t_nn.Conv2D(O, k, **kw), x)
    scale = jq._minmax_scale(x)
    jl = jq.QuantizedConv2D(jc, act_scale=scale)
    tl = tq.QuantizedConv2D(tc, act_scale=scale)
    onp.testing.assert_array_equal(tl._w_scale, jl._w_scale)
    onp.testing.assert_array_equal(_unpack(tl, C // g), onp.asarray(jl._wq))
    # the int32 sums
    aq = jq.quantize_array(jnp.asarray(x), scale)
    dn = jax.lax.conv_dimension_numbers(aq.shape, jl._wq.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    jacc = onp.asarray(jax.lax.conv_general_dilated(
        aq, jl._wq, (s, s), [(p, p)] * 2, rhs_dilation=(d, d),
        dimension_numbers=dn, feature_group_count=g,
        preferred_element_type=jnp.int32))
    tacc = ti8.int8_conv(ti8.int8_quantize(torch.from_numpy(x), scale, g),
                         tl._wpk, (k, k), (s, s), (p, p), (d, d), g,
                         out_dtype=torch.int32).numpy()
    onp.testing.assert_array_equal(tacc, jacc)
    want = jl(mx.np.array(x))
    assert _rel(tl(torch.from_numpy(x)), want) <= REL
    # the unit-scale probe: scales 1, no bias, no activation -> f32(acc)
    tl._scale.fill_(1.0)
    tl._bias, tl._activation = None, None
    onp.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(),
                                   jacc.astype(onp.float32))


# the stem's geometry at a small size, then dilation with odd paddings:
# (N, C, H, W, O, kernel, stride, (ph, pw), dilation)
IM2COL_CASES = [(2, 3, 32, 32, 16, 7, 2, (3, 3), 1),
                (1, 3, 17, 19, 8, 3, 1, (3, 1), 2),
                (2, 5, 15, 13, 12, 5, 2, (1, 2), 1)]


@pytest.mark.parametrize("case", IM2COL_CASES,
                         ids=["n%d_c%d_%dx%d_o%d_k%d_s%d_p%s_d%d" % c
                              for c in IM2COL_CASES])
def test_im2col_rows_by_the_packed_weight_match_jax_int32(case):
    """The stem's path: the im2col rows (quantize_array's values, the
    depth in pack_conv_weight's order) as a 1 x 1 int8_conv with the
    layer's packed weight give the JAX package's int32 sums exactly."""
    N, C, H, W, O, k, s, (ph, pw), d = case
    x = _rand(3, N, C, H, W)
    wq = onp.random.RandomState(4).randint(-127, 128, (O, C, k, k)) \
        .astype(onp.int8)
    scale = jq._minmax_scale(x)
    aq = jq.quantize_array(jnp.asarray(x), scale)
    dn = jax.lax.conv_dimension_numbers(aq.shape, wq.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    jacc = onp.asarray(jax.lax.conv_general_dilated(
        aq, jnp.asarray(wq), (s, s), [(ph, ph), (pw, pw)],
        rhs_dilation=(d, d), dimension_numbers=dn,
        preferred_element_type=jnp.int32))
    geo = ((k, k), (s, s), (ph, pw), (d, d))
    assert ti8.int8_conv_mode(N, C, H, W, *geo) == ("im2col", "hopper")
    xt, wpk = torch.from_numpy(x), ti8.pack_conv_weight(
        torch.from_numpy(wq), 1)
    cols = ti8.int8_quantize_im2col_plain(xt, scale, *geo)
    assert torch.equal(ti8.int8_quantize_im2col(xt, scale, *geo), cols)
    kc = cols.shape[3]
    assert kc % 32 == 0 and kc <= wpk.shape[2]
    tacc = ti8.int8_conv(cols, wpk, (1, 1), out_dtype=torch.int32).numpy()
    onp.testing.assert_array_equal(tacc, jacc)
    # the layer's pair, and the NHWC layout through the general route's
    # plain version: the same sums
    onp.testing.assert_array_equal(ti8.quantized_conv(
        xt, scale, wpk, *geo, out_dtype=torch.int32).numpy(), jacc)
    onp.testing.assert_array_equal(ti8.int8_conv(
        ti8.int8_quantize(xt, scale), wpk, *geo,
        out_dtype=torch.int32).numpy(), jacc)


@pytest.mark.parametrize("flatten,shape,act", [(True, (3, 3, 2, 2), "relu"),
                                               (False, (2, 3, 12), None),
                                               (True, (4, 12), "tanh")])
def test_quantized_dense(flatten, shape, act):
    x = _rand(3, *shape)
    kw = dict(in_units=12, flatten=flatten, activation=act)
    jd, td = _pair(j_nn.Dense(5, **kw), t_nn.Dense(5, **kw), x)
    scale = jq._minmax_scale(x)
    jl, tl = jq.QuantizedDense(jd, scale), tq.QuantizedDense(td, scale)
    assert tl._w_scale == jl._w_scale
    onp.testing.assert_array_equal(
        tl._wpk[0, :, :12].numpy(), onp.asarray(jl._wq))
    want = jl(mx.np.array(x))
    got = tl(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _rel(got, want) <= REL


def test_channels_last_conv_is_refused_where_the_reference_miscomputes():
    """The reference's QuantizedConv2D reads any Conv2D as NCHW / OIHW:
    with an NHWC layer whose height equals its kernel it computes a
    wrong result; with any other height it raises.  The port refuses the
    layer with a clear error in both cases."""
    x = _rand(4, 1, 3, 3, 4)                                    # NHWC
    kw = dict(padding=1, layout="NHWC", in_channels=4)
    jc, tc = _pair(j_nn.Conv2D(4, 3, **kw), t_nn.Conv2D(4, 3, **kw), x)
    jl = jq.QuantizedConv2D(jc, act_scale=jq._minmax_scale(x))
    wrong = _np(jl(mx.np.array(x)))
    right = _np(jc(mx.np.array(x)))
    assert wrong.shape != right.shape or _rel(wrong, right) > 0.1
    with pytest.raises(ValueError):
        jl(mx.np.array(_rand(4, 1, 5, 5, 4)))
    with pytest.raises(NotImplementedError, match="NCHW"):
        tq.QuantizedConv2D(tc, act_scale=1.0)


# ----------------------------------------------------------------------
# quantize_net
# ----------------------------------------------------------------------
def _small_cnn(nn):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
            nn.MaxPool2D(2),
            nn.Conv2D(16, 3, padding=1, activation="relu"),
            nn.GlobalAvgPool2D(),
            nn.Dense(10))
    return net


def _cnn_pair(seed=5):
    mx.np.random.seed(seed)
    jnet = _small_cnn(j_nn)
    jnet.initialize()
    x = _np(mx.np.random.normal(0, 1, (8, 3, 16, 16))).astype(onp.float32)
    jnet(mx.np.array(x))
    tnet = load_params(_small_cnn(t_nn).initialize(device="cpu"),
                       _jparams(jnet))
    return jnet, tnet, x


@pytest.mark.parametrize("calib_mode", ["naive", "entropy"])
def test_quantize_net_small_cnn(calib_mode):
    jnet, tnet, x = _cnn_pair()
    # each quantized layer's input range: the entropy histogram's [-th, th]
    ths = []
    handles = [c.register_forward_pre_hook(
        lambda b, a: ths.append(float(a[0].detach().abs().max())))
        for c in tnet if isinstance(c, (t_nn.Conv2D, t_nn.Dense))]
    ref = _np(tnet(torch.from_numpy(x)))
    for h in handles:
        h.detach()
    jq.quantize_net(jnet, calib_data=[mx.np.array(x)], calib_mode=calib_mode)
    tq.quantize_net(tnet, calib_data=[torch.from_numpy(x)],
                    calib_mode=calib_mode)
    kinds = [type(c).__name__ for c in tnet]
    assert kinds == [type(c).__name__ for c in jnet._children.values()]
    assert kinds.count("QuantizedConv2D") == 2 and "QuantizedDense" in kinds
    jl = [c for c in jnet._children.values() if hasattr(c, "_act_scale")]
    tl = [c for c in tnet if hasattr(c, "_act_scale")]
    if calib_mode == "naive":
        assert tl[0]._act_scale == jl[0]._act_scale
        for a, b in zip(tl, jl):
            assert abs(a._act_scale - b._act_scale) <= REL * b._act_scale
    else:
        # thresholds within one bin of the 8001-bin histogram over [-th, th]
        assert len(ths) == len(tl) == 3
        for a, b, th in zip(tl, jl, ths):
            assert abs(a._act_scale - b._act_scale) * 127 <= 2 * th / 8001
    got, want = _np(tnet(torch.from_numpy(x))), _np(jnet(mx.np.array(x)))
    assert onp.abs(got - want).max() <= 1e-3 * onp.abs(want).max()
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.75
    # hybridized (on the CPU the block runs eagerly) equals eager
    tnet.hybridize()
    onp.testing.assert_array_equal(_np(tnet(torch.from_numpy(x))), got)


def test_quantize_net_options():
    _, tnet, x = _cnn_pair(6)
    tq.quantize_net(tnet, calib_data=[(torch.from_numpy(x), None)] * 3,
                    exclude_layers=["4"], exclude_layers_match=[r"^2$"],
                    num_calib_batches=1)
    assert [type(c).__name__ for c in tnet] == [
        "QuantizedConv2D", "MaxPool2D", "Conv2D", "GlobalAvgPool2D", "Dense"]
    with pytest.raises(ValueError):
        tq.quantize_net(tnet, quantized_dtype="uint8")
    with pytest.raises(NotImplementedError):
        tq.quantize_model()
    # no calibration data: nothing reached, nothing swapped
    _, t2, _ = _cnn_pair(7)
    tq.quantize_net(t2)
    assert "QuantizedConv2D" not in [type(c).__name__ for c in t2]


def test_quantized_elemwise_add_and_concat_match():
    a, b = _rand(8, 4, 8, scale=1.5), _rand(9, 4, 5, scale=0.4)
    aq, bq = jq.quantize_array(jnp.asarray(a), 3 / 127), \
        jq.quantize_array(jnp.asarray(b[:, :5]), 1 / 127)
    ta, tb = torch.from_numpy(onp.array(aq)), torch.from_numpy(
        onp.array(bq))
    bb = onp.asarray(jq.quantize_array(jnp.asarray(b[:, :5].repeat(2, 1)
                                                   [:, :8]), 1 / 127))
    j = jq.quantized_elemwise_add(mx.np.array(onp.asarray(aq)),
                                  mx.np.array(bb), -3.0, 3.0, -1.0, 1.0)
    t = tq.quantized_elemwise_add(ta, torch.from_numpy(onp.array(bb)),
                                  -3.0, 3.0, -1.0, 1.0)
    for x, y in zip(t, j):
        onp.testing.assert_array_equal(_np(x), _np(y))
    j = jq.quantized_concat(mx.np.array(onp.asarray(aq)), -3.0, 3.0,
                            mx.np.array(onp.asarray(bq)), -1.0, 1.0, dim=1)
    t = tq.quantized_concat(ta, -3.0, 3.0, tb, -1.0, 1.0, dim=1)
    for x, y in zip(t, j):
        onp.testing.assert_array_equal(_np(x), _np(y))


# ----------------------------------------------------------------------
# nd.contrib's int8 family
# ----------------------------------------------------------------------
def _both(name, *args, **kw):
    """The op of each package on the same inputs (numpy arrays become
    each package's NDArray)."""
    conv = {"j": lambda a: mx.np.array(a) if isinstance(a, onp.ndarray)
            else a,
            "t": lambda a: TND(torch.from_numpy(a))
            if isinstance(a, onp.ndarray) else a}
    out = {}
    for side, mod in (("j", mx.nd.contrib), ("t", tmx.nd.contrib)):
        res = getattr(mod, name)(*[conv[side](a) for a in args], **kw)
        out[side] = [_np(r) for r in (res if isinstance(res, (list, tuple))
                                      else [res])]
    return out["t"], out["j"]


def _equal(name, *args, tol=0, **kw):
    got, want = _both(name, *args, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.dtype,
                                                           w.dtype)
        if tol:
            assert onp.abs(g.astype(onp.int64) - w.astype(onp.int64)) \
                .max() <= tol, name
        else:
            onp.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_nd_contrib_int8_family():
    x = _rand(10, 2, 6, 7, 7, scale=2.0)
    q, lo, hi = _equal("quantize_v2", x)
    u = _equal("quantize", onp.abs(x), 0.0, float(onp.abs(x).max()),
               out_type="uint8")[0]
    _equal("quantize", x, -3.0, 2.5, out_type="int8")
    _equal("dequantize", q, float(lo), float(hi))
    w = onp.asarray(jq.quantize_array(jnp.asarray(_rand(11, 8, 3, 3, 3)),
                                      0.02))
    bias = onp.asarray(jq.quantize_array(jnp.asarray(_rand(12, 8)), 0.01))
    rng = (float(lo), float(hi), -2.54, 2.54)
    for kw in (dict(kernel=(3, 3), pad=(1, 1), num_group=2),
               dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 2),
                    num_group=2)):
        out = _equal("quantized_conv", q, w, bias, *rng, -1.27, 1.27, **kw)
        _equal("quantized_conv", q, w, None, *rng, **kw)
        o32, olo, ohi = out
        _equal("dequantize", o32, float(olo), float(ohi))
        _equal("requantize", o32, float(olo), float(ohi))
        _equal("requantize", o32, float(olo), float(ohi),
               min_calib_range=-5.0, max_calib_range=5.0)
    # channels last: NHWC data, OHWI weight
    _equal("quantized_conv", q.transpose(0, 2, 3, 1).copy(),
           w.transpose(0, 2, 3, 1).copy(), bias, *rng, -1.27, 1.27,
           kernel=(3, 3), pad=(1, 1), num_group=2, layout="NHWC")
    # 1-D
    _equal("quantized_conv", q[:, :, 0].copy(), w[:, :, 0].copy(), None,
           *rng, kernel=(3,), pad=(1,), num_group=2)
    # raw int8 data holding -128 goes in unclipped, as the reference
    # convolves it
    qm = q.copy()
    qm.reshape(-1)[::5] = -128
    _equal("quantized_conv", qm, w, bias, *rng, -1.27, 1.27, kernel=(3, 3),
           pad=(1, 1), num_group=2)
    with pytest.raises(ValueError, match="scale 1"):
        ti8.int8_quantize(torch.from_numpy(qm), 0.5)
    wf = onp.asarray(jq.quantize_array(jnp.asarray(_rand(13, 5, 294)),
                                       0.02))
    _equal("quantized_fully_connected", q, wf,
           bias[:5].copy(), *rng, -1.27, 1.27, num_hidden=5)
    # the uint8 output of quantize: 128 and above become negative int8 in
    # both packages, -128 among them
    assert (u == 128).any()
    _equal("quantized_fully_connected", u, wf, None, *rng, num_hidden=5,
           no_bias=True)
    _equal("quantized_fully_connected", q[:, :, :, 0].copy(),
           wf[:, :7].copy(), None, *rng, flatten=False, no_bias=True)
    for kw in (dict(kernel=(2, 2), pool_type="max", stride=(2, 2)),
               dict(kernel=(3, 3), pool_type="avg", stride=(2, 2),
                    pad=(1, 1)),
               dict(kernel=(1, 1), pool_type="avg", global_pool=True),
               dict(kernel=(2, 2), pool_type="sum")):
        _equal("quantized_pooling", q, lo, hi, **kw)
    _equal("quantized_flatten", q, lo, hi)
    _equal("quantized_act", q, lo, hi)
    q2, lo2, hi2 = _equal("quantize_v2", _rand(14, 2, 6, 7, 7))
    _equal("quantized_elemwise_add", q, q2, lo, hi, lo2, hi2)
    _equal("quantized_elemwise_mul", q, q2, lo, hi, lo2, hi2)
    _equal("quantized_concat", q, q2, lo, hi, lo2, hi2, dim=1)
    idx = onp.array([[0, 3], [4, 1]], dtype=onp.int32)
    _equal("quantized_embedding", idx, wf, -1.0, 1.0)
    g, b = _rand(15, 6) + 1.5, _rand(16, 6)
    mm, mv = _rand(17, 6), onp.abs(_rand(18, 6)) + 0.5
    _equal("quantized_batch_norm", q, g, b, mm, mv, lo, hi, tol=1)
    _equal("quantized_batch_norm", q, g, b, mm, mv, lo, hi, tol=1,
           min_calib_range=-3.0, max_calib_range=3.0)
    edges = onp.linspace(-2, 2, 1002)
    hist = onp.histogram(_rand(19, 5000), bins=1001, range=(-2, 2))[0]
    _equal("calibrate_entropy", hist, edges)
    with pytest.raises(NotImplementedError, match="queue 5"):
        tmx.nd.contrib.sldwin_atten_score(None, None, None, 1)
    with pytest.raises(AttributeError):
        tmx.nd.contrib.not_an_op


# ----------------------------------------------------------------------
# the all-finite check
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_multi_all_finite_matches(dtype):
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    base = [_rand(20 + i, n) for i, n in enumerate((5, 300, 17))]
    for bad in (None, float("inf"), float("-inf"), float("nan")):
        for pos in range(3):
            arrs = [a.copy() for a in base]
            if bad is not None:
                arrs[pos][pos * 3] = bad
            j = [mx.nd.NDArray(jnp.asarray(a).astype(jdt)) for a in arrs]
            t = [torch.from_numpy(a).to(tdt) for a in arrs]
            want = _np(mx.nd.multi_all_finite(*j, num_arrays=3))
            got = _np(tmx.nd.multi_all_finite(*[TND(a) for a in t],
                                              num_arrays=3))
            onp.testing.assert_array_equal(got, want)
            plain = tmt.multi_all_finite_plain(t).numpy()
            onp.testing.assert_array_equal(plain, want)
            onp.testing.assert_array_equal(
                _np(tmx.nd.all_finite(TND(t[pos]))),
                _np(mx.nd.all_finite(j[pos])))
            # init_output=False keeps a 0 already in out
            for init in (True, False):
                jo = mx.nd.NDArray(jnp.zeros((1,), jnp.float32))
                to = TND(torch.zeros(1))
                mx.nd.multi_all_finite(*j, num_arrays=3, init_output=init,
                                       out=jo)
                tmx.nd.multi_all_finite(*[TND(a) for a in t], num_arrays=3,
                                        init_output=init, out=to)
                onp.testing.assert_array_equal(_np(to), _np(jo))


# ----------------------------------------------------------------------
# forward hooks, and the gluon namespace
# ----------------------------------------------------------------------
def _hooked(nn, log, active):
    net = nn.HybridSequential()
    net.add(nn.Dense(3, in_units=4), nn.Dense(2, in_units=3))
    if nn is t_nn:
        net.initialize(device="cpu")
    else:
        net.initialize()
    handles = []
    for name, blk in (("net", net), ("d0", net[0])):
        handles.append(blk.register_forward_pre_hook(
            lambda b, a, name=name: log.append(
                ("pre", name, type(b).__name__, tuple(a[0].shape)))))
        handles.append(blk.register_forward_hook(
            lambda b, a, out, name=name: log.append(
                ("post", name, type(b).__name__, tuple(out.shape)))))
        if active:
            break
    return net, handles


@pytest.mark.parametrize("active", [False, True])
def test_forward_hooks_match(active):
    logs = {}
    for side, nn, arr in (("j", j_nn, lambda x: mx.np.array(x)),
                          ("t", t_nn, lambda x: torch.from_numpy(x))):
        log = logs[side] = []
        net, handles = _hooked(nn, log, active)
        net.hybridize(active)
        x = _rand(30, 2, 4)
        net(arr(x))
        net(arr(x))
        n = len(log)
        handles[0].detach()
        net(arr(x))
        assert len(log) == n + (1 if active else 3), (side, log)
        for h in handles:
            h.detach()
            # again, in torch's spelling where there is one: harmless
            getattr(h, "remove", h.detach)()
        net(arr(x))
        assert len(log) == n + (1 if active else 3)
    assert logs["t"] == logs["j"]
    assert logs["t"][:2] == [("pre", "net", "HybridSequential", (2, 4)),
                             ("pre", "d0", "Dense", (2, 4))] or active


def test_hooks_see_ndarrays_and_run_around_forward():
    order = []
    layer = t_nn.Dense(2, in_units=3).initialize(device="cpu")
    layer.register_forward_pre_hook(lambda b, a: order.append(
        ("pre", type(a[0]).__name__)))
    layer.register_forward_hook(lambda b, a, o: order.append(
        ("post", type(o).__name__)))
    layer.register_forward_hook(lambda b, a, o: order.append(("post2",)))
    layer(TND(torch.ones(1, 3)))
    layer(torch.ones(1, 3))
    assert order == [("pre", "NDArray"), ("post", "NDArray"), ("post2",),
                     ("pre", "Tensor"), ("post", "Tensor"), ("post2",)]


def test_gluon_exports_constant():
    from mxnet_tpu_torch.gluon import parameter
    assert tmx.gluon.Constant is parameter.Constant
    c = tmx.gluon.Constant(onp.arange(3, dtype=onp.float32))
    assert c.grad_req == "null" and not c.requires_grad
    assert hasattr(mx.gluon, "Constant")
