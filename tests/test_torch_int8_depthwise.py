"""K3's depthwise route (``conv_depthwise`` in ``csrc/int8_conv.cu``) on
the CPU: its launch plan, its index math emulated in numpy, the unpadded
layout K2 writes for one-channel groups, the route choice, and the
quantized depthwise layers against the JAX package.

The kernel runs only on the card.  Here :func:`int8_depthwise_blocks`
walks its CTAs with the kernel's index math: every output is computed by
one CTA, each CTA stages its patch once (every staged position written
once, zeros outside the image) and every tap reads the staged position
of its input, so the emulated sums equal :func:`int8_conv_plain`'s.  The
parity tests put the same numpy-seeded inputs through both packages: the
int32 sums bit for bit, the layers' outputs within 1e-6 relative (the
same float32 epilogue, one rounding per operation), an exported block
bit for bit against the block.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon import nn as j_nn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon import SymbolBlock
from mxnet_tpu_torch.gluon import nn as t_nn
from mxnet_tpu_torch.ndarray import NDArray as TND
from mxnet_tpu_torch.ops import int8 as i8

REL = 1e-6

# the depthwise layers of MobileNet v2 1.0 (17) and MobileNet 1.0 (13) at
# 224^2, all 3 x 3 with padding 1: (C, H, stride, layers)
MOBILENET_V2 = [(32, 112, 1, 1), (96, 112, 2, 1), (144, 56, 1, 2),
                (192, 56, 2, 1), (192, 28, 1, 2), (384, 28, 2, 1),
                (384, 14, 1, 3), (576, 14, 1, 3), (960, 14, 2, 1),
                (960, 7, 1, 2)]
MOBILENET_V1 = [(32, 112, 1, 1), (64, 112, 2, 1), (128, 56, 1, 1),
                (128, 56, 2, 1), (256, 28, 1, 1), (256, 28, 2, 1),
                (512, 14, 1, 5), (512, 14, 2, 1), (1024, 7, 1, 1)]


def _out(size, k, s, p, d):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


# ----------------------------------------------------------------------
# the plan and the kernel's index math (no JAX)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("net,layers", [("v2", MOBILENET_V2),
                                        ("v1", MOBILENET_V1)])
def test_int8_depthwise_plan_at_the_mobilenet_shapes(net, layers):
    assert sum(n for *_, n in layers) == {"v2": 17, "v1": 13}[net]
    for C, H, s, _ in layers:
        OH = _out(H, 3, s, 1, 1)
        plan = i8.int8_depthwise_plan(32, C, OH, OH, (3, 3), (s, s))
        # 8 x 32 (4 x 32 at stride 2), 8 x 16 and 8 x 8 for 14 and 7
        want_tw = 8 if OH <= 8 else 16 if OH <= 16 else 32
        want_th = 4 if s == 2 and want_tw == 32 else 8
        assert (plan["th"], plan["tw"]) == (want_th, want_tw)
        assert plan["cb"] == i8.DEPTHWISE_CB == 32
        assert plan["ctas"] == 32 * -(-C // plan["cb"]) * \
            -(-OH // plan["th"]) * -(-OH // plan["tw"])
        # the 3 x 3 route's word reads stay inside a channel's row
        assert plan["rw"] >= plan["tw"] // 4 * s + 1
        assert plan["plane"] % 2 and plan["smem"] <= 48 * 1024
        # the staged halo of a stride-1 tile: at most 1.35x its inputs
        if s == 1 and plan["tw"] == 32:
            assert plan["ph"] * plan["pw"] <= 1.35 * plan["th"] * plan["tw"]


def test_int8_depthwise_plan_shrinks_to_fit_and_refuses_the_rest():
    # a 21 x 21 kernel at dilation 4 (81 x 81 positions): rows first,
    # then channels
    plan = i8.int8_depthwise_plan(1, 8, 50, 50, (21, 21), (1, 1), (4, 4))
    assert plan["smem"] <= i8.DEPTHWISE_SMEM
    assert (plan["th"], plan["tw"], plan["cb"]) == (1, 32, 16)
    assert i8.int8_depthwise_plan(1, 8, 9, 9, (255, 255), (1, 1),
                                  (1, 1)) is None


def _emulate(xq, wq, groups, kernel, stride, padding, dilation):
    """``conv_depthwise``'s int32 sums from K2's layout ``xq`` (N, H, W,
    Ctot) and the weight ``wq`` (O, 1, KH, KW), CTA by CTA as
    :func:`int8_depthwise_blocks` walks them: each staging unit's 4
    channels x 4 positions written as 4 words of the channel-major patch
    (every word once, zeros outside the image and past the patch's
    columns), then every output's taps read at their bytes; asserts that
    each output is written once and every read stays inside its
    channel's row."""
    N, H, W, ctot = xq.shape
    O = wq.shape[0]
    m = O // groups
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    OH = _out(H, kh, sh, padding[0], dh)
    OW = _out(W, kw, sw, padding[1], dw)
    plan = i8.int8_depthwise_plan(N, groups, OH, OW, kernel, stride,
                                  dilation)
    cb, rw, ph, pw = plan["cb"], plan["rw"], plan["ph"], plan["pw"]
    words = cb * plan["plane"]
    assert 4 * words == plan["smem"]
    out = onp.full((N, O, OH, OW), 2 ** 40, onp.int64)
    x = onp.zeros((N, H + 2 * ph, W + 8 * pw, ctot + 4 * cb), onp.int64)
    x[:, ph:ph + H, 4 * pw:4 * pw + W, :ctot] = xq          # zero margins
    w = wq.reshape(O, kh, kw).astype(onp.int64)
    ctas = 0
    for blk in i8.int8_depthwise_blocks(plan, groups, OH, OW, kernel,
                                        stride, padding, dilation):
        ctas += 1
        n, c0 = blk["n"], blk["c0"]
        cq, pq, pr, dst = blk["units"].T
        smem = onp.full((words, 4), -999, onp.int64)
        for k in range(4):
            cl = 4 * cq + k
            # the kernel's word of (channel cl, row pr, word pq)
            onp.testing.assert_array_equal(dst + k * plan["plane"],
                                           cl * plan["plane"] + pr * rw + pq)
            assert (smem[dst + k * plan["plane"]] == -999).all()
            for i in range(4):
                pc = 4 * pq + i
                vals = x[n, ph + blk["ih0"] + pr, 4 * pw + blk["iw0"] + pc,
                         c0 + cl]
                smem[dst + k * plan["plane"], i] = onp.where(pc < pw, vals,
                                                             0)
        taps = blk["taps"]
        assert (taps % (4 * rw) < pw).all() and taps.max() < 4 * ph * rw
        oh0, oh1, ow0, ow1 = blk["oh0"], blk["oh1"], blk["ow0"], blk["ow1"]
        assert oh1 > oh0 and ow1 > ow0 and blk["c1"] > c0
        for c in range(c0, blk["c1"]):
            plane = smem[(c - c0) * plan["plane"]:
                         (c - c0 + 1) * plan["plane"]].reshape(-1)
            assert (plane[taps] != -999).all()
            for k in range(m):
                acc = (plane[taps] * w[c * m + k]).sum((2, 3))
                tile = out[n, c * m + k, oh0:oh1, ow0:ow1]
                assert (tile == 2 ** 40).all()
                tile[...] = acc[:oh1 - oh0, :ow1 - ow0]
    assert ctas == plan["ctas"] and (out != 2 ** 40).all()
    return out


# (N, C, H, W, multiplier, kernel, stride, padding, dilation): C % 4 and
# C % 16 != 0 (4-byte loads), multiplier 2, 5 x 5 taps, dilation 2,
# padding 0-2, batch 1, ragged tiles, channels past one block, and two
# MobileNet shapes at batch 1
EDGES = [(2, 7, 9, 9, 1, 3, 1, 1, 1), (1, 6, 13, 11, 2, 3, 2, 0, 1),
         (2, 32, 9, 9, 1, 3, 2, 1, 1), (1, 40, 17, 15, 1, 5, 1, 2, 1),
         (2, 20, 16, 16, 2, 3, 1, 2, 2), (1, 64, 8, 40, 1, 5, 2, 2, 1),
         (2, 3, 10, 10, 1, 3, 1, 1, 1), (1, 48, 35, 33, 1, 3, 1, 1, 1),
         (1, 36, 19, 23, 3, 3, 2, 1, 2), (1, 144, 56, 56, 1, 3, 1, 1, 1),
         (1, 192, 56, 56, 1, 3, 2, 1, 1)]


@pytest.mark.parametrize("edge", EDGES, ids=[
    "n%d_c%d_%dx%d_m%d_k%d_s%d_p%d_d%d" % e for e in EDGES])
def test_conv_depthwise_index_math_against_plain(edge):
    N, C, H, W, m, k, s, p, d = edge
    rs = onp.random.RandomState(C + H)
    qv = rs.randint(-128, 128, (N, C, H, W)).astype(onp.int8)
    wq = rs.randint(-127, 128, (C * m, 1, k, k)).astype(onp.int8)
    xq = i8.int8_quantize_plain(torch.from_numpy(qv), 1.0, C)
    wpk = i8.pack_conv_weight(torch.from_numpy(wq), C)
    geo = ((k, k), (s, s), (p, p), (d, d))
    want = i8.int8_conv_plain(xq, wpk, *geo, C, out_dtype=torch.int32)
    got = _emulate(xq.numpy(), wq, C, *geo)
    onp.testing.assert_array_equal(got, want.numpy())


# ----------------------------------------------------------------------
# the layout and the route (no JAX)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("C", [2, 3, 6, 7, 32, 144])
def test_one_channel_groups_take_the_one_group_layout(C):
    x = torch.from_numpy(onp.random.RandomState(C).randn(2, C, 5, 3)
                         .astype(onp.float32))
    one = i8.int8_quantize_plain(x, 0.02, 1)
    assert one.shape == (2, 5, 3, i8.padded_channels(C))
    assert torch.equal(i8.int8_quantize_plain(x, 0.02, C), one)
    assert torch.equal(i8.int8_quantize(x, 0.02, C), one)
    assert i8.int8_quantize_plan(2, C, 15, C) == \
        i8.int8_quantize_plan(2, C, 15, 1)
    qi = i8.quantize_tensor(x, 0.02)
    assert torch.equal(i8.int8_quantize_plain(qi, 1.0, C), one)
    # the channels in order at bytes 0 .. C - 1, zeros to the row's end
    assert torch.equal(one[..., :C], qi.permute(0, 2, 3, 1))
    assert not one[..., C:].any()


@pytest.mark.parametrize("C,groups", [(2, 2), (3, 3), (7, 7), (32, 32),
                                      (960, 960), (6, 2), (24, 3),
                                      (64, 32), (9, 3)])
def test_int8_conv_route_and_mode_take_one_channel_groups(C, groups):
    cgp = i8.group_bytes(C, groups)
    route = i8.int8_conv_route(2, 9, 9, cgp, groups)
    mode = i8.int8_conv_mode(2, C, 9, 9, (3, 3), (1, 1), (1, 1), (1, 1),
                             groups)
    if C // groups == 1:
        assert cgp == 1 and route == "depthwise"
        assert mode == ("nhwc", "depthwise")
    else:
        assert cgp == i8.padded_channels(C // groups)
        assert route == "general" and mode == ("nhwc", "general")


def test_the_general_route_still_takes_the_padded_layout():
    """The earlier layout, each channel padded to 4 bytes, is a grouped
    input of 4-byte groups: the general route, the same sums."""
    rs = onp.random.RandomState(1)
    x = torch.from_numpy(rs.randn(2, 12, 7, 7).astype(onp.float32))
    wpk = i8.pack_conv_weight(torch.from_numpy(
        rs.randint(-127, 128, (12, 1, 3, 3)).astype(onp.int8)), 12)
    xq = i8.int8_quantize(x, 0.02, 12)
    padded = torch.nn.functional.pad(xq[..., :12, None], (0, 3)).reshape(
        2, 7, 7, 48)
    geo = ((3, 3), (1, 1), (1, 1), (1, 1), 12)
    assert i8.int8_conv_route(2, 7, 7, 4, 12) == "general"
    for r in (None, "general"):
        assert torch.equal(
            i8._int8_conv(padded, wpk, *geo, out_dtype=torch.int32, route=r),
            i8.int8_conv_plain(xq, wpk, *geo, out_dtype=torch.int32))


# ----------------------------------------------------------------------
# the quantized depthwise layers against the JAX package
# ----------------------------------------------------------------------
def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _np(x):
    if isinstance(x, TND):
        x = x._data
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return onp.asarray(x._data if hasattr(x, "_data") else x)


def _rel(got, want):
    got, want = _np(got).astype(onp.float64), _np(want).astype(onp.float64)
    return onp.abs(got - want).max() / max(onp.abs(want).max(), 1e-30)


# (C, multiplier, stride, dilation, activation)
LAYERS = [(6, 1, 1, 1, "relu"), (7, 2, 2, 1, None), (32, 1, 1, 2, None),
          (7, 1, 1, 1, "relu"), (32, 2, 2, 1, "relu")]


@pytest.mark.parametrize("layer", LAYERS, ids=[
    "c%d_m%d_s%d_d%d_%s" % lay for lay in LAYERS])
def test_quantized_depthwise_conv2d_matches_jax(layer):
    C, m, s, d, act = layer
    x = _rand(C, 2, C, 9, 10)
    kw = dict(strides=s, padding=1, dilation=d, groups=C, in_channels=C,
              activation=act)
    jc, tc = j_nn.Conv2D(C * m, 3, **kw), t_nn.Conv2D(C * m, 3, **kw)
    jc.initialize()
    jc(mx.np.array(x))
    load_params(tc.initialize(device="cpu"),
                {k: onp.asarray(p.data()._data)
                 for k, p in jc.collect_params().items()})
    scale = jq._minmax_scale(x)
    jl = jq.QuantizedConv2D(jc, act_scale=scale)
    tl = tq.QuantizedConv2D(tc, act_scale=scale)
    aq = jq.quantize_array(jnp.asarray(x), scale)
    dn = jax.lax.conv_dimension_numbers(aq.shape, jl._wq.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    jacc = onp.asarray(jax.lax.conv_general_dilated(
        aq, jl._wq, (s, s), [(1, 1)] * 2, rhs_dilation=(d, d),
        dimension_numbers=dn, feature_group_count=C,
        preferred_element_type=jnp.int32))
    xq = i8.int8_quantize(torch.from_numpy(x), scale, C)
    assert xq.shape[3] == i8.padded_channels(C)
    tacc = i8.int8_conv(xq, tl._wpk, (3, 3), (s, s), (1, 1), (d, d), C,
                        out_dtype=torch.int32).numpy()
    onp.testing.assert_array_equal(tacc, jacc)
    assert i8.int8_conv_mode(2, C, 9, 10, (3, 3), (s, s), (1, 1), (d, d),
                             C) == ("nhwc", "depthwise")
    want = jl(mx.np.array(x))
    assert _rel(tl(torch.from_numpy(x)), want) <= REL


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_nd_contrib_quantized_conv_one_channel_groups(layout):
    """``nd.contrib.quantized_conv`` with ``num_group`` equal to the
    channels, multiplier 2: the same int32 sums and ranges as the JAX
    package's."""
    rs = onp.random.RandomState(8)
    q = rs.randint(-127, 128, (2, 6, 7, 8)).astype(onp.int8)
    w = rs.randint(-127, 128, (12, 1, 3, 3)).astype(onp.int8)
    bias = rs.randint(-127, 128, (12,)).astype(onp.int8)
    if layout == "NHWC":
        q, w = q.transpose(0, 2, 3, 1).copy(), w.transpose(0, 2, 3, 1).copy()
    kw = dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_group=6,
              layout=layout)
    rng = (-1.5, 1.5, -2.54, 2.54, -1.27, 1.27)
    want = mx.nd.contrib.quantized_conv(
        mx.np.array(q), mx.np.array(w), mx.np.array(bias), *rng, **kw)
    got = tmx.nd.contrib.quantized_conv(
        TND(torch.from_numpy(q)), TND(torch.from_numpy(w)),
        TND(torch.from_numpy(bias)), *rng, **kw)
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        onp.testing.assert_array_equal(_np(g), _np(j))


def test_exported_int8_depthwise_block_equals_the_block(tmp_path):
    net = t_nn.HybridSequential()
    net.add(t_nn.Conv2D(7, 3, padding=1, groups=7, in_channels=7,
                        activation="relu"),
            t_nn.Conv2D(14, 3, strides=2, padding=1, groups=7,
                        in_channels=7))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(_rand(5, 2, 7, 10, 10))
    with autograd.pause():
        net(x)
    tq.quantize_net(net, calib_data=[x])
    with autograd.pause():
        want = net(x)
    sym, par = net.export(str(tmp_path / "dw"), example_inputs=x)
    blk = SymbolBlock.imports(sym, None, par, device="cpu")
    got = blk(x)
    assert got.shape == (2, 14, 5, 5)
    assert torch.equal(got, want)
