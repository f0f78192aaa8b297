"""The port's Gluon pieces against the JAX package's: the ``ops.nn``
functions (convolution, pooling, batch / layer / group / instance norm,
activations, dense, masked attention), the layers over them, deferred
parameter shapes and names, and -- where the two packages cannot draw
the same random numbers -- the initializers' and Dropout's own rules.

The same numpy inputs go through both packages; layer weights cross by
``convert.load_params``.  Tolerance 1e-4 on float32 outputs (the two
frameworks sum in different orders; the largest difference here is
about 2e-6).
"""
import math

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import nn as j_nn
from mxnet_tpu_torch import autograd, gluon, initializer
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon import nn as t_layers
from mxnet_tpu_torch.gluon.parameter import (DeferredInitializationError,
                                             TorchParameter,
                                             is_deferred)
from mxnet_tpu_torch.ops import nn as t_nn

TOL = 1e-4


def _rand(seed, *shape):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = onp.asarray(want._data if isinstance(want, NDArray) else want)
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


def _jparams(jnet):
    return {k: onp.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}


def _pair(jlayer, tlayer, x):
    """Initialize the JAX layer, run it once on ``x`` (deferred shapes),
    and load its weights into the port's layer; returns the port layer."""
    jlayer.initialize()
    jlayer(NDArray(jnp.asarray(x)))
    return load_params(tlayer.initialize(device="cpu"), _jparams(jlayer))


# ----------------------------------------------------------------------
# ops.nn functions
# ----------------------------------------------------------------------
# (layout, x shape, weight shape, stride, pad, dilate, groups)
CONV_CASES = [
    ("NCHW", (2, 4, 9, 9), (6, 4, 3, 3), (1, 1), (0, 0), (1, 1), 1),
    ("NCHW", (2, 4, 9, 9), (6, 2, 3, 3), (2, 2), (1, 1), (1, 1), 2),
    ("NCHW", (2, 4, 11, 9), (4, 1, 3, 3), (1, 2), (2, 1), (2, 2), 4),
    ("NHWC", (2, 9, 9, 4), (6, 3, 3, 4), (2, 2), (1, 1), (1, 1), 1),
    ("NHWC", (2, 9, 9, 4), (6, 3, 3, 2), (1, 1), (1, 1), (2, 2), 2),
    ("NHWC", (2, 8, 8, 4), (6, 1, 1, 4), (2, 2), (0, 0), (1, 1), 1),
    ("NCW", (2, 4, 15), (6, 4, 5), (2,), (2,), (1,), 1),
    ("NWC", (2, 15, 4), (6, 5, 2), (1,), (1,), (2,), 2),
    ("NCDHW", (1, 2, 5, 6, 7), (4, 2, 3, 3, 3), (1, 2, 1), (1, 1, 1),
     (1, 1, 1), 1),
    ("NDHWC", (1, 5, 6, 7, 2), (4, 3, 3, 3, 2), (1, 1, 1), (1, 0, 1),
     (1, 1, 1), 1),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "%s-s%s-p%s-d%s-g%d"
                         % (c[0], c[3], c[4], c[5], c[6]))
def test_convolution_matches_jax(case):
    layout, xs, ws, stride, pad, dilate, groups = case
    x, w, b = _rand(1, *xs), _rand(2, *ws), _rand(3, ws[0])
    want = j_nn.convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            stride, pad, dilate, groups, layout)
    got = t_nn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), stride, pad, dilate, groups,
                           layout)
    _close(got, want)


@pytest.mark.parametrize("case", [
    ((2, 4, 5, 5), (4, 3, 3, 3), (2, 2), (1, 1), (1, 1), (1, 1), 1),
    ((2, 4, 5, 6), (4, 2, 3, 2), (2, 1), (0, 1), (1, 0), (1, 1), 2),
    ((2, 3, 7), (3, 4, 4), (3,), (1,), (2,), (1,), 1)])
def test_deconvolution_matches_jax(case):
    xs, ws, stride, pad, adj, dilate, groups = case
    x, w, b = _rand(4, *xs), _rand(5, *ws), _rand(6, ws[1] * groups)
    want = j_nn.deconvolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              stride, pad, dilate, groups, adj)
    got = t_nn.deconvolution(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), stride, pad, dilate,
                             groups, adj)
    _close(got, want)


# (pool_type, x shape, kernel, stride, pad, global, count_include_pad, layout)
POOL_CASES = [
    ("max", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), False, True, "NCHW"),
    ("avg", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), False, True, "NCHW"),
    ("avg", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), False, False, "NCHW"),
    ("avg", (2, 3, 8, 8), (2, 2), None, None, False, False, "NCHW"),
    ("sum", (2, 3, 8, 8), (2, 2), (2, 1), (1, 0), False, True, "NCHW"),
    ("lp", (2, 3, 8, 8), (3, 3), (2, 2), (1, 1), False, True, "NCHW"),
    ("max", (2, 9, 9, 3), (3, 3), (2, 2), (1, 1), False, True, "NHWC"),
    ("avg", (2, 9, 9, 3), (3, 3), (2, 2), (1, 1), False, False, "NHWC"),
    ("max", (2, 3, 7, 5), None, None, None, True, True, "NCHW"),
    ("avg", (2, 3, 7, 5), None, None, None, True, True, "NCHW"),
    ("avg", (2, 7, 5, 3), None, None, None, True, True, "NHWC"),
    ("sum", (2, 3, 7, 5), None, None, None, True, True, "NCHW"),
    ("lp", (2, 3, 7, 5), None, None, None, True, True, "NCHW"),
    ("avg", (2, 3, 11), (3,), (2,), (1,), False, False, "NCW"),
    ("max", (2, 11, 3), (3,), (2,), (1,), False, True, "NWC"),
    ("max", (1, 2, 6, 6, 6), (2, 2, 2), None, None, False, True, "NCDHW"),
    ("avg", (1, 6, 6, 6, 2), (3, 3, 3), (2, 2, 2), (1, 1, 1), False, True,
     "NDHWC"),
]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda c: "%s-%s%s-%s%s"
                         % (c[0], c[7], "-global" if c[5] else "",
                            "cip" if c[6] else "nocip", c[2]))
def test_pooling_matches_jax(case):
    ptype, xs, kernel, stride, pad, glob, cip, layout = case
    x = _rand(7, *xs)
    kernel = kernel or (1,) * (len(xs) - 2)
    want = j_nn.pooling(jnp.asarray(x), kernel, ptype, stride, pad, glob, cip,
                        layout)
    got = t_nn.pooling(torch.from_numpy(x), kernel, ptype, stride, pad, glob,
                       cip, layout)
    _close(got, want)


@pytest.mark.parametrize("size", [(2, 3), 4, (3, 5)])
def test_adaptive_avg_pool2d_matches_jax(size):
    x = _rand(8, 2, 3, 8, 12)
    _close(t_nn.adaptive_avg_pool2d(torch.from_numpy(x), size),
           j_nn.adaptive_avg_pool2d(jnp.asarray(x), size))


@pytest.mark.parametrize("axis,shape", [(1, (4, 3, 5, 5)), (-1, (4, 5, 5, 3)),
                                        (1, (6, 3)), (-1, (2, 4, 3))])
def test_batch_norm_functions_match_jax(axis, shape):
    x = _rand(9, *shape) * 3 + 1
    g, b = _rand(10, 3), _rand(11, 3)
    mm, mv = _rand(12, 3), onp.abs(_rand(13, 3)) + 0.5
    out, mean, var = (t.detach() for t in t_nn.batch_norm_train(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5,
        axis))
    jout, jmean, jvar = j_nn.batch_norm_train(jnp.asarray(x), jnp.asarray(g),
                                              jnp.asarray(b), 1e-5, axis)
    _close(out, jout)
    _close(mean, jmean)
    _close(var, jvar)
    _close(t_nn.batch_norm_inference(
        *(torch.from_numpy(a) for a in (x, g, b, mm, mv)), 1e-5, axis),
        j_nn.batch_norm_inference(*(jnp.asarray(a) for a in (x, g, b, mm, mv)),
                                  1e-5, axis))


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_group_instance_norm_match_jax(axis):
    x = _rand(14, 2, 4, 6) * 2
    c = x.shape[axis]
    g, b = _rand(15, c), _rand(16, c)
    _close(t_nn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), axis, 1e-5),
           j_nn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                           axis, 1e-5))
    x4 = _rand(17, 2, 4, 3, 3)
    g4, b4 = _rand(18, 4), _rand(19, 4)
    args = [torch.from_numpy(a) for a in (x4, g4, b4)]
    jargs = [jnp.asarray(a) for a in (x4, g4, b4)]
    _close(t_nn.group_norm(*args, 2), j_nn.group_norm(*jargs, 2))
    _close(t_nn.instance_norm(*args), j_nn.instance_norm(*jargs))


ACTS = ["relu", "sigmoid", "log_sigmoid", "tanh", "softrelu", "softsign",
        "mish", "silu", "swish", "gelu", "gelu_tanh"]


@pytest.mark.parametrize("act", ACTS)
def test_activation_matches_jax(act):
    x = _rand(20, 3, 7) * 3
    _close(t_nn.activation(torch.from_numpy(x), act),
           j_nn.activation(jnp.asarray(x), act), tol=1e-5)


@pytest.mark.parametrize("act", ["leaky", "prelu", "elu", "selu", "gelu",
                                 "rrelu"])
def test_leaky_relu_matches_jax(act):
    x = _rand(21, 3, 5) * 3
    gamma = _rand(22, 5)
    _close(t_nn.leaky_relu(torch.from_numpy(x), act, 0.3,
                           torch.from_numpy(gamma)),
           j_nn.leaky_relu(jnp.asarray(x), act, 0.3, jnp.asarray(gamma)),
           tol=1e-5)


def test_gelu_is_erf_not_tanh():
    """``npx.gelu`` defaults to the erf form; the two forms differ by
    ~1e-3 near |x| = 2, so the check can tell them apart."""
    x = torch.linspace(-3, 3, 61)
    exact = 0.5 * x * (1 + torch.erf(x / math.sqrt(2)))
    assert torch.allclose(t_nn.activation(x, "gelu"), exact, atol=1e-6)
    assert (t_nn.activation(x, "gelu_tanh") - exact).abs().max() > 1e-4


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected_matches_jax(flatten):
    x = _rand(23, 2, 3, 4)
    w = _rand(24, 5, 12 if flatten else 4)
    b = _rand(25, 5)
    _close(t_nn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b), flatten),
           j_nn.fully_connected(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), flatten))


def test_dot_product_attention_with_mask_matches_jax():
    q, k, v = _rand(26, 2, 3, 5, 8), _rand(27, 2, 3, 6, 8), _rand(28, 2, 3,
                                                                 6, 8)
    mask = (onp.arange(6)[None, :] < onp.array([4, 6])[:, None])
    mask = mask[:, None, None, :]
    _close(t_nn.dot_product_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v)),
                                      mask=torch.from_numpy(mask)),
           j_nn.dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      mask=jnp.asarray(mask)))


# ----------------------------------------------------------------------
# layers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(activation="relu"),
                                dict(flatten=False, activation="tanh"),
                                dict(use_bias=False)])
def test_dense_layer_matches_jax(kw):
    x = _rand(30, 2, 3, 4)
    jd, td = mx.gluon.nn.Dense(5, **kw), t_layers.Dense(5, **kw)
    assert is_deferred(td.weight)
    _pair(jd, td, x)
    _close(td(torch.from_numpy(x)), jd(NDArray(jnp.asarray(x))))


@pytest.mark.parametrize("axis,shape,kw", [
    (1, (4, 3, 5, 5), {}), (-1, (4, 5, 5, 3), {}),
    (1, (4, 3, 5, 5), dict(scale=False, center=False)),
    (1, (6, 3), dict(momentum=0.7, epsilon=1e-3))])
def test_batch_norm_layer_matches_jax(axis, shape, kw):
    """Two training calls (output and running statistics after each,
    with MXNet's momentum and the biased variance), then inference."""
    xs = [_rand(31 + i, *shape) * 2 + 1 for i in range(3)]
    jbn = mx.gluon.nn.BatchNorm(axis=axis, **kw)
    tbn = _pair(jbn, t_layers.BatchNorm(axis=axis, **kw), xs[0])
    for x in xs[:2]:
        with mx.autograd.record():
            jout = jbn(NDArray(jnp.asarray(x)))
        with autograd.record():
            tout = tbn(torch.from_numpy(x))
        _close(tout, jout)
        jp = _jparams(jbn)
        for name in ("running_mean", "running_var"):
            _close(getattr(tbn, name), jp[name], msg=name)
    _close(tbn(torch.from_numpy(xs[2])), jbn(NDArray(jnp.asarray(xs[2]))))
    assert not tbn.running_mean.requires_grad
    assert tbn.gamma.requires_grad == kw.get("scale", True)
    assert tbn.beta.requires_grad == kw.get("center", True)


def test_batch_norm_running_stats_rule():
    """running = 0.9 * running + 0.1 * batch, with the biased variance."""
    x = torch.from_numpy(_rand(34, 8, 2, 3, 3))
    bn = t_layers.BatchNorm(in_channels=2).initialize(device="cpu")
    with autograd.record():
        bn(x)
    xc = x.transpose(0, 1).reshape(2, -1)
    assert torch.allclose(bn.running_mean.detach(), 0.1 * xc.mean(1),
                          atol=1e-6)
    assert torch.allclose(bn.running_var.detach(),
                          0.9 + 0.1 * xc.var(1, unbiased=False), atol=1e-6)


@pytest.mark.parametrize("layer", ["LayerNorm", "LayerNorm1", "GroupNorm",
                                   "InstanceNorm"])
def test_norm_layers_match_jax(layer):
    x = _rand(35, 2, 4, 3, 3)
    make = {"LayerNorm": lambda m: m.LayerNorm(),
            "LayerNorm1": lambda m: m.LayerNorm(axis=1, epsilon=1e-3),
            "GroupNorm": lambda m: m.GroupNorm(num_groups=2),
            "InstanceNorm": lambda m: m.InstanceNorm()}[layer]
    jl = make(mx.gluon.nn)
    tl = _pair(jl, make(t_layers), x)
    _close(tl(torch.from_numpy(x)), jl(NDArray(jnp.asarray(x))))


ACT_LAYERS = {
    "Activation": lambda m: m.Activation("softrelu"),
    "LeakyReLU": lambda m: m.LeakyReLU(0.1),
    "PReLU": lambda m: m.PReLU(),
    "PReLU5": lambda m: m.PReLU(in_channels=5),
    "ELU": lambda m: m.ELU(0.5),
    "SELU": lambda m: m.SELU(),
    "GELU": lambda m: m.GELU(),
    "GELU_tanh": lambda m: m.GELU(approximation="tanh"),
    "Swish": lambda m: m.Swish(1.5),
    "SiLU": lambda m: m.SiLU(),
    "Mish": lambda m: m.Mish(),
}


@pytest.mark.parametrize("name", sorted(ACT_LAYERS))
def test_activation_layers_match_jax(name):
    x = _rand(36, 3, 5) * 3
    jl = ACT_LAYERS[name](mx.gluon.nn)
    tl = _pair(jl, ACT_LAYERS[name](t_layers), x)
    _close(tl(torch.from_numpy(x)), jl(NDArray(jnp.asarray(x))), tol=1e-5)


CONV_LAYERS = {
    "Conv2D-NHWC": (lambda m: m.Conv2D(6, 3, 2, 1, activation="relu",
                                       layout="NHWC"), (2, 9, 9, 4)),
    "Conv2D-groups": (lambda m: m.Conv2D(6, (3, 2), groups=2,
                                         dilation=(2, 1)), (2, 4, 9, 8)),
    "Conv1D": (lambda m: m.Conv1D(5, 3, padding=1), (2, 3, 10)),
    "Conv3D-NDHWC": (lambda m: m.Conv3D(4, 3, layout="NDHWC",
                                        use_bias=False), (1, 5, 5, 5, 2)),
    "Conv2DTranspose": (lambda m: m.Conv2DTranspose(
        4, 3, 2, 1, output_padding=1), (2, 3, 5, 5)),
    "Conv1DTranspose": (lambda m: m.Conv1DTranspose(3, 4, 2), (2, 2, 6)),
    "MaxPool2D-NHWC": (lambda m: m.MaxPool2D(3, 2, 1, layout="NHWC"),
                       (2, 9, 9, 3)),
    "AvgPool2D": (lambda m: m.AvgPool2D(3, 2, 1, count_include_pad=False),
                  (2, 3, 9, 9)),
    "AvgPool1D": (lambda m: m.AvgPool1D(), (2, 3, 8)),
    "MaxPool3D": (lambda m: m.MaxPool3D(), (1, 2, 4, 4, 4)),
    "GlobalAvgPool2D-NHWC": (lambda m: m.GlobalAvgPool2D(layout="NHWC"),
                             (2, 5, 5, 3)),
    "GlobalMaxPool1D": (lambda m: m.GlobalMaxPool1D(), (2, 3, 7)),
    "GlobalAvgPool3D": (lambda m: m.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
    "ReflectionPad2D": (lambda m: m.ReflectionPad2D(2), (2, 3, 5, 5)),
    "Flatten": (lambda m: m.Flatten(), (2, 3, 4)),
    "Identity": (lambda m: m.Identity(), (2, 3)),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_and_pool_layers_match_jax(name):
    make, shape = CONV_LAYERS[name]
    x = _rand(37, *shape)
    jl = make(mx.gluon.nn)
    tl = _pair(jl, make(t_layers), x)
    _close(tl(torch.from_numpy(x)), jl(NDArray(jnp.asarray(x))))


def _small_net(m, layout="NCHW"):
    ax = -1 if layout == "NHWC" else 1
    return m.HybridSequential(
        m.Conv2D(8, 3, padding=1, layout=layout), m.BatchNorm(axis=ax),
        m.Activation("relu"), m.GlobalAvgPool2D(layout=layout), m.Flatten(),
        m.Dense(10))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_deferred_shapes_and_names_match_jax(layout):
    """Parameters with an unknown input dimension take it from the first
    forward; names and shapes then equal the JAX package's."""
    x = _rand(38, 2, 3, 6, 6) if layout == "NCHW" else _rand(38, 2, 6, 6, 3)
    jnet, tnet = _small_net(mx.gluon.nn, layout), _small_net(t_layers, layout)
    tnet.initialize(device="cpu")
    assert is_deferred(tnet[0].weight) and is_deferred(tnet[5].weight)
    assert not is_deferred(tnet[0].bias)      # (channels,) is known
    jnet.initialize()
    jout = jnet(NDArray(jnp.asarray(x)))
    tnet(torch.from_numpy(x))
    jp = _jparams(jnet)
    tp = tnet.collect_params()
    assert list(tp) == list(jp)
    assert {k: tuple(p.shape) for k, p in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert all(type(p) is TorchParameter for p in tp.values())
    load_params(tnet, jp)
    _close(tnet(torch.from_numpy(x)), jout)


def test_forward_without_initialize_raises():
    net = t_layers.Dense(3)
    with pytest.raises(DeferredInitializationError):
        net(torch.ones(2, 4))


def test_sequential_indexing_and_hybridize_on_cpu_is_eager():
    """On the CPU ``hybridize()`` runs the block eagerly (CUDA graphs are
    CUDA-only): same result, nothing cached."""
    net = _small_net(t_layers).initialize(device="cpu")
    x = torch.from_numpy(_rand(39, 2, 3, 6, 6))
    with autograd.pause():
        want = net(x)
        net.hybridize()
        got = net(x)
    assert torch.equal(got, want) and not net._graphs
    assert len(net) == 6 and isinstance(net[1], t_layers.BatchNorm)
    assert len(net[:3]) == 3


def test_cast_and_grad_req():
    net = _small_net(t_layers).initialize(device="cpu")
    net(torch.ones(1, 3, 4, 4))
    net.cast("bfloat16")
    assert {p.dtype for p in net.parameters()} == {torch.bfloat16}
    assert net(torch.ones(1, 3, 4, 4, dtype=torch.bfloat16)).dtype == \
        torch.bfloat16
    net.setattr("grad_req", "null")
    assert not any(p.requires_grad for p in net.parameters())
    net.setattr("lr_mult", 2.0)
    assert {p.lr_mult for p in net.parameters()} == {2.0}
    with pytest.raises(AttributeError):
        net.setattr("no_such_attribute", 2.0)


def test_trainer_skips_batch_norm_statistics():
    net = _small_net(t_layers).initialize(device="cpu")
    x = torch.from_numpy(_rand(40, 4, 3, 6, 6))
    net(x)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        loss = net(x).square().mean()
    autograd.backward(loss)
    stats = {k: p.detach().clone() for k, p in net.collect_params().items()
             if "running" in k}
    trainer.step(4)            # no stale-gradient error for the statistics
    for k, v in stats.items():
        assert torch.equal(net.collect_params()[k].detach(), v), k


# ----------------------------------------------------------------------
# initializers (the draws differ by framework: their rules are tested)
# ----------------------------------------------------------------------
def _init(init, name, shape, seed=0):
    t = torch.empty(shape)
    init(initializer.InitDesc(name), t, torch.Generator().manual_seed(seed))
    return t


@pytest.mark.parametrize("name,value", [
    ("dense0.bias", 0.0), ("bn.gamma", 1.0), ("bn.beta", 0.0),
    ("bn.running_mean", 0.0), ("bn.running_var", 1.0),
    ("x.moving_mean", 0.0), ("x.moving_var", 1.0)])
def test_initializer_name_suffix_dispatch(name, value):
    t = _init(initializer.Uniform(0.5), name, (7,))
    assert torch.equal(t, torch.full((7,), value))


def test_explicit_initializer_overrides_suffix():
    t = torch.empty(5)
    initializer.Uniform()(initializer.InitDesc(
        "dense0.bias", {"__init__": initializer.Constant(3.0)}), t)
    assert torch.equal(t, torch.full((5,), 3.0))
    d = t_layers.Dense(4, in_units=3, bias_initializer="ones",
                       weight_initializer=initializer.Zero())
    d.initialize(device="cpu")
    assert torch.equal(d.bias.detach(), torch.ones(4))
    assert torch.equal(d.weight.detach(), torch.zeros(4, 3))


def test_uniform_and_normal_bounds_and_moments():
    u = _init(initializer.Uniform(), "w.weight", (200, 500))
    assert u.abs().max() <= 0.07 and u.abs().max() > 0.0699
    assert abs(u.mean()) < 1e-3 and abs(u.std() - 0.07 / math.sqrt(3)) < 1e-3
    n = _init(initializer.Normal(0.3), "w.weight", (200, 500))
    assert abs(n.mean()) < 3e-3 and abs(n.std() - 0.3) < 3e-3


@pytest.mark.parametrize("rnd,factor,shape", [
    ("uniform", "avg", (64, 32, 3, 3)), ("gaussian", "in", (128, 64, 3, 3)),
    ("uniform", "out", (256, 128)), ("gaussian", "avg", (256, 512))])
def test_xavier_variance_follows_fan(rnd, factor, shape):
    t = _init(initializer.Xavier(rnd, factor, 3), "conv.weight", shape)
    rf = math.prod(shape[2:])
    fan = {"in": shape[1] * rf, "out": shape[0] * rf,
           "avg": (shape[0] + shape[1]) * rf / 2}[factor]
    scale = math.sqrt(3 / fan)
    want_var = scale ** 2 / 3 if rnd == "uniform" else scale ** 2
    assert abs(t.var().item() / want_var - 1) < 0.03
    if rnd == "uniform":
        assert t.abs().max() <= scale


def test_msra_prelu_variance():
    shape = (128, 64, 3, 3)
    t = _init(initializer.MSRAPrelu("in", 0.25), "c.weight", shape)
    want_var = 2.0 / (1 + 0.25 ** 2) / (64 * 9)
    assert abs(t.var().item() / want_var - 1) < 0.03


@pytest.mark.parametrize("shape", [(8, 20), (20, 8), (6, 2, 3, 3)])
def test_orthogonal_rows_or_columns_are_orthonormal(shape):
    t = _init(initializer.Orthogonal(scale=2.0), "w.weight", shape)
    m = t.reshape(shape[0], -1) / 2.0
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    assert torch.allclose(gram, torch.eye(gram.shape[0]), atol=1e-5)


def test_constant_zero_one_mixed_and_seeded_draws():
    assert torch.equal(_init(initializer.Constant(2.5), "w", (3,)),
                       torch.full((3,), 2.5))
    assert torch.equal(_init(initializer.create("zeros"), "w", (3,)),
                       torch.zeros(3))
    assert torch.equal(_init(initializer.One(), "w", (3,)), torch.ones(3))
    mixed = initializer.Mixed(["conv.*", ".*"], [initializer.Constant(1.0),
                                                 initializer.Constant(2.0)])
    assert torch.equal(_init(mixed, "conv0.weight", (2,)), torch.ones(2))
    assert torch.equal(_init(mixed, "dense.weight", (2,)),
                       torch.full((2,), 2.0))
    a, b, c = (_init(initializer.Uniform(), "w", (50,), s) for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    for name in ("bilinear", "lstmbias"):
        with pytest.raises(NotImplementedError):
            _init(initializer.create(name), "w", (4, 4))


def test_block_initialize_uses_generator_and_default_uniform():
    def build():
        return t_layers.Dense(30, in_units=40).initialize(
            device="cpu", generator=torch.Generator().manual_seed(3))
    a, b = build(), build()
    assert torch.equal(a.weight, b.weight)
    assert a.weight.abs().max() <= 0.07 and torch.equal(a.bias,
                                                        torch.zeros(30))
    c = t_layers.Dense(30, in_units=40).initialize(
        init=initializer.Normal(1.0), device="cpu")
    assert c.weight.std() > 0.5
    before = a.weight.detach().clone()
    a.initialize(device="cpu")                 # already initialized: kept
    assert torch.equal(a.weight, before)
    a.initialize(device="cpu", force_reinit=True)
    assert not torch.equal(a.weight, before)


# ----------------------------------------------------------------------
# dropout (the masks differ by framework: its rules are tested)
# ----------------------------------------------------------------------
def test_dropout_rules():
    x = torch.from_numpy(_rand(41, 64, 64)) + 5.0

    def drop(seed, p=0.3, axes=None):
        return t_nn.dropout(x, p, torch.Generator().manual_seed(seed), axes)
    a, b, c = drop(1), drop(1), drop(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert torch.allclose(a[kept], x[kept] / 0.7)
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    assert torch.equal(t_nn.dropout(x, 0.0), x)
    shared = drop(3, 0.5, axes=(1,))      # the mask varies along axis 1 only
    assert torch.equal(shared != 0, (shared[:1] != 0).expand_as(shared))


def test_dropout_layer_only_drops_in_training():
    x = torch.ones(16, 16)
    layer = t_layers.Dropout(0.5)
    assert torch.equal(layer(x), x)                     # predict mode

    def masked(seed):
        torch.manual_seed(seed)
        with autograd.record():
            return layer(x)
    y = masked(0)
    assert set(y.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(masked(0), y) and not torch.equal(masked(1), y)
    with autograd.record():
        assert torch.equal(t_layers.Dropout(0.0)(x), x)


def test_recording_state_is_mxnets():
    """Recording is off outside any scope, as in MXNet, while torch's
    grad mode keeps its own default there; ``record`` turns both on,
    ``pause`` both off, and each scope restores both on exit."""
    assert torch.is_grad_enabled()
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and torch.is_grad_enabled()
        assert autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
            assert not torch.is_grad_enabled()
        assert autograd.is_recording() and torch.is_grad_enabled()
    assert not autograd.is_recording() and torch.is_grad_enabled()
    with torch.no_grad():
        with autograd.record():
            assert torch.is_grad_enabled()
        assert not torch.is_grad_enabled()
    try:
        assert not autograd.set_recording(True)
        assert autograd.set_recording(False) and not torch.is_grad_enabled()
    finally:
        autograd.set_recording(False)
        torch.set_grad_enabled(True)
