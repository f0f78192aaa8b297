"""The port's ResNets against the JAX package's model zoo: logits in
inference, then one training step -- BatchNorm in training mode, the
softmax CE, ``record`` / ``backward`` and a ``Trainer`` with SGD
(momentum 0.9, wd 1e-4) -- compared by loss, every gradient, every
weight after the update and both BatchNorm statistics.

The same numpy inputs and weights go through both packages: the
weights follow MXNet's default initialization, drawn by numpy, and go
into the JAX net by ``set_data`` and into the port by
``convert.load_params``.  The JAX nets run hybridized and in float64, with their
BatchNorm statistics reduced in float64 too (the JAX function reduces
in float32 whatever the input, ``_bn_train_f64`` below lifts that): a
float32 training step of these random nets is no reference.  Measured
here, the JAX package's own float32 gradients of ``resnet18_v2`` at 2 x
32 x 32 differ from its float64 ones by up to 30% (the port's float32
ones by 1e-5), and ResNet-50's float32 step at 1 x 64 x 64 is chaotic
in either framework: the port's float32 and float64 gradients differ by
up to 139% (loss 2e-4), through 53 train-mode BatchNorms on one image.

So: the port's float32 logits against the reference at 1e-4, both
layouts; the resnet18 steps with the port in float32 (loss at rtol 2e-5
/ atol 1e-6 as in ``test_torch_train.py``; gradients, weights and
statistics within 1e-4 of each tensor's largest value, measured 1.1e-5);
the ResNet-50 steps (``test_torch_resnet50.py``, a file of their own
so that the test workers run them beside these) with the port cast to
float64 (loss at 1e-10, gradients and statistics within 1e-8 of each
tensor's largest value; weights within 1e-6, because the port's SGD
rule computes in float32).
"""
import functools
from unittest import mock

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as j_vision
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import nn as j_nn
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import export_params, load_params
from mxnet_tpu_torch.gluon.model_zoo import vision as t_vision

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# (loss rtol, loss atol, grads and statistics, weights) by the port's dtype
TOLS = {torch.float32: (2e-5, 1e-6, 1e-4, 1e-4),
        torch.float64: (1e-10, 1e-12, 1e-8, 1e-6)}


def _bn_train_f64(x, gamma, beta, eps=1e-5, axis=1):
    """``mxnet_tpu.ops.nn.batch_norm_train`` with its statistics in the
    input's precision (float64 here) rather than always float32."""
    axis = axis % x.ndim
    axes = tuple(i for i in range(x.ndim) if i != axis)
    mean, var = jnp.mean(x, axis=axes), jnp.var(x, axis=axes)
    shape = [1] * x.ndim
    shape[axis] = -1
    out = (x - mean.reshape(shape)) * lax.rsqrt(var + eps).reshape(shape) \
        * gamma.reshape(shape) + beta.reshape(shape)
    return out, mean.astype(gamma.dtype), var.astype(gamma.dtype)


def _rel_err(got, want):
    return float(onp.abs(got - want).max()) / max(float(onp.abs(want).max()),
                                                  1e-30)


def _ohwi(arr):
    """An NCHW zoo weight in the NHWC layout: OIHW conv weights OHWI."""
    return arr.transpose(0, 2, 3, 1) if arr.ndim == 4 else arr


def _oihw(arr):
    return arr.transpose(0, 3, 1, 2) if arr.ndim == 4 else arr


def _net(version, depth, classes, kw, layout="NCHW"):
    return t_vision.get_resnet(version, depth, classes=classes,
                               layout=layout, **kw).initialize(device="cpu")


def _weights(net, x, seed):
    """MXNet's default initialization (Uniform(0.07) weights, unit gains
    and variances, zero biases, shifts and means) drawn by numpy in
    float32, by the names and shapes of the port's NCHW ``net``."""
    with autograd.pause():
        net(torch.from_numpy(x))                    # deferred shapes
    rng = onp.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        if name.endswith(("gamma", "running_var")):
            arr = onp.ones(p.shape)
        elif name.endswith(("beta", "bias", "running_mean")):
            arr = onp.zeros(p.shape)
        else:
            arr = rng.uniform(-0.07, 0.07, p.shape)
        out[name] = arr.astype(onp.float32)
    return out


def _jax_net(version, depth, classes, kw, params, dtype, layout="NCHW"):
    """The JAX zoo net holding ``params`` in ``dtype`` (zero-initialized
    first: ``set_data`` gives a deferred parameter its shape)."""
    jnet = j_vision.get_resnet(version, depth, classes=classes, layout=layout,
                               **kw)
    jnet.initialize(mx.init.Zero())
    jnet.cast(dtype)
    for name, p in jnet.collect_params().items():
        p.set_data(NDArray(jnp.asarray(params[name], dtype)))
    return jnet


@functools.lru_cache(maxsize=None)
def _reference(version, depth, x_shape, classes, thumbnail=False):
    """The NCHW input, labels and weights, and the JAX net's float64
    logits and training step on them (hybridized, BatchNorm statistics
    in float64): (x, labels, params, logits, loss, grads, weights
    after).  Cached, so that both layouts compare with one run."""
    kw = {"thumbnail": True} if thumbnail else {}
    rng = onp.random.RandomState(depth + version)
    x = rng.randn(*x_shape).astype(onp.float32)
    labels = rng.randint(0, classes, x_shape[0]).astype(onp.int32)
    params = _weights(_net(version, depth, classes, kw), x, depth)
    with mock.patch.object(j_nn, "batch_norm_train", _bn_train_f64), \
            jax.enable_x64(True):
        jnet = _jax_net(version, depth, classes, kw, params, "float64")
        jnet.hybridize()
        jx = NDArray(jnp.asarray(x, jnp.float64))
        jy = NDArray(jnp.asarray(labels))
        jlogits = onp.asarray(jnet(jx)._data)
        jtrainer = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
        with mx.autograd.record():
            jloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(jnet(jx), jy)
        jloss.backward()
        jgrads = {k: onp.asarray(p.grad()._data)
                  for k, p in jnet.collect_params().items()
                  if p.grad_req != "null"}
        jtrainer.step(x_shape[0])
        jafter = {k: onp.asarray(p.data()._data)
                  for k, p in jnet.collect_params().items()}
    return x, labels, params, jlogits, onp.asarray(jloss._data), jgrads, \
        jafter


def _check_step(version, depth, x_shape, dtype, layout="NCHW", classes=10,
                thumbnail=False):
    """The port in ``layout`` against the JAX reference: float32 logits,
    then one training step with the port in ``dtype``.  In NHWC the
    input and conv weights are the reference's, transposed, and the
    logits are also held against the JAX package's own NHWC net in
    float32."""
    x, labels, params, jlogits, jloss, jgrads, jafter = _reference(
        version, depth, x_shape, classes, thumbnail)
    kw = {"thumbnail": True} if thumbnail else {}
    to_layout, back = (_ohwi, _oihw) if layout == "NHWC" else \
        (lambda a: a, lambda a: a)
    xin = onp.ascontiguousarray(to_layout(x))
    tnet = load_params(_net(version, depth, classes, kw, layout),
                       {k: onp.ascontiguousarray(to_layout(v))
                        for k, v in params.items()})
    with autograd.pause():                          # float32 inference
        tlogits = tnet(torch.from_numpy(xin)).numpy()
    onp.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)
    if layout == "NHWC":
        jnet = _jax_net(version, depth, classes, kw,
                        {k: to_layout(v) for k, v in params.items()},
                        "float32", layout)
        onp.testing.assert_allclose(
            tlogits, onp.asarray(jnet(NDArray(jnp.asarray(xin)))._data),
            rtol=1e-4, atol=1e-4)

    tnet.cast(dtype)
    trainer = gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    with autograd.record():
        tloss = gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet(torch.from_numpy(xin).to(dtype)), torch.from_numpy(labels))
    autograd.backward(tloss)
    tgrads = {k: back(p.grad.double().numpy())
              for k, p in tnet.collect_params().items() if p.requires_grad}
    trainer.step(x_shape[0])
    tafter = {k: back(v) for k, v in export_params(tnet).items()}

    loss_rtol, loss_atol, grad_tol, weight_tol = TOLS[dtype]
    onp.testing.assert_allclose(tloss.detach().double().numpy(), jloss,
                                rtol=loss_rtol, atol=loss_atol)
    assert sorted(tgrads) == sorted(jgrads)
    for name in jgrads:
        err = _rel_err(tgrads[name], jgrads[name])
        assert err <= grad_tol, "grad %s: %.3e" % (name, err)
    assert sorted(tafter) == sorted(jafter)
    stats = [k for k in jafter if "running" in k]
    assert len(stats) >= 2
    for name in jafter:
        err = _rel_err(tafter[name], jafter[name])
        tol = grad_tol if name in stats else weight_tol
        assert err <= tol, "%s after the step: %.3e" % (name, err)


@pytest.mark.parametrize("version", [1, 2])
def test_resnet18_thumbnail_matches_jax(version):
    _check_step(version, 18, (2, 3, 32, 32), torch.float32, thumbnail=True)


def test_resnet50_names_and_nhwc_weights():
    """The zoo's names are the JAX package's, in its order (the shapes
    are checked by ``load_params`` in the tests above); NHWC stores the
    same names with OHWI conv weights, and NHWC on permuted weights and
    input gives the NCHW logits."""
    x = onp.random.RandomState(0).randn(1, 3, 32, 32).astype(onp.float32)
    nets = {}
    for layout in ("NCHW", "NHWC"):
        net = t_vision.resnet50_v1(layout=layout).initialize(
            device="cpu", generator=torch.Generator().manual_seed(0))
        xin = x if layout == "NCHW" else x.transpose(0, 2, 3, 1)
        with autograd.pause():
            net(torch.from_numpy(onp.ascontiguousarray(xin)))
        nets[layout] = net
    nchw = nets["NCHW"].collect_params()
    assert list(nchw) == list(j_vision.resnet50_v1().collect_params())
    assert list(nets["NHWC"].collect_params()) == list(nchw)
    conv = [k for k, p in nchw.items() if p.dim() == 4]
    assert len(conv) == 53
    params = export_params(nets["NCHW"])
    for k in conv:
        params[k] = onp.ascontiguousarray(params[k].transpose(0, 2, 3, 1))
    load_params(nets["NHWC"], params)
    with autograd.pause():
        want = nets["NCHW"](torch.from_numpy(x))
        got = nets["NHWC"](torch.from_numpy(
            onp.ascontiguousarray(x.transpose(0, 2, 3, 1))))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_get_model():
    assert isinstance(t_vision.get_model("ResNet18_v2"), t_vision.ResNetV2)
    assert isinstance(t_vision.get_model("vgg16"), t_vision.VGG)
    with pytest.raises(ValueError):
        t_vision.get_model("resnet19_v1")
