"""Fault F15 of the port's imperative surface, each case held against the
JAX package on the same numpy inputs (``with mx.cpu():``):
``gluon.nn.Embedding(sparse_grad=)``, ``optimizer.SGD`` / ``NAG(
lazy_update=)``, ``gluon.Parameter(stype=, grad_stype=)``,
``mx.np.current_context`` and the ``npx.contrib`` ops that ``nd.contrib``
re-exports.

An Embedding is trained two steps with a Trainer (momentum 0.9, wd 1e-4)
with ``sparse_grad`` and ``lazy_update`` on and off: in both packages
the flags change nothing (dense gradients, every row updated), so the
four runs of a package give the same weights bit for bit, and the
port's equal the reference's within float32 rounding (rtol 1e-6, atol
1e-7).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import nn as tnn

RTOL, ATOL = 1e-6, 1e-7
W = onp.random.RandomState(0).randn(10, 4).astype(onp.float32)
IDX = onp.array([[1, 3, 3], [0, 9, 1]], onp.int32)


def _train_jax(opt, sparse_grad, lazy):
    net = jnn.Embedding(10, 4, sparse_grad=sparse_grad)
    with mx.cpu():
        net.initialize()
        net.weight.set_data(mx.np.array(W))
        tr = mx.gluon.Trainer(net.collect_params(), opt, {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
            "lazy_update": lazy})
        for _ in range(2):
            with mx.autograd.record():
                loss = (net(mx.np.array(IDX)) ** 2).sum()
            loss.backward()
            tr.step(2)
        return net.weight.data().asnumpy()


def _train_port(opt, sparse_grad, lazy):
    net = tnn.Embedding(10, 4, sparse_grad=sparse_grad)
    net.initialize(device="cpu")
    mt.convert.load_params(net, {"weight": W})
    tr = mt.gluon.Trainer(net.collect_params(), opt, {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "lazy_update": lazy})
    with mt.cpu():
        for _ in range(2):
            with mt.autograd.record():
                loss = (net(mt.np.array(IDX)._data) ** 2).sum()
            mt.autograd.backward(loss)
            tr.step(2)
    return net.weight.detach().numpy().copy()


@pytest.mark.parametrize("opt", ["sgd", "nag"])
def test_embedding_sparse_grad_and_lazy_update_step_as_the_reference(opt):
    runs = {(sg, lz): (_train_jax(opt, sg, lz), _train_port(opt, sg, lz))
            for sg in (False, True) for lz in (False, True)}
    base_j, base_t = runs[(False, False)]
    assert not onp.allclose(base_t, W)          # the step moved the rows
    for (sg, lz), (want, got) in runs.items():
        onp.testing.assert_array_equal(want, base_j)
        onp.testing.assert_array_equal(got, base_t)
        onp.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cls", ["SGD", "NAG"])
def test_optimizer_accepts_lazy_update(cls):
    for pkg in (mx, mt):
        opt = getattr(pkg.optimizer, cls)(learning_rate=0.5, momentum=0.9,
                                          lazy_update=True)
        assert opt.momentum == 0.9
    assert isinstance(mt.optimizer.create("sgd", lazy_update=False),
                      mt.optimizer.SGD)


@pytest.mark.parametrize("stype", [("row_sparse", "default"),
                                   ("default", "row_sparse"),
                                   ("csr", "row_sparse")])
def test_parameter_sparse_stypes_initialize_dense(stype):
    jp = mx.gluon.Parameter(shape=(2, 3), name="w", stype=stype[0],
                            grad_stype=stype[1], init=mx.init.One())
    jp.initialize(ctx=mx.cpu())
    tp = mt.gluon.Parameter(shape=(2, 3), stype=stype[0],
                            grad_stype=stype[1], init=mt.init.One())
    mt.gluon.parameter.initialize(tp, "w", mt.init.One(), "cpu")
    onp.testing.assert_array_equal(tp.data().asnumpy(),
                                   jp.data().asnumpy())
    assert tp.data().stype == "default"


def test_np_current_context_is_the_scope():
    assert mt.np.current_context is mt.current_context
    with mt.cpu():
        assert mt.np.current_context().device_type == "cpu"
    with mx.cpu():
        assert mx.np.current_context().device_type == "cpu"


NPX_CONTRIB = ["box_iou", "box_nms", "roi_align", "roi_pooling",
               "interleaved_matmul_selfatt_qk",
               "interleaved_matmul_selfatt_valatt",
               "interleaved_matmul_encdec_qk",
               "interleaved_matmul_encdec_valatt"]


@pytest.mark.parametrize("name", NPX_CONTRIB + ["ROIAlign"])
def test_nd_contrib_reexports_npx_contrib(name):
    src = "roi_align" if name == "ROIAlign" else name
    assert getattr(mt.nd.contrib, name) is getattr(mt.npx.contrib, src)
    assert hasattr(mx.nd.contrib, name)


def test_reexported_box_iou_matches_the_reference():
    rng = onp.random.RandomState(1)
    a = onp.sort(rng.rand(4, 2, 2), axis=1).reshape(4, 4)[:, [0, 2, 1, 3]]
    b = onp.sort(rng.rand(3, 2, 2), axis=1).reshape(3, 4)[:, [0, 2, 1, 3]]
    with mx.cpu():
        want = mx.nd.contrib.box_iou(mx.np.array(a), mx.np.array(b))
    with mt.cpu():
        got = mt.nd.contrib.box_iou(mt.np.array(a), mt.np.array(b))
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-6)
