"""The port's NDArray, its autograd and the Gluon parameter surface
against the JAX package.

The same seeded numpy inputs (and, for Gluon, the same weights copied
across as numpy) go through ``mxnet_tpu`` and, under ``with mx.cpu():``,
through ``mxnet_tpu_torch``: arithmetic, comparison and indexing
dunders, conversions, ``attach_grad`` / ``backward`` on a non-scalar
head (``grad_req`` ``"write"`` and ``"add"``), ``autograd.grad``, one SGD
step with ``lr_mult`` / ``wd_mult``, ``share_parameters`` and the
``Parameter`` accessors.  Both packages run float32: rtol 1e-5 / atol
1e-6 (the float32 rounding of a few operations), integer and bool
results exactly.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray.ndarray import NDArray

RTOL, ATOL = 1e-5, 1e-6


def _rand(seed, *shape):
    return onp.random.RandomState(seed).uniform(-1, 1, shape).astype(
        onp.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


X = _rand(0, 3, 4)
Y = _rand(1, 3, 4)
IDX = onp.array([2, 0, 2], onp.int32)

OPS = {
    "add": lambda a, b: a + b, "radd": lambda a, b: 2.5 + a,
    "sub": lambda a, b: a - b, "rsub": lambda a, b: 1 - a,
    "mul": lambda a, b: a * b, "rmul": lambda a, b: 3 * a,
    "div": lambda a, b: a / (b + 2), "rdiv": lambda a, b: 1 / (a + 2),
    "floordiv": lambda a, b: a // 0.3, "mod": lambda a, b: a % 0.3,
    "pow": lambda a, b: (a + 2) ** 1.5, "rpow": lambda a, b: 2 ** a,
    "matmul": lambda a, b: a @ b.T, "neg": lambda a, b: -a,
    "abs": lambda a, b: abs(a), "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != 0.5, "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b, "gt": lambda a, b: a > 0,
    "ge": lambda a, b: a >= b, "getitem_int": lambda a, b: a[1],
    "getitem_slice": lambda a, b: a[1:, ::2],
    "getitem_neg": lambda a, b: a[-1, -2],
    "getitem_none": lambda a, b: a[:, None, 1],
    "getitem_ellipsis": lambda a, b: a[..., 0],
    "getitem_list": lambda a, b: a[[0, 2]],
    "getitem_array": lambda a, b: a[:, onp.array([3, 0])],
    "getitem_ndarray": lambda a, b: a[type(a)(IDX)],
    "getitem_mask": lambda a, b: a[a > 0],
    "T": lambda a, b: a.T, "reshape": lambda a, b: a.reshape(2, 6),
    "reshape_tuple": lambda a, b: a.reshape((4, -1)),
    "flatten": lambda a, b: a.reshape(3, 2, 2).flatten(),
    "transpose": lambda a, b: a.transpose(), "squeeze":
        lambda a, b: a.reshape(1, 3, 4).squeeze(),
    "expand_dims": lambda a, b: a.expand_dims(1),
    "swapaxes": lambda a, b: a.swapaxes(0, 1),
    "broadcast_to": lambda a, b: a[:1].broadcast_to((2, 3, 4)),
    "repeat": lambda a, b: a.repeat(2, axis=0),
    "tile": lambda a, b: a.tile((2, 1)), "clip": lambda a, b: a.clip(-.2, .3),
    "sum": lambda a, b: a.sum(axis=1), "mean": lambda a, b: a.mean(),
    "max": lambda a, b: a.max(axis=0), "min": lambda a, b: a.min(),
    "prod": lambda a, b: a.prod(axis=1), "std": lambda a, b: a.std(),
    "var": lambda a, b: a.var(axis=0), "cumsum": lambda a, b: a.cumsum(1),
    "argmax": lambda a, b: a.argmax(axis=1),
    "argmin": lambda a, b: a.argmin(),
    "argsort_desc": lambda a, b: a.argsort(axis=1, is_ascend=False),
    "sort": lambda a, b: a.sort(axis=0), "round": lambda a, b: a.round(2),
    "sqrt": lambda a, b: (a + 1).sqrt(), "exp": lambda a, b: a.exp(),
    "log": lambda a, b: (a + 2).log(), "sigmoid": lambda a, b: a.sigmoid(),
    "tanh": lambda a, b: a.tanh(), "relu": lambda a, b: a.relu(),
    "softmax": lambda a, b: a.softmax(), "log_softmax":
        lambda a, b: a.log_softmax(axis=0),
    "norm": lambda a, b: a.norm(), "dot": lambda a, b: a.dot(b.T),
    "take": lambda a, b: a.take(type(a)(IDX), axis=1),
    "astype": lambda a, b: a.astype("int32"),
    "one_hot": lambda a, b: type(a)(IDX).one_hot(4),
}


def _pair(fn, *arrays):
    with tmx.cpu():
        got = fn(*[NDArray(a) for a in arrays])
    want = fn(*[jmx.nd.array(a) for a in arrays])
    return got.asnumpy(), want.asnumpy()


@pytest.mark.parametrize("name", sorted(OPS))
def test_ndarray_methods_and_dunders_match_jax(name):
    _close(*_pair(OPS[name], X, Y))


SETITEM = {
    "slice_scalar": lambda a: a.__setitem__((slice(None), 1), 5.0),
    "int_array": lambda a: a.__setitem__(1, onp.arange(4, dtype="f4")),
    "ellipsis_ndarray": lambda a: a.__setitem__(
        Ellipsis, type(a)(onp.ones((3, 4), "f4"))),
    "mask": lambda a: a.__setitem__(a > 0, 0.0),
    "neg_index": lambda a: a.__setitem__((-1, -1), 7.0),
    "iadd": lambda a: a.__iadd__(2.0), "isub": lambda a: a.__isub__(a),
    "imul": lambda a: a.__imul__(3.0), "idiv": lambda a: a.__itruediv__(4),
}


@pytest.mark.parametrize("name", sorted(SETITEM))
def test_ndarray_writes_match_jax(name):
    with tmx.cpu():
        t = NDArray(X.copy())
        SETITEM[name](t)
    j = jmx.nd.array(X.copy())
    SETITEM[name](j)
    _close(t.asnumpy(), j.asnumpy())


def test_conversions_and_properties():
    with tmx.cpu():
        a = tmx.np.array(X)
        assert a.shape == (3, 4) and a.size == 12 and a.ndim == 2
        assert a.dtype == onp.float32 and a.itemsize == 4
        assert a.context == tmx.cpu() and a.ctx == a.device
        assert a.astype("bfloat16").dtype == torch.bfloat16
        assert onp.array_equal(a.astype("bfloat16").asnumpy(),
                               torch.from_numpy(X).bfloat16().float())
        assert a[0, 0].asscalar() == a[0, 0].item() == float(X[0, 0])
        assert a.tolist() == X.tolist() and len(a) == 3
        assert [r.shape for r in a] == [(4,)] * 3
        assert onp.array_equal(onp.asarray(a), X)
        b = tmx.np.zeros((3, 4))
        assert a.copyto(b) is b and onp.array_equal(b.asnumpy(), X)
        c = a.copy()
        c[0, 0] = 9.0
        assert a[0, 0].item() == X[0, 0]          # a copy owns its data
        assert a.as_in_context(tmx.cpu()) is a
        assert int(tmx.np.array(3)) == 3 and bool(tmx.np.array(1.0))
        with pytest.raises(ValueError):
            bool(a)
        a.wait_to_read()
        tmx.nd.waitall()


# ----------------------------------------------------------------------
# autograd: attach_grad / backward / grad
# ----------------------------------------------------------------------
def _grads(mx, head_grad=None, steps=1, grad_req="write", seed=2):
    """Gradients of a non-scalar head (B, 3) of x (B, 4) and w (3, 4)
    after ``steps`` backward passes."""
    xv, wv = _rand(seed, 5, 4), _rand(seed + 1, 3, 4)
    x, w = mx.nd.array(xv), mx.nd.array(wv)
    x.attach_grad(grad_req)
    w.attach_grad(grad_req)
    for _ in range(steps):
        with mx.autograd.record():
            y = mx.np.tanh(mx.np.dot(x, w.T)) * x[:, :3]
        y.backward(None if head_grad is None else mx.nd.array(head_grad))
    return x.grad.asnumpy(), w.grad.asnumpy()


@pytest.mark.parametrize("case", ["ones", "head_grad", "write_twice",
                                  "add_twice"])
def test_backward_on_a_non_scalar_head_matches_jax(case):
    kw = {"ones": {}, "head_grad": {"head_grad": _rand(9, 5, 3)},
          "write_twice": {"steps": 2},
          "add_twice": {"steps": 2, "grad_req": "add"}}[case]
    with tmx.cpu():
        got = _grads(tmx, **kw)
    want = _grads(jmx, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    if case == "add_twice":                # "add" accumulates, "write" not
        once = _grads(jmx)
        _close(got[0], 2 * once[0], rtol=1e-5)


def test_grad_buffer_is_a_live_handle_and_zero_grad():
    with tmx.cpu():
        x = tmx.np.array(X)
        x.attach_grad()
        g = x.grad
        assert not g.asnumpy().any()               # zeros before backward
        with tmx.autograd.record():
            (x * x).backward()
        onp.testing.assert_allclose(g.asnumpy(), 2 * X, rtol=1e-6)
        x.zero_grad()
        assert not g.asnumpy().any()
        x[0, 0] = 4.0               # writing a variable keeps it a leaf
        with tmx.autograd.record():
            (3 * x).backward()
        onp.testing.assert_allclose(g.asnumpy(), onp.full_like(X, 3.0))


def test_autograd_grad_returns_ndarrays_like_jax():
    def run(mx):
        x = mx.nd.array(X)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.sin(x) * x
        return mx.autograd.grad(y, [x])[0].asnumpy()
    with tmx.cpu():
        got = run(tmx)
    _close(got, run(jmx))


# ----------------------------------------------------------------------
# Gluon: lr_mult / wd_mult, share_parameters, the Parameter accessors
# ----------------------------------------------------------------------
def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(6, in_units=4, activation="relu"))
    net.add(mx.gluon.nn.Dense(3, in_units=6))
    return net


def _sgd_step(mx, params, net):
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(params[k]))
    net.collect_params()["0.weight"].lr_mult = 0.5
    net.collect_params()["0.bias"].lr_mult = 0.0
    net.collect_params()["1.weight"].wd_mult = 3.0
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "wd": 0.01,
                                "momentum": 0.9})
    x, lab = mx.nd.array(_rand(4, 5, 4)), mx.nd.array(
        onp.array([0, 2, 1, 1, 0], onp.int32))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(x), lab)
    loss.backward()
    trainer.step(5)
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_lr_mult_and_wd_mult_in_one_sgd_step_match_jax():
    jnet = _mlp(jmx)
    jnet.initialize()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    want = _sgd_step(jmx, params, jnet)
    with tmx.cpu():
        tnet = _mlp(tmx)
        tnet.initialize()
        got = _sgd_step(tmx, params, tnet)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    assert onp.array_equal(got["0.bias"], params["0.bias"])   # lr_mult 0


def test_block_setattr_lr_mult_and_grad_req_add():
    with tmx.cpu():
        net = _mlp(tmx)
        net.initialize()
        net.setattr("wd_mult", 0.0)
        net.setattr("grad_req", "add")
        assert {p.wd_mult for p in net.parameters()} == {0.0}
        x = tmx.np.array(_rand(5, 2, 4))
        for _ in range(2):
            with tmx.autograd.record():
                net(x).sum().backward()
        w = net.collect_params()["1.weight"]
        twice = w.grad().asnumpy()
        w.zero_grad()
        with tmx.autograd.record():
            net(x).sum().backward()
        onp.testing.assert_allclose(twice, 2 * w.grad().asnumpy(), rtol=1e-6)
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1})
        trainer.step(1)
        assert w.grad is not None          # "add" keeps its gradient


def test_share_parameters_matches_jax():
    def run(mx):
        a, b = _mlp(mx), _mlp(mx)
        a.initialize()
        b.initialize()
        b.share_parameters(a.collect_params())
        x = mx.nd.array(_rand(6, 2, 4))
        return a(x).asnumpy(), b(x).asnumpy(), \
            b.collect_params()["0.weight"] is a.collect_params()["0.weight"]
    with tmx.cpu():
        ta, tb, tsame = run(tmx)
    ja, jb, jsame = run(jmx)
    assert tsame and jsame
    onp.testing.assert_array_equal(ta, tb)
    onp.testing.assert_array_equal(ja, jb)


def test_parameter_accessors_share_storage():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        p = net.collect_params()["weight"]
        d = p.data()
        assert isinstance(d, NDArray) and d._data is p
        assert [x._data for x in p.list_data()] == [p]
        d[0, 0] = 5.0                          # writes the parameter
        assert p[0, 0].item() == 5.0
        p.set_data(onp.ones((3, 4), onp.float64))
        assert p.dtype == torch.float32 and bool((d._data == 1).all())
        with tmx.autograd.record():
            net(tmx.np.ones((2, 4))).sum().backward()
        onp.testing.assert_allclose(p.grad().asnumpy(), onp.full((3, 4), 2.0))
        assert p.list_grad()[0].shape == (3, 4)
        const = tmx.gluon.parameter.Constant(onp.arange(3, dtype="f4"))
        blk = tmx.gluon.Block()
        blk.c = const
        blk.initialize()
        assert not blk.c.requires_grad and blk.c.grad_req == "null"
        onp.testing.assert_array_equal(blk.c.data().asnumpy(), [0, 1, 2])
        deferred = tmx.gluon.nn.Dense(3)
        deferred.initialize()
        with pytest.raises(tmx.gluon.DeferredInitializationError):
            deferred.weight.list_data()


def test_engine_naive_mode_and_bulk():
    prev = tmx.engine.set_engine_type("NaiveEngine")
    try:
        assert tmx.engine.is_naive()
        with tmx.cpu():
            assert (tmx.np.ones(3) + 1).sum().item() == 6.0
    finally:
        tmx.engine.set_engine_type(prev)
    assert not tmx.engine.is_naive()
    with pytest.raises(ValueError):
        tmx.engine.set_engine_type("NoSuchEngine")
    with tmx.engine.bulk(30):
        assert tmx.engine.set_bulk_size(30) == 30


# F4: basic indexing with a negative slice step (ROADMAP section 3)
NEG_STEP_READS = {
    "reverse": lambda a: a.reshape(-1)[::-1],
    "step_minus_2": lambda a: a.reshape(-1)[8:2:-2],
    "two_axes": lambda a: a[::-1, 3:0:-2],
    "with_int_and_newaxis": lambda a: a[None, 1, ::-3],
    "ellipsis": lambda a: a[..., ::-2],
    "empty": lambda a: a[1:2:-1],
    "with_index_array": lambda a: a[type(a)(IDX), ::-1],
}


@pytest.mark.parametrize("name", sorted(NEG_STEP_READS))
def test_negative_slice_step_reads_match_jax(name):
    _close(*_pair(NEG_STEP_READS[name], X))


NEG_STEP_WRITES = {
    "scalar": lambda a: a.__setitem__((slice(None), slice(None, None, -2)),
                                      0.0),
    "array": lambda a: a.__setitem__(
        (slice(None, None, -1), 1), type(a)(onp.arange(3, dtype="f4"))),
    "broadcast_row": lambda a: a.__setitem__(
        (slice(2, 0, -1),), type(a)(onp.arange(4, dtype="f4"))),
}


@pytest.mark.parametrize("name", sorted(NEG_STEP_WRITES))
def test_negative_slice_step_writes_match_jax(name):
    with tmx.cpu():
        t = NDArray(X.copy())
        NEG_STEP_WRITES[name](t)
    j = jmx.nd.array(X.copy())
    NEG_STEP_WRITES[name](j)
    _close(t.asnumpy(), j.asnumpy())


def test_negative_slice_step_write_records_a_gradient():
    """A write through a negative step under ``record`` is out of place
    and keeps the gradient of what it did not overwrite, as in JAX."""
    def run(mx, arr):
        x = arr(X.copy())
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            y[::-1, 0] = 0.0
            z = (y * y).sum()
        z.backward()
        return x.grad.asnumpy()
    with tmx.cpu():
        got = run(tmx, NDArray)
    _close(got, run(jmx, jmx.nd.array))
