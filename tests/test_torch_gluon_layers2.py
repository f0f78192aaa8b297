"""The layers, ops and autograd pieces of the vision zoo's slice against
the JAX package: ``Lambda`` / ``HybridLambda`` (a name of ``mx.np`` and
an ``F`` callable over ``F.clip``), ``Concatenate`` /
``HybridConcatenate``, ``nd.clip`` and ``autograd.Function`` (the
reference docstring's sigmoid and a two-output function, values and
gradients), all on the same numpy inputs at 1e-6 (float32; the same
arithmetic); and ``ceil_mode=True`` pooling against a numpy pooling
written here (the JAX package accepts the option and ignores it).
``SyncBatchNorm`` on dp=2 ranks is in ``test_torch_sharding.py``, which
starts the ranks once for all its cases.
"""
import itertools

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import nn as tnn

TOL = 1e-6


def _x(seed, *shape):
    return onp.random.RandomState(seed).normal(0, 2, shape).astype("float32")


def _close(got, want, tol=TOL):
    got = got.asnumpy() if hasattr(got, "asnumpy") else \
        got.detach().numpy()
    want = want.asnumpy() if hasattr(want, "asnumpy") else want
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("fn", ["tanh", "abs", "sign"])
def test_lambda_by_name(fn):
    x = _x(0, 3, 4)
    want = jnn.Lambda(fn)(mx.np.array(x))
    _close(tnn.Lambda(fn)(torch.from_numpy(x)), want)
    hyb = tnn.HybridLambda(fn)
    hyb.hybridize()
    _close(hyb(mt.nd.array(x, ctx=mt.cpu())), jnn.HybridLambda(fn)(
        mx.np.array(x)))


def test_hybrid_lambda_hands_f_its_nd():
    """MobileNet's ReLU6, ``lambda F, x: F.clip(x, 0, 6)``; and a two-input
    callable."""
    x, y = _x(1, 2, 3, 5), _x(2, 2, 3, 5) * 4
    relu6 = lambda F, a: F.clip(a, 0, 6)  # noqa: E731
    want = jnn.HybridLambda(relu6)(mx.np.array(y))
    _close(tnn.HybridLambda(relu6)(torch.from_numpy(y)), want)
    assert float(want.asnumpy().max()) == 6.0
    two = lambda F, a, b: F.clip(a * b, -1, 1)  # noqa: E731
    _close(tnn.HybridLambda(two)(torch.from_numpy(x), torch.from_numpy(y)),
           jnn.HybridLambda(two)(mx.np.array(x), mx.np.array(y)))
    _close(mt.nd.clip(torch.from_numpy(y), -2, 3),
           mx.nd.clip(mx.np.array(y), -2, 3))


@pytest.mark.parametrize("hybrid,axis", itertools.product([False, True],
                                                           [1, -1]))
def test_concatenate_runs_each_child_on_the_input(hybrid, axis):
    x = _x(3, 4, 6)
    rs = onp.random.RandomState(4)
    ws = [(rs.normal(0, 0.5, (u, 6)).astype("float32"),
           rs.normal(0, 0.5, (u,)).astype("float32")) for u in (3, 2, 5)]

    def build(nn, params):
        blk = (nn.HybridConcatenate if hybrid else nn.Concatenate)(axis=axis)
        for w, b in ws:
            blk.add(nn.Dense(w.shape[0], in_units=6))
        return blk
    jb = build(jnn, ws)
    jb.initialize()
    for i, (w, b) in enumerate(ws):
        jb[i].weight.set_data(mx.np.array(w))
        jb[i].bias.set_data(mx.np.array(b))
    tb = build(tnn, ws)
    tb.load_dict({"%d.%s" % (i, k): v for i, (w, b) in enumerate(ws)
                  for k, v in (("weight", w), ("bias", b))}, device="cpu")
    if hybrid:
        tb.hybridize()
    want = jb(mx.np.array(x))
    _close(tb(torch.from_numpy(x)), want)
    assert want.shape == (4, 10)
    assert list(tb.collect_params()) == list(jb.collect_params())


class _JSigmoid(mx.autograd.Function):
    def forward(self, x):
        y = 1 / (1 + mx.np.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


class _TSigmoid(autograd.Function):
    def forward(self, x):
        y = 1 / (1 + mt.np.exp(-x))
        self.save_for_backward(y)
        return y

    def backward(self, dy):
        y, = self.saved_tensors
        return dy * y * (1 - y)


def _two(base, np):
    class Two(base):
        """(a * b, a - b) with a hand-written backward that scales the
        first output's gradient by 2 (so it is not autograd's)."""

        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a - b

        def backward(self, d1, d2):
            a, b = self.saved_tensors
            return 2 * d1 * b + d2, 2 * d1 * a - d2
    return Two


def test_function_sigmoid_values_and_gradient():
    x = _x(5, 3, 4)
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = _JSigmoid()(jx)
    jy.backward()
    with mt.cpu():
        tx = mt.np.array(x)
        tx.attach_grad()
        with autograd.record():
            ty = _TSigmoid()(tx)
        ty.backward()
    _close(ty, jy)
    _close(tx.grad, jx.grad)
    # outside record() only forward runs, and records nothing
    out = _TSigmoid()(torch.from_numpy(x).requires_grad_(True))
    assert out._data.grad_fn is None
    _close(out, jy)


def test_function_two_outputs_and_tensor_inputs():
    a, b, g1, g2 = (_x(s, 2, 5) for s in (6, 7, 8, 9))
    ja, jb = mx.np.array(a), mx.np.array(b)
    ja.attach_grad()
    jb.attach_grad()
    with mx.autograd.record():
        o1, o2 = _two(mx.autograd.Function, mx.np)()(ja, jb)
    mx.autograd.backward([o1, o2], [mx.np.array(g1), mx.np.array(g2)])
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    with autograd.record():
        p1, p2 = _two(autograd.Function, mt.np)()(ta, tb)
    assert isinstance(p1, torch.Tensor)
    autograd.backward([p1, p2], [torch.from_numpy(g1), torch.from_numpy(g2)])
    for got, want in ((p1, o1), (p2, o2), (ta.grad, ja.grad),
                      (tb.grad, jb.grad)):
        _close(got, want)


def _np_pool(x, kernel, stride, pad, kind, count_include_pad=True):
    """NC + spatial pooling with MXNet's "full" convention: ceil((size + 2
    pad - k) / s) + 1 windows an axis, each clipped to the padded input;
    avg divides by the clipped window (padding included, or not)."""
    sp = x.shape[2:]
    out_sz = [-(-(n + 2 * p - k) // s) + 1
              for n, k, s, p in zip(sp, kernel, stride, pad)]
    fill = -onp.inf if kind == "max" else 0.0
    xp = onp.pad(x, [(0, 0), (0, 0)] + [(p, p + k) for p, k in
                                         zip(pad, kernel)],
                 constant_values=fill)
    real = onp.pad(onp.ones(sp), [(p, p + k) for p, k in zip(pad, kernel)])
    out = onp.zeros(x.shape[:2] + tuple(out_sz), "float64")
    for idx in itertools.product(*(range(o) for o in out_sz)):
        lo = [i * s for i, s in zip(idx, stride)]
        # the window clipped to the padded input (size + 2 pad)
        hi = [min(l + k, n + 2 * p) for l, k, n, p in zip(lo, kernel, sp,
                                                          pad)]
        win = (slice(None), slice(None)) + tuple(slice(l, h) for l, h in
                                                 zip(lo, hi))
        if kind == "max":
            out[(slice(None), slice(None)) + idx] = xp[win].reshape(
                x.shape[:2] + (-1,)).max(-1)
        else:
            n = real[win[2:]].sum() if not count_include_pad else \
                onp.prod([h - l for l, h in zip(lo, hi)])
            out[(slice(None), slice(None)) + idx] = xp[win].reshape(
                x.shape[:2] + (-1,)).sum(-1) / n
    return out.astype("float32")


# shapes where the full convention adds a window on some axis, and no
# last window would start in the right padding (which torch drops)
POOLS = [("max", 2, (8, 8), (3, 3), (2, 2), (0, 0)),
         ("max", 2, (8, 10), (3, 3), (2, 2), (1, 1)),
         ("avg", 2, (7, 8), (3, 3), (2, 2), (0, 0)),
         ("avg", 2, (9, 7), (3, 2), (2, 3), (1, 0)),
         ("max", 1, (10,), (3,), (2,), (0,)),
         ("avg", 1, (12,), (4,), (3,), (1,)),
         ("max", 3, (5, 6, 7), (2, 2, 3), (2, 2, 2), (0, 0, 0)),
         ("avg", 3, (6, 8, 6), (3, 2, 2), (2, 2, 2), (0, 1, 0))]


@pytest.mark.parametrize("kind,nd,size,kernel,stride,pad", POOLS)
def test_ceil_mode_pooling_is_the_full_convention(kind, nd, size, kernel,
                                                  stride, pad):
    x = _x(10 + nd, 2, 3, *size)
    cls = getattr(tnn, "%sPool%dD" % (kind.capitalize(), nd))
    got = cls(kernel, stride, pad, ceil_mode=True)(torch.from_numpy(x))
    want = _np_pool(x, kernel, stride, pad, kind)
    _close(got, want, 1e-5)
    floor = cls(kernel, stride, pad)(torch.from_numpy(x))
    assert any(g > f for g, f in zip(got.shape, floor.shape))
    # ceil_mode=False is what the JAX package computes
    jcls = getattr(jnn, "%sPool%dD" % (kind.capitalize(), nd))
    _close(floor, jcls(kernel, stride, pad)(mx.np.array(x)), 1e-5)


def test_ceil_mode_takes_max_and_avg_only():
    from mxnet_tpu_torch.ops import nn as F
    with pytest.raises(ValueError, match="ceil_mode"):
        F.pooling(torch.ones(1, 1, 5, 5), (2, 2), "sum", ceil_mode=True)
