"""``mx.npx`` of the port against the JAX package's: the nn operators,
the contrib ones, control flow and ``npx.flash_attention`` with its
gradient.

The same seeded numpy inputs go through ``mxnet_tpu.npx`` and, under
``with mx.cpu():``, through ``mxnet_tpu_torch.npx``; each operator is a
case of a few parametrised tests.  float32 throughout: rtol 1e-5 / atol
1e-5 (float32 rounding of a convolution, a norm or a softmax summed in
another order); indices exactly.  ``npx.flash_attention`` runs the
port's plain versions of the CUDA kernels here and the JAX package's
Pallas kernels in interpret mode (as ``tests/test_torch_attention.py``
runs them), at head_dim 16 and 64: outputs and gradients within 2e-5,
fp32 summation-order noise over D <= 64 and T <= 256.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import pallas_ops

RTOL, ATOL = 1e-5, 1e-5


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype(
        onp.float32)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _both(fn, *arrays):
    with tmx.cpu():
        got = _host(fn(tmx, *[tmx.np.array(a) for a in arrays]))
    want = _host(fn(jmx, *[jmx.np.array(a) for a in arrays]))
    return got, want


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


X = _rand(0, 2, 3, 6, 6)
V = _rand(1, 4, 7)
W = _rand(2, 5, 7)
IDX = onp.array([[0, 3], [1, 1], [2, 0], [3, 6]], onp.int32)

NN = {
    "softmax": lambda mx, x: mx.npx.softmax(x, axis=1),
    "softmax_temp": lambda mx, x: mx.npx.softmax(x, temperature=2.0),
    "log_softmax": lambda mx, x: mx.npx.log_softmax(x, axis=-1),
    "relu": lambda mx, x: mx.npx.relu(x),
    "sigmoid": lambda mx, x: mx.npx.sigmoid(x),
    "gelu": lambda mx, x: mx.npx.gelu(x),
    "gelu_tanh": lambda mx, x: mx.npx.gelu(x, approximate=True),
    "activation_tanh": lambda mx, x: mx.npx.activation(x, "tanh"),
    "activation_softrelu": lambda mx, x: mx.npx.activation(x, "softrelu"),
    "leaky_relu": lambda mx, x: mx.npx.leaky_relu(x, slope=0.1),
    "elu": lambda mx, x: mx.npx.leaky_relu(x, act_type="elu", slope=0.5),
    "selu": lambda mx, x: mx.npx.leaky_relu(x, act_type="selu"),
    "smooth_l1": lambda mx, x: mx.npx.smooth_l1(x * 3, 1.5),
    "erf": lambda mx, x: mx.npx.erf(x),
    "erfinv": lambda mx, x: mx.npx.erfinv(x * 0.9),
    "gammaln": lambda mx, x: mx.npx.gammaln(x + 2),
    "gamma": lambda mx, x: mx.npx.gamma(x + 2),
    "digamma": lambda mx, x: mx.npx.digamma(x + 2),
    "l2_normalization": lambda mx, x: mx.npx.l2_normalization(x),
    "l2_channel": lambda mx, x: mx.npx.l2_normalization(x, mode="channel"),
    "slice": lambda mx, x: mx.npx.slice(x, (0, 1), (2, 3)),
    "slice_step": lambda mx, x: mx.npx.slice(x, (0, 0, 1), (1, 3, 5),
                                              (1, 2, 2)),
    "slice_axis": lambda mx, x: mx.npx.slice_axis(x, 2, 1, 4),
    "slice_like": lambda mx, x: mx.npx.slice_like(x, x[:1, :2]),
    "reshape_like": lambda mx, x: mx.npx.reshape_like(x, x.reshape(6, 36)),
    "broadcast_like": lambda mx, x: mx.npx.broadcast_like(x[:1], x),
    "cast": lambda mx, x: mx.npx.cast(x * 4, "int32"),
    "pooling_max": lambda mx, x: mx.npx.pooling(x, kernel=(2, 2),
                                                stride=(2, 2)),
    "pooling_avg": lambda mx, x: mx.npx.pooling(x, kernel=(3, 3),
                                                pool_type="avg",
                                                pad=(1, 1)),
    "pooling_global": lambda mx, x: mx.npx.pooling(x, global_pool=True,
                                                   pool_type="avg"),
    "topk_indices": lambda mx, x: mx.npx.topk(x, k=2),
    "topk_value_asc": lambda mx, x: mx.npx.topk(x, axis=2, k=3,
                                                ret_typ="value",
                                                is_ascend=True),
    "topk_both": lambda mx, x: mx.npx.topk(x, k=2, ret_typ="both"),
    "topk_mask": lambda mx, x: mx.npx.topk(x, k=2, ret_typ="mask"),
    "masked_softmax": lambda mx, x: mx.npx.masked_softmax(x, x > 0),
    "masked_log_softmax": lambda mx, x: mx.npx.masked_log_softmax(x, x > 0),
    "sequence_mask": lambda mx, x: mx.npx.sequence_mask(
        x.reshape(6, 2, 18), mx.np.array([3, 5]), True, -1.0),
    "arange_like": lambda mx, x: mx.npx.arange_like(x, 1.0, 0.5, axis=2),
    "batch_dot": lambda mx, x: mx.npx.batch_dot(x[0], x[1],
                                                transpose_b=True),
    "multi_sum_sq": lambda mx, x: mx.npx.multi_sum_sq(x, x[0]),
    # F4 and F7 (ROADMAP section 3): a negative slice step, and one_hot
    # of indices outside [0, depth)
    "slice_negative_step": lambda mx, x: mx.npx.slice(
        x.reshape(-1), begin=(8,), end=(2,), step=(-2,)),
    "slice_negative_step_2d": lambda mx, x: mx.npx.slice(
        x[0, 0], begin=(5, None), end=(None, 1), step=(-2, -1)),
    "one_hot_out_of_range": lambda mx, x: mx.npx.one_hot(
        mx.np.array([7, 1, -1, 3, 2]), 3),
    "one_hot_out_of_range_values": lambda mx, x: mx.npx.one_hot(
        mx.np.array([[0, 5], [-2, 2]]), 4, on_value=3.0, off_value=-1.0),
}


@pytest.mark.parametrize("name", sorted(NN))
def test_nn_ops_match_jax(name):
    _close(*_both(NN[name], X))


def test_layers_with_weights_match_jax():
    cases = {
        "fully_connected": (lambda mx, v, w, b: mx.npx.fully_connected(
            v, w, b, num_hidden=5), (V, W, _rand(3, 5))),
        "fully_connected_no_bias": (lambda mx, v, w: mx.npx.fully_connected(
            v, w, no_bias=True), (V, W)),
        "convolution": (lambda mx, x, w, b: mx.npx.convolution(
            x, w, b, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
            num_filter=4), (X, _rand(4, 4, 3, 3, 3), _rand(5, 4))),
        "deconvolution": (lambda mx, x, w: mx.npx.deconvolution(
            x, w, kernel=(2, 2), stride=(2, 2), num_filter=2, no_bias=True),
            (X, _rand(6, 3, 2, 2, 2))),
        "layer_norm": (lambda mx, x, g, b: mx.npx.layer_norm(x, g, b),
                       (X, _rand(7, 6), _rand(8, 6))),
        "group_norm": (lambda mx, x, g, b: mx.npx.group_norm(
            x.reshape(2, 6, 3, 6), g, b, num_groups=3),
            (X, _rand(9, 6), _rand(10, 6))),
        "instance_norm": (lambda mx, x, g, b: mx.npx.instance_norm(x, g, b),
                          (X, _rand(11, 3), _rand(12, 3))),
        "rms_norm": (lambda mx, x, g: mx.npx.rms_norm(x, g),
                     (X, _rand(13, 6))),
        "batch_norm_inference": (lambda mx, x, g, b, m, v: mx.npx.batch_norm(
            x, g, b, m, v), (X, _rand(14, 3), _rand(15, 3), _rand(16, 3),
                             _rand(17, 3, lo=0.5, hi=2.0))),
        "embedding": (lambda mx, i, w: mx.npx.embedding(i, w),
                      (IDX, _rand(18, 8, 5))),
        "one_hot": (lambda mx, i: mx.npx.one_hot(i, 7), (IDX,)),
        "pick": (lambda mx, x, i: mx.npx.pick(x, i, axis=1),
                 (_rand(19, 4, 7), IDX[:, 1])),
        "gather_nd": (lambda mx, x, i: mx.npx.gather_nd(x, i.T),
                      (_rand(20, 4, 7), IDX)),
        "scatter_nd": (lambda mx, d, i: mx.npx.scatter_nd(d, i.T, (4, 7)),
                       (_rand(21, 4), IDX)),
        "index_add": (lambda mx, a, i, v: mx.npx.index_add(a, i.T, v),
                      (_rand(22, 4, 7), IDX, _rand(23, 4))),
        "index_update": (lambda mx, a, i, v: mx.npx.index_update(a, i.T, v),
                         (_rand(24, 4, 7), IDX, _rand(25, 4))),
        "prelu": (lambda mx, x, g: mx.npx.leaky_relu(x, g, act_type="prelu"),
                  (X, _rand(26, 6))),
    }
    for name, (fn, arrays) in cases.items():
        got, want = _both(fn, *arrays)
        _close(got, want, atol=1e-4 if "conv" in name else ATOL)


def _boxes(seed, n):
    r = onp.random.RandomState(seed)
    xy = r.uniform(0, 10, (n, 2))
    wh = r.uniform(1, 5, (n, 2))
    return onp.concatenate([xy, xy + wh], -1).astype(onp.float32)


CONTRIB = {
    "box_iou": (lambda mx, a, b: mx.npx.box_iou(a, b),
                (_boxes(0, 5), _boxes(1, 4))),
    "box_iou_center": (lambda mx, a, b: mx.npx.box_iou(a, b,
                                                       format="center"),
                       (_boxes(2, 3), _boxes(3, 6))),
    "box_nms": (lambda mx, d: mx.npx.box_nms(d, overlap_thresh=0.3),
                (onp.concatenate([onp.random.RandomState(4).randint(
                    0, 3, (8, 1)).astype(onp.float32),
                    _rand(5, 8, 1, lo=0.1, hi=1.0), _boxes(6, 8)], -1),)),
    "box_nms_per_class": (lambda mx, d: mx.npx.box_nms(
        d[None], overlap_thresh=0.2, id_index=0, topk=3),
        (onp.concatenate([onp.random.RandomState(7).randint(
            0, 2, (8, 1)).astype(onp.float32),
            _rand(8, 8, 1, lo=0.1, hi=1.0), _boxes(9, 8)], -1),)),
    "roi_align": (lambda mx, x, r: mx.npx.roi_align(x, r, (2, 3), 0.5),
                  (_rand(10, 2, 3, 8, 8), onp.array(
                      [[0, 1, 1, 9, 12], [1, 0, 2, 6, 6], [0, 4, 4, 15, 9]],
                      onp.float32))),
    "roi_pooling": (lambda mx, x, r: mx.npx.roi_pooling(x, r, (2, 2), 1.0),
                    (_rand(11, 2, 3, 8, 8), onp.array(
                        [[0, 1, 1, 6, 5], [1, 0, 2, 3, 7]], onp.float32))),
    "selfatt_qk": (lambda mx, q: mx.npx.interleaved_matmul_selfatt_qk(q, 2),
                   (_rand(12, 5, 3, 2 * 3 * 4),)),
    "selfatt_valatt": (lambda mx, q, a:
                       mx.npx.interleaved_matmul_selfatt_valatt(q, a, 2),
                       (_rand(13, 5, 3, 24), _rand(14, 6, 5, 5))),
    "encdec_qk": (lambda mx, q, kv: mx.npx.interleaved_matmul_encdec_qk(
        q, kv, 2), (_rand(15, 4, 3, 8), _rand(16, 6, 3, 16))),
    "encdec_valatt": (lambda mx, kv, a:
                      mx.npx.interleaved_matmul_encdec_valatt(kv, a, 2),
                      (_rand(17, 6, 3, 16), _rand(18, 6, 4, 6))),
}


@pytest.mark.parametrize("name", sorted(CONTRIB))
def test_contrib_ops_match_jax(name):
    fn, arrays = CONTRIB[name]
    _close(*_both(fn, *arrays))


# ----------------------------------------------------------------------
# control flow
# ----------------------------------------------------------------------
def _foreach(mx, x, s):
    def body(d, states):
        h = states[0] * 0.5 + d
        return [h * 2, h.sum()], [h]
    outs, final = mx.npx.foreach(body, x, [s])
    return outs + final


def _while(mx, x):
    def cond(i, acc):
        return i < 3

    def func(i, acc):
        return acc * 2, (i + 1, acc + x[0])
    outs, (i, acc) = mx.npx.while_loop(cond, func, (mx.np.array(0.0), x[1]),
                                       max_iterations=5)
    return [outs, i, acc]


def _cond(mx, x):
    return [mx.npx.cond(x.sum() > 0, lambda a: a * 2, lambda a: a - 1, [x]),
            mx.npx.cond(x.sum() < 0, lambda a: a * 2, lambda a: a - 1, [x])]


@pytest.mark.parametrize("name", ["foreach", "while_loop", "cond"])
def test_control_flow_matches_jax(name):
    x = _rand(30, 4, 3)
    if name == "foreach":
        got, want = _both(_foreach, x, _rand(31, 3))
    elif name == "while_loop":
        got, want = _both(_while, x)
    else:
        got, want = _both(_cond, x)
    _close(got, want)


def test_foreach_records_gradients_like_jax():
    def run(mx):
        x = mx.np.array(_rand(32, 4, 3))
        x.attach_grad()
        with mx.autograd.record():
            outs, _ = _foreach(mx, x, mx.np.zeros((3,)))[:2], None
            loss = (outs[0] * outs[0]).sum() + outs[1].sum()
        loss.backward()
        return x.grad.asnumpy()
    with tmx.cpu():
        got = run(tmx)
    _close(got, run(jmx))


# ----------------------------------------------------------------------
# npx.flash_attention
# ----------------------------------------------------------------------
@pytest.mark.parametrize("D,causal,Hkv", [(16, True, 2), (64, False, 4),
                                          (64, True, 1)])
def test_flash_attention_and_grad_match_jax(monkeypatch, D, causal, Hkv):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)
    rng = onp.random.RandomState(D + Hkv)
    q = rng.randn(1, 4, 128, D).astype(onp.float32)
    k, v = (rng.randn(1, Hkv, 128, D).astype(onp.float32) for _ in range(2))
    dy = rng.randn(1, 4, 128, D).astype(onp.float32)

    def run(mx):
        ins = [mx.np.array(a) for a in (q, k, v)]
        for t in ins:
            t.attach_grad()
        with mx.autograd.record():
            o = mx.npx.flash_attention(*ins, causal=causal)
        o.backward(mx.np.array(dy))
        return [o.asnumpy()] + [t.grad.asnumpy() for t in ins]
    with tmx.cpu():
        got = run(tmx)
    want = run(jmx)
    for g, w in zip(got, want):
        _close(g, w, rtol=0, atol=2e-5)


def test_npx_misc_surface():
    with tmx.cpu():
        x = tmx.np.array(_rand(40, 2, 5))
        assert tmx.npx.shape_array(x).asnumpy().tolist() == [2, 5]
        assert tmx.npx.is_np_array() and tmx.npx.use_np(len) is len
        a, b = tmx.np.array(_rand(41, 3)), tmx.np.array(_rand(42, 2, 2))
        norm = tmx.npx.clip_global_norm([a, b], 0.5)
        total = onp.sqrt(sum((t.asnumpy() ** 2).sum() for t in (a, b)))
        onp.testing.assert_allclose(total, 0.5, rtol=1e-5)
        assert norm > 0.5
        with pytest.raises(ValueError):
            tmx.npx.constraint_check(x > 5)
        tmx.npx.seed(3)
        u = tmx.npx.uniform_n(0.0, 1.0, batch_shape=(4,))
        assert u.shape == (4,)
        with pytest.raises(NotImplementedError, match="queue 5"):
            tmx.npx.ctc_loss(x, x)
        with tmx.autograd.train_mode():
            d = tmx.npx.dropout(tmx.np.ones((1000,)), p=0.5)
        kept = d.asnumpy()
        assert set(onp.unique(kept).tolist()) <= {0.0, 2.0}
        assert 350 < (kept > 0).sum() < 650
        assert tmx.npx.dropout(x, p=0.5) is x           # not training
