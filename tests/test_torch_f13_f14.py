"""Faults F13 and F14 of the port's Gluon surface, each case held against
the JAX package on the same inputs (``with mx.cpu():``).

F13: ``Block.initialize(ctx=, verbose=)``; ``gluon.Parameter`` as a class
with the reference's signature and positional order (``isinstance`` of
every parameter a block holds, ``differentiable``, ``lr_mult``, sparse
storage types accepted, F15); ``Parameter.grad()`` zeros before a backward and
``RuntimeError`` under ``grad_req="null"``; ``Parameter.name``; and
``Block.register_child`` / ``params`` / ``reset_ctx`` / ``summary``.
F14: ``nn.RMSNorm(axis=)``, ``autograd.grad(train_mode=)``,
``init.InitDesc(global_init=)``, ``gluon.utils.check_sha1`` /
``shape_is_known`` and ``serve.WarmPool(params=, scales=)``.
"""
import contextlib
import io

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serve as jserve
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import TransformerLM, tiny_config

TOL = 1e-6


def _np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return x.detach().cpu().numpy()


def _seq(nn):
    net = nn.Sequential()
    net.add(nn.Dense(3, in_units=2), nn.BatchNorm(in_channels=3),
            nn.Dense(4, in_units=3, use_bias=False))
    return net


def _x(seed, *shape):
    return onp.random.RandomState(seed).normal(0, 1, shape).astype("float32")


# ----------------------------------------------------------------------
# F13
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spelling", ["ctx", "ctx_verbose", "device"])
def test_initialize_takes_ctx_and_verbose(spelling):
    kw = {"ctx": {"ctx": None}, "ctx_verbose": {"ctx": None,
                                                "verbose": True},
          "device": {"device": None}}[spelling]

    def run(pkg, nn, ctx):
        net = _seq(nn)
        args = {k: (ctx if v is None else v) for k, v in kw.items()}
        net.initialize(init=pkg.init.Constant(0.25), **args)
        return {k: _np(p.data()) for k, p in net.collect_params().items()}
    want = run(mx, jnn, mx.cpu())
    got = run(mt, tnn, mt.cpu())
    assert sorted(got) == sorted(want)
    for k in want:
        onp.testing.assert_array_equal(got[k], want[k])


def test_parameter_is_a_class_for_every_parameter_a_block_holds():
    net = _seq(tnn)
    ps = net.collect_params()
    assert all(isinstance(p, mt.gluon.Parameter) for p in ps.values())
    net.initialize(device="cpu")
    ps = net.collect_params()
    assert all(isinstance(p, mt.gluon.Parameter) for p in ps.values())
    assert issubclass(mt.gluon.parameter.TorchParameter, mt.gluon.Parameter)
    assert not isinstance(torch.zeros(2), mt.gluon.Parameter)
    jps = _seq(jnn).collect_params()
    assert all(isinstance(p, mx.gluon.Parameter) for p in jps.values())


@pytest.mark.parametrize("case", ["positional", "keywords",
                                  "not_differentiable", "deferred"])
def test_parameter_signature_matches_the_reference(case):
    if case == "positional":        # the third positional is lr_mult
        args, kw = ((2, 3), "float32", 0.1, 0.5), {}
    elif case == "keywords":
        args, kw = (), {"shape": (2, 3), "lr_mult": 2.0, "wd_mult": 0.0,
                        "init": "ones", "grad_req": "add", "name": "w"}
    elif case == "not_differentiable":
        args, kw = (), {"shape": (4,), "differentiable": False,
                        "grad_req": "write"}
    else:
        args, kw = (), {"shape": (0, 3), "allow_deferred_init": True}
    jp = mx.gluon.Parameter(*args, **kw)
    tp = mt.gluon.Parameter(*args, **kw)
    assert isinstance(tp, mt.gluon.Parameter)
    for attr in ("lr_mult", "wd_mult", "grad_req"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    if "name" in kw:
        assert tp.name == jp.name == "w"
    assert tp.requires_grad == (jp.grad_req != "null")


def test_parameter_deferred_init_is_refused_unless_allowed():
    with pytest.raises(ValueError, match="deferred init is disallowed"):
        mx.gluon.Parameter(shape=(0, 3), name="w").initialize(ctx=mx.cpu())
    p = mt.gluon.Parameter(shape=(0, 3), name="w")
    with pytest.raises(ValueError, match="deferred init is disallowed"):
        mt.gluon.parameter.initialize(p, "w", mt.init.Zero(), "cpu")


@pytest.mark.parametrize("stype", [("row_sparse", "default"),
                                   ("default", "row_sparse")])
def test_parameter_sparse_storage_is_refused(stype):
    # sparse storage types are accepted since F15 and, as in the
    # reference, hold the parameter dense
    jp = mx.gluon.Parameter(shape=(2, 2), stype=stype[0],
                            grad_stype=stype[1])
    tp = mt.gluon.Parameter(shape=(2, 2), stype=stype[0],
                            grad_stype=stype[1])
    assert tp._mx.shape == jp.shape == (2, 2)
    assert isinstance(tp, mt.gluon.Parameter)


def test_grad_before_backward_is_zeros_and_null_raises():
    def build(pkg, nn, ctx):
        net = nn.Dense(3, in_units=2)
        net.initialize(init=pkg.init.One(), ctx=ctx)
        return net
    jnet, tnet = build(mx, jnn, mx.cpu()), build(mt, tnn, mt.cpu())
    for name in ("weight", "bias"):
        want = _np(getattr(jnet, name).grad())
        got = _np(getattr(tnet, name).grad())
        onp.testing.assert_array_equal(got, want)
        assert got.shape == want.shape and not got.any()
    # after a backward: the gradient itself
    x = _x(1, 5, 2)
    with mx.autograd.record():
        jl = jnet(mx.np.array(x)).sum()
    jl.backward()
    with mt.autograd.record():
        tl = tnet(mt.np.array(x, device="cpu")).sum()
    tl.backward()
    onp.testing.assert_allclose(_np(tnet.weight.grad()),
                                _np(jnet.weight.grad()), rtol=TOL, atol=TOL)
    jnet.weight.grad_req = "null"
    tnet.weight.grad_req = "null"
    for p in (jnet.weight, tnet.weight):
        with pytest.raises(RuntimeError, match="grad_req='null'"):
            p.grad()


def test_parameter_names_are_the_references():
    jnet, tnet = _seq(jnn), _seq(tnn)
    with mx.cpu():
        jnet.initialize()
    tnet.initialize(device="cpu")
    want = {k: p.name for k, p in jnet.collect_params().items()}
    got = {k: p.name for k, p in tnet.collect_params().items()}
    assert got == want
    assert set(got.values()) == {"weight", "bias", "gamma", "beta",
                                 "running_mean", "running_var"}


def test_register_child_params_and_summary():
    def build(nn):
        net = nn.Sequential()
        net.register_child(nn.Dense(3, in_units=2))
        net.register_child(nn.Dense(2, in_units=3), "head")
        return net
    jnet, tnet = build(jnn), build(tnn)
    with mx.cpu():
        jnet.initialize()
    tnet.initialize(device="cpu")
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    dense = tnet[0]
    assert list(dense.params) == list(jnet._children["0"].params) == \
        ["weight", "bias"]
    assert tnet.params == {} and len(jnet.params) == 0
    outs = []
    for net in (jnet, tnet):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            net.summary()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "Total params: 17" in outs[1]


@pytest.mark.parametrize("alias", ["reset_ctx", "reset_device"])
def test_reset_ctx_moves_the_parameters(alias):
    jnet, tnet = _seq(jnn), _seq(tnn)
    with mx.cpu():
        jnet.initialize(init=mx.init.Constant(0.5))
    tnet.initialize(init=mt.init.Constant(0.5), device="cpu")
    getattr(jnet, alias)(mx.cpu())
    getattr(tnet, alias)(mt.cpu())
    for (k, jp), (k2, tp) in zip(jnet.collect_params().items(),
                                 tnet.collect_params().items()):
        assert k == k2 and tp.device.type == "cpu"
        onp.testing.assert_array_equal(_np(tp.data()), _np(jp.data()))
    x = _x(2, 4, 2)
    with mx.autograd.pause():
        want = _np(jnet(mx.np.array(x)))
    got = _np(tnet(mt.np.array(x, device="cpu")))
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ----------------------------------------------------------------------
# F14
# ----------------------------------------------------------------------
@pytest.mark.parametrize("axis,shape", [(-1, (2, 3, 5)), (1, (2, 3, 5)),
                                        (0, (4, 3))])
def test_rmsnorm_normalizes_over_axis(axis, shape):
    x = _x(3, *shape)
    g = onp.random.RandomState(4).uniform(0.5, 1.5, shape[axis]).astype(
        "float32")
    jl = jnn.RMSNorm(axis, in_channels=shape[axis])   # axis is positional
    with mx.cpu():
        jl.initialize()
    jl.gamma.set_data(mx.np.array(g))
    tl = tnn.RMSNorm(axis, in_channels=shape[axis]).initialize(device="cpu")
    tl.gamma.set_data(g)
    want = _np(jl(mx.np.array(x)))
    got = _np(tl(torch.from_numpy(x)))
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("train_mode", [True, False])
def test_autograd_grad_takes_train_mode(train_mode):
    x = _x(5, 3, 4)
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = (jx * jx).sum()
    want = mx.autograd.grad(jy, jx, train_mode=train_mode)
    tx = mt.np.array(x, device="cpu")
    tx.attach_grad()
    with mt.autograd.record():
        ty = (tx * tx).sum()
    got = mt.autograd.grad(ty, tx, train_mode=train_mode)
    onp.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


def test_initdesc_takes_global_init():
    g = mt.init.Uniform(0.1)
    d = mt.init.InitDesc("fc_weight", {"k": 1}, global_init=g)
    jd = mx.init.InitDesc("fc_weight", {"k": 1}, global_init=g)
    assert d == jd == "fc_weight" and d.attrs == jd.attrs == {"k": 1}
    assert d.global_init is g and jd.global_init is g
    assert mt.init.InitDesc("w").global_init is None


def test_check_sha1_and_shape_is_known(tmp_path):
    import hashlib
    f = tmp_path / "blob.bin"
    f.write_bytes(onp.random.RandomState(6).bytes(3 << 20))
    good = hashlib.sha1(f.read_bytes()).hexdigest()
    for sha in (good, "0" * 40):
        assert mt.gluon.utils.check_sha1(str(f), sha) == \
            mx.gluon.utils.check_sha1(str(f), sha)
    assert mt.gluon.utils.check_sha1(str(f), good)
    for shape in (None, (), (2, 3), (0, 3), (2, -1), [4]):
        assert mt.gluon.utils.shape_is_known(shape) == \
            mx.gluon.utils.shape_is_known(shape), shape


def _lm(seed):
    gen = torch.Generator().manual_seed(seed)
    return TransformerLM(tiny_config(), device="cpu").initialize(gen,
                                                                 std=0.1)


def _serve_once(pool):
    padded = onp.zeros(8, onp.int32)
    padded[:5] = [4, 8, 15, 16, 23]
    mp = pool.spec.max_pages_per_slot
    row = onp.zeros(mp, onp.int32)
    row[:2] = [2, 3]
    first = pool.run_prefill(padded, row, 5)
    table = onp.zeros((3, mp), onp.int32)
    table[0] = row
    toks = pool.run_decode(table, onp.array([5, 0, 0], onp.int32),
                           onp.array([first, 0, 0], onp.int32),
                           onp.array([True, False, False]))
    return first, [int(t) for t in toks], pool.k_pages.clone()


def _cfg(**kw):
    return serve.ServeConfig(slots=3, page_size=4, pages=16, ladder=(8,),
                             max_new=6, prefix_cache=False, **kw)


def test_warm_pool_serves_a_callers_params():
    src = _lm(1)
    params = {k: p.detach().clone() for k, p in
              src.collect_params().items()}
    want = _serve_once(serve.WarmPool(_lm(1), _cfg()))
    other = _lm(2)
    got = _serve_once(serve.WarmPool(other, _cfg(), params=params))
    assert got[:2] == want[:2] and torch.equal(got[2], want[2])
    with pytest.raises(ValueError, match="missing"):
        serve.WarmPool(_lm(2), _cfg(), params={"output.weight":
                                                params["output.weight"]})


def test_warm_pool_serves_int8_weights_with_their_scales():
    """The reference's quantize_weights output (int8 arrays and scales)
    served as given equals the pool that quantizes the net itself."""
    net = _lm(3)
    jparams = {k: mx.np.array(p.detach().numpy())._data
               for k, p in net.collect_params().items()}
    jq, jscales = jserve.quantize_weights(jparams)
    q = {k: torch.from_numpy(onp.array(v)) for k, v in jq.items()}
    assert jscales and all(q[k].dtype == torch.int8 for k in jscales)
    want = _serve_once(serve.WarmPool(_lm(3), _cfg(int8=True)))
    got_pool = serve.WarmPool(_lm(4), _cfg(int8=True), params=q,
                              scales=jscales)
    assert got_pool.stats["int8"]
    got = _serve_once(got_pool)
    assert got[:2] == want[:2] and torch.equal(got[2], want[2])
