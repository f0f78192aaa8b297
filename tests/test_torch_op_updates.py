"""The port's optimizer update ops (``mx.nd.sgd_update`` ...,
``mxnet_tpu_torch/ndarray/op_updates.py``) against the JAX package's.

Every one of the 39 names runs on the same numpy inputs in both
packages, on the CPU (the kernel-backed ones through the multi-tensor
wrappers' plain versions): the returned weights, every state the op
updates in place, and ``out``: ``out=None`` leaves the weight as it was,
``out=weight`` writes it.  Then each multi-tensor op equals its single
op tensor by tensor.  Tolerance: rtol 1e-6 / atol 1e-6 (elementwise
float32), float16 weights to one float16 step (2^-10 of the value),
each the rounding of a float32 master that agrees to 1e-6.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu_torch import ndarray as tnd

SHAPES = [(5, 4), (7,), (2, 3, 2)]
PKGS = {
    "jax": (mx.nd, lambda x: mx.nd.NDArray(jnp.asarray(x)),
            lambda a: onp.asarray(a._data)),
    "torch": (tnd, lambda x: tnd.NDArray(torch.from_numpy(onp.array(x))),
              lambda a: a._data.numpy()),
}
SGD_KW = dict(wd=0.01, rescale_grad=0.5, clip_gradient=1.0)


class Data:
    """Numpy inputs of one case, made from a seed: the same arrays for
    both packages."""

    def __init__(self, seed):
        self.rng = onp.random.RandomState(seed)

    def randn(self, shape, scale=1.0, dtype=onp.float32):
        return (self.rng.randn(*shape) * scale).astype(dtype)

    def pos(self, shape, lo=0.1):
        return (self.rng.rand(*shape) + lo).astype(onp.float32)


def _w(d, shape, mp):
    """(weight, its float32 master or None)."""
    w = d.randn(shape, dtype=onp.float16 if mp else onp.float32)
    return w, (w.astype(onp.float32) if mp else None)


# Each case: (nd, A, d, inplace) -> (result, [states], [weights]); the
# weights are the arrays ``out=weight`` targets when ``inplace``.
def _sgd(name, mom=False, mp=False):
    def run(nd, A, d, inplace):
        w, w32 = _w(d, (5, 4), mp)
        W = A(w)
        args = [W, A(d.randn((5, 4), 3, w.dtype))]
        states = []
        if mom:
            states.append(A(d.randn((5, 4), 0.1)))
        if mp:
            states.append(A(w32))
        kw = dict(SGD_KW, momentum=0.9) if mom else dict(SGD_KW)
        res = getattr(nd, name)(*args, *states, lr=0.1, **kw,
                                out=W if inplace else None)
        return res, states, [W]
    return run


def _adamw(name, mp):
    def run(nd, A, d, inplace):
        w, w32 = _w(d, (5, 4), mp)
        W = A(w)
        states = [A(d.randn((5, 4), 0.1)), A(d.pos((5, 4)))]
        if mp:
            states.append(A(w32))
        res = getattr(nd, name)(W, A(d.randn((5, 4), 3, w.dtype)), *states,
                                A(onp.array([0.5], onp.float32)), lr=0.01,
                                eta=0.5, wd=0.01, clip_gradient=1.0,
                                out=W if inplace else None)
        return res, states, [W]
    return run


def _adam(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.randn((5, 4), 0.1)), A(d.pos((5, 4)))]
    res = nd.adam_update(W, A(d.randn((5, 4), 3)), *states, lr=0.01,
                         **SGD_KW, out=W if inplace else None)
    return res, states, [W]


def _ftml(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.pos((5, 4))), A(d.pos((5, 4))), A(d.randn((5, 4)))]
    res = nd.ftml_update(W, A(d.randn((5, 4), 3)), *states, lr=0.01, t=2,
                         wd=0.01, rescale_grad=0.5, clip_grad=1.0,
                         out=W if inplace else None)
    return res, states, [W]


def _ftrl(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.randn((5, 4), 0.02)), A(d.pos((5, 4)))]
    res = nd.ftrl_update(W, A(d.randn((5, 4), 3)), *states, lr=0.1,
                         lamda1=0.01, beta=1.0, **SGD_KW,
                         out=W if inplace else None)
    return res, states, [W]


def _rmsprop(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.pos((5, 4)))]
    res = nd.rmsprop_update(W, A(d.randn((5, 4), 3)), *states, lr=0.01,
                            rho=0.9, **SGD_KW, clip_weights=0.9,
                            out=W if inplace else None)
    return res, states, [W]


def _rmspropalex(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.pos((5, 4), 1.0)), A(d.randn((5, 4), 0.1)),
              A(d.randn((5, 4), 0.1))]
    res = nd.rmspropalex_update(W, A(d.randn((5, 4), 3)), *states, lr=0.01,
                                rho=0.9, momentum=0.9, **SGD_KW,
                                clip_weights=2.0, out=W if inplace else None)
    return res, states, [W]


def _signsgd(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    res = nd.signsgd_update(W, A(d.randn((5, 4), 3)), lr=0.1, wd=0.01,
                            rescale_grad=-0.5, clip_gradient=1.0,
                            out=W if inplace else None)
    return res, [], [W]


def _signum(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.randn((5, 4), 0.1))]
    res = nd.signum_update(W, A(d.randn((5, 4), 3)), *states, lr=0.1,
                           momentum=0.9, **SGD_KW, wd_lh=0.01,
                           out=W if inplace else None)
    return res, states, [W]


def _lamb1(mp):
    def run(nd, A, d, inplace):
        w, w32 = _w(d, (5, 4), mp)
        W = A(w)
        states = [A(d.randn((5, 4), 0.1)), A(d.pos((5, 4)))]
        if mp:
            states.append(A(w32))
        name = "mp_lamb_update_phase1" if mp else "lamb_update_phase1"
        res = getattr(nd, name)(W, A(d.randn((5, 4), 3, w.dtype)), *states,
                                t=2, wd=0.01, rescale_grad=0.5,
                                clip_gradient=1.0,
                                out=A(onp.zeros((5, 4), onp.float32))
                                if inplace else None)
        return res, states, []
    return run


def _lamb2(mp):
    def run(nd, A, d, inplace):
        w, w32 = _w(d, (5, 4), mp)
        W = A(w)
        args = [W, A(d.randn((5, 4))), A(onp.array([2.5], onp.float32)),
                A(onp.array([1.5], onp.float32))]
        states = [A(w32)] if mp else []
        name = "mp_lamb_update_phase2" if mp else "lamb_update_phase2"
        res = getattr(nd, name)(*args, *states, lr=0.1, lower_bound=0.5,
                                upper_bound=2.0, out=W if inplace else None)
        return res, states, [W]
    return run


def _multi_sgd(name, mom=False, mp=False, preloaded=False):
    def run(nd, A, d, inplace):
        data, states, ws = [], [], []
        for s in SHAPES:
            w, w32 = _w(d, s, mp)
            ws.append(A(w))
            data += [ws[-1], A(d.randn(s, 3, w.dtype))]
            if mom:
                states.append(A(d.randn(s, 0.1)))
                data.append(states[-1])
            if mp:
                states.append(A(w32))
                data.append(states[-1])
        lrs, wds = [0.1, 0.05, 0.2], [0.01, 0.0, 0.02]
        kw = dict(rescale_grad=0.5, clip_gradient=1.0, num_weights=3,
                  out=ws if inplace else None)
        if mom:
            kw["momentum"] = 0.9
        if preloaded:
            data += [A(onp.array(lrs, onp.float32)),
                     A(onp.array(wds, onp.float32))]
        else:
            kw.update(lrs=lrs, wds=wds)
        return getattr(nd, name)(*data, **kw), states, ws
    return run


def _multi_lamb(name, mp=False):
    def run(nd, A, d, inplace):
        data, states, ws = [], [], []
        for s in SHAPES:
            w, w32 = _w(d, s, mp)
            ws.append(A(w))
            st = [A(d.randn(s, 0.1)), A(d.pos(s))] + ([A(w32)] if mp else [])
            data += [ws[-1], A(d.randn(s, 3, w.dtype))] + st
            states += st
        kw = dict(learning_rates=[0.1, 0.05, 0.2], wds=[0.01, 0.0, 0.02],
                  step_count=[1, 2, 3], rescale_grad=0.5, clip_gradient=1.0,
                  lower_bound=0.5, upper_bound=3.0, num_tensors=3,
                  out=ws if inplace else None)
        return getattr(nd, name)(*data, **kw), states, ws
    return run


def _multi_adamw(name, mp=False):
    def run(nd, A, d, inplace):
        data, states, ws = [], [], []
        for s in SHAPES:
            w, w32 = _w(d, s, mp)
            ws.append(A(w))
            st = [A(d.randn(s, 0.1)), A(d.pos(s))] + ([A(w32)] if mp else [])
            data += [ws[-1], A(d.randn(s, 3, w.dtype))] + st
            states += st
        data.append(A(onp.array([0.5], onp.float32)))
        res = getattr(nd, name)(*data, lrs=[0.01, 0.02, 0.03],
                                wds=[0.01, 0.0, 0.02], etas=[0.5, 1.0, 2.0],
                                clip_gradient=1.0, num_weights=3,
                                out=ws if inplace else None)
        return res, states, ws
    return run


def _multi_lars(nd, A, d, inplace):
    lrs = A(onp.array([0.1, 0.2, 0.3, 0.4], onp.float32))
    res = nd.multi_lars(lrs, A(onp.array([4.0, 0.0, 9.0, 1.0], onp.float32)),
                        A(onp.array([1.0, 2.0, 0.0, 0.25], onp.float32)),
                        A(onp.array([0.01, 0.0, 0.1, 0.02], onp.float32)),
                        eta=0.001, eps=1e-8, rescale_grad=0.5,
                        out=lrs if inplace else None)
    return res, [], [lrs]


def _all_finite(nd, A, d, inplace):
    x = d.randn((5, 4))
    x[2, 1] = onp.inf
    outs = []
    for data in (x, d.randn((3,))):
        out = A(onp.ones(1, onp.float32)) if inplace else None
        outs.append(nd.all_finite(A(data), init_output=not inplace, out=out))
    return outs, [], []


def _multi_all_finite(nd, A, d, inplace):
    bad = d.randn((4,))
    bad[0] = onp.nan
    outs = []
    for arrays in ((d.randn((5, 4)), d.randn((3,))), (d.randn((2,)), bad)):
        out = A(onp.ones(1, onp.float32)) if inplace else None
        outs.append(nd.multi_all_finite(*map(A, arrays), num_arrays=2,
                                        init_output=not inplace, out=out))
    return outs, [], []


def _reset_arrays(nd, A, d, inplace):
    arrays = [A(d.randn(s)) for s in SHAPES]
    nd.reset_arrays(*arrays, num_arrays=2 if inplace else 3)
    return None, arrays, []


def _sparse_adagrad(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.pos((5, 4)))]
    res = nd.sparse_adagrad_update(W, A(d.randn((5, 4), 3)), *states,
                                   lr=0.1, **SGD_KW,
                                   out=W if inplace else None)
    return res, states, [W]


def _group_adagrad(nd, A, d, inplace):
    W = A(d.randn((5, 4)))
    states = [A(d.pos((5,)))]
    res = nd.group_adagrad_update(W, A(d.randn((5, 4), 3)), *states, lr=0.1,
                                  rescale_grad=0.5, clip_gradient=1.0,
                                  out=W if inplace else None)
    return res, states, [W]


CASES = {
    "sgd_update": _sgd("sgd_update"),
    "sgd_mom_update": _sgd("sgd_mom_update", mom=True),
    "mp_sgd_update": _sgd("mp_sgd_update", mp=True),
    "mp_sgd_mom_update": _sgd("mp_sgd_mom_update", mom=True, mp=True),
    "nag_mom_update": _sgd("nag_mom_update", mom=True),
    "mp_nag_mom_update": _sgd("mp_nag_mom_update", mom=True, mp=True),
    "adam_update": _adam,
    "adamw_update": _adamw("adamw_update", False),
    "mp_adamw_update": _adamw("mp_adamw_update", True),
    "ftml_update": _ftml, "ftrl_update": _ftrl,
    "rmsprop_update": _rmsprop, "rmspropalex_update": _rmspropalex,
    "signsgd_update": _signsgd, "signum_update": _signum,
    "lamb_update_phase1": _lamb1(False),
    "lamb_update_phase2": _lamb2(False),
    "mp_lamb_update_phase1": _lamb1(True),
    "mp_lamb_update_phase2": _lamb2(True),
    "multi_sgd_update": _multi_sgd("multi_sgd_update"),
    "multi_sgd_mom_update": _multi_sgd("multi_sgd_mom_update", mom=True),
    "multi_mp_sgd_update": _multi_sgd("multi_mp_sgd_update", mp=True),
    "multi_mp_sgd_mom_update": _multi_sgd("multi_mp_sgd_mom_update",
                                          mom=True, mp=True),
    "preloaded_multi_sgd_update": _multi_sgd("preloaded_multi_sgd_update",
                                             preloaded=True),
    "preloaded_multi_sgd_mom_update": _multi_sgd(
        "preloaded_multi_sgd_mom_update", mom=True, preloaded=True),
    "preloaded_multi_mp_sgd_update": _multi_sgd(
        "preloaded_multi_mp_sgd_update", mp=True, preloaded=True),
    "preloaded_multi_mp_sgd_mom_update": _multi_sgd(
        "preloaded_multi_mp_sgd_mom_update", mom=True, mp=True,
        preloaded=True),
    "multi_lamb_update": _multi_lamb("multi_lamb_update"),
    "multi_mp_lamb_update": _multi_lamb("multi_mp_lamb_update", mp=True),
    "multi_lans_update": _multi_lamb("multi_lans_update"),
    "multi_mp_lans_update": _multi_lamb("multi_mp_lans_update", mp=True),
    "multi_adamw_update": _multi_adamw("multi_adamw_update"),
    "multi_mp_adamw_update": _multi_adamw("multi_mp_adamw_update", mp=True),
    "multi_lars": _multi_lars, "all_finite": _all_finite,
    "multi_all_finite": _multi_all_finite, "reset_arrays": _reset_arrays,
    "sparse_adagrad_update": _sparse_adagrad,
    "group_adagrad_update": _group_adagrad,
}


def _close(got, want):
    if got.dtype == onp.float16:
        onp.testing.assert_allclose(got.astype(onp.float32),
                                    want.astype(onp.float32),
                                    rtol=2 ** -10, atol=1e-6)
    else:
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _as_list(res):
    if res is None:
        return []
    return list(res) if isinstance(res, (list, tuple)) else [res]


def test_every_name_has_a_case():
    assert sorted(CASES) == sorted(mx.nd.op_updates.__all__) \
        == sorted(tnd.op_updates.__all__)
    assert len(CASES) == 39
    assert all(getattr(tnd, n) is getattr(tnd.op_updates, n) for n in CASES)


@pytest.mark.parametrize("inplace", [False, True], ids=["fresh", "out"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name, inplace):
    """The op's results and every state it updates in place match the JAX
    op; ``out=None`` leaves the weight alone, ``out=weight`` (or the
    given ``out``) receives the result."""
    got = {}
    for pkg, (nd, A, host) in PKGS.items():
        before = []
        d = Data(sum(map(ord, name)))

        def wrap(x, A=A, before=before):
            arr = A(x)
            before.append((arr, onp.array(x)))
            return arr
        res, states, weights = CASES[name](nd, wrap, d, inplace)
        results = _as_list(res)
        for r in results:
            assert isinstance(r, nd.NDArray)
        if inplace:
            for w in weights:
                assert any(r is w for r in results)
        else:
            for arr, orig in before:
                if any(arr is w for w in weights):
                    assert onp.array_equal(host(arr), orig)
        got[pkg] = ([host(r) for r in results], [host(s) for s in states])
    for a, b in zip(got["torch"][0] + got["torch"][1],
                    got["jax"][0] + got["jax"][1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close(a, b)
    assert len(got["torch"][0]) == len(got["jax"][0])


# ---------------------------------------------------------------------------
# the multi ops against the singles
# ---------------------------------------------------------------------------

def _T(x):
    return tnd.NDArray(torch.from_numpy(onp.array(x)))


def _np(a):
    return a._data.numpy()


@pytest.mark.parametrize("mom,mp", [(False, False), (True, False),
                                    (False, True), (True, True)])
def test_multi_sgd_equals_singles(mom, mp):
    d = Data(3)
    groups = []
    for s in SHAPES:
        w, w32 = _w(d, s, mp)
        groups.append([w, d.randn(s, 3, w.dtype)]
                      + ([d.randn(s, 0.1)] if mom else [])
                      + ([w32] if mp else []))
    lrs, wds = [0.1, 0.05, 0.2], [0.01, 0.0, 0.02]
    kw = dict(rescale_grad=0.5, clip_gradient=1.0)
    if mom:
        kw["momentum"] = 0.9
    name = ("mp_" if mp else "") + ("sgd_mom_update" if mom else
                                    "sgd_update")
    multi = [[_T(x) for x in grp] for grp in groups]
    outs = getattr(tnd, "multi_" + name)(*[a for grp in multi for a in grp],
                                         lrs=lrs, wds=wds, num_weights=3,
                                         **kw)
    pre = [[_T(x) for x in grp] for grp in groups]
    pouts = getattr(tnd, "preloaded_multi_" + name)(
        *[a for grp in pre for a in grp], _T(onp.array(lrs, onp.float32)),
        _T(onp.array(wds, onp.float32)), num_weights=3, **kw)
    for grp, mgrp, pgrp, o, po, lr, wd in zip(groups, multi, pre, outs,
                                              pouts, lrs, wds):
        single = [_T(x) for x in grp]
        so = getattr(tnd, name)(*single, lr=lr, wd=wd, **kw)
        assert onp.array_equal(_np(o), _np(so))
        assert onp.array_equal(_np(po), _np(so))
        for a, b, c in zip(mgrp[2:], single[2:], pgrp[2:]):
            assert onp.array_equal(_np(a), _np(b))
            assert onp.array_equal(_np(c), _np(b))


@pytest.mark.parametrize("mp", [False, True])
def test_multi_adamw_equals_singles(mp):
    d = Data(4)
    groups = []
    for s in SHAPES:
        w, w32 = _w(d, s, mp)
        groups.append([w, d.randn(s, 3, w.dtype), d.randn(s, 0.1), d.pos(s)]
                      + ([w32] if mp else []))
    lrs, wds, etas = [0.01, 0.02, 0.03], [0.01, 0.0, 0.02], [0.5, 1.0, 2.0]
    scale = onp.array([0.5], onp.float32)
    multi = [[_T(x) for x in grp] for grp in groups]
    outs = getattr(tnd, "multi_mp_adamw_update" if mp else
                   "multi_adamw_update")(
        *[a for grp in multi for a in grp], _T(scale), lrs=lrs, wds=wds,
        etas=etas, clip_gradient=1.0, num_weights=3)
    for grp, mgrp, o, lr, wd, eta in zip(groups, multi, outs, lrs, wds,
                                         etas):
        single = [_T(x) for x in grp]
        so = getattr(tnd, "mp_adamw_update" if mp else "adamw_update")(
            *single, _T(scale), lr=lr, eta=eta, wd=wd, clip_gradient=1.0)
        assert onp.array_equal(_np(o), _np(so))
        for a, b in zip(mgrp[2:], single[2:]):
            assert onp.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("mp", [False, True])
def test_multi_lamb_equals_the_two_phases(mp):
    """``multi_lamb_update`` = ``lamb_update_phase1``, the norms, then
    ``lamb_update_phase2``, tensor by tensor (their mp twins with mp)."""
    d = Data(5)
    groups = []
    for s in SHAPES:
        w, w32 = _w(d, s, mp)
        groups.append([w, d.randn(s, 3, w.dtype), d.randn(s, 0.1), d.pos(s)]
                      + ([w32] if mp else []))
    lrs, wds, steps = [0.1, 0.05, 0.2], [0.01, 0.0, 0.02], [1, 2, 3]
    kw = dict(rescale_grad=0.5, clip_gradient=1.0)
    multi = [[_T(x) for x in grp] for grp in groups]
    outs = getattr(tnd, "multi_mp_lamb_update" if mp else
                   "multi_lamb_update")(
        *[a for grp in multi for a in grp], learning_rates=lrs, wds=wds,
        step_count=steps, lower_bound=0.5, upper_bound=3.0, num_tensors=3,
        **kw)
    p = "mp_" if mp else ""
    for grp, mgrp, o, lr, wd, t in zip(groups, multi, outs, lrs, wds, steps):
        single = [_T(x) for x in grp]
        upd = getattr(tnd, p + "lamb_update_phase1")(*single, t=t, wd=wd,
                                                     **kw)
        wf = single[4]._data if mp else single[0]._data
        r1 = _T(torch.linalg.vector_norm(wf).reshape(1).numpy())
        r2 = _T(torch.linalg.vector_norm(upd._data).reshape(1).numpy())
        extra = [single[4]] if mp else []
        so = getattr(tnd, p + "lamb_update_phase2")(
            single[0], upd, r1, r2, *extra, lr=lr, lower_bound=0.5,
            upper_bound=3.0)
        _close(_np(o), _np(so))
        for a, b in zip(mgrp[2:], single[2:]):
            _close(_np(a), _np(b))
