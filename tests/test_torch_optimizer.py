"""The port's optimizers (``mxnet_tpu_torch.optimizer``) against the JAX
package's, and the host side of the multi-tensor kernels
(``ops/multi_tensor.py``: the plan, the table, the checks).

The same numpy weights and gradients go through both packages' list-form
``update`` on the CPU, where SGD / NAG / Adam / AdamW / LAMB run the
multi-tensor wrappers' plain versions and the others their ``_rule``.
Tolerance: weights and states at rtol 1e-6 / atol 1e-6 (elementwise
float32; the two frameworks round a few scalars -- 1 - beta, beta^t --
differently), float16 weights to one float16 step (2^-10 of the value)
since each is the rounding of a float32 master that agrees to 1e-6.
"""
import pickle

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import context, optimizer
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops import multi_tensor as mt

SHAPES = [(5, 4), (7,), (2, 3, 2)]
COMMON = dict(learning_rate=0.05, wd=0.1, rescale_grad=0.5,
              clip_gradient=1.0)
# every registered optimizer, with the options that shape its rule
CASES = {
    "sgd": {"momentum": 0.9}, "sgd_plain": {}, "nag": {"momentum": 0.9},
    "sgld": {}, "signum": {}, "signum_nomom": {"momentum": 0.0},
    "dcasgd": {"momentum": 0.9}, "adagrad": {}, "adadelta": {},
    "adam": {}, "adam_nobias": {"correct_bias": False}, "adamw": {},
    "adamax": {}, "nadam": {}, "ftrl": {}, "ftml": {},
    "lamb": {"lower_bound": 0.5, "upper_bound": 4.0},
    "lamb_nobias": {"bias_correction": False}, "lans": {}, "lars": {},
    "rmsprop": {"centered": True},
    "rmsprop_plain": {"clip_weights": 0.9},
}


def _name(case):
    return case.split("_")[0]


def _sgld_noise(t, shape):
    """The JAX SGLD rule's standard normal noise at step t."""
    key = jax.random.fold_in(jax.random.key(0), t)
    return onp.array(jax.random.normal(key, shape))


def _pair(case, **over):
    args = dict(COMMON, **CASES[case], **over)
    jopt = mx.optimizer.create(_name(case), **args)
    topt = optimizer.create(_name(case), **args)
    if _name(case) == "sgld":
        topt._noise = lambda t, w: torch.from_numpy(
            _sgld_noise(t, tuple(w.shape)))
    return jopt, topt


def _data(seed, dtype=onp.float32):
    rng = onp.random.RandomState(seed)
    w0 = [rng.randn(*s).astype(dtype) for s in SHAPES]
    # gradients of mixed size, so that clip_gradient bites
    grads = [[(rng.randn(*s) * 3).astype(dtype) for s in SHAPES]
             for _ in range(3)]
    return w0, grads


def _close(got, want, **tol):
    onp.testing.assert_allclose(got, want, **(tol or dict(rtol=1e-6,
                                                          atol=1e-6)))


def _leaves(state):
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state]


@pytest.mark.parametrize("case", sorted(CASES))
def test_list_update_matches_jax(case):
    """Three list-form ``update`` calls over three tensors of different
    shapes, with wd, ``rescale_grad``, ``clip_gradient`` and lr / wd
    multipliers: weights and every state leaf match the JAX package."""
    jopt, topt = _pair(case)
    for opt in (jopt, topt):
        opt.set_lr_mult({0: 0.5, 2: 2.0})
        opt.set_wd_mult({1: 0.0})
    w0, grads = _data(11)
    jw = [NDArray(jnp.asarray(w)) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    jst = [jopt.create_state(i, w) for i, w in enumerate(jw)]
    tst = [topt.create_state(i, w) for i, w in enumerate(tw)]
    idx = list(range(len(SHAPES)))
    for gs in grads:
        jopt.update(idx, jw, [NDArray(jnp.asarray(g)) for g in gs], jst)
        topt.update(idx, tw, [torch.from_numpy(g) for g in gs], tst)
    assert topt.num_update == jopt.num_update == 3
    for a, b in zip(tw, jw):
        _close(a.numpy(), onp.asarray(b._data))
    for js, ts in zip(jst, tst):
        jl, tl = _leaves(js), _leaves(ts)
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            _close(a.numpy(), onp.asarray(b._data))


@pytest.mark.parametrize("case", ["sgd", "nag", "adam", "adamw", "lamb",
                                  "rmsprop", "adagrad"])
def test_multi_precision_float16_matches_jax(case):
    """``multi_precision=True`` on float16 weights: the state is (float32
    master, state) as in the JAX package, the master and the states
    match it, and the weight is the master's rounding."""
    jopt, topt = _pair(case, multi_precision=True)
    w0, grads = _data(12, onp.float16)
    jw = [NDArray(jnp.asarray(w)) for w in w0]
    tw = [torch.from_numpy(w.copy()) for w in w0]
    jst = [jopt.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    tst = [topt.create_state_multi_precision(i, w) for i, w in enumerate(tw)]
    for js, ts, w in zip(jst, tst, w0):
        assert len(ts) == 2 and ts[0].dtype == torch.float32
        assert onp.array_equal(ts[0].numpy(), w.astype(onp.float32))
        assert len(_leaves(ts[1])) == len(_leaves(js[1]))
    idx = list(range(len(SHAPES)))
    for gs in grads:
        jopt.update_multi_precision(
            idx, jw, [NDArray(jnp.asarray(g)) for g in gs], jst)
        topt.update_multi_precision(idx, tw, [torch.from_numpy(g)
                                              for g in gs], tst)
    for a, b, st in zip(tw, jw, tst):
        assert a.dtype == torch.float16
        _close(a.numpy().astype(onp.float32),
               onp.asarray(b._data).astype(onp.float32), rtol=2 ** -10,
               atol=1e-6)
        assert onp.array_equal(a.numpy(), st[0].numpy().astype(onp.float16))
    for js, ts in zip(jst, tst):
        for a, b in zip(_leaves(ts), _leaves(js)):
            _close(a.numpy(), onp.asarray(b._data))


@pytest.mark.parametrize("case", ["sgd", "sgd_plain", "nag", "adam",
                                  "adam_nobias", "adamw", "lamb"])
def test_fused_optimizers_rule_equals_list_update(case):
    """The pure ``_rule`` of each optimizer the list form sends to the
    multi-tensor wrappers (what the JAX TrainStep reuses) gives the list
    update's weights and states."""
    _, topt = _pair(case, rescale_grad=1.0, clip_gradient=None)
    w0, grads = _data(16)
    w, st = torch.from_numpy(w0[0].copy()), None
    ref = torch.from_numpy(w0[0].copy())
    st = topt.create_state(0, w)
    ref_st = topt.create_state(0, ref)
    for t, gs in enumerate(grads, start=1):
        g = torch.from_numpy(gs[0])
        new_w, st = topt._rule(w, g, 0.05, 0.1, t, topt._scalar_args(0), st)
        w = new_w
        topt.update(0, ref, g, ref_st)
    _close(w.numpy(), ref.numpy())
    for a, b in zip(st, ref_st):
        _close(a.numpy(), b.numpy())


def test_multi_precision_keeps_other_dtypes_plain():
    """Only float16 weights get a master copy (JAX :118-122)."""
    opt = optimizer.Adam(multi_precision=True)
    st = opt.create_state_multi_precision(0, torch.zeros(3))
    assert len(st) == 2 and st[0].shape == (3,) and not opt._is_mp(
        torch.zeros(3), st)
    st = opt.create_state_multi_precision(
        0, torch.zeros(3, dtype=torch.bfloat16))
    assert all(s.dtype == torch.float32 and s.shape == (3,) for s in st)


def _run_updater(upd, w, grads):
    for i, g in enumerate(grads):
        for k, wk in enumerate(w):
            upd(k, g[k], wk)


@pytest.mark.parametrize("case", ["adam", "sgd", "lamb"])
def test_updater_round_trip_and_jax_payload(case):
    """``Updater``: a JAX-written ``get_states()`` payload loads into the
    port and the next updates match the JAX updater's; the port's own
    payload round-trips through ``set_states``."""
    jopt, topt = _pair(case)
    w0, grads = _data(13)
    jw = [NDArray(jnp.asarray(w)) for w in w0]
    jup = mx.optimizer.get_updater(jopt)
    _run_updater(jup, jw, [[NDArray(jnp.asarray(g)) for g in gs]
                           for gs in grads[:2]])
    payload = jup.get_states()
    with context.cpu():
        tup = optimizer.get_updater(topt)
        tup.set_states(payload)
    tw = [torch.from_numpy(onp.asarray(w._data).copy()) for w in jw]
    topt._index_update_count = dict(jopt._index_update_count)
    topt.num_update = jopt.num_update
    _run_updater(jup, jw, [[NDArray(jnp.asarray(g)) for g in grads[2]]])
    _run_updater(tup, tw, [[torch.from_numpy(g) for g in grads[2]]])
    for a, b in zip(tw, jw):
        _close(a.numpy(), onp.asarray(b._data))
    for k in tup.states:
        for a, b in zip(_leaves(tup.states[k]), _leaves(jup.states[k])):
            _close(a.numpy(), onp.asarray(b._data))
    # the port's own payload, with and without the optimizer
    for dump in (False, True):
        with context.cpu():
            back = optimizer.get_updater(optimizer.create(_name(case)))
            back.set_states(tup.get_states(dump_optimizer=dump))
        assert sorted(back.states) == sorted(tup.states)
        for k in back.states:
            for a, b in zip(_leaves(back.states[k]), _leaves(tup.states[k])):
                assert torch.equal(a, b)
        assert isinstance(back.optimizer, type(topt))
        if dump:
            assert back.optimizer.lr == topt.lr


def test_sgld_injected_noise_and_generator():
    """SGLD with the JAX rule's noise injected matches it; its own noise
    comes from the given generator, so one seed gives one trajectory."""
    jopt, topt = _pair("sgld")
    w0, grads = _data(14)
    jw, tw = NDArray(jnp.asarray(w0[0])), torch.from_numpy(w0[0].copy())
    for gs in grads:
        jopt.update(0, jw, NDArray(jnp.asarray(gs[0])), ())
        topt.update(0, tw, torch.from_numpy(gs[0]), ())
    _close(tw.numpy(), onp.asarray(jw._data))
    runs = []
    for _ in range(2):
        opt = optimizer.SGLD(learning_rate=0.01,
                             generator=torch.Generator().manual_seed(3))
        w = torch.from_numpy(w0[0].copy())
        for gs in grads:
            opt.update(0, w, torch.from_numpy(gs[0]), ())
        runs.append(w)
    assert torch.equal(*runs) and not torch.equal(
        runs[0], torch.from_numpy(w0[0]))


def test_step_and_fused_step_are_update():
    w0, grads = _data(15)
    out = []
    for method in ("update", "step", "fused_step"):
        opt = optimizer.create("adamw", **COMMON)
        ws = [torch.from_numpy(w.copy()) for w in w0]
        sts = [opt.create_state(i, w) for i, w in enumerate(ws)]
        for gs in grads:
            getattr(opt, method)([0, 1, 2], ws, [torch.from_numpy(g)
                                                 for g in gs], sts)
        out.append(ws)
    for ws in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(ws, out[0]))
    assert pickle.loads(pickle.dumps(opt)).lr == opt.lr


def test_cpu_updates_launch_no_kernel():
    cuda_ops.reset_launch_counts()
    for case in ("sgd", "adamw", "lamb"):
        _, topt = _pair(case)
        w = torch.ones(4)
        topt.update(0, w, torch.ones(4), topt.create_state(0, w))
    assert set(cuda_ops.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# the host side of the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_entries,chunk", [(mt.TABLE, mt.CHUNK),
                                               (3, 16), (1, 8)])
def test_plan_covers_every_element_once(max_entries, chunk):
    """Every element of every non-empty tensor lies in exactly one chunk;
    launches are cut at ``max_entries`` tensors; a tensor whose pointers
    are not all 16-byte aligned (or of 1-byte elements) takes the scalar
    path, and so do all its chunks."""
    rng = onp.random.RandomState(0)
    numels = [0, 1, 3, 4097, 16, 17, 40000, 0, 5] + list(
        rng.randint(0, 100, 20))
    aligns = [256, 2, 16, 4, 32, 8, 256, 1, 512] + [16] * 20
    sizes = [4, 2, 2, 4, 4, 1, 2, 4, 2] + [4] * 20
    launches = mt.multi_tensor_plan(numels, sizes, aligns, max_entries, chunk)
    live = [i for i, n in enumerate(numels) if n]
    assert [len(L.tensors) for L in launches] == [
        min(max_entries, len(live) - lo)
        for lo in range(0, len(live), max_entries)]
    assert sum((L.tensors.tolist() for L in launches), []) == live
    covered = {i: onp.zeros(n, int) for i, n in enumerate(numels)}
    for L in launches:
        tens, starts, aligned = L.chunks()
        assert len(tens) == L.nchunks
        for t, s, a in zip(tens, starts, aligned):
            assert s % chunk == 0
            covered[t][s:s + chunk] += 1
            assert a == (aligns[t] % 16 == 0 and sizes[t] >= 2)
    assert all((c == 1).all() for c in covered.values())


def test_table_holds_pointers_sizes_and_scalars():
    """The table ``_tables`` builds for a launch: pointers, element counts
    and per-tensor scalars in the planned order, the chunk prefix, and a
    tensor offset by one element off the vector path."""
    base = torch.zeros(4100)
    groups = [(torch.zeros(3, 4), torch.zeros(3, 4), torch.zeros(3, 4),
               None),
              (base[1:4098], torch.zeros(4097), torch.zeros(4097), None),
              (torch.zeros(0), torch.zeros(0), torch.zeros(0), None),
              (torch.zeros(20000), torch.zeros(20000), torch.zeros(20000),
               None)]
    (launch, tab), = list(mt._tables(groups, {"lr": [1, 2, 3, 4],
                                                  "wd": [5, 6, 7, 8]}))
    assert launch.tensors.tolist() == [0, 1, 3]
    assert tab["ntensors"] == 3
    assert tab["w"][:4].tolist() == [groups[0][0].data_ptr(),
                                     groups[1][0].data_ptr(),
                                     groups[3][0].data_ptr(), 0]
    assert tab["s1"][:3].tolist() == [0, 0, 0]
    assert tab["n"][:3].tolist() == [12, 4097, 20000]
    assert tab["chunk_begin"][:4].tolist() == [0, 1, 2, 4]
    assert tab["aligned"][:3].tolist() == [1, 0, 1]
    assert tab["lr"][:3].tolist() == [1, 2, 4]
    assert tab["wd"][:3].tolist() == [5, 6, 8]
    assert tab["eta"][:3].tolist() == [1, 1, 1]
    assert mt._TABLE_DTYPE.itemsize <= 32764 - mt._SCALARS_DTYPE.itemsize


def test_tables_cut_a_long_list():
    ts = [torch.zeros(2) for _ in range(2 * mt.TABLE + 3)]
    tabs = list(mt._tables([(t, t, None, None) for t in ts],
                           {"lr": [0.1] * len(ts), "wd": [0] * len(ts)}))
    assert [int(t["ntensors"]) for _, t in tabs] == [mt.TABLE, mt.TABLE, 3]


@pytest.mark.parametrize("bad,err", [
    (lambda w, g, s: [(w.double(), g, s, s, None)], TypeError),
    (lambda w, g, s: [(w, g.to(torch.int32), s, s, None)], TypeError),
    (lambda w, g, s: [(w, g, s.half(), s, None)], TypeError),
    (lambda w, g, s: [(w, g.t(), s, s, None)], ValueError),
    (lambda w, g, s: [(w, g[:2], s, s, None)], ValueError),
    (lambda w, g, s: [(w, g, s, s, None),
                      (w.bfloat16(), g, s, s, None)], TypeError),
    (lambda w, g, s: [(w.half(), g, s, s, s),
                      (w.half(), g, s, s, None)], ValueError),
    (lambda w, g, s: [(w, g, s, s, s.double())], TypeError),
], ids=["float64_weight", "int_grad", "half_state", "strided_grad",
        "shape", "mixed_weight_dtypes", "mixed_master", "float64_master"])
def test_kernel_input_checks_refuse(bad, err):
    """What the kernels do not take raises (the check the wrappers run on
    CUDA tensors, run here on CPU ones)."""
    w, g, s = torch.zeros(3, 3), torch.zeros(3, 3), torch.zeros(3, 3)
    with pytest.raises(err):
        mt._check("multi_adam", bad(w, g, s))


def test_mixed_devices_raise():
    meta = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="or all on CUDA"):
        mt._on_cuda([(torch.zeros(2), meta)])
