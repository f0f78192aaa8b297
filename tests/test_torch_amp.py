"""The port's mixed precision (``mxnet_tpu_torch/amp``) and non-finite
step guard (``fault.grads_finite`` / ``GradGuard`` / ``step_hook``,
``Trainer.step(skip_nonfinite=)``) against the JAX package's, on the CPU.

Mirrors ``tests/test_amp_training.py`` on both packages: the same
numpy-seeded float16 Dense and Conv nets (weights carried across by
``convert.load_params``) train through ``amp.scale_loss`` and a Trainer
with a loss scaler.  The loss-scale trajectories, skip verdicts and
counters must be equal; the weights after the steps agree to rtol 2e-2 /
atol 2e-3: both sides run float16 products whose sums round in other
orders, about one float16 step (2^-11 of a weight) per step, and a
gradient that differs by a step moves a weight by lr times it.  An
overflowed or skipped step must leave the weights bit for bit.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import amp as j_amp
from mxnet_tpu import autograd as j_autograd
from mxnet_tpu import fault as j_fault
from mxnet_tpu import gluon as j_gluon
from mxnet_tpu import profiler as j_prof
from mxnet_tpu.amp.loss_scaler import LossScaler as JScaler
from mxnet_tpu.gluon import nn as j_nn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as t_amp
from mxnet_tpu_torch import autograd as t_autograd
from mxnet_tpu_torch import fault as t_fault
from mxnet_tpu_torch import gluon as t_gluon
from mxnet_tpu_torch import profiler as t_prof
from mxnet_tpu_torch.amp.loss_scaler import LossScaler as TScaler
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon import nn as t_nn

W_RTOL, W_ATOL = 2e-2, 2e-3


@pytest.fixture(autouse=True)
def _clean():
    j_fault.clear()
    t_fault.clear()
    yield
    j_fault.clear()
    t_fault.clear()


def _build(nn, kind):
    if kind == "dense":
        return nn.Dense(4, in_units=6)
    net = nn.HybridSequential()
    net.add(nn.Conv2D(3, 3, padding=1, in_channels=2),
            nn.Dense(4, in_units=3 * 5 * 5))
    return net


IN_SHAPE = {"dense": (3, 6), "conv": (2, 2, 5, 5)}


class Pair:
    """One net in each package with the same float16 weights, a Trainer
    on each, and their steps driven from the same numpy batches."""

    def __init__(self, kind="dense", lr=0.1, optimizer="sgd", scaler=None,
                 trainer_kw=None, seed=11):
        self.kind = kind
        mx.np.random.seed(seed)
        self.jnet = _build(j_nn, kind)
        self.jnet.initialize()
        x = onp.zeros(IN_SHAPE[kind], onp.float32)
        self.jnet(mx.np.array(x))
        j_amp.convert_hybrid_block(self.jnet, "float16")
        params = {k: onp.asarray(p.data()._data).astype(onp.float32)
                  for k, p in self.jnet.collect_params().items()}
        self.tnet = _build(t_nn, kind).initialize(device="cpu")
        load_params(self.tnet, params)
        t_amp.convert_hybrid_block(self.tnet, "float16")
        kw = dict(trainer_kw or {})
        self.jtr = j_gluon.Trainer(self.jnet.collect_params(), optimizer,
                                   {"learning_rate": lr}, **kw)
        self.ttr = t_gluon.Trainer(self.tnet.collect_params(), optimizer,
                                   {"learning_rate": lr}, **kw)
        if scaler is not None:
            self.jtr._amp_loss_scaler = JScaler(**scaler)
            self.ttr._amp_loss_scaler = TScaler(**scaler)

    def backward(self, x, scaled=True):
        """The loss (net(x)^2).mean() in float16, through scale_loss."""
        with j_autograd.record():
            loss = (self.jnet(mx.np.array(x).astype("float16")) ** 2).mean()
            if scaled:
                with j_amp.scale_loss(loss, self.jtr) as s:
                    s.backward()
            else:
                loss.backward()
        with t_autograd.record():
            tl = (self.tnet(torch.from_numpy(x).half()) ** 2).mean()
            if scaled:
                with t_amp.scale_loss(tl, self.ttr) as s:
                    t_autograd.backward(s)
            else:
                t_autograd.backward(tl)

    def step(self, batch, **kw):
        self.jtr.step(batch, **kw)
        self.ttr.step(batch, **kw)

    def weights(self):
        j = {k: onp.asarray(p.data()._data).astype(onp.float32)
             for k, p in self.jnet.collect_params().items()}
        t = {k: p.detach().float().numpy()
             for k, p in self.tnet.collect_params().items()}
        return j, t

    def scales(self):
        return (self.jtr._amp_loss_scaler.loss_scale,
                self.ttr._amp_loss_scaler.loss_scale)

    def assert_close(self):
        j, t = self.weights()
        assert sorted(j) == sorted(t)
        for k in j:
            onp.testing.assert_allclose(t[k], j[k], rtol=W_RTOL, atol=W_ATOL,
                                        err_msg=k)


def _x(kind, seed, scale=1.0):
    return (onp.random.RandomState(seed).normal(0, 1, IN_SHAPE[kind])
            * scale).astype(onp.float32)


@pytest.mark.parametrize("kind", ["dense", "conv"])
def test_loss_scale_trajectory_and_weights_match(kind):
    """From 2^18 the float16 loss times the scale overflows until the
    scale has halved enough; then the window grows it again.  Both
    packages take the same verdicts step by step."""
    pair = Pair(kind, scaler=dict(init_scale=2.0 ** 18, scale_window=2))
    traj = []
    for i in range(8):
        pair.backward(_x(kind, i, 2.0))
        pair.step(1)
        traj.append(pair.scales())
    j_traj = [s[0] for s in traj]
    assert j_traj == [s[1] for s in traj], traj
    assert min(j_traj) < 2.0 ** 18 and j_traj[-1] > min(j_traj), j_traj
    pair.assert_close()


def test_scaled_step_matches_unscaled_and_jax():
    """The step folds 1 / loss_scale into rescale_grad: with a power-of-
    two scale and no overflow, AMP training is the plain training."""
    runs = {}
    for with_amp in (True, False):
        pair = Pair("dense", scaler=dict(init_scale=1024.0) if with_amp
                    else None)
        for i in range(3):
            pair.backward(_x("dense", i), scaled=with_amp)
            pair.step(1)
        pair.assert_close()
        runs[with_amp] = pair.weights()[1]
    for k in runs[True]:
        onp.testing.assert_array_equal(runs[True][k], runs[False][k])


def test_overflow_leaves_weights_bitwise_and_halves_scale():
    pair = Pair("dense", scaler=dict(init_scale=1024.0, scale_window=3))
    x = _x("dense", 0)
    pair.backward(x)
    pair.jnet.weight.grad()._data = jnp.full_like(
        pair.jnet.weight.grad()._data, jnp.inf)
    pair.tnet.weight.grad.fill_(float("inf"))
    before = pair.weights()
    pair.step(2)
    after = pair.weights()
    for side in (0, 1):
        for k in before[side]:
            onp.testing.assert_array_equal(after[side][k], before[side][k])
    assert pair.scales() == (512.0, 512.0)
    # the gradients were consumed by the dropped step
    with pytest.raises(UserWarning):
        pair.jtr.step(2)
    with pytest.raises(UserWarning):
        pair.ttr.step(2)
    pair.backward(x)
    pair.step(2)
    assert not onp.allclose(pair.weights()[1]["weight"], before[1]["weight"])
    pair.assert_close()


def test_scale_grows_after_window():
    pair = Pair("dense", scaler=dict(init_scale=64.0, scale_window=2))
    for i in range(2):
        pair.backward(_x("dense", i))
        pair.step(2)
    assert pair.scales() == (128.0, 128.0)


def test_manual_unscale_not_double_divided():
    """unscale() then step divides by the loss scale exactly once."""
    out = {}
    for manual in (True, False):
        pair = Pair("dense", scaler=dict(init_scale=256.0))
        pair.backward(_x("dense", 1))
        if manual:
            j_amp.unscale(pair.jtr)
            t_amp.unscale(pair.ttr)
            assert pair.ttr._amp_loss_scaler._manual_unscaled
        pair.step(1)
        assert not pair.ttr._amp_loss_scaler._manual_unscaled
        pair.assert_close()
        out[manual] = pair.weights()[1]["weight"]
    onp.testing.assert_allclose(out[True], out[False], rtol=1e-3, atol=1e-4)


def test_stale_raise_does_not_leak_the_unscale_flag():
    """A step that raises stale still consumes the manual-unscale flag,
    so the recovery step divides by the scale itself."""
    pair = Pair("dense", scaler=dict(init_scale=256.0))
    j_amp.unscale(pair.jtr)
    t_amp.unscale(pair.ttr)
    for tr in (pair.jtr, pair.ttr):
        with pytest.raises(UserWarning):
            tr.step(1)
        assert not tr._amp_loss_scaler._manual_unscaled
    ref = Pair("dense", scaler=dict(init_scale=256.0))
    for p in (pair, ref):
        p.backward(_x("dense", 2))
        p.step(1)
    onp.testing.assert_array_equal(pair.weights()[1]["weight"],
                                   ref.weights()[1]["weight"])
    pair.assert_close()


def test_per_trainer_scaler_isolation():
    for amp, nn, gluon, ag, dev in (
            (j_amp, j_nn, j_gluon, j_autograd, None),
            (t_amp, t_nn, t_gluon, t_autograd, "cpu")):
        amp.init("float16")
        nets = [nn.Dense(2, in_units=3) for _ in range(2)]
        trs = []
        for net in nets:
            if dev is None:
                net.initialize()
            else:
                net.initialize(device=dev)
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
            amp.init_trainer(tr)
            trs.append(tr)
        assert trs[0]._amp_loss_scaler is not trs[1]._amp_loss_scaler
        assert trs[0]._amp_loss_scaler.loss_scale == 2.0 ** 16
        with ag.record():
            losses = [net(mx.np.ones((1, 3)) if dev is None
                          else torch.ones(1, 3)).sum() for net in nets]
        for loss in losses:
            if dev is None:
                loss.backward()
            else:
                ag.backward(loss)
        amp.unscale(trs[0])
        assert trs[0]._amp_loss_scaler._manual_unscaled
        assert not trs[1]._amp_loss_scaler._manual_unscaled


def _counter(prof, name):
    return prof.get_counters().get("fault::" + name, 0)


def test_skip_nonfinite_and_grad_guard_match():
    """An injected nan_grad under skip_nonfinite, then under a GradGuard
    with max_consecutive=2: the same skips, scale, counters and raise."""
    pair = Pair("dense", scaler=dict(init_scale=64.0))
    base = (_counter(j_prof, "nonfinite_steps"),
            _counter(t_prof, "nonfinite_steps"))
    before = pair.weights()
    j_fault.inject("nan_grad", at=1)
    t_fault.inject("nan_grad", at=1)
    pair.backward(_x("dense", 3))
    pair.step(2, skip_nonfinite=True)
    after = pair.weights()
    for side in (0, 1):
        for k in before[side]:
            onp.testing.assert_array_equal(after[side][k], before[side][k])
    assert pair.scales() == (32.0, 32.0)
    assert (_counter(j_prof, "nonfinite_steps") - base[0]
            == _counter(t_prof, "nonfinite_steps") - base[1] == 1)
    assert j_fault.stats() == t_fault.stats() == {"nan_grad": 1}
    pair.backward(_x("dense", 4))
    pair.step(2, skip_nonfinite=True)
    assert pair.scales() == (32.0, 32.0)
    assert not onp.array_equal(pair.weights()[1]["weight"],
                               before[1]["weight"])
    pair.assert_close()
    guards = (j_fault.GradGuard(pair.jtr, max_consecutive=2),
              t_fault.GradGuard(pair.ttr, max_consecutive=2))
    j_fault.inject("nan_grad", at=1, count=5)
    t_fault.inject("nan_grad", at=1, count=5)
    pair.backward(_x("dense", 5))
    pair.step(2)
    assert [(g.skipped, g.consecutive) for g in guards] == [(1, 1)] * 2
    assert pair.scales() == (16.0, 16.0)
    for tr in (pair.jtr, pair.ttr):
        pair.backward(_x("dense", 6))
        with pytest.raises(Exception, match="consecutive non-finite"):
            tr.step(2)
    assert type(guards[1]).__module__ == "mxnet_tpu_torch.fault"
    for g, tr in zip(guards, (pair.jtr, pair.ttr)):
        g.detach()
        assert tr._grad_guard is None


def test_guard_finite_verdict_and_grads_finite():
    pair = Pair("dense", scaler=dict(init_scale=64.0, scale_window=1))
    guards = (j_fault.GradGuard(pair.jtr), t_fault.GradGuard(pair.ttr))
    pair.backward(_x("dense", 7))
    assert j_fault.grads_finite(list(pair.jnet.collect_params().values()))
    assert t_fault.grads_finite(list(pair.tnet.collect_params().values()))
    pair.step(2)
    assert pair.scales() == (128.0, 128.0)       # a finite step grew it
    assert [(g.skipped, g.consecutive) for g in guards] == [(0, 0)] * 2
    pair.backward(_x("dense", 8))
    pair.tnet.bias.grad[1] = float("nan")
    assert not t_fault.grads_finite(list(pair.tnet.collect_params()
                                         .values()))
    assert t_fault.grads_finite([])


def test_kvstore_path_scaler_and_guard():
    """update_on_kvstore: an overflowed step pushes nothing; the next one
    updates the store's weights, in both packages alike."""
    pair = Pair("dense", scaler=dict(init_scale=1024.0),
                trainer_kw={"kvstore": "local", "update_on_kvstore": True})
    before = pair.weights()
    pair.backward(_x("dense", 0))
    pair.jnet.bias.grad()._data = jnp.full_like(
        pair.jnet.bias.grad()._data, jnp.nan)
    pair.tnet.bias.grad.fill_(float("nan"))
    pair.step(2)
    after = pair.weights()
    for side in (0, 1):
        for k in before[side]:
            onp.testing.assert_array_equal(after[side][k], before[side][k])
    assert pair.scales() == (512.0, 512.0)
    j_fault.inject("nan_grad", at=1)
    t_fault.inject("nan_grad", at=1)
    pair.backward(_x("dense", 1))
    pair.step(2, skip_nonfinite=True)
    assert pair.scales() == (256.0, 256.0)
    pair.backward(_x("dense", 2))
    pair.step(2)
    pair.assert_close()
    assert not onp.array_equal(pair.weights()[1]["weight"],
                               before[1]["weight"])


def test_convert_hybrid_block_keeps_norms_float32():
    dtypes = []
    for nn, dev in ((j_nn, None), (t_nn, "cpu")):
        net = nn.HybridSequential()
        net.add(nn.Conv2D(4, 3, in_channels=2), nn.BatchNorm(in_channels=4),
                nn.Dense(5, in_units=4), nn.LayerNorm(in_channels=5))
        if dev is None:
            net.initialize()
            t_amp_mod = j_amp
        else:
            net.initialize(device=dev)
            t_amp_mod = t_amp
        t_amp_mod.convert_hybrid_block(net, "float16")
        dtypes.append({k: str(p.data().dtype).replace("torch.", "")
                       for k, p in net.collect_params().items()
                       if not k.startswith("1.running")})
    assert dtypes[0] == dtypes[1], dtypes
    assert dtypes[1]["0.weight"] == "float16"
    assert dtypes[1]["1.gamma"] == dtypes[1]["3.gamma"] == "float32"


def test_amp_surface(tmp_path):
    assert tmx.amp is t_amp
    assert t_amp.list_lp16_ops() == j_amp.list_lp16_ops()
    assert t_amp.list_fp32_ops() == j_amp.list_fp32_ops()
    assert t_amp.list_widest_type_cast() == j_amp.list_widest_type_cast()
    with pytest.raises(ValueError):
        t_amp.init("int8")
    with pytest.raises(NotImplementedError):
        t_amp.convert_model(None, {}, {})
    t_amp.init("float16")
    t_amp.init("bfloat16")         # keeps the float16 scaler's prototype
    net = t_nn.Dense(2, in_units=3).initialize(device="cpu")
    tr = t_amp.init_trainer(t_gluon.Trainer(net.collect_params(), "sgd"))
    assert getattr(tr, "_amp_loss_scaler", None) is not None  # fp16 proto
    x = torch.ones(2)
    with t_amp.scale_loss([x, x], tr) as scaled:
        assert [float(s[0]) for s in scaled] == [2.0 ** 16] * 2
    # the preemption half of the fault runtime is ported: an injected
    # preempt at the step seam fires the installed handler, which
    # snapshots the AMP trainer's net and states
    handler = t_fault.on_preemption(str(tmp_path), net=net, trainer=tr,
                                    exit_on_signal=False)
    try:
        t_fault.inject("preempt", at=1)
        t_fault.step_hook(tr)
        assert handler.fired == 1
        manifest = t_fault.load_snapshot(str(tmp_path), net=net)
        assert manifest["reason"] == "injected"
    finally:
        handler.uninstall()
        t_fault.clear()
