"""``mx.monitor.Monitor`` of the port against the JAX package's.

The reference ``tests/test_monitor.py``'s eight cases run against the
port; then one small Gluon net (Conv2D / BatchNorm / Dense, float32) is
built in both packages with the same weights (``convert.load_params``)
and fed the same seeded input through both monitors: the two give the
same ``(step, name)`` list and stats to rtol 1e-5, and an injected NaN
the same first NaN name.  The port's own contract: a user ``stat_func``
gets numpy, the default stat stays on the device until one transfer at
``toc()``, and nothing is queued while a CUDA graph is captured.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.monitor import Monitor as JMonitor
from mxnet_tpu.ndarray.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import monitor as monitor_mod
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.monitor import Monitor
from mxnet_tpu_torch.ops import cuda_ops

RTOL = 1e-5


def _small_net():
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu", in_units=5), nn.Dense(3))
    net.initialize(device="cpu")
    return net


def _x(seed, *shape):
    return torch.from_numpy(
        onp.random.RandomState(seed).rand(*shape).astype("float32"))


# ----------------------------------------------------------------------
# the reference's eight cases
# ----------------------------------------------------------------------
def test_monitor_collects_output_and_param_stats():
    net = _small_net()
    mon = Monitor(interval=1)
    mon.install(net)
    mon.tic()
    net(_x(0, 2, 5))
    res = mon.toc()
    assert res, "toc must return collected stats"
    names = [name for _, name, _ in res]
    assert any(name.endswith("_output") for name in names)
    assert any("weight" in name for name in names)  # params snapshot
    for step, name, stat in res:
        assert step == 1  # reference tic() increments before the batch
        assert isinstance(stat, str) and stat != ""
        assert stat != "nan"


def test_monitor_catches_injected_nan():
    net = _small_net()
    x = _x(1, 2, 5)
    net(x)
    mon = Monitor(interval=1, sort=True)
    mon.install(net)
    params = net.collect_params()
    wname = [n for n in params if "weight" in n][-1]
    with torch.no_grad():
        params[wname].fill_(float("nan"))
    mon.tic()
    net(x)
    res = mon.toc()
    nan_names = [name for _, name, stat in res if "nan" in stat]
    assert nan_names, "NaN must be visible in monitor stats"
    first_dense_out = [stat for _, name, stat in res
                       if name.endswith("0_output")]
    assert first_dense_out and "nan" not in first_dense_out[0]


def test_monitor_interval_gating():
    net = _small_net()
    mon = Monitor(interval=2)
    mon.install(net)
    x = _x(2, 1, 5)
    mon.tic()            # step 0: activated
    net(x)
    assert mon.toc() != []
    mon.tic()            # step 1: not on the interval
    net(x)
    assert mon.toc() == []
    mon.tic()            # step 2: activated again
    net(x)
    assert mon.toc() != []


def test_monitor_pattern_and_sort():
    net = _small_net()
    mon = Monitor(interval=1, pattern=".*_output.*", sort=True)
    mon.install(net)
    mon.tic()
    net(_x(3, 2, 5))
    names = [name for _, name, _ in mon.toc()]
    assert names and all("_output" in n for n in names)  # params filtered
    assert names == sorted(names)


def test_monitor_all_captures_inputs():
    net = _small_net()
    mon = Monitor(interval=1, monitor_all=True)
    mon.install(net)
    mon.tic()
    net(_x(4, 2, 5))
    names = [name for _, name, _ in mon.toc()]
    assert any("_input" in n for n in names)


def test_monitor_custom_stat_func_and_toc_print(capsys):
    net = _small_net()
    mon = Monitor(interval=1, stat_func=lambda x: float(x.max()),
                  pattern=".*_output.*")
    mon.install(net)
    mon.tic()
    net(torch.ones(2, 5))
    res = mon.toc_print()
    printed = capsys.readouterr().out
    assert res
    for _, name, _ in res:
        assert name in printed


def test_monitor_uninstall_stops_collection():
    net = _small_net()
    mon = Monitor(interval=1)
    mon.install(net)
    mon.uninstall()
    mon.tic()
    net(_x(5, 1, 5))
    names = [name for _, name, _ in mon.toc()]
    assert not any("_output" in n for n in names)  # hooks detached


def test_monitor_namespace():
    assert mx.monitor.Monitor is Monitor
    assert mx.mon.Monitor is Monitor


# ----------------------------------------------------------------------
# parity with the JAX package
# ----------------------------------------------------------------------
def _conv_net(m):
    net = m.HybridSequential()
    net.add(m.Conv2D(4, 3, padding=1), m.BatchNorm(), m.Activation("relu"),
            m.Conv2D(6, 3, padding=1, strides=2), m.BatchNorm(),
            m.GlobalAvgPool2D(), m.Flatten(), m.Dense(5), m.Dense(3))
    return net


def _pair(seed):
    """The same net in both packages, the JAX weights in the port's."""
    x = onp.random.RandomState(seed).randn(2, 3, 8, 8).astype("float32")
    jnet = _conv_net(jmx.gluon.nn)
    jnet.initialize()
    jnet(JNDArray(jnp.asarray(x)))
    tnet = _conv_net(nn)
    tnet.initialize(device="cpu")
    tnet(torch.from_numpy(x))
    load_params(tnet, {k: onp.asarray(p.data()._data)
                       for k, p in jnet.collect_params().items()})
    return jnet, tnet, x


def _run(mon_cls, net, x, **kw):
    mon = mon_cls(interval=1, **kw)
    mon.install(net)
    mon.tic()
    net(x)
    return mon.toc()


def _backward(jnet, tnet, x, seed):
    """One inference-mode backward of ``(net(x) * w).sum()`` in both
    packages, so every parameter has a gradient for ``monitor_all``."""
    w = onp.random.RandomState(seed).randn(2, 3).astype("float32")
    with jmx.autograd.record(train_mode=False):
        loss = (jnet(JNDArray(jnp.asarray(x)))
                * JNDArray(jnp.asarray(w))).sum()
    loss.backward()
    with mx.autograd.record(train_mode=False):
        loss = (tnet(torch.from_numpy(x)) * torch.from_numpy(w)).sum()
    loss.backward()


@pytest.mark.parametrize("monitor_all", [False, True])
def test_names_and_stats_match_jax(monitor_all):
    jnet, tnet, x = _pair(7)
    if monitor_all:
        _backward(jnet, tnet, x, 17)
    jres = _run(JMonitor, jnet, JNDArray(jnp.asarray(x)),
                monitor_all=monitor_all)
    tres = _run(Monitor, tnet, torch.from_numpy(x),
                monitor_all=monitor_all)
    assert [(s, n) for s, n, _ in tres] == [(s, n) for s, n, _ in jres]
    assert len(tres) > 20
    onp.testing.assert_allclose([float(v) for _, _, v in tres],
                                [float(v) for _, _, v in jres], rtol=RTOL)


def test_first_nan_layer_matches_jax():
    jnet, tnet, x = _pair(8)
    bad = "3.weight"        # the second convolution
    w = onp.asarray(jnet.collect_params()[bad].data()._data).copy()
    w[0, 0, 1, 1] = onp.nan
    jnet.collect_params()[bad].set_data(JNDArray(jnp.asarray(w)))
    with torch.no_grad():
        tnet.collect_params()[bad].copy_(torch.from_numpy(w))
    jres = _run(JMonitor, jnet, JNDArray(jnp.asarray(x)))
    tres = _run(Monitor, tnet, torch.from_numpy(x))

    def first_nan(res):
        return next(n for _, n, v in res if v == "nan")
    assert first_nan(tres) == first_nan(jres) == "hybridsequential.3_output"
    before = [v for _, n, v in tres[:[n for _, n, _ in tres].index(
        "hybridsequential.3_output")]]
    assert before and "nan" not in before


# ----------------------------------------------------------------------
# the port's own contract
# ----------------------------------------------------------------------
def test_user_stat_func_receives_numpy():
    seen = []

    def stat(a):
        seen.append(type(a))
        return float(onp.abs(a).max())
    net = _small_net()
    mon = Monitor(interval=1, stat_func=stat)
    mon.install(net)
    mon.tic()
    net(_x(9, 2, 5))
    res = mon.toc()
    assert res and set(seen) == {onp.ndarray}
    assert all(v != "nan" for _, _, v in res)


def test_default_stat_stays_on_device_until_one_transfer(monkeypatch):
    """The hooks queue 0-d tensors and make no host copy; ``toc()``
    makes exactly one (the stacked stats of the one device)."""
    calls = {"cpu": 0, "item": 0, "numpy_before": 0}
    cpu, item = torch.Tensor.cpu, torch.Tensor.item

    def counting_cpu(self, *a, **k):
        calls["cpu"] += 1
        return cpu(self, *a, **k)

    def counting_item(self, *a, **k):
        calls["item"] += 1
        return item(self, *a, **k)
    net = _small_net()
    mon = Monitor(interval=1, monitor_all=True)
    mon.install(net)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "item", counting_item)
    mon.tic()
    net(_x(10, 2, 5))
    assert calls == {"cpu": 0, "item": 0, "numpy_before": 0}
    assert mon.queue and all(
        isinstance(s, monitor_mod.DeviceStat) and s.total.dim() == 0
        and s.total.dtype == torch.float32 for _, _, s in mon.queue)
    before = monitor_mod.TRANSFERS["count"]
    res = mon.toc()
    assert calls["cpu"] == 1 and calls["item"] == 0
    assert monitor_mod.TRANSFERS["count"] == before + 1
    assert len(res) > 6


def test_capture_path_queues_nothing(monkeypatch):
    """``capture_graph``'s warm-ups and capture run under
    ``cuda_ops.capturing()``, where the hooks queue nothing: on the CPU
    the capture itself is stood in for by running ``fn`` (no CUDA
    graph here), through the same flag."""
    net = _small_net()
    mon = Monitor(interval=1)
    mon.install(net)
    x = _x(11, 2, 5)
    ran = []

    def fake_capture(fn, pool, warmup):
        for _ in range(warmup + 1):
            ran.append(cuda_ops.capturing())
            fn()
        return None, None, {}
    monkeypatch.setattr(cuda_ops, "_capture_graph", fake_capture)
    mon.tic()
    cuda_ops.capture_graph(lambda: net(x))
    assert ran == [True, True, True] and not cuda_ops.capturing()
    assert mon.queue == []
    net(x)                               # an eager call still queues
    names = [n for _, n, _ in mon.toc()]
    assert "hybridsequential_output" in names
    assert names.count("hybridsequential.0_output") == 1
