"""The preemption half of the port's fault runtime against the JAX
package's: the autosave (``PreemptionHandler`` / ``on_preemption`` /
``load_snapshot``), the elastic state (``save_elastic_state`` /
``load_elastic_state``), and the step and dataloader seams that deliver
``preempt``, ``peer_preempt`` and ``worker_kill``.

A small Gluon net gets the JAX package's initial weights through
``convert.load_params``; both packages train it the same steps, the port
is preempted (an injected ``preempt`` at the step seam) and resumes from
its snapshot in a fresh net and Trainer.  The resumed port run equals
the uninterrupted port run bit for bit, and its output matches the JAX
package's uninterrupted run to 1e-5 (float32 summed in different
orders).  File names, generations and manifests of the snapshots and the
elastic state are compared between the packages exactly.  Kills
(``peer_preempt``, ``worker_kill``, an unhandled ``preempt``) happen
only to child processes.
"""
import os
import pickle
import random
import signal
import subprocess
import sys
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import fault as jfault
from mxnet_tpu_torch import autograd as tautograd
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.convert import export_params, load_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
STEPS = 4


@pytest.fixture(autouse=True)
def _clean():
    for f in (jfault, tfault):
        f.clear()
    yield
    for f in (jfault, tfault):
        f.clear()
        h = f.preempt_handler()
        if h is not None:
            h.uninstall()


def _data(step):
    rs = onp.random.RandomState(10 + step)
    return (rs.normal(0, 1, (6, 5)).astype(onp.float32),
            rs.normal(0, 1, (6, 3)).astype(onp.float32))


def _jax_net():
    jmx.np.random.seed(3)
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(8, in_units=5, activation="relu"),
            jmx.gluon.nn.Dense(3, in_units=8))
    net.initialize()
    return net


def _port_net(params):
    net = tgluon.nn.HybridSequential()
    net.add(tgluon.nn.Dense(8, in_units=5, activation="relu"),
            tgluon.nn.Dense(3, in_units=8))
    net.initialize(device="cpu")
    return load_params(net, params)


def _params(jnet):
    return {k: onp.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}


def _port_steps(net, trainer, steps):
    loss_fn = tgluon.loss.L2Loss()
    for s in steps:
        x, y = (torch.from_numpy(a) for a in _data(s))
        with tautograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
    return net(torch.from_numpy(_data(99)[0])).detach().numpy()


def _jax_steps(net, trainer, steps):
    loss_fn = jmx.gluon.loss.L2Loss()
    for s in steps:
        x, y = (jmx.np.array(a) for a in _data(s))
        with jmx.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
        trainer.step(1)
    return onp.asarray(net(jmx.np.array(_data(99)[0]))._data)


def test_preempted_run_resumes_exactly_and_matches_the_reference(tmp_path):
    """SGD with momentum: Adam's bias correction reads per-parameter
    update counts that ``save_states`` does not keep, in the reference as
    in the port (``num_update`` only), so an Adam resume restarts them."""
    jnet = _jax_net()
    params = _params(jnet)
    opt = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}
    want = _jax_steps(jnet, jmx.gluon.Trainer(jnet.collect_params(), "sgd",
                                              opt), range(STEPS))
    # uninterrupted port run
    net = _port_net(params)
    straight = _port_steps(net, tgluon.Trainer(net.collect_params(), "sgd",
                                               opt), range(STEPS))
    onp.testing.assert_allclose(straight, want, rtol=TOL, atol=TOL)
    # preempted at the 3rd step: the handler snapshots before its update
    net = _port_net(params)
    trainer = tgluon.Trainer(net.collect_params(), "sgd", opt)
    handler = tfault.on_preemption(str(tmp_path), net=net, trainer=trainer,
                                   exit_on_signal=False)
    tfault.inject("preempt", at=3)
    _port_steps(net, trainer, range(STEPS))
    assert handler.fired == 1
    torch.manual_seed(1)
    onp.random.seed(1)
    random.seed(1)
    handler.uninstall()
    draws = (torch.rand(3), onp.random.rand(3), random.random())
    # a fresh process's view: a new net and Trainer from the snapshot
    net2 = _port_net(params)
    trainer2 = tgluon.Trainer(net2.collect_params(), "sgd", opt)
    before = tfault.stats()
    manifest = tfault.load_snapshot(str(tmp_path), net=net2,
                                    trainer=trainer2)
    assert manifest["reason"] == "injected" and before == {"preempt": 1}
    assert trainer2.optimizer.num_update == 2
    resumed = _port_steps(net2, trainer2, range(2, STEPS))
    assert onp.array_equal(resumed, straight)
    onp.testing.assert_allclose(resumed, want, rtol=TOL, atol=TOL)
    # the host RNG came back to the snapshot's state, not the reseed
    again = (torch.rand(3), onp.random.rand(3), random.random())
    assert not torch.equal(again[0], draws[0])
    tfault.load_snapshot(str(tmp_path))
    assert torch.equal(torch.rand(3), again[0])
    assert onp.array_equal(onp.random.rand(3), again[1])
    assert random.random() == again[2]


def test_sigterm_fires_the_handler_and_uninstall_restores(tmp_path):
    net = _port_net(_params(_jax_net()))
    prev = signal.getsignal(signal.SIGTERM)
    handler = tfault.on_preemption(str(tmp_path), net=net,
                                   exit_on_signal=False)
    assert signal.getsignal(signal.SIGTERM) == handler._on_signal
    os.kill(os.getpid(), signal.SIGTERM)
    assert handler.fired == 1
    manifest = tfault.load_snapshot(str(tmp_path))
    assert manifest["reason"] == "SIGTERM"
    handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert tfault.preempt_handler() is None


def _snapshot_names(f, root):
    """Snapshot files of a rng-only handler: generations, per-process
    tags, pruning, and which manifest a resume reads."""
    out = []
    for idx in (None, 1, 2):
        h = f.PreemptionHandler(root, process_index=idx,
                                signals=())
        for _ in range(3):
            h.fire(reason="r%s" % idx)
    out.append(sorted(n for n in os.listdir(root)))
    out.append(f.load_snapshot(root, process_index=2,
                               restore_rng=False)["generation"])
    out.append(f.load_snapshot(root, process_index=5,
                               restore_rng=False)["reason"])
    with open(os.path.join(root, "preempt.p1.resume.json"), "r+b") as fh:
        fh.truncate(5)
    with pytest.raises(f.CorruptCheckpointError):
        f.load_snapshot(root, process_index=1)
    return out


def test_snapshot_names_and_generations_match_the_reference(tmp_path):
    got = _snapshot_names(tfault, str(tmp_path / "port"))
    want = _snapshot_names(jfault, str(tmp_path / "jax"))
    assert got == want
    assert "preempt.p2.g2.rng" in got[0] and "preempt.p2.g0.rng" not in got[0]


def _elastic_state(f, root):
    out = [f.load_elastic_state(root)]
    onp.random.seed(7)
    manifest = f.save_elastic_state(root, step=12, generation=3, world=4,
                                    epoch=2, checkpoint="ck.g5",
                                    extra={"note": "x"})
    want = onp.random.rand(4)
    payload = f.load_elastic_state(root)
    out.append({k: payload[k] for k in ("step", "generation", "world",
                                        "epoch", "checkpoint", "extra")})
    out.append(onp.array_equal(onp.random.rand(4), want))
    out.append({k: manifest[k] for k in ("step", "generation", "world",
                                         "epoch", "version")})
    out.append(sorted(manifest["files"]))
    with open(os.path.join(root, f.ELASTIC_STATE), "r+b") as fh:
        fh.truncate(4)
    with pytest.raises(f.CorruptCheckpointError):
        f.load_elastic_state(root)
    return out


def test_elastic_state_round_trips_like_the_reference(tmp_path):
    got = _elastic_state(tfault, str(tmp_path / "port"))
    want = _elastic_state(jfault, str(tmp_path / "jax"))
    assert got == want
    assert got[0] is None and got[2] is True


def test_elastic_state_keeps_the_torch_generators(tmp_path):
    torch.manual_seed(5)
    tfault.save_elastic_state(str(tmp_path), 1, 0, 1)
    want = torch.rand(2)
    tfault.load_elastic_state(str(tmp_path), restore_rng=False)
    assert not torch.equal(torch.rand(2), want)
    tfault.load_elastic_state(str(tmp_path))
    assert torch.equal(torch.rand(2), want)
    with open(tmp_path / tfault.ELASTIC_STATE, "rb") as fh:
        assert set(pickle.load(fh)["rng"]) >= {"numpy", "random", "torch"}


def _kill_order(f):
    """Which of four sleeping child processes ``worker_kill`` SIGKILLs at
    each of two seeded dataloader events."""
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import time; time.sleep(60)"])
             for _ in range(4)]
    try:
        pool = types.SimpleNamespace(_pool=[types.SimpleNamespace(
            pid=p.pid, join=lambda timeout, p=p: p.wait(timeout))
            for p in procs])
        f.inject("worker_kill", at=2, count=2, seed=11)
        for _ in range(3):
            f.dataloader_hook(pool)
        return [p.poll() for p in procs], f.stats()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)


def test_dataloader_hook_kills_the_reference_worker():
    got, want = _kill_order(tfault), _kill_order(jfault)
    assert got == want
    assert sorted(c for c in got[0] if c is not None) in \
        ([-signal.SIGKILL], [-signal.SIGKILL] * 2)
    tfault.dataloader_hook(types.SimpleNamespace(_pool=[]))  # no workers


@pytest.mark.parametrize("kind, code", [
    ("peer_preempt", -signal.SIGKILL),     # hard: no notice, no autosave
    ("preempt", -signal.SIGTERM),          # no handler: the signal itself
])
def test_step_faults_kill_a_child_process(kind, code):
    prog = ("import sys; sys.path.insert(0, %r)\n"
            "from mxnet_tpu_torch import fault\n"
            "fault.inject(%r, at=2)\n"
            "fault.step_hook(None)\n"
            "print('survived step 1', flush=True)\n"
            "fault.step_hook(None)\n"
            "print('survived step 2', flush=True)\n" % (ROOT, kind))
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       timeout=120, text=True)
    assert p.returncode == code, p.stderr[-2000:]
    assert p.stdout.splitlines() == ["survived step 1"]


def test_preempt_handler_releases_an_active_lease(tmp_path):
    from mxnet_tpu_torch import fault_dist as tfd
    comm = types.SimpleNamespace(rank=0, world=1, _round=0,
                                 allgather=lambda p, timeout=None: [p])
    hb = tfd.Heartbeat(comm=comm, every=1, timeout=1)
    lease = tfd.enable_step_lease(heartbeat=hb)
    try:
        hb.beat(step=0)
        assert lease.active()
        handler = tfault.PreemptionHandler(str(tmp_path), signals=())
        handler.fire(reason="notice")
        assert lease.active()               # released at the next beat
        hb.beat(step=1)
        assert lease.state() == "revoked"
    finally:
        tfd.disable_step_lease()


def test_export_params_round_trip_after_a_resume(tmp_path):
    """The resumed net's parameters export by the JAX names."""
    jnet = _jax_net()
    net = _port_net(_params(jnet))
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
    _port_steps(net, trainer, range(2))
    tfault.PreemptionHandler(str(tmp_path), net=net, trainer=trainer,
                             signals=()).fire()
    net2 = _port_net(_params(jnet))
    tfault.load_snapshot(str(tmp_path), net=net2, restore_rng=False)
    a, b = export_params(net), export_params(net2)
    assert sorted(a) == sorted(_params(jnet))
    assert all(onp.array_equal(a[k], b[k]) for k in a)
