"""The port's elastic training (``fault_elastic``) against the JAX
package's, on the same scripted faults.

Each scenario runs once through ``mxnet_tpu.fault_elastic`` and once
through ``mxnet_tpu_torch.fault_elastic``, with threads as ranks over an
``InProcessBoard`` and ``InProcessComm`` heartbeats (the reference tests'
harness, ``tests/test_fault_elastic.py:304``), and the two runs must
agree exactly: each rank's status or exception type, the steps it ran
(step, epoch, loss), its ``ElasticInfo`` (world, survivors, ``lr_scale``
/ ``batch_scale``, generation), the committed ``ResizeIntent``
(survivors, generation, epoch), the ``fault::elastic::*`` /
``fault::dist::*`` counter deltas and the flight-recorder event kinds (a
count per kind: threads interleave their events).  The toy model decays
a weight, so a loss shows exactly which checkpoint a rank resumed from.

One test is a real resize: two gloo ranks on the CPU (this file is their
program: ``python tests/test_torch_fault_elastic.py --rank R --dir D``;
the rank part runs before the JAX imports below, so the ranks never
import JAX) train ``tiny_config`` through ``TrainStep(mesh=dp=2)`` under
an ``ElasticRunner``; rank 1 is SIGKILLed by ``peer_preempt`` after the
step-2 checkpoint; rank 0 loses it at the next heartbeat, votes world 1
on a ``FileBoard``, re-bootstraps, restores through ``shrink_mesh`` +
``TrainStep.resize`` and continues at ``lr_scale`` 0.5.  Its losses after
the resize equal a one-rank ``TrainStep`` restored from the same
checkpoint bit for bit, and the restored weights' loss matches the JAX
``TrainStep`` on the same weights at the dryrun's tolerance (rtol 2e-5,
atol 1e-6, ``__graft_entry__.py:158``).
"""
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
from collections import Counter

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the dryrun's model (__graft_entry__.py:124)
DRYRUN = dict(n_heads=4, n_kv_heads=2, dim=64, hidden_dim=128, n_layers=2,
              vocab_size=128)
B, T, STEPS, LR = 4, 16, 4, 1e-3
JOIN_S = 60


def batch(t):
    rng = onp.random.RandomState(100 + t)
    return (rng.randint(0, 128, (B, T)).astype(onp.int64),
            rng.randint(0, 128, (B, T)).astype(onp.int64))


def _rank_main(rank, out_dir):
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import (fault, fault_dist, fault_elastic,
                                 optimizer, parallel, profiler)
    from mxnet_tpu_torch.convert import export_params, load_params
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    store = "file://" + os.path.join(out_dir, "store")
    os.environ.update(MX_COORD_ADDR=store, MX_NUM_WORKERS="2",
                      MX_WORKER_ID=str(rank))
    assert fault_dist.initialize(store, 2, rank, backend="gloo", timeout=60)
    loss_fn = SoftmaxCrossEntropyLoss()

    def fwd(net, tokens, labels):
        logits = net.forward(tokens)
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1)).mean()

    init = dict(onp.load(os.path.join(out_dir, "init.npz")))
    with mt.cpu():
        net = load_params(TransformerLM(tiny_config(**DRYRUN), device="cpu"),
                          init)
        mesh = [parallel.create_mesh(dp=2, device="cpu")]
        step = parallel.TrainStep(net, None, optimizer.AdamW(learning_rate=LR),
                                  mesh[0], forward_fn=fwd)
        post = []

        def step_fn(t, info):
            n = int(B * info.batch_scale)
            toks, labels = (torch.from_numpy(a[:n]) for a in batch(t))
            step.optimizer.set_learning_rate(LR * info.lr_scale)
            loss = float(step(toks, labels))
            if info.epoch:
                post.append(loss)
            return loss

        def restore_fn(path, info):
            mesh[0] = parallel.shrink_mesh(mesh[0],
                                           ranks=list(range(info.world)))
            step.resize(mesh[0], path)
            shutil.copytree(path, os.path.join(out_dir, "restored_from"))
            onp.savez(os.path.join(out_dir, "restored.npz"),
                      **export_params(net))

        if rank == 1:
            fault.inject("peer_preempt", at=3, op="elastic")
        runner = fault_elastic.ElasticRunner(
            step_fn, board=fault_elastic.FileBoard(
                os.path.join(out_dir, "board")),
            comm_factory=lambda r, w, e: fault_dist.FileComm(
                os.path.join(out_dir, "hb"), r, w, namespace="el%d" % e),
            rank=rank, world=2, save_fn=lambda path, t:
                step.save_checkpoint(path),
            restore_fn=restore_fn,
            ckpt_dir=os.path.join(out_dir, "ckpt%d" % rank), ckpt_every=2,
            heartbeat_timeout=1.0, drain=3.0, min_world=1)
        t0 = time.monotonic()
        status = runner.run(STEPS)
        wall = time.monotonic() - t0
        # the one-rank TrainStep restored from the same checkpoint
        net2 = load_params(TransformerLM(tiny_config(**DRYRUN),
                                         device="cpu"), init)
        solo = parallel.TrainStep(net2, None,
                                  optimizer.AdamW(learning_rate=LR),
                                  forward_fn=fwd)
        solo.load_checkpoint(os.path.join(out_dir, "restored_from"))
        solo.optimizer.set_learning_rate(LR * runner.info.lr_scale)
        n = int(B * runner.info.batch_scale)
        solo_losses = [float(solo(*(torch.from_numpy(a[:n])
                                    for a in batch(t))))
                       for t in range(2, STEPS)]
    res = {"history": runner.history, "post": post, "solo": solo_losses,
           "world": runner.info.world, "lr_scale": runner.info.lr_scale,
           "batch_scale": runner.info.batch_scale,
           "survivors": runner.info.survivors,
           "gen": runner.info.gen.value, "completed": status.completed,
           "resizes": runner.resizes, "wall_s": wall,
           "group_world": torch.distributed.get_world_size(),
           "counters": {k: profiler.get_counter("fault::elastic::" + k)
                        for k in ("resizes", "rebootstraps", "restores",
                                  "votes", "checkpoints")},
           "peer_lost": profiler.get_counter("fault::dist::peer_lost"),
           "imported_jax": any(m.split(".")[0] in ("jax", "jaxlib",
                                                   "mxnet_tpu")
                               for m in sys.modules)}
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    _rank_main(int(args["--rank"]), args["--dir"])
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (JAX from here on)
# ----------------------------------------------------------------------
import pytest  # noqa: E402

from mxnet_tpu import fault as jfault  # noqa: E402
from mxnet_tpu import fault_dist as jfd  # noqa: E402
from mxnet_tpu import fault_elastic as jfe  # noqa: E402
from mxnet_tpu import flightrec as jrec  # noqa: E402
from mxnet_tpu import profiler as jprof  # noqa: E402
from mxnet_tpu import telemetry as jtel  # noqa: E402
from mxnet_tpu_torch import fault as tfault  # noqa: E402
from mxnet_tpu_torch import fault_dist as tfd  # noqa: E402
from mxnet_tpu_torch import fault_elastic as tfe  # noqa: E402
from mxnet_tpu_torch import flightrec as trec  # noqa: E402
from mxnet_tpu_torch import profiler as tprof  # noqa: E402
from mxnet_tpu_torch import telemetry as ttel  # noqa: E402

JAX = types.SimpleNamespace(fault=jfault, fd=jfd, fe=jfe, rec=jrec,
                            prof=jprof, tel=jtel)
PORT = types.SimpleNamespace(fault=tfault, fd=tfd, fe=tfe, rec=trec,
                             prof=tprof, tel=ttel)
COUNTERS = tuple("fault::elastic::" + k for k in (
    "votes", "resizes", "rebootstraps", "restores", "checkpoints",
    "drains", "joins", "scale_up", "scale_down")) + tuple(
    "fault::dist::" + k for k in ("peer_lost", "heartbeats",
                                  "generation_bumps"))


@pytest.fixture(autouse=True)
def _clean():
    saved = {k: os.environ.get(k)
             for k in ("MX_NUM_WORKERS", "MX_WORKER_ID", "MX_COORD_ADDR")}
    for m in (JAX, PORT):
        m.fault.clear()
        m.rec.reset()
    yield
    for m in (JAX, PORT):
        m.fault.clear()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


class _Killed(Exception):
    """A thread-rank's hard death (the SIGKILL stand-in)."""


def _norm(value=None, error=None):
    if error is None:
        return ("ok", value)
    return ("raise", type(error).__name__)


def _threads(worker, ranks):
    results, errors = {}, {}

    def go(r):
        try:
            results[r] = worker(r)
        except BaseException as e:  # noqa: BLE001 -- compared below
            errors[r] = e

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return {r: _norm(results.get(r), errors.get(r)) for r in ranks}


def _observe(m, scenario, tmp):
    before = {c: m.prof.get_counter(c) for c in COUNTERS}
    m.rec.reset()
    out = scenario(m, tmp)
    kinds = [e["kind"] for e in m.rec.events()]
    return {"out": out,
            "counters": {c: m.prof.get_counter(c) - before[c]
                         for c in COUNTERS},
            "events": sorted(Counter(kinds).items())}


def _intent(i):
    return [i.survivors, i.joiners, i.old_world, i.new_world, i.old_rank,
            i.new_rank, i.gen, i.epoch, i.coord, i.step]


def _factory(m):
    pools, lock = {}, threading.Lock()

    def factory(rank, world, epoch):
        with lock:
            if (world, epoch) not in pools:
                pools[(world, epoch)] = m.fd.InProcessComm.create(world)
            return pools[(world, epoch)][rank]
    return factory


def _toy_runner(m, rank, tmp, board, factory, world, fail=None,
                steps=6, notice_at=None, **kw):
    """One thread-rank training a toy weight (w *= 0.8 a step) under an
    ElasticRunner; returns a record of what it ran and ended with."""
    state = {"w": 10.0}
    ckpt_dir = os.path.join(tmp, "rank%d" % rank)
    runner_box = []

    def step_fn(t, info):
        if fail is not None:
            fail(m, rank, t, info)
        if notice_at is not None and t == notice_at:
            runner_box[0].notice()
        state["w"] *= 0.8
        return state["w"]

    def save_fn(path, t):
        with open(path, "w") as f:
            json.dump({"w": state["w"]}, f)

    def restore_fn(path, info):
        if path is not None:
            with open(path) as f:
                state["w"] = json.load(f)["w"]

    args = dict(board=board, comm_factory=factory, rank=rank, world=world,
                save_fn=save_fn, restore_fn=restore_fn, ckpt_dir=ckpt_dir,
                ckpt_every=2, heartbeat_timeout=1.0, drain=4.0,
                min_world=1, max_resizes=2, gen=m.fd.Generation(),
                rebootstrap=lambda intent: None, telemetry=False)
    args.update(kw)
    runner = m.fe.ElasticRunner(step_fn, **args)
    runner_box.append(runner)
    status = runner.run(steps)
    i = runner.info
    return {"status": [status.completed, status.drained, status.step,
                       status.resizes, status.world, status.generation,
                       status.epoch],
            "history": [list(h) for h in runner.history],
            "info": [i.rank, i.world, i.orig_world, i.epoch, i.survivors,
                     i.lr_scale, i.batch_scale, i.gen.value]}


def _shrink(m, tmp):
    board, factory = m.fe.InProcessBoard(), _factory(m)

    def die(m, rank, t, info):
        if rank == 2 and t == 4:
            raise _Killed()
    return _threads(lambda r: _toy_runner(m, r, tmp, board, factory, 3,
                                          fail=die), (0, 1, 2))


def _in_place(m, tmp):
    board, factory = m.fe.InProcessBoard(), _factory(m)
    fired = set()

    def abort(m, rank, t, info):
        if t == 3 and rank not in fired:
            fired.add(rank)
            raise m.fd.CoordinatedAbortError("retry budget spent")
    return _threads(lambda r: _toy_runner(m, r, tmp, board, factory, 2,
                                          fail=abort, steps=5), (0, 1))


def _drain(m, tmp):
    board, factory = m.fe.InProcessBoard(), _factory(m)
    return _threads(lambda r: _toy_runner(
        m, r, tmp, board, factory, 3, notice_at=2 if r == 2 else None),
        (0, 1, 2))


def _grow(m, tmp):
    """Two ranks train; rank 0 starts a joiner at step 2 and waits until
    its join record is on the board, so the beat of step 3 raises
    JoinRequestedError on both; the three end at world 3."""
    board, factory = m.fe.InProcessBoard(), _factory(m)
    joiner = {}

    def start_joiner(m, rank, t, info):
        if rank == 0 and t == 2 and info.world == 2 and not joiner:
            joiner["t"] = threading.Thread(target=lambda: joiner.update(
                out=_threads(lambda r: _toy_runner(
                    m, 2, tmp, board, factory, 2, join="j7",
                    join_drain=JOIN_S, rescale="none",
                    restore_fn=lambda path, info: None), (2,))[2]),
                daemon=True)
            joiner["t"].start()
            deadline = time.monotonic() + JOIN_S
            while "j7" not in m.fe.pending_joiners(board):
                assert time.monotonic() < deadline
                time.sleep(0.01)
    outs = _threads(lambda r: _toy_runner(m, r, tmp, board, factory, 2,
                                          fail=start_joiner,
                                          rescale="none"), (0, 1))
    joiner["t"].join(timeout=JOIN_S)
    outs[2] = joiner["out"]
    return outs


def _votes(m, tmp):
    """The vote's own rules: one round, split knowledge, a voted-out
    rank, leave records, the minimum world, a leader that never
    commits."""
    out = {}
    board = m.fe.InProcessBoard()
    out["one_round"] = _threads(lambda r: _intent(m.fe.vote_resize(
        board, rank=r, world=3, lost=(2,), gen=4, epoch=1, drain=20,
        min_world=1, coord_hint="h%d:1" % r)), (0, 1))
    board = m.fe.InProcessBoard()
    out["split"] = _threads(lambda r: _intent(m.fe.vote_resize(
        board, rank=r, world=3, lost=(2,) if r == 0 else (), gen=0,
        epoch=1, drain=0.7, min_world=1)), (0, 1))
    board = m.fe.InProcessBoard()
    out["voted_out"] = _threads(lambda r: _intent(m.fe.vote_resize(
        board, rank=r, world=3, lost=(), gen=0, epoch=1, drain=0.4,
        min_world=1)), (0, 1))
    out["voted_out"][2] = _threads(lambda r: m.fe.vote_resize(
        board, rank=2, world=3, lost=(), gen=0, epoch=1, drain=0.4,
        min_world=1), (2,))[2]
    board = m.fe.InProcessBoard()
    board.post("rz/1/leave/1", {"rank": 1, "step": 7, "reason": "m"})
    out["leave"] = _intent(m.fe.vote_resize(board, rank=0, world=2,
                                            lost=(), gen=0, epoch=1,
                                            drain=10, min_world=1))
    out["min_world"] = _threads(lambda r: m.fe.vote_resize(
        m.fe.InProcessBoard(), rank=0, world=2, lost=(1,), gen=0, epoch=1,
        drain=0.2, min_world=2), (0,))
    board = m.fe.InProcessBoard()
    board.post("rz/1/p0/0", {"rank": 0, "survivors": [0, 1], "gen": 0,
                             "coord": None})
    out["leader_silent"] = _threads(lambda r: m.fe.vote_resize(
        board, rank=1, world=2, lost=(), gen=0, epoch=1, drain=0.3,
        min_world=1), (1,))
    out["rescale"] = [m.fe.linear_rescale(4, 3),
                      m.fe._resolve_rescale("none")(4, 2)]
    return out


def _view(m, beat, **per_rank):
    ranks = {}
    for metric, vals in per_rank.items():
        for r, v in enumerate(vals):
            ranks.setdefault(r, {})[metric.replace("__", "::")] = v
    return m.tel.FleetView(ranks, len(ranks), step=beat, gen=0, beat=beat)


def _scale(m, tmp):
    board = m.fe.InProcessBoard()
    up = m.fe.ScalePolicy(board=board, queue_high=8, cooldown=5)
    for beat in (10, 12, 20):
        up.consume(_view(m, beat, serve__queue_depth=[20.0, 12.0]))
    capped = m.fe.ScalePolicy(board=m.fe.InProcessBoard(), queue_high=1,
                              cooldown=0, max_world=2)
    capped.consume(_view(m, 5, serve__queue_depth=[50.0, 50.0]))
    view = _view(m, 30, serve__queue_depth=[0.0] * 4,
                 step_ms_ewma=[5.0, 9.0, 9.0, 2.0])
    noticed = []
    for rank in range(4):
        runner = types.SimpleNamespace(
            board=None, telemetry=None,
            info=types.SimpleNamespace(rank=rank, orig_world=4),
            notice=lambda rank=rank: noticed.append(rank))
        m.fe.ScalePolicy(runner=runner, queue_low=1.0, cooldown=0,
                         min_world=1, max_world=4).consume(view)
    return {"up": [(b, d) for b, d, _ in up.proposals],
            "records": sorted(v["dir"] for v in
                              board.sweep("rz/scale/").values()),
            "capped": capped.proposals,
            "victim": m.fe.ScalePolicy._pick_victim(view),
            "noticed": noticed}


def _peer_preempt(m, tmp):
    """The runner's step seam delivers ``peer_preempt`` (the kill is
    replaced by an exception) at the 3rd step."""
    saved = m.fault._hard_preempt
    m.fault._hard_preempt = lambda: (_ for _ in ()).throw(_Killed())
    try:
        m.fault.inject("peer_preempt", at=3, op="elastic")
        runner = m.fe.ElasticRunner(lambda t, info: 0.5, world=1, rank=0,
                                    ckpt_every=0, telemetry=False,
                                    gen=m.fd.Generation())
        out = _threads(lambda r: runner.run(10), (0,))
        return [out, len(runner.history)]
    finally:
        m.fault._hard_preempt = saved


SCENARIOS = {"shrink": _shrink, "in_place_after_abort": _in_place,
             "drain": _drain, "grow": _grow, "votes": _votes,
             "scale_policy": _scale, "peer_preempt": _peer_preempt}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_elastic_scenario_matches_the_reference(name, tmp_path):
    got = _observe(PORT, SCENARIOS[name], str(tmp_path / "port"))
    want = _observe(JAX, SCENARIOS[name], str(tmp_path / "jax"))
    if name == "grow":
        # the joiner's first beat lands wherever the scheduler puts it:
        # compare the outcome and the counters the steps do not move
        for d in (got, want):
            for k in ("fault::dist::heartbeats",
                      "fault::elastic::checkpoints"):
                d["counters"].pop(k)
            d.pop("events")
            for r in d["out"]:
                if d["out"][r][0] == "ok":
                    d["out"][r][1].pop("history")
    assert got == want


def test_the_scenarios_show_the_resize(tmp_path):
    out = _shrink(PORT, str(tmp_path))
    assert out[2] == ("raise", "_Killed")
    for r in (0, 1):
        rec = out[r][1]
        assert rec["status"][:5] == [True, False, 6, 1, 2]
        assert rec["info"][4] == [0, 1]
        assert rec["info"][5] == pytest.approx(2 / 3)
        post = [h for h in rec["history"] if h[1] == 1]
        assert post[0][0] == 4 and post[0][2] == pytest.approx(
            10.0 * 0.8 ** 5)
    assert out[0][1]["info"][7] == out[1][1]["info"][7] > 0


def test_runner_resumes_from_its_elastic_manifest(tmp_path):
    seen = {}
    runner = tfe.ElasticRunner(lambda t, info: 1.0, world=1, rank=0,
                               ckpt_dir=str(tmp_path), ckpt_every=2,
                               save_fn=lambda path, t: open(path, "w")
                               .write(str(t)),
                               restore_fn=lambda path, info:
                               seen.update(path=path), telemetry=False)
    assert runner.run(5).completed
    again = tfe.ElasticRunner(lambda t, info: 1.0, world=1, rank=0,
                              ckpt_dir=str(tmp_path), ckpt_every=2,
                              restore_fn=lambda path, info:
                              seen.update(path=path), telemetry=False)
    status = again.run(6)
    assert status.completed and again.history[0][0] == 4
    assert seen["path"].endswith("elastic_ckpt.g1")


def test_a_real_resize_on_two_gloo_ranks(tmp_path):
    import jax.numpy as jnp

    import mxnet_tpu as mx
    from mxnet_tpu.models import TransformerLM as JTransformerLM
    from mxnet_tpu.models import tiny_config as j_tiny_config
    from mxnet_tpu.ndarray.ndarray import NDArray

    mx.np.random.seed(0)
    jnet = JTransformerLM(j_tiny_config(**DRYRUN))
    jnet.initialize()
    onp.savez(tmp_path / "init.npz",
              **{k: onp.asarray(p.data()._data)
                 for k, p in jnet.collect_params().items()})
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MXNET_FAULT_CONSENSUS_TIMEOUT="20")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--dir", str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=180)[0].decode(
                errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert procs[1].returncode == -9, logs[1][-3000:]   # peer_preempt
    assert procs[0].returncode == 0, logs[0][-4000:]
    with open(tmp_path / "rank0.json") as f:
        r0 = json.load(f)
    assert r0["imported_jax"] is False
    assert r0["completed"] and r0["resizes"] == 1
    assert r0["world"] == r0["group_world"] == 1 and r0["survivors"] == [0]
    assert r0["lr_scale"] == r0["batch_scale"] == 0.5
    assert r0["counters"]["resizes"] == r0["counters"]["rebootstraps"] == \
        r0["counters"]["restores"] == 1
    assert r0["peer_lost"] == 1
    assert [h[0] for h in r0["history"]] == [0, 1, 2, 3]
    assert [h[1] for h in r0["history"]] == [0, 0, 1, 1]
    # the survivor after the resize == a one-rank restore, bit for bit
    assert len(r0["post"]) == 2 and r0["post"] == r0["solo"]
    # the restored weights' loss on the JAX package's TrainStep
    restored = dict(onp.load(tmp_path / "restored.npz"))
    for k, p in jnet.collect_params().items():
        p.set_data(mx.np.array(restored[k]))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def fwd(net, tokens, labels):
        logits = net.forward(tokens)
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1)).mean()
    jstep = mx.parallel.TrainStep(jnet, None,
                                  mx.optimizer.AdamW(learning_rate=LR / 2),
                                  mesh=None, forward_fn=fwd)
    toks, labels = (NDArray(jnp.asarray(a[:B // 2].astype(onp.int32)))
                    for a in batch(2))
    onp.testing.assert_allclose(r0["post"][0], float(jstep(toks, labels)),
                                rtol=2e-5, atol=1e-6)


def _kv_bootstrap(fd, kvs, monkeypatch):
    """A failed join out of the kvstore stays retryable at the next
    store; a reset forgets a good one."""
    monkeypatch.setattr(kvs, "_dist_initialized", False)
    calls = {"n": 0, "fail": True}

    def fake_init(coordinator_address=None, num_processes=None,
                  process_id=None, **kw):
        calls["n"] += 1
        if calls["fail"]:
            raise fd.BootstrapError("coordinator down")
        return True
    monkeypatch.setattr(fd, "initialize", fake_init)
    out = []
    try:
        kvs._maybe_init_distributed()
    except fd.BootstrapError:
        out.append(("raised", kvs._dist_initialized))
    calls["fail"] = False
    kvs._maybe_init_distributed()
    kvs._maybe_init_distributed()
    out.append((calls["n"], kvs._dist_initialized))
    kvs.reset_distributed()
    out.append(kvs._dist_initialized)
    return out


def test_the_kvstore_join_and_reset_match_the_reference(monkeypatch):
    from mxnet_tpu.kvstore import kvstore as jkvs
    from mxnet_tpu_torch.kvstore import kvstore as tkvs
    monkeypatch.setenv("MX_COORD_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("MX_NUM_WORKERS", "2")
    monkeypatch.setenv("MX_WORKER_ID", "0")
    got = _kv_bootstrap(tfd, tkvs, monkeypatch)
    assert got == _kv_bootstrap(jfd, jkvs, monkeypatch)
    assert got == [("raised", False), (2, True), False]


def test_reset_kvstore_carries_the_store_optimizer_state():
    """``update_on_kvstore``: a reset between two steps rebuilds the
    store and carries its momentum, so the run equals one without the
    reset bit for bit, and the JAX package's to 1e-5."""
    import torch

    import mxnet_tpu as jmx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import load_params

    jmx.np.random.seed(4)
    jnet = jmx.gluon.nn.Dense(3, in_units=4)
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    x = onp.arange(8, dtype=onp.float32).reshape(2, 4) / 8
    y = onp.zeros((2, 3), onp.float32)

    def port(reset):
        net = gluon.nn.Dense(3, in_units=4)
        net.initialize(device="cpu")
        net = load_params(net, params)
        tr = gluon.Trainer(net.collect_params(), "sgd", opt,
                           kvstore="local", update_on_kvstore=True)
        for step in range(3):
            with autograd.record():
                loss = gluon.loss.L2Loss()(net(torch.from_numpy(x)),
                                           torch.from_numpy(y)).mean()
            loss.backward()
            tr.step(1)
            if reset and step == 0:
                kv = tr._kvstore
                tr.reset_kvstore()
                assert tr._kvstore is None
        assert not reset or tr._kvstore is not kv
        return net.weight.detach().numpy()

    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", opt,
                            kvstore="local", update_on_kvstore=True)
    for step in range(3):
        with jmx.autograd.record():
            loss = jmx.gluon.loss.L2Loss()(jnet(jmx.np.array(x)),
                                           jmx.np.array(y)).mean()
        loss.backward()
        jtr.step(1)
        if step == 0:
            jtr.reset_kvstore()
    got = port(True)
    assert onp.array_equal(got, port(False))
    onp.testing.assert_allclose(got, onp.asarray(jnet.weight.data()._data),
                                rtol=1e-5, atol=1e-5)
