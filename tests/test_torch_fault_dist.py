"""The port's coordinated fault layer (``fault_dist``) against the JAX
package's, on the same scripted faults.

The protocol is host Python in both packages, so each scenario below
runs twice, once through ``mxnet_tpu.fault_dist`` and once through
``mxnet_tpu_torch.fault_dist``, with threads as ranks over
``InProcessComm`` endpoints (the reference tests' harness,
``tests/test_fault_dist.py:42``), and the two runs must agree exactly:
each rank's return value or exception type (and ``process_indices``),
the final generations, the call and round counts, the ``fault::dist::*``
counter deltas, and the flight-recorder event kinds (a count per kind:
threads interleave their events in the scheduler's order).  A single-
threaded scenario compares its events in order.

Beyond the threads: the resilient bootstrap against a scripted fake of
each package's process-group call (and one real one-process ``gloo``
bootstrap of the port), the maintenance poller against a stub HTTP
server on 127.0.0.1, and ``FileComm`` / ``FileBoard`` across two
subprocess ranks of the port (this file is their program: ``python
tests/test_torch_fault_dist.py --rank R --dir D``; the rank part runs
before the JAX imports below, so the ranks never import JAX).
"""
import json
import os
import subprocess
import sys
import threading
import time
import types
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the counters every scenario compares (deltas)
COUNTERS = (
    "fault::dist::coordinated_retries", "fault::dist::generation_bumps",
    "fault::dist::gave_up", "fault::dist::vote_rounds",
    "fault::dist::peer_lost", "fault::dist::heartbeats",
    "fault::dist::lease_ops", "fault::dist::lease_activations",
    "fault::dist::lease_revocations", "fault::dist::bootstrap_attempts",
    "fault::dist::bootstrap_retries", "fault::dist::bootstrap_fallbacks",
    "fault::dist::maintenance_events", "fault::retries", "fault::gave_up",
    "fault::injected", "fault::preemptions")
JOIN_S = 30          # every thread and subprocess has its own deadline


def _fast_policy(m, max_retries=3):
    return m.fault.RetryPolicy(max_retries=max_retries, base_delay=0.001,
                               max_delay=0.005, jitter=0.0, timeout=False)


def _filecomm_rank(m, rank, root):
    """One rank of the cross-process check: a FileComm allgather, a
    coordinated call whose first attempt fails at the entry seam on rank
    1, a heartbeat, and a resize vote on a FileBoard."""
    comm = m.fd.FileComm(os.path.join(root, "comm"), rank, 2, poll=0.01,
                         namespace="x")
    seen = comm.allgather({"rank": rank, "hello": True}, timeout=JOIN_S)
    gen = m.fd.Generation()
    calls = [0]

    def fn():
        calls[0] += 1
        if rank == 1 and calls[0] == 1:
            raise m.fault.InjectedFault("entry-seam fault on rank 1")
        return 10 * rank + calls[0]
    out = m.fd.coordinated_call(fn, comm=comm, op="t", gen=gen,
                                policy=_fast_policy(m), timeout=JOIN_S)
    hb = m.fd.Heartbeat(comm=comm, every=1, timeout=JOIN_S)
    votes = hb.beat(step=5)
    board = m.fe.FileBoard(os.path.join(root, "board"), poll=0.01)
    intent = m.fe.vote_resize(board, rank=rank, world=2, lost=(),
                              gen=gen.value, epoch=1, drain=JOIN_S)
    return {"seen": [v["rank"] for v in seen], "out": out,
            "calls": calls[0], "gen": gen.value,
            "beat_steps": [v["step"] for v in votes],
            "rounds": comm._round,
            "intent": [intent.survivors, intent.gen, intent.epoch,
                       intent.new_world, intent.new_rank]}


def _rank_main(rank, out_dir):
    from mxnet_tpu_torch import fault, fault_dist, fault_elastic
    m = types.SimpleNamespace(fault=fault, fd=fault_dist, fe=fault_elastic)
    res = _filecomm_rank(m, rank, out_dir)
    res["imported_jax"] = any(mod.split(".")[0] in ("jax", "jaxlib",
                                                    "mxnet_tpu")
                              for mod in sys.modules)
    with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    _rank_main(int(args["--rank"]), args["--dir"])
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (JAX from here on)
# ----------------------------------------------------------------------
import http.server  # noqa: E402

import pytest  # noqa: E402

from mxnet_tpu import fault as jfault  # noqa: E402
from mxnet_tpu import fault_dist as jfd  # noqa: E402
from mxnet_tpu import fault_elastic as jfe  # noqa: E402
from mxnet_tpu import flightrec as jrec  # noqa: E402
from mxnet_tpu import profiler as jprof  # noqa: E402
from mxnet_tpu_torch import fault as tfault  # noqa: E402
from mxnet_tpu_torch import fault_dist as tfd  # noqa: E402
from mxnet_tpu_torch import fault_elastic as tfe  # noqa: E402
from mxnet_tpu_torch import flightrec as trec  # noqa: E402
from mxnet_tpu_torch import profiler as tprof  # noqa: E402

JAX = types.SimpleNamespace(fault=jfault, fd=jfd, fe=jfe, rec=jrec,
                            prof=jprof, name="jax")
PORT = types.SimpleNamespace(fault=tfault, fd=tfd, fe=tfe, rec=trec,
                             prof=tprof, name="port")


def _reset(m):
    m.fault.clear()
    m.fd.disable_step_lease()
    m.fd.disable_step_heartbeat()
    m.fd.set_default_comm(None)
    m.rec.reset()


@pytest.fixture(autouse=True)
def _clean():
    for m in (JAX, PORT):
        _reset(m)
    yield
    for m in (JAX, PORT):
        _reset(m)


def _norm(value=None, error=None):
    """A rank's outcome, comparable across packages."""
    if error is None:
        return ("ok", value)
    return ("raise", type(error).__name__,
            tuple(getattr(error, "process_indices", ()) or ()))


def _threads(worker, world=2, comms=None):
    """``worker(rank, comm)`` on one thread per rank; each rank's outcome
    (a hung thread fails the test at its deadline)."""
    results, errors = {}, {}

    def go(r):
        try:
            results[r] = worker(r, comms[r] if comms else None)
        except BaseException as e:  # noqa: BLE001 -- compared below
            errors[r] = e

    threads = [threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return {r: _norm(results.get(r), errors.get(r)) for r in range(world)}


def _observe(m, scenario, ordered=False):
    """Run ``scenario(m)``: its result, the counter deltas and the flight
    recorder's event kinds."""
    before = {c: m.prof.get_counter(c) for c in COUNTERS}
    m.rec.reset()
    out = scenario(m)
    kinds = [e["kind"] for e in m.rec.events()]
    return {"out": out,
            "counters": {c: m.prof.get_counter(c) - before[c]
                         for c in COUNTERS},
            "events": kinds if ordered else sorted(Counter(kinds).items())}


# ----------------------------------------------------------------------
# coordinated_call scenarios (threads as ranks)
# ----------------------------------------------------------------------
def _coord(m, fail, world=2, mutating=False, max_retries=3, gens=None,
           timeout=None):
    """Every rank runs ``coordinated_call`` on an op that raises
    ``fail(m, rank, call)`` (when not None) or returns ``rank``."""
    comms = m.fd.InProcessComm.create(world)
    gens = [m.fd.Generation(g) for g in (gens or [0] * world)]
    calls = [0] * world

    def worker(rank, comm):
        def fn():
            calls[rank] += 1
            err = fail(m, rank, calls[rank])
            if err is not None:
                raise err
            return "ok-%d-gen%d" % (rank, gens[rank].value)
        return m.fd.coordinated_call(
            fn, comm=comm, op="t", gen=gens[rank], mutating=mutating,
            policy=_fast_policy(m, max_retries), timeout=timeout)

    outs = _threads(worker, world, comms)
    return {"ranks": outs, "gens": [g.value for g in gens], "calls": calls,
            "rounds": [c._round for c in comms]}


SCENARIOS = {
    "all_ok": lambda m: _coord(m, lambda m, r, c: None),
    "entry_failure_retries_together": lambda m: _coord(
        m, lambda m, r, c: m.fault.InjectedFault("boom")
        if (r, c) == (0, 1) else None),
    "entry_failure_mutating_retries": lambda m: _coord(
        m, lambda m, r, c: m.fault.InjectedFault("boom")
        if c == 1 else None, mutating=True),
    "midop_mutating_aborts_everywhere": lambda m: _coord(
        m, lambda m, r, c: m.fault.TransientError("mid-op")
        if (r, c) == (1, 1) else None, mutating=True),
    "midop_plain_retries": lambda m: _coord(
        m, lambda m, r, c: m.fault.TransientError("mid-op")
        if (r, c) == (1, 1) else None),
    "retry_exhaustion": lambda m: _coord(
        m, lambda m, r, c: m.fault.TransientError("always down")
        if r == 1 else None, max_retries=2),
    "fatal_reraised_abort_elsewhere": lambda m: _coord(
        m, lambda m, r, c: ValueError("shape bug") if r == 0 else None),
    "transient_runtime_error_retries": lambda m: _coord(
        m, lambda m, r, c: m.fault.InjectedXlaError(
            "UNAVAILABLE: connection reset by peer")
        if (r, c) == (0, 1) else None),
    "oom_runtime_error_aborts": lambda m: _coord(
        m, lambda m, r, c: m.fault.InjectedXlaError(
            "RESOURCE_EXHAUSTED: out of memory")
        if (r, c) == (0, 1) else None),
    "three_ranks_split_vote": lambda m: _coord(
        m, lambda m, r, c: m.fault.InjectedFault("boom")
        if (r, c) in ((2, 1), (1, 2)) else None, world=3),
    "generation_mismatch": lambda m: _coord(
        m, lambda m, r, c: None, gens=[1, 0]),
}


def _no_vote_peer_lost(m):
    comm = m.fd.InProcessComm.create(2)[0]
    try:
        m.fd.coordinated_call(lambda: 1, comm=comm, op="t",
                              gen=m.fd.Generation(), timeout=0.2,
                              policy=_fast_policy(m))
    except m.fd.PeerLostError as e:
        return _norm(error=e)
    return "no error"


def _local_comm_mutating(m):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] == 1:
            raise m.fault.InjectedFault("entry")
        if calls[0] == 2:
            raise m.fault.TransientError("mid-op")
        return "never"
    try:
        out = m.fd.coordinated_call(fn, comm=m.fd.LocalComm(), op="t",
                                    mutating=True, policy=_fast_policy(m))
    except m.fault.TransientError as e:
        out = _norm(error=e)
    return {"out": out, "calls": calls[0]}


SINGLE = {"no_vote_peer_lost": _no_vote_peer_lost,
          "local_comm_mutating_keeps_entry_rule": _local_comm_mutating}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_coordinated_call_matches_the_reference(name):
    got, want = (_observe(m, SCENARIOS[name]) for m in (PORT, JAX))
    assert got == want


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_rank_paths_match_the_reference(name):
    got, want = (_observe(m, SINGLE[name], ordered=True)
                 for m in (PORT, JAX))
    assert got == want


def test_scenarios_show_the_protocol():
    """What the parity above holds, stated once on the port's run."""
    s = SCENARIOS["entry_failure_retries_together"](PORT)
    assert s["gens"] == [1, 1] and s["calls"] == [2, 2]
    assert s["ranks"][1] == ("ok", "ok-1-gen1")
    s = SCENARIOS["midop_mutating_aborts_everywhere"](PORT)
    assert [o[1] for o in s["ranks"].values()] == \
        ["CoordinatedAbortError"] * 2 and s["calls"] == [1, 1]
    s = SCENARIOS["fatal_reraised_abort_elsewhere"](PORT)
    assert s["ranks"][0][1] == "ValueError"
    assert s["ranks"][1][1] == "CoordinatedAbortError"
    assert _no_vote_peer_lost(PORT) == ("raise", "PeerLostError", (1,))


# ----------------------------------------------------------------------
# step lease and heartbeat (threads as ranks)
# ----------------------------------------------------------------------
def _lease_world(m, world=2, rearm=1):
    hb_comms = m.fd.InProcessComm.create(world)
    op_comms = m.fd.InProcessComm.create(world)
    gens = [m.fd.Generation() for _ in range(world)]
    hbs = [m.fd.Heartbeat(comm=hb_comms[r], every=1, timeout=5)
           for r in range(world)]
    leases = []
    for r in range(world):
        lease = m.fd.StepLease(heartbeat=hbs[r], gen=gens[r], rearm=rearm)
        hbs[r].lease = lease
        leases.append(lease)
    return hb_comms, op_comms, gens, hbs, leases


def _lease_arm_revoke_rearm(m):
    """Arm (the unanimous first beat), ride the lease with zero per-op
    rounds, fail a covered op on rank 0 (revoke + escalate: both ranks
    abort in one beat round), vote per-op while revoked, re-arm on the
    next clean beat."""
    hb_comms, op_comms, gens, hbs, leases = _lease_world(m)
    calls = [0, 0]
    trace = {0: [], 1: []}

    def worker(rank, _comm):
        t = trace[rank]
        hbs[rank].beat(step=0)
        t.append(leases[rank].state())
        for k in range(3):
            t.append(m.fd.coordinated_call(
                lambda k=k: "ok%d" % k, comm=op_comms[rank], op="op%d" % k,
                gen=gens[rank], policy=_fast_policy(m), lease=leases[rank]))
        t.append(op_comms[rank]._round)
        hbs[rank].beat(step=1)

        def bad():
            calls[rank] += 1
            if rank == 0:
                raise m.fault.TransientError("covered-op failure")
            return "applied"
        try:
            m.fd.coordinated_call(bad, comm=op_comms[rank], op="bad",
                                  gen=gens[rank], policy=_fast_policy(m),
                                  lease=leases[rank])
            hbs[rank].beat(step=2)
        except m.fd.CoordinatedAbortError as e:
            t.append(_norm(error=e))
        t.append(leases[rank].state())
        t.append(m.fd.coordinated_call(
            lambda: "post", comm=op_comms[rank], op="post",
            gen=gens[rank], policy=_fast_policy(m), lease=leases[rank]))
        t.append(op_comms[rank]._round)
        hbs[rank].beat(step=3)
        t.append(leases[rank].state())
        return t

    outs = _threads(worker)
    return {"ranks": outs, "calls": calls, "gens": [g.value for g in gens],
            "hb_rounds": [c._round for c in hb_comms]}


def _lease_mixed_world(m):
    """Rank 0 leases, rank 1 never opted in: the first beat fails fast."""
    comms = m.fd.InProcessComm.create(2)
    hbs = [m.fd.Heartbeat(comm=comms[r], every=1, timeout=5)
           for r in range(2)]
    lease = m.fd.StepLease(heartbeat=hbs[0], gen=m.fd.Generation())
    hbs[0].lease = lease
    outs = _threads(lambda r, _c: hbs[r].beat(step=0) and "beat")
    return {"ranks": outs, "state": lease.state()}


def _heartbeat_rounds(m):
    comms = m.fd.InProcessComm.create(2)

    def worker(rank, comm):
        hb = m.fd.Heartbeat(comm=comm, every=2, timeout=5)
        beats = [hb.beat(step=s) is not None for s in range(4)]
        return beats, sorted((r, s) for r, (s, _) in hb.peers.items())
    return _threads(worker, comms=comms)


def _heartbeat_peer_hang(m):
    """``peer_hang`` on rank 1: its peer's beat raises PeerLostError
    naming it (the registry is process-wide, so the victim arms the
    fault itself, then lets rank 0 beat)."""
    hung = threading.Event()

    def worker(rank, comm):
        hb = m.fd.Heartbeat(comm=comm, every=1, timeout=0.3)
        if rank == 0:
            assert hung.wait(5)
            time.sleep(0.1)
            return hb.beat(step=0)
        m.fault.inject("peer_hang", at=1)
        hung.set()
        return len(hb.beat(step=0))
    outs = _threads(worker, comms=m.fd.InProcessComm.create(2))
    return {"ranks": outs, "stats": m.fault.stats()}


def _escalation_without_heartbeat(m):
    lease = m.fd.StepLease(heartbeat=None, gen=m.fd.Generation())
    lease._s["state"] = "active"
    try:
        m.fd.coordinated_call(
            lambda: (_ for _ in ()).throw(m.fault.TransientError("x")),
            comm=m.fd.InProcessComm.create(2)[0], op="t", lease=lease)
    except m.fd.CoordinatedAbortError as e:
        return [_norm(error=e), lease.state()]
    return "no error"


LEASE = {"lease_arm_revoke_escalate_rearm": _lease_arm_revoke_rearm,
         "lease_mixed_world_fails_fast": _lease_mixed_world,
         "heartbeat_every_two": _heartbeat_rounds,
         "heartbeat_peer_hang_is_peer_lost": _heartbeat_peer_hang,
         "lease_escalation_without_heartbeat":
             _escalation_without_heartbeat}


@pytest.mark.parametrize("name", sorted(LEASE))
def test_lease_and_heartbeat_match_the_reference(name):
    got, want = (_observe(m, LEASE[name]) for m in (PORT, JAX))
    assert got == want


def test_lease_success_path_pays_no_per_op_round():
    out = _lease_arm_revoke_rearm(PORT)
    for rank in (0, 1):
        t = out["ranks"][rank][1]
        assert t[0] == "active" and t[1:4] == ["ok0", "ok1", "ok2"]
        assert t[4] == 0                       # no per-op vote round
        assert t[5][1] == "CoordinatedAbortError"
        assert t[6] == "revoked" and t[7] == "post" and t[8] == 1
        assert t[9] == "active"                # re-armed
    assert out["calls"] == [1, 1] and out["gens"] == [1, 1]


def test_step_heartbeat_enable_disable_and_the_dist_context():
    for m in (PORT, JAX):
        comm = types.SimpleNamespace(rank=0, world=1, _round=0,
                                     allgather=lambda p, timeout=None: [p])
        hb = m.fd.enable_step_heartbeat(comm=comm, every=1, timeout=1)
        assert m.fault._DIST_HEARTBEAT is hb
        lease = m.fd.enable_step_lease()
        assert m.fd.step_lease() is lease and hb.lease is lease
        hb.beat(step=0)
        got = m.fd._flightrec_dist_context()
        m.fd.disable_step_heartbeat()
        assert m.fault._DIST_HEARTBEAT is None and m.fd.step_lease() is None
        assert got["lease_state"] == "active"
        if m is PORT:
            port_ctx = got
        else:
            assert port_ctx == got
        with pytest.raises(ValueError, match="every=1"):
            m.fd.enable_step_lease(heartbeat=m.fd.Heartbeat(comm=comm,
                                                            every=2))


def test_trainer_step_beats_the_installed_heartbeat():
    from mxnet_tpu_torch.gluon import Trainer, nn
    import torch
    beats = []
    comm = types.SimpleNamespace(
        rank=0, world=1, _round=0,
        allgather=lambda p, timeout=None: beats.append(p["step"]) or [p])
    tfd.enable_step_heartbeat(comm=comm, every=1, timeout=1)
    net = nn.Dense(2, in_units=3)
    net.initialize(device="cpu")
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    for _ in range(3):
        net(torch.ones(1, 3)).sum().backward()
        tr.step(1)
    assert beats == [0, 1, 2]


# ----------------------------------------------------------------------
# resilient bootstrap (a scripted fake of each package's group call)
# ----------------------------------------------------------------------
@pytest.fixture()
def fake_init(monkeypatch):
    """Each package's process-group call replaced by one fake that raises
    the scripted errors in turn."""
    import jax
    import torch.distributed as dist
    script = {"n": 0, "raise": []}

    def fake(*args, **kwargs):
        script["n"] += 1
        if script["raise"]:
            raise script["raise"].pop(0)
    monkeypatch.setattr(jax.distributed, "initialize", fake)
    monkeypatch.setattr(dist, "init_process_group", fake)
    monkeypatch.setattr(tfd, "_make_store", lambda *a: None)
    return script


BOOT = {
    "injected_then_ok": ("dist_bootstrap_fail", [], {}),
    "unreachable_then_ok": (None, [
        RuntimeError("DEADLINE_EXCEEDED: coordinator unreachable"),
        ConnectionError("refused")], {}),
    "bare_oserror_escapes_the_default_retry_on": (
        None, [OSError("name not resolved")], {}),
    "exhausted_raises": (None, [RuntimeError("Connection refused")] * 4,
                         {}),
    "exhausted_degrades": (None, [RuntimeError("Connection refused")] * 4,
                           {"fallback": True}),
    "config_error_never_degrades": (None, [RuntimeError("bad config")] * 4,
                                    {"fallback": True}),
}


@pytest.mark.parametrize("name", sorted(BOOT))
def test_bootstrap_matches_the_reference(name, fake_init):
    kind, errors, kw = BOOT[name]

    def run(m):
        fake_init["n"] = 0
        fake_init["raise"] = list(errors)
        if kind:
            m.fault.inject(kind, at=1)
        try:
            out = ("ok", m.fd.initialize("127.0.0.1:1", 2, 0,
                                         policy=_fast_policy(m), **kw))
        except Exception as e:  # noqa: BLE001 -- compared across packages
            out = _norm(error=e) + (type(e.__cause__).__name__,)
        return {"out": out, "calls": fake_init["n"]}
    got, want = (_observe(m, run, ordered=True) for m in (PORT, JAX))
    assert got == want


def test_a_real_one_process_bootstrap(tmp_path):
    import torch.distributed as dist
    assert tfd.initialize("file://%s" % (tmp_path / "store"), 1, 0,
                          backend="gloo", timeout=30) is True
    try:
        assert dist.get_world_size() == 1
        assert isinstance(tfd.default_comm(), tfd.LocalComm)
        assert tfd._coord_client() is not None
        assert tfd.initialize("file://%s" % (tmp_path / "other"), 1, 0)
    finally:
        dist.destroy_process_group()
    assert tfd._coord_client() is None


def test_the_store_comm_votes_and_names_a_silent_rank(tmp_path):
    """``CoordServiceComm`` over a ``FileStore``: two endpoints (threads)
    complete rounds and delete their own old keys; a silent rank is
    named by a ``PeerLostError``, and completes its round late."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "fs"), 2)
    comms = [tfd.CoordServiceComm(client=store, rank=r, world=2,
                                  namespace="t") for r in range(2)]
    outs = _threads(lambda r, c: [c.allgather({"r": r, "i": i}, timeout=10)
                                  for i in range(3)], comms=comms)
    assert outs[0] == outs[1]
    assert outs[0][1][2] == [{"r": 0, "i": 2}, {"r": 1, "i": 2}]
    assert not store.check([comms[0]._key(0, 0)])      # GC'd
    with pytest.raises(tfd.PeerLostError) as ei:
        comms[0].allgather({"r": 0}, timeout=0.2)
    assert ei.value.process_indices == (1,)
    late = tprof.get_counter("fault::dist::late_rounds")
    assert comms[1].allgather({"r": 1}, timeout=0.2) == [{"r": 0}, {"r": 1}]
    assert tprof.get_counter("fault::dist::late_rounds") == late


# ----------------------------------------------------------------------
# maintenance notices (a stub metadata server on 127.0.0.1)
# ----------------------------------------------------------------------
class _MetaHandler(http.server.BaseHTTPRequestHandler):
    value = "NONE"

    def do_GET(self):
        assert self.headers.get("Metadata-Flavor") == "Google"
        body = type(self).value.encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture()
def meta_server():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _MetaHandler)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    _MetaHandler.value = "NONE"
    yield "http://127.0.0.1:%d/maintenance-event" % srv.server_port
    srv.shutdown()
    th.join(timeout=5)


def test_maintenance_poller_matches_the_reference(meta_server):
    def run(m):
        events = []
        poller = m.fd.MaintenancePoller(url=meta_server, interval=0.01,
                                        on_event=events.append,
                                        http_timeout=2.0)
        seq = []
        for value in ("NONE", "TERMINATE_ON_HOST_MAINTENANCE",
                      "TERMINATE_ON_HOST_MAINTENANCE", "NONE",
                      "MIGRATE_ON_HOST_MAINTENANCE", "SOMETHING_ELSE"):
            _MetaHandler.value = value
            seq.append((poller.tick(), poller.pending()))
        m.fault.inject("maintenance_event", at=1)
        dead = m.fd.MaintenancePoller(url="http://127.0.0.1:9/x",
                                      on_event=events.append,
                                      http_timeout=0.5)
        seq.append((dead.tick(), dead.tick()))
        return {"seq": seq, "events": events, "n": poller.events}
    got, want = (_observe(m, run, ordered=True) for m in (PORT, JAX))
    assert got == want
    assert got["counters"]["fault::dist::maintenance_events"] == 3


def test_maintenance_poller_thread_fires_the_preemption_autosave(
        meta_server, tmp_path):
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(2, in_units=3)
    net.initialize(device="cpu")
    handler = tfault.on_preemption(str(tmp_path), net=net,
                                   exit_on_signal=False)
    try:
        poller = tfd.watch_maintenance(url=meta_server, interval=0.02)
        try:
            _MetaHandler.value = "TERMINATE_ON_HOST_MAINTENANCE"
            deadline = time.monotonic() + 10
            while handler.fired == 0 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            poller.stop()
        assert handler.fired == 1
        manifest = tfault.load_snapshot(str(tmp_path))
        assert manifest["reason"] == \
            "maintenance:TERMINATE_ON_HOST_MAINTENANCE"
    finally:
        handler.uninstall()


# ----------------------------------------------------------------------
# FileComm / FileBoard across processes
# ----------------------------------------------------------------------
def test_filecomm_and_fileboard_across_two_jax_free_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--dir", str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0].decode(
                errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, log[-4000:])
    ranks = []
    for r in range(2):
        with open(tmp_path / ("rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    assert [r.pop("imported_jax") for r in ranks] == [False, False]
    # the JAX package's protocol on the same files, in threads
    ref_dir = tmp_path / "jax"
    want = _threads(lambda r, _c: _filecomm_rank(JAX, r, str(ref_dir)))
    assert [want[r][0] for r in range(2)] == ["ok", "ok"]
    assert ranks == [json.loads(json.dumps(want[r][1])) for r in range(2)]
    assert ranks[1]["out"] == 12 and ranks[0]["gen"] == 1
    assert ranks[0]["intent"] == [[0, 1], 2, 1, 2, 0]
