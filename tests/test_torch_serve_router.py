"""The port's ``serve_router.ReplicaGroup`` (tiny float32 models).

Counterparts of the 13 tests of ``tests/test_serve_router.py`` on the
port's ``Server``:

* **Failover is exactly-once and bitwise**: killing a replica's engine
  mid-decode (``serve_engine_kill``) re-runs its in-flight requests on a
  healthy replica; the pinned seeds make the tokens equal a fault-free
  control run's, and the delivery ledger holds each gid once.
* **Deadlines cancel through the scheduler** (pages and refcounts
  released) and surface as ``DeadlineExceededError``.
* **Overload sheds** by priority on the router's backlog and the
  replicas' ``slo_snapshot()`` p99 (``MXNET_SERVE_QUEUE_LIMIT``,
  ``MXNET_SERVE_SLO_TARGET_MS``), with a typed ``OverloadedError``.
* **The elastic drain keeps prefix-shared pages honest.**

One greedy case is held against the JAX package's ``ReplicaGroup`` on
the same weights.
"""
import threading
import time
import types

import numpy as onp
import pytest

import torch

import mxnet_tpu as mx
from mxnet_tpu import serve as jserve
from mxnet_tpu import serve_router as jserve_router
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu_torch import fault, serve, serve_router
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config
from mxnet_tpu_torch.serve import DeadlineExceededError, OverloadedError
from mxnet_tpu_torch.serve_router import ReplicaGroup


def _net(cfg=None, seed=0):
    cfg = cfg or tiny_config()
    net = TransformerLM(cfg, device="cpu")
    net.initialize(torch.Generator().manual_seed(seed), std=0.1)
    return cfg, net


def _scfg(**kw):
    base = dict(slots=3, page_size=8, pages=24, ladder=(16, 32),
                max_new=10, int8=False)
    base.update(kw)
    return serve.ServeConfig(**base)


def _unstarted_group(n_servers=1, **kw):
    """A router over engine-less replicas: submits queue in the
    scheduler and stay router-inflight forever — the backlog is fully
    under test control (shed/dedupe/timeout paths, no decode)."""
    _, net = _net()
    servers = [serve.Server(net, serve_cfg=_scfg())
               for _ in range(n_servers)]
    return ReplicaGroup(servers, threaded=False, **kw)


# ----------------------------------------------------------------------
# failover: exactly-once, bitwise vs fault-free control
# ----------------------------------------------------------------------
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failover_exactly_once_and_tokens_match_control():
    """Kill one of two replicas with both provably loaded; every
    request completes, the ledger has no double delivery, and the
    tokens are bitwise what a single fault-free replica produces
    (pinned seeds make the replay identical)."""
    cfg, net = _net()
    rng = onp.random.RandomState(20)
    prompts = [list(rng.randint(1, cfg.vocab_size,
                                int(rng.randint(3, 12))))
               for _ in range(6)]
    budgets = [6 + (i % 3) * 2 for i in range(6)]
    sampling = {"temperature": 0.8, "top_k": 20}

    # fault-free control: ONE replica, same pinned seeds (gid = index
    # because the router numbers submits in order)
    control = {}
    with ReplicaGroup.build(net, serve_cfg=_scfg(), replicas=1) as g:
        gids = [g.submit(p, max_new=m, sampling=dict(sampling))
                for p, m in zip(prompts, budgets)]
        for gid in gids:
            rec = g.result(gid, timeout=120)
            assert rec["state"] == "done"
            control[gid] = rec["tokens"]

    fault.clear()
    group = ReplicaGroup.build(net, serve_cfg=_scfg(), replicas=2)
    try:
        with group:
            gids = [group.submit(p, max_new=m, sampling=dict(sampling))
                    for p, m in zip(prompts, budgets)]
            # arm the kill only once BOTH replicas hold router-side
            # in-flight work, so whichever engine steps next dies loaded
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                live = {r["replica"]
                        for r in group.requests().values()
                        if r["state"] == "inflight"}
                if {0, 1} <= live:
                    break
                if all(r["state"] in serve_router.TERMINAL
                       for r in group.requests().values()):
                    break       # tiny model outran us: still a pass
                time.sleep(0.005)
            fault.inject("serve_engine_kill", at=1, seed=0)
            got = {}
            for gid in gids:
                rec = group.result(gid, timeout=120)
                assert rec["state"] == "done"
                got[gid] = rec["tokens"]
    finally:
        fault.clear()

    assert got == control               # bitwise, every request
    ledger = group.delivery_log()
    assert len(set(g for g, _a in ledger)) == len(ledger)  # no dupes
    assert sorted(g for g, _a in ledger) == sorted(gids)   # no holes
    stats = group.stats()
    if stats["dead"]:                   # the kill landed mid-flight
        assert stats["failovers"] >= 1
    for srv in group.servers:
        assert srv.sched.check_conservation() == []


def test_dedupe_store_drops_late_echo_and_tombstones():
    """The exactly-once mechanism in isolation: a second terminal
    delivery for a gid is dropped (late echo of a presumed-dead
    replica), and after the client collects, the tombstone keeps even
    post-eviction echoes out of the ledger."""
    group = _unstarted_group()
    gid = group.submit([1, 2, 3], max_new=4)
    assert group._deliver(gid, 1, {"state": "done",
                                   "tokens": (7, 8)}) is True
    # the duplicate: same gid, later attempt, conflicting payload
    assert group._deliver(gid, 2, {"state": "done",
                                   "tokens": (9, 9)}) is False
    rec = group.result(gid, timeout=1)
    assert rec["tokens"] == (7, 8)      # first delivery won, intact
    # post-collection echo: the reqs entry is gone, the tombstone holds
    assert group._deliver(gid, 3, {"state": "done",
                                   "tokens": (0,)}) is False
    assert group.delivery_log() == ((gid, 1),)
    assert group.stats()["dup_drops"] == 2


def test_router_result_timeout_is_final_and_typed():
    group = _unstarted_group()
    gid = group.submit([1, 2, 3], max_new=4)
    with pytest.raises(TimeoutError):
        group.result(gid, timeout=0.05)
    # unknown gid: None, not an exception
    assert group.result(10**9) is None


# ----------------------------------------------------------------------
# deadlines: typed error, pages + refcounts released
# ----------------------------------------------------------------------
def test_deadline_expiry_releases_pages_and_raises_typed():
    """A storm of impossible deadlines: every request is cancelled
    THROUGH the scheduler by the engine sweep — result() raises the
    typed error and the page/refcount audits come back clean (nothing
    expired while still pinning pool pages or radix refcounts)."""
    cfg, net = _net()
    rng = onp.random.RandomState(21)
    srv = serve.Server(net, _scfg(max_new=48))
    shared = list(rng.randint(1, cfg.vocab_size, 8))
    with srv:
        # a mix: shared-prefix prompts (radix refcounts in play) with
        # 1ms budgets, plus one request allowed to finish normally
        doomed = [srv.submit(shared + [i + 1], max_new=40,
                             deadline=0.001) for i in range(4)]
        ok = srv.submit(shared, max_new=2)
        for rid in doomed:
            with pytest.raises(DeadlineExceededError):
                srv.result(rid, timeout=60)
        assert srv.result(ok, timeout=60)["state"] == "done"
    assert srv.sched.check_conservation() == []
    assert srv.sched.check_refcounts() == []
    assert srv.sched.stats()["requests"] == 0   # all purged
    from mxnet_tpu_torch import profiler
    assert profiler.get_counter("serve::deadline_exceeded") >= 4


def test_router_deadline_surfaces_typed_error():
    """Router-level deadline: expiry inside the replica surfaces as
    the same typed error at group.result(), and an already-expired
    deadline never even dispatches."""
    cfg, net = _net()
    with ReplicaGroup.build(net, serve_cfg=_scfg(max_new=48),
                            replicas=1) as group:
        gid = group.submit([3, 1, 4, 1, 5], max_new=40,
                           deadline=0.001)
        with pytest.raises(DeadlineExceededError):
            group.result(gid, timeout=60)
    # pre-expired at dispatch time: delivered as deadline, no submit
    group2 = _unstarted_group()
    gid2 = group2.submit([1, 2], max_new=4, deadline=-1.0)
    with pytest.raises(DeadlineExceededError):
        group2.result(gid2, timeout=1)


def test_server_default_deadline_env_knob(monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_DEADLINE_MS", "250")
    cfg = serve.ServeConfig(slots=2, page_size=8, pages=16,
                            ladder=(16,), max_new=4)
    assert cfg.deadline_ms == 250
    assert cfg.default_deadline() == 0.25


# ----------------------------------------------------------------------
# overload shedding: bounded queue, priority classes, SLO feed
# ----------------------------------------------------------------------
def test_shed_policy_priorities_and_saturation():
    """queue_limit=2: normal sheds at the bound while high still
    admits; at twice the bound even high sheds ("hard").  Errors are
    typed and counted."""
    group = _unstarted_group(queue_limit=2)
    group.submit([1, 2], max_new=4)             # backlog 0 -> 1
    group.submit([1, 2], max_new=4)             # backlog 1 -> 2
    with pytest.raises(OverloadedError, match="full"):
        group.submit([1, 2], max_new=4)         # normal at the bound
    with pytest.raises(OverloadedError, match="full"):
        group.submit([1, 2], max_new=4, priority="low")
    group.submit([1, 2], max_new=4, priority="high")   # 2 -> 3
    group.submit([1, 2], max_new=4, priority="high")   # 3 -> 4
    with pytest.raises(OverloadedError, match="hard"):
        group.submit([1, 2], max_new=4, priority="high")  # saturated
    assert group.stats()["sheds"] == 3
    assert isinstance(OverloadedError("x"), RuntimeError)  # typed


def test_shed_low_priority_early_on_slo_breach():
    """The SLO feed: with the worst replica p99 over target, ``low``
    sheds at HALF the queue bound — best-effort traffic yields first
    while normal/high still admit."""
    group = _unstarted_group(queue_limit=4, slo_target_ms=10.0)
    group._worst_p99_ms = lambda: 250.0     # replica histograms say: slow
    group.submit([1, 2], max_new=4)         # backlog 1 still admits low?
    group.submit([1, 2], max_new=4)         # backlog -> 2 == limit//2
    with pytest.raises(OverloadedError, match="slo"):
        group.submit([1, 2], max_new=4, priority="low")
    # healthy p99: low admits again at the same backlog
    group._worst_p99_ms = lambda: 1.0
    group.submit([1, 2], max_new=4, priority="low")    # backlog -> 3
    # back over target: normal and high are untouched below the bound
    group._worst_p99_ms = lambda: 250.0
    group.submit([1, 2], max_new=4)                    # normal: fine
    group.submit([1, 2], max_new=4, priority="high")   # high: fine
    assert group.stats()["sheds"] == 1


def test_shed_off_by_default_and_env_knob(monkeypatch):
    group = _unstarted_group()              # queue_limit 0 = unbounded
    for _ in range(16):
        group.submit([1, 2], max_new=4)
    assert group.stats()["sheds"] == 0
    monkeypatch.setenv("MXNET_SERVE_QUEUE_LIMIT", "3")
    monkeypatch.setenv("MXNET_SERVE_SLO_TARGET_MS", "7.5")
    g2 = _unstarted_group()
    assert g2.queue_limit == 3 and g2.slo_target_ms == 7.5
    with pytest.raises(ValueError, match="unknown priority"):
        g2.submit([1], max_new=1, priority="urgent")


# ----------------------------------------------------------------------
# Server.result(timeout=): cancel-and-evict semantics
# ----------------------------------------------------------------------
def test_server_result_timeout_cancels_and_evicts():
    """A caller that gives up OWNS the give-up: the timed-out request
    is cancelled through the scheduler (pages released), its Server
    record evicted (a later result() returns None — not a hang, not a
    stale answer), and generate(timeout=) behaves identically."""
    cfg, net = _net()
    srv = serve.Server(net, _scfg())        # engine never started:
    rid = srv.submit([1, 2, 3], max_new=4)  # guaranteed to time out
    with pytest.raises(TimeoutError, match="cancelled and evicted"):
        srv.result(rid, timeout=0.05)
    assert srv.sched.request(rid) is None   # purged from the scheduler
    assert srv.sched.check_conservation() == []
    assert srv.result(rid, timeout=0.05) is None   # evicted, final
    with srv._lock:
        assert rid not in srv._live and rid not in srv._done
        assert rid not in srv._prompts and rid not in srv._deadlines
    with pytest.raises(TimeoutError):
        srv.generate([4, 5, 6], max_new=4, timeout=0.05)
    assert srv.sched.stats()["requests"] == 0
    # the eviction must not break a live engine: start it and serve
    with srv:
        assert srv.generate([7, 8], max_new=3,
                            timeout=120)["state"] == "done"
    assert srv.sched.check_conservation() == []


# ----------------------------------------------------------------------
# elastic drain x prefix cache (the resize interaction)
# ----------------------------------------------------------------------
def test_elastic_drain_with_shared_prefix_pages_no_cross_delivery():
    """Satellite proof for the resize x radix-cache interaction: drain
    every slot mid-decode (attach_elastic's on_resize seam) while the
    in-flight requests SHARE prefix-cached pages, here through a
    ReplicaGroup of one replica.  Refcounts and page
    conservation must hold through the drain, and — the cross-delivery
    check — every request's tokens must still equal its own fault-free
    control run (pinned seeds; a swapped slot or leaked page would
    break the bitwise match)."""
    cfg, net = _net()
    rng = onp.random.RandomState(22)
    shared = list(rng.randint(1, cfg.vocab_size, 8))
    prompts = [shared + list(rng.randint(1, cfg.vocab_size, 2 + i))
               for i in range(5)]
    budgets = [8, 6, 8, 6, 8]
    samp = [{"temperature": 0.9, "top_k": 16, "seed": 100 + i}
            for i in range(5)]

    def scfg():
        return _scfg(slots=3, page_size=4, pages=30, ladder=(16, 32),
                     max_new=10, prefix_cache=True)

    # fault-free control, same seeds, no drain
    control = []
    with serve.Server(net, scfg()) as srv:
        rids = [srv.submit(p, max_new=m, sampling=dict(s))
                for p, m, s in zip(prompts, budgets, samp)]
        control = [srv.result(r, timeout=120)["tokens"] for r in rids]
    assert srv.sched.check_refcounts() == []

    group = ReplicaGroup([serve.Server(net, scfg())])
    srv = group.servers[0]
    runner = types.SimpleNamespace(on_resize=None)
    srv.attach_elastic(runner)
    with group:
        gids = [group.submit(p, max_new=m, sampling=dict(s))
                for p, m, s in zip(prompts, budgets, samp)]
        # wait for real decode load (slots occupied, prefixes shared)
        deadline = time.monotonic() + 30
        while (srv.sched.stats()["running"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.002)
        runner.on_resize(types.SimpleNamespace(gen=3, world=2))
        mid_refs = srv.sched.check_refcounts()       # audited AT the
        mid_cons = srv.sched.check_conservation()    # drained instant
        res = [group.result(g, timeout=120) for g in gids]
    assert mid_refs == [] and mid_cons == []
    assert all(r["state"] == "done" for r in res)
    # no cross-delivery: each request's tokens are ITS control tokens
    assert [r["tokens"] for r in res] == control
    assert srv.sched.check_conservation() == []
    assert srv.sched.check_refcounts() == []
    assert srv.sched.stats()["requests"] == 0


# ----------------------------------------------------------------------
# router lifecycle / dispatch edges
# ----------------------------------------------------------------------
def test_router_rejects_bad_requests_and_closed_group():
    group = _unstarted_group()
    # ladder overflow is malformed for EVERY replica: the request goes
    # terminal-failed (not a replica death — nobody is declared dead)
    bad = group.submit(list(range(99)), max_new=4)
    rec = group.result(bad, timeout=1)
    assert rec["state"] == "failed" and "ladder" in rec["error"]
    gid = group.submit([1, 2], max_new=4)
    group.close()
    with pytest.raises(RuntimeError, match="closed"):
        group.submit([1, 2], max_new=4)
    assert group.stats()["dead"] == ()  # close is not a death


def test_router_balances_dispatch_across_replicas():
    group = _unstarted_group(n_servers=2)
    for _ in range(4):
        group.submit([1, 2, 3], max_new=4)
    by_replica = {}
    for r in group.requests().values():
        by_replica[r["replica"]] = by_replica.get(r["replica"], 0) + 1
    assert by_replica == {0: 2, 1: 2}   # least-loaded, ties by index


# ----------------------------------------------------------------------
# against the JAX package's router
# ----------------------------------------------------------------------
def test_router_greedy_tokens_equal_the_reference_router():
    mx.np.random.seed(4)
    jnet = JTransformerLM(j_tiny_config())
    jnet.initialize(mx.init.Normal(0.2))
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(), device="cpu"), params)
    rng = onp.random.RandomState(23)
    prompts = [list(rng.randint(1, 256, int(rng.randint(3, 12))))
               for _ in range(4)]
    cfg = dict(slots=2, page_size=8, pages=24, ladder=(16,), max_new=6,
               prefix_cache=False, int8=False)
    out = {}
    for name, mod, net, scfg in (
            ("jax", jserve_router, jnet,
             jserve.ServeConfig(cache_dir=None, **cfg)),
            ("torch", serve_router, tnet, serve.ServeConfig(**cfg))):
        with mod.ReplicaGroup.build(net, serve_cfg=scfg,
                                    replicas=1) as group:
            gids = [group.submit(p, max_new=5) for p in prompts]
            out[name] = [list(group.result(g, timeout=120)["tokens"])
                         for g in gids]
            assert sorted(group.delivery_log()) == [(g, 1) for g in gids]
    assert out["torch"] == out["jax"]
