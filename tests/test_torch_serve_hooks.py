"""The serving hooks of the port's ``Server`` (tiny float32 model).

Against the JAX package's ``Server``, on the same weights and requests,
with the engine pumped by hand (``engine_step``) so both run the same
scheduler transactions in the same order: the ``serve::*`` counters,
the flight recorder's event kinds, in order, and the greedy tokens with
the telemetry gauges and an elastic runner attached.  Within the port:
``slo_snapshot`` counts, a transient ``serve_decode_fail`` replays the
step (tokens bit for bit the fault-free run's), the fatal flavour kills
the engine and ``result`` re-raises, ``attach_elastic`` drains on a
resize (``tests/test_serve.py:798``) also with shared prefix pages
(``tests/test_serve_router.py:303``), deadlines and engine deaths land
in the flight recorder.
"""
import time
import types

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import fault as jfault
from mxnet_tpu import flightrec as jflightrec
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import serve as jserve
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu_torch import fault, flightrec, profiler, serve, telemetry
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config

SCFG = dict(slots=3, page_size=8, pages=24, ladder=(16,), max_new=10,
            prefix_cache=False)


def _nets(seed=1):
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config())
    jnet.initialize(mx.init.Normal(0.2))
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    return jnet, load_params(TransformerLM(tiny_config(), device="cpu"),
                             params)


def _tnet(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TransformerLM(tiny_config(), device="cpu").initialize(gen,
                                                                 std=0.1)


def _prompts(n=5, seed=20):
    rs = onp.random.RandomState(seed)
    return [list(rs.randint(1, 256, int(rs.randint(3, 14))))
            for _ in range(n)]


@pytest.fixture(autouse=True)
def _clean():
    for f in (fault, jfault):
        f.clear()
    yield
    for f in (fault, jfault):
        f.clear()


def _pumped(srv, prompts, budgets, rec, prof, tel_mod):
    """Submit everything, pump ``engine_step`` until idle: (tokens,
    serve:: counters, event kinds in order, SLO counts)."""
    rec.reset()
    prof.reset()
    tel_mod_sess = tel_mod.TelemetrySession()
    srv.attach_telemetry(tel_mod_sess)
    srv.attach_elastic(types.SimpleNamespace(on_resize=None))
    rids = [srv.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
    while srv.engine_step():
        pass
    toks = [list(srv.result(r, timeout=1)["tokens"]) for r in rids]
    counters = {k: v for k, v in prof.get_counters().items()
                if k.startswith("serve::")}
    kinds = [e["kind"] for e in rec.events()]
    gauges = {k: v for k, v in tel_mod_sess.payload()["full"].items()
              if k.startswith("serve::")}
    snap = srv.slo_snapshot()
    return toks, counters, kinds, gauges, (
        snap["latency_ms"]["count"], snap["ttft_ms"]["count"],
        snap["queued_ms"]["count"], snap["tokens"])


@pytest.fixture(scope="module")
def reference():
    """One JAX server run (the module's only one) and the port's."""
    jnet, tnet = _nets()
    prompts, budgets = _prompts(), [6, 4, 7, 5, 3]
    jsrv = jserve.Server(jnet, jserve.ServeConfig(
        cache_dir=None, int8=False, **SCFG))
    from mxnet_tpu import telemetry as jtelemetry
    want = _pumped(jsrv, prompts, budgets, jflightrec, jprofiler,
                   jtelemetry)
    got = _pumped(serve.Server(tnet, serve.ServeConfig(**SCFG)), prompts,
                  budgets, flightrec, profiler, telemetry)
    return got, want, budgets


def test_hooked_greedy_tokens_equal_the_reference(reference):
    got, want, budgets = reference
    assert got[0] == want[0]
    assert [len(t) for t in got[0]] == budgets


def test_serve_counters_equal_the_reference(reference):
    got, want, _ = reference
    assert got[1] == want[1]
    assert got[1]["serve::submitted"] == 5 == got[1]["serve::finished"]


def test_flight_recorder_kinds_equal_the_reference(reference):
    got, want, _ = reference
    assert got[2] == want[2]
    assert {"sched.submit", "sched.admit", "sched.begin", "sched.commit",
            "sched.commit_prefill"} <= set(got[2])


def test_gauges_and_slo_counts_match_the_requests(reference):
    got, want, budgets = reference
    # the payload: the serve:: counters and the three gauges
    assert got[3] == want[3]
    assert {k: got[3][k] for k in ("serve::queue_depth", "serve::running",
                                   "serve::free_pages")} == {
        "serve::queue_depth": 0, "serve::running": 0,
        "serve::free_pages": 23}
    assert got[4] == want[4] == (5, 5, 5, sum(budgets))


# ----------------------------------------------------------------------
# faults on the decode commit and the engine
# ----------------------------------------------------------------------
def _serve(srv, prompts, max_new=8):
    with srv:
        rids = [srv.submit(p, max_new=max_new) for p in prompts]
        return [list(srv.result(r, timeout=120)["tokens"]) for r in rids]


@pytest.mark.parametrize("at", [1, 4])
def test_transient_decode_fault_replays_the_step_bitwise(at):
    net = _tnet()
    prompts = _prompts(4, seed=3)
    want = _serve(serve.Server(net, serve.ServeConfig(**SCFG)), prompts)
    before = profiler.get_counter("serve::decode_retries")
    fault.inject("serve_decode_fail", at=at)
    srv = serve.Server(net, serve.ServeConfig(**SCFG))
    assert _serve(srv, prompts) == want
    assert profiler.get_counter("serve::decode_retries") - before == 1
    assert fault.stats() == {"serve_decode_fail": 1}
    assert "serve.decode_retry" in {e["kind"] for e in flightrec.events()}
    assert srv.sched.check_conservation() == []


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_fatal_decode_fault_kills_the_engine_and_result_reraises():
    srv = serve.Server(_tnet(), serve.ServeConfig(**SCFG))
    fault.inject("serve_decode_fail", at=2, op="fatal")
    flightrec.reset()
    with srv:
        rid = srv.submit([1, 2, 3], max_new=8)
        with pytest.raises(RuntimeError, match="died") as info:
            srv.result(rid, timeout=60)
        assert "RESOURCE_EXHAUSTED" in str(info.value.__cause__)
        with pytest.raises(RuntimeError, match="died"):
            srv.submit([4, 5], max_new=2)
    terminal = [e for e in flightrec.events() if e["kind"] == "terminal"]
    assert terminal and terminal[-1]["reason"] == "serve_engine" \
        and terminal[-1]["error"] == "XlaRuntimeError"


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_engine_kill_is_the_engine_check_at_the_top_of_a_step():
    srv = serve.Server(_tnet(), serve.ServeConfig(**SCFG))
    fault.inject("serve_engine_kill", at=1)
    with pytest.raises(fault.InjectedFault, match="engine death"):
        srv.engine_step()
    assert fault.stats() == {"serve_engine_kill": 1}


# ----------------------------------------------------------------------
# elastic drains (tests/test_serve.py:798, tests/test_serve_router.py:303)
# ----------------------------------------------------------------------
def test_server_attach_elastic_drains_on_resize_and_completes():
    net = _tnet(2)
    rng = onp.random.RandomState(11)
    srv = serve.Server(net, serve.ServeConfig(**dict(SCFG, slots=2,
                                                     max_new=12)))
    chained = []
    runner = types.SimpleNamespace(on_resize=chained.append)
    assert srv.attach_elastic(runner) is runner
    assert runner.on_resize is not chained.append   # wrapped
    prompts = [list(rng.randint(1, 256, 5)) for _ in range(3)]
    before = profiler.get_counter("serve::elastic_drains")
    with srv:
        rids = [srv.submit(p, max_new=8) for p in prompts]
        deadline = time.monotonic() + 30
        while srv.sched.stats()["running"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        info = types.SimpleNamespace(gen=2, world=2)
        runner.on_resize(info)           # the resize seam
        res = [srv.result(r, timeout=120) for r in rids]
    assert chained == [info]             # prior hook still fired
    assert all(r["state"] == "done" and len(r["tokens"]) == 8 for r in res)
    assert srv.sched.check_conservation() == []
    assert profiler.get_counter("serve::elastic_drains") > before


def test_elastic_drain_with_shared_prefix_pages_no_cross_delivery():
    net = _tnet(3)
    rng = onp.random.RandomState(22)
    shared = list(rng.randint(1, 256, 8))
    prompts = [shared + list(rng.randint(1, 256, 2 + i)) for i in range(5)]
    budgets = [8, 6, 8, 6, 8]
    samp = [{"temperature": 0.9, "top_k": 16, "seed": 100 + i}
            for i in range(5)]

    def scfg():
        return serve.ServeConfig(slots=3, page_size=4, pages=30,
                                 ladder=(16, 32), max_new=10,
                                 prefix_cache=True)
    with serve.Server(net, scfg()) as srv:
        rids = [srv.submit(p, max_new=m, sampling=dict(s))
                for p, m, s in zip(prompts, budgets, samp)]
        control = [srv.result(r, timeout=120)["tokens"] for r in rids]
    srv = serve.Server(net, scfg())
    runner = types.SimpleNamespace(on_resize=None)
    srv.attach_elastic(runner)
    with srv:
        rids = [srv.submit(p, max_new=m, sampling=dict(s))
                for p, m, s in zip(prompts, budgets, samp)]
        deadline = time.monotonic() + 30
        while (srv.sched.stats()["running"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.002)
        runner.on_resize(types.SimpleNamespace(gen=3, world=2))
        mid_refs = srv.sched.check_refcounts()
        mid_cons = srv.sched.check_conservation()
        res = [srv.result(r, timeout=120) for r in rids]
    assert mid_refs == [] and mid_cons == []
    assert all(r["state"] == "done" for r in res)
    assert [r["tokens"] for r in res] == control
    assert srv.sched.check_conservation() == []
    assert srv.sched.check_refcounts() == []
    assert srv.sched.stats()["requests"] == 0


def test_preempt_all_requeues_every_slot_at_the_front():
    sched = serve.SlotScheduler(3, 24, 8, 4)
    rids = [sched.submit(5, 4) for _ in range(4)]
    plans = [sched.admit_next() for _ in range(3)]
    for p in plans:
        sched.commit_prefill(p, 7)
    assert sched.preempt_all("test") == 3
    st = sched.stats()
    assert st["running"] == 0 and st["waiting"] == 4 \
        and st["preemptions"] == 3
    # each drained slot goes to the front, in slot order
    assert sched._s["queue"] == (rids[2], rids[1], rids[0], rids[3])
    assert sched.check_conservation() == []
    assert sched.preempt_all() == 0


def test_deadline_expiry_is_counted_and_recorded():
    srv = serve.Server(_tnet(), serve.ServeConfig(**dict(SCFG,
                                                         max_new=40)))
    before = profiler.get_counter("serve::deadline_exceeded")
    flightrec.reset()
    with srv:
        rid = srv.submit([3, 1, 4, 1, 5], max_new=40, deadline=0.001)
        with pytest.raises(serve.DeadlineExceededError):
            srv.result(rid, timeout=60)
    assert profiler.get_counter("serve::deadline_exceeded") == before + 1
    assert any(e["kind"] == "serve.deadline" for e in flightrec.events())
    assert srv.sched.check_conservation() == []


def test_slo_snapshot_counts_every_delivered_request():
    srv = serve.Server(_tnet(), serve.ServeConfig(**SCFG))
    prompts = _prompts(6, seed=9)
    toks = _serve(srv, prompts, max_new=5)
    snap = srv.slo_snapshot()
    assert snap["latency_ms"]["count"] == snap["ttft_ms"]["count"] == 6
    assert snap["tokens"] == sum(map(len, toks)) == 30
    assert snap["latency_ms"]["p99"] >= snap["latency_ms"]["p50"] > 0
