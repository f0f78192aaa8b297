"""The port's control plane against the JAX package's.

``mxnet_tpu_torch``'s ``telemetry``, ``fault``, ``fault_dist``,
``flightrec`` and ``profiler`` (host plane) are the reference's logic
on the standard library; the same seeded inputs go through both
packages and the outputs must be equal:

* ``LatencyHistogram`` / ``ServeSLO`` buckets and quantiles;
* ``TelemetrySession.payload`` / ``on_beat`` over three simulated ranks
  (a generation jump, a forced full snapshot, a rank missing a round),
  the ``FleetView``s, ``telemetry::resyncs`` and the ``Watchdog``'s
  straggler;
* ``parse_spec`` and the firing pattern of a seeded ``check`` sequence
  (``at``, ``count``, ``prob``, ``seed``), ``retry_call``'s attempts
  and give-ups, the manifests (and a torn file), the error classifier;
* the flight recorder's events and snapshots (timestamps aside);
* the profiler's host plane: event names, categories and counters of
  the same scopes; its chrome JSON and the flight recorder's dump read
  unchanged by the repo's ``tools/trace_merge.py`` and
  ``tools/postmortem.py`` (subprocesses).

And the port's seams (``ndarray.apply_op``, ``Trainer.step``, the
kvstore) emit their events only when their flag is on.
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

from mxnet_tpu import fault as jfault
from mxnet_tpu import fault_dist as jfault_dist
from mxnet_tpu import flightrec as jflightrec
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import telemetry as jtelemetry
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import fault_dist as tfault_dist
from mxnet_tpu_torch import flightrec as tflightrec
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch import telemetry as ttelemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jtelemetry, jfault, jflightrec, jprofiler),
        "torch": (ttelemetry, tfault, tflightrec, tprofiler)}


@pytest.fixture(autouse=True)
def _clean():
    for tel, fault, rec, prof in PKGS.values():
        fault.clear()
        rec.reset()
        prof.reset()
    yield
    for tel, fault, rec, prof in PKGS.values():
        fault.clear()
        if prof.state() == "run":
            prof.set_state("stop")
        prof.reset()


def _samples(kind, seed):
    rs = onp.random.RandomState(seed)
    if kind == "lognormal":
        return rs.lognormal(-4, 1.5, 500).tolist()
    if kind == "edges":      # the sketch's clamps and bucket edges
        return [0.0, 1e-7, 1e-6, 1e-6 * 1.25, 1.0, 9999.0, 1e4, 2e4] \
            + rs.uniform(0, 2, 50).tolist()
    return rs.exponential(0.05, 300).tolist()


# ----------------------------------------------------------------------
# telemetry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,seed", [("lognormal", 0), ("edges", 1),
                                       ("exponential", 2)])
def test_latency_histogram_and_serve_slo_equal(kind, seed):
    xs = _samples(kind, seed)
    outs = {}
    for name, (tel, *_) in PKGS.items():
        h = tel.LatencyHistogram()
        for x in xs:
            h.record(x)
        other = tel.LatencyHistogram()
        for x in xs[::3]:
            other.record(x * 2)
        h.merge(other.to_dict())
        slo = tel.ServeSLO()
        for i, x in enumerate(xs):
            slo.latency.record(x)
            slo.ttft.record(x / 2)
            slo.queued.record(x / 4)
            slo.note_tokens(i % 7, x)
        outs[name] = (h.to_dict(), [h.percentile(p) for p in
                                    (0, 1, 50, 90, 95, 99, 100)],
                      h.snapshot(), slo.snapshot())
    assert outs["torch"] == outs["jax"]


def _fleet_run(tel, prof):
    """Three simulated ranks beating 9 rounds: counters, gauges and step
    times from one seeded draw; rank 2 misses round 2 (its next delta
    cannot apply: a resync), rank 1's generation jumps at round 5 and
    the others' a round later, and every 4th beat is a forced full
    snapshot."""
    rs = onp.random.RandomState(11)
    tel.register_namespace("moe::")
    wd = tel.Watchdog(factor=1.5, window=4, min_median_ms=0.5)
    sessions = [tel.TelemetrySession(full_every=4, watchdog=wd if r == 0
                                     else None, ewma_alpha=0.5)
                for r in range(3)]
    load = [0, 0, 0]
    for r, sess in enumerate(sessions):
        sess.register_gauge("serve::queue_depth",
                            lambda r=r: load[r])
    trace = []
    for beat in range(9):
        tel.bump("serve::submitted", int(rs.randint(1, 4)))
        if beat % 3 == 0:
            tel.bump("moe::dropped_tokens", 2)
        votes = []
        for r, sess in enumerate(sessions):
            load[r] = int(rs.randint(0, 9))
            ms = float(rs.uniform(5, 6)) * (3.0 if r == 2 and beat > 4
                                            else 1.0)
            sess.note_step_time(ms / 1e3)
            if beat == (5 if r == 1 else 6):
                sess.set_generation(1)
            payload = sess.payload()
            if r == 2 and beat == 2:
                continue            # this rank's beat is lost
            votes.append({"rank": r, "step": beat, "telemetry": payload})
        views = [sess.on_beat(votes) for sess in sessions]
        v = views[0]
        trace.append(([vote["telemetry"] for vote in votes],
                      v.ranks, v.world, v.step, v.gen, v.beat,
                      v.reduce()))
    return (trace, wd.stragglers, wd.regressions,
            prof.get_counter("telemetry::resyncs"),
            prof.get_counter("telemetry::beats"),
            prof.get_counter("telemetry::straggler"))


def test_telemetry_session_payloads_and_fleet_views_equal():
    got = _fleet_run(ttelemetry, tprofiler)
    want = _fleet_run(jtelemetry, jprofiler)
    assert got == want
    assert got[3] > 0 and got[1]        # a resync and a straggler


def test_enable_fleet_telemetry_needs_a_heartbeat():
    with pytest.raises(RuntimeError, match="no heartbeat"):
        ttelemetry.enable_fleet_telemetry()
    hb = type("HB", (), {"telemetry": None})()
    sess = ttelemetry.TelemetrySession()
    assert ttelemetry.enable_fleet_telemetry(hb, sess) is sess
    assert hb.telemetry is sess
    with pytest.raises(ValueError, match="namespace"):
        ttelemetry.bump("nowhere::x")


# ----------------------------------------------------------------------
# fault injection and retry
# ----------------------------------------------------------------------
SPECS = ["kvstore_fail@3:count=2",
         "kvstore_fail:prob=0.3:seed=7;collective_fail@2",
         "serve_decode_fail@2:op=fatal,serve_slow_decode:op=0.0",
         "checkpoint_truncate@1;serve_engine_kill@4:count=3",
         '[{"kind": "collective_fail", "at": 2, "count": 3},'
         ' {"kind": "kvstore_fail", "prob": 0.5, "seed": 3}]']


def _firings(fault, spec):
    parsed = fault.parse_spec(spec)
    for s in parsed:
        fault.inject(**s)
    rs = onp.random.RandomState(5)
    sites = ["kvstore", "collective", "serve_engine", "checkpoint",
             "step"]
    out = []
    for _ in range(40):
        site = sites[rs.randint(len(sites))]
        out.append((site, sorted(f.kind for f in fault.check(
            site, op="push"))))
    for _ in range(4):
        out.append(("serve_decode", sorted(
            f.kind for f in fault._check_flavored("serve_decode"))))
    return parsed, out, fault.stats(), fault.active()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_and_firing_pattern_equal(spec):
    got = _firings(tfault, spec)
    want = _firings(jfault, spec)
    assert got == want
    assert any(k for _, k in got[1])


@pytest.mark.parametrize("fails,max_retries", [(0, 3), (2, 3), (3, 3),
                                               (5, 2)])
def test_retry_call_attempts_and_give_ups_equal(fails, max_retries):
    outs = {}
    for name, (_, fault, _, prof) in PKGS.items():
        calls = []

        def op():
            calls.append(1)
            if len(calls) <= fails:
                raise fault.TransientError("blip %d" % len(calls))
            return "ok"
        pol = fault.RetryPolicy(max_retries=max_retries, base_delay=0.0,
                                jitter=0.0, timeout=False, seed=0)
        try:
            res = fault.retry_call(op, policy=pol, op="t")
        except fault.TransientError as e:
            res = "gave up: %s" % e
        outs[name] = (res, len(calls), prof.get_counter("fault::retries"),
                      prof.get_counter("fault::gave_up"))
    assert outs["torch"] == outs["jax"]


def test_retry_call_per_attempt_timeout():
    import time
    n = []

    def slow():
        n.append(1)
        if len(n) == 1:
            time.sleep(0.5)
        return len(n)
    pol = tfault.RetryPolicy(max_retries=2, base_delay=0.0, jitter=0.0,
                             timeout=0.05)
    assert tfault.retry_call(slow, policy=pol) == 2
    assert tprofiler.get_counter("fault::retries") == 1


def test_manifests_round_trip_and_detect_a_torn_file(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / ("part%d.bin" % i)
        p.write_bytes(onp.random.RandomState(i).bytes(1000 + i))
        files.append(str(p))
    man = str(tmp_path / "manifest.json")
    written = tfault.write_manifest(man, files, extra={"step": 7})
    assert written["step"] == 7 and len(written["files"]) == 3
    assert tfault.verify_manifest(man) == (True, [])
    assert jfault.verify_manifest(man) == (True, [])   # the same format
    tfault.inject("checkpoint_truncate")
    tfault.checkpoint_hook(files[1])                    # tears it
    ok, bad = tfault.verify_manifest(man)
    assert not ok and bad == [files[1]]
    assert jfault.verify_manifest(man) == (ok, bad)
    assert tfault.verify_manifest(man, only=["part0.bin"]) == (True, [])
    (tmp_path / "broken.json").write_text("{not json")
    assert tfault.verify_manifest(str(tmp_path / "broken.json"))[0] is False


def _reference_errors():
    errs = []
    for spec in ("serve_decode_fail", "serve_decode_fail:op=fatal"):
        jfault.clear()
        for s in jfault.parse_spec(spec):
            jfault.inject(**s)
        try:
            jfault.serve_decode_check()
        except Exception as e:  # noqa: BLE001 -- the injected error
            errs.append(e)
    jfault.clear()
    cls = type(errs[0])
    for msg in ("UNAVAILABLE: socket closed", "DEADLINE_EXCEEDED: rpc",
                "RESOURCE_EXHAUSTED: UNAVAILABLE while tearing down",
                "INTERNAL: something new", "Mosaic failed to lower"):
        errs.append(cls(msg))
    errs += [RuntimeError("UNAVAILABLE"), ValueError("OOM")]
    return errs


@pytest.mark.parametrize("i", range(9))
def test_classify_xla_error_equal_on_the_references_errors(i):
    e = _reference_errors()[i]
    assert tfault_dist.classify_xla_error(e) == \
        jfault_dist.classify_xla_error(e)


def test_classify_torch_runtime_errors_and_the_ports_injected_ones():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert tfault_dist.classify_xla_error(oom) == "fatal"
    assert tfault_dist.classify_xla_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) == "fatal"
    assert tfault_dist.classify_xla_error(RuntimeError(
        "CUDA error: device-side assert triggered")) == "fatal"
    assert tfault_dist.classify_xla_error(torch.distributed.DistBackendError(
        "NCCL error: remote process exited or there was a network "
        "error")) == "transient"
    assert tfault_dist.classify_xla_error(RuntimeError(
        "NCCL watchdog: Connection reset by peer")) == "transient"
    assert tfault_dist.classify_xla_error(RuntimeError("plain")) is None
    verdicts = []
    for op in (None, "fatal"):
        tfault.inject("serve_decode_fail", op=op)
        with pytest.raises(RuntimeError) as info:
            tfault.serve_decode_check()
        assert type(info.value).__name__ == "XlaRuntimeError"
        verdicts.append(tfault_dist.classify_xla_error(info.value))
    assert verdicts == ["transient", "fatal"]
    # the rest of the module is ported: one process votes with itself
    assert isinstance(tfault_dist.default_comm(), tfault_dist.LocalComm)
    assert tfault_dist.coordinated_call(lambda: 7, op="t") == 7
    assert callable(tfault.PreemptionHandler)


# ----------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------
def _recorder_run(rec):
    rec.configure(capacity=8)
    rec.set_context(rank=0, world=3)
    for i in range(13):
        rec.record("sched.admit" if i % 2 else "router.dispatch",
                   detail="rid %d" % i, step=i, gen=i // 5)
    rec.set_context(step=12)
    snap = rec.snapshot()
    for ev in snap["events"]:
        ev.pop("t")
    last = [{k: v for k, v in e.items() if k != "t"}
            for e in rec.events(last=3)]
    rec.configure(capacity=rec.DEFAULT_CAPACITY)
    return snap, last


def test_flight_recorder_events_and_snapshots_equal():
    got, want = _recorder_run(tflightrec), _recorder_run(jflightrec)
    assert got == want
    assert got[0]["dropped"] == 5 and len(got[0]["events"]) == 8


def test_flight_recorder_dump_reads_in_postmortem(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHTREC_DIR", str(tmp_path))
    for rank in range(2):
        tflightrec.reset()
        tflightrec.record("sched.admit", detail="rid 1")
        tflightrec.record("router.replica_dead", detail="replica 1",
                          replica=1)
        assert tflightrec.dump(str(tmp_path / (
            "flightrec.rank%d.json" % rank)), reason="test")
    tflightrec.reset()
    assert tflightrec.note_terminal("serve_engine",
                                    exc=RuntimeError("dead"))
    with open(tmp_path / "flightrec.rank0.json") as f:
        dump = json.load(f)
    assert sorted(dump) == sorted([
        "version", "reason", "wall_time", "pid", "rank", "world",
        "flightrec", "providers", "env", "exception", "counters"])
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "postmortem.py"),
         str(tmp_path), "--json", str(out), "-q"], capture_output=True,
        text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(out.read_text())
    assert report["dumps"] and report["timeline"]


# ----------------------------------------------------------------------
# the profiler's host plane
# ----------------------------------------------------------------------
def _scopes(prof, path):
    prof.set_config(filename=str(path), profile_all=True)
    prof.set_state("run")
    dom = prof.Domain("serve")
    with dom.new_task("prefill"):
        pass
    fr = prof.Frame(dom, "step")
    fr.start()
    fr.stop()
    with prof.Event("decode"):
        pass
    c = dom.new_counter("tokens", 3)
    c += 4
    c.decrement(2)
    dom.new_marker("admit").mark()
    with prof.annotate("user"):
        pass
    prof.pause()
    with prof.Event("paused"):
        pass
    prof.resume()
    prof.counter_bump("fault::retries", 2, cat="fault")
    prof.record_instant("tick", cat="instant")
    prof.set_state("stop")
    prof.dump()
    with open(path) as f:
        doc = json.load(f)
    table = prof.dumps()
    events = sorted((e["name"], e["cat"], e["ph"]) for e in
                    doc["traceEvents"] if e["ph"] != "M")
    counters = {e["name"]: e["args"]["value"] for e in doc["traceEvents"]
                if e["ph"] == "C"}
    return events, counters, prof.get_counters(), \
        sorted(line.split()[0] for line in table.splitlines()[1:])


def test_profiler_host_plane_equal_and_chrome_json(tmp_path):
    try:
        got = _scopes(tprofiler, tmp_path / "port" / "profile.json")
        want = _scopes(jprofiler, tmp_path / "jax" / "profile.json")
    finally:
        for prof in (tprofiler, jprofiler):
            prof.set_config(profile_all=False)
    assert got == want
    assert ("serve::prefill", "task", "X") in got[0]
    assert os.path.exists(tmp_path / "port" / "profile_trace"
                          / "device.json")
    # the port's dump through the repo's stdlib merger, unchanged
    out = tmp_path / "merged.json"
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_merge.py"),
         str(tmp_path / "port" / "profile.json"), "-o", str(out)],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(out.read_text())["traceEvents"]


# ----------------------------------------------------------------------
# the seams: events only with their flag on
# ----------------------------------------------------------------------
def _seam_events(tmp_path, on, seam):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, kvstore
    tprofiler.reset()
    tprofiler.set_config(filename=str(tmp_path / "p.json"),
                         profile_all=False, profile_imperative=on,
                         profile_kvstore=on)
    tprofiler.set_state("run")
    with mx.cpu():
        if seam == "apply_op":
            a = mx.np.ones((2, 3))
            (a * 2 + a).asnumpy()
        elif seam == "trainer":
            net = gluon.nn.Dense(3, in_units=4)
            net.initialize(device="cpu")
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
            with mx.autograd.record():
                loss = net(mx.np.ones((2, 4))).sum()
            loss.backward()
            tr.step(2)
        else:
            kv = kvstore.create("local")
            kv.init(3, torch.ones(4))
            kv.push(3, torch.ones(4))
            out = torch.zeros(4)
            kv.pull(3, out=out)
            kv.pushpull(3, torch.ones(4), out=out)
    tprofiler.set_state("stop")
    return {(e[1], e[2]) for e in tprofiler._state["events"]}


@pytest.mark.parametrize("seam,want", [
    ("apply_op", ("operator",)),
    ("trainer", ("Trainer::step", "Trainer::update")),
    ("kvstore", ("KVStore::push", "KVStore::pull", "KVStore::pushpull",
                 "kvstore::push_bytes", "kvstore::pull_bytes"))])
def test_seams_emit_only_with_their_flag_on(tmp_path, seam, want):
    on = _seam_events(tmp_path, True, seam)
    off = _seam_events(tmp_path, False, seam)
    names = {n for n, _ in on} | {c for _, c in on}
    assert set(want) <= names
    assert not ({n for n, _ in off} | {c for _, c in off}) & set(want)


def test_kvstore_retries_an_injected_failure():
    from mxnet_tpu_torch import kvstore
    kv = kvstore.create("local")
    kv.init(0, torch.zeros(3))
    tfault.inject("kvstore_fail", at=1, count=2)
    kv.push(0, torch.ones(3))
    out = torch.zeros(3)
    kv.pull(0, out=out)
    assert out.tolist() == [1.0, 1.0, 1.0]
    assert tprofiler.get_counter("fault::retries") == 2
    assert tfault.stats() == {"kvstore_fail": 2}
