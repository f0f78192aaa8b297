"""mxrace level 2 for the PyTorch port: dynamic confirmation of static
race findings over REAL threads, with a vector-clock happens-before
checker.

The static half (:mod:`.race`) proves the *absence of a common lock*;
this module proves the *absence of ordering*: each scenario replays a
finding's thread roots against the port's real code, with the shared
object and its guarding lock wrapped in instrumented twins that report
every access, acquire and release to a vector-clock detector.  Two
accesses race when they come from different threads, at least one
writes, their locksets are disjoint, AND their vector clocks are
incomparable: no chain of lock releases / acquires (the only
synchronization the scenarios use) orders them.

Every instrumented operation is a yield point where a seeded
interleaver perturbs the schedule.  The verdict does NOT depend on
schedule luck: "unordered" is a property of the happens-before
relation, which is the same on every interleaving of the same roots;
the forced interleavings only vary which states and code paths a run
exercises.  So a seeded race is flagged on every run, and a properly
locked scenario is clean on every run.

Mutation seams, mirroring ``modelcheck.KNOWN_MUTATIONS``: the liveness
proof deliberately DROPS a known lock and the detector must flag the
race; with the lock restored the scenario must run clean
(``python -m mxnet_tpu_torch.analysis racecheck --smoke`` is the gate).

Scenarios: ``counter_bump`` (``profiler._state`` / ``_rec_lock``),
``lease_flag`` (``fault_dist.StepLease._s``), ``serve_sched``
(``serve.SlotScheduler._s``), ``telemetry_view``
(``telemetry.TelemetrySession._s``) and ``flightrec_ring``
(``flightrec._s``).  The reference's ``relay`` scenario checks the JAX
package's launcher (``tools/launch.py``); the port has no launcher of
its own, so that scenario, and its ``drop_relay_lock`` mutation, are
not here.

Stdlib-only at import; each scenario imports the port module it drives
when it runs.
"""
from __future__ import annotations

import contextlib
import os
import random
import sys
import threading
import time

__all__ = [
    "RaceDetector", "InstrumentedLock", "InstrumentedDict", "NullLock",
    "Witness", "ConfirmReport", "SCENARIOS", "KNOWN_MUTATIONS",
    "mutations", "confirm",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_THIS = os.path.abspath(__file__)


# ----------------------------------------------------------------------
# vector clocks
# ----------------------------------------------------------------------
def _leq(a, b):
    return all(v <= b.get(k, 0) for k, v in a.items())


def _unordered(a, b):
    return not _leq(a, b) and not _leq(b, a)


class Witness:
    __slots__ = ("var", "a_site", "a_write", "b_site", "b_write",
                 "a_locks", "b_locks")

    def __init__(self, var, a, b):
        self.var = var
        self.a_site, self.a_write, self.a_locks = a.site, a.write, a.locks
        self.b_site, self.b_write, self.b_locks = b.site, b.write, b.locks

    def format(self):
        def leg(site, write, locks):
            return "%s %s holding %s" % (
                "write" if write else "read", site,
                "{%s}" % ", ".join(sorted(locks)) if locks
                else "no lock")
        return "race on %s: %s UNORDERED with %s" % (
            self.var, leg(self.a_site, self.a_write, self.a_locks),
            leg(self.b_site, self.b_write, self.b_locks))


class _Access:
    __slots__ = ("var", "write", "tid", "vc", "locks", "site")

    def __init__(self, var, write, tid, vc, locks, site):
        self.var = var
        self.write = write
        self.tid = tid
        self.vc = vc
        self.locks = locks
        self.site = site


class _Interleaver:
    """Seeded schedule perturbation at every instrumented access — the
    "forced interleavings" knob.  See the module docstring for why the
    verdict is schedule-invariant regardless."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self._mx = threading.Lock()

    def pause(self):
        with self._mx:
            r = self._rng.random()
        if r < 0.25:
            time.sleep(0.0005)
        elif r < 0.6:
            time.sleep(0)  # explicit GIL yield point


class RaceDetector:
    """Records instrumented accesses with per-thread vector clocks and
    lock-transfer edges; :meth:`races` reports every conflicting,
    lockset-disjoint, happens-before-unordered pair."""

    def __init__(self, interleaver=None):
        self._mx = threading.Lock()
        self._vcs = {}       # logical thread id -> {id: counter}
        self._lock_vcs = {}  # lock name -> published clock
        self._held = {}      # logical thread id -> [lock name, ...]
        self._accesses = []
        self._interleaver = interleaver
        self._tls = threading.local()
        self._spawn_seq = 0

    # -- thread lifecycle ----------------------------------------------
    def _lid(self):
        """Logical thread id.  NOT the OS ident: the kernel reuses
        idents, so a root finishing before its sibling starts would
        collapse two concurrent-by-construction roots into "one
        thread" and hide their race — each spawned() root gets a
        unique logical id instead."""
        lid = getattr(self._tls, "lid", None)
        return threading.get_ident() if lid is None else lid

    def spawned(self, fn):
        """Wrap a root callable: the child's clock inherits the
        spawner's (a fork edge), so setup done before start() is
        ordered before everything the root does."""
        parent = self._lid()
        with self._mx:
            self._spawn_seq += 1
            lid = "root-%d" % self._spawn_seq
            pvc = self._vcs.setdefault(parent, {parent: 0})
            pvc[parent] += 1
            snap = dict(pvc)

        def run(*args, **kwargs):
            self._tls.lid = lid
            with self._mx:
                vc = dict(snap)
                vc[lid] = 0
                self._vcs[lid] = vc
                self._held.setdefault(lid, [])
            return fn(*args, **kwargs)

        return run

    # -- events ---------------------------------------------------------
    def _site(self):
        f = sys._getframe(2)
        while f is not None and \
                os.path.abspath(f.f_code.co_filename) == _THIS:
            f = f.f_back
        if f is None:
            return "<unknown>"
        path = f.f_code.co_filename
        try:
            rel = os.path.relpath(path, _ROOT)
            if not rel.startswith(".."):
                path = rel.replace(os.sep, "/")
        except ValueError:
            pass
        return "%s:%d (%s)" % (path, f.f_lineno, f.f_code.co_name)

    def on_access(self, var, write):
        tid = self._lid()
        site = self._site()
        with self._mx:
            vc = self._vcs.setdefault(tid, {tid: 0})
            vc[tid] += 1
            self._accesses.append(_Access(
                var, write, tid, dict(vc),
                frozenset(self._held.get(tid, ())), site))
        if self._interleaver is not None:
            self._interleaver.pause()

    def on_acquire(self, name):
        tid = self._lid()
        with self._mx:
            vc = self._vcs.setdefault(tid, {tid: 0})
            for k, v in self._lock_vcs.get(name, {}).items():
                if vc.get(k, 0) < v:
                    vc[k] = v
            self._held.setdefault(tid, []).append(name)

    def on_release(self, name):
        tid = self._lid()
        with self._mx:
            vc = self._vcs.setdefault(tid, {tid: 0})
            vc[tid] += 1
            self._lock_vcs[name] = dict(vc)
            held = self._held.get(tid, [])
            if name in held:
                held.remove(name)

    # -- analysis -------------------------------------------------------
    def races(self, max_per_var=3):
        by_var = {}
        for a in self._accesses:
            by_var.setdefault(a.var, []).append(a)
        out = []
        for var in sorted(by_var):
            accs = by_var[var]
            found = 0
            for i in range(len(accs)):
                if found >= max_per_var:
                    break
                for j in range(i + 1, len(accs)):
                    a, b = accs[i], accs[j]
                    if a.tid == b.tid:
                        continue
                    if not (a.write or b.write):
                        continue
                    if a.locks & b.locks:
                        continue
                    if not _unordered(a.vc, b.vc):
                        continue
                    out.append(Witness(var, a, b))
                    found += 1
                    break
        return out


# ----------------------------------------------------------------------
# instrumented twins
# ----------------------------------------------------------------------
class InstrumentedLock:
    """A real lock that reports acquire/release (and the clock transfer
    they imply) to the detector."""

    def __init__(self, det, name, lock=None):
        self._det = det
        self._name = name
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, *args, **kwargs):
        got = self._lock.acquire(*args, **kwargs)
        if got:
            self._det.on_acquire(self._name)
        return got

    def release(self):
        self._det.on_release(self._name)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class NullLock:
    """The dropped lock: a context manager that synchronizes nothing
    and tells the detector nothing — the seeded mutation."""

    def acquire(self, *args, **kwargs):
        return True

    def release(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class InstrumentedDict:
    """Dict twin reporting element reads/writes as accesses to one
    named shared variable (the granularity the static finding names)."""

    def __init__(self, det, name, data=None):
        self._det = det
        self._name = name
        self._d = dict(data or {})

    def get(self, key, default=None):
        self._det.on_access(self._name, False)
        return self._d.get(key, default)

    def __getitem__(self, key):
        self._det.on_access(self._name, False)
        return self._d[key]

    def __contains__(self, key):
        self._det.on_access(self._name, False)
        return key in self._d

    def __setitem__(self, key, value):
        self._det.on_access(self._name, True)
        self._d[key] = value

    def __delitem__(self, key):
        self._det.on_access(self._name, True)
        del self._d[key]

    def setdefault(self, key, default=None):
        self._det.on_access(self._name, True)
        return self._d.setdefault(key, default)

    def clear(self):
        self._det.on_access(self._name, True)
        self._d.clear()

    def items(self):
        self._det.on_access(self._name, False)
        return list(self._d.items())

    def keys(self):
        self._det.on_access(self._name, False)
        return list(self._d.keys())

    def __len__(self):
        self._det.on_access(self._name, False)
        return len(self._d)

    def snapshot(self):
        return dict(self._d)


# ----------------------------------------------------------------------
# mutation seams (checker-liveness proof)
# ----------------------------------------------------------------------
KNOWN_MUTATIONS = {
    "drop_counter_lock": "run profiler.counter_bump roots with "
                         "_rec_lock replaced by a no-op (an unlocked "
                         "read-modify-write of the counters)",
    "drop_lease_lock": "run the StepLease roots with the lease's _lock "
                       "replaced by a no-op (the step thread's op "
                       "bookkeeping racing the poller/preemption "
                       "thread's revoke_local)",
    "drop_sched_lock": "run the serve.SlotScheduler roots with the "
                       "scheduler's _lock replaced by a no-op (client "
                       "submit/cancel threads racing the engine's "
                       "admit/begin/commit transactions)",
    "drop_telemetry_lock": "run the telemetry.TelemetrySession roots "
                           "with the session's _lock replaced by a "
                           "no-op (the beat thread's on_beat/payload "
                           "aggregation racing the step thread's "
                           "note_step_time and fleet_view readers)",
    "drop_flightrec_lock": "run the mx.flightrec roots with the "
                           "recorder's _lock replaced by a no-op "
                           "(protocol seams' record() racing the "
                           "dump thread's events()/snapshot() over "
                           "the ring state)",
}
_ARMED = set()


@contextlib.contextmanager
def mutations(*names):
    """Arm deliberately dropped locks (tests/CI smoke only).  Validates
    every name BEFORE arming anything and disarms in a finally — same
    contract as ``modelcheck.mutations``."""
    for n in names:
        if n not in KNOWN_MUTATIONS:
            raise KeyError("unknown mutation %r (known: %s)"
                           % (n, ", ".join(sorted(KNOWN_MUTATIONS))))
    armed = []
    try:
        for n in names:
            _ARMED.add(n)
            armed.append(n)
        yield
    finally:
        for n in armed:
            _ARMED.discard(n)


# ----------------------------------------------------------------------
# scenarios
# ----------------------------------------------------------------------
class Scenario:
    def __init__(self, name, confirms, runner, doc):
        self.name = name
        self.confirms = confirms
        self.runner = runner
        self.doc = doc


SCENARIOS = {}


def _scenario(name, confirms, doc):
    def deco(runner):
        SCENARIOS[name] = Scenario(name, confirms, runner, doc)
        return runner
    return deco


@_scenario(
    "counter_bump",
    "R9 on mxnet_tpu_torch.profiler._state (counters bumped "
    "concurrently from heartbeat/poller/main threads, guarded by "
    "_rec_lock)",
    "three real profiler.counter_bump roots (heartbeat-, poller-, and "
    "step-shaped) hammer one counter through the instrumented dict "
    "and lock")
def _run_counter_bump(det, seed):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from mxnet_tpu_torch import profiler
    real_lock = profiler._rec_lock
    real_counters = profiler._state["counters"]
    probe = "mxrace::probe"
    wrapped = InstrumentedDict(
        det, "mxnet_tpu_torch/profiler.py:_state['counters']")
    profiler._state["counters"] = wrapped
    if "drop_counter_lock" in _ARMED:
        profiler._rec_lock = NullLock()
    else:
        profiler._rec_lock = InstrumentedLock(
            det, "mxnet_tpu_torch/profiler.py:_rec_lock",
            threading.RLock())
    bumps_per_root, roots = 30, 3
    try:
        def root():
            for _ in range(bumps_per_root):
                profiler.counter_bump(probe, 1, cat="fault")

        threads = [threading.Thread(target=det.spawned(root),
                                    daemon=True,
                                    name="mxrace-bump-%d" % i)
                   for i in range(roots)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        return {"expected": bumps_per_root * roots,
                "final": wrapped.snapshot().get(probe, 0)}
    finally:
        profiler._rec_lock = real_lock
        profiler._state["counters"] = real_counters


@_scenario(
    "lease_flag",
    "R9 on fault_dist.StepLease._s (the lease/escalation state shared "
    "between the step thread — op bookkeeping, beats — and the "
    "maintenance-poller/preemption thread's revoke_local; every access "
    "must ride the lease's _lock)",
    "a step-shaped root hammers note_op/active/payload while a "
    "poller-shaped root fires revoke_local, over the real StepLease "
    "code with its state dict and lock instrumented")
def _run_lease_flag(det, seed):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    import logging
    from mxnet_tpu_torch import fault_dist as fdist
    # dozens of instrumented revoke_local calls would each log their
    # escalation warning: silence the protocol logger for the probe
    lg = logging.getLogger("mxnet_tpu_torch.fault.dist")
    level = lg.level
    lg.setLevel(logging.CRITICAL)
    lease = fdist.StepLease(heartbeat=None, gen=fdist.Generation(),
                            rearm=1)
    lease._s = InstrumentedDict(
        det, "mxnet_tpu_torch/fault_dist.py:StepLease._s", lease._s)
    if "drop_lease_lock" in _ARMED:
        lease._lock = NullLock()
    else:
        lease._lock = InstrumentedLock(
            det, "mxnet_tpu_torch/fault_dist.py:StepLease._lock",
            threading.RLock())  # the real lock is an RLock (signal path)
    iters = 25

    def step_root():
        # the step thread's view: covered-op bookkeeping plus the
        # active() gate every coordinated_call consults
        for _ in range(iters):
            lease.active()
            lease.note_op("op")
            lease.payload()

    def poller_root():
        # the maintenance-poller / preemption-fire view
        for _ in range(iters):
            lease.revoke_local(reason="mxrace-probe")

    threads = [threading.Thread(target=det.spawned(root), daemon=True,
                                name="mxrace-lease-%d" % i)
               for i, root in enumerate((step_root, poller_root))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    lg.setLevel(level)
    return {"state": lease._s.snapshot().get("state")}


@_scenario(
    "serve_sched",
    "R9 on serve.SlotScheduler._s (the continuous-batching scheduler's "
    "queue/page-table/slot state shared between client submit/cancel "
    "threads and the engine thread's admit/begin/commit transactions; "
    "every access must ride the scheduler's _lock)",
    "a client-shaped root hammers submit/cancel/stats while an "
    "engine-shaped root runs admit/begin/commit over the real "
    "SlotScheduler with its state dict and lock instrumented")
def _run_serve_sched(det, seed):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from mxnet_tpu_torch import serve
    sched = serve.SlotScheduler(slots=2, pages=9, page_size=2,
                                max_pages_per_slot=4)
    sched._s = InstrumentedDict(
        det, "mxnet_tpu_torch/serve.py:SlotScheduler._s", sched._s)
    if "drop_sched_lock" in _ARMED:
        sched._lock = NullLock()
    else:
        sched._lock = InstrumentedLock(
            det, "mxnet_tpu_torch/serve.py:SlotScheduler._lock")
    iters = 20

    def client_root():
        # the client-thread view: submissions, cancels, stats polls.
        # With the lock dropped the state TEARS (KeyError/IndexError on
        # stale reads) — that corruption IS the race manifesting; the
        # vector clocks carry the verdict, so keep the root quiet.
        for i in range(iters):
            try:
                rid = sched.submit(3, 2)
                sched.stats()
                if i % 3 == 0:
                    sched.cancel(rid)
            except (KeyError, IndexError):
                pass

    def engine_root():
        # the engine-thread view: the production iteration shape
        for i in range(iters):
            try:
                snap = sched.begin_step()
                while True:
                    plan = sched.admit_next()
                    if plan is None:
                        break
                    sched.commit_prefill(plan, 7)
                sched.commit_step(snap, [(11, False) for _ in snap])
            except (KeyError, IndexError):
                pass

    threads = [threading.Thread(target=det.spawned(root), daemon=True,
                                name="mxrace-serve-%d" % i)
               for i, root in enumerate((client_root, engine_root))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    return {"stats": sched.stats(), "audit": len(sched.audit)}


@_scenario(
    "telemetry_view",
    "R9 on telemetry.TelemetrySession._s (the fleet-aggregation state "
    "shared between the heartbeat thread's payload/on_beat and the "
    "step thread's note_step_time + fleet_view readers; every access "
    "must ride the session's _lock)",
    "a beat-shaped root replays payload()/on_beat() rounds while a "
    "step-shaped root hammers note_step_time/fleet_view/set_generation "
    "over the real TelemetrySession with its state dict and lock "
    "instrumented")
def _run_telemetry_view(det, seed):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from mxnet_tpu_torch import telemetry
    sess = telemetry.TelemetrySession(max_keys=8, full_every=4)
    sess._s = InstrumentedDict(
        det, "mxnet_tpu_torch/telemetry.py:TelemetrySession._s", sess._s)
    if "drop_telemetry_lock" in _ARMED:
        sess._lock = NullLock()
    else:
        sess._lock = InstrumentedLock(
            det, "mxnet_tpu_torch/telemetry.py:TelemetrySession._lock",
            threading.RLock())  # the real lock is an RLock (watchdog
    iters = 25                  # callbacks re-enter fleet_view)

    def beat_root():
        # the heartbeat thread's view: export the payload, consume the
        # completed round.  With the lock dropped the delta base and
        # per-rank states TEAR (KeyError on stale reads) — that
        # corruption IS the race manifesting; the vector clocks carry
        # the verdict, so keep the root quiet.
        for i in range(iters):
            try:
                p = sess.payload()
                sess.on_beat([{"rank": 0, "step": i, "t": 0.0,
                               "telemetry": p}])
            except (KeyError, TypeError):
                pass

    def step_root():
        # the step thread's view: per-step timings plus the readers a
        # policy/watchdog callback would run
        for i in range(iters):
            try:
                sess.note_step_time(0.001 * (i + 1))
                sess.fleet_view()
                if i % 5 == 0:
                    sess.set_generation(i)
            except (KeyError, TypeError):
                pass

    threads = [threading.Thread(target=det.spawned(root), daemon=True,
                                name="mxrace-telemetry-%d" % i)
               for i, root in enumerate((beat_root, step_root))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    return {"beats": sess._s.snapshot().get("beats")}


@_scenario(
    "flightrec_ring",
    "R9 on flightrec._s (the black-box ring: seq/slot/config state "
    "shared between every protocol seam's record() — step thread, "
    "heartbeat thread, signal path — and the dump thread's "
    "events()/snapshot(); every access must ride flightrec._lock)",
    "a step-shaped root hammers record() while a dump-shaped root "
    "snapshots the ring (the note_terminal path minus file I/O) over "
    "the real mx.flightrec with its state dict and lock instrumented")
def _run_flightrec_ring(det, seed):
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    from mxnet_tpu_torch import flightrec as fr
    real_lock, real_s = fr._lock, fr._s
    was_cap, was_enabled = fr.capacity(), fr.enabled()
    fr.configure(capacity=16, enabled=True)   # wrap early and often
    fr.reset()
    fr._s = InstrumentedDict(det, "mxnet_tpu_torch/flightrec.py:_s",
                             fr._s)
    if "drop_flightrec_lock" in _ARMED:
        fr._lock = NullLock()
    else:
        fr._lock = InstrumentedLock(
            det, "mxnet_tpu_torch/flightrec.py:_lock",
            threading.RLock())  # the real lock is an RLock (a dump
    iters = 25                  # records its own breadcrumb)
    try:
        def step_root():
            # every protocol seam's view: append-only recording
            for i in range(iters):
                fr.record("step.begin", step=i, gen=0)

        def dump_root():
            # the terminal-event view: snapshot the ring mid-flight
            # (note_terminal's read side, minus the file write)
            for _ in range(iters):
                fr.snapshot()
                fr.events(last=4)

        threads = [threading.Thread(target=det.spawned(root),
                                    daemon=True,
                                    name="mxrace-flightrec-%d" % i)
                   for i, root in enumerate((step_root, dump_root))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        return {"seq": fr._s.snapshot().get("seq")}
    finally:
        fr._lock, fr._s = real_lock, real_s
        fr.configure(capacity=was_cap, enabled=was_enabled)
        fr.reset()


# ----------------------------------------------------------------------
# confirmation
# ----------------------------------------------------------------------
class ConfirmReport:
    def __init__(self, scenario, confirms, racy, witnesses, info,
                 seeds):
        self.scenario = scenario
        self.confirms = confirms
        self.racy = racy
        self.witnesses = witnesses
        self.info = info
        self.seeds = seeds

    def summary(self):
        head = ("mxrace: scenario %-12s %s across %d seeded "
                "interleaving(s); confirms: %s"
                % (self.scenario,
                   "RACE CONFIRMED" if self.racy else "clean (benign/"
                   "properly locked)", len(self.seeds), self.confirms))
        lines = [head]
        for w in self.witnesses[:4]:
            lines.append("  " + w.format())
        if self.info:
            lines.append("  info: %s" % self.info)
        return "\n".join(lines)


def confirm(name, seeds=(0, 1, 2)):
    """Run scenario ``name`` under each seeded forced interleaving and
    merge the vector-clock verdicts.  Racy on ANY seed = confirmed (the
    verdict is schedule-invariant; multiple seeds only widen code-path
    coverage)."""
    scen = SCENARIOS[name]
    witnesses, info = [], {}
    for seed in seeds:
        det = RaceDetector(interleaver=_Interleaver(seed))
        info = scen.runner(det, seed) or {}
        witnesses.extend(det.races())
    return ConfirmReport(name, scen.confirms, bool(witnesses),
                         witnesses, info, tuple(seeds))
