"""profiler -- framework-wide instrumentation over ``torch.profiler``.

Counterpart of ``mxnet_tpu/profiler.py`` (the reference MXNet's
``set_config``, ``set_state``, ``pause`` / ``resume``, ``dump``, user
scopes ``Domain`` / ``Task`` / ``Frame`` / ``Counter`` / ``Marker``).

Two recording planes:

1. **Device plane** -- ``set_state('run')`` starts a
   ``torch.profiler.profile`` (CPU activity, plus CUDA activity when a
   card is present); ``dump`` exports its chrome trace into
   ``<filename stem>_trace/``.  User scopes also open
   ``torch.profiler.record_function``, so they appear on that trace.
   :func:`record_memory` samples ``torch.cuda.memory_allocated`` /
   ``max_memory_allocated`` of every card.
2. **Host plane** -- the reference's event recorder, whole: framework
   seams (op dispatch in ``ndarray.apply_op``, the kvstore's push /
   pull, the ``Trainer.step`` phases) and user scopes emit events with
   real wall-clock begin / end timestamps, and ``dump()`` writes them as
   chrome://tracing JSON (``ph:"X"`` complete events, ``ph:"C"`` counter
   events, ``ph:"i"`` instants), the reference's format, which
   ``tools/trace_merge.py`` reads.

Hot paths are gated by module-level flags (``_IMPERATIVE``,
``_KVSTORE``, ``_STEP``, ``_DATA``, ``_MEMORY``) recomputed on every
config / state change, so with profiling off an instrumented call site
pays one attribute read.  Every ``_state`` touch is under the reentrant
``_rec_lock``: counters are bumped from the serving engine, the
router's waiters and client threads at once.

``MXNET_PROFILER_AUTOSTART=1`` starts the profiler at import and dumps
at interpreter exit.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import defaultdict


# epoch for all host-plane timestamps: microseconds since module import
_EPOCH = time.perf_counter()


def _now_us():
    """Monotonic wall-clock in microseconds since profiler epoch."""
    return (time.perf_counter() - _EPOCH) * 1e6


_state = {
    "config": {"profile_all": False, "profile_symbolic": True,
               "profile_imperative": True, "profile_memory": False,
               "profile_api": False, "profile_kvstore": True,
               "profile_data": True, "filename": "profile.json",
               "aggregate_stats": False, "continuous_dump": False},
    "running": False,
    "paused": False,
    "trace_dir": None,
    "device_prof": None,   # the running torch.profiler.profile
    "agg": defaultdict(lambda: [0, 0.0]),  # name -> [count, total_s]
    "events": [],     # ("X", name, cat, ts_us, dur_us, tid, args|None)
                      # ("C", name, cat, ts_us, value)
                      # ("i", name, cat, ts_us, args|None)
    "counters": {},   # name -> latest cumulative value (exported at dump)
    "dropped": 0,     # events discarded after the buffer cap was hit
}

# One recorder lock for every ``_state`` touch.  The host plane is fed
# from concurrent threads (the serving engine, the router's waiters,
# client threads bumping ``fault::*`` / ``serve::*`` counters) and the
# counter path is a read-modify-write, which loses updates unlocked.
# Reentrant because _append -> _write_trace (continuous_dump) and
# dump -> set_state re-enter on the same thread.
_rec_lock = threading.RLock()


def _append(ev):
    """Bounded event buffer.  At ``max_events`` (config, default 1M): with
    ``continuous_dump`` the buffer is snapshotted to ``filename`` and
    cleared (a long run keeps its tail on disk and totals in the
    aggregate table); otherwise new events are dropped and counted."""
    with _rec_lock:
        events = _state["events"]
        if len(events) >= _state["config"].get("max_events", 1000000):
            if _state["config"].get("continuous_dump"):
                _write_trace(_state["config"].get("filename",
                                                  "profile.json"))
                events.clear()
            else:
                _state["dropped"] += 1
                return
        events.append(ev)

# -- fast gating flags (one attribute read on the instrumented hot path) --
_IMPERATIVE = False   # per-op dispatch timing in ndarray.apply_op
_STEP = False         # Trainer phases, Block forward, autograd backward
_KVSTORE = False      # KVStore byte/time counters
_DATA = False         # DataLoader / DataIter throughput
_MEMORY = False       # device memory_stats() counter sampling


def _recompute_flags():
    global _IMPERATIVE, _STEP, _KVSTORE, _DATA, _MEMORY
    with _rec_lock:
        cfg = _state["config"]
        base = _state["running"] and not _state["paused"]
        all_ = cfg.get("profile_all", False)
        _IMPERATIVE = base and (all_ or cfg.get("profile_imperative",
                                                True))
        _STEP = _IMPERATIVE
        _KVSTORE = base and (all_ or cfg.get("profile_kvstore", True))
        _DATA = base and (all_ or cfg.get("profile_data", True))
        _MEMORY = base and (all_ or cfg.get("profile_memory", False))


def _recording():
    """Host trace-plane gate for user scopes."""
    with _rec_lock:
        return _state["running"] and not _state["paused"]


# ----------------------------------------------------------------------
# recorder primitives (used by framework seams and user scopes)
# ----------------------------------------------------------------------
def record_duration(name, cat, ts_us, dur_us, args=None):
    """Append a complete (``ph:"X"``) event with a real begin timestamp."""
    with _rec_lock:
        _append(("X", name, cat, ts_us, dur_us, threading.get_ident(),
                 args))
        entry = _state["agg"][name]
        entry[0] += 1
        entry[1] += dur_us * 1e-6


def record_counter(name, value, cat="counter"):
    """Append a ``ph:"C"`` counter sample at the current timestamp."""
    with _rec_lock:
        _state["counters"][name] = value
        _append(("C", name, cat, _now_us(), value))


def counter_add(name, delta, cat="counter"):
    """Bump a cumulative counter and emit its new value as a C event.
    The read-modify-write runs under the recorder lock: counters are
    bumped from heartbeat/poller/worker threads concurrently with the
    step loop, and an unlocked bump loses updates."""
    with _rec_lock:
        value = _state["counters"].get(name, 0) + delta
        _state["counters"][name] = value
        _append(("C", name, cat, _now_us(), value))
        return value


def counter_bump(name, delta, cat="counter"):
    """Like :func:`counter_add`, but the trace event is only emitted
    while the profiler is recording — the cumulative value updates
    regardless.  For always-on subsystems (``mx.fault`` recovery
    actions) that must count even when nobody asked for a trace."""
    with _rec_lock:
        value = _state["counters"].get(name, 0) + delta
        _state["counters"][name] = value
        if _recording():
            _append(("C", name, cat, _now_us(), value))
        return value


def record_instant(name, cat="instant", args=None):
    _append(("i", name, cat, _now_us(), args))


def get_counters():
    """Snapshot of cumulative counter values (bytes moved, batches, ...).
    The fault runtime (``mx.fault``) publishes its recovery actions here
    under the ``fault::`` prefix: ``retries``, ``gave_up``, ``injected``,
    ``nonfinite_steps``, ``checkpoint_fallbacks``, ``worker_restarts``,
    ``preemptions``."""
    with _rec_lock:
        return dict(_state["counters"])


def get_counter(name, default=0):
    """Current value of one cumulative counter (``default`` if it never
    moved) — the cheap probe used by tests and ``tools/chaos_check.py``
    to assert that a defense engaged."""
    with _rec_lock:
        return _state["counters"].get(name, default)


def record_memory(tag="step"):
    """Sample every card's allocated and peak-allocated bytes into
    counter events (``memory::cuda_<i>::bytes_in_use`` /
    ``peak_bytes_in_use``, the reference's names); nothing without a
    card.  Only called by instrumented seams when ``_MEMORY`` is set."""
    import torch
    if not torch.cuda.is_available():
        return
    for i in range(torch.cuda.device_count()):
        for key, fn in (("bytes_in_use", torch.cuda.memory_allocated),
                        ("peak_bytes_in_use",
                         torch.cuda.max_memory_allocated)):
            record_counter("memory::cuda_%d::%s" % (i, key), int(fn(i)),
                           cat="memory")


def _start_device_trace():
    """A running ``torch.profiler.profile`` (CUDA activity when a card
    is present)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False)
    prof.__enter__()
    return prof


# ----------------------------------------------------------------------
# reference API
# ----------------------------------------------------------------------
def set_config(**kwargs):
    """The reference's knobs; ``filename`` determines both the JSON path
    and the device trace's directory.  Extra knobs, as in the JAX
    package: ``profile_kvstore``, ``profile_data``."""
    with _rec_lock:
        _state["config"].update(kwargs)
        _recompute_flags()


def set_state(state="stop", profile_process="worker"):
    """``'run'`` starts both planes (the device trace's directory is
    ``<filename stem>_trace``), ``'stop'`` stops them; the device trace
    is written at :func:`dump`."""
    with _rec_lock:
        if state == "run":
            if not _state["running"]:
                trace_dir = os.path.splitext(
                    _state["config"].get("filename", "profile.json"))[0] \
                    + "_trace"
                os.makedirs(trace_dir, exist_ok=True)
                _state["trace_dir"] = trace_dir
                _state["device_prof"] = _start_device_trace()
                _state["running"] = True
        elif state == "stop":
            if _state["running"]:
                prof = _state["device_prof"]
                if prof is not None:
                    prof.__exit__(None, None, None)
                _state["running"] = False
        else:
            raise ValueError("state must be 'run' or 'stop'")
        _recompute_flags()


def state():
    with _rec_lock:
        return "run" if _state["running"] else "stop"


def pause(profile_process="worker"):
    """Suspend recording: scopes entered while paused land in neither the
    trace nor the aggregate table (reference ``MXProfilePause``)."""
    with _rec_lock:
        _state["paused"] = True
        _recompute_flags()


def resume(profile_process="worker"):
    with _rec_lock:
        _state["paused"] = False
        _recompute_flags()


def dump(finished=True, profile_process="worker"):
    """Write the host-plane chrome://tracing JSON to ``filename`` and,
    once the device trace has stopped, its chrome trace into
    ``trace_dir`` (``device.json``)."""
    with _rec_lock:
        if _state["running"] and finished:
            set_state("stop")
        fn = _state["config"].get("filename", "profile.json")
        prof = None
        if not _state["running"]:
            prof, _state["device_prof"] = _state["device_prof"], None
        trace_dir = _state["trace_dir"]
    if prof is not None and trace_dir is not None:
        prof.export_chrome_trace(os.path.join(trace_dir, "device.json"))
    _write_trace(fn)
    return fn


def _write_trace(fn):
    # Snapshot under the lock, serialize and write OUTSIDE it: holding
    # _rec_lock across a megabyte JSON dump would stall every always-on
    # counter bump (heartbeat, poller, a preemption autosave) for the
    # write's duration.  The continuous_dump caller in _append already
    # holds the RLock, so its snapshot+clear stays atomic there.
    with _rec_lock:
        events = list(_state["events"])
        counters = dict(_state["counters"])
        dropped = _state["dropped"]
        trace_dir = _state["trace_dir"]
    pid = os.getpid()
    trace_events = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": "mxnet_tpu worker"}},
    ]
    for ev in sorted(events, key=lambda e: e[3]):
        if ev[0] == "X":
            _, name, cat, ts, dur, tid, args = ev
            rec = {"name": name, "cat": cat, "ph": "X", "ts": ts,
                   "dur": dur, "pid": pid, "tid": tid}
            if args:
                rec["args"] = args
            trace_events.append(rec)
        elif ev[0] == "C":
            _, name, cat, ts, value = ev
            trace_events.append(
                {"name": name, "cat": cat, "ph": "C", "ts": ts,
                 "pid": pid, "args": {"value": value}})
        else:
            _, name, cat, ts, args = ev
            rec = {"name": name, "cat": cat, "ph": "i", "ts": ts,
                   "pid": pid, "tid": 0, "s": "g"}
            if args:
                rec["args"] = args
            trace_events.append(rec)
    # final value of every cumulative counter, so a counter that last
    # moved before the dump still shows on the track end
    ts_end = _now_us()
    for name, value in sorted(counters.items()):
        trace_events.append(
            {"name": name, "cat": "counter", "ph": "C", "ts": ts_end,
             "pid": pid, "args": {"value": value}})
    if dropped:
        trace_events.append(
            {"name": "profiler::dropped_events", "cat": "counter",
             "ph": "C", "ts": ts_end, "pid": pid,
             "args": {"value": dropped}})
    from .utils.serialization import atomic_write
    d = os.path.dirname(fn)
    if d:
        os.makedirs(d, exist_ok=True)
    with atomic_write(fn, "w") as f:
        json.dump({
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            # the reference's key (readers look for it), here the
            # directory of the torch.profiler chrome trace
            "xla_trace_dir": trace_dir,
        }, f)


def dumps(reset=False, format="table"):  # noqa: A002
    """Aggregate stats table (profiler.py:154 / aggregate_stats.cc)."""
    with _rec_lock:
        lines = ["%-40s %10s %14s %14s" % ("Name", "Calls", "Total(ms)",
                                           "Avg(ms)")]
        for name, (count, total) in sorted(_state["agg"].items()):
            lines.append("%-40s %10d %14.3f %14.3f"
                         % (name, count, total * 1e3,
                            total * 1e3 / max(count, 1)))
        if _state["counters"]:
            lines.append("%-40s %10s" % ("Counter", "Value"))
            for name, value in sorted(_state["counters"].items()):
                lines.append("%-40s %10s" % (name, value))
        if reset:
            _state["agg"].clear()
            _state["counters"].clear()
            _state["events"].clear()
            _state["dropped"] = 0
        return "\n".join(lines)


def reset():
    """Drop all recorded events, aggregates and counters."""
    with _rec_lock:
        _state["agg"].clear()
        _state["counters"].clear()
        _state["events"].clear()
        _state["dropped"] = 0


class _Scope:
    """Timed scope, also a ``torch.profiler.record_function`` range on
    the device trace.

    The aggregate table is fed whenever the profiler is not paused;
    trace events additionally require the profiler to be running.  Both
    decisions are latched at ``__enter__``, so a pause mid-scope keeps
    the reference's semantics."""

    def __init__(self, name, cat="scope"):
        self._name = name
        self._cat = cat
        self._ann = None
        self._rec = False
        self._agg = False

    def __enter__(self):
        with _rec_lock:
            self._agg = not _state["paused"]
            self._rec = self._agg and _state["running"]
        self._t0 = _now_us()
        if self._rec:
            from torch.profiler import record_function
            self._ann = record_function(self._name)
            self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if not self._agg:
            return
        t1 = _now_us()
        if self._rec:
            record_duration(self._name, self._cat, self._t0, t1 - self._t0)
        else:
            with _rec_lock:
                entry = _state["agg"][self._name]
                entry[0] += 1
                entry[1] += (t1 - self._t0) * 1e-6


class Domain:
    """Profiler domain (profiler.py:228)."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class Task(_Scope):
    def __init__(self, domain, name):
        super().__init__("%s::%s" % (domain.name, name), cat="task")
        self.domain = domain
        self.name = name

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


class Frame(_Scope):
    def __init__(self, domain, name):
        super().__init__("%s::%s" % (domain.name, name), cat="frame")

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


class Event(_Scope):
    def __init__(self, name):
        super().__init__(name, cat="event")

    def start(self):
        self.__enter__()

    def stop(self):
        self.__exit__(None, None, None)


class Counter:
    """User counter — every mutation records a ``ph:"C"`` sample when the
    profiler is running (reference ``profiler.h`` CounterStat)."""

    def __init__(self, domain, name, value=None):
        self.name = "%s::%s" % (domain.name, name)
        self.value = value or 0
        self._publish()

    def _publish(self):
        with _rec_lock:
            _state["counters"][self.name] = self.value
            if _recording():
                _append(("C", self.name, "counter", _now_us(),
                         self.value))

    def set_value(self, value):
        with _rec_lock:
            self.value = value
            self._publish()

    def increment(self, delta=1):
        # RMW under the recorder lock — same lost-update class as
        # counter_add (the _publish-only lock would just publish an
        # already-torn value)
        with _rec_lock:
            self.value += delta
            self._publish()

    def decrement(self, delta=1):
        with _rec_lock:
            self.value -= delta
            self._publish()

    def __iadd__(self, v):
        self.increment(v)
        return self

    def __isub__(self, v):
        self.decrement(v)
        return self


class Marker:
    def __init__(self, domain, name):
        self.name = "%s::%s" % (domain.name, name)

    def mark(self, scope="process"):
        with _rec_lock:
            entry = _state["agg"]["marker::" + self.name]
            entry[0] += 1
            if _recording():
                record_instant(self.name, cat="marker")


def annotate(name):
    """A scope on the host plane and the device trace."""
    return _Scope(name)


# reference parity: MXNET_PROFILER_AUTOSTART starts the profiler in the
# `run` state at library load and dumps on process exit
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") not in ("", "0",
                                                           "false", "False"):
    set_state("run")
    atexit.register(dump)
