"""fault -- the fault-tolerance runtime's injection and retry core.

Counterpart of ``mxnet_tpu/fault.py`` (its :1-520 and the checksum
manifests), standard library only:

**Defenses**
- :func:`retry_call` / :class:`RetryPolicy` -- exponential backoff with
  jitter and an optional per-attempt timeout; wrapped around the
  kvstore's push / pull / pushpull / broadcast.  Emits ``fault::retries``
  / ``fault::gave_up`` profiler counters.
- checksum manifests (:func:`write_manifest` / :func:`verify_manifest`)
  so a resume can detect a torn checkpoint.

**Offense** -- a deterministic fault-injection harness the tests use to
prove every defense fires: :func:`inject` arms a fault
programmatically; ``MXNET_FAULT_SPEC`` arms them from the environment.
Spec DSL (``;``-separated)::

    kind[@N][:key=val[:key=val...]]

    kvstore_fail@3:count=2         fail the 3rd and 4th kvstore ops
    kvstore_fail:prob=0.1:seed=7   seeded probabilistic failures
    collective_fail@1              fail the 1st collective
    checkpoint_truncate@1          tear the 1st checkpoint after it is saved
    serve_engine_kill@1            kill a serving engine thread
    serve_decode_fail@2[:op=fatal] fail the 2nd decode commit
    serve_slow_decode:op=0.2       stall each decode commit 0.2 s

    nan_grad@2                     NaN the first fresh gradient at the
                                   2nd Trainer.step

A JSON list of ``{"kind": ..., "at": ..., ...}`` objects is accepted
too.  All randomness is seeded (``seed=`` per fault).  The kinds of the
reference's training and multi-host seams parse and arm here as there.

**The non-finite gradient guard** (reference :660-716):
:func:`grads_finite` checks a parameter list's gradients with one
``multi_all_finite`` kernel launch on the card and one host sync;
:class:`GradGuard` makes every step of a Trainer skip a non-finite
batch (``Trainer.step(skip_nonfinite=True)`` for one step), counting
``fault::nonfinite_steps``; :func:`step_hook`, the Trainer's step seam,
delivers ``nan_grad``.  Its ``preempt`` and ``peer_preempt`` kinds, the
dataloader's seam, ``PreemptionHandler``, ``on_preemption``,
``load_snapshot`` and the elastic state wait for ROADMAP queue 4 and
raise ``NotImplementedError``.

Retry knobs from the environment: ``MXNET_FAULT_MAX_RETRIES`` (3),
``MXNET_FAULT_BACKOFF`` (0.05s base), ``MXNET_FAULT_BACKOFF_MAX`` (2.0s),
``MXNET_FAULT_JITTER`` (0.5), ``MXNET_FAULT_ATTEMPT_TIMEOUT`` (unset).
"""
from __future__ import annotations

import hashlib
import json
import os
import random as _random
import threading
import time
from collections import defaultdict

from . import flightrec as _flightrec
from . import profiler as _profiler

__all__ = [
    "FaultError", "TransientError", "InjectedFault", "CorruptCheckpointError",
    "InjectedXlaError",
    "RetryPolicy", "retry_call", "default_policy", "entry_only_policy",
    "mutating_policy", "inject", "clear", "parse_spec", "active", "stats",
    "check", "kvstore_check", "collective_check", "serve_engine_check",
    "serve_decode_check", "checkpoint_hook",
    "file_sha256", "write_manifest", "verify_manifest",
    "GradGuard", "grads_finite", "step_hook",
    "PreemptionHandler", "on_preemption", "load_snapshot",
    "save_elastic_state", "load_elastic_state",
]


# ----------------------------------------------------------------------
# exceptions
# ----------------------------------------------------------------------
class FaultError(RuntimeError):
    """Base class for fault-runtime errors."""


class TransientError(FaultError):
    """An error worth retrying (network blip, preempted collective)."""


class InjectedFault(TransientError):
    """Raised by the injection harness at an armed seam."""


class CorruptCheckpointError(FaultError):
    """A checkpoint file failed integrity verification or deserialization."""


# ----------------------------------------------------------------------
# retry with exponential backoff + jitter
# ----------------------------------------------------------------------
class RetryPolicy:
    """Backoff schedule: ``min(max_delay, base * 2**(attempt-1))`` scaled
    by ``1 + jitter*rand``; all knobs default from the environment so a
    fleet-wide config needs no code change."""

    def __init__(self, max_retries=None, base_delay=None, max_delay=None,
                 jitter=None, timeout=None, retry_on=None, seed=None):
        env = os.environ
        self.max_retries = int(env.get("MXNET_FAULT_MAX_RETRIES", "3")) \
            if max_retries is None else max_retries
        self.base_delay = float(env.get("MXNET_FAULT_BACKOFF", "0.05")) \
            if base_delay is None else base_delay
        self.max_delay = float(env.get("MXNET_FAULT_BACKOFF_MAX", "2.0")) \
            if max_delay is None else max_delay
        self.jitter = float(env.get("MXNET_FAULT_JITTER", "0.5")) \
            if jitter is None else jitter
        if timeout is None:
            t = env.get("MXNET_FAULT_ATTEMPT_TIMEOUT", "")
            timeout = float(t) if t else None
        # False/0 mean "explicitly no deadline", distinct from None
        # ("use the env default")
        self.timeout = timeout or None
        self.retry_on = tuple(retry_on) if retry_on else \
            (TransientError, ConnectionError, TimeoutError)
        self._rng = _random.Random(seed)

    def delay(self, attempt):
        d = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        return d * (1.0 + self.jitter * self._rng.random())


_default_policy = None
_entry_only_policy = None
# lazy policy singletons are created from whichever thread first retries:
# the lock keeps first use from two threads producing two policy objects
_policy_lock = threading.Lock()


def default_policy():
    global _default_policy
    with _policy_lock:
        if _default_policy is None:
            _default_policy = RetryPolicy()
        return _default_policy


def entry_only_policy():
    """Policy for non-idempotent ops: retries only entry-seam
    :class:`InjectedFault` (raised before any state mutation) and never
    uses a per-attempt timeout — a mid-op transient failure must surface
    to the caller rather than re-run the mutation."""
    global _entry_only_policy
    with _policy_lock:
        if _entry_only_policy is None:
            _entry_only_policy = RetryPolicy(retry_on=(InjectedFault,),
                                             timeout=False)
        return _entry_only_policy


_mutating_policy = None


def mutating_policy():
    """Policy for idempotent-but-mutating ops (a re-run converges to the
    same state): full transient retry, but never a per-attempt timeout —
    a timed-out attempt's abandoned thread would keep running and race
    its own retry on the shared state."""
    global _mutating_policy
    with _policy_lock:
        if _mutating_policy is None:
            _mutating_policy = RetryPolicy(timeout=False)
        return _mutating_policy


def _call_with_timeout(fn, args, kwargs, timeout, op):
    """Run ``fn`` with a per-attempt deadline.  The attempt runs in a
    daemon thread; a timed-out attempt is abandoned (its thread keeps
    running — acceptable for idempotent communication ops) and reported
    as :class:`TimeoutError` so the policy can retry it."""
    result = {}
    done = threading.Event()

    def run():
        try:
            result["value"] = fn(*args, **kwargs)
        # captured verbatim and re-raised by the waiter below
        except BaseException as e:  # noqa: BLE001 — re-raised in caller
            result["error"] = e
        finally:
            done.set()

    th = threading.Thread(target=run, daemon=True,
                          name="fault-attempt-%s" % (op or "call"))
    th.start()
    if not done.wait(timeout):
        raise TimeoutError("%s did not complete within %.2fs"
                           % (op or getattr(fn, "__name__", "call"), timeout))
    if "error" in result:
        raise result["error"]
    return result.get("value")


def retry_call(fn, *args, policy=None, op=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient failures under
    ``policy`` (default: env-configured :func:`default_policy`).  Every
    retry bumps ``fault::retries``; exhausting the budget bumps
    ``fault::gave_up`` and re-raises the last error."""
    policy = policy or default_policy()
    failures = 0
    while True:
        try:
            if policy.timeout is not None:
                return _call_with_timeout(fn, args, kwargs, policy.timeout,
                                          op)
            return fn(*args, **kwargs)
        except policy.retry_on:
            failures += 1
            if failures > policy.max_retries:
                _profiler.counter_bump("fault::gave_up", 1, cat="fault")
                raise
            _profiler.counter_bump("fault::retries", 1, cat="fault")
            if _profiler._recording():
                _profiler.record_instant(
                    "fault::retry::%s"
                    % (op or getattr(fn, "__name__", "call")), cat="fault")
            time.sleep(policy.delay(failures))


# ----------------------------------------------------------------------
# fault injection harness
# ----------------------------------------------------------------------
# kind -> seam it fires at
KINDS = {
    "nan_grad": "step",
    "preempt": "step",
    "kvstore_fail": "kvstore",
    "collective_fail": "collective",
    "worker_kill": "dataloader",
    "checkpoint_truncate": "checkpoint",
    # multi-host seams (mx.fault.dist)
    "dist_bootstrap_fail": "dist_bootstrap",
    "peer_hang": "heartbeat",
    "maintenance_event": "maintenance",
    # hard preemption (mx.fault.elastic): SIGKILL, no autosave window
    "peer_preempt": "step",
    # grow offense (mx.fault.elastic): at this worker's N-th step, post
    # a join record on the vote board AS IF a replacement rank arrived
    # (the chaos grow phase uses a real relaunched process instead;
    # this kind drives single-process tests of the same trigger path)
    "peer_join": "step",
    # serving seams (mx.serve / mx.serve_router): kill an engine
    # thread outright, fail a decode step (op=transient|fatal rides
    # classify_xla_error semantics), or stall a decode step
    # (op=<seconds>) to exercise deadline/shed paths
    "serve_engine_kill": "serve_engine",
    "serve_decode_fail": "serve_decode",
    "serve_slow_decode": "serve_decode",
}

_ACTIVE = False          # fast gate read by the instrumented seams
# process-wide step heartbeat (the reference's fault_dist installs it;
# the port's heartbeat waits for ROADMAP queue 4, so it stays None and
# telemetry.enable_fleet_telemetry needs an explicit heartbeat)
_DIST_HEARTBEAT = None
_faults = []
# RLock, as in the reference (a signal handler may re-enter it)
_fault_lock = threading.RLock()
_fired_stats = defaultdict(int)


class _Fault:
    """One armed fault: fires at the ``at``-th matching seam event (and
    the next ``count-1`` after it), or per-event with probability
    ``prob`` (seeded)."""

    def __init__(self, kind, at=1, count=None, prob=None, seed=None,
                 op=None):
        if kind not in KINDS:
            raise ValueError("unknown fault kind %r (known: %s)"
                             % (kind, ", ".join(sorted(KINDS))))
        self.kind = kind
        self.site = KINDS[kind]
        self.at = int(at)
        if count is None:
            # deterministic faults fire once by default; probabilistic
            # ones keep firing per-event (that is what prob= means)
            count = 1 if prob is None else float("inf")
        self.count = count if count == float("inf") else int(count)
        self.prob = None if prob is None else float(prob)
        self.op = op
        self.rng = _random.Random(0 if seed is None else int(seed))
        self.seen = 0
        self.fired = 0

    def should_fire(self, site, ctx):
        if site != self.site:
            return False
        if self.op is not None and ctx.get("op") != self.op:
            return False
        self.seen += 1
        if self.fired >= self.count:
            return False
        if self.prob is not None:
            fire = self.rng.random() < self.prob
        else:
            fire = self.seen >= self.at
        if fire:
            self.fired += 1
        return fire

    def __repr__(self):
        return "_Fault(%s@%d:count=%s%s%s fired=%d/%s)" % (
            self.kind, self.at, self.count,
            ":prob=%g" % self.prob if self.prob is not None else "",
            ":op=%s" % self.op if self.op else "", self.fired, self.count)


def _recompute_active():
    global _ACTIVE
    _ACTIVE = any(f.fired < f.count for f in _faults)


def inject(kind, at=1, count=None, prob=None, seed=None, op=None):
    """Arm a fault; returns its handle (``.fired`` counts deliveries).
    Deterministic faults (no ``prob``) fire once unless ``count`` says
    otherwise; probabilistic faults fire per matching event until
    cleared.  ``mx.fault.clear()`` disarms everything."""
    f = _Fault(kind, at=at, count=count, prob=prob, seed=seed, op=op)
    with _fault_lock:
        _faults.append(f)
        _recompute_active()
    return f


def clear():
    """Disarm all faults (programmatic and env-spec) and reset stats."""
    with _fault_lock:
        del _faults[:]
        _fired_stats.clear()
        _recompute_active()


def active():
    """True when at least one armed fault can still fire."""
    return _ACTIVE


def stats():
    """``{kind: times fired}`` for all faults delivered so far."""
    with _fault_lock:
        return dict(_fired_stats)


def parse_spec(text):
    """Parse ``MXNET_FAULT_SPEC`` (mini-DSL or JSON) into kwargs dicts
    suitable for :func:`inject`."""
    text = (text or "").strip()
    if not text:
        return []
    if text[0] in "[{":
        obj = json.loads(text)
        entries = obj if isinstance(obj, list) else [obj]
        return [dict(e) for e in entries]
    out = []
    for entry in text.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, _, tail = entry.partition(":")
        kind, _, at = head.partition("@")
        spec = {"kind": kind.strip()}
        if at:
            spec["at"] = int(at)
        for kv in filter(None, tail.split(":")):
            k, _, v = kv.partition("=")
            k = k.strip()
            if k in ("at", "count", "seed"):
                spec[k] = int(v)
            elif k == "prob":
                spec[k] = float(v)
            else:
                spec[k] = v.strip()
        out.append(spec)
    return out


def _load_env_spec():
    for spec in parse_spec(os.environ.get("MXNET_FAULT_SPEC", "")):
        inject(**spec)


def check(site, **ctx):
    """Seam entry point: returns the armed faults firing at this event
    (empty when the harness is idle — one module-flag read)."""
    if not _ACTIVE:
        return []
    with _fault_lock:
        fired = [f for f in _faults if f.should_fire(site, ctx)]
        for f in fired:
            _fired_stats[f.kind] += 1
        _recompute_active()
    for f in fired:
        _profiler.counter_bump("fault::injected", 1, cat="fault")
        _profiler.counter_bump("fault::injected::%s" % f.kind, 1, cat="fault")
        _flightrec.record("fault.injected", fault=f.kind, site=site,
                          op=str(ctx.get("op")) if ctx.get("op") else None)
    return fired


# -- seam helpers (called by kvstore/trainer/dataloader/checkpoint) -------
def kvstore_check(op):
    """Raise :class:`InjectedFault` when a ``kvstore_fail`` fault fires."""
    if _ACTIVE and check("kvstore", op=op):
        raise InjectedFault("injected kvstore failure (op=%s)" % op)


def collective_check(op):
    if _ACTIVE and check("collective", op=op):
        raise InjectedFault("injected collective failure (op=%s)" % op)


class InjectedXlaError(RuntimeError):
    """An injected device-runtime failure whose *class name* reads as
    ``XlaRuntimeError``, the reference's contract, so
    ``fault_dist.classify_xla_error`` (which matches the MRO by class
    name) sorts it by message marker, transient vs fatal, like a real
    decode failure."""


InjectedXlaError.__name__ = "XlaRuntimeError"


def _check_flavored(site):
    """Like :func:`check` but for sites whose *kind/op carries the
    flavor* rather than filtering the call site: each armed fault is
    offered its OWN ``op`` as the ctx, so the seen/at/count bookkeeping
    advances identically for every flavor without the caller having to
    probe once per flavor (which would double-count ``seen`` and break
    ``at=`` semantics)."""
    if not _ACTIVE:
        return []
    with _fault_lock:
        fired = [f for f in _faults if f.should_fire(site, {"op": f.op})]
        for f in fired:
            _fired_stats[f.kind] += 1
        _recompute_active()
    for f in fired:
        _profiler.counter_bump("fault::injected", 1, cat="fault")
        _profiler.counter_bump("fault::injected::%s" % f.kind, 1, cat="fault")
        _flightrec.record("fault.injected", fault=f.kind, site=site,
                          op=str(f.op) if f.op else None)
    return fired


def serve_engine_check(op=None):
    """Serve engine-loop seam: a ``serve_engine_kill`` fault kills the
    engine thread (the replica-death offense ``ReplicaGroup`` defends
    against)."""
    if _ACTIVE and check("serve_engine", op=op):
        raise InjectedFault("injected serve engine death (op=%s)" % op)


def serve_decode_check():
    """Serve decode-commit seam: ``serve_decode_fail`` raises an
    :class:`InjectedXlaError` whose message classifies transient
    (default) or fatal (``:op=fatal``); ``serve_slow_decode`` sleeps
    ``op`` seconds (default 0.05) to simulate a straggling device."""
    for f in _check_flavored("serve_decode"):
        if f.kind == "serve_slow_decode":
            try:
                delay = float(f.op) if f.op else 0.05
            except (TypeError, ValueError):
                delay = 0.05
            time.sleep(delay)
        elif f.kind == "serve_decode_fail":
            if f.op == "fatal":
                raise InjectedXlaError(
                    "injected decode failure: RESOURCE_EXHAUSTED: out of "
                    "memory allocating decode scratch "
                    "(serve_decode_fail:op=fatal)")
            raise InjectedXlaError(
                "injected decode failure: UNAVAILABLE: connection reset "
                "by peer (serve_decode_fail)")


def checkpoint_hook(path):
    """Post-save seam: tear the just-written checkpoint when armed."""
    for _ in check("checkpoint"):
        _truncate_file(path)


def _truncate_file(path):
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    # the checkpoint_truncate fault: this write tears the file on purpose
    with open(path, "r+b") as fh:
        fh.truncate(max(1, size // 2))


# ----------------------------------------------------------------------
# checksum manifests (torn-checkpoint detection)
# ----------------------------------------------------------------------
def file_sha256(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _atomic_write_bytes(path, payload):
    from .utils.serialization import atomic_write
    with atomic_write(path) as f:
        f.write(payload)


def write_manifest(path, files, extra=None):
    """Atomically write a JSON manifest with sha256+size of ``files``
    (paths are stored relative to the manifest's directory)."""
    base = os.path.dirname(os.path.abspath(path))
    manifest = {"version": 1, "time": time.time(), "files": {}}
    for f in files:
        if not os.path.exists(f):
            continue
        rel = os.path.relpath(os.path.abspath(f), base)
        manifest["files"][rel] = {"sha256": file_sha256(f),
                                  "bytes": os.path.getsize(f)}
    if extra:
        manifest.update(extra)
    _atomic_write_bytes(path, json.dumps(manifest, indent=1).encode())
    return manifest


def verify_manifest(path, only=None):
    """Returns ``(ok, bad_files)``: every listed file must exist with a
    matching size and sha256.  An unreadable manifest is itself bad.
    ``only`` (iterable of basenames) restricts verification to those
    entries — e.g. a params-only deployment verifies just the ``.params``
    file even though the manifest also lists trainer states."""
    base = os.path.dirname(os.path.abspath(path))
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read().decode())
        entries = manifest["files"]
    except (OSError, ValueError, KeyError, UnicodeDecodeError):
        return False, [path]
    if only is not None:
        wanted = set(only)
        entries = {rel: v for rel, v in entries.items()
                   if os.path.basename(rel) in wanted}
    bad = []
    for rel, want in entries.items():
        p = os.path.join(base, rel)
        if not os.path.exists(p) or os.path.getsize(p) != want["bytes"] \
                or file_sha256(p) != want["sha256"]:
            bad.append(p)
    return not bad, bad


# ----------------------------------------------------------------------
# the training step's seam and the non-finite gradient guard
# ----------------------------------------------------------------------
def _queue4(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            "fault.%s is not ported yet (ROADMAP queue 4: preemption and "
            "the elastic state)" % name)
    stub.__name__ = name
    return stub


def step_hook(trainer):
    """Trainer.step entry: deliver armed step-site faults (``nan_grad``;
    ``preempt`` / ``peer_preempt`` raise, ROADMAP queue 4)."""
    for f in check("step"):
        if f.kind == "nan_grad":
            _corrupt_grads(trainer)
        elif f.kind in ("preempt", "peer_preempt"):
            raise NotImplementedError(
                "fault %s is not ported yet (ROADMAP queue 4: preemption "
                "and the elastic state)" % f.kind)


def _grads(params):
    """The floating-point gradients of the trainable ``params``."""
    out = []
    for p in params:
        if getattr(p, "grad_req", "write") == "null" or \
                not getattr(p, "requires_grad", True):
            continue
        g = getattr(p, "grad", None)
        if g is not None and g.is_floating_point():
            out.append(g)
    return out


def _corrupt_grads(trainer):
    """Overwrite the first fresh floating-point gradient with NaN."""
    grads = _grads(trainer._params)
    if not grads:
        return False
    grads[0].fill_(float("nan"))
    return True


def grads_finite(params):
    """Whether every gradient of ``params`` is finite: one
    ``multi_all_finite`` kernel launch over all of them on the card (the
    plain check on the CPU), each in its own dtype, then one host sync
    (the reference reduces on the device and syncs once the same way)."""
    from .ops.multi_tensor import multi_all_finite
    grads = _grads(params)
    if not grads:
        return True
    return bool(multi_all_finite(grads, narrow=False).item())


class GradGuard:
    """Attach to a Trainer so every step behaves as
    ``step(..., skip_nonfinite=True)``: a non-finite gradient batch skips
    the optimizer update (weights untouched), backs off the AMP loss
    scale when one is attached, and counts ``fault::nonfinite_steps``.
    ``max_consecutive`` bounds silent divergence: that many back-to-back
    skips raises instead of looping forever."""

    def __init__(self, trainer=None, max_consecutive=100):
        self.skipped = 0
        self.consecutive = 0
        self.max_consecutive = max_consecutive
        self._trainer = None
        if trainer is not None:
            self.attach(trainer)

    def attach(self, trainer):
        trainer._grad_guard = self
        self._trainer = trainer
        return self

    def detach(self):
        if self._trainer is not None and \
                getattr(self._trainer, "_grad_guard", None) is self:
            self._trainer._grad_guard = None
        self._trainer = None

    def _record_skip(self):
        self.skipped += 1
        self.consecutive += 1
        if self.consecutive >= self.max_consecutive:
            raise FaultError(
                "GradGuard: %d consecutive non-finite gradient steps -- "
                "training is diverging, not recovering" % self.consecutive)

    def _record_ok(self):
        self.consecutive = 0


# the preemption / elastic half of the reference module
dataloader_hook = _queue4("dataloader_hook")
preempt_handler = _queue4("preempt_handler")
PreemptionHandler = _queue4("PreemptionHandler")
on_preemption = _queue4("on_preemption")
load_snapshot = _queue4("load_snapshot")
save_elastic_state = _queue4("save_elastic_state")
load_elastic_state = _queue4("load_elastic_state")


def __getattr__(name):
    # mx.fault.dist: the ported part of the multi-host layer (the error
    # classifier); mx.fault.elastic waits for ROADMAP queue 4
    if name == "dist":
        from . import fault_dist as dist
        globals()["dist"] = dist
        return dist
    if name == "elastic":
        raise NotImplementedError(
            "fault.elastic is not ported yet (ROADMAP queue 4)")
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))


_load_env_spec()
