"""fault -- the fault-tolerance runtime's injection and retry core.

Counterpart of ``mxnet_tpu/fault.py``:

**Defenses**
- :func:`retry_call` / :class:`RetryPolicy` -- exponential backoff with
  jitter and an optional per-attempt timeout; wrapped around the
  kvstore's push / pull / pushpull / broadcast.  Emits ``fault::retries``
  / ``fault::gave_up`` profiler counters.
- checksum manifests (:func:`write_manifest` / :func:`verify_manifest`)
  so a resume can detect a torn checkpoint.
- the non-finite gradient guard and the preemption autosave (below).

**Offense** -- a deterministic fault-injection harness the tests use to
prove every defense fires: :func:`inject` arms a fault programmatically;
``MXNET_FAULT_SPEC`` arms them from the environment.  Spec DSL
(``;``-separated)::

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
    preempt@5                      deliver a simulated preemption on step 5
    worker_kill@1                  SIGKILL a dataloader pool worker
    dist_bootstrap_fail@1          fail the 1st process-group bootstrap
    peer_hang@2                    hang this worker's 2nd heartbeat past
                                   its peers' timeout
    maintenance_event@1            deliver a TERMINATE maintenance notice
    peer_preempt@6                 SIGKILL this worker at its 6th step (a
                                   hard preemption: no notice, no autosave)
    peer_join@3                    post a join record at the 3rd step, as
                                   if a replacement rank arrived

A JSON list of ``{"kind": ..., "at": ..., ...}`` objects is accepted
too.  All randomness is seeded (``seed=`` per fault).

**The non-finite gradient guard** (reference :660-716):
:func:`grads_finite` checks a parameter list's gradients with one
``multi_all_finite`` kernel launch on the card and one host sync;
:class:`GradGuard` makes every step of a Trainer skip a non-finite
batch (``Trainer.step(skip_nonfinite=True)`` for one step), counting
``fault::nonfinite_steps``; :func:`step_hook`, the Trainer's step seam,
delivers ``nan_grad``, ``preempt`` (the autosave below) and
``peer_preempt`` (SIGKILL of this process).

**Preemption** (reference :717-1062): :func:`on_preemption` installs a
:class:`PreemptionHandler` that, on SIGTERM / SIGINT, an injected
``preempt`` or a maintenance notice (``fault_dist.MaintenancePoller``),
writes a new generation of ``Block.save_parameters`` +
``Trainer.save_states`` + host RNG files and swaps a checksummed resume
manifest onto them (``fault::preemptions``); :func:`load_snapshot`
verifies and restores it.  :func:`save_elastic_state` /
:func:`load_elastic_state` keep the elastic runner's step, generation,
world and epoch beside its checkpoint.  The host RNG state is PyTorch's
CPU generator, every CUDA generator that was initialized, numpy's global
state and ``random``'s (the reference keeps numpy's).
:func:`dataloader_hook` is the DataLoader's per-batch seam
(``worker_kill``), duck-typed on the pool's ``_pool`` list of processes.

The multi-host half (coordinated recovery: the resilient bootstrap,
generation-gated collective retry, heartbeats, the step lease,
maintenance notices) is :mod:`mxnet_tpu_torch.fault_dist`, exposed as
``mx.fault.dist``; the elastic half (survive a lost rank by resizing the
job) is :mod:`mxnet_tpu_torch.fault_elastic`, exposed as
``mx.fault.elastic``.

Retry knobs from the environment: ``MXNET_FAULT_MAX_RETRIES`` (3),
``MXNET_FAULT_BACKOFF`` (0.05s base), ``MXNET_FAULT_BACKOFF_MAX`` (2.0s),
``MXNET_FAULT_JITTER`` (0.5), ``MXNET_FAULT_ATTEMPT_TIMEOUT`` (unset).
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import random as _random
import signal as _signal
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
    "GradGuard", "grads_finite", "step_hook", "dataloader_hook",
    "PreemptionHandler", "preempt_handler", "on_preemption",
    "load_snapshot",
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
# process-wide step heartbeat (fault_dist.enable_step_heartbeat installs
# it; Trainer.step / parallel.TrainStep beat it) -- here so the hot step
# path pays one attribute read and no fault_dist import
_DIST_HEARTBEAT = None
# process-wide step lease (fault_dist.enable_step_lease installs it;
# coordinated ops ride it with lease=True).  Read through _step_lease()
# and written through _set_step_lease(): the signal-handler and poller
# preemption paths consult it while the main thread may be enabling or
# disabling lease mode
_STEP_LEASE = None
_faults = []
# RLock, not Lock: PreemptionHandler._on_signal runs on the main thread
# between bytecodes and reaches _step_lease() (this lock); a plain Lock
# would deadlock when SIGTERM lands inside a locked region of that thread
_fault_lock = threading.RLock()
_fired_stats = defaultdict(int)


def _step_lease():
    """The installed process-wide step lease (or None), read under
    ``_fault_lock``."""
    with _fault_lock:
        return _STEP_LEASE


def _set_step_lease(lease):
    global _STEP_LEASE
    with _fault_lock:
        _STEP_LEASE = lease


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
def step_hook(trainer):
    """Trainer.step entry: deliver armed step-site faults."""
    for f in check("step"):
        if f.kind == "nan_grad":
            _corrupt_grads(trainer)
        elif f.kind == "preempt":
            _deliver_preemption()
        elif f.kind == "peer_preempt":
            _hard_preempt()


def _hard_preempt():
    """SIGKILL this worker: the injected form of a hard preemption (no
    notice, no SIGTERM autosave window).  ``mx.fault.elastic`` is the
    defense: the surviving ranks detect the silence and resize the job.
    The black box flushes first."""
    _flightrec.note_terminal("hard_preempt")
    os.kill(os.getpid(), _signal.SIGKILL)


def dataloader_hook(pool):
    """Per-batch-submit seam: SIGKILL one pool worker when armed."""
    for f in check("dataloader"):
        _kill_one_worker(pool, f.rng)


def _kill_one_worker(pool, rng):
    """SIGKILL one process of ``pool._pool`` (a ``multiprocessing``
    pool's worker list), chosen by the fault's seeded ``rng``."""
    procs = list(getattr(pool, "_pool", []) or [])
    if not procs:
        return
    victim = procs[rng.randrange(len(procs))]
    try:
        os.kill(victim.pid, _signal.SIGKILL)
    except (OSError, ProcessLookupError):
        return
    try:
        victim.join(timeout=2.0)
    except (OSError, AssertionError, ValueError):
        pass


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


# ----------------------------------------------------------------------
# preemption-aware autosave
# ----------------------------------------------------------------------
_preempt_handler = None


def preempt_handler():
    """The installed process-wide :class:`PreemptionHandler` (or None),
    read under ``_fault_lock``: the maintenance poller's thread consults
    it while the main thread may be swapping handlers."""
    with _fault_lock:
        return _preempt_handler


def _proc_tag(idx):
    """Per-process filename tag: ``.p<rank>`` in a multi-process job,
    empty with one process (keeps single-process snapshot names)."""
    return "" if idx is None else ".p%d" % int(idx)


def _detect_process_index():
    """This worker's rank for multi-process snapshot names, or None with
    one process: the launcher's ``MX_NUM_WORKERS`` / ``MX_WORKER_ID``
    first (so an autosave before the bootstrap already tells the ranks
    apart), then a live ``torch.distributed`` group of more than one."""
    n = os.environ.get("MX_NUM_WORKERS")
    if n and int(n) > 1:
        return int(os.environ.get("MX_WORKER_ID", "0"))
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return dist.get_rank()
    return None


def _rng_state():
    """The host RNG state: PyTorch's CPU generator, each CUDA generator
    already initialized, numpy's global state and ``random``'s."""
    import numpy as _onp
    import torch
    state = {"numpy": _onp.random.get_state(), "random": _random.getstate(),
             "torch": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def _set_rng_state(state):
    import numpy as _onp
    import torch
    if "numpy" in state:
        _onp.random.set_state(state["numpy"])
    if "random" in state:
        _random.setstate(state["random"])
    if "torch" in state:
        torch.set_rng_state(state["torch"])
    if "cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(state["cuda"])


class PreemptionHandler:
    """On SIGTERM / SIGINT (or an injected ``preempt`` fault) atomically
    snapshot the parameters, the trainer states and the host RNG state,
    and write a checksummed resume manifest; :func:`load_snapshot`
    restores all of it.  A second signal during a save is ignored.

    In a multi-process job every worker autosaves to the (often shared)
    ``save_dir``: file names carry a ``.p<rank>`` suffix so concurrent
    autosaves never clobber each other, and a resume reads its own
    rank's snapshot."""

    def __init__(self, save_dir, net=None, trainer=None, prefix="preempt",
                 signals=(_signal.SIGTERM, _signal.SIGINT), on_fire=None,
                 exit_on_signal=True, process_index=None):
        self.save_dir = save_dir
        self.net = net
        self.trainer = trainer
        self.prefix = prefix
        self.process_index = process_index
        self.signals = tuple(signals)
        self.on_fire = on_fire
        self.exit_on_signal = exit_on_signal
        self.fired = 0
        self._prev = {}
        self._saving = threading.Lock()
        self._pid = None
        self._generation = None  # resolved lazily past existing snapshots
        self._tagged_prefix = None

    def _host_prefix(self):
        """``prefix`` with the per-process tag; resolved lazily (the job
        may not be up at construction), then frozen.  While the rank is
        unknown the untagged name is used without freezing it."""
        if self._tagged_prefix is None:
            idx = self.process_index if self.process_index is not None \
                else _detect_process_index()
            if idx is None:
                return self.prefix
            self._tagged_prefix = self.prefix + _proc_tag(idx)
        return self._tagged_prefix

    # -- lifecycle ------------------------------------------------------
    def install(self):
        """Install the signal handlers (main thread only, as Python's
        ``signal.signal`` requires); :meth:`uninstall` puts the previous
        ones back."""
        self._pid = os.getpid()
        for sig in self.signals:
            self._prev[sig] = _signal.signal(sig, self._on_signal)
        return self

    def uninstall(self):
        global _preempt_handler
        for sig, prev in self._prev.items():
            _signal.signal(sig, prev)
        self._prev.clear()
        with _fault_lock:
            if _preempt_handler is self:
                _preempt_handler = None

    def _on_signal(self, signum, frame):
        if os.getpid() != self._pid:
            # a forked child (a dataloader worker) inherited the handler:
            # die with the default semantics instead of snapshotting there
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.fire(reason=_signal.Signals(signum).name)
        if not self.exit_on_signal:
            return
        # the snapshot is on disk: hand the signal back, so the process
        # still dies or interrupts as it would have
        prev = self._prev.get(signum, _signal.SIG_DFL)
        if callable(prev):
            prev(signum, frame)
        elif prev != _signal.SIG_IGN:
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    # -- snapshot -------------------------------------------------------
    def fire(self, reason="manual"):
        if not self._saving.acquire(blocking=False):
            return None
        lease = _step_lease()
        if lease is not None:
            # this rank may survive the fire (a live-migration notice, a
            # manual fire): the release is voted at the next beat, so the
            # whole fleet drops the lease together
            lease.request_release(reason="preemption:%s" % reason)
        try:
            manifest = self.snapshot(reason=reason)
            self.fired += 1
            _profiler.counter_bump("fault::preemptions", 1, cat="fault")
            _flightrec.note_terminal("preempt:%s" % reason)
            if self.on_fire is not None:
                self.on_fire(self, reason)
            return manifest
        finally:
            self._saving.release()

    def _path(self, suffix):
        return os.path.join(self.save_dir, self._host_prefix() + suffix)

    def _next_generation(self):
        """The first unused generation number in ``save_dir``: the live
        manifest may still name the files of an existing one."""
        import re
        pat = re.compile(re.escape(self._host_prefix()) + r"\.g(\d+)\.")
        gens = [int(m.group(1)) for f in os.listdir(self.save_dir)
                for m in [pat.match(f)] if m]
        return max(gens) + 1 if gens else 0

    def snapshot(self, reason="manual"):
        """Write a new generation of snapshot files, then swap the resume
        manifest onto it (the commit point: a kill before it leaves the
        previous manifest naming the previous, intact generation).  Older
        generations are pruned after the swap."""
        os.makedirs(self.save_dir, exist_ok=True)
        if self._generation is None:
            self._generation = self._next_generation()
        else:
            self._generation += 1
        tag = ".g%d" % self._generation
        files = []
        if self.net is not None:
            self.net.save_parameters(self._path(tag + ".params"))
            files.append(self._path(tag + ".params"))
        if self.trainer is not None:
            self.trainer.save_states(self._path(tag + ".states"))
            files.append(self._path(tag + ".states"))
        _atomic_write_bytes(self._path(tag + ".rng"),
                            pickle.dumps(_rng_state(),
                                         pickle.HIGHEST_PROTOCOL))
        files.append(self._path(tag + ".rng"))
        manifest = write_manifest(
            self._path(".resume.json"), files,
            extra={"reason": reason, "generation": self._generation})
        self._prune(keep=set(os.path.basename(f) for f in files))
        return manifest

    def _prune(self, keep):
        import re
        # a worker prunes only its own generations
        pat = re.compile(re.escape(self._host_prefix()) + r"\.g\d+\.")
        for f in os.listdir(self.save_dir):
            if pat.match(f) and f not in keep:
                try:
                    os.remove(os.path.join(self.save_dir, f))
                except OSError:
                    pass


def on_preemption(save_dir, net=None, trainer=None, **kwargs):
    """Install (and return) the process-wide preemption handler.  The
    injected ``preempt`` fault and a real SIGTERM / SIGINT both fire it."""
    global _preempt_handler
    prev = preempt_handler()
    if prev is not None:
        prev.uninstall()
    handler = PreemptionHandler(save_dir, net=net, trainer=trainer, **kwargs)
    handler.install()
    with _fault_lock:
        _preempt_handler = handler
    return handler


def _deliver_preemption():
    handler = preempt_handler()
    if handler is not None:
        handler.fire(reason="injected")
    else:
        os.kill(os.getpid(), _signal.SIGTERM)


def load_snapshot(save_dir, net=None, trainer=None, prefix="preempt",
                  restore_rng=True, process_index=None):
    """Verify and restore a preemption snapshot; returns the manifest.
    File names come from the manifest (snapshots are generation-
    versioned).  Raises :class:`CorruptCheckpointError` when the check
    fails.  In a multi-process job a worker reads its own ``.p<rank>``
    snapshot, falling back only to the untagged single-process name."""
    idx = process_index if process_index is not None \
        else _detect_process_index()
    manifest_path = os.path.join(
        save_dir, prefix + _proc_tag(idx) + ".resume.json")
    if idx is not None and not os.path.exists(manifest_path):
        manifest_path = os.path.join(save_dir, prefix + ".resume.json")
    ok, bad = verify_manifest(manifest_path)
    if not ok:
        raise CorruptCheckpointError(
            "preemption snapshot failed verification: %s" % ", ".join(bad))
    with open(manifest_path, "rb") as f:
        manifest = json.loads(f.read().decode())

    def resolve(suffix):
        for rel in manifest.get("files", {}):
            if rel.endswith(suffix):
                return os.path.join(save_dir, rel)
        return None

    params = resolve(".params")
    if net is not None and params is not None:
        net.load_parameters(params)
    states = resolve(".states")
    if trainer is not None and states is not None:
        trainer.load_states(states)
    rng_path = resolve(".rng")
    if restore_rng and rng_path is not None:
        with open(rng_path, "rb") as f:
            _set_rng_state(pickle.load(f))
    return manifest


# ----------------------------------------------------------------------
# elastic-state snapshot (mx.fault.elastic's resume manifest)
# ----------------------------------------------------------------------
ELASTIC_STATE = "elastic.state"      # pickled payload
ELASTIC_MANIFEST = "elastic.json"    # checksum manifest + summary


def save_elastic_state(save_dir, step, generation, world, epoch=0,
                       checkpoint=None, extra=None):
    """Atomically snapshot the elastic runner's state (step, generation,
    world size, resize epoch, host RNG) beside the model checkpoint it
    describes, then write its checksum manifest.  Call after the model
    checkpoint completes: the manifest is the commit point."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {
        "step": int(step), "generation": int(generation),
        "world": int(world), "epoch": int(epoch),
        "checkpoint": checkpoint, "time": time.time(),
        "rng": _rng_state(),
    }
    if extra:
        payload["extra"] = dict(extra)
    path = os.path.join(save_dir, ELASTIC_STATE)
    _atomic_write_bytes(path, pickle.dumps(payload,
                                           pickle.HIGHEST_PROTOCOL))
    return write_manifest(
        os.path.join(save_dir, ELASTIC_MANIFEST), [path],
        extra={"step": int(step), "generation": int(generation),
               "world": int(world), "epoch": int(epoch)})


def load_elastic_state(save_dir, restore_rng=True):
    """Verify and load the elastic-state snapshot: the payload dict
    (``step`` / ``generation`` / ``world`` / ``epoch`` / ``checkpoint``)
    or None when there is none.  A torn snapshot raises
    :class:`CorruptCheckpointError` instead of resuming from garbage."""
    mpath = os.path.join(save_dir, ELASTIC_MANIFEST)
    spath = os.path.join(save_dir, ELASTIC_STATE)
    if not os.path.exists(mpath) and not os.path.exists(spath):
        return None
    ok, bad = verify_manifest(mpath)
    if not ok:
        raise CorruptCheckpointError(
            "elastic state failed verification: %s" % ", ".join(bad))
    with open(spath, "rb") as f:
        payload = pickle.load(f)
    if restore_rng:
        _set_rng_state(payload.get("rng") or {})
    return payload


def __getattr__(name):
    # mx.fault.dist / mx.fault.elastic: the coordinated multi-process and
    # elastic-resize layers, imported on first use
    if name == "dist":
        from . import fault_dist as dist
        globals()["dist"] = dist
        return dist
    if name == "elastic":
        from . import fault_elastic as elastic
        globals()["elastic"] = elastic
        return elastic
    raise AttributeError("module %r has no attribute %r"
                         % (__name__, name))

_load_env_spec()
