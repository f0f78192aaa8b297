"""flightrec -- the per-rank black box.

Counterpart of ``mxnet_tpu/flightrec.py``: an always-on bounded ring
buffer of structured control-plane events.  The serving scheduler's
transactions, the fault-injection firings, the serving deadlines and
retries, the router's dispatches and failovers and the telemetry
watchdog's verdicts record here, so that when a rank dies the last N
things it was doing survive as a postmortem dump.  The dumps are the
reference's JSON, key for key, so ``tools/postmortem.py`` merges them
unchanged.

Design rules, as there: ALL mutable state lives in ONE module dict
``_s`` of immutable values, guarded by ONE reentrant ``_lock``; ring
slots are integer keys of that same dict.  ``record()`` is three dict
operations under an uncontended lock and never calls out; ``dump()``
snapshots under the lock and serializes outside it, through the port's
own ``utils.serialization.atomic_write``.  Terminal events auto-dump
only when ``MXNET_FLIGHTREC_DIR`` is set.  The rank and world of a dump
come from ``torch.distributed`` when its default group is initialised
(else ``MX_WORKER_ID`` / ``MX_NUM_WORKERS``, as in the reference).

Knobs::

    MXNET_FLIGHTREC=1            recorder on/off (default on)
    MXNET_FLIGHTREC_CAPACITY=N   ring capacity in events (default 4096)
    MXNET_FLIGHTREC_DIR=PATH     auto-dump directory (unset = no dumps)
    MXNET_FLIGHTREC_MAX_DUMPS=N  per-process auto-dump cap (default 16)

Standard library only at import.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import traceback

__all__ = [
    "record", "events", "snapshot", "dump", "note_terminal",
    "set_context", "provide", "configure", "reset", "enabled",
    "capacity", "dump_dir", "default_dump_path", "TERMINAL_KINDS",
]

log = logging.getLogger("mxnet_tpu_torch.flightrec")

DEFAULT_CAPACITY = 4096
DEFAULT_MAX_DUMPS = 16

# event kinds whose presence in a dump marks the dumping rank as a
# first-failure candidate (tools/postmortem.py shares this table)
TERMINAL_KINDS = ("terminal",)


def _env_bool(name, default):
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v not in ("0", "false", "False", "off")


def _env_int(name, default):
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


_lock = threading.RLock()
# THE state: scalar config under string keys, ring slots under integer
# keys (seq % cap -> immutable event tuple).  One dict, one lock.
_s = {
    "enabled": _env_bool("MXNET_FLIGHTREC", True),
    "cap": max(8, _env_int("MXNET_FLIGHTREC_CAPACITY",
                           DEFAULT_CAPACITY)),
    "seq": 0,
    "dumps": 0,
    "ctx": (),   # tuple of (key, value) pairs from set_context
}
# dump-time context providers (name -> zero-arg callable); registered
# under _lock, snapshotted under _lock, CALLED outside it — a provider
# may take its own subsystem lock (lease, telemetry) and flightrec's
# lock must stay a leaf in every other subsystem's lock order.
_providers = {}


# ----------------------------------------------------------------------
# recording (the hot path)
# ----------------------------------------------------------------------
def record(kind, /, **fields):
    """Append one event to the ring: ``(seq, wall_time, kind, fields)``.
    Field values should be immutables (ints/floats/strings/tuples);
    callers on protocol seams pass the alignment keys they know
    (``step``, ``gen``, ``round``, ``epoch``) so the postmortem merger
    can anchor cross-rank timelines on them.  ``kind``, ``seq`` and
    ``t`` are reserved field names (they carry the envelope)."""
    ev = (kind, time.time(), tuple(fields.items()))
    with _lock:
        if not _s["enabled"]:
            return
        seq = _s["seq"]
        _s[seq % _s["cap"]] = ev
        _s["seq"] = seq + 1


def set_context(**kv):
    """Merge slow-changing rank context (rank, world, step, gen, …)
    carried verbatim into every dump.  Values must be immutable."""
    with _lock:
        ctx = dict(_s["ctx"])
        ctx.update(kv)
        _s["ctx"] = tuple(ctx.items())


def provide(name, fn):
    """Register (or, with ``fn=None``, remove) a dump-time context
    provider.  Providers run OUTSIDE the recorder lock and individually
    fail-soft: a raising provider contributes an error string, never
    kills the dump."""
    with _lock:
        if fn is None:
            _providers.pop(name, None)
        else:
            _providers[name] = fn


# ----------------------------------------------------------------------
# introspection
# ----------------------------------------------------------------------
def enabled():
    with _lock:
        return _s["enabled"]


def capacity():
    with _lock:
        return _s["cap"]


def configure(capacity=None, enabled=None):
    """Reconfigure the recorder; changing capacity drops the ring."""
    with _lock:
        if enabled is not None:
            _s["enabled"] = bool(enabled)
        if capacity is not None:
            cap = max(8, int(capacity))
            for k in [k for k in _s if isinstance(k, int)]:
                del _s[k]
            _s["cap"] = cap
            _s["seq"] = 0


def reset():
    """Drop all events, context, and the dump budget (tests)."""
    with _lock:
        for k in [k for k in _s if isinstance(k, int)]:
            del _s[k]
        _s["seq"] = 0
        _s["dumps"] = 0
        _s["ctx"] = ()


def events(last=None):
    """The ring's events oldest-first as dicts (a snapshot; the ring
    keeps recording).  ``last`` bounds the count from the tail."""
    with _lock:
        seq, cap = _s["seq"], _s["cap"]
        lo = max(0, seq - cap)
        if last is not None:
            lo = max(lo, seq - int(last))
        raw = [(i, _s.get(i % cap)) for i in range(lo, seq)]
    out = []
    for i, ev in raw:
        if ev is None:  # capacity shrank mid-scan; slot reclaimed
            continue
        kind, t, fields = ev
        d = {"seq": i, "t": t, "kind": kind}
        d.update(fields)
        out.append(d)
    return out


def snapshot():
    """Recorder state for embedding in a dump (no I/O, no providers)."""
    with _lock:
        seq, cap = _s["seq"], _s["cap"]
        ctx = dict(_s["ctx"])
        enabled_ = _s["enabled"]
    return {
        "enabled": enabled_, "capacity": cap, "seq": seq,
        "dropped": max(0, seq - cap), "context": ctx,
        "events": events(),
    }


# ----------------------------------------------------------------------
# dumps (the postmortem seam)
# ----------------------------------------------------------------------
def dump_dir():
    return os.environ.get("MXNET_FLIGHTREC_DIR") or None


def _dist():
    """``torch.distributed`` when its default group is up, else None
    (imported here: the recorder itself stays standard-library)."""
    try:
        import torch.distributed as dist
    except ImportError:
        return None
    return dist if dist.is_available() and dist.is_initialized() else None


def _detect_rank():
    dist = _dist()
    if dist is not None:
        return dist.get_rank()
    try:
        return int(os.environ.get("MX_WORKER_ID", ""))
    except ValueError:
        return 0


def _detect_world():
    dist = _dist()
    if dist is not None:
        return dist.get_world_size()
    try:
        return int(os.environ.get("MX_NUM_WORKERS", ""))
    except ValueError:
        return 1


def default_dump_path(rank=None):
    d = dump_dir()
    if d is None:
        return None
    r = _detect_rank() if rank is None else int(rank)
    return os.path.join(d, "flightrec.rank%d.json" % r)


def _env_knobs():
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("MXNET_") or k.startswith("MX_")}


def _run_providers():
    with _lock:
        provs = dict(_providers)
    out = {}
    for name, fn in sorted(provs.items()):
        try:
            out[name] = fn()
        # a provider raising mid-postmortem degrades to an error
        # string, never loses the whole black box
        except Exception as e:  # noqa: BLE001
            out[name] = "<provider failed: %r>" % (e,)
    return out


def _format_exc(exc):
    if exc is None:
        return None
    try:
        return traceback.format_exception(type(exc), exc,
                                          exc.__traceback__)
    # an unformattable exception still dumps
    except Exception:  # noqa: BLE001
        return [repr(exc)]


def dump(path=None, reason="manual", exc=None):
    """Atomically write the per-rank postmortem JSON; returns the path
    (or None when no path is resolvable).  Always works when called
    explicitly with a ``path``; the default path needs
    ``MXNET_FLIGHTREC_DIR``."""
    record("dump", reason=reason)
    if path is None:
        path = default_dump_path()
        if path is None:
            return None
    payload = {
        "version": 1,
        "reason": reason,
        "wall_time": time.time(),
        "pid": os.getpid(),
        "rank": _detect_rank(),
        "world": _detect_world(),
        "flightrec": snapshot(),
        "providers": _run_providers(),
        "env": _env_knobs(),
        "exception": _format_exc(exc),
    }
    try:
        from . import profiler as _profiler
        payload["counters"] = _profiler.get_counters()
    # counters are garnish: a half-imported profiler (interpreter
    # teardown) must not lose the dump
    except Exception:  # noqa: BLE001
        payload["counters"] = {}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    from .utils import serialization as _ser
    with _ser.atomic_write(path, mode="w") as f:
        json.dump(payload, f, default=repr)
    return path


def note_terminal(reason, exc=None):
    """A terminal event on this rank: record it, and — when
    ``MXNET_FLIGHTREC_DIR`` is set and the per-process budget allows —
    write the postmortem dump.  Never raises: the black box must not
    change what the crashing program does."""
    record("terminal", reason=reason,
           error=type(exc).__name__ if exc is not None else None)
    if dump_dir() is None:
        return None
    with _lock:
        if not _s["enabled"]:
            return None
        budget = _env_int("MXNET_FLIGHTREC_MAX_DUMPS",
                          DEFAULT_MAX_DUMPS)
        if _s["dumps"] >= budget:
            return None
        _s["dumps"] += 1
    try:
        return dump(reason=reason, exc=exc)
    # a failing dump (disk full, teardown) must not mask the original
    # failure being recorded
    except Exception as e:  # noqa: BLE001
        log.warning("flightrec dump failed for %s: %r", reason, e)
        return None
