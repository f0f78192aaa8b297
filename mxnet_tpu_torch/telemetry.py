"""telemetry -- the fleet-wide observability plane.

Counterpart of ``mxnet_tpu/telemetry.py``, pure Python as there:

1. **Cross-rank metrics riding a heartbeat.**  A
   :class:`TelemetrySession` attached to a heartbeat
   (``hb.telemetry = sess``) adds a bounded, delta-compressed counter /
   gauge snapshot to the beat payload (:meth:`TelemetrySession.payload`);
   every rank ends each completed beat (:meth:`TelemetrySession.on_beat`)
   holding the same :class:`FleetView` (per-rank values plus min / mean /
   max / sum reductions), exposed via :func:`fleet_view`.  The port's
   heartbeat (``fault_dist.Heartbeat``) is not ported yet, so
   :func:`enable_fleet_telemetry` needs an explicit ``heartbeat=`` and
   raises without one, as the reference does with none installed.
2. **Per-step span traces with fleet correlation.**  :func:`span`
   layers on the profiler's host event recorder and stamps
   ``(rank, step, generation)`` on every event.
3. **Serving SLO telemetry.**  :class:`LatencyHistogram` is a fixed
   log-bucket sketch, mergeable across replicas, exporting p50 / p95 /
   p99 without retaining per-request state; :func:`request_lifecycle`
   turns a terminal ``serve`` request record into queued -> prefill ->
   decode spans plus histogram samples.
4. **Straggler and regression detection.**  :class:`Watchdog` consumes
   each FleetView and flags a rank whose step-time EWMA exceeds the
   fleet median by a factor (``telemetry::straggler``), and the fleet
   mean against a rolling baseline (``telemetry::regression``).

Counters are namespaced (``telemetry::``, ``serve::``, ``fault::``):
:func:`bump` derives the profiler category from the namespace and the
export allowlist is a prefix match over registered namespaces.  A
session's shared state lives in ONE dict (``_s``) under ``_lock``.

Knobs (environment, all optional)::

    MXNET_TELEMETRY                   arm the plane where a host offers
                                      it (ElasticRunner)           (1)
    MXNET_TELEMETRY_ALLOWLIST         exported-counter namespace
                                      prefixes, csv  (telemetry::,serve::,fault::)
    MXNET_TELEMETRY_MAX_KEYS          exported keys per snapshot   (64)
    MXNET_TELEMETRY_FULL_EVERY        full (non-delta) snapshot
                                      every N beats                (16)
    MXNET_TELEMETRY_EWMA_ALPHA        step-time EWMA weight       (0.5)
    MXNET_TELEMETRY_STRAGGLER_FACTOR  flag rank when EWMA > factor
                                      x fleet median              (2.0)
    MXNET_TELEMETRY_REGRESSION_FACTOR flag fleet when mean > factor
                                      x rolling baseline          (1.5)
    MXNET_TELEMETRY_BASELINE_WINDOW   rolling-baseline beats       (16)
    MXNET_TELEMETRY_MIN_MEDIAN_MS     watchdog noise floor: no flags
                                      below this fleet median     (1.0)
"""
from __future__ import annotations

import logging
import math
import os
import threading

from . import flightrec as _flightrec
from . import profiler as _profiler

log = logging.getLogger("mxnet_tpu_torch.telemetry")

__all__ = [
    "NAMESPACES", "register_namespace", "bump", "allowlist",
    "TelemetrySession", "FleetView", "Watchdog", "LatencyHistogram",
    "span", "step_mark", "set_step_context", "session", "fleet_view",
    "request_lifecycle", "ServeSLO", "enable_fleet_telemetry",
]


def _env_float(name, default):
    return float(os.environ.get(name, str(default)))


def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


def enabled():
    """The global arm switch consulted by hosts that offer the plane
    by default (``ElasticRunner``); explicit ``telemetry=`` arguments
    override it."""
    return os.environ.get("MXNET_TELEMETRY", "1") not in (
        "", "0", "false", "False")


# ----------------------------------------------------------------------
# namespaced counter registry
# ----------------------------------------------------------------------
#: registered counter namespaces -> profiler category.  serve.py and
#: this module route their bumps through here so the heartbeat-export
#: allowlist below is a PREFIX MATCH over registered namespaces, not a
#: hand-maintained name list.
NAMESPACES = {
    "telemetry::": "telemetry",
    "serve::": "serve",
    "fault::": "fault",
}

_ns_lock = threading.Lock()


def register_namespace(prefix, cat=None):
    """Register a counter namespace (``"moe::"``) and the profiler
    category its bumps land in (default: the prefix stem).  The
    registry is REBOUND atomically (copy-on-write under ``_ns_lock``)
    rather than mutated, so hot-path readers — ``bump`` runs on the
    serve engine thread — stay lock-free: any read sees either the
    complete old dict or the complete new one, never a dict mid-grow."""
    global NAMESPACES
    if not prefix.endswith("::"):
        raise ValueError("namespace prefix must end with '::', got %r"
                         % (prefix,))
    with _ns_lock:
        ns = dict(NAMESPACES)
        ns[prefix] = cat or prefix[:-2]
        NAMESPACES = ns
    return prefix


def _namespace_of(name):
    for prefix in NAMESPACES:
        if name.startswith(prefix):
            return prefix
    return None


def bump(name, delta=1):
    """Bump a cumulative counter through the namespaced registry: the
    profiler category comes from the name's registered namespace, so
    callers cannot drift into ad-hoc category strings.  Unregistered
    names raise — a typo'd namespace would silently fall off the
    heartbeat-export allowlist."""
    ns = _namespace_of(name)
    if ns is None:
        raise ValueError(
            "counter %r is outside every registered namespace %s — "
            "register_namespace() it first" % (name,
                                               sorted(NAMESPACES)))
    return _profiler.counter_bump(name, delta, cat=NAMESPACES[ns])


_allowlist_cache = (None, None, ())  # (env raw, namespace count, parsed)


def allowlist():
    """The namespace prefixes whose counters ride the heartbeat.
    ``MXNET_TELEMETRY_ALLOWLIST`` overrides (csv of prefixes); the
    default is every registered namespace.  Called once per beat —
    cached against the env value and registry size."""
    global _allowlist_cache
    raw = os.environ.get("MXNET_TELEMETRY_ALLOWLIST")
    key = (raw, len(NAMESPACES))
    if _allowlist_cache[:2] != key:
        if raw:
            parsed = tuple(p.strip() for p in raw.split(",")
                           if p.strip())
        else:
            parsed = tuple(sorted(NAMESPACES))
        _allowlist_cache = key + (parsed,)
    return _allowlist_cache[2]


# ----------------------------------------------------------------------
# span traces with fleet correlation
# ----------------------------------------------------------------------
# ambient (rank, step, generation) stamped on every span/marker; one
# triple per process is the SPMD norm — thread-rank tests pass
# explicit kwargs instead.
_ctx_lock = threading.Lock()
_ctx = {"rank": None, "step": None, "gen": None}


def set_step_context(rank=None, step=None, gen=None):
    """Update the ambient (rank, step, generation) stamp; ``None``
    leaves a field unchanged."""
    with _ctx_lock:
        if rank is not None:
            _ctx["rank"] = int(rank)
        if step is not None:
            _ctx["step"] = int(step)
        if gen is not None:
            _ctx["gen"] = int(gen)


def _stamp(rank=None, step=None, gen=None, extra=None):
    with _ctx_lock:
        args = {
            "rank": _ctx["rank"] if rank is None else int(rank),
            "step": _ctx["step"] if step is None else int(step),
            "gen": _ctx["gen"] if gen is None else int(gen),
        }
    if extra:
        args.update(extra)
    return args


class span:
    """Context manager recording one host-plane span stamped with
    (rank, step, generation) — the fleet-correlation fields
    ``tools/trace_merge.py`` aligns per-rank traces on.  Rides the
    profiler's recording gate exactly like ``profiler.annotate``:
    with the profiler off it costs one lock-free attribute read."""

    __slots__ = ("_name", "_cat", "_args", "_rec", "_t0")

    def __init__(self, name, cat="span", **stamp_kw):
        self._name = name
        self._cat = cat
        self._args = stamp_kw

    def __enter__(self):
        self._rec = _profiler._recording()
        if self._rec:
            self._t0 = _profiler._now_us()
        return self

    def __exit__(self, *exc):
        if self._rec:
            t1 = _profiler._now_us()
            _profiler.record_duration(
                self._name, self._cat, self._t0, t1 - self._t0,
                args=_stamp(**self._args))
        return False


def step_mark(step, rank=None, gen=None):
    """Emit the step-boundary instant marker trace_merge aligns rank
    tracks on (no-op while the profiler is not recording)."""
    if _profiler._recording():
        _profiler.record_instant(
            "telemetry::step", cat="telemetry",
            args=_stamp(rank=rank, step=step, gen=gen))


# ----------------------------------------------------------------------
# latency histograms (fixed log-bucket sketch, mergeable)
# ----------------------------------------------------------------------
class LatencyHistogram:
    """Streaming latency sketch: fixed log-spaced buckets over
    [``lo``, ``hi``) seconds, mergeable across replicas by plain
    bucket-count addition (the growth factor IS the bucket layout, so
    two sketches with the same growth merge exactly).  Percentiles are
    read from the bucket's geometric midpoint — error bounded by the
    bucket width (``growth`` 1.25 = <12% relative), which is the trade
    that keeps the sketch O(1) per sample and O(buckets) to ship.

    Thread-safe: the serve engine thread records while client threads
    snapshot percentiles."""

    def __init__(self, growth=1.25, lo=1e-6, hi=1e4):
        self.growth = float(growth)
        self.lo = float(lo)
        self.hi = float(hi)
        self._log_g = math.log(self.growth)
        self._nbuckets = int(math.ceil(
            math.log(self.hi / self.lo) / self._log_g)) + 1
        self._lock = threading.Lock()
        self._counts = {}   # bucket index -> count (sparse)
        self._n = 0
        self._sum = 0.0     # exact running sum (mean stays exact)

    def _bucket(self, seconds):
        if seconds <= self.lo:
            return 0
        if seconds >= self.hi:
            return self._nbuckets - 1
        return int(math.log(seconds / self.lo) / self._log_g)

    def _mid(self, idx):
        # geometric midpoint of bucket idx
        return self.lo * self.growth ** (idx + 0.5)

    def record(self, seconds):
        idx = self._bucket(float(seconds))
        with self._lock:
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self._n += 1
            self._sum += float(seconds)

    def merge(self, other):
        """Fold another sketch (or its :meth:`to_dict`) into this one.
        Layouts must match — replicas share the default knobs."""
        if isinstance(other, LatencyHistogram):
            with other._lock:
                counts = dict(other._counts)
                n, s = other._n, other._sum
            growth = other.growth
        else:
            counts = {int(k): int(v)
                      for k, v in other["counts"].items()}
            n, s = int(other["n"]), float(other["sum"])
            growth = float(other["growth"])
        if abs(growth - self.growth) > 1e-12:
            raise ValueError("histogram growth mismatch: %r vs %r"
                             % (growth, self.growth))
        with self._lock:
            for k, v in counts.items():
                self._counts[k] = self._counts.get(k, 0) + v
            self._n += n
            self._sum += s
        return self

    def to_dict(self):
        with self._lock:
            return {"growth": self.growth, "lo": self.lo,
                    "counts": dict(self._counts), "n": self._n,
                    "sum": self._sum}

    @property
    def count(self):
        with self._lock:
            return self._n

    def mean(self):
        with self._lock:
            return self._sum / self._n if self._n else 0.0

    def percentile(self, p):
        """p in [0, 100] -> seconds (bucket geometric midpoint; 0.0
        when empty)."""
        with self._lock:
            if not self._n:
                return 0.0
            target = max(1, int(math.ceil(self._n * p / 100.0)))
            seen = 0
            for idx in sorted(self._counts):
                seen += self._counts[idx]
                if seen >= target:
                    return self._mid(idx)
            return self._mid(max(self._counts))

    def snapshot(self, unit=1e3):
        """Live SLO export (default unit: milliseconds)."""
        return {
            "count": self.count,
            "mean": round(self.mean() * unit, 4),
            "p50": round(self.percentile(50) * unit, 4),
            "p95": round(self.percentile(95) * unit, 4),
            "p99": round(self.percentile(99) * unit, 4),
        }


# ----------------------------------------------------------------------
# serving SLO lifecycle (fed by mx.serve at terminal transitions)
# ----------------------------------------------------------------------
class ServeSLO:
    """The per-replica SLO sink: latency sketches + token throughput,
    retaining nothing per-request.  Mergeable across replicas
    (:meth:`merge`) because every piece is."""

    def __init__(self):
        self.ttft = LatencyHistogram()      # submit -> first token
        self.latency = LatencyHistogram()   # submit -> terminal
        self.queued = LatencyHistogram()    # submit -> admitted
        self._lock = threading.Lock()
        self._tokens = 0
        self._decode_s = 0.0

    def note_tokens(self, n, decode_s):
        with self._lock:
            self._tokens += int(n)
            self._decode_s += max(0.0, float(decode_s))

    def merge(self, other):
        self.ttft.merge(other.ttft)
        self.latency.merge(other.latency)
        self.queued.merge(other.queued)
        with other._lock:
            t, d = other._tokens, other._decode_s
        with self._lock:
            self._tokens += t
            self._decode_s += d
        return self

    def snapshot(self):
        with self._lock:
            tokens, decode_s = self._tokens, self._decode_s
        return {
            "latency_ms": self.latency.snapshot(),
            "ttft_ms": self.ttft.snapshot(),
            "queued_ms": self.queued.snapshot(),
            "tokens": tokens,
            "tokens_per_s": round(tokens / decode_s, 2)
            if decode_s > 0 else 0.0,
        }


def request_lifecycle(record, slo=None, rank=None, gen=None):
    """Turn one TERMINAL serve request record into lifecycle spans and
    SLO samples, retaining nothing: the record's phase timestamps
    (``t_submit``/``t_admit``/``t_first``/``t_done``, stamped by
    ``SlotScheduler``) are consumed here and the record is purged with
    the request by the caller.  Spans (queued→prefill→decode, with
    preemption/outcome annotations) land on the profiler's host plane
    only while it records; the histograms always do."""
    rid = record.get("rid")
    state = record.get("state")
    t_submit = record.get("t_submit")
    t_admit = record.get("t_admit")
    t_first = record.get("t_first")
    t_done = record.get("t_done")
    ntok = len(record.get("tokens", ()))
    if slo is not None and t_submit is not None and t_done is not None:
        slo.latency.record(t_done - t_submit)
        if t_admit is not None:
            slo.queued.record(t_admit - t_submit)
        if t_first is not None:
            slo.ttft.record(t_first - t_submit)
            slo.note_tokens(ntok, t_done - t_first)
    if not _profiler._recording() or t_submit is None:
        return
    # phase spans share the request's wall-clock phase boundaries,
    # mapped onto the profiler epoch so they land beside other host
    # events; annotations carry the fleet-correlation stamp + outcome
    now_us = _profiler._now_us()
    t_end = t_done if t_done is not None else t_submit
    base = {"rid": rid, "outcome": state,
            "preempts": record.get("preempts", 0)}

    def _span(name, a, b):
        if a is None or b is None or b < a:
            return
        ts = now_us - (t_end - a) * 1e6
        _profiler.record_duration(
            "serve::req::" + name, "serve", ts, (b - a) * 1e6,
            args=_stamp(rank=rank, gen=gen, extra=base))

    _span("queued", t_submit, t_admit if t_admit is not None
          else t_done)
    _span("prefill", t_admit, t_first)
    _span("decode", t_first, t_done)
    if record.get("preempts"):
        _profiler.record_instant(
            "serve::req::preempted", cat="serve",
            args=_stamp(rank=rank, gen=gen, extra=base))


# ----------------------------------------------------------------------
# the fleet view
# ----------------------------------------------------------------------
class FleetView:
    """One completed beat round's aggregated metrics: per-rank values
    plus min/mean/max/sum reductions.  Immutable — the session swaps a
    fresh instance in under its lock, readers never see a torn one."""

    __slots__ = ("ranks", "world", "step", "gen", "beat", "_reduced")

    def __init__(self, ranks, world, step, gen, beat):
        self.ranks = ranks      # rank -> {metric: value}
        self.world = world
        self.step = step
        self.gen = gen
        self.beat = beat
        self._reduced = None

    def metrics(self):
        names = set()
        for data in self.ranks.values():
            names.update(data)
        return sorted(names)

    def get(self, metric, rank=None, default=None):
        if rank is not None:
            return self.ranks.get(rank, {}).get(metric, default)
        return {r: d[metric] for r, d in self.ranks.items()
                if metric in d}

    def reduce(self):
        """{metric: {min, max, mean, sum, count}} over the ranks that
        reported it (numeric values only)."""
        if self._reduced is None:
            out = {}
            for metric in self.metrics():
                vals = [v for v in self.get(metric).values()
                        if isinstance(v, (int, float))]
                if not vals:
                    continue
                out[metric] = {
                    "min": min(vals), "max": max(vals),
                    "sum": sum(vals),
                    "mean": sum(vals) / len(vals),
                    "count": len(vals),
                }
            # immutable-after-build: safe to cache without the lock
            object.__setattr__(self, "_reduced", out)
        return self._reduced

    def __repr__(self):
        return ("FleetView(world=%d, step=%s, gen=%s, metrics=%d)"
                % (self.world, self.step, self.gen,
                   len(self.metrics())))


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    if not n:
        return 0.0
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


class Watchdog:
    """Straggler + regression detector over successive FleetViews.

    A rank whose ``step_ms_ewma`` exceeds ``factor`` x the fleet
    median is flagged by name (``telemetry::straggler`` bumps,
    ``on_straggler(rank, ewma_ms, median_ms, view)`` fires — the hook
    the autoscale policy layer subscribes to); the fleet MEAN is also
    checked against a rolling median baseline of the last ``window``
    beats (``telemetry::regression`` / ``on_regression``).  Driven
    entirely by the views' carried values — a virtual-clock test needs
    no sleeps.  Called from the session's beat path under no session
    lock (callbacks may re-enter :func:`fleet_view`)."""

    def __init__(self, factor=None, regression_factor=None,
                 window=None, on_straggler=None, on_regression=None,
                 min_median_ms=None):
        self.factor = _env_float("MXNET_TELEMETRY_STRAGGLER_FACTOR",
                                 2.0) if factor is None \
            else float(factor)
        self.regression_factor = _env_float(
            "MXNET_TELEMETRY_REGRESSION_FACTOR", 1.5) \
            if regression_factor is None else float(regression_factor)
        self.window = _env_int("MXNET_TELEMETRY_BASELINE_WINDOW", 16) \
            if window is None else int(window)
        self.on_straggler = on_straggler
        self.on_regression = on_regression
        # noise floor: below this fleet median the factor test is
        # meaningless (sub-ms CPU-proxy steps flap on scheduler jitter)
        self.min_median_ms = _env_float(
            "MXNET_TELEMETRY_MIN_MEDIAN_MS", 1.0) \
            if min_median_ms is None else float(min_median_ms)
        self.stragglers = []   # (beat, rank, ewma_ms, median_ms)
        self.regressions = []  # (beat, mean_ms, baseline_ms)
        self._means = []       # rolling fleet-mean window

    def rearm(self):
        """Drop the rolling regression baseline.  Called after an
        elastic resize: the new topology's step times are a DIFFERENT
        population (fewer or more chips, resharded batch), and judging
        them against the old world's median would fire a spurious
        ``on_regression`` on the very first post-resize beats.  The
        baseline re-fills over the next ``window//2`` rounds before the
        regression test re-engages; the straggler test (within-round,
        no baseline) keeps running."""
        self._means = []
        bump("telemetry::watchdog_rearms")

    def consume(self, view):
        by_rank = view.get("step_ms_ewma")
        vals = [v for v in by_rank.values()
                if isinstance(v, (int, float))]
        if not vals:
            return
        median = _median(vals)
        if median > self.min_median_ms:
            for rank in sorted(by_rank):
                v = by_rank[rank]
                if v > self.factor * median:
                    self.stragglers.append((view.beat, rank, v,
                                            median))
                    bump("telemetry::straggler")
                    _flightrec.record("watchdog.straggler", rank=rank,
                                      ewma_ms=round(v, 3),
                                      median_ms=round(median, 3),
                                      beat=view.beat)
                    log.warning(
                        "telemetry watchdog: rank %d is a straggler — "
                        "step EWMA %.2f ms vs fleet median %.2f ms "
                        "(factor %.1f)", rank, v, median, self.factor)
                    if self.on_straggler is not None:
                        self.on_straggler(rank, v, median, view)
        mean = sum(vals) / len(vals)
        if len(self._means) >= max(2, self.window // 2):
            baseline = _median(self._means)
            if baseline > self.min_median_ms \
                    and mean > self.regression_factor * baseline:
                self.regressions.append((view.beat, mean, baseline))
                bump("telemetry::regression")
                _flightrec.record("watchdog.regression",
                                  mean_ms=round(mean, 3),
                                  baseline_ms=round(baseline, 3),
                                  beat=view.beat)
                log.warning(
                    "telemetry watchdog: fleet step-time regression — "
                    "mean %.2f ms vs rolling baseline %.2f ms "
                    "(factor %.1f)", mean, baseline,
                    self.regression_factor)
                if self.on_regression is not None:
                    self.on_regression(mean, baseline, view)
        self._means.append(mean)
        if len(self._means) > self.window:
            self._means = self._means[-self.window:]


# ----------------------------------------------------------------------
# the session: payload <-> beat votes <-> FleetView
# ----------------------------------------------------------------------
class TelemetrySession:
    """Per-fleet aggregation state.  Attach to a heartbeat
    (``hb.telemetry = session``): each :meth:`payload` rides the
    beat's existing allgather, each :meth:`on_beat` consumes the
    completed round into a fresh :class:`FleetView`.

    Snapshots are DELTA-COMPRESSED against the sender's own previous
    beat: every rank participates in every completed round, so the
    receiver's per-rank state is always exactly one round behind and a
    delta applies cleanly.  A full snapshot is forced every
    ``full_every`` beats and whenever the sender's generation moved
    (resize), and a receiver that cannot apply a delta (fresh entry,
    generation jump) drops the rank's state and waits for the next
    full — counted in ``telemetry::resyncs``, never silently wrong.
    Stale-rank pruning is generation-gated: a completed round is a
    full-world allgather, so ranks absent from it are gone (resize) —
    their entries are dropped and entries carrying an older generation
    than the round's newest never survive into the view.

    All shared state lives in ONE dict (``_s``) under ``_lock``."""

    def __init__(self, gauges=None, watchdog=None, max_keys=None,
                 full_every=None, ewma_alpha=None):
        # RLock: watchdog callbacks run on the beat thread and may call
        # fleet_view()/note_step_time back into the session
        self._lock = threading.RLock()
        self._s = {
            "seq": 0,            # this rank's beat sequence number
            "last": {},          # last exported snapshot (delta base)
            "last_gen": None,    # generation of the last export
            "ranks": {},         # rank -> {"seq", "gen", "data"}
            "view": None,        # latest FleetView (immutable)
            "gen": 0,            # this rank's current generation
            "ewma_ms": None,     # local step-time EWMA
            "dropped": 0,        # keys over the cap, ever
            "resyncs": 0,        # un-appliable deltas dropped, ever
            "beats": 0,
        }
        self._gauges = dict(gauges or {})   # name -> callable() -> num
        self.watchdog = watchdog
        # additional per-round FleetView consumers (e.g. the autoscale
        # ScalePolicy): each gets consume(view) after the watchdog, on
        # the beat thread, outside the session lock
        self.consumers = []
        self.max_keys = _env_int("MXNET_TELEMETRY_MAX_KEYS", 64) \
            if max_keys is None else int(max_keys)
        self.full_every = max(1, _env_int(
            "MXNET_TELEMETRY_FULL_EVERY", 16)
            if full_every is None else int(full_every))
        self.alpha = _env_float("MXNET_TELEMETRY_EWMA_ALPHA", 0.5) \
            if ewma_alpha is None else float(ewma_alpha)
        # flightrec dump-time context: the latest session wins (one
        # live fleet session per rank is the production shape); the
        # provider runs outside the recorder lock and takes _lock like
        # any reader
        _flightrec.provide("telemetry", self._flightrec_snapshot)

    def _flightrec_snapshot(self):
        with self._lock:
            view = self._s["view"]
            out = {"beats": self._s["beats"], "gen": self._s["gen"],
                   "ewma_ms": self._s["ewma_ms"],
                   "resyncs": self._s["resyncs"]}
        if view is not None:
            out["view"] = {"world": view.world, "step": view.step,
                           "gen": view.gen, "beat": view.beat,
                           "ranks": sorted(view.ranks)}
        return out

    # -- local inputs ---------------------------------------------------
    def register_gauge(self, name, fn):
        """A callable sampled into every snapshot (e.g. a serve
        replica's queue depth).  Must be namespaced like counters."""
        if _namespace_of(name) is None:
            raise ValueError("gauge %r is outside every registered "
                             "namespace" % (name,))
        with self._lock:
            self._gauges[name] = fn

    def set_generation(self, gen):
        """Advance this rank's generation (the resize protocol's
        committed value) — the next payload goes FULL and peers
        generation-gate their stale entries out."""
        with self._lock:
            self._s["gen"] = int(gen)

    def note_step_time(self, seconds, step=None):
        """Fold one step's wall time into the local EWMA gauge (and
        emit the trace step marker while the profiler records).  The
        value is caller-supplied — virtual-clock tests inject step
        times instead of sleeping."""
        ms = float(seconds) * 1e3
        with self._lock:
            prev = self._s["ewma_ms"]
            self._s["ewma_ms"] = ms if prev is None \
                else self.alpha * ms + (1.0 - self.alpha) * prev
        if step is not None:
            set_step_context(step=step)
            step_mark(step)

    # -- the beat seam --------------------------------------------------
    def _snapshot(self):
        """Bounded current snapshot: allowlisted counters + gauges +
        the step-time EWMA.  Called under ``_lock``."""
        prefixes = allowlist()
        data = {}
        for name, value in _profiler.get_counters().items():
            if any(name.startswith(p) for p in prefixes):
                data[name] = value
        for name, fn in self._gauges.items():
            try:
                data[name] = fn()
            # a dying gauge provider (a stopped server's stats) must
            # not take the heartbeat down
            except Exception:  # noqa: BLE001
                continue
        ewma = self._s["ewma_ms"]
        if ewma is not None:
            data["step_ms_ewma"] = round(ewma, 4)
        if len(data) > self.max_keys:
            keep = sorted(data)[:self.max_keys]
            self._s["dropped"] += len(data) - self.max_keys
            data = {k: data[k] for k in keep}
            data["telemetry::dropped_keys"] = self._s["dropped"]
        return data

    def payload(self):
        """This rank's beat contribution: ``{"seq", "gen", "full"|
        "delta"}``.  Delta = keys that changed since the previous
        export plus explicit ``None`` tombstones for keys that
        vanished."""
        with self._lock:
            snap = self._snapshot()
            seq = self._s["seq"]
            gen = self._s["gen"]
            full = (seq % self.full_every == 0
                    or self._s["last_gen"] != gen)
            out = {"seq": seq, "gen": gen}
            if full:
                out["full"] = snap
            else:
                last = self._s["last"]
                delta = {k: v for k, v in snap.items()
                         if last.get(k) != v}
                for k in last:
                    if k not in snap:
                        delta[k] = None  # tombstone
                out["delta"] = delta
            self._s["last"] = snap
            self._s["last_gen"] = gen
            self._s["seq"] = seq + 1
        return out

    def on_beat(self, votes):
        """Consume one COMPLETED beat round (called by
        ``Heartbeat.beat`` after the allgather, before the lease —
        telemetry must not lose the round to a lease revocation).
        Builds and publishes the round's :class:`FleetView`; never
        raises into the beat."""
        entries = {}
        step = None
        for v in votes:
            tel = v.get("telemetry")
            if isinstance(tel, dict):
                entries[v.get("rank")] = tel
            if v.get("step", -1) >= 0:
                step = v["step"] if step is None \
                    else max(step, v["step"])
        if not entries:
            return None
        round_gen = max(t.get("gen", 0) for t in entries.values())
        resyncs = 0
        with self._lock:
            # copy-on-write like SlotScheduler._s: the stored ranks
            # dict is replaced wholesale, never mutated in place
            old = self._s["ranks"]
            ranks = {}
            # a completed round IS a full-world allgather: ranks
            # absent from it left the world (resize) — pruned by
            # simply not carrying them into the new dict; survivors
            # are generation-gated below
            for rank, tel in entries.items():
                seq, gen = tel.get("seq", 0), tel.get("gen", 0)
                ent = old.get(rank)
                if gen < round_gen:
                    # pre-resize state aliased onto a renumbered rank:
                    # never let it into the view
                    continue
                if "full" in tel:
                    ranks[rank] = {"seq": seq, "gen": gen,
                                   "data": dict(tel["full"])}
                elif ent is not None and ent["seq"] == seq - 1 \
                        and ent["gen"] == gen:
                    data = dict(ent["data"])
                    for k, v in tel["delta"].items():
                        if v is None:
                            data.pop(k, None)
                        else:
                            data[k] = v
                    ranks[rank] = {"seq": seq, "gen": gen,
                                   "data": data}
                else:
                    # un-appliable delta (fresh entry / missed base):
                    # drop and wait for the sender's next full
                    resyncs += 1
            self._s["ranks"] = ranks
            if resyncs:
                self._s["resyncs"] = \
                    self._s.get("resyncs", 0) + resyncs
            self._s["beats"] += 1
            beat = self._s["beats"]
            view = FleetView(
                {r: dict(e["data"]) for r, e in ranks.items()},
                world=len(entries), step=step, gen=round_gen,
                beat=beat)
            self._s["view"] = view
            wd = self.watchdog
        # counter bumps OUTSIDE the session lock: never nest
        # _lock -> profiler._rec_lock
        if resyncs:
            bump("telemetry::resyncs", resyncs)
        bump("telemetry::beats")
        if wd is not None:
            wd.consume(view)
        for c in list(self.consumers):
            c.consume(view)
        return view

    # -- readers --------------------------------------------------------
    def fleet_view(self):
        """The latest completed round's :class:`FleetView` (or None
        before the first)."""
        with self._lock:
            return self._s["view"]

    def local_ewma_ms(self):
        with self._lock:
            return self._s["ewma_ms"]


# ----------------------------------------------------------------------
# process-wide default session
# ----------------------------------------------------------------------
_ambient_lock = threading.Lock()
_SESSION = None


def session():
    """The process-wide default :class:`TelemetrySession` (created on
    first use).  Thread-rank tests and multi-runner processes build
    their own sessions instead — the singleton is for the one-rank-
    per-process SPMD norm."""
    global _SESSION
    with _ambient_lock:
        if _SESSION is None:
            _SESSION = TelemetrySession(watchdog=Watchdog())
        return _SESSION


def fleet_view():
    """The default session's latest :class:`FleetView` (None until a
    telemetry-armed heartbeat completes a round)."""
    return session().fleet_view()


def enable_fleet_telemetry(heartbeat=None, sess=None):
    """Attach a session (default: the process-wide one) to a heartbeat
    (default: the installed step heartbeat) so its beats start
    carrying telemetry.  Returns the session."""
    sess = sess or session()
    if heartbeat is None:
        from . import fault as _fault
        heartbeat = _fault._DIST_HEARTBEAT
    if heartbeat is None:
        raise RuntimeError(
            "no heartbeat to attach telemetry to — enable_step_"
            "heartbeat() first or pass heartbeat=")
    heartbeat.telemetry = sess
    return sess
