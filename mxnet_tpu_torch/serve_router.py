"""serve_router -- replica failover front-end over ``serve``.

Counterpart of ``mxnet_tpu/serve_router.py`` on the port's
:class:`~mxnet_tpu_torch.serve.Server`:

1. **Failover with exactly-once delivery** (:class:`ReplicaGroup`): a
   front-end router dispatching submits across N thread-hosted
   replicas.  A waiter thread per in-flight request watches its
   replica; when the engine thread dies (the ``serve_engine_kill``
   fault, or a real fatal decode error), every in-flight request on
   that replica is resubmitted to a healthy one.  The router PINS each
   request's sampling seed at admission (default: the router-global
   gid), so the replay gives the tokens the dead replica would have
   given -- sampling is a pure function of (seed, step) -- and the
   result store dedupes on the request's terminal state, so a late
   duplicate from a presumed-dead replica is dropped, never delivered
   twice.
2. **Per-request deadlines** ride the replica's own
   ``submit(deadline=)`` path: expiry cancels through the scheduler
   (pages and radix refcounts released) and surfaces here as a typed
   :class:`~mxnet_tpu_torch.serve.DeadlineExceededError`.
3. **Overload shedding**: a bounded admission queue with priority
   classes (``high`` / ``normal`` / ``low``).  The shed policy reads the
   router's own backlog and the replicas' ``slo_snapshot()`` p99: at
   ``queue_limit`` backlog only ``high`` is admitted, at twice that
   everything sheds, and ``low`` sheds early once the worst replica p99
   breaches ``slo_target_ms``.  A rejected submit raises a typed
   :class:`~mxnet_tpu_torch.serve.OverloadedError`.

Knobs (environment, all optional)::

    MXNET_SERVE_QUEUE_LIMIT    admission backlog bound   (0 = off)
    MXNET_SERVE_SLO_TARGET_MS  p99 target for early shed (0 = off)

Concurrency shape: ALL router state lives in ONE dict (``_s``) of
immutable values, every access under ONE ``_lock``; ``_point`` (the
flight-recorder event) is always called OUTSIDE the locked region.

Ownership note: there is deliberately no router-level ``cancel`` —
a client that stops caring uses ``result(gid, timeout=)``, whose
timeout is final (``TimeoutError``; the underlying replica request
keeps running to its own deadline and the late delivery is dropped
by the dedupe store).
"""
from __future__ import annotations

import logging
import os
import threading
import time

from . import flightrec as _flightrec
from . import telemetry as _telemetry
from .serve import DeadlineExceededError, OverloadedError, Server

log = logging.getLogger("mxnet_tpu_torch.serve_router")

__all__ = ["ReplicaGroup", "PRIORITIES",
           "DeadlineExceededError", "OverloadedError"]

#: admission priority classes, most to least protected
PRIORITIES = ("high", "normal", "low")

#: router-side terminal request states ("deadline" is the router's
#: rendering of a replica-side DeadlineExceededError)
TERMINAL = ("done", "cancelled", "failed", "deadline")

def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


class ReplicaGroup:
    """Front-end router over N serving replicas: failover with
    exactly-once delivery, deadlines, and overload shedding.

    Request lifecycle (gid = router-global request id)::

        submit -> queued -> inflight(replica r, attempt k)
                     ^            |
                     '-- failover-'     (replica r died)
        inflight -> done|cancelled|failed|deadline   (terminal, once)

    ``threaded=True`` spawns one daemon waiter per dispatch;
    ``threaded=False`` leaves delivery and death detection to the
    caller, through :meth:`_deliver` / :meth:`_on_replica_dead`.
    """

    def __init__(self, servers, threaded=True, queue_limit=None,
                 slo_target_ms=None):
        if not servers:
            raise ValueError("ReplicaGroup needs at least one Server")
        self.servers = list(servers)
        self._threaded = bool(threaded)
        self.queue_limit = _env_int("MXNET_SERVE_QUEUE_LIMIT", 0) \
            if queue_limit is None else int(queue_limit)
        self.slo_target_ms = float(
            os.environ.get("MXNET_SERVE_SLO_TARGET_MS", "0")) \
            if slo_target_ms is None else float(slo_target_ms)
        self._lock = threading.Lock()
        # ONE shared-state dict, immutable values, ONE lock
        self._s = {
            "next_gid": 0,
            "reqs": {},           # gid -> immutable request dict
            "events": {},         # gid -> threading.Event
            "delivery_log": (),   # ((gid, attempt), ...) accepted
            "delivered": frozenset(),  # gid tombstones after result()
            "dead": frozenset(),  # replica indices declared dead
            "failovers": 0,
            "sheds": 0,
            "dup_drops": 0,
            "closing": False,
        }

    @classmethod
    def build(cls, net, serve_cfg=None, replicas=2, mesh=None, **kw):
        """Construct ``replicas`` Servers over one model: they share its
        weights and ``serve_cfg``; each has its own KV pools and
        programs."""
        from .serve import ServeConfig
        cfg = serve_cfg or ServeConfig()
        servers = [Server(net, serve_cfg=cfg, mesh=mesh)
                   for _ in range(int(replicas))]
        return cls(servers, **kw)

    # -- seams ----------------------------------------------------------
    @staticmethod
    def _point(kind, detail="", **fields):
        # flight-recorder event, called OUTSIDE the locked regions, like
        # SlotScheduler._point
        _flightrec.record(kind, detail=detail, **fields)

    # -- admission ------------------------------------------------------
    def _worst_p99_ms(self):
        worst = 0.0
        for srv in self.servers:
            try:
                snap = srv.slo_snapshot()
            except Exception:  # noqa: BLE001 -- replica may be dying
                continue
            p99 = (snap.get("latency_ms") or {}).get("p99")
            if p99:
                worst = max(worst, float(p99))
        return worst

    def _shed_verdict(self, priority, backlog):
        """Returns a shed reason string, or None to admit."""
        limit = self.queue_limit
        if limit <= 0:
            return None
        if backlog >= 2 * limit:
            return "hard"       # saturated: shed everything
        if backlog >= limit and priority != "high":
            return "full"       # queue bound: only high admitted
        if (priority == "low" and self.slo_target_ms > 0
                and backlog >= max(1, limit // 2)
                and self._worst_p99_ms() > self.slo_target_ms):
            return "slo"        # p99 breach: shed best-effort early
        return None

    def submit(self, prompt_tokens, max_new=None, sampling=None,
               deadline=None, priority="normal"):
        """Admit a request and dispatch it to the least-loaded healthy
        replica; returns the router-global gid.  The sampling seed is
        PINNED here (default: the gid) so a failover replay is bitwise
        identical on any replica.  Raises
        :class:`~mxnet_tpu.serve.OverloadedError` when the shed policy
        rejects, ``RuntimeError`` when no replica is healthy."""
        if priority not in PRIORITIES:
            raise ValueError("unknown priority %r (known: %s)"
                             % (priority, ", ".join(PRIORITIES)))
        with self._lock:
            s = self._s
            if s["closing"]:
                raise RuntimeError("ReplicaGroup is closed")
            if len(s["dead"]) >= len(self.servers):
                raise RuntimeError("no healthy serving replica")
            backlog = sum(1 for r in s["reqs"].values()
                          if r["state"] not in TERMINAL)
        verdict = self._shed_verdict(priority, backlog)
        if verdict is not None:
            with self._lock:
                self._s = dict(self._s, sheds=self._s["sheds"] + 1)
            _telemetry.bump("serve::sheds")
            self._point("router.shed",
                        detail="%s priority=%s backlog=%d"
                        % (verdict, priority, backlog))
            raise OverloadedError(
                "admission queue at %d/%d (%s shed, priority=%s) — "
                "retry later" % (backlog, self.queue_limit, verdict,
                                 priority))
        sp = dict(sampling or {})
        prompt = tuple(int(t) for t in prompt_tokens)
        expiry = None if deadline is None \
            else time.monotonic() + float(deadline)
        with self._lock:
            s = self._s
            gid = s["next_gid"]
            # THE exactly-once enabler: the seed is pinned before the
            # first dispatch, so every attempt on every replica
            # samples the same token sequence
            sp.setdefault("seed", gid)
            req = {"gid": gid, "prompt": prompt, "max_new": max_new,
                   "sampling": sp, "deadline": deadline,
                   "expiry": expiry, "priority": priority,
                   "state": "queued", "replica": None,
                   "local_rid": None, "attempt": 0, "tokens": (),
                   "error": None, "t_submit": time.time(),
                   "t_done": None}
            reqs = dict(s["reqs"])
            reqs[gid] = req
            events = dict(s["events"])
            events[gid] = threading.Event()
            self._s = dict(s, next_gid=gid + 1, reqs=reqs,
                           events=events)
        self._point("router.submit",
                    detail="gid %d priority=%s" % (gid, priority))
        self._dispatch(gid)
        return gid

    # -- dispatch / failover --------------------------------------------
    def _pick_replica(self):
        """Least router-side-inflight healthy replica (ties: lowest
        index).  Called under ``_lock``."""
        s = self._s
        load = {i: 0 for i in range(len(self.servers))
                if i not in s["dead"]}
        if not load:
            return None
        for r in s["reqs"].values():
            if r["state"] == "inflight" and r["replica"] in load:
                load[r["replica"]] += 1
        return min(load, key=lambda i: (load[i], i))

    def _dispatch(self, gid, failover=False):
        """Submit ``gid`` to a healthy replica, retrying through
        replica deaths; marks the request failed when none is left."""
        while True:
            with self._lock:
                s = self._s
                req = s["reqs"].get(gid)
                if (req is None or s["closing"]
                        or req["state"] in TERMINAL):
                    return
                idx = self._pick_replica()
            if idx is None:
                self._fail(gid, "no healthy serving replica")
                return
            srv = self.servers[idx]
            dl = None
            if req["expiry"] is not None:
                dl = req["expiry"] - time.monotonic()
                if dl <= 0:
                    self._deliver(gid, req["attempt"],
                                  {"state": "deadline", "tokens": ()})
                    return
            try:
                rid = srv.submit(list(req["prompt"]),
                                 max_new=req["max_new"],
                                 sampling=dict(req["sampling"]),
                                 deadline=dl)
            except ValueError as exc:
                # the request itself is malformed for EVERY replica
                # (ladder overflow): terminal, not a replica fault
                self._fail(gid, str(exc))
                return
            except RuntimeError as exc:
                # replica refused (engine dead): declare it, try next
                self._on_replica_dead(idx, exc)
                continue
            with self._lock:
                s = self._s
                cur = s["reqs"].get(gid)
                if cur is None or cur["state"] in TERMINAL:
                    return
                attempt = cur["attempt"] + 1
                reqs = dict(s["reqs"])
                reqs[gid] = dict(cur, state="inflight", replica=idx,
                                 local_rid=rid, attempt=attempt)
                self._s = dict(s, reqs=reqs)
            self._point("router.dispatch",
                        detail="gid %d -> replica %d rid %d "
                        "attempt %d%s"
                        % (gid, idx, rid, attempt,
                           " (failover)" if failover else ""))
            if self._threaded:
                t = threading.Thread(
                    target=self._wait_one,
                    args=(gid, attempt, idx, rid), daemon=True,
                    name="mxroute-wait-%d" % gid)
                t.start()
            return

    def _fail(self, gid, msg):
        with self._lock:
            s = self._s
            req = s["reqs"].get(gid)
            if req is None or req["state"] in TERMINAL:
                return
            reqs = dict(s["reqs"])
            reqs[gid] = dict(req, state="failed", error=msg,
                             t_done=time.time())
            self._s = dict(s, reqs=reqs)
            ev = s["events"].get(gid)
        self._point("router.failed", detail="gid %d: %s" % (gid, msg))
        if ev is not None:
            ev.set()

    def _wait_one(self, gid, attempt, idx, rid):
        """Waiter thread: block on the replica's result and route the
        outcome — terminal record delivers, engine death fails over."""
        try:
            rec = self.servers[idx].result(rid)
        except DeadlineExceededError:
            self._deliver(gid, attempt,
                          {"state": "deadline", "tokens": ()})
            return
        except BaseException as exc:  # noqa: BLE001 -- engine death
            self._on_replica_dead(idx, exc)
            return
        if rec is None or rec.get("state") not in ("done", "cancelled",
                                                   "failed"):
            # non-terminal read-back: an orderly replica stop (close()
            # path) or a death the exception path did not surface
            with self._lock:
                closing = self._s["closing"]
            if not closing:
                self._on_replica_dead(idx)
            return
        self._deliver(gid, attempt, rec)

    def _on_replica_dead(self, idx, exc=None):
        """Declare replica ``idx`` dead and fail over its in-flight
        requests.  Idempotent: a second caller finds no victims (they
        were already re-queued)."""
        idx = int(idx)
        self._point("router.replica_dead",
                    detail="replica %d%s"
                    % (idx, ": %s" % exc if exc is not None else ""),
                    replica=idx)
        with self._lock:
            s = self._s
            if s["closing"]:
                return
            victims = sorted(
                g for g, r in s["reqs"].items()
                if r["state"] == "inflight" and r["replica"] == idx)
            reqs = dict(s["reqs"])
            for g in victims:
                reqs[g] = dict(reqs[g], state="queued", replica=None,
                               local_rid=None)
            self._s = dict(s, dead=s["dead"] | {idx}, reqs=reqs,
                           failovers=s["failovers"] + len(victims))
        if exc is not None:
            log.warning("serve_router: replica %d dead (%s); failing "
                        "over %d request(s)", idx, exc, len(victims))
        for g in victims:
            _telemetry.bump("serve::failovers")
            self._point("router.failover",
                        detail="gid %d off replica %d" % (g, idx))
            self._dispatch(g, failover=True)

    # -- delivery (the exactly-once store) ------------------------------
    def _deliver(self, gid, attempt, record):
        """Land a terminal outcome for ``(gid, attempt)`` in the result
        store.  Exactly-once: a request already terminal (or already
        collected) drops the delivery — the late echo of a
        presumed-dead replica, bitwise identical anyway thanks to the
        pinned seed.  Returns True when the delivery was accepted."""
        state = record.get("state", "failed")
        if state not in TERMINAL:
            state = "failed"
        with self._lock:
            s = self._s
            req = s["reqs"].get(gid)
            dup = (req["state"] in TERMINAL) if req is not None \
                else (gid in s["delivered"])
            known = req is not None or gid in s["delivered"]
            if dup or not known:
                self._s = dict(s, dup_drops=s["dup_drops"] + 1)
                ev = None
            else:
                reqs = dict(s["reqs"])
                reqs[gid] = dict(req, state=state,
                                 tokens=tuple(record.get("tokens", ())),
                                 error=record.get("error"),
                                 t_done=time.time())
                self._s = dict(s, reqs=reqs,
                               delivery_log=s["delivery_log"]
                               + ((gid, attempt),))
                ev = s["events"].get(gid)
        if dup or not known:
            _telemetry.bump("serve::dup_dropped")
            self._point("router.dup_dropped",
                        detail="gid %d attempt %d" % (gid, attempt))
            return False
        self._point("router.deliver",
                    detail="gid %d attempt %d state=%s"
                    % (gid, attempt, state))
        if ev is not None:
            ev.set()
        return True

    # -- client API -----------------------------------------------------
    def result(self, gid, timeout=None):
        """Block for the request's terminal outcome; returns the
        request dict.  Single-delivery: the record is evicted on
        return (a tombstone keeps the dedupe store exact).  Raises
        :class:`~mxnet_tpu.serve.DeadlineExceededError` when the
        request's deadline expired, ``TimeoutError`` when THIS call's
        ``timeout`` does — the request itself stays live (the router
        owns it; a late completion is dedupe-dropped)."""
        with self._lock:
            ev = self._s["events"].get(gid)
        if ev is None:
            return None
        if not ev.wait(timeout):
            raise TimeoutError("request %d not finished" % gid)
        with self._lock:
            s = self._s
            req = s["reqs"].get(gid)
            if req is None:
                return None
            reqs = dict(s["reqs"])
            del reqs[gid]
            events = dict(s["events"])
            events.pop(gid, None)
            self._s = dict(s, reqs=reqs, events=events,
                           delivered=s["delivered"] | {gid})
        if req["state"] == "deadline":
            raise DeadlineExceededError(
                "request %d exceeded its deadline" % gid)
        return req

    def generate(self, prompt_tokens, max_new=None, timeout=None,
                 sampling=None, deadline=None, priority="normal"):
        gid = self.submit(prompt_tokens, max_new=max_new,
                          sampling=sampling, deadline=deadline,
                          priority=priority)
        return self.result(gid, timeout=timeout)

    # -- introspection --------------------------------------------------
    def requests(self):
        """Deep-copied view of every uncollected request."""
        with self._lock:
            return {g: dict(r) for g, r in self._s["reqs"].items()}

    def delivery_log(self):
        """The accepted-delivery ledger: ``((gid, attempt), ...)`` —
        exactly-once means every gid appears at most once."""
        with self._lock:
            return self._s["delivery_log"]

    def stats(self):
        with self._lock:
            s = self._s
            return {
                "failovers": s["failovers"],
                "sheds": s["sheds"],
                "dup_drops": s["dup_drops"],
                "dead": tuple(sorted(s["dead"])),
                "inflight": sum(1 for r in s["reqs"].values()
                                if r["state"] == "inflight"),
                "queued": sum(1 for r in s["reqs"].values()
                              if r["state"] == "queued"),
                "delivered": len(s["delivered"]),
            }

    # -- lifecycle ------------------------------------------------------
    def start(self):
        for srv in self.servers:
            srv.start()
        return self

    def close(self):
        # closing is set FIRST so waiter threads seeing their replica
        # stop do not misread the orderly shutdown as a death and
        # fail over into stopped replicas
        with self._lock:
            self._s = dict(self._s, closing=True)
        for srv in self.servers:
            srv.stop()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
