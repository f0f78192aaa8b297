"""mxverify for the PyTorch port: an exhaustive-interleaving checker of
the coordination protocols.

A CHESS-style deterministic cooperative scheduler runs N simulated ranks
through the port's ACTUAL protocol code (``fault_dist.coordinated_call``
over ``InProcessComm``, ``StepLease`` / ``Heartbeat``,
``fault_elastic.vote_resize`` / ``vote_join`` over ``InProcessBoard``,
``serve.SlotScheduler`` and ``serve_router.ReplicaGroup``; each carries
schedule-point seams that are inert in production), systematically
exploring schedules and injecting a crash or hang at every yield point.

How an execution is controlled:

- Exactly ONE simulated rank runs at a time; every comm/board operation
  is a **yield point** where the scheduler picks who runs next.
- Time is **virtual**: blocking waits park the rank; when no rank is
  runnable the clock jumps to the earliest pending deadline (or a
  doubling quantum for deadline-less board waits), so a 60s consensus
  timeout costs microseconds and fires *exactly* when the protocol says
  it would (``fault_dist._now`` / ``fault_elastic._now`` read it).
- A **crash** raises a ``BaseException`` the protocol code cannot
  swallow (a process kill); a **hang** parks the rank until everything
  else drained: the slow-but-alive peer the persistent-vote comms
  exist for.

Exploration: bounded DFS over scheduling choices (preemption bound:
non-default switches while the previous rank is still runnable, plus
classic sleep-set pruning on independent pending actions), a slow-rank
delay sweep, then seeded random walks beyond the bound.  Every terminal
state is judged by invariant oracles lifted from the prose guarantees:

======================  ================================================
oracle                  violation it hunts
======================  ================================================
no_deadlock             a schedule that never terminates (live-lock /
                        all ranks parked with nothing to wake them)
attributed_errors       a rank dying of anything but PeerLostError /
                        CoordinatedAbortError / VotedOutError /
                        ElasticAbortError (GenerationMismatchError IS a
                        violation: the divergence it names is the bug)
no_solo_reissue         a rank re-entering an op with no completed
                        consensus round (or no generation bump) between
                        attempts (the solo re-issue deadlock)
no_double_apply         a mutating op applied more than once on any rank
equal_generations       ranks that completed normally disagree on the
                        committed generation
no_fork                 two committed resize records (or returned
                        intents) with different survivor sets
no_stale_world_commit   a commit record folding a joiner with no posted
                        join record, naming a survivor that never
                        voted, or carrying a generation that is not
                        max(posted)+1 — a fabricated/stale world
joiner_adopts_committed_gen
                        a joiner returning a generation no commit
                        record for its epoch carries — it started
                        stepping at its OWN notion of the world
                        (the join barrier was skipped)
no_lease_false_success  a rank reporting its step successful while a
                        peer flagged a failure under the step lease
                        (the revocation was skipped)
lease_amortized         the lease success path paying ANY per-op vote
                        round, or more than one aggregate round per
                        step (the perf property as an invariant)
======================  ================================================

A violation replays as a **minimized schedule trace** (greedy shrink:
shortest failing prefix, then drop redundant choices) that
:func:`replay` re-executes deterministically.

Budget knobs (environment)::

    MXNET_VERIFY_SCHEDULES    distinct schedules per scenario   (1200)
    MXNET_VERIFY_SECONDS      wall budget per scenario, seconds (45)
    MXNET_VERIFY_PREEMPTIONS  DFS preemption bound              (2)
    MXNET_VERIFY_FAULTS       injected crash/hangs per schedule (1)
    MXNET_VERIFY_STEPS        per-schedule step limit           (4000)
    MXNET_VERIFY_SEED         random-walk seed                  (0)

Unlike ``analysis.lint`` / ``analysis.race`` (stdlib-only, loadable by
file path), this module imports the fault runtime and the serving
control plane: the whole point is executing the real protocol code.  It
touches no card.  ``python -m mxnet_tpu_torch.analysis verify`` is its
CLI.
"""
from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
import time

from .. import fault as _fault
from .. import fault_dist as _fdist
from .. import fault_elastic as _felastic
from .. import serve as _serve
from .. import serve_router as _srouter

__all__ = [
    "SimCrash", "Budget", "Violation", "Counterexample", "VariantResult",
    "ScenarioReport", "SCENARIOS", "KNOWN_MUTATIONS", "mutations",
    "verify_scenario", "replay", "format_trace",
]

RUN, CRASH, HANG = "run", "crash", "hang"


class SimCrash(BaseException):
    """Simulated process kill.  BaseException on purpose: the protocol
    code's ``except Exception`` arms must NOT see it (a killed process
    does not vote, log, or clean up)."""


# ----------------------------------------------------------------------
# budgets
# ----------------------------------------------------------------------
class Budget:
    """Exploration budget; every knob has an ``MXNET_VERIFY_*`` env
    default so the CLI, CI smoke, and tests share one vocabulary."""

    def __init__(self, schedules=None, seconds=None, preemptions=None,
                 faults=None, steps=None, seed=None):
        env = os.environ

        def _pick(val, name, default, cast):
            return cast(env.get(name, default)) if val is None else val
        self.schedules = _pick(schedules, "MXNET_VERIFY_SCHEDULES",
                               "1200", int)
        self.seconds = _pick(seconds, "MXNET_VERIFY_SECONDS", "45", float)
        self.preemptions = _pick(preemptions, "MXNET_VERIFY_PREEMPTIONS",
                                 "2", int)
        self.faults = _pick(faults, "MXNET_VERIFY_FAULTS", "1", int)
        self.steps = _pick(steps, "MXNET_VERIFY_STEPS", "4000", int)
        self.seed = _pick(seed, "MXNET_VERIFY_SEED", "0", int)

    def split(self, n):
        """Even per-variant sub-budgets for an n-variant scenario."""
        out = []
        for _ in range(n):
            b = Budget(schedules=max(1, self.schedules // n),
                       seconds=self.seconds / n,
                       preemptions=self.preemptions, faults=self.faults,
                       steps=self.steps, seed=self.seed)
            out.append(b)
        return out


# ----------------------------------------------------------------------
# the cooperative scheduler
# ----------------------------------------------------------------------
_TLS = threading.local()


def sim_point(kind, obj=None, write=False, detail=""):
    """Yield point for scenario code (no-op outside a simulation)."""
    sched = getattr(_TLS, "sched", None)
    if sched is not None:
        sched.point(kind, obj=obj, write=write, detail=detail)


class _Rank:
    __slots__ = ("status", "wake", "kill", "hung", "pending", "blocked",
                 "timeout_fired", "result", "error")

    def __init__(self):
        self.status = "new"      # new|paused|running|done|crashed
        self.wake = False
        self.kill = False
        self.hung = False
        self.pending = None      # (kind, obj, write, detail) at a yield
        self.blocked = None      # (pred, virtual-deadline-or-None)
        self.timeout_fired = False
        self.result = None
        self.error = None


class Scheduler:
    """Runs ``world`` rank functions with exactly one thread active at a
    time; every seam operation pauses at a yield point and the
    controller decides who runs next.  Virtual clock, injectable
    crash/hang, full event trace."""

    def __init__(self, world, controller, step_limit=4000, fault_budget=1):
        self.world = world
        self.controller = controller
        self.step_limit = step_limit
        self.fault_budget = fault_budget
        self.faults_used = 0
        self.ranks = {r: _Rank() for r in range(world)}
        self._cv = threading.Condition()
        self._active = None
        self.clock = 0.0
        self._quantum = 0.05
        self.versions = {}       # obj -> write count
        self.events = []         # (seq, clock, rank, kind, obj, detail)
        self.livelock = False
        self.state = None        # scenario-owned terminal state

    # -- thread side ---------------------------------------------------
    def now(self):
        return self.clock

    def _record(self, rank, kind, obj, detail):
        self.events.append((len(self.events), round(self.clock, 4),
                            rank, kind, obj, detail))

    def _pause(self, rank):
        rs = self.ranks[rank]
        with self._cv:
            rs.status = "paused"
            self._active = None
            self._cv.notify_all()
            while not rs.wake:
                self._cv.wait()
            rs.wake = False
            rs.status = "running"
        if rs.kill:
            rs.kill = False
            raise SimCrash()

    def point(self, kind, obj=None, write=False, detail=""):
        rank = _TLS.rank
        rs = self.ranks[rank]
        rs.pending = (kind, obj, write, detail)
        self._pause(rank)
        rs.pending = None
        self._record(rank, kind, obj, detail)
        if write:
            self.versions[obj] = self.versions.get(obj, 0) + 1
            self._quantum = 0.05  # progress: reset the idle fast-forward
            self.controller.on_write(self, rank, (kind, obj, write, detail))

    def block(self, pred, obj=None, timeout=None, detail=""):
        """Park until ``pred()`` holds (True) or the virtual timeout
        fires (False) — the scheduler decides which, and when."""
        rank = _TLS.rank
        rs = self.ranks[rank]
        deadline = None if timeout is None else self.clock + timeout
        while True:
            rs.pending = ("block", obj, False, detail)
            rs.blocked = (pred, deadline)
            self._pause(rank)
            rs.blocked = None
            rs.pending = None
            fired = rs.timeout_fired
            rs.timeout_fired = False
            if pred():
                self._record(rank, "block.ok", obj, detail)
                return True
            if fired:
                self._record(rank, "block.timeout", obj, detail)
                return False

    def board_wait(self, obj, timeout):
        """One virtual board wait: returns after a board write or a
        clock advance (spurious wakes allowed, same as Condition.wait);
        the caller's own deadline checks run on the virtual clock."""
        rank = _TLS.rank
        rs = self.ranks[rank]
        v0 = self.versions.get(obj, 0)
        rs.pending = ("block", obj, False, "wait")
        rs.blocked = (lambda: self.versions.get(obj, 0) > v0, None)
        self._pause(rank)
        rs.blocked = None
        rs.pending = None
        rs.timeout_fired = False
        self._record(rank, "board.wait", obj, "")

    def _main(self, rank, fn):
        _TLS.sched = self
        _TLS.rank = rank
        _felastic._SIM_CLOCK.fn = self.now
        rs = self.ranks[rank]
        status, result, error = "done", None, None
        try:
            self._pause(rank)  # first scheduling is a decision too
            result = fn(rank)
        except SimCrash:
            status = "crashed"
        except BaseException as e:  # noqa: BLE001 — terminal state capture
            error = e
        finally:
            _felastic._SIM_CLOCK.fn = None
            with self._cv:
                rs.result, rs.error, rs.status = result, error, status
                self._active = None
                self._cv.notify_all()

    # -- scheduler side ------------------------------------------------
    def _resume(self, rank):
        rs = self.ranks[rank]
        with self._cv:
            self._active = rank
            rs.wake = True
            self._cv.notify_all()
            while self._active is not None:
                self._cv.wait()

    def _runnable(self):
        out = []
        for r, rs in self.ranks.items():
            if rs.status != "paused" or rs.hung:
                continue
            if rs.blocked is not None:
                pred, _ = rs.blocked
                if not (pred() or rs.timeout_fired):
                    continue
            out.append(r)
        return out

    def _advance_time(self):
        """Quiescence: jump the clock to the earliest deadline (or a
        doubling quantum for deadline-less waiters), waking what
        expired; un-hang hung ranks only when nothing else can move;
        False = true deadlock."""
        waiters = [(r, rs) for r, rs in self.ranks.items()
                   if rs.status == "paused" and not rs.hung
                   and rs.blocked is not None]
        deadlines = [rs.blocked[1] for _, rs in waiters
                     if rs.blocked[1] is not None]
        quantum_ok = any(rs.blocked[1] is None for _, rs in waiters)
        if deadlines:
            t = min(deadlines)
            if quantum_ok:
                t = min(t, self.clock + self._quantum)
        elif quantum_ok:
            t = self.clock + self._quantum
        else:
            hung = [r for r, rs in self.ranks.items()
                    if rs.status == "paused" and rs.hung]
            if hung:
                for r in hung:
                    self.ranks[r].hung = False
                    self._record(r, "unhang", None, "")
                return True
            return False
        # strictly PAST the deadline (real time always is), so a waiter
        # woken at its deadline takes the timeout path, not a re-check
        # that races the event it was waiting for
        self.clock = max(self.clock, t) + 1e-6
        self._quantum = min(self._quantum * 2.0, 64.0)
        for _, rs in waiters:
            _, dl = rs.blocked
            if dl is None or dl <= self.clock:
                rs.timeout_fired = True
        self._record(-1, "clock", None, "-> %.2fs" % self.clock)
        return True

    def _options(self, runnable):
        opts = [(RUN, r) for r in runnable]
        # a hung rank is SLOW, not dead (crash models dead): it never
        # runs by default, but WAKING it is a choice at any later
        # decision point — the hang duration is itself explored, which
        # is how stale-round interleavings (a peer resurfacing after its
        # drain window) become reachable
        for r, rs in self.ranks.items():
            if rs.hung and rs.status == "paused":
                opts.append((RUN, r))
        if self.faults_used < self.fault_budget:
            for r in runnable:
                opts.append((CRASH, r))
                opts.append((HANG, r))
        return opts

    def run(self, runners):
        threads = [threading.Thread(target=self._main, args=(r, fn),
                                    daemon=True,
                                    name="mxverify-rank-%d" % r)
                   for r, fn in enumerate(runners)]
        for t in threads:
            t.start()
        with self._cv:
            while any(rs.status == "new" for rs in self.ranks.values()):
                self._cv.wait()
        steps = 0
        while True:
            live = [r for r, rs in self.ranks.items()
                    if rs.status == "paused"]
            if not live:
                break
            runnable = self._runnable()
            if not runnable:
                if not self._advance_time():
                    self.livelock = True
                    break
                continue
            steps += 1
            if steps > self.step_limit:
                self.livelock = True
                break
            choice = self.controller.decide(self, runnable,
                                            self._options(runnable))
            kind, r = choice
            if kind == RUN and self.ranks[r].hung:
                self.ranks[r].hung = False
                self._record(r, "unhang", None, "")
            if kind == HANG:
                self.ranks[r].hung = True
                self.faults_used += 1
                self._record(r, "hang", None, "")
                continue
            if kind == CRASH:
                self.ranks[r].kill = True
                self.faults_used += 1
                self._record(r, "crash", None, "")
            self._resume(r)
        # reap: kill anything still parked (live-locked schedules)
        for r, rs in self.ranks.items():
            if rs.status == "paused":
                rs.kill = True
                self._resume(r)
        for t in threads:
            t.join(timeout=10.0)


# ----------------------------------------------------------------------
# controller: path-following + DFS bookkeeping
# ----------------------------------------------------------------------
def _dependent(a, b):
    """Two pending actions are dependent when they touch the same shared
    object and at least one writes (unknown = dependent, conservative)."""
    if a is None or b is None:
        return True
    return a[1] == b[1] and (a[2] or b[2])


class _Node:
    __slots__ = ("options", "chosen", "sleep", "pending", "preemptions",
                 "prev")

    def __init__(self, options, chosen, sleep, pending, preemptions,
                 prev):
        self.options = options
        self.chosen = chosen
        self.sleep = sleep
        self.pending = pending
        self.preemptions = preemptions
        self.prev = prev


class Controller:
    """Follows a choice prefix, extends with run-to-completion defaults
    (or seeded random picks), and records every decision node so the
    explorer can branch."""

    def __init__(self, prefix=(), sleep0=frozenset(), rng=None,
                 fault_prob=0.12):
        self.prefix = tuple(prefix)
        self.trace = []
        self.nodes = []
        self.sleep = set(sleep0)
        self.preemptions = 0
        self.last = None
        self.rng = rng
        self.fault_prob = fault_prob
        self.diverged = False

    def decide(self, sim, runnable, options):
        i = len(self.trace)
        default = (RUN, self.last) if self.last in runnable \
            else (RUN, min(runnable))
        if i < len(self.prefix):
            choice = tuple(self.prefix[i])
            if choice not in options:
                self.diverged = True
                choice = default
        elif self.rng is not None:
            # crash/hang injections and hung-rank wakes are the rare
            # moves; otherwise mostly run-to-completion with occasional
            # random switches
            extras = [o for o in options
                      if o[0] != RUN or o[1] not in runnable]
            if extras and self.rng.random() < self.fault_prob:
                choice = extras[self.rng.randrange(len(extras))]
            elif self.rng.random() < 0.6:
                choice = default
            else:
                choice = (RUN, runnable[self.rng.randrange(len(runnable))])
        else:
            choice = default
        pending = {r: sim.ranks[r].pending for r in runnable}
        self.nodes.append(_Node(tuple(options), choice,
                                frozenset(self.sleep), pending,
                                self.preemptions, self.last))
        if choice[0] == RUN:
            if self.last is not None and choice[1] != self.last and \
                    (RUN, self.last) in options:
                self.preemptions += 1
            self.sleep.discard(choice[1])
            self.last = choice[1]
        elif choice[0] == CRASH:
            self.last = choice[1]
        self.trace.append(choice)
        return choice

    def on_write(self, sim, rank, action):
        if not self.sleep:
            return
        for r in list(self.sleep):
            rs = sim.ranks.get(r)
            if rs is None or _dependent(rs.pending, action):
                self.sleep.discard(r)


# ----------------------------------------------------------------------
# violations / counterexamples
# ----------------------------------------------------------------------
class Violation:
    def __init__(self, oracle, message):
        self.oracle = oracle
        self.message = message

    def __repr__(self):
        return "Violation(%s: %s)" % (self.oracle, self.message)


class Counterexample:
    """A minimized failing schedule plus the event trace of its replay."""

    def __init__(self, scenario, variant, oracle, message, schedule,
                 events):
        self.scenario = scenario
        self.variant = variant
        self.oracle = oracle
        self.message = message
        self.schedule = [tuple(c) for c in schedule]
        self.events = list(events)

    def to_json(self):
        return {"scenario": self.scenario, "variant": self.variant,
                "oracle": self.oracle, "message": self.message,
                "schedule": [list(c) for c in self.schedule],
                "events": [[e[0], e[1], e[2], e[3],
                            list(e[4]) if isinstance(e[4], tuple)
                            else e[4], e[5]] for e in self.events]}

    def format(self):
        return format_trace(self)


def format_trace(cex):
    lines = ["counterexample: scenario=%s variant=%s oracle=%s"
             % (cex.scenario, cex.variant, cex.oracle),
             "  %s" % cex.message,
             "  minimized schedule (%d forced choice(s), defaults "
             "elsewhere):" % len(cex.schedule)]
    for i, (kind, r) in enumerate(cex.schedule):
        lines.append("    [%d] %s rank %d" % (i, kind, r))
    lines.append("  replayed events:")
    for seq, clk, rank, kind, obj, detail in cex.events:
        who = "clock" if rank < 0 else "rank%d" % rank
        lines.append("    [%3d] t=%-8.2f %-6s %-13s %s"
                     % (seq, clk, who, kind, detail or
                        (obj if obj is None else repr(obj))))
    return "\n".join(lines)


# ----------------------------------------------------------------------
# oracles
# ----------------------------------------------------------------------
def _oracle_no_deadlock(variant, sim):
    if sim.livelock:
        stuck = sorted(r for r, rs in sim.ranks.items()
                       if rs.status == "crashed" and rs.error is None)
        return Violation(
            "no_deadlock",
            "schedule did not terminate within the step budget "
            "(live-lock or deadlock; reaped rank(s) %s)" % stuck)
    return None


def _oracle_attributed_errors(variant, sim):
    allowed = (_fdist.PeerLostError, _fdist.CoordinatedAbortError,
               _felastic.VotedOutError, _felastic.ElasticAbortError) + \
        tuple(variant.allowed)
    for r, rs in sim.ranks.items():
        if rs.error is not None and not isinstance(rs.error, allowed):
            return Violation(
                "attributed_errors",
                "rank %d died of unattributed %s: %s"
                % (r, type(rs.error).__name__, rs.error))
    return None


def _oracle_no_solo_reissue(variant, sim):
    enters = {}   # (rank, op-obj) -> [event seq, ...]
    comm_ok = {}  # rank -> [event seq of completed comm rounds]
    for seq, _, rank, kind, obj, _ in sim.events:
        if kind == "op.enter":
            enters.setdefault((rank, obj), []).append(seq)
        elif kind == "block.ok" and isinstance(obj, tuple) and \
                obj and obj[0] == "comm":
            comm_ok.setdefault(rank, []).append(seq)
    for (rank, obj), seqs in enters.items():
        for a, b in zip(seqs, seqs[1:]):
            if not any(a < s < b for s in comm_ok.get(rank, ())):
                return Violation(
                    "no_solo_reissue",
                    "rank %d re-issued %r with NO completed consensus "
                    "round between attempts (events %d -> %d)"
                    % (rank, obj, a, b))
    gens = sim.state.get("attempts", {})
    for (rank, opi), glist in gens.items():
        for a, b in zip(glist, glist[1:]):
            if b <= a:
                return Violation(
                    "no_solo_reissue",
                    "rank %d re-issued op %s without a generation bump "
                    "(gen %d -> %d): peers never acknowledged the retry"
                    % (rank, opi, a, b))
    # every rank that RETURNED must have taken identical attempt-gen
    # sequences per op — re-issue is all-together or not at all
    per_op = {}
    for (rank, opi), glist in gens.items():
        if sim.ranks[rank].status == "done" and \
                sim.ranks[rank].error is None:
            per_op.setdefault(opi, set()).add(tuple(glist))
    for opi, seqset in per_op.items():
        if len(seqset) > 1:
            return Violation(
                "no_solo_reissue",
                "ranks that completed op %s took different attempt-"
                "generation sequences %s — someone re-issued solo"
                % (opi, sorted(seqset)))
    return None


def _oracle_no_double_apply(variant, sim):
    if not variant.mutating:
        return None
    for (rank, opi), n in sim.state.get("applied", {}).items():
        if n > 1:
            return Violation(
                "no_double_apply",
                "mutating op %s applied %d times on rank %d"
                % (opi, n, rank))
    return None


def _oracle_equal_generations(variant, sim):
    finals = {}
    for r, rs in sim.ranks.items():
        if rs.status == "done" and rs.error is None:
            gen = sim.state["final_gen"].get(r)
            if gen is not None:
                finals[r] = gen
    if len(set(finals.values())) > 1:
        return Violation(
            "equal_generations",
            "ranks completed at different generations: %s" % finals)
    return None


def _oracle_no_lease_false_success(variant, sim):
    """With a failure scripted under the step lease, NO rank may report
    its step loop successful: the revocation must reach (and abort)
    every rank through the beat's aggregate vote.  A rank finishing
    cleanly while a peer flagged a failure is exactly the silent-
    success bug the ``skip_lease_revoke`` mutation reintroduces."""
    failed = sim.state.get("failed_ranks") or ()
    if not failed:
        return None
    ok = sorted(sim.state.get("step_ok", ()))
    if ok:
        return Violation(
            "no_lease_false_success",
            "rank(s) %s completed their step loop under a lease whose "
            "window carried a failure flag from rank(s) %s — the "
            "revocation was skipped" % (ok, sorted(failed)))
    return None


def _oracle_lease_amortized(variant, sim):
    """The perf property as a protocol invariant: on a fault-free,
    fully-clean schedule the success path pays EXACTLY one comm round
    per step (the piggybacked beat) and ZERO rounds on the op comm —
    a per-op vote sneaking back in is a regression the bench would
    show but this catches structurally."""
    if sim.faults_used:
        return None  # injected crash/hangs legitimately change rounds
    if any(rs.status != "done" or rs.error is not None
           for rs in sim.ranks.values()):
        return None  # scripted-failure variants abort by design
    op_comm = sim.state.get("op_comm")
    hb_comm = sim.state.get("hb_comm")
    expected = sim.state.get("expected_rounds")
    if op_comm is None or expected is None:
        return None
    op_rounds = {}
    hb_rounds = {}
    for _, _, rank, kind, obj, _ in sim.events:
        if kind == "block.ok" and isinstance(obj, tuple) and obj \
                and obj[0] == "comm":
            if obj[1] == op_comm:
                op_rounds[rank] = op_rounds.get(rank, 0) + 1
            elif obj[1] == hb_comm:
                hb_rounds[rank] = hb_rounds.get(rank, 0) + 1
    if op_rounds:
        return Violation(
            "lease_amortized",
            "success path paid per-op vote rounds under an active "
            "lease: %s" % op_rounds)
    bad = {r: n for r, n in hb_rounds.items() if n != expected}
    if bad or len(hb_rounds) != sim.world:
        return Violation(
            "lease_amortized",
            "per-step aggregate rounds off: got %s, expected %d per "
            "rank" % (hb_rounds, expected))
    return None


def _oracle_no_fork(variant, sim):
    intents = {r: rs.result for r, rs in sim.ranks.items()
               if rs.status == "done" and rs.error is None
               and rs.result is not None}
    views = {r: (tuple(i.survivors), i.gen) for r, i in intents.items()}
    if len(set(views.values())) > 1:
        return Violation(
            "no_fork", "disjoint committed resize outcomes: %s" % views)
    board = sim.state.get("board")
    if board is not None:
        commits = {}
        for k, v in board._data.items():
            # proposals carry "survivors" too — only COMMIT records fork
            if "/commit/" in k and isinstance(v, dict) \
                    and "survivors" in v:
                commits.setdefault(frozenset(v["survivors"]),
                                   []).append(v)
        if len(commits) > 1:
            return Violation(
                "no_fork",
                "board carries commit records for %d DIFFERENT survivor "
                "sets: %s" % (len(commits),
                              sorted(sorted(s) for s in commits)))
    return None


def _oracle_no_stale_world_commit(variant, sim):
    """Every commit record must describe a world its members actually
    voted: each folded joiner has a posted join record, each named
    survivor posted at least one proposal for that epoch, and the
    committed generation is exactly ``max(posted gens) + 1`` — a commit
    failing any of these fabricated a world nobody agreed to."""
    board = sim.state.get("board")
    if board is None:
        return None
    data = dict(board._data)
    joins = set()
    for k, v in data.items():
        if k.startswith("rz/join/") and isinstance(v, dict) \
                and v.get("jid"):
            joins.add(str(v["jid"]))
    for key, c in data.items():
        if "/commit/" not in key or not isinstance(c, dict) \
                or "survivors" not in c:
            continue
        epoch = key.split("/")[1]
        for j in c.get("joiners") or ():
            if str(j) not in joins:
                return Violation(
                    "no_stale_world_commit",
                    "commit %s folds joiner %r with NO posted join "
                    "record" % (key, j))
        posters, gens = set(), []
        for k2, v2 in data.items():
            parts = k2.split("/")
            if len(parts) == 4 and parts[0] == "rz" \
                    and parts[1] == epoch and parts[2].startswith("p") \
                    and isinstance(v2, dict):
                posters.add(int(v2["rank"]))
                gens.append(int(v2["gen"]))
        missing = [r for r in c.get("survivors") or ()
                   if int(r) not in posters]
        if missing:
            return Violation(
                "no_stale_world_commit",
                "commit %s names survivor(s) %s that never posted a "
                "proposal for epoch %s" % (key, missing, epoch))
        if gens and int(c["gen"]) != max(gens) + 1:
            return Violation(
                "no_stale_world_commit",
                "commit %s carries gen %d, expected max(posted)+1 = %d"
                % (key, int(c["gen"]), max(gens) + 1))
    return None


def _oracle_joiner_adopts_committed_gen(variant, sim):
    """A joiner that returned cleanly must carry a generation some
    commit record for its epoch actually committed — the join barrier
    (block until a committed epoch folds the jid, adopt ITS outcome)
    is exactly what ``skip_join_barrier`` removes: the mutated joiner
    fabricates a world from visible proposals and keeps its own stale
    generation."""
    board = sim.state.get("board")
    jranks = sim.state.get("joiner_ranks") or ()
    if board is None:
        return None
    commit_gens = {}
    for key, c in board._data.items():
        if "/commit/" in key and isinstance(c, dict) and "gen" in c:
            commit_gens.setdefault(key.split("/")[1], set()).add(
                int(c["gen"]))
    for r in jranks:
        rs = sim.ranks.get(r)
        if rs is None or rs.status != "done" or rs.error is not None \
                or rs.result is None:
            continue
        intent = rs.result
        gens = commit_gens.get(str(int(intent.epoch)), set())
        if int(intent.gen) not in gens:
            return Violation(
                "joiner_adopts_committed_gen",
                "joiner (sim rank %d, jid %s) returned gen %d but "
                "epoch %d committed gen(s) %s — it never adopted a "
                "committed record" % (r, intent.jid, intent.gen,
                                      intent.epoch, sorted(gens)))
    return None


def _oracle_serve_no_cross_delivery(variant, sim):
    """Every token delivered to a request must have been produced FOR
    that request: the serve scenarios encode provenance in the token
    value (``("t", rid, ...)``), so a commit that lands a stale
    (slot, epoch) result into the slot's NEW occupant — the TOCTOU the
    epoch check exists for, reintroduced by ``serve_stale_commit`` —
    shows up as a token whose rid tag disagrees with its recipient."""
    sched = sim.state.get("sched")
    if sched is None:
        return None
    for rid, req in sched._s["reqs"].items():
        for tok in req["tokens"]:
            if isinstance(tok, tuple) and len(tok) >= 2 \
                    and tok[1] != rid:
                return Violation(
                    "serve_no_cross_delivery",
                    "request %s was delivered token %r produced for "
                    "request %s — a stale (slot, epoch) commit crossed "
                    "requests" % (rid, tok, tok[1]))
    return None


def _oracle_serve_conservation(variant, sim):
    """Allocator soundness at every terminal state (crash/hang runs
    included — scheduler transactions are atomic between yield
    points): every page free or owned exactly once, no double
    alloc/free ever observed.  On clean fault-free schedules where the
    engine drained, additionally: every request reached a terminal
    state (admission liveness — nobody starves forever)."""
    sched = sim.state.get("sched")
    if sched is None:
        return None
    problems = sched.check_conservation()
    if problems:
        return Violation(
            "serve_conservation",
            "page-allocator invariant broken: %s" % "; ".join(
                problems[:4]))
    clean = (sim.faults_used == 0
             and sim.state.get("engine_drained")
             and all(rs.status == "done" and rs.error is None
                     for rs in sim.ranks.values()))
    if clean:
        stuck = sorted(
            rid for rid, req in sched._s["reqs"].items()
            if req["state"] not in ("done", "cancelled", "failed"))
        if stuck:
            return Violation(
                "serve_conservation",
                "engine drained on a fault-free schedule yet "
                "request(s) %s never reached a terminal state" % stuck)
    return None


def _oracle_serve_refcount_conservation(variant, sim):
    """Prefix-cache refcount soundness at every terminal state: every
    cached page's refcount equals the number of slots holding it
    shared, refs never negative, no cached page simultaneously free —
    the invariant that makes \"evict only at refcount 0\" safe."""
    sched = sim.state.get("sched")
    if sched is None:
        return None
    problems = sched.check_refcounts()
    if problems:
        return Violation(
            "serve_refcount_conservation",
            "prefix-cache refcount invariant broken: %s"
            % "; ".join(problems[:4]))
    return None


def _oracle_serve_shared_no_cross_delivery(variant, sim):
    """No request's output may be served through another request's
    writes: a cached prefix page must hold exactly the KV content its
    trie key promises (the scenarios model device memory in
    ``state[\"page_mem\"]``, content = the token at each position).
    Skipping the copy-on-write (``skip_cow_copy``) lets a request's
    decode append land INSIDE a shared page, so a later request
    walking the trie would attend to foreign KV — visible here as
    cached content disagreeing with the key."""
    sched = sim.state.get("sched")
    mem = sim.state.get("page_mem")
    if sched is None or mem is None:
        return None
    psz = sched.page_size
    for key, val in sched._s["prefix"].items():
        page, blk = val[0], key[1]
        for off in range(min(psz, len(blk))):
            got = mem.get((page, off), blk[off])
            if got != blk[off]:
                return Violation(
                    "serve_shared_no_cross_delivery",
                    "cached page %d offset %d holds %r but its trie "
                    "key promises %r — a write crossed into a shared "
                    "page (copy-on-write skipped?)"
                    % (page, off, got, blk[off]))
    return None


def _oracle_exactly_once_delivery(variant, sim):
    """Unconditional (fault-free and faulty runs alike): no request may
    be delivered twice — the accepted-delivery ledger holds at most one
    entry per gid (``skip_failover_dedupe`` reintroduces the late echo
    of a presumed-dead replica landing a SECOND delivery) — and every
    delivered request's tokens must be the sequence its PINNED seed
    produces (a router failing to pin seeds at admission lets a
    failover replay diverge from the original attempt)."""
    router = sim.state.get("router")
    if router is None:
        return None
    counts = {}
    for gid, _att in router.delivery_log():
        counts[gid] = counts.get(gid, 0) + 1
    dups = {g: n for g, n in counts.items() if n > 1}
    if dups:
        return Violation(
            "exactly_once_delivery",
            "request(s) delivered more than once (gid -> deliveries): "
            "%s — the failover dedupe store let a duplicate through"
            % dups)
    for gid, req in router.requests().items():
        if req["state"] != "done":
            continue
        seed = (req.get("sampling") or {}).get("seed")
        want = tuple(("t", seed, g) for g in range(req["max_new"]))
        if tuple(req["tokens"]) != want:
            return Violation(
                "exactly_once_delivery",
                "request %d delivered tokens %r, expected the pinned-"
                "seed sequence %r — a failover replay diverged (seed "
                "not pinned at admission?)"
                % (gid, tuple(req["tokens"]), want))
    return None


def _oracle_no_lost_request(variant, sim):
    """On a drained run with at least one replica still healthy, every
    admitted request must have completed AND appear in the delivery
    ledger — failover may delay a request, never lose it.  (A total
    outage — every replica declared dead — legitimately fails the
    stragglers, so the oracle stands down.)"""
    if not sim.state.get("router_drained"):
        return None
    router = sim.state.get("router")
    if router is None:
        return None
    if len(router.stats()["dead"]) >= len(router.servers):
        return None
    delivered = set(g for g, _ in router.delivery_log())
    for gid, req in router.requests().items():
        if req["state"] != "done" or gid not in delivered:
            return Violation(
                "no_lost_request",
                "request %d ended %s (delivered=%s) on a drained run "
                "with healthy replicas — failover lost it"
                % (gid, req["state"], gid in delivered))
    return None


_ORACLES = {
    "no_deadlock": _oracle_no_deadlock,
    "attributed_errors": _oracle_attributed_errors,
    "no_solo_reissue": _oracle_no_solo_reissue,
    "no_double_apply": _oracle_no_double_apply,
    "equal_generations": _oracle_equal_generations,
    "no_fork": _oracle_no_fork,
    "no_stale_world_commit": _oracle_no_stale_world_commit,
    "joiner_adopts_committed_gen": _oracle_joiner_adopts_committed_gen,
    "no_lease_false_success": _oracle_no_lease_false_success,
    "lease_amortized": _oracle_lease_amortized,
    "serve_no_cross_delivery": _oracle_serve_no_cross_delivery,
    "serve_conservation": _oracle_serve_conservation,
    "serve_refcount_conservation": _oracle_serve_refcount_conservation,
    "serve_shared_no_cross_delivery":
        _oracle_serve_shared_no_cross_delivery,
    "exactly_once_delivery": _oracle_exactly_once_delivery,
    "no_lost_request": _oracle_no_lost_request,
}


# ----------------------------------------------------------------------
# scenarios
# ----------------------------------------------------------------------
class Variant:
    """One concrete world + failure script explored exhaustively."""

    def __init__(self, scenario, name, world, make_runners, oracles,
                 mutating=False, allowed=()):
        self.scenario = scenario
        self.name = name
        self.world = world
        self.make_runners = make_runners
        self.oracles = tuple(oracles)
        self.mutating = mutating
        self.allowed = tuple(allowed)

    def build(self, sim):
        return self.make_runners(self, sim)


class _ScriptedFatal(RuntimeError):
    """Scenario-scripted non-transient failure (stands in for an OOM /
    compile error): the failing rank re-raises it, peers abort."""


def _zero_policy():
    return _fault.RetryPolicy(max_retries=2, base_delay=0.0,
                              max_delay=0.0, timeout=False)


def _consensus_runners(script, ops=2):
    """Runners for world ranks each driving ``ops`` coordinated_calls
    through real InProcessComm endpoints.  ``script`` maps
    ``(rank, op, attempt)`` to "entry" | "mid" | "fatal"."""

    def build(variant, sim):
        comms = _fdist.InProcessComm.create(variant.world)
        comms[0]._shared["sched"] = sim
        gens = [_fdist.Generation() for _ in range(variant.world)]
        state = {"attempts": {}, "applied": {}, "final_gen": {},
                 "gens": gens}
        counters = {}

        def make_fn(rank, opi):
            def fn():
                k = counters.get((rank, opi), 0)
                counters[(rank, opi)] = k + 1
                sim_point("op.enter", obj=("op", opi), write=True,
                          detail="rank %d op %d attempt %d gen %d"
                          % (rank, opi, k, gens[rank].value))
                state["attempts"].setdefault((rank, opi), []).append(
                    gens[rank].value)
                act = script.get((rank, opi, k))
                if act == "entry":
                    raise _fault.InjectedFault(
                        "scripted entry-seam failure")
                sim_point("op.apply", obj=("op", opi), write=True,
                          detail="rank %d op %d applies" % (rank, opi))
                state["applied"][(rank, opi)] = \
                    state["applied"].get((rank, opi), 0) + 1
                if act == "mid":
                    raise _fault.TransientError(
                        "scripted mid-op transient")
                if act == "fatal":
                    raise _ScriptedFatal("scripted fatal failure")
                return "ok%d" % opi

            return fn

        def runner(rank):
            out = []
            for opi in range(ops):
                out.append(_fdist.coordinated_call(
                    make_fn(rank, opi), comm=comms[rank],
                    op="op%d" % opi, policy=_zero_policy(),
                    mutating=variant.mutating, gen=gens[rank]))
            state["final_gen"][rank] = gens[rank].value
            return out

        return [runner] * variant.world, state

    return build


def _resize_runners(lost_by_rank, dead=()):
    """Runners for a vote_resize world: ``lost_by_rank[r]`` is what rank
    r believes is already dead; ranks in ``dead`` crash at their first
    yield (a SIGKILLed peer)."""

    def build(variant, sim):
        board = _felastic.InProcessBoard()
        board._sched = sim
        state = {"final_gen": {}, "board": board, "attempts": {}}

        def runner(rank):
            if rank in dead:
                sim_point("resize.dead", obj=("rank", rank), write=False,
                          detail="rank %d preempted" % rank)
                raise SimCrash()
            intent = _felastic.vote_resize(
                board, rank=rank, world=variant.world,
                lost=lost_by_rank.get(rank, ()), gen=0, epoch=1,
                drain=1.0, min_world=1,
                coord_hint="127.0.0.1:%d" % (9000 + rank))
            state["final_gen"][rank] = intent.gen
            return intent

        return [runner] * variant.world, state

    return build


def _grow_runners(joiner_ids, lost_by_rank=None, dead=()):
    """Runners for a GROW world: the first ``world - len(joiner_ids)``
    sim ranks are survivors running ``vote_resize`` (which sweeps and
    folds pending join records), the rest are newcomers running
    ``vote_join``.  Both outcomes are legal per schedule: a joiner
    whose record landed before the survivors' sweep is folded into the
    committed epoch (and must adopt ITS generation/world — the join
    barrier); one that landed after stays pending and aborts with the
    attributed ``ElasticAbortError`` when its drain expires.  What may
    NEVER happen: a commit naming a world nobody voted
    (no_stale_world_commit) or a joiner stepping at its own notion of
    the fleet (joiner_adopts_committed_gen, no_fork,
    equal_generations — the ``skip_join_barrier`` mutation's
    signature)."""
    lost_by_rank = lost_by_rank or {}

    def build(variant, sim):
        board = _felastic.InProcessBoard()
        board._sched = sim
        nsurv = variant.world - len(joiner_ids)
        state = {"final_gen": {}, "board": board, "attempts": {},
                 "joiner_ranks": tuple(range(nsurv, variant.world))}

        def survivor(rank):
            if rank in dead:
                sim_point("resize.dead", obj=("rank", rank), write=False,
                          detail="rank %d preempted" % rank)
                raise SimCrash()
            intent = _felastic.vote_resize(
                board, rank=rank, world=nsurv,
                lost=lost_by_rank.get(rank, ()), gen=0, epoch=1,
                drain=1.0, min_world=1,
                coord_hint="127.0.0.1:%d" % (9000 + rank))
            state["final_gen"][rank] = intent.gen
            return intent

        def make_joiner(simrank, jid):
            def joiner(_rank):
                intent = _felastic.vote_join(
                    board, jid, drain=3.0,
                    coord_hint="127.0.0.1:%d" % (9000 + simrank))
                state["final_gen"][simrank] = intent.gen
                return intent
            return joiner

        runners = [survivor] * nsurv
        for i, jid in enumerate(joiner_ids):
            runners.append(make_joiner(nsurv + i, jid))
        return runners, state

    return build


def _amortized_runners(script, steps=1, ops=2):
    """Runners for world ranks driving ``steps`` step-lease windows of
    ``ops`` coordinated_calls each through the REAL
    ``StepLease``/``Heartbeat`` code over InProcessComm endpoints: a
    handshake beat activates the lease, ops ride the success-path fast
    lane (zero per-op rounds), a boundary beat per step carries the
    aggregate vote.  ``script`` maps ``(rank, step, k)`` to
    ``"entry"`` (InjectedFault before the apply) or ``"mid"``
    (TransientError after it) — either one must revoke the lease and
    abort EVERY rank through the beat round."""

    def build(variant, sim):
        hb_comms = _fdist.InProcessComm.create(variant.world)
        op_comms = _fdist.InProcessComm.create(variant.world)
        hb_comms[0]._shared["sched"] = sim
        op_comms[0]._shared["sched"] = sim
        gens = [_fdist.Generation() for _ in range(variant.world)]
        hbs = [_fdist.Heartbeat(comm=hb_comms[r], every=1, timeout=5.0)
               for r in range(variant.world)]
        leases = []
        for r in range(variant.world):
            lease = _fdist.StepLease(heartbeat=hbs[r], gen=gens[r],
                                     rearm=1)
            lease._sim = sim  # schedule-point seam for the lease state
            hbs[r].lease = lease
            leases.append(lease)
        state = {"attempts": {}, "applied": {}, "final_gen": {},
                 "gens": gens, "step_ok": {},
                 "failed_ranks": sorted({r for (r, _s, _k) in script}),
                 "hb_comm": id(hb_comms[0]._shared),
                 "op_comm": id(op_comms[0]._shared),
                 "expected_rounds": 1 + steps}
        counters = {}

        def make_fn(rank, s, k):
            opi = "s%dk%d" % (s, k)

            def fn():
                a = counters.get((rank, opi), 0)
                counters[(rank, opi)] = a + 1
                sim_point("op.enter", obj=("op", opi), write=True,
                          detail="rank %d %s attempt %d gen %d"
                          % (rank, opi, a, gens[rank].value))
                state["attempts"].setdefault((rank, opi), []).append(
                    gens[rank].value)
                act = script.get((rank, s, k))
                if act == "entry":
                    raise _fault.InjectedFault(
                        "scripted entry-seam failure under lease")
                sim_point("op.apply", obj=("op", opi), write=True,
                          detail="rank %d %s applies" % (rank, opi))
                state["applied"][(rank, opi)] = \
                    state["applied"].get((rank, opi), 0) + 1
                if act == "mid":
                    raise _fault.TransientError(
                        "scripted mid-op transient under lease")
                return "ok"

            return fn

        def runner(rank):
            hbs[rank].beat(step=0)  # handshake: unanimous -> ACTIVE
            for s in range(steps):
                for k in range(ops):
                    _fdist.coordinated_call(
                        make_fn(rank, s, k), comm=op_comms[rank],
                        op="s%dk%d" % (s, k), policy=_zero_policy(),
                        mutating=variant.mutating, gen=gens[rank],
                        lease=leases[rank])
                hbs[rank].beat(step=s + 1)  # the aggregate vote
            state["step_ok"][rank] = True
            state["final_gen"][rank] = gens[rank].value
            return "done"

        return [runner] * variant.world, state

    return build


def _serve_runners(submits, cancels=(), slots=2, pages=7, page_size=2,
                   max_pages_per_slot=4, iters=24):
    """Runners for the mx.serve continuous-batching protocol: ONE
    engine rank driving the REAL ``SlotScheduler`` through the
    production iteration shape — begin_step, then admissions/prefills
    OVERLAPPING the (simulated) in-flight decode, then the epoch-checked
    commit — plus one submitter rank per entry of ``submits``
    (lists of ``(prompt_len, max_new)``; ``prompt_len`` may instead be
    a token tuple, submitted as an explicit prompt so the prefix cache
    engages).  Submitters in ``cancels`` (by ``(rank_idx, req_idx)``)
    wait until their request is RUNNING, then cancel it — the
    mid-flight slot-reassignment window the epoch protocol exists for.
    Tokens are provenance tuples ``("t", rid, step)`` so the
    cross-delivery oracle can attribute every delivery.

    The engine also models DEVICE MEMORY in ``state["page_mem"]``:
    ``(page, offset) -> content`` where position p of a sequence holds
    token p (a sound model of KV content for prefix sharing — two
    requests write identical content at a position iff their prefixes
    match through it).  Prefill writes ``[prefill_start, prefill_len)``
    at the plan's table, copy-on-write duplicates the source page
    first, and the decode step writes each snapshotted slot's fed
    token at its OLD coordinates — stale after a mid-flight cancel,
    which is harmless because the engine is sequential: any new
    owner's prefill rewrites the page before anything reads it.  The
    ``serve_shared_no_cross_delivery`` oracle audits this memory
    against the prefix trie.
    """

    def build(variant, sim):
        sched = _serve.SlotScheduler(slots, pages, page_size,
                                     max_pages_per_slot, sim=sim)
        total = sum(len(s) for s in submits)
        mem = {}
        state = {"sched": sched, "sub_done": set(), "page_mem": mem}

        def _full_seq(rid):
            req = sched._s["reqs"][rid]
            prompt = req.get("prompt")
            if prompt is None:
                prompt = tuple(("p", rid, g)
                               for g in range(req["prompt_len"]))
            return prompt + tuple(req["tokens"])

        def engine(rank):
            for it in range(iters):
                reqs = sched._s["reqs"]
                drained = (len(state["sub_done"]) == len(submits)
                           and len(reqs) == total
                           and all(r["state"] in ("done", "cancelled",
                                                  "failed")
                                   for r in reqs.values()))
                if drained:
                    state["engine_drained"] = True
                    sim.state["engine_drained"] = True
                    return "drained"
                snap = sched.begin_step()
                # the in-flight decode: admissions overlap it, so a
                # cancel landing here reassigns a snapshotted slot
                sim_point("engine.decode", obj=("sched", id(sched)),
                          write=False,
                          detail="step %d over %d slot(s)"
                          % (it, len(snap)))
                for e in snap:
                    # device write model: the fed token's KV lands at
                    # cache position len of the snapshotted table
                    page = e["pages"][e["len"] // page_size]
                    mem[(page, e["len"] % page_size)] = e["last_tok"]
                while True:
                    plan = sched.admit_next()
                    if plan is None:
                        break
                    sim_point("engine.prefill",
                              obj=("sched", id(sched)), write=False,
                              detail="rid %s" % plan["rid"])
                    if plan.get("cow"):
                        src, dst = plan["cow"]
                        for off in range(page_size):
                            if (src, off) in mem:
                                mem[(dst, off)] = mem[(src, off)]
                    seqf = _full_seq(plan["rid"])
                    for g in range(plan.get("prefill_start", 0),
                                   plan["prefill_len"]):
                        page = plan["pages"][g // page_size]
                        mem[(page, g % page_size)] = seqf[g]
                    sched.commit_prefill(plan,
                                         ("t", plan["rid"], "p%d" % it))
                sched.commit_step(
                    snap, [(("t", e["rid"], it), False) for e in snap])
            return "capped"

        def make_submitter(i):
            def run(rank):
                for j, (plen, mnew) in enumerate(submits[i]):
                    if isinstance(plen, tuple):
                        rid = sched.submit(len(plen), mnew, prompt=plen)
                    else:
                        rid = sched.submit(plen, mnew)
                    if (i, j) in cancels:
                        # the cancel-mid-flight window: wait (virtual
                        # time) until the engine admitted us, then
                        # yank the request out from under its decode
                        sim.block(
                            lambda rid=rid: sched.request(rid)["state"]
                            != "waiting",
                            obj=("sched", id(sched)), timeout=90.0,
                            detail="await running rid %d" % rid)
                        sched.cancel(rid)
                state["sub_done"].add(i)
                return "submitted"
            return run

        runners = [engine] + [make_submitter(i)
                              for i in range(len(submits))]
        return runners, state

    return build


class _FakeReplica:
    """A scheduler-less serving replica for the router scenario: just
    the ``submit`` surface :class:`~mxnet_tpu_torch.serve_router.ReplicaGroup`
    dispatches into, with a visible work queue the engine runner
    drains.  CRUCIALLY the sampling seed defaults to the REPLICA-LOCAL
    rid (exactly like the real scheduler's ``_norm_sampling``), so a
    router that fails to pin seeds at admission produces visibly
    different tokens after a failover — the ``exactly_once_delivery``
    oracle's second clause."""

    def __init__(self, idx):
        self.idx = idx
        self.queue = []        # pending submission dicts, FIFO
        self.next_rid = 0

    def submit(self, prompt, max_new=None, sampling=None,
               deadline=None):
        rid = self.next_rid
        self.next_rid += 1
        sp = dict(sampling or {})
        sp.setdefault("seed", rid)   # replica-local default
        self.queue.append({"rid": rid, "prompt": tuple(prompt),
                           "max_new": 1 if max_new is None
                           else int(max_new),
                           "sampling": sp})
        return rid


def _router_runners(n_requests, replicas=2, max_new=2, iters=40,
                    presubmit=False):
    """Runners for the ReplicaGroup failover protocol: one engine
    runner per fake replica, plus (unless ``presubmit``) one submitter
    rank admitting ``n_requests`` through the REAL router.  Each
    engine drains its replica's queue and — this is the window the
    scenario exists for — BINDS the (gid, attempt) it will deliver
    BEFORE its ``router.deliver_window`` yield point, exactly like the
    real waiter thread's closure: an engine hung there and woken at
    quiescence delivers a LATE result for an attempt the router
    already failed over, which the dedupe store must drop
    (``skip_failover_dedupe`` lets it through).  Engines also play
    liveness watcher: a crashed/hung peer engine is reported through
    ``router._on_replica_dead`` — the same failover entry point the
    production waiter threads use.  Tokens carry the SEED they were
    sampled under (``("t", seed, step)``), so the oracle can check a
    failover replay is bitwise what the pinned seed demands.

    ``presubmit`` admits the requests during build, OUTSIDE the sim
    (the router is wired to the scheduler only afterwards): the
    dedupe-race variant uses it so the critical decision point — an
    engine hung between binding and delivering — sits one step from
    the schedule root, where the DFS frontier finds it within the CI
    smoke budget instead of behind the submitter's own yield points."""

    def build(variant, sim):
        backends = [_FakeReplica(i) for i in range(replicas)]
        router = _srouter.ReplicaGroup(backends, sim=None,
                                       threaded=False, queue_limit=0)
        state = {"router": router, "handled": set(),
                 "sub_done": False}
        if presubmit:
            for _k in range(n_requests):
                router.submit((1, 2), max_new=max_new)
            state["sub_done"] = True
        router._sim = sim   # yield points live from here on
        off = 0 if presubmit else 1   # replica j's engine = rank j+off

        def _drained():
            reqs = router.requests()
            return (state["sub_done"] and len(reqs) == n_requests
                    and all(r["state"] in _srouter.TERMINAL
                            for r in reqs.values()))

        def make_engine(i):
            def engine(rank):
                be = backends[i]
                for it in range(iters):
                    # liveness watch: a dead/hung peer ENGINE means its
                    # replica stopped serving — declare it and fail its
                    # in-flight requests over
                    for j in range(replicas):
                        if j == i or j in state["handled"]:
                            continue
                        peer = sim.ranks[j + off]
                        if peer.status == "crashed" or peer.hung:
                            state["handled"].add(j)
                            router._on_replica_dead(j)
                    if _drained():
                        state["router_drained"] = True
                        sim.state["router_drained"] = True
                        return "drained"
                    if not be.queue:
                        sim_point("router.idle",
                                  obj=("router", id(router)),
                                  write=False,
                                  detail="engine %d idle" % i)
                        continue
                    sub = be.queue.pop(0)
                    # bind (gid, attempt) NOW — the real waiter's
                    # closure does exactly this before blocking
                    bound = None
                    for gid, r in router.requests().items():
                        if (r["state"] == "inflight"
                                and r["replica"] == i
                                and r["local_rid"] == sub["rid"]):
                            bound = (gid, r["attempt"])
                            break
                    if bound is None:
                        continue  # already failed over / terminal
                    toks = tuple(("t", sub["sampling"]["seed"], g)
                                 for g in range(sub["max_new"]))
                    sim_point("router.deliver_window",
                              obj=("router", id(router)), write=True,
                              detail="replica %d rid %d gid %d"
                              % (i, sub["rid"], bound[0]))
                    router._deliver(bound[0], bound[1],
                                    {"state": "done", "tokens": toks})
                return "capped"
            return engine

        def submitter(rank):
            for _k in range(n_requests):
                try:
                    router.submit((1, 2), max_new=max_new)
                except RuntimeError:
                    break  # total outage: nothing left to submit into
            state["sub_done"] = True
            return "submitted"

        engines = [make_engine(i) for i in range(replicas)]
        runners = engines if presubmit else [submitter] + engines
        return runners, state

    return build


_CONSENSUS_ORACLES = ("no_deadlock", "attributed_errors",
                      "no_solo_reissue", "no_double_apply",
                      "equal_generations")
_AMORTIZED_ORACLES = _CONSENSUS_ORACLES + ("no_lease_false_success",
                                           "lease_amortized")
_RESIZE_ORACLES = ("no_deadlock", "attributed_errors", "no_fork",
                   "equal_generations")
_GROW_ORACLES = ("no_deadlock", "attributed_errors", "no_fork",
                 "equal_generations", "no_stale_world_commit",
                 "joiner_adopts_committed_gen")
_SERVE_ORACLES = ("no_deadlock", "attributed_errors",
                  "serve_no_cross_delivery", "serve_conservation",
                  "serve_refcount_conservation",
                  "serve_shared_no_cross_delivery")
_ROUTER_ORACLES = ("no_deadlock", "attributed_errors",
                   "exactly_once_delivery", "no_lost_request")


def _consensus_variants():
    mk = lambda name, script, **kw: Variant(  # noqa: E731
        "consensus", name, 3, _consensus_runners(script),
        _CONSENSUS_ORACLES, **kw)
    return [
        mk("ok", {}),
        mk("entry_fail", {(1, 0, 0): "entry"}),
        mk("entry_fail_all_mutating",
           {(r, 0, 0): "entry" for r in range(3)}, mutating=True),
        mk("mid_fail_mutating", {(1, 0, 0): "mid"}, mutating=True),
        mk("fatal", {(1, 0, 0): "fatal"}, allowed=(_ScriptedFatal,)),
    ]


def _resize_variants():
    mk = lambda name, lost, dead=(): Variant(  # noqa: E731
        "resize", name, 3, _resize_runners(lost, dead), _RESIZE_ORACLES)
    return [
        # 3 -> 2: rank 2 SIGKILLed, survivors pre-exclude it
        mk("peer_dead", {0: (2,), 1: (2,)}, dead=(2,)),
        # rank 2 merely slow: it votes the full set, peers exclude it
        mk("slow_peer", {0: (2,), 1: (2,)}),
        # in-place resize (CoordinatedAbortError trigger): all vote,
        # crashes/hangs injected by the explorer make it 3 -> 2
        mk("in_place", {}),
    ]


def _grow_variants():
    mk = lambda name, joiners, world, lost=None, dead=(): Variant(  # noqa: E731
        "resize_grow", name, world, _grow_runners(joiners, lost, dead),
        _GROW_ORACLES)
    return [
        # 2 survivors + 1 newcomer: the basic mid-job join
        mk("join", ("j1",), 3),
        # two newcomers race the same epoch: folded in sorted-jid
        # order, or one misses the sweep and times out — never forked
        mk("join_pair", ("j1", "j2"), 4),
        # shrink AND grow in one epoch: rank 2 SIGKILLed (survivors
        # pre-exclude it) while a replacement joins: the
        # preempt-then-respawn trajectory
        mk("replace_dead", ("j1",), 4, lost={0: (2,), 1: (2,)},
           dead=(2,)),
    ]


def _amortized_variants():
    mk = lambda name, script, steps=1, ops=2, **kw: Variant(  # noqa: E731
        "consensus_amortized", name, 3,
        _amortized_runners(script, steps=steps, ops=ops),
        _AMORTIZED_ORACLES, **kw)
    return [
        # success path: two steps of two ops each, mutating (so the
        # no_double_apply oracle is live) — the lease_amortized oracle
        # pins "exactly one round per step, zero on the op comm"
        mk("ok", {}, steps=2, ops=2, mutating=True),
        # rank 1 fails op 0 at the ENTRY seam mid-step: escalation must
        # abort every rank through the beat round (no step_ok anywhere)
        mk("entry_fail_mid_step", {(1, 0, 0): "entry"}, mutating=True),
        # rank 1 fails AFTER applying (mid-op): peers that already
        # applied their copy must abort, never re-issue
        mk("mid_fail_mutating", {(1, 0, 1): "mid"}, mutating=True),
        # the nasty window: the failure lands in step 1, after every
        # rank already advanced past step 0 optimistically; the delay
        # sweep additionally makes rank 1's escalation beat arbitrarily
        # LATE relative to peers that already parked in (or timed out
        # of) their boundary beat
        mk("late_peer_flag", {(1, 1, 0): "mid"}, steps=2, ops=2,
           mutating=True),
    ]


def _serve_variants():
    mk = lambda name, submits, **kw: Variant(  # noqa: E731
        "serve_sched", name, 1 + len(submits),
        _serve_runners(submits, **kw), _SERVE_ORACLES)
    return [
        # the TOCTOU window: submitter 0's request is cancelled while
        # its decode is in flight; with ONE slot the freed slot is
        # immediately reassigned to submitter 1's request, so a commit
        # that skips the epoch check (serve_stale_commit) delivers the
        # stale token into the wrong request
        mk("cancel_race", [[(3, 3)], [(3, 3)]], cancels={(0, 0)},
           slots=1, pages=9, page_size=2, max_pages_per_slot=4),
        # steady continuous batching: two submitters' requests join and
        # leave the running batch with ample pages — admission
        # liveness + allocator conservation under arbitrary schedules
        mk("steady", [[(3, 2), (2, 3)], [(4, 2)]],
           slots=2, pages=13, page_size=2, max_pages_per_slot=4),
        # page pressure: the pool cannot hold both requests at peak, so
        # begin_step must preempt (free + requeue) and later readmit —
        # the eviction/preemption half of the protocol
        mk("overload_preempt", [[(3, 4)], [(3, 4)]],
           slots=2, pages=5, page_size=2, max_pages_per_slot=4,
           iters=30),
        # prefix sharing + copy-on-write: submitter 0's prompt seeds
        # the trie with two full blocks; submitter 1's prompt covers
        # the deeper cached block only PARTIALLY (lcp 1 of 2), so its
        # admission must COW that page before its own decode appends
        # into it.  skip_cow_copy leaves the shared page in the table
        # — the decode write corrupts the cached block, caught by
        # serve_shared_no_cross_delivery; refcount conservation runs
        # over the same schedules
        mk("prefix_share", [[((7, 8, 9, 10), 2)], [((7, 8, 9), 2)]],
           slots=2, pages=9, page_size=2, max_pages_per_slot=4),
    ]


def _router_variants():
    mk = lambda name, n, world, **kw: Variant(  # noqa: E731
        "serve_router", name, world, _router_runners(n, **kw),
        _ROUTER_ORACLES)
    return [
        # ONE pre-admitted request, so every schedule is about ITS
        # delivery: the engine hangs inside its bound deliver window,
        # the peer engine declares the replica dead and fails the
        # request over, the hung engine wakes at quiescence and
        # delivers a LATE duplicate — the dedupe store must drop it
        # (skip_failover_dedupe is caught here, fast)
        mk("dedupe_race", 1, 2, presubmit=True),
        # steady failover with a live submitter rank: three requests
        # spread across two replicas; any replica may die at any point
        # — every accepted request still completes exactly once with
        # its pinned-seed tokens
        mk("failover", 3, 3),
    ]


SCENARIOS = {
    "consensus": _consensus_variants,
    "consensus_amortized": _amortized_variants,
    "resize": _resize_variants,
    "resize_grow": _grow_variants,
    "serve_sched": _serve_variants,
    "serve_router": _router_variants,
}


# ----------------------------------------------------------------------
# mutation seams (checker-liveness proof)
# ----------------------------------------------------------------------
KNOWN_MUTATIONS = {
    "solo_reissue": _fdist,        # coordinated_call retries alone
    "skip_commit_funnel": _felastic,  # any rank commits its own view
    "skip_lease_revoke": _fdist,   # a rank ignores a peer's lease flag
    "skip_join_barrier": _felastic,  # a joiner steps without adopting
    "serve_stale_commit": _serve,  # commit skips the slot-epoch check
    "skip_cow_copy": _serve,       # prefix admit keeps the shared page
    "skip_failover_dedupe": _srouter,  # router re-delivers a late echo
}


@contextlib.contextmanager
def mutations(*names):
    """Arm deliberately reintroduced protocol bugs (tests only).
    Validates every name BEFORE arming anything, and disarms in a
    finally — a typo'd name must never leave a broken protocol armed
    for the rest of the process."""
    for n in names:
        if n not in KNOWN_MUTATIONS:
            raise KeyError(
                "unknown mutation %r (known: %s)"
                % (n, ", ".join(sorted(KNOWN_MUTATIONS))))
    armed = []
    try:
        for n in names:
            KNOWN_MUTATIONS[n]._TEST_MUTATIONS.add(n)
            armed.append(n)
        yield
    finally:
        for n in armed:
            KNOWN_MUTATIONS[n]._TEST_MUTATIONS.discard(n)


# ----------------------------------------------------------------------
# exploration
# ----------------------------------------------------------------------
_QUIET_LOGGERS = ("mxnet_tpu_torch.fault.elastic",
                  "mxnet_tpu_torch.fault.dist", "mxnet_tpu_torch.serve",
                  "mxnet_tpu_torch.serve_router")


@contextlib.contextmanager
def _quiet():
    """Thousands of simulated vote rounds would each log their
    drops/retries — silence the protocol loggers for the exploration."""
    saved = []
    for name in _QUIET_LOGGERS:
        lg = logging.getLogger(name)
        saved.append((lg, lg.level))
        lg.setLevel(logging.CRITICAL)
    try:
        yield
    finally:
        for lg, level in saved:
            lg.setLevel(level)


def _run_one(variant, prefix, sleep0, budget, rng=None):
    ctl = Controller(prefix=prefix, sleep0=sleep0, rng=rng)
    sim = Scheduler(variant.world, ctl, step_limit=budget.steps,
                    fault_budget=budget.faults)
    runners, state = variant.build(sim)
    sim.state = state
    with _quiet():
        sim.run(runners)
    return sim, ctl


def _check(variant, sim):
    for name in variant.oracles:
        v = _ORACLES[name](variant, sim)
        if v is not None:
            return v
    return None


def _minimize(variant, budget, trace, oracle):
    """Greedy schedule shrink: shortest failing prefix, then drop each
    remaining choice that is not needed to reproduce the violation.
    Time-boxed: a violation first reproduced deep in a random walk can
    carry thousands of decisions, and the greedy-drop loop is O(n^2)
    replays — minimization must never stall the gate that just found a
    bug, so it returns the best shrink reached at the deadline."""
    deadline = time.monotonic() + min(10.0, max(2.0, budget.seconds))

    def fails(prefix):
        sim, _ = _run_one(variant, tuple(prefix), frozenset(), budget)
        v = _check(variant, sim)
        return (sim, v) if v is not None and v.oracle == oracle else None

    cur = list(trace)
    for n in range(len(cur) + 1):
        if time.monotonic() > deadline:
            break
        hit = fails(cur[:n])
        if hit:
            cur = cur[:n]
            break
    changed = True
    while changed and time.monotonic() < deadline:
        changed = False
        for i in reversed(range(len(cur))):
            if time.monotonic() > deadline:
                break
            cand = cur[:i] + cur[i + 1:]
            if fails(cand):
                cur = cand
                changed = True
    hit = fails(cur)
    if hit is None:  # replay-nondeterminism guard: keep the original
        sim, _ = _run_one(variant, tuple(trace), frozenset(), budget)
        return list(trace), sim, None
    sim, v = hit
    return cur, sim, v


class VariantResult:
    def __init__(self, name, schedules, dfs, sweeps, walks,
                 counterexample):
        self.name = name
        self.schedules = schedules
        self.dfs = dfs
        self.sweeps = sweeps
        self.walks = walks
        self.counterexample = counterexample


def _explore_variant(variant, budget, deadline):
    """Three exploration phases sharing one schedule budget:

    1. bounded DFS (preemption bound + sleep sets) over scheduling and
       fault choices — systematic near the default path;
    2. a deterministic **slow-rank delay sweep**: for each rank, hang it
       at the start and wake it at EVERY later step of the resulting
       default schedule — the "one slow peer, arbitrary delay" family
       (stale-round commits, late vote completion) that sits beyond any
       small preemption bound;
    3. seeded random walks with occasional faults until the budget or
       the deadline runs out.
    """
    seen = set()
    counts = {"dfs": 0, "sweep": 0, "walk": 0}

    def attempt(phase, prefix, sleep0=frozenset(), rng=None):
        sim, ctl = _run_one(variant, prefix, sleep0, budget, rng=rng)
        seen.add(tuple(ctl.trace))
        counts[phase] += 1
        v = _check(variant, sim)
        if v is None:
            return None, ctl
        sched, msim, mv = _minimize(variant, budget, ctl.trace, v.oracle)
        mv = mv or v
        return VariantResult(
            variant.name, len(seen), counts["dfs"], counts["sweep"],
            counts["walk"],
            Counterexample(variant.scenario, variant.name, mv.oracle,
                           mv.message, sched, msim.events)), ctl

    def out_of_budget():
        return len(seen) >= budget.schedules or \
            time.monotonic() > deadline

    # -- phase 1: bounded DFS (front 50% of the schedule budget) -------
    stack = [((), frozenset())]
    dfs_budget = max(1, int(budget.schedules * 0.5))
    while stack and len(seen) < dfs_budget and \
            time.monotonic() < deadline:
        prefix, sleep0 = stack.pop()
        res, ctl = attempt("dfs", prefix, sleep0)
        if res is not None:
            return res
        # reversed: the LIFO stack then pops SHALLOW alternatives first,
        # so divergence at the root (the classic hang-at-start) is
        # explored before deep tail permutations of the default path
        for i in reversed(range(len(prefix), len(ctl.nodes))):
            node = ctl.nodes[i]
            base = tuple(ctl.trace[:i])
            prev_tried = [node.chosen[1]] if node.chosen[0] == RUN else []
            for kind, r in node.options:
                if (kind, r) == node.chosen:
                    continue
                if kind == RUN:
                    if r in node.sleep:
                        continue
                    cost = 1 if (node.prev is not None
                                 and r != node.prev
                                 and (RUN, node.prev) in node.options) \
                        else 0
                    if node.preemptions + cost > budget.preemptions:
                        continue
                    sleep_a = frozenset(
                        s for s in set(node.sleep) | set(prev_tried)
                        if not _dependent(node.pending.get(s),
                                          node.pending.get(r)))
                    stack.append((base + ((RUN, r),), sleep_a))
                    prev_tried.append(r)
                else:
                    stack.append((base + ((kind, r),), node.sleep))

    # -- phase 2: slow-rank delay sweep --------------------------------
    if budget.faults > 0:
        for r in range(variant.world):
            if out_of_budget():
                break
            res, ctl0 = attempt("sweep", ((HANG, r),))
            if res is not None:
                return res
            trace0 = list(ctl0.trace)
            for k in range(1, len(trace0)):
                if out_of_budget():
                    break
                node = ctl0.nodes[k]
                # only while r was still hung there: (RUN, r) is offered
                # as a wake (in the options, yet r is not runnable)
                if (RUN, r) not in node.options or r in node.pending:
                    continue
                res, _ = attempt("sweep",
                                 tuple(trace0[:k]) + ((RUN, r),))
                if res is not None:
                    return res

    # -- phase 3: seeded random walks ----------------------------------
    # zlib.crc32, not hash(): str hashes are salted per process and a
    # per-process seed would make "mxverify found it" unreproducible
    import zlib
    rng = random.Random(budget.seed
                        ^ zlib.crc32(variant.name.encode("utf-8")))
    dry = 0
    while not out_of_budget() and dry < budget.schedules:
        before = len(seen)
        res, _ = attempt("walk", (),
                         rng=random.Random(rng.randrange(1 << 30)))
        if res is not None:
            return res
        dry = 0 if len(seen) > before else dry + 1
    return VariantResult(variant.name, len(seen), counts["dfs"],
                         counts["sweep"], counts["walk"], None)


class ScenarioReport:
    def __init__(self, name, variants, elapsed, oracles):
        self.name = name
        self.variants = variants
        self.elapsed = elapsed
        self.oracles = tuple(oracles)
        self.schedules = sum(v.schedules for v in variants)
        self.dfs = sum(v.dfs for v in variants)
        self.sweeps = sum(v.sweeps for v in variants)
        self.walks = sum(v.walks for v in variants)
        self.counterexample = next(
            (v.counterexample for v in variants
             if v.counterexample is not None), None)
        self.ok = self.counterexample is None

    def summary(self):
        status = "ok" if self.ok else \
            "VIOLATION (%s)" % self.counterexample.oracle
        return ("mxverify: scenario %-9s %s — %d distinct schedules "
                "(dfs %d, sweeps %d, walks %d) across %d variant(s) "
                "in %.1fs; oracles: %s"
                % (self.name, status, self.schedules, self.dfs,
                   self.sweeps, self.walks, len(self.variants),
                   self.elapsed,
                   ", ".join(self.oracles)))


def verify_scenario(name, budget=None, log=None):
    """Explore every variant of ``name``; returns a
    :class:`ScenarioReport` (``.ok`` False carries the first minimized
    :class:`Counterexample`)."""
    variants = SCENARIOS[name]()
    budget = budget or Budget()
    t0 = time.monotonic()
    subs = budget.split(len(variants))
    results = []
    oracles = []
    for variant, sub in zip(variants, subs):
        deadline = time.monotonic() + sub.seconds
        res = _explore_variant(variant, sub, deadline)
        results.append(res)
        for o in variant.oracles:
            if o not in oracles:
                oracles.append(o)
        if log is not None:
            log("mxverify:   %s/%s: %d schedules (dfs %d, sweeps %d, "
                "walks %d)%s"
                % (name, variant.name, res.schedules, res.dfs,
                   res.sweeps, res.walks,
                   "" if res.counterexample is None else " — VIOLATION"))
        if res.counterexample is not None:
            break
    return ScenarioReport(name, results, time.monotonic() - t0, oracles)


def replay(data, budget=None):
    """Re-execute a counterexample (``Counterexample`` or its
    ``to_json()`` dict): returns ``(violation_or_None, events)``."""
    if isinstance(data, Counterexample):
        data = data.to_json()
    budget = budget or Budget()
    variants = {v.name: v for v in SCENARIOS[data["scenario"]]()}
    variant = variants[data["variant"]]
    schedule = tuple(tuple(c) for c in data["schedule"])
    sim, _ = _run_one(variant, schedule, frozenset(), budget)
    return _check(variant, sim), sim.events
