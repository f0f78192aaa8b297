"""``mx.fault.elastic`` -- survive a lost rank by RESIZING the job.

Counterpart of ``mxnet_tpu/fault_elastic.py``.  ``mx.fault.dist`` makes
recovery a collective decision, but a lost peer still ends the run:
:class:`~mxnet_tpu_torch.fault_dist.PeerLostError` propagates.  Here the
surviving ranks agree to continue at the smaller world size, restore
training state from the last good checkpoint, rescale batch and LR, and
keep stepping.

The resize protocol (:class:`ElasticRunner`, per trigger):

1. **Vote** -- :func:`vote_resize`: every surviving rank posts a resize
   *intent* ``(survivors, generation, coordinator)`` on a control-plane
   :class:`FileBoard` / :class:`InProcessBoard` and waits until every
   rank of its proposed survivor set posted an *identical* intent.
   Disagreeing views converge by intersection over bounded rounds; a
   silent rank is dropped only after ``drain`` seconds.  A rank left out
   of the committed set finds the commit record and raises
   :class:`VotedOutError` instead of resizing alone.  The board must
   outlive every topology: a shared directory, not a store hosted by a
   rank that may die.
2. **Re-bootstrap** -- destroy the process group and join a new one at
   the surviving world size through the resilient bootstrap
   (:func:`mxnet_tpu_torch.fault_dist.initialize`); the kvstore's
   bootstrap latch is reset (``kvstore.reset_distributed``) so the next
   dist op binds the new world.
3. **Restore** -- ``restore_fn`` rebuilds at the new topology from the
   last checkpoint: ``parallel.shrink_mesh`` / ``grow_mesh`` with
   ``TrainStep.resize(mesh, path)``, or ``Block.load_parameters`` +
   ``Trainer.load_states`` + ``Trainer.reset_kvstore``.
4. **Rescale + continue** -- global batch and LR scale by
   ``surviving / original`` world size (the linear rule; ``rescale=``
   plugs in another), the shared
   :class:`~mxnet_tpu_torch.fault_dist.Generation` jumps to the committed
   value on every survivor, and the loop continues from the
   checkpointed step.

Triggers: :class:`~mxnet_tpu_torch.fault_dist.PeerLostError` (heartbeat
or data plane), :class:`~mxnet_tpu_torch.fault_dist.CoordinatedAbortError`
(everyone alive resizes "in place": same world, fresh bootstrap, restore
from the checkpoint), and a maintenance notice
(:class:`~mxnet_tpu_torch.fault_dist.MaintenancePoller`: this rank
checkpoints, posts a leave record and drains out; the survivors resize
without it).

The fleet also GROWS.  A replacement rank joins a live job through the
same board (:func:`vote_join`): it posts a join record, every
survivor's heartbeat carries the pending join ids it sees, and a
completed round where ANY rank saw one raises
:class:`JoinRequestedError` on every rank; the survivors checkpoint in
place and enter the next :func:`vote_resize` epoch, which folds the
joiners into the committed record.  The joiner blocks on the commit that
names it, adopts its generation, survivors, coordinator and step, joins
the world ``N+k`` and restores the fleet's checkpoint.  A newcomer never
votes.  :class:`ScalePolicy` proposes resizes from the fleet telemetry
that rides the beat (scale-up posts a request record, scale-down drains
a deterministically chosen victim).

Knobs (environment)::

    MXNET_FAULT_ELASTIC_MIN_WORLD    stop resizing below this world size (1)
    MXNET_FAULT_ELASTIC_MAX_RESIZES  give up after this many resizes (3)
    MXNET_FAULT_ELASTIC_DRAIN        resize-vote wait for silent ranks, s (20)
    MXNET_FAULT_ELASTIC_RESCALE      batch/LR rule: linear | none (linear)
    MXNET_FAULT_ELASTIC_CKPT_EVERY   steps between elastic checkpoints (10)
    MXNET_FAULT_ELASTIC_JOIN_DRAIN   joiner wait for a folding commit, s (120)
    MXNET_FAULT_ELASTIC_JOIN_EVERY   beats between join-record sweeps (1)
    MXNET_TELEMETRY_SCALE_*          ScalePolicy thresholds (see class)

Offense: ``peer_preempt`` SIGKILLs this worker at its N-th step, and
``peer_join`` posts a join record as if a replacement arrived.

Counters: ``fault::elastic::votes / resizes / rebootstraps / restores /
checkpoints / drains / joins / scale_up / scale_down``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from . import fault as _fault
from . import fault_dist as _fdist
from . import flightrec as _flightrec
from . import profiler as _profiler
from . import telemetry as _telemetry

__all__ = [
    "ElasticAbortError", "VotedOutError", "JoinRequestedError",
    "InProcessBoard", "FileBoard",
    "ResizeIntent", "vote_resize", "vote_join", "pending_joiners",
    "linear_rescale", "ElasticInfo", "ElasticStatus", "ElasticRunner",
    "ScalePolicy",
]

log = logging.getLogger("mxnet_tpu_torch.fault.elastic")


# ----------------------------------------------------------------------
# exceptions
# ----------------------------------------------------------------------
class ElasticAbortError(_fault.FaultError):
    """The resize protocol cannot continue (survivors below the minimum
    world size, resize budget spent, or the vote failed to converge)."""


class VotedOutError(ElasticAbortError):
    """The surviving peers committed a resize that excludes this rank
    (it was presumed dead while merely slow).  Continuing would fork the
    job into two fleets training divergent models — this rank must exit
    and rejoin as a fresh worker instead."""

    def __init__(self, *args):
        super().__init__(*args)
        # terminal for this rank by definition: flush the black box so
        # the postmortem can show WHY the peers dropped it
        _flightrec.note_terminal("voted_out", exc=self)


class JoinRequestedError(_fault.FaultError):
    """A completed heartbeat round observed pending join record(s) on
    the vote board.  Raised on EVERY rank in the same round (the union
    of per-rank sightings rides the beat), so every survivor enters the
    grow vote together — the same symmetry argument as
    :class:`~mxnet_tpu_torch.fault_dist.CoordinatedAbortError`."""

    def __init__(self, joiners):
        self.joiners = tuple(joiners)
        super().__init__("join requested by %s" % (list(self.joiners),))


# ----------------------------------------------------------------------
# knobs
# ----------------------------------------------------------------------
def _min_world():
    return int(os.environ.get("MXNET_FAULT_ELASTIC_MIN_WORLD", "1"))


def _max_resizes():
    return int(os.environ.get("MXNET_FAULT_ELASTIC_MAX_RESIZES", "3"))


def _drain_timeout():
    return float(os.environ.get("MXNET_FAULT_ELASTIC_DRAIN", "20"))


def _ckpt_every():
    return int(os.environ.get("MXNET_FAULT_ELASTIC_CKPT_EVERY", "10"))


def _join_drain():
    return float(os.environ.get("MXNET_FAULT_ELASTIC_JOIN_DRAIN", "120"))


def _join_every():
    return int(os.environ.get("MXNET_FAULT_ELASTIC_JOIN_EVERY", "1"))


# ----------------------------------------------------------------------
# vote boards (subset-capable control-plane transport)
# ----------------------------------------------------------------------
# The existing comms (FileComm/CoordServiceComm/InProcessComm) allgather
# over a FIXED world — with a dead peer every round times out, which is
# exactly the situation a resize starts from.  A board is the weaker
# primitive the vote needs: posted records persist, and each rank
# decides for itself which subset it waits for.
class InProcessBoard:
    """Dict-backed board for tests: threads as ranks.

    ``_sched`` is the model checker's seam (``analysis.modelcheck``):
    with its cooperative scheduler installed, every post, claim, sweep
    and wait is a schedule point on a virtual clock.  Production never
    sets it."""

    def __init__(self):
        self._data = {}
        self._cond = threading.Condition(threading.Lock())
        self._sched = None  # the model checker's seam; None in production

    def post(self, key, payload):
        if self._sched is not None:
            self._sched.point("board.post", obj=("board", id(self)),
                              write=True, detail=str(key))
            self._data[str(key)] = payload
            return
        with self._cond:
            self._data[str(key)] = payload
            self._cond.notify_all()

    def claim(self, key, payload):
        """Atomically post ``payload`` under ``key`` IFF no record exists
        there yet; True when this caller won the slot.  The primitive
        the commit's uniqueness rests on (see :func:`vote_resize`)."""
        key = str(key)
        if self._sched is not None:
            self._sched.point("board.claim", obj=("board", id(self)),
                              write=True, detail=key)
            if key in self._data:
                return False
            self._data[key] = payload
            return True
        with self._cond:
            if key in self._data:
                return False
            self._data[key] = payload
            self._cond.notify_all()
            return True

    def sweep(self, prefix):
        """All posted ``{key: payload}`` whose key starts with prefix."""
        prefix = str(prefix)
        if self._sched is not None:
            self._sched.point("board.sweep", obj=("board", id(self)),
                              write=False, detail=prefix)
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}
        with self._cond:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}

    def wait(self, timeout):
        if self._sched is not None:
            # virtual wait: runnable again after any board write or a
            # clock advance; the caller's deadlines read _now(), the
            # same virtual clock
            self._sched.board_wait(("board", id(self)), timeout)
            return
        with self._cond:
            self._cond.wait(timeout)


class FileBoard:
    """Shared-directory board: one atomically-written JSON file per
    posted key.  Works wherever the workers share a filesystem — the
    same deployment envelope as :class:`~mxnet_tpu_torch.fault_dist.FileComm`
    (local multi-process fleets, NFS/GCS-fuse)."""

    def __init__(self, root, poll=0.02):
        self.root = root
        self.poll = poll
        os.makedirs(root, exist_ok=True)

    def _fname(self, key):
        # keys use '/' as a namespace separator; flatten for one dir
        return str(key).replace("/", "@") + ".json"

    def post(self, key, payload):
        path = os.path.join(self.root, self._fname(key))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    def claim(self, key, payload):
        """First-writer-wins atomic post: the record is fully written to
        a private tmp file, then ``os.link``ed into place — link fails
        with EEXIST when someone else already claimed the slot, and the
        record is never observable half-written.  Filesystems without
        hardlinks fall back to ``O_EXCL`` create (same exclusivity; a
        crash mid-write can then leave a torn record, which sweepers
        skip and the vote's drain deadline turns into a clean abort)."""
        path = os.path.join(self.root, self._fname(key))
        tmp = "%s.claim.%d.%d" % (path, os.getpid(),
                                  threading.get_ident())
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        except OSError:
            # no hardlink support (some FUSE mounts): O_EXCL fallback
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            return True
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def sweep(self, prefix):
        prefix = self._fname(prefix)[:-len(".json")]
        out = {}
        for name in os.listdir(self.root):
            if not (name.startswith(prefix) and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    out[name[:-len(".json")].replace("@", "/")] = \
                        json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace
        return out

    def wait(self, timeout):
        time.sleep(min(timeout, self.poll))


#: The model checker's virtual clock, shared with ``fault_dist``: its
#: simulated threads set ``_SIM_CLOCK.fn`` so the vote's drain deadlines
#: run on the checker's clock; every other thread reads the real one.
_SIM_CLOCK = _fdist._SIM_CLOCK


def _now():
    """``time.monotonic``, or the model checker's clock on its threads."""
    clk = getattr(_SIM_CLOCK, "fn", None)
    return clk() if clk is not None else time.monotonic()


#: Protocol bugs put back on purpose, armed only by
#: ``analysis.modelcheck.mutations()`` (``"skip_commit_funnel"``: any
#: rank commits its own view of an identical round;
#: ``"skip_join_barrier"``: a joiner steps before adopting a committed
#: record).  Empty in production.
_TEST_MUTATIONS = set()


def _bkey(epoch, stage, rank):
    return "rz/%d/%s/%s" % (int(epoch), stage, rank)


def _jkey(jid):
    # join records are NOT epoch-scoped: a newcomer does not know the
    # live job's epoch — the vote that folds it does
    return "rz/join/%s" % (jid,)


def pending_joiners(board):
    """``{jid: record}`` of posted join records no committed epoch has
    folded yet.  A jid is spent once ANY commit record names it in its
    ``joiners`` list — the record stays on the board (boards have no
    delete) but never folds twice."""
    joiners = {}
    for v in board.sweep(_jkey("")).values():
        if isinstance(v, dict) and v.get("jid"):
            joiners[str(v["jid"])] = v
    if joiners:
        for key, c in board.sweep("rz/").items():
            if "/commit/" in key and isinstance(c, dict):
                for j in c.get("joiners") or ():
                    joiners.pop(str(j), None)
    return joiners


def _adopt_commit(board, c, epoch, rank, world):
    """Act on a peer's commit record: raise :class:`VotedOutError` when
    it excludes this rank, otherwise echo it under our own key (a
    third, slower rank's voted-out discovery must not depend on which
    one of us it sweeps first) and return the adopted intent."""
    if rank not in c["survivors"]:
        raise VotedOutError(
            "peers committed resize epoch %d to survivors %s — this "
            "rank (%d) was voted out; exit and rejoin as a fresh worker"
            % (epoch, c["survivors"], rank))
    board.post(_bkey(epoch, "commit", rank), dict(c, rank=rank))
    _profiler.counter_bump("fault::elastic::votes", 1, cat="fault")
    _flightrec.record("resize.adopt", epoch=epoch, gen=int(c["gen"]),
                      survivors=tuple(c["survivors"]),
                      joiners=tuple(c.get("joiners") or ()))
    return ResizeIntent(c["survivors"], world, c["gen"], epoch,
                        c.get("coord"), rank,
                        joiners=c.get("joiners") or (),
                        step=c.get("step", 0))


# ----------------------------------------------------------------------
# the resize vote
# ----------------------------------------------------------------------
class ResizeIntent:
    """The committed outcome of one resize vote: identical on every
    surviving rank (that is what the vote guarantees).  ``joiners`` are
    the jids folded into this epoch; they take the new ranks AFTER the
    survivors, in sorted-jid order, so old-rank relabeling stays a pure
    index into ``survivors``."""

    def __init__(self, survivors, old_world, gen, epoch, coord, rank,
                 joiners=(), step=0, jid=None):
        self.survivors = list(survivors)   # OLD ranks, sorted
        self.joiners = [str(j) for j in joiners]
        self.old_world = int(old_world)
        self.new_world = len(self.survivors) + len(self.joiners)
        if jid is None:
            self.old_rank = int(rank)
            self.new_rank = self.survivors.index(int(rank))
        else:
            self.old_rank = -1             # a newcomer had no old rank
            self.new_rank = len(self.survivors) \
                + self.joiners.index(str(jid))
        self.jid = jid
        self.gen = int(gen)                # committed generation
        self.epoch = int(epoch)            # resize epoch (1-based)
        self.coord = coord                 # new coordinator "host:port"
        self.step = int(step)              # step the fleet resumes from

    def __repr__(self):
        return ("ResizeIntent(epoch=%d, %d->%d, survivors=%s, joiners=%s"
                ", rank %d->%d, gen=%d)"
                % (self.epoch, self.old_world, self.new_world,
                   self.survivors, self.joiners, self.old_rank,
                   self.new_rank, self.gen))


def vote_resize(board, rank, world, lost=(), gen=0, epoch=1, drain=None,
                min_world=None, coord_hint=None, step=0):
    """Converge every surviving rank on one :class:`ResizeIntent`.

    Round ``r``: post ``(my survivor set, joiner set, generation,
    coordinator candidate)`` and wait until every rank in that survivor
    set posted a round-r proposal.  All proposals identical → commit.
    Otherwise the next round's set is the intersection of every
    responder's view (minus ranks that stayed silent past ``drain`` —
    dropping a rank is the ONLY way the wait ends early, so **no rank
    can commit a set whose live members have not voted it**: the
    no-solo-resize invariant).  Views only shrink, so convergence is
    bounded by ``world`` rounds.

    ``lost`` pre-excludes ranks already known dead (a
    :class:`~mxnet_tpu_torch.fault_dist.PeerLostError` names them); ranks that
    posted a leave record for this epoch (maintenance drain) are
    excluded the same way.  A slow-but-alive rank dropped by its peers
    finds their commit records and raises :class:`VotedOutError` rather
    than resizing solo.

    GROW: unspent join records (:func:`pending_joiners`) are swept once
    at entry and carried in every proposal — agreement covers the
    joiner set too, and the committed record names the folded jids so
    each blocked :func:`vote_join` caller adopts it.  Joiner views also
    only shrink (round ``r+1`` intersects the responders' round-``r``
    joiner sets); a jid seen by some ranks but not others this epoch
    simply stays pending and triggers the next one.  ``step`` is this
    rank's resume step (its last durable checkpoint, or the in-place
    checkpoint a grow takes); the commit carries the max so a joiner
    with no checkpoint of its own knows where the fleet resumes.

    The COMMIT is funneled through one rank — the lowest of the agreed
    set posts it, everyone else adopts what it posted (bounded wait,
    then abort).  An identical-proposal round alone is not enough to
    commit on: a slow rank can observe a stale all-identical round
    after its peers already dropped it and committed a smaller set, and
    committing its own view then would fork the fleet.  ``coord_hint``
    is this rank's coordinator candidate (host:port); the committed
    coordinator is the candidate of the new rank 0.
    """
    drain = _drain_timeout() if drain is None else float(drain)
    min_world = _min_world() if min_world is None else int(min_world)
    rank = int(rank)
    gone = set(int(r) for r in lost)
    gone |= set(int(v["rank"]) for v in
                board.sweep(_bkey(epoch, "leave", "")).values())
    alive = sorted((set(range(int(world))) - gone) | {rank})
    joiners = sorted(pending_joiners(board))
    rnd = 0
    while True:
        if rnd > int(world) + 2:
            raise ElasticAbortError(
                "resize vote (epoch %d) did not converge after %d rounds"
                % (epoch, rnd))
        board.post(_bkey(epoch, "p%d" % rnd, rank),
                   {"rank": rank, "survivors": alive, "gen": int(gen),
                    "coord": coord_hint, "joiners": joiners,
                    "step": int(step)})
        _flightrec.record("resize.propose", epoch=epoch, round=rnd,
                          gen=int(gen), survivors=tuple(alive),
                          joiners=tuple(joiners))
        # later rounds wait longer: a peer may still be inside the
        # PREVIOUS round's drain window (bounded skew of one drain per
        # completed round), and dropping it here would vote out a live
        # rank over scheduling skew
        deadline = _now() + drain * (2.0 if rnd else 1.0)
        timed_out = False
        while True:
            for c in board.sweep(_bkey(epoch, "commit", "")).values():
                # a commit that includes us is OUR outcome too: commits
                # only happen from a complete identical-proposal round,
                # which must contain our own matching vote
                return _adopt_commit(board, c, epoch, rank, world)
            posted = {int(v["rank"]): v for v in
                      board.sweep(_bkey(epoch, "p%d" % rnd, "")).values()}
            if all(r in posted for r in alive):
                break
            if _now() > deadline:
                timed_out = True
                break
            board.wait(0.02)
        responders = [r for r in alive if r in posted]
        views = [set(int(x) for x in posted[r]["survivors"])
                 for r in responders]
        jviews = [tuple(str(x) for x in posted[r].get("joiners") or ())
                  for r in responders]
        if not timed_out and all(v == set(alive) for v in views) \
                and all(jv == tuple(joiners) for jv in jviews):
            new_world = len(alive) + len(joiners)
            if new_world < max(1, min_world):
                raise ElasticAbortError(
                    "resize epoch %d: %d survivor(s) %s is below the "
                    "minimum world size %d (MXNET_FAULT_ELASTIC_MIN_WORLD)"
                    % (epoch, new_world, alive, min_world))
            gen_next = max(int(posted[r]["gen"]) for r in alive) + 1
            coord = posted[alive[0]].get("coord")
            step_next = max(int(posted[r].get("step", 0)) for r in alive)
            if _TEST_MUTATIONS and "skip_commit_funnel" in _TEST_MUTATIONS:
                # the mutation: ANY rank that sees an identical round
                # commits its OWN view, with no leader funnel and no
                # re-sweep before the commit
                board.post(_bkey(epoch, "commit", rank),
                           {"rank": rank, "survivors": alive,
                            "gen": gen_next, "coord": coord,
                            "joiners": joiners, "step": step_next})
                _profiler.counter_bump("fault::elastic::votes", 1,
                                       cat="fault")
                return ResizeIntent(alive, world, gen_next, epoch, coord,
                                    rank, joiners=joiners, step=step_next)
            # Only the LEADER (lowest agreed rank) tries to commit;
            # everyone else adopts what got committed.  An identical-
            # proposal round is necessary but NOT sufficient: a slow
            # rank can observe a stale all-identical round after its
            # peers already dropped it and moved on — committing its own
            # view then would fork the fleet.  The commit itself is an
            # atomic first-writer-wins CLAIM of the epoch's single
            # winner slot: a sweep-then-post funnel has a window in
            # which a slow leader, waking after its peers drained it,
            # posts a second, stale commit record between a peer's
            # pre-commit sweep and that peer's post.  claim() makes
            # commit uniqueness
            # structural — at most one record can ever exist per epoch;
            # every other rank adopts it or raises VotedOutError.
            if rank == alive[0]:
                if board.claim(_bkey(epoch, "commit", "W"),
                               {"rank": rank, "survivors": alive,
                                "gen": gen_next, "coord": coord,
                                "joiners": joiners, "step": step_next}):
                    _profiler.counter_bump("fault::elastic::votes", 1,
                                           cat="fault")
                    _flightrec.record("resize.commit", epoch=epoch,
                                      gen=gen_next,
                                      survivors=tuple(alive),
                                      joiners=tuple(joiners),
                                      step=step_next)
                    return ResizeIntent(alive, world, gen_next, epoch,
                                        coord, rank, joiners=joiners,
                                        step=step_next)
                # lost the claim: another leader (of a different agreed
                # set) already committed this epoch — adopt its record
                # below, exactly like a follower
            # follower (or claim-losing leader): wait for the
            # authoritative commit (drain-bounded — a leader that died
            # between agreeing and committing must not hang us forever;
            # aborting is safe, forking is not)
            commit_deadline = _now() + drain * 2.0
            while _now() < commit_deadline:
                for c in board.sweep(_bkey(epoch, "commit", "")).values():
                    return _adopt_commit(board, c, epoch, rank, world)
                board.wait(0.02)
            raise ElasticAbortError(
                "resize epoch %d: agreed on survivors %s but leader %d "
                "never committed within %.1fs — aborting (it may have "
                "died mid-vote)" % (epoch, alive, alive[0], drain * 2.0))
        # disagreement (or silent ranks): intersect every responder's
        # view, drop the silent, keep ourselves, re-vote; joiner views
        # intersect the same way (a jid not unanimously seen stays
        # pending for the next epoch — safety over greed)
        nxt = set(responders)
        jnxt = set(joiners)
        for v in views:
            nxt &= v
        for jv in jviews:
            jnxt &= set(jv)
        nxt |= {rank}
        dropped = sorted(set(alive) - nxt)
        if dropped:
            log.warning("resize epoch %d round %d: dropping silent/"
                        "disputed rank(s) %s", epoch, rnd, dropped)
        alive = sorted(nxt)
        joiners = sorted(jnxt)
        rnd += 1


def vote_join(board, jid, *, drain=None, coord_hint=None, gen=0):
    """The joiner's half of the grow protocol: post a join record and
    BLOCK until a committed epoch folds this jid, then adopt that
    commit's generation/survivors/coordinator/step (the JOIN BARRIER —
    a newcomer must never take a step at its own notion of the world).
    Returns the adopted :class:`ResizeIntent` (``new_rank`` is this
    joiner's rank in the grown world, ``step`` the fleet's resume
    step); raises :class:`ElasticAbortError` if no epoch folds it
    within ``drain`` seconds (MXNET_FAULT_ELASTIC_JOIN_DRAIN).

    A joiner never votes: it has no stake in the old world and cannot
    fork a fleet it is not yet part of.  ``gen`` is the newcomer's own
    generation floor, used only for diagnostics — the committed value
    always wins.
    """
    jid = str(jid)
    drain = _join_drain() if drain is None else float(drain)
    board.post(_jkey(jid), {"jid": jid, "coord": coord_hint,
                            "gen": int(gen)})
    _flightrec.record("join.post", jid=jid, gen=int(gen))
    if _TEST_MUTATIONS and "skip_join_barrier" in _TEST_MUTATIONS:
        # the mutation: the newcomer starts stepping BEFORE adopting a
        # committed record, guessing the fleet from the proposals it
        # sees and keeping its own generation
        seen = set()
        for key, v in board.sweep("rz/").items():
            if "/p" in key and isinstance(v, dict):
                seen.update(int(x) for x in v.get("survivors") or ())
        surv = sorted(seen) or [0]
        return ResizeIntent(surv, len(surv), int(gen), 1, coord_hint,
                            -1, joiners=[jid], step=0, jid=jid)
    deadline = _now() + drain
    while True:
        commits = [(key, c) for key, c in sorted(board.sweep("rz/").items())
                   if "/commit/" in key and isinstance(c, dict)
                   and jid in (c.get("joiners") or ())]
        if commits:
            # adopt the LOWEST folding epoch (there can only be one —
            # pending_joiners spends a jid at its first commit — but
            # sorted adoption keeps the choice deterministic anyway)
            key, c = min(commits, key=lambda kc: int(kc[0].split("/")[1]))
            epoch = int(key.split("/")[1])
            board.post(_bkey(epoch, "commit", "j%s" % jid),
                       dict(c, jid=jid))
            _profiler.counter_bump("fault::elastic::joins", 1,
                                   cat="fault")
            _profiler.counter_bump("fault::elastic::votes", 1,
                                   cat="fault")
            _flightrec.record("join.fold", jid=jid, epoch=epoch,
                              gen=int(c["gen"]),
                              step=int(c.get("step", 0)))
            return ResizeIntent(c["survivors"], len(c["survivors"]),
                                c["gen"], epoch, c.get("coord"), -1,
                                joiners=c.get("joiners") or (),
                                step=c.get("step", 0), jid=jid)
        if _now() > deadline:
            raise ElasticAbortError(
                "join %s: no resize epoch folded this joiner within "
                "%.1fs (MXNET_FAULT_ELASTIC_JOIN_DRAIN) — is a fleet "
                "beating on this board?" % (jid, drain))
        board.wait(0.05)


# ----------------------------------------------------------------------
# batch/LR rescale rules
# ----------------------------------------------------------------------
def linear_rescale(orig_world, new_world):
    """The linear scaling rule: LR and global batch both scale by
    ``new/orig`` (smaller fleet → proportionally smaller global batch →
    proportionally smaller LR).  Returns ``(lr_scale, batch_scale)``."""
    s = float(new_world) / float(orig_world)
    return s, s


def _no_rescale(orig_world, new_world):
    return 1.0, 1.0


_RESCALES = {"linear": linear_rescale, "none": _no_rescale}


def _resolve_rescale(rule):
    if rule is None:
        rule = os.environ.get("MXNET_FAULT_ELASTIC_RESCALE", "linear")
    if callable(rule):
        return rule
    try:
        return _RESCALES[rule]
    except KeyError:
        raise ValueError("unknown rescale rule %r (known: %s, or a "
                         "callable (orig_world, new_world) -> "
                         "(lr_scale, batch_scale))"
                         % (rule, ", ".join(sorted(_RESCALES))))


# ----------------------------------------------------------------------
# the runner
# ----------------------------------------------------------------------
class ElasticInfo:
    """Mutable view of the elastic topology, passed to every hook:
    ``rank``/``world`` are CURRENT, ``orig_world`` is the launch size,
    ``lr_scale``/``batch_scale`` are cumulative (vs the original
    configuration — apply them to the ORIGINAL lr/batch, not the
    previous epoch's)."""

    def __init__(self, rank, world, gen):
        self.rank = int(rank)
        self.world = int(world)
        self.orig_world = int(world)
        self.epoch = 0
        self.step = 0
        self.gen = gen
        self.lr_scale = 1.0
        self.batch_scale = 1.0
        self.survivors = list(range(int(world)))

    def as_dict(self):
        return {"rank": self.rank, "world": self.world,
                "orig_world": self.orig_world, "epoch": self.epoch,
                "step": self.step, "generation": self.gen.value,
                "lr_scale": self.lr_scale, "batch_scale": self.batch_scale,
                "survivors": self.survivors}


class ElasticStatus:
    """What :meth:`ElasticRunner.run` came back with."""

    def __init__(self, completed, drained, step, resizes, info):
        self.completed = completed   # ran all requested steps
        self.drained = drained       # left early on a maintenance notice
        self.step = step
        self.resizes = resizes
        self.world = info.world
        self.generation = info.gen.value
        self.epoch = info.epoch

    def __repr__(self):
        return ("ElasticStatus(completed=%s, drained=%s, step=%d, "
                "resizes=%d, world=%d, generation=%d)"
                % (self.completed, self.drained, self.step, self.resizes,
                   self.world, self.generation))


class _JoinWatch:
    """Rides the runner's per-epoch heartbeat (``hb.elastic``): each
    beat's payload carries the unspent join jids this rank saw on the
    board (one sweep per ``every`` beats — the sweep result is cached
    between sweeps so every beat still carries SOMETHING), and a
    completed round where ANY rank saw one raises
    :class:`JoinRequestedError` on EVERY rank — the union over the
    round's votes is what makes the trigger symmetric, exactly like the
    lease's revocation round.  Zero extra comm rounds."""

    def __init__(self, board, every=None):
        self.board = board
        self.every = max(1, _join_every() if every is None
                         else int(every))
        self._n = 0
        self._seen = ()

    def payload(self):
        n = self._n
        self._n = n + 1
        if n % self.every == 0:
            try:
                self._seen = tuple(sorted(pending_joiners(self.board)))
            except OSError:
                pass  # a board hiccup must not take the beat down
        return {"joins": list(self._seen)}

    def on_beat(self, votes):
        jids = set()
        for v in votes:
            e = v.get("elastic")
            if isinstance(e, dict):
                jids.update(str(j) for j in e.get("joins") or ())
        if jids:
            raise JoinRequestedError(sorted(jids))


class ElasticRunner:
    """Drive a training loop that survives peer loss by resizing.

    Parameters
    ----------
    step_fn : callable(step, info) -> loss
        One training step.  ``info`` is the live :class:`ElasticInfo`;
        apply ``info.lr_scale`` / ``info.batch_scale`` to the ORIGINAL
        lr/global batch.  Raise
        :class:`~mxnet_tpu_torch.fault_dist.PeerLostError` /
        :class:`~mxnet_tpu_torch.fault_dist.CoordinatedAbortError` to trigger
        a resize (the wrapped dist kvstore / ring ops already do).
    board : InProcessBoard | FileBoard
        Control-plane transport for the resize vote (must outlive every
        topology — unlike the per-epoch comm).
    comm_factory : callable(rank, world, epoch) -> comm, optional
        Builds the step-heartbeat comm for each topology epoch (e.g.
        ``FileComm(dir, rank, world, namespace="el%d" % epoch)``).
        ``None`` disables heartbeats (resizes then trigger only from
        ``step_fn`` exceptions).
    save_fn : callable(path, step), optional
        Write a full-training-state checkpoint (e.g.
        ``TrainStep.save_checkpoint``).  The runner wraps it with the
        elastic state manifest (step, generation, world, RNG —
        ``mx.fault.save_elastic_state``).
    restore_fn : callable(path, info), optional
        Rebuild at the NEW topology and restore from ``path`` (e.g.
        ``parallel.shrink_mesh`` + ``TrainStep.resize(mesh, path)``).
        ``path`` is None when no checkpoint exists yet (restart from
        step 0 at the new size).
    rebootstrap : "auto" | "never" | callable(intent)
        "auto" destroys the live process group (when there is one),
        joins a new one at the committed world through
        :func:`mxnet_tpu_torch.fault_dist.initialize` at the committed
        coordinator, and always resets the kvstore seam and the
        launcher env; a callable replaces the whole step.
    """

    def __init__(self, step_fn, *, board=None, comm_factory=None,
                 rank=0, world=1, save_fn=None, restore_fn=None,
                 ckpt_dir=None, ckpt_every=None, min_world=None,
                 max_resizes=None, drain=None, rescale=None,
                 heartbeat_timeout=None, gen=None, on_resize=None,
                 rebootstrap="auto", coord_hint=None, lease=None,
                 telemetry=None, on_straggler=None, join=None,
                 join_drain=None):
        self.step_fn = step_fn
        self.board = board
        self.comm_factory = comm_factory
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = _ckpt_every() if ckpt_every is None \
            else int(ckpt_every)
        self.min_world = min_world
        self.max_resizes = _max_resizes() if max_resizes is None \
            else int(max_resizes)
        self.drain = drain
        self.rescale = _resolve_rescale(rescale)
        self.heartbeat_timeout = heartbeat_timeout
        self.on_resize = on_resize
        self.rebootstrap = rebootstrap
        self.coord_hint = coord_hint
        self.info = ElasticInfo(rank, world,
                                gen if gen is not None else
                                _fdist.generation())
        # a runner constructed with join= is a NEWCOMER: run() first
        # blocks on vote_join (the join barrier) and enters the step
        # loop only as a committed member of the grown world.  rank/
        # world then describe the ORIGINAL fleet it is rejoining (the
        # rescale baseline), not a membership it holds yet.
        self._join = None if join is None else str(join)
        self.join_drain = join_drain
        self.resizes = 0
        self.history = []          # (step, epoch, loss)
        self._last_ckpt = None
        self._last_ckpt_step = 0
        self._ckpt_gen = None      # resolved lazily past existing files
        self._notice = threading.Event()
        self._poller = None
        self._hb = None
        self._comm = None
        # arm a StepLease over the runner's own per-epoch heartbeat:
        # the runner already pays one beat per
        # step, so its step_fn's coordinated ops
        # (``coordinated_call(..., lease=self.lease)`` or ``lease=True``
        # when this runner installed the process-wide lease) ride the
        # beat's aggregate vote — ZERO per-op rounds on the success
        # path.  ``lease=None`` follows MXNET_FAULT_LEASE.
        self._use_lease = _fdist._lease_env_enabled() if lease is None \
            else bool(lease)
        self.lease = None
        self._installed_lease = False
        # fleet telemetry rides the runner's per-epoch heartbeat the
        # same way the lease does: ONE session per runner (its FleetView
        # survives resizes; the per-epoch heartbeat is rebound to it in
        # _bind_comm), with the straggler/regression Watchdog armed —
        # on_straggler(rank, ewma_ms, median_ms, view) is the hook a
        # policy layer (ROADMAP elastic item c) plugs into.
        use_tel = _telemetry.enabled() if telemetry is None \
            else bool(telemetry)
        if isinstance(telemetry, _telemetry.TelemetrySession):
            self.telemetry = telemetry
        elif use_tel:
            self.telemetry = _telemetry.TelemetrySession(
                watchdog=_telemetry.Watchdog(on_straggler=on_straggler))
        else:
            self.telemetry = None
        if comm_factory is not None and self._join is None:
            # a joiner binds only after the join barrier commits its
            # rank/world/epoch — a comm at the old world would hang
            self._bind_comm(self.info.rank, self.info.world, 0)

    # -- wiring --------------------------------------------------------
    def _bind_comm(self, rank, world, epoch):
        self._comm = self.comm_factory(rank, world, epoch)
        self._hb = _fdist.Heartbeat(comm=self._comm, every=1,
                                    timeout=self.heartbeat_timeout)
        if self._use_lease:
            if self.lease is None:
                self.lease = _fdist.StepLease(heartbeat=self._hb,
                                              gen=self.info.gen)
                # install process-wide only when the slot is free, so
                # seam callers using lease=True resolve it; thread-rank
                # tests run several runners per process and pass
                # runner.lease explicitly instead
                if _fault._step_lease() is None:
                    _fault._set_step_lease(self.lease)
                    self._installed_lease = True
            else:
                # new topology epoch: rebind the SAME lease (state
                # "revoked" from the resize/drain revoke) to the new
                # heartbeat; the new world re-arms it via the unanimous
                # handshake beat
                self.lease._hb = self._hb
            self._hb.lease = self.lease
        if self.telemetry is not None:
            # new epoch, same session: the committed generation gates
            # out pre-resize per-rank state aliased onto renumbered
            # ranks, and the next payload goes full
            self.telemetry.set_generation(self.info.gen.value)
            _telemetry.set_step_context(rank=rank,
                                        gen=self.info.gen.value)
            self._hb.telemetry = self.telemetry
            if epoch and self.telemetry.watchdog is not None:
                # the new topology's step-time distribution is a
                # different population (fewer/more chips, resharded
                # batch) — a stale baseline would read the shift as a
                # fleet-wide regression
                self.telemetry.watchdog.rearm()
        if self.board is not None:
            # grow trigger: pending join records ride every beat; a
            # round where any rank saw one raises JoinRequestedError
            # fleet-wide (see _JoinWatch)
            self._hb.elastic = _JoinWatch(self.board)

    def watch_maintenance(self, url=None, interval=None):
        """Start a :class:`~mxnet_tpu_torch.fault_dist.MaintenancePoller`
        whose notice makes this rank DRAIN at the next step boundary
        (checkpoint, post a leave record, return cleanly) instead of
        dying mid-step when SIGTERM lands — the survivors resize without
        it.  Returns the poller (caller stops it)."""
        self._poller = _fdist.MaintenancePoller(
            url=url, interval=interval,
            on_event=lambda ev: self._notice.set()).start()
        return self._poller

    def notice(self):
        """Arm the drain path directly (tests; schedulers with their own
        notice source)."""
        self._notice.set()

    def _notice_pending(self):
        # either the on_event wiring fired, or the poller's latched
        # pending() says a terminal notice is outstanding (covers a
        # caller-supplied poller whose on_event was repurposed)
        if self._notice.is_set():
            return True
        return self._poller is not None and \
            self._poller.pending() is not None

    # -- checkpointing -------------------------------------------------
    _CKPT_PAT = None  # compiled lazily (class-level regex cache)

    def _next_ckpt_path(self):
        """A FRESH generation-suffixed checkpoint path every save —
        overwriting the single live checkpoint in place would open a
        window (save started, manifest not yet swapped) where a
        preemption leaves the still-verified manifest naming a
        destroyed checkpoint.  Resolved past existing files so a
        restarted binary never reuses a generation either."""
        import re
        if ElasticRunner._CKPT_PAT is None:
            ElasticRunner._CKPT_PAT = re.compile(r"elastic_ckpt\.g(\d+)$")
        if self._ckpt_gen is None:
            gens = [int(m.group(1)) for f in os.listdir(self.ckpt_dir)
                    for m in [ElasticRunner._CKPT_PAT.match(f)] if m]
            self._ckpt_gen = max(gens) + 1 if gens else 0
        path = os.path.join(self.ckpt_dir,
                            "elastic_ckpt.g%d" % self._ckpt_gen)
        self._ckpt_gen += 1
        return path

    def _checkpoint(self, step):
        if self.ckpt_dir is None:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self._next_ckpt_path()
        if self.save_fn is not None:
            self.save_fn(path, step)
        # manifest written AFTER the checkpoint: the manifest swap is
        # the commit point, and the checkpoint it replaces is pruned
        # only after the swap — at every instant one complete,
        # manifest-named checkpoint exists
        _fault.save_elastic_state(
            self.ckpt_dir, step=step, generation=self.info.gen.value,
            world=self.info.world, epoch=self.info.epoch, checkpoint=path)
        self._last_ckpt = path
        self._last_ckpt_step = int(step)
        for f in os.listdir(self.ckpt_dir):
            if ElasticRunner._CKPT_PAT.match(f) and \
                    os.path.join(self.ckpt_dir, f) != path:
                stale = os.path.join(self.ckpt_dir, f)
                try:
                    if os.path.isdir(stale):
                        import shutil
                        shutil.rmtree(stale, ignore_errors=True)
                    else:
                        os.remove(stale)
                except OSError:
                    pass
        _profiler.counter_bump("fault::elastic::checkpoints", 1,
                               cat="fault")

    def _restore(self, st=None):
        """Rebuild at the new topology from the last good checkpoint;
        returns the step to resume from.  ``st`` is an already-loaded
        elastic-state payload (the resume path verified it once — don't
        re-read and re-hash the same file)."""
        if st is None and self.ckpt_dir is not None:
            try:
                st = _fault.load_elastic_state(self.ckpt_dir)
            except _fault.CorruptCheckpointError as e:
                log.warning("elastic state failed verification (%s) — "
                            "restarting from step 0 at the new size", e)
        if st:
            # a restarted binary must rejoin at the saved epoch and
            # generation: voting at epoch 1 again would adopt (or be
            # voted out by) THIS job's stale epoch-1 commit records
            # still on the board.  max(): a post-resize restore must
            # never lower the freshly committed values.
            self.info.epoch = max(self.info.epoch, int(st.get("epoch", 0)))
            self.info.gen.value = max(self.info.gen.value,
                                      int(st["generation"]))
        path = st.get("checkpoint") if st else None
        if self.restore_fn is not None:
            self.restore_fn(path, self.info)
        _profiler.counter_bump("fault::elastic::restores", 1, cat="fault")
        step = int(st["step"]) if st else 0
        self.info.step = step
        return step

    # -- the resize ----------------------------------------------------
    def _resize(self, lost=()):
        lease = self.lease if self.lease is not None \
            else _fault._step_lease()
        if lease is not None:
            # every survivor enters the resize together (PeerLostError /
            # CoordinatedAbortError fire fleet-wide), so this local
            # revoke IS symmetric; the post-resize world re-arms the
            # lease via the unanimous handshake beat at the new gen
            lease.revoke_local(reason="elastic-resize")
        self.resizes += 1
        if self.resizes > self.max_resizes:
            raise ElasticAbortError(
                "resize budget spent (%d resizes; "
                "MXNET_FAULT_ELASTIC_MAX_RESIZES)" % self.max_resizes)
        if self.board is None or self.info.world <= 1:
            raise ElasticAbortError(
                "cannot resize: no vote board / single-rank job")
        epoch = self.info.epoch + 1
        intent = vote_resize(
            self.board, rank=self.info.rank, world=self.info.world,
            lost=lost, gen=self.info.gen.value, epoch=epoch,
            drain=self.drain, min_world=self.min_world,
            coord_hint=self._coord_hint(),
            # the step this rank can resume from (its last durable
            # checkpoint) — the commit carries the fleet max so a
            # folded joiner, which has no checkpoint, resumes right
            step=self._last_ckpt_step)
        log.warning("elastic resize: %r", intent)
        info = self.info
        info.epoch = intent.epoch
        info.survivors = list(intent.survivors)
        info.rank, info.world = intent.new_rank, intent.new_world
        _flightrec.set_context(rank=info.rank, world=info.world,
                               gen=intent.gen, epoch=intent.epoch)
        # every survivor jumps to the SAME committed generation (not a
        # local bump — a rank that burned extra generations on
        # coordinated retries must land equal with its peers)
        info.gen.value = intent.gen
        info.lr_scale, info.batch_scale = self.rescale(info.orig_world,
                                                       info.world)
        self._do_rebootstrap(intent)
        if self.comm_factory is not None:
            self._bind_comm(info.rank, info.world, info.epoch)
        _profiler.counter_bump("fault::elastic::resizes", 1, cat="fault")
        if self.on_resize is not None:
            self.on_resize(info)
        return intent

    def _coord_hint(self):
        if self.coord_hint is not None:
            return self.coord_hint() if callable(self.coord_hint) \
                else self.coord_hint
        # candidate rendezvous for the new world, used only if this rank
        # becomes the new rank 0.  Beside a file store: a fresh file next
        # to the current one (the old one still holds the old world's
        # keys).  Otherwise a free port on this host; bind-then-close is
        # racy, and a collision surfaces as a retried-then-raised
        # BootstrapError ("Address already in use" is a transient
        # marker), never as silent corruption; pass coord_hint= to pin
        # one instead.
        cur = os.environ.get("MX_COORD_ADDR", "")
        if cur.startswith("file://"):
            return "%s.%d.%d" % (cur, os.getpid(), time.monotonic_ns())
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return "%s:%d" % (os.environ.get("MX_COORD_HOST", "127.0.0.1"),
                          port)

    def _do_rebootstrap(self, intent):
        """Step 2 of the protocol: bind this process to the new world.
        With ``rebootstrap="auto"`` and a live process group: destroy it,
        then join a new one at the committed world and coordinator
        (:func:`mxnet_tpu_torch.fault_dist.initialize`; a one-process
        data plane with no group has nothing to re-join).  Always
        rewrites the launcher env (``MX_NUM_WORKERS`` / ``MX_WORKER_ID``
        / ``MX_COORD_ADDR``) and resets the kvstore's bootstrap latch, so
        the next dist op binds the new world; the default comm follows
        the new group's store (``fault_dist.default_comm``)."""
        if callable(self.rebootstrap):
            self.rebootstrap(intent)
            _profiler.counter_bump("fault::elastic::rebootstraps", 1,
                                   cat="fault")
            return
        os.environ["MX_NUM_WORKERS"] = str(intent.new_world)
        os.environ["MX_WORKER_ID"] = str(intent.new_rank)
        if intent.coord:
            os.environ["MX_COORD_ADDR"] = str(intent.coord)
        import torch.distributed as dist
        if self.rebootstrap == "auto" and dist.is_available() and \
                dist.is_initialized():
            backend = dist.get_backend()       # the new group keeps it
            try:
                dist.destroy_process_group()
            # the old group is dying: its teardown may complain about
            # the peer that is gone
            except Exception as e:  # noqa: BLE001
                log.warning("destroy_process_group before resize: %s", e)
            _fdist.initialize(coordinator_address=intent.coord,
                              num_processes=intent.new_world,
                              process_id=intent.new_rank, backend=backend)
        from .kvstore import kvstore as _kv
        _kv.reset_distributed()
        _profiler.counter_bump("fault::elastic::rebootstraps", 1,
                               cat="fault")

    # -- drain-on-notice -----------------------------------------------
    def _drain(self, step):
        lease = self.lease if self.lease is not None \
            else _fault._step_lease()
        if lease is not None:
            # this rank is leaving: it must not keep skipping votes for
            # anything it still runs on the way out (the survivors
            # detect the departure via the heartbeat and resize)
            lease.revoke_local(reason="maintenance-drain")
        self._checkpoint(step)
        if self.board is not None:
            self.board.post(_bkey(self.info.epoch + 1, "leave",
                                  self.info.rank),
                            {"rank": self.info.rank, "step": step,
                             "reason": "maintenance"})
        _profiler.counter_bump("fault::elastic::drains", 1, cat="fault")
        log.warning("maintenance notice: rank %d drained at step %d "
                    "(checkpoint + leave record posted)",
                    self.info.rank, step)
        return ElasticStatus(False, True, step, self.resizes, self.info)

    # -- join (newcomer entry) -----------------------------------------
    def _join_fleet(self):
        """The newcomer's entry: block on the join barrier, then bind
        this process to the committed grown world.  Returns the step to
        resume from (the fleet's, not ours — we have no history)."""
        if self.board is None:
            raise ElasticAbortError("cannot join: no vote board")
        intent = vote_join(self.board, self._join,
                           drain=self.join_drain,
                           coord_hint=self._coord_hint(),
                           gen=self.info.gen.value)
        log.warning("elastic join: %r", intent)
        info = self.info
        info.epoch = intent.epoch
        info.survivors = list(intent.survivors)
        info.rank, info.world = intent.new_rank, intent.new_world
        info.gen.value = intent.gen
        info.lr_scale, info.batch_scale = self.rescale(info.orig_world,
                                                       info.world)
        self.resizes += 1
        self._do_rebootstrap(intent)
        if self.comm_factory is not None:
            self._bind_comm(info.rank, info.world, info.epoch)
        info.step = intent.step
        if self.restore_fn is not None:
            # the joiner has no checkpoint of its own: path is None and
            # the caller's restore_fn resolves the fleet's shared
            # artifact (e.g. a survivor's manifest on the shared fs) —
            # info carries the committed step/survivors it needs
            self.restore_fn(None, info)
        _profiler.counter_bump("fault::elastic::restores", 1,
                               cat="fault")
        if self.on_resize is not None:
            self.on_resize(info)
        return intent.step

    # -- the loop ------------------------------------------------------
    def _deliver_step_faults(self):
        """The ``peer_preempt`` seam: a hard preemption (SIGKILL, no
        notice) injected at this rank's N-th step — the offense half of
        the chaos scenario.  The softer ``preempt`` kind routes to the
        normal autosave delivery.  ``peer_join`` posts a join record
        under jid ``"injected"`` AS IF a replacement arrived — the beat
        rider turns it into a fleet-symmetric grow trigger (tests pair
        it with a concurrent ``ElasticRunner(join="injected")``)."""
        if not _fault._ACTIVE:
            return
        for f in _fault.check("step", op="elastic"):
            if f.kind == "peer_preempt":
                _fault._hard_preempt()
            elif f.kind == "preempt":
                _fault._deliver_preemption()
            elif f.kind == "peer_join" and self.board is not None:
                self.board.post(_jkey("injected"),
                                {"jid": "injected", "coord": None,
                                 "gen": 0})

    def run(self, steps, start_step=0):
        """Run ``step_fn`` until ``steps`` are done, resizing through
        peer loss; returns an :class:`ElasticStatus`.  Resumes from an
        existing elastic checkpoint in ``ckpt_dir`` when one is newer
        than ``start_step`` (restart-the-binary recovery)."""
        t = int(start_step)
        _flightrec.set_context(rank=self.info.rank,
                               world=self.info.world,
                               gen=self.info.gen.value,
                               epoch=self.info.epoch)
        if self._join is not None:
            t = self._join_fleet()
        elif self.ckpt_dir is not None and t == 0:
            try:
                # probe WITHOUT the RNG side effect: rewinding the
                # process-global numpy stream belongs to an accepted
                # resume, not to a probe that may reject the state
                st = _fault.load_elastic_state(self.ckpt_dir,
                                               restore_rng=False)
            except _fault.CorruptCheckpointError:
                st = None
            if st and int(st["step"]) > 0 and self.restore_fn is not None:
                rng = (st.get("rng") or {}).get("numpy")
                if rng is not None:
                    import numpy as _onp
                    _onp.random.set_state(rng)
                t = self._restore(st)
        try:
            while t < steps:
                try:
                    if self._notice_pending():
                        return self._drain(t)
                    self._deliver_step_faults()
                    if self._hb is not None:
                        # with an armed lease this beat IS the step's
                        # aggregate vote (and the activation handshake
                        # on the first one / after a resize); with a
                        # telemetry session it also carries the prior
                        # step's metrics fleet-wide — zero extra rounds
                        self._hb.beat(step=t)
                    _flightrec.record("step.begin", step=t,
                                      gen=self.info.gen.value,
                                      epoch=self.info.epoch)
                    t0 = time.monotonic()
                    loss = self.step_fn(t, self.info)
                    _flightrec.record(
                        "step.end", step=t,
                        host_ms=round((time.monotonic() - t0) * 1e3, 3))
                    if self.telemetry is not None:
                        self.telemetry.note_step_time(
                            time.monotonic() - t0, step=t)
                    self.history.append((t, self.info.epoch,
                                         None if loss is None
                                         else float(loss)))
                    t += 1
                    self.info.step = t
                    if self.ckpt_every and t % self.ckpt_every == 0:
                        self._checkpoint(t)
                except _fdist.PeerLostError as e:
                    log.warning("peer(s) %s lost at step %d — resizing",
                                list(e.process_indices), t)
                    self._resize(lost=e.process_indices)
                    t = self._restore()
                except _fdist.CoordinatedAbortError as e:
                    # coordinated retry exhausted: every rank raises
                    # this in the same round, so every rank enters the
                    # same vote.  Ranks that are genuinely gone miss
                    # the vote and drain out of the survivor set; if
                    # everyone is alive the "resize" keeps the world
                    # size and becomes a collective
                    # restore-from-checkpoint (fresh bootstrap, same
                    # fleet).  A revoked step lease lands here too —
                    # the beat round that flagged a covered-op failure
                    # raises CoordinatedAbortError on every rank.
                    log.warning("coordinated abort at step %d (%s) — "
                                "resizing", t, e)
                    self._resize(lost=())
                    t = self._restore()
                except JoinRequestedError as e:
                    # GROW: nothing failed — checkpoint the live state
                    # in place first, so the epoch the vote commits
                    # resumes at THIS step (no work lost, and the
                    # joiner restores the same artifact the survivors
                    # do).  Every rank raises in the same beat round,
                    # so every rank enters the same vote; the vote
                    # itself folds the pending jids.
                    log.warning("join request %s at step %d — growing",
                                list(e.joiners), t)
                    self._checkpoint(t)
                    self._resize(lost=())
                    t = self._restore()
            return ElasticStatus(True, False, t, self.resizes, self.info)
        except BaseException as e:
            # the run loop's own terminal seam: anything that escapes
            # (ElasticAbortError, a step_fn bug, KeyboardInterrupt)
            # flushes the black box before unwinding.  The dump budget
            # dedups against hooks that already fired (PeerLostError &c
            # dump in their constructors; each dump costs one slot).
            _flightrec.note_terminal("elastic_runner", exc=e)
            raise
        finally:
            # don't leak the runner's lease into the process after the
            # loop ends (the next runner/job re-arms its own)
            if self._installed_lease and \
                    _fault._step_lease() is self.lease:
                _fault._set_step_lease(None)
                hb = _fault._DIST_HEARTBEAT
                if hb is not None and getattr(hb, "lease", None) \
                        is self.lease:
                    hb.lease = None

# ----------------------------------------------------------------------
# autoscale policy (tentpole c): subscribe to the signal plane, PROPOSE
# ----------------------------------------------------------------------
def _scale_env(name, default):
    return float(os.environ.get("MXNET_TELEMETRY_SCALE_" + name,
                                str(default)))


class ScalePolicy:
    """Telemetry-driven autoscale proposals over the fleet signal plane.

    Subscribes to a runner's :class:`~mxnet_tpu_torch.telemetry.
    TelemetrySession` (``policy.attach()`` appends it to the session's
    ``consumers`` — every completed beat round's FleetView flows
    through :meth:`consume`, zero extra comm rounds) and PROPOSES
    resizes through the machinery every actual resize already uses:

    * **scale-up** — a load signal crossed its high-water mark (serving
      queue depth, step-time EWMA, free KV pages): post a
      ``rz/scale/up<seq>`` record on the vote board.  The policy cannot
      conjure a worker; the record is the request a supervisor
      (a launcher that spawns replacements, an operator, a cluster
      autoscaler) turns into a real process, whose :func:`vote_join`
      then runs the actual join epoch.
    * **scale-down** — the fleet is idle below the low-water mark:
      every rank's policy picks the SAME victim deterministically from
      the shared view (slowest step EWMA, ties to the highest rank),
      and only the victim acts — ``runner.notice()`` arms its own
      maintenance drain (checkpoint + leave record + clean exit; the
      survivors resize without it).

    Pure host-side state machine: every mutable field lives under ONE
    lock (no other lock is ever taken while holding it), and
    :meth:`consume` never raises into the beat.

    Knobs (environment, constructor args win)::

        MXNET_TELEMETRY_SCALE_QUEUE_HIGH    mean serve queue depth above
                                            which to propose up (8)
        MXNET_TELEMETRY_SCALE_QUEUE_LOW     mean queue depth below which
                                            to propose down (0 = never)
        MXNET_TELEMETRY_SCALE_STEP_MS_HIGH  mean step EWMA ms above which
                                            to propose up (0 = ignore)
        MXNET_TELEMETRY_SCALE_PAGES_LOW     min free serve pages below
                                            which to propose up
                                            (0 = ignore)
        MXNET_TELEMETRY_SCALE_COOLDOWN      beats between proposals (16)
        MXNET_TELEMETRY_SCALE_MIN_WORLD     never propose down below (1)
        MXNET_TELEMETRY_SCALE_MAX_WORLD     never propose up above
                                            (0 = the runner's original
                                            world, else unlimited)

    Counters: ``fault::elastic::scale_up`` / ``scale_down``.
    """

    def __init__(self, runner=None, *, board=None, queue_high=None,
                 queue_low=None, step_ms_high=None, pages_low=None,
                 cooldown=None, min_world=None, max_world=None,
                 on_propose=None):
        self.runner = runner
        self.board = board if board is not None else \
            (runner.board if runner is not None else None)
        self.queue_high = _scale_env("QUEUE_HIGH", 8) \
            if queue_high is None else float(queue_high)
        self.queue_low = _scale_env("QUEUE_LOW", 0) \
            if queue_low is None else float(queue_low)
        self.step_ms_high = _scale_env("STEP_MS_HIGH", 0) \
            if step_ms_high is None else float(step_ms_high)
        self.pages_low = _scale_env("PAGES_LOW", 0) \
            if pages_low is None else float(pages_low)
        self.cooldown = int(_scale_env("COOLDOWN", 16)) \
            if cooldown is None else int(cooldown)
        self.min_world = int(_scale_env("MIN_WORLD", 1)) \
            if min_world is None else int(min_world)
        if max_world is not None:
            self.max_world = int(max_world)
        else:
            mw = int(_scale_env("MAX_WORLD", 0))
            self.max_world = mw or (runner.info.orig_world
                                    if runner is not None else 0)
        self.on_propose = on_propose
        self._lock = threading.Lock()
        self._last_beat = None     # beat of the last proposal
        self._seq = 0
        self.proposals = []        # (beat, direction, reason)

    def attach(self, session=None):
        """Subscribe to a telemetry session (default: the runner's).
        Returns self."""
        sess = session if session is not None else \
            (self.runner.telemetry if self.runner is not None else None)
        if sess is None:
            raise ValueError("no telemetry session to attach to — pass "
                             "session= or build the runner with "
                             "telemetry enabled")
        sess.consumers.append(self)
        return self

    # -- the beat-side consumer ----------------------------------------
    def consume(self, view):
        """One completed round's FleetView in, at most one proposal
        out.  Runs on the beat thread — never raises into it."""
        try:
            decision, reason = self._decide(view)
            if decision is not None:
                self._propose(decision, reason, view)
        except Exception:  # noqa: BLE001
            log.exception("scale policy consume failed (ignored)")

    def _decide(self, view):
        with self._lock:
            last = self._last_beat
        if last is not None and view.beat - last < self.cooldown:
            return None, None
        world = view.world or len(view.ranks)

        def _mean(metric):
            vals = [v for v in view.get(metric).values()
                    if isinstance(v, (int, float))]
            return (sum(vals) / len(vals)) if vals else None

        q = _mean("serve::queue_depth")
        ms = _mean("step_ms_ewma")
        pages = [v for v in view.get("serve::free_pages").values()
                 if isinstance(v, (int, float))]
        if not self.max_world or world < self.max_world:
            if q is not None and self.queue_high and q > self.queue_high:
                return "up", "queue_depth %.1f > %.1f" % (q,
                                                          self.queue_high)
            if ms is not None and self.step_ms_high \
                    and ms > self.step_ms_high:
                return "up", "step_ms %.2f > %.2f" % (ms,
                                                      self.step_ms_high)
            if pages and self.pages_low \
                    and min(pages) < self.pages_low:
                return "up", "free_pages %d < %d" % (min(pages),
                                                     self.pages_low)
        if q is not None and self.queue_low and q < self.queue_low \
                and world > max(1, self.min_world):
            return "down", "queue_depth %.1f < %.1f" % (q,
                                                        self.queue_low)
        return None, None

    def _propose(self, direction, reason, view):
        with self._lock:
            self._last_beat = view.beat
            self._seq += 1
            seq = self._seq
            self.proposals.append((view.beat, direction, reason))
        if direction == "up":
            if self.board is not None:
                self.board.post("rz/scale/up%d" % seq,
                                {"dir": "up", "reason": reason,
                                 "beat": view.beat})
            _profiler.counter_bump("fault::elastic::scale_up", 1,
                                   cat="fault")
            log.warning("scale policy: proposing UP (%s)", reason)
        else:
            victim = self._pick_victim(view)
            _profiler.counter_bump("fault::elastic::scale_down", 1,
                                   cat="fault")
            log.warning("scale policy: proposing DOWN, victim rank %s "
                        "(%s)", victim, reason)
            if self.runner is not None \
                    and victim == self.runner.info.rank:
                # only the victim acts: its drain posts the leave
                # record and the survivors resize without it
                self.runner.notice()
        if self.on_propose is not None:
            self.on_propose(direction, reason, view)

    @staticmethod
    def _pick_victim(view):
        """Deterministic from the SHARED view, so every rank's policy
        names the same victim without a round of its own: the slowest
        rank by step EWMA, ties broken toward the highest rank."""
        by = view.get("step_ms_ewma")
        ranks = sorted(view.ranks)
        if not ranks:
            return None
        return max(ranks, key=lambda r: (
            by[r] if isinstance(by.get(r), (int, float)) else -1.0, r))
