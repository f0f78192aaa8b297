"""``mx.fault.dist`` -- coordinated multi-process fault tolerance.

Counterpart of ``mxnet_tpu/fault_dist.py``.  ``mx.fault`` recovers from
failures inside one process; across processes a retry that only ONE
worker takes deadlocks the job, because its peers are still parked in
the original collective.  So recovery here is a collective decision:

**Resilient bootstrap** -- :func:`initialize` wraps
``torch.distributed.init_process_group`` (a ``TCPStore`` rendezvous at
``host:port`` / ``tcp://host:port``, a ``FileStore`` at
``file:///path``) in a retry loop with backoff (knobs
``MXNET_FAULT_BOOTSTRAP_*``), a diagnostic per attempt, and an opt-in
degrade to one process when retries run out
(``fault::dist::bootstrap_retries`` / ``bootstrap_fallbacks``).  The
group gets an explicit ``timeout`` (``MXNET_FAULT_COLLECTIVE_TIMEOUT``,
seconds), so a survivor parked in a collective with a dead peer raises
instead of waiting out gloo's 30 minutes.

**Generation-gated collective retry** -- :class:`Generation` +
:func:`coordinated_call`.  Every attempt ends in a consensus barrier: an
allgather of ``(generation, ok, entry)`` votes.  Only when *all* workers
have voted does any worker act on the round: all-ok commits the result;
any failure makes *every* worker bump the generation and re-issue
together.  When ``mutating=True`` a vote recording a *mid-op* failure
aborts every worker instead of retrying (a re-run could double-apply a
gradient on workers that already committed;
``fault::dist::coordinated_retries`` / ``generation_bumps`` /
``gave_up``).

**Peer health** -- :class:`Heartbeat` piggybacks liveness on a
step-boundary allgather: a silent peer becomes a :class:`PeerLostError`
naming its rank after ``MXNET_FAULT_HEARTBEAT_TIMEOUT`` seconds
(``fault::dist::heartbeats`` / ``peer_lost``).

**Preemption notices** -- :class:`MaintenancePoller` polls the instance
metadata endpoint (``MXNET_FAULT_METADATA_URL`` overrides it) and feeds
``mx.fault.on_preemption``'s autosave before SIGTERM arrives
(``fault::dist::maintenance_events``).

**Step lease** -- :class:`StepLease` + :func:`enable_step_lease` amortize
the consensus barrier from per-op to per-step: under an ACTIVE lease the
success path pays no vote round, and ONE aggregate vote per step rides
the :class:`Heartbeat` the job already beats.  Any local failure (or a
failure flag in a peer's beat) revokes the lease on every rank in the
same beat round: the step aborts everywhere
(:class:`CoordinatedAbortError`; a covered op is never re-issued) and
coordinated ops fall back to per-op voting until the lease re-arms on
clean beats (``MXNET_FAULT_LEASE_REARM``).  ``MXNET_FAULT_LEASE=1`` arms
lease mode with the step heartbeat (``fault::dist::lease_ops /
lease_activations / lease_revocations``).

The votes ride a control-plane comm, not the data plane (they must flow
when the data plane is what failed): :class:`CoordServiceComm` (the
process group's ``torch.distributed.Store``: ``set`` / ``check`` /
``get``, each rank deleting its own records of finished rounds),
:class:`FileComm` (a shared-directory allgather that outlives any one
rank), :class:`InProcessComm` (threads, for tests) and
:class:`LocalComm` (one process: the plain ``mx.fault`` retry).

The error classifier :func:`classify_xla_error` sorts a device or
process-group runtime error by message: the reference's markers, plus
PyTorch's (an out-of-memory, an illegal memory access and a device-side
assert are fatal; an NCCL peer that exited, a gloo peer that closed its
connection and a collective that timed out are transient).

Injectable fault kinds (``MXNET_FAULT_SPEC`` DSL, seeded)::

    dist_bootstrap_fail@1      fail the 1st bootstrap attempt
    peer_hang@2                hang this worker's 2nd heartbeat past timeout
    maintenance_event@1        deliver a TERMINATE maintenance notice
"""
from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time

from . import fault as _fault
from . import flightrec as _flightrec
from . import profiler as _profiler

__all__ = [
    "BootstrapError", "PeerLostError", "GenerationMismatchError",
    "CoordinatedAbortError", "LeaseConfigError",
    "initialize",
    "Generation", "generation", "coordinated_call",
    "classify_xla_error",
    "LocalComm", "InProcessComm", "FileComm", "CoordServiceComm",
    "default_comm", "set_default_comm",
    "Heartbeat", "enable_step_heartbeat", "disable_step_heartbeat",
    "StepLease", "step_lease", "enable_step_lease", "disable_step_lease",
    "MaintenancePoller", "watch_maintenance",
    "TRANSIENT_XLA_MARKERS", "FATAL_XLA_MARKERS",
    "TRANSIENT_TORCH_MARKERS", "FATAL_TORCH_MARKERS",
]

log = logging.getLogger("mxnet_tpu_torch.fault.dist")

#: The model checker's virtual clock (``analysis.modelcheck``): its
#: simulated threads set ``_SIM_CLOCK.fn`` so deadlines run on the
#: checker's clock; every other thread reads the real one.
#: ``fault_elastic`` shares this object.
_SIM_CLOCK = threading.local()


def _now():
    """``time.monotonic``, or the model checker's clock on its threads."""
    clk = getattr(_SIM_CLOCK, "fn", None)
    return clk() if clk is not None else time.monotonic()


# ----------------------------------------------------------------------
# exceptions
# ----------------------------------------------------------------------
class BootstrapError(_fault.FaultError):
    """The process-group bootstrap failed after every retry."""


class PeerLostError(_fault.FaultError):
    """A peer worker stopped participating (hang, crash, partition).

    ``process_indices`` names the missing workers; ``-1`` means the comm
    could not attribute the loss to specific ranks."""

    def __init__(self, msg, process_indices=()):
        super().__init__(msg)
        self.process_indices = tuple(process_indices)
        # which ranks THIS rank lost: the postmortem's victim signal,
        # recorded before note_terminal so the dump already has it
        _flightrec.record("error.peer_lost",
                          ranks=self.process_indices)
        _flightrec.note_terminal("peer_lost", exc=self)


class GenerationMismatchError(_fault.FaultError):
    """Votes from two generations met in one consensus round: workers
    diverged, which the gate exists to prevent; fail loudly."""


class CoordinatedAbortError(_fault.FaultError):
    """The consensus decision was to abort (a peer hit a non-retryable
    failure); every worker raises this in the same round."""

    def __init__(self, *args):
        super().__init__(*args)
        _flightrec.note_terminal("coordinated_abort", exc=self)


class LeaseConfigError(_fault.FaultError):
    """Step-lease mode is on for this rank but a peer's beat carries no
    lease state: a mixed world would split into ranks that vote per-op
    and ranks that do not.  Raised at the first beat, before the lease
    ever activates."""


# ----------------------------------------------------------------------
# resilient process-group bootstrap
# ----------------------------------------------------------------------
_TRANSIENT_BOOTSTRAP_MARKERS = (
    "DEADLINE_EXCEEDED", "UNAVAILABLE", "failed to connect",
    "Connection refused", "connection attempt", "Timed out",
    "timed out", "Unable to connect", "coordinator",
    "Address already in use",  # the port in TIME_WAIT after a crash
    "Connection reset", "Socket Timeout", "client socket",
)
#: the messages of a process group that is already up: the bootstrap
#: succeeded elsewhere
_ALREADY_MARKERS = ("initialize the default process group twice",
                    "already initialized")


def _is_transient_bootstrap_error(e):
    if isinstance(e, (_fault.TransientError, ConnectionError, TimeoutError,
                      OSError)):
        return True
    text = str(e)
    return isinstance(e, RuntimeError) and \
        any(m in text for m in _TRANSIENT_BOOTSTRAP_MARKERS)


def _bootstrap_policy():
    env = os.environ
    return _fault.RetryPolicy(
        max_retries=int(env.get("MXNET_FAULT_BOOTSTRAP_RETRIES", "3")),
        base_delay=float(env.get("MXNET_FAULT_BOOTSTRAP_BACKOFF", "0.5")),
        max_delay=float(env.get("MXNET_FAULT_BOOTSTRAP_BACKOFF_MAX",
                                "10.0")),
        timeout=False,
        # the classifier above calls a bare OSError transient (a name
        # that does not resolve yet...): the attempt loop catches it too
        retry_on=(_fault.TransientError, OSError))


def _collective_timeout():
    """The process group's collective timeout, seconds
    (``MXNET_FAULT_COLLECTIVE_TIMEOUT``; 1800, PyTorch's own default)."""
    return float(os.environ.get("MXNET_FAULT_COLLECTIVE_TIMEOUT", "1800"))


def _default_backend(num_processes):
    """NCCL when every process can have a card of its own, else gloo
    (ranks sharing a card, or none)."""
    import torch
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= int(num_processes or 1):
        return "nccl"
    return "gloo"


def _make_store(address, num_processes, process_id, timeout):
    """The rendezvous store at ``address``: ``file:///path`` a
    ``FileStore``, ``[tcp://]host:port`` a ``TCPStore`` that process 0
    hosts."""
    import torch.distributed as dist
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], int(num_processes))
    hostport = address[len("tcp://"):] if address.startswith("tcp://") \
        else address
    host, _, port = hostport.rpartition(":")
    return dist.TCPStore(host or "127.0.0.1", int(port),
                         world_size=int(num_processes),
                         is_master=int(process_id) == 0,
                         timeout=datetime.timedelta(seconds=timeout),
                         wait_for_workers=False)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               fallback=None, policy=None, backend=None, timeout=None):
    """Join the ``torch.distributed`` job, retrying transient rendezvous
    failures with backoff.

    Returns ``True`` when the process is part of the job (including when
    a process group was already up), ``False`` when retries ran out and
    the degrade-to-one-process fallback is on (``fallback=True`` or
    ``MXNET_FAULT_BOOTSTRAP_FALLBACK=1``): the caller keeps running alone
    on its card instead of crash-looping.  Otherwise raises
    :class:`BootstrapError` chained on the last attempt's error.

    ``coordinator_address`` is ``[tcp://]host:port`` (process 0 hosts a
    ``TCPStore``) or ``file:///path`` (a ``FileStore``).
    ``MXNET_FAULT_BOOTSTRAP_TIMEOUT`` (seconds, default 300) bounds each
    attempt's rendezvous; ``timeout`` (default
    ``MXNET_FAULT_COLLECTIVE_TIMEOUT``) is the group's collective
    timeout; ``backend`` defaults to NCCL when every process can have a
    card, else gloo.  Every attempt logs
    a diagnostic naming the coordinator, the attempt and the failure."""
    import torch.distributed as dist

    if fallback is None:
        fallback = os.environ.get("MXNET_FAULT_BOOTSTRAP_FALLBACK", "0") \
            not in ("", "0", "false", "False")
    policy = policy or _bootstrap_policy()
    rdv_timeout = float(os.environ.get("MXNET_FAULT_BOOTSTRAP_TIMEOUT",
                                       "300"))
    pg_timeout = _collective_timeout() if timeout is None else float(timeout)
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    backend = backend or _default_backend(world)
    attempt = 0
    last = None
    while attempt <= policy.max_retries:
        attempt += 1
        try:
            _profiler.counter_bump("fault::dist::bootstrap_attempts", 1,
                                   cat="fault")
            if _fault._ACTIVE and _fault.check("dist_bootstrap",
                                               op="initialize"):
                raise _fault.InjectedFault(
                    "injected process-group bootstrap failure")
            if dist.is_initialized():
                return True  # someone else initialized: that IS success
            if coordinator_address is None:
                if world > 1:
                    raise BootstrapError(
                        "a %d-process bootstrap needs a coordinator_address"
                        % world)
                store = dist.HashStore()
            else:
                store = _make_store(coordinator_address, world, rank,
                                    rdv_timeout)
            dist.init_process_group(
                backend, store=store, rank=rank, world_size=world,
                timeout=datetime.timedelta(seconds=pg_timeout))
            log.info("process-group bootstrap OK (coordinator=%s, process "
                     "%s/%s, %s, attempt %d)", coordinator_address, rank,
                     world, backend, attempt)
            return True
        except (RuntimeError, ValueError) as e:
            if any(m in str(e) for m in _ALREADY_MARKERS):
                return True
            if isinstance(e, BootstrapError):
                raise
            last = e
        except policy.retry_on as e:
            last = e
        if not _is_transient_bootstrap_error(last):
            break
        if attempt > policy.max_retries:
            break
        delay = policy.delay(attempt)
        log.warning(
            "process-group bootstrap attempt %d/%d failed "
            "(coordinator=%s, process %s/%s): %s -- retrying in %.2fs",
            attempt, policy.max_retries + 1, coordinator_address,
            rank, world, last, delay)
        _profiler.counter_bump("fault::dist::bootstrap_retries", 1,
                               cat="fault")
        time.sleep(delay)
    # the fallback is for TRANSIENT exhaustion only: a non-transient
    # error is a configuration bug, and degrading there would train N
    # divergent one-process models instead of surfacing it
    if fallback and _is_transient_bootstrap_error(last):
        log.error(
            "process-group bootstrap failed after %d attempts "
            "(coordinator=%s): %s -- degrading to one process "
            "(MXNET_FAULT_BOOTSTRAP_FALLBACK)", attempt,
            coordinator_address, last)
        _profiler.counter_bump("fault::dist::bootstrap_fallbacks", 1,
                               cat="fault")
        return False
    raise BootstrapError(
        "process-group bootstrap failed after %d attempts "
        "(coordinator=%s, process %s/%s): %s" % (
            attempt, coordinator_address, rank, world, last)) from last


# ----------------------------------------------------------------------
# control-plane comms (vote transport for the consensus barrier)
# ----------------------------------------------------------------------
def _consensus_timeout():
    return float(os.environ.get("MXNET_FAULT_CONSENSUS_TIMEOUT", "60"))


class LocalComm:
    """Single-process comm: the barrier is trivially this worker."""

    rank = 0
    world = 1

    def allgather(self, payload, timeout=None):
        return [payload]


class InProcessComm:
    """Thread-backed comm for tests: ``create(world)`` returns one
    endpoint per simulated worker; ``allgather`` blocks until every
    endpoint's vote for the same round arrived (or times out with a
    :class:`PeerLostError` naming the silent ranks).  Votes persist per
    round, so a slow worker still completes its round after fast peers
    timed out, as with the file and store comms."""

    def __init__(self, rank, shared):
        self.rank = rank
        self._shared = shared
        self.world = shared["world"]
        self._round = 0

    @classmethod
    def create(cls, world):
        shared = {"world": world, "rounds": {},
                  "cond": threading.Condition(threading.Lock())}
        return [cls(r, shared) for r in range(world)]

    def allgather(self, payload, timeout=None):
        timeout = _consensus_timeout() if timeout is None else timeout
        rnd = self._round
        self._round += 1
        sched = self._shared.get("sched")
        if sched is not None:
            # the model checker's seam (analysis.modelcheck): a
            # cooperative, virtual-time twin of the wait below.  Votes
            # persist per round and a timeout names the silent ranks, as
            # there, but blocking and deadline expiry are the
            # scheduler's decisions.  Nothing else sets "sched".
            votes = self._shared["rounds"].setdefault(rnd, {})
            sched.point("comm.vote", obj=("comm", id(self._shared), rnd),
                        write=True,
                        detail="round %d rank %d" % (rnd, self.rank))
            votes[self.rank] = payload
            if not sched.block(lambda: len(votes) >= self.world,
                               obj=("comm", id(self._shared), rnd),
                               timeout=timeout,
                               detail="round %d rank %d" % (rnd, self.rank)):
                missing = sorted(set(range(self.world)) - set(votes))
                raise PeerLostError(
                    "consensus round %d: no vote from process(es) %s "
                    "within %.1fs" % (rnd, missing, timeout),
                    process_indices=missing)
            out = [votes[r] for r in sorted(votes)]
            self._shared["rounds"].pop(rnd - 1, None)
            return out
        cond = self._shared["cond"]
        with cond:
            votes = self._shared["rounds"].setdefault(rnd, {})
            votes[self.rank] = payload
            cond.notify_all()
            deadline = _now() + timeout
            while len(votes) < self.world:
                left = deadline - _now()
                if left <= 0:
                    missing = sorted(set(range(self.world)) - set(votes))
                    raise PeerLostError(
                        "consensus round %d: no vote from process(es) %s "
                        "within %.1fs" % (rnd, missing, timeout),
                        process_indices=missing)
                cond.wait(left)
            out = [votes[r] for r in sorted(votes)]
            # completing round N proves every endpoint entered it, so no
            # one still waits inside round N-1
            self._shared["rounds"].pop(rnd - 1, None)
            return out


class _RoundComm:
    """Bookkeeping shared by the persistent-vote comms (:class:`FileComm`,
    :class:`CoordServiceComm`): the namespace (by default this process's
    construction sequence for ``seq_key``, so the rank endpoints of one
    logical comm, built in the same order on every rank, meet, and a
    second comm cannot consume the first one's rounds), the round
    counter, and the deletion of this endpoint's own finished rounds.

    Subclasses provide a class-level ``_seq`` dict and
    ``_discard_round(rnd)``."""

    def _init_rounds(self, namespace, seq_key=None):
        if namespace is None:
            seq = type(self)._seq
            namespace = "mx%d" % seq.get(seq_key, 0)
            seq[seq_key] = seq.get(seq_key, 0) + 1
        self._ns = namespace
        self._round = 0
        self._gced = 0  # own votes of rounds below this are deleted

    def _next_round(self, timeout):
        rnd = self._round
        self._round += 1
        return rnd, (_consensus_timeout() if timeout is None else timeout)

    def _gc_rounds(self, rnd):
        """Completing round ``rnd`` proves every rank entered it, hence
        finished every round below: this endpoint's older records are
        dead.  Only our own records are deleted (no cross-rank races)."""
        while self._gced < rnd:
            try:
                self._discard_round(self._gced)
            # best effort: GC must never fail a completed round
            except Exception:  # noqa: BLE001
                pass
            self._gced += 1


class FileComm(_RoundComm):
    """Shared-directory allgather: round ``i`` of rank ``r`` is the file
    ``<ns>_ag_<i>.<r>.json`` under ``root``, written atomically; every
    rank polls for the full set.  Works wherever the workers share a
    filesystem, and outlives any one rank (unlike a ``TCPStore``, which
    dies with its host).  Votes persist on disk, so a rank that timed
    out stays round-aligned with a slow peer that completes the round
    late.  The construction-sequence key is ``(root, rank)``; pass
    ``namespace`` when construction order is rank-dependent."""

    _seq = {}  # (abspath(root), rank) -> instances constructed so far

    def __init__(self, root, rank, world, poll=0.02, namespace=None):
        self.root = root
        self.rank = int(rank)
        self.world = int(world)
        self.poll = poll
        self._init_rounds(namespace, (os.path.abspath(root), self.rank))
        os.makedirs(root, exist_ok=True)

    def _path(self, rnd, rank):
        return os.path.join(self.root,
                            "%s_ag_%d.%d.json" % (self._ns, rnd, rank))

    def _discard_round(self, rnd):
        os.remove(self._path(rnd, self.rank))

    def allgather(self, payload, timeout=None):
        rnd, timeout = self._next_round(timeout)
        tmp = self._path(rnd, self.rank) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(rnd, self.rank))
        deadline = _now() + timeout
        votes = {}
        while len(votes) < self.world:
            for r in range(self.world):
                if r in votes:
                    continue
                try:
                    with open(self._path(rnd, r)) as f:
                        votes[r] = json.load(f)
                except (OSError, ValueError):
                    continue  # not written yet (or mid-replace)
            if len(votes) == self.world:
                break
            if _now() > deadline:
                missing = sorted(set(range(self.world)) - set(votes))
                raise PeerLostError(
                    "consensus round %d: no vote from process(es) %s "
                    "within %.1fs" % (rnd, missing, timeout),
                    process_indices=missing)
            time.sleep(self.poll)
        self._gc_rounds(rnd)
        return [votes[r] for r in sorted(votes)]


class CoordServiceComm(_RoundComm):
    """Votes over the process group's ``torch.distributed.Store`` (the
    ``TCPStore`` / ``FileStore`` of the rendezvous): each rank ``set``s
    its vote, polls ``check`` until every rank's key is there, and
    ``get``s them.  The
    store is the control plane that already survives a failed data-plane
    collective, with no extra infrastructure (a ``TCPStore`` dies with
    its host rank: fleets that must survive rank 0 vote on a
    :class:`FileComm`).

    Votes persist in the store past a timeout, so a slow-but-alive rank
    whose peers already raised :class:`PeerLostError` naming it still
    completes its round late and stays round-aligned
    (``fault::dist::late_rounds``).  Keys are namespaced per instance (a
    per-process construction sequence, via :class:`_RoundComm`), which
    lines up across ranks when every rank builds its comms in the same
    order; pass ``namespace`` otherwise."""

    _seq = {}  # None (one process-wide sequence) -> instances so far

    def __init__(self, client=None, rank=None, world=None, namespace=None):
        import torch.distributed as dist
        self._client = client if client is not None else _coord_client()
        if self._client is None:
            raise BootstrapError(
                "no torch.distributed store to vote on (initialize() "
                "first)")
        self.rank = dist.get_rank() if rank is None else int(rank)
        self.world = dist.get_world_size() if world is None else int(world)
        self._init_rounds(namespace, None)

    def _key(self, rnd, rank):
        return "/%s_fault_ag/%d/%d" % (self._ns, rnd, rank)

    def _discard_round(self, rnd):
        self._client.delete_key(self._key(rnd, self.rank))

    def _wait(self, keys, timeout):
        """Until every key is in the store: ``check`` polled with a
        backoff from 50 us to 2 ms (a ``FileStore``'s own ``wait`` sleeps
        10 ms a poll, which a vote a kvstore op cannot afford)."""
        deadline = _now() + timeout
        delay = 5e-5
        while not self._client.check(keys):
            if _now() > deadline:
                raise TimeoutError("votes missing after %.1fs" % timeout)
            time.sleep(delay)
            delay = min(2 * delay, 2e-3)

    def _lost(self, rnd, why, cause):
        """A :class:`PeerLostError` naming the ranks whose round-``rnd``
        votes are not in the store (``-1`` when the store cannot say)."""
        try:
            missing = [r for r in range(self.world) if r != self.rank
                       and not self._client.check([self._key(rnd, r)])]
        # the store itself is gone (its host died): nobody can be named
        except Exception:  # noqa: BLE001
            missing = [-1]
        return missing, PeerLostError(
            "consensus round %d %s (no vote from process(es) %s): %s"
            % (rnd, why, missing, cause), process_indices=missing)

    def allgather(self, payload, timeout=None):
        rnd, timeout = self._next_round(timeout)
        keys = [self._key(rnd, r) for r in range(self.world)]
        try:
            self._client.set(keys[self.rank], json.dumps(payload))
        except Exception as e:  # noqa: BLE001 -- the store is unreachable
            raise self._lost(rnd, "could not post its vote", e)[1] from e
        try:
            self._wait(keys, timeout)
        except Exception as e:  # noqa: BLE001 -- store error types vary
            missing, err = self._lost(rnd, "timed out after %.1fs"
                                      % timeout, e)
            if missing:
                raise err from e
            # every vote landed: this was the slow rank, whose peers
            # already raised naming it; complete the round late so the
            # round counter stays aligned with theirs
            log.warning("consensus round %d timed out after %.1fs but "
                        "every vote landed -- completing it late (%s)",
                        rnd, timeout, e)
            _profiler.counter_bump("fault::dist::late_rounds", 1,
                                   cat="fault")
        try:
            out = [json.loads(self._client.get(k)) for k in keys]
        except Exception as e:  # noqa: BLE001 -- the store is unreachable
            raise self._lost(rnd, "could not read the votes", e)[1] from e
        # delete our own finished rounds, so a heartbeat-a-step job does
        # not grow the store without bound
        self._gc_rounds(rnd)
        return out


def _coord_client():
    """The default process group's store, or None without a group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


_default_comm = None
_auto_client = None  # the store an auto-resolved default comm votes on
# the ambient comm and the shared generation resolve lazily from
# whichever thread first needs them (heartbeat, poller): the lock keeps
# two first callers from installing two singletons
_ambient_lock = threading.Lock()


def default_comm():
    """The ambient comm: :class:`LocalComm` with one process, a
    :class:`CoordServiceComm` over the process group's store when a group
    of more than one is up.  Overridable with :func:`set_default_comm`
    (tests, shared-filesystem fleets).  Only the multi-process answer is
    cached, and only while the group it was built over is the live one:
    after a re-bootstrap (``fault_elastic``) it votes on the new store."""
    global _default_comm, _auto_client
    with _ambient_lock:
        client = _coord_client()
        if _default_comm is not None:
            if _auto_client is None or _auto_client is client:
                return _default_comm
            _default_comm = _auto_client = None   # its group is gone
        if client is not None and _world() > 1:
            _default_comm = CoordServiceComm(client=client)
            _auto_client = client
            return _default_comm
    return LocalComm()


def set_default_comm(comm):
    """Install ``comm`` as the ambient comm (``None`` resets to
    auto-detection)."""
    global _default_comm, _auto_client
    with _ambient_lock:
        _default_comm = comm
        _auto_client = None
    return comm


# ----------------------------------------------------------------------
# device and process-group runtime-error classification
# ----------------------------------------------------------------------
#: message fragments of a transient transport failure (retry-worthy),
#: the reference's list
TRANSIENT_XLA_MARKERS = (
    "UNAVAILABLE",             # grpc/DCN channel dropped
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "Connection reset",
    "connection reset",
    "Connection refused",
    "Connection timed out",
    "Socket closed",
    "Broken pipe",
    "transport is closing",
    "failed to connect",
    "timed out",
    "Timed out",
)
#: fragments that are fatal no matter what else the message says, the
#: reference's list
FATAL_XLA_MARKERS = (
    "RESOURCE_EXHAUSTED",      # OOM -- a retry re-allocates the same bytes
    "Out of memory",
    "out of memory",
    "OOM",
    "INVALID_ARGUMENT",        # program/shape bug
    "FAILED_PRECONDITION",
    "UNIMPLEMENTED",
    "Compilation failure",
    "compilation failure",
    "Mosaic",                  # custom-kernel lowering bug
)
#: PyTorch's transient device-runtime messages: an NCCL or gloo peer
#: that went away, a reset socket under the process group (a gloo
#: collective that timed out reads "Timed out", a reference marker)
TRANSIENT_TORCH_MARKERS = (
    "remote process exited",
    "ncclRemoteError",
    "Connection closed by peer",   # gloo: the peer's process went away
    "Connection reset by peer",
)
#: PyTorch's fatal device-runtime messages: the CUDA context is gone
#: (illegal address, a failed device-side assert) or memory ran out
FATAL_TORCH_MARKERS = (
    "illegal memory access",
    "illegal address",
    "device-side assert",
    "unspecified launch failure",
    "CUBLAS_STATUS_",
)

#: error classes that are a device runtime's, by name (the reference's
#: contract: names, not imports)
_RUNTIME_CLASSES = ("XlaRuntimeError", "JaxRuntimeError", "OutOfMemoryError",
                    "AcceleratorError", "DistError", "DistBackendError",
                    "DistNetworkError")
#: a plain RuntimeError is the device runtime's when its message says so
_RUNTIME_TEXT = ("CUDA error", "NCCL", "CUDA out of memory", "cuDNN error",
                 "CUBLAS_STATUS_", "gloo", "Gloo")


def _is_runtime_error(e):
    if any(c.__name__ in _RUNTIME_CLASSES for c in type(e).__mro__):
        return True
    return isinstance(e, RuntimeError) and any(
        m in str(e) for m in _RUNTIME_TEXT)


def classify_xla_error(e):
    """``"transient"`` / ``"fatal"`` / ``None`` for a device-runtime
    error (``None``: not one, or a message no marker names -- the
    caller's own classification applies).  Fatal markers win over
    transient ones: an OOM diagnostic that happens to mention a reset
    connection while tearing down must not be retried."""
    if not _is_runtime_error(e):
        return None
    text = str(e)
    if any(m in text for m in FATAL_XLA_MARKERS + FATAL_TORCH_MARKERS):
        return "fatal"
    if any(m in text for m in TRANSIENT_XLA_MARKERS
           + TRANSIENT_TORCH_MARKERS):
        return "transient"
    return None


# ----------------------------------------------------------------------
# generation-gated coordinated retry
# ----------------------------------------------------------------------
#: Protocol bugs put back on purpose, armed only by
#: ``analysis.modelcheck.mutations()`` to show the checker finds each
#: (``"solo_reissue"``: a transiently failed rank retries without
#: voting; ``"skip_lease_revoke"``: a rank ignores a peer's failure flag
#: in the step-lease beat and keeps its lease).  Empty in production.
_TEST_MUTATIONS = set()


class Generation:
    """Monotonic recovery epoch shared by all workers of a job.  Bumps
    only happen from a *complete* vote round (every worker saw the same
    votes), so equal values across workers is an invariant — and
    :func:`coordinated_call` hard-fails on any observed divergence."""

    def __init__(self, value=0):
        self.value = int(value)
        self._lock = threading.Lock()

    def bump(self):
        with self._lock:
            self.value += 1
            _profiler.counter_bump("fault::dist::generation_bumps", 1,
                                   cat="fault")
            return self.value

    def __repr__(self):
        return "Generation(%d)" % self.value


_generation = None


def generation():
    """The process-global :class:`Generation` (one recovery epoch per
    job; every coordinated op shares it).  Resolved under
    ``_ambient_lock``: two threads racing the first call must not mint
    two Generation objects — gen-gated retry compares ``gen.value``
    across attempts, and a split singleton would let a re-issue pass
    the gate against the wrong epoch ."""
    global _generation
    with _ambient_lock:
        if _generation is None:
            _generation = Generation()
        return _generation


def coordinated_call(fn, comm=None, op=None, policy=None, mutating=False,
                     gen=None, timeout=None, lease=None):
    """Run collective ``fn`` on every worker with generation-gated retry.

    Protocol per attempt (identical on every worker):

    1. run ``fn`` locally; classify the outcome — ok, a retryable
       transient (``policy.retry_on``), or fatal (any other
       ``Exception``).  Fatal outcomes are voted too — skipping the
       vote would leave this rank's comm round counter permanently
       behind its peers (every later round would read stale votes), and
       voting turns the peers' slow ``PeerLostError`` timeout into an
       immediate coordinated abort.  Only a death that prevents voting
       at all (process kill) surfaces as the peers' vote timeout.
    2. consensus barrier: allgather ``(generation, ok, entry)`` votes.
       **No worker proceeds past this point until every worker voted** —
       this is what makes a solo retry impossible.
    3. all-ok → return the local result.  Any failure → every worker
       bumps the shared generation and either retries together (backoff,
       ``fault::dist::coordinated_retries``) or — when the budget is
       spent, or ``mutating=True`` and any worker got past the entry
       seam — raises together: :class:`CoordinatedAbortError` everywhere
       (a rank's transient local error is chained as ``__cause__``, not
       re-raised — a transient type escaping here would let an outer
       ``mx.fault.retry_call`` re-enter solo), except that a rank whose
       own failure was *fatal* re-raises that real error.

    ``lease`` opts the op into step-granularity consensus: ``True``
    rides the process-wide :class:`StepLease` (when one is ACTIVE —
    see :func:`enable_step_lease`), a :class:`StepLease` instance rides
    that lease (tests, bench), ``None``/``False`` always votes per-op.
    Under an active lease the success path pays ZERO vote rounds (the
    aggregate vote piggybacks on the step-boundary heartbeat) and ANY
    local failure revokes the lease and aborts the step on every worker
    — covered ops are never re-issued, because an optimistically
    advanced peer may already have applied them (see
    :meth:`StepLease.escalate`).  While the lease is pending or revoked
    the call takes the per-op voting path below — that IS the
    escalation mode.

    ``entry`` in a vote means the failure was raised at the injection
    entry seam, before any state mutation.  A ``mutating`` op is only
    re-issued when EVERY worker's attempt failed at the entry seam: a
    worker whose attempt *succeeded* already applied its update, so a
    re-run would double-apply there (the cross-host extension of the
    ``mx.fault.entry_only_policy`` rule) — any partial-success round on
    a mutating op aborts every worker instead.

    Limitation (by design): the vote happens after ``fn`` completes
    locally.  A peer still parked inside a *blocking* data-plane
    collective cannot vote; the workers that did fail surface a
    :class:`PeerLostError` after the consensus timeout, and the parked
    peer is bounded by the data-plane's own timeout plus the launcher's
    supervision (``tools/launch.py`` tears down survivors when any
    worker dies) — the job fails loudly rather than deadlocking, and
    the retry-together path applies when the failure is visible on
    every worker (the common case for a failed collective).
    """
    comm = comm or default_comm()
    policy = policy or _fault.mutating_policy()
    gen = gen or generation()
    if isinstance(comm, LocalComm):
        # single process: the barrier is vacuous; use the plain retry
        # runtime.  The entry-seam rule still binds a mutating op —
        # with a real comm a non-entry failure aborts every worker, so
        # the degenerate comm must not quietly re-run the mutation
        # either
        if mutating:
            return _fault.retry_call(
                fn, policy=_fault.entry_only_policy(), op=op)
        return _fault.retry_call(fn, policy=policy, op=op)
    if lease is True:
        lease = _fault._step_lease()
    if lease is not None and lease is not False and lease.active():
        return _lease_call(fn, lease, op=op)
    failures = 0
    while True:
        start_gen = gen.value
        result, err, fatal = None, None, False
        try:
            result = fn()
        except policy.retry_on as e:
            err = e
        except Exception as e:  # noqa: BLE001 — fatal, but still voted:
            # a rank that raises without voting would stay one round
            # behind its peers forever (stale-vote consumption on every
            # later op), and its peers would burn the full consensus
            # timeout instead of aborting together now.  One carve-out:
            # an XlaRuntimeError whose message names a transient
            # transport failure (reset DCN connection, coordinator
            # blip) is retry-worthy — but NOT an entry-seam failure, so
            # a mutating op still aborts (the vote below records
            # entry=False)
            if classify_xla_error(e) == "transient":
                err = e
            else:
                err, fatal = e, True
        if _TEST_MUTATIONS and "solo_reissue" in _TEST_MUTATIONS \
                and err is not None and not fatal:
            # the mutation: the failed rank retries ALONE, with no vote
            # and no shared generation bump
            failures += 1
            if failures > policy.max_retries:
                raise err
            time.sleep(policy.delay(failures))
            continue
        vote = {"gen": start_gen, "ok": err is None,
                "entry": (err is None
                          or isinstance(err, _fault.InjectedFault))
                and not fatal,
                "fatal": fatal,
                "rank": comm.rank}
        _flightrec.record("coord.entry", op=str(op or "collective"),
                          gen=start_gen, attempt=failures,
                          ok=err is None, fatal=fatal)
        try:
            votes = comm.allgather(vote, timeout=timeout)
        except PeerLostError:
            _profiler.counter_bump("fault::dist::peer_lost", 1, cat="fault")
            raise
        _profiler.counter_bump("fault::dist::vote_rounds", 1, cat="fault")
        _flightrec.record("coord.vote", op=str(op or "collective"),
                          gen=start_gen,
                          round=getattr(comm, "_round", None),
                          bad=tuple(sorted(v["rank"] for v in votes
                                           if not v["ok"])))
        gens = set(v["gen"] for v in votes)
        if len(gens) > 1:
            raise GenerationMismatchError(
                "consensus votes span generations %s for op %s — workers "
                "diverged" % (sorted(gens), op))
        bad = [v for v in votes if not v["ok"]]
        if not bad:
            return result
        failures += 1
        gen.bump()  # every worker, from the same complete vote round
        # a fatal (non-transient) failure anywhere aborts the round on
        # every worker — retrying cannot help, and the failing rank is
        # re-raising its error regardless.  A mutating op may only be
        # re-issued when NO worker mutated state: every attempt must
        # have died at the entry seam.  A worker that voted ok already
        # applied its update — re-running it would double-apply, so
        # that round aborts everywhere.
        retryable = not any(v.get("fatal") for v in votes) and \
            ((not mutating)
             or all((not v["ok"]) and v["entry"] for v in votes))
        if failures > policy.max_retries or not retryable:
            _profiler.counter_bump("fault::dist::gave_up", 1, cat="fault")
            if fatal:
                raise err  # the real non-transient failure on this rank
            if retryable:
                why = "retry budget spent"
            elif any(v.get("fatal") for v in votes):
                why = "non-transient failure on process(es) %s" % sorted(
                    v["rank"] for v in votes if v.get("fatal"))
            else:
                why = "mutating op with a non-entry failure or " \
                      "partial success"
            # a transient-typed local error must NOT escape the abort
            # path: a caller wrapping this dist op in a generic retry
            # (mx.fault.retry_call) would classify it retryable and
            # re-enter solo — the exact deadlock this layer forbids.
            # Wrap it; the local error stays chained as __cause__.
            raise CoordinatedAbortError(
                "op %s failed on process(es) %s at generation %d (%s%s) "
                "— aborting on every worker" % (
                    op, sorted(v["rank"] for v in bad), start_gen, why,
                    ": %s" % err if err is not None else "")) from err
        _profiler.counter_bump("fault::dist::coordinated_retries", 1,
                               cat="fault")
        _flightrec.record("coord.retry", op=str(op or "collective"),
                          gen=gen.value, attempt=failures)
        if _profiler._recording():
            _profiler.record_instant(
                "fault::dist::retry::%s" % (op or "collective"),
                cat="fault")
        time.sleep(policy.delay(failures))


def _lease_call(fn, lease, op=None):
    """The step-lease success-path fast lane: run ``fn`` with NO vote
    round — the op is covered by the lease's aggregate vote at the next
    step-boundary beat.  Any local failure revokes the lease and
    escalates through that beat immediately (ONE shared round: this
    rank beats early with the failure flag, peers join at their natural
    step boundary), aborting the step on every worker.  A covered op is
    NEVER re-issued: a peer may already have optimistically applied it
    — and later ops — before the flag reaches it, so a re-run could
    double-apply there; recovery is the caller's checkpoint/elastic
    path, exactly as for any :class:`CoordinatedAbortError`.

    The per-op protocol's fatal-error rule carries over: a rank whose
    own failure is non-transient (OOM, shape bug) still votes the flag
    — peers abort together — but re-raises the REAL error as itself,
    so a deterministically broken rank exits identifiably instead of
    entering its supervisor's resize-and-retry loop."""
    try:
        result = fn()
    except Exception as e:  # noqa: BLE001 — every failure escalates
        fatal = not (isinstance(e, (_fault.TransientError,
                                    ConnectionError, TimeoutError))
                     or classify_xla_error(e) == "transient")
        try:
            lease.escalate(op=op, error=e,
                           entry=isinstance(e, _fault.InjectedFault))
        except CoordinatedAbortError:
            if fatal:
                raise e  # the real non-transient failure on this rank
            raise
        raise
    lease.note_op(op)
    return result


# ----------------------------------------------------------------------
# step lease: step-granularity consensus
# ----------------------------------------------------------------------
class StepLease:
    """Amortizes the consensus barrier from per-op to per-step.

    State machine (transitions only from complete beat rounds, so every
    rank decides identically — the same complete-round rule the per-op
    protocol lives by)::

        pending --[unanimous clean beat]--> active
        active  --[failure flag in a beat]--> revoked   (abort + bump)
        active  --[drop flag in a beat]--> revoked      (no abort/bump:
                 the fleet-wide release request_release() votes)
        revoked --[rearm clean beats]--> active
        any     --[revoke_local]--> revoked             (no round; see below)

    While ACTIVE, :func:`coordinated_call` ops that opted in
    (``lease=``) skip the per-op vote entirely; the beat that the step
    loop already pays (:class:`Heartbeat`, which must run ``every=1`` —
    the beat IS the aggregate vote) carries this rank's lease state:
    ``want`` + current generation + the count of covered ops + a
    failure flag when a covered op failed since the last beat.  A flag
    from ANY rank revokes the lease on every rank in that same round,
    bumps the shared generation everywhere (equal-generations
    preserved), and raises :class:`CoordinatedAbortError` — covered
    ops are never re-issued (no-double-apply: an optimistically
    advanced peer may already have applied them), and subsequent ops
    fall back to per-op voting until ``rearm`` clean beats re-activate.

    Activation is a unanimous handshake: a beat from a rank carrying NO
    lease state (it never opted in) raises :class:`LeaseConfigError` at
    the first beat — a mixed world must fail fast, not hang its per-op
    voters against peers that never join a round.

    :meth:`revoke_local` drops the lease WITHOUT a round — legal only
    where the surrounding protocol restores cross-rank symmetry: an
    elastic resize (every survivor resizes together and re-arms via
    the handshake) or a maintenance drain (the rank issues no further
    coordinated ops).  A rank that may KEEP TRAINING — a preemption
    autosave fired on a notice it survives — uses
    :meth:`request_release` instead: it keeps skipping votes (staying
    symmetric) until the next beat carries its drop flag and the whole
    fleet deactivates together.

    Thread-safety: the state is shared between the step thread (op
    bookkeeping, beats) and the maintenance-poller/preemption paths
    (:meth:`revoke_local`); every access rides ``_lock``.

    ``_sim`` is the model checker's seam (``analysis.modelcheck``): its
    scheduler installs itself there so the lease's transitions become
    schedule points.  Production never sets it."""

    def __init__(self, heartbeat=None, gen=None, rearm=None):
        # RLock, not Lock: request_release() is reached from the
        # SIGTERM handler (PreemptionHandler.fire), which runs on the
        # MAIN thread between bytecodes — a plain Lock would deadlock
        # when the signal lands while that same thread is inside
        # note_op()'s locked region (once per covered op on the hot
        # path; same rule as profiler._rec_lock)
        self._lock = threading.RLock()
        # one dict so the dynamic race harness can instrument the whole
        # shared state as a single named variable (racecheck.py)
        self._s = {"state": "pending", "ops": 0, "clean": 0,
                   "failure": None, "drop": None}
        self._hb = heartbeat
        self._gen = gen
        self.rearm = max(1, int(os.environ.get(
            "MXNET_FAULT_LEASE_REARM", "1")) if rearm is None
            else int(rearm))
        self._local_error = None
        self._sim = None  # the model checker's seam; None in production

    @property
    def gen(self):
        # resolved lazily: the shared Generation may not exist yet at
        # construction (pre-bootstrap), and minting one here would
        # split the job's recovery epochs
        if self._gen is None:
            self._gen = generation()
        return self._gen

    def _heartbeat(self):
        return self._hb if self._hb is not None \
            else _fault._DIST_HEARTBEAT

    def _point(self, kind, detail=""):
        sim = self._sim
        if sim is not None:
            sim.point(kind, obj=("lease", id(self)), write=True,
                      detail=detail)

    def active(self):
        with self._lock:
            return self._s["state"] == "active"

    def state(self):
        with self._lock:
            return self._s["state"]

    def note_op(self, op=None):
        """Record one successfully applied op under the lease (covered
        by the next beat's aggregate vote).  Deliberately minimal —
        this IS the whole per-op cost of the amortized success path —
        so the ``fault::dist::lease_ops`` counter is bumped in batch at
        beat time, not here."""
        with self._lock:
            self._s["ops"] += 1

    def payload(self):
        """This rank's lease state for the beat payload (JSON-safe).
        Reports the window's op count but does NOT consume it — the
        counter batch lands in :meth:`_consume_ops` only after the
        round COMPLETED, so a beat that fails mid-allgather cannot
        double-count the same window on the next beat."""
        with self._lock:
            fail = self._s["failure"]
            drop = self._s["drop"]
            ops = self._s["ops"]
        return {"want": True, "gen": self.gen.value, "ops": ops,
                "drop": drop,
                "fail": dict(fail) if fail else None}

    def _consume_ops(self):
        """Zero the covered-op window and batch it into
        ``fault::dist::lease_ops`` — called only from the completed-
        round beat paths (this is the whole reason :meth:`note_op` can
        stay a bare locked increment)."""
        with self._lock:
            ops, self._s["ops"] = self._s["ops"], 0
        if ops:
            _profiler.counter_bump("fault::dist::lease_ops", ops,
                                   cat="fault")

    def _revoke_locked(self, failure=None, clear_drop=False):
        """The one locked revoked-transition (revoke_local, escalate,
        and on_beat all route here so the field handling cannot drift);
        returns the previous state.  The covered-op window is left
        alone — only a completed beat round consumes it
        (:meth:`_consume_ops`)."""
        with self._lock:
            was = self._s["state"]
            self._s["state"] = "revoked"
            self._s["clean"] = 0
            self._s["failure"] = failure
            if clear_drop:
                self._s["drop"] = None
            return was

    def revoke_local(self, reason="local"):
        """Drop to per-op voting IMMEDIATELY, without a round.  Only
        legal where the surrounding protocol restores symmetry on its
        own — the elastic resize (every survivor enters it together
        and the new world re-arms via the handshake) and the
        maintenance drain (this rank issues no further coordinated
        ops).  A rank that may keep training must use
        :meth:`request_release` instead: an asymmetric local revoke
        leaves this rank voting per-op against peers that still hold
        the lease and never join the round."""
        was = self._revoke_locked(clear_drop=True)
        if was != "revoked":
            _profiler.counter_bump("fault::dist::lease_revocations", 1,
                                   cat="fault")
            _flightrec.record("lease.revoke", how="local",
                              reason=str(reason))
            log.warning("step lease revoked (%s) — coordinated ops "
                        "escalate to per-op voting", reason)

    def request_release(self, reason="release"):
        """Ask the FLEET to drop the lease at the next beat — the safe
        revocation for a rank that may SURVIVE (a preemption autosave
        fired on a live-migration notice, a manual fire): this rank
        keeps skipping per-op votes — staying symmetric with its peers
        — until the beat carries its drop flag, where every rank
        (itself included) deactivates together: no abort, no
        generation bump, per-op voting until the re-arm handshake.  A
        rank that dies before that beat is the plain dead-peer case
        (peers time out at their next beat)."""
        with self._lock:
            if self._s["state"] != "active":
                return
            already = self._s["drop"]
            if not already:
                self._s["drop"] = str(reason)
        if not already:
            log.warning("step lease release requested (%s) — the fleet "
                        "drops the lease at the next beat", reason)

    def escalate(self, op=None, error=None, entry=False):
        """A covered op failed locally: revoke, then vote the failure
        through the step-boundary beat NOW (this rank's beat for the
        aborted step, one round early; peers join at their natural
        boundary) so every rank aborts in the same round.  Always
        raises — :class:`CoordinatedAbortError` from the beat (local
        error chained), or the beat's own :class:`PeerLostError`."""
        was = self._revoke_locked(failure={
            "op": str(op) if op is not None else None,
            "entry": bool(entry),
            "error": "%s: %s" % (type(error).__name__, error)})
        with self._lock:
            self._local_error = error
        if was != "revoked":
            _profiler.counter_bump("fault::dist::lease_revocations", 1,
                                   cat="fault")
        self._point("lease.revoke", "local failure on op %s" % op)
        _flightrec.record("lease.escalate",
                          op=str(op) if op is not None else None,
                          gen=self.gen.value)
        hb = self._heartbeat()
        if hb is None:
            raise CoordinatedAbortError(
                "step lease revoked by a local failure on op %s with no "
                "heartbeat to escalate over — peers discover via their "
                "own beat timeouts" % op) from error
        # the escalation beat fires MID-step, but peers only join at
        # their natural step boundary — legitimately up to a full step
        # of compute away.  The boundary-calibrated heartbeat timeout
        # would misname those live ranks as lost (the
        # "unrealistic deadline" class), so this one round gets its own
        # deadline; set it above the longest step wall time.
        hb.beat(step=None, _force=True,
                _timeout=_lease_escalation_timeout())  # our flag: raises
        raise CoordinatedAbortError(
            "step lease revoked by a local failure on op %s but the "
            "escalation beat did not abort — aborting locally" % op) \
            from error

    def on_beat(self, votes):
        """Process one complete beat round (called by
        :meth:`Heartbeat.beat` after the allgather).  May raise
        :class:`LeaseConfigError` (a peer never opted in),
        :class:`CoordinatedAbortError` (a failure flag — the lease
        revocation), or :class:`GenerationMismatchError`."""
        missing = sorted(v.get("rank", -1) for v in votes
                         if "lease" not in v)
        if missing:
            # revoke BEFORE raising (same rule as the gen-mismatch
            # branch below): a supervisor that catches this and keeps
            # stepping must not leave the zero-vote fast lane open
            # against peers that vote per-op
            self._revoke_locked(clear_drop=True)
            raise LeaseConfigError(
                "step-lease mode is enabled on this rank but process(es) "
                "%s beat WITHOUT lease state — every rank must enable "
                "the lease (enable_step_lease / MXNET_FAULT_LEASE=1) or "
                "none may; a mixed world would hang its per-op voters "
                "at the first failure" % missing)
        flags = {v["rank"]: v["lease"]["fail"] for v in votes
                 if v["lease"].get("fail")}
        with self._lock:
            local = self._s["failure"]
        if flags:
            if _TEST_MUTATIONS and "skip_lease_revoke" in _TEST_MUTATIONS \
                    and local is None:
                # the mutation: a rank that sees a PEER's failure flag
                # keeps its lease and reports its step successful
                return votes
            self._consume_ops()
            self._revoke_locked(clear_drop=True)
            with self._lock:
                err, self._local_error = self._local_error, None
            self.gen.bump()  # every rank, from the same complete round
            if local is None:
                # the escalating rank already counted its revocation
                _profiler.counter_bump("fault::dist::lease_revocations",
                                       1, cat="fault")
            self._point("lease.revoke",
                        "flags from rank(s) %s" % sorted(flags))
            _flightrec.record("lease.revoke", how="flags",
                              ranks=tuple(sorted(flags)),
                              gen=self.gen.value)
            detail = "; ".join(
                "rank %d: %s on op %s" % (r, f.get("error"), f.get("op"))
                for r, f in sorted(flags.items()))
            raise CoordinatedAbortError(
                "step lease revoked: op failure on process(es) %s since "
                "the last beat (%s) — aborting the step on every worker; "
                "coordinated ops escalate to per-op voting until the "
                "lease re-arms" % (sorted(flags), detail)) from err
        drops = {v["rank"]: v["lease"].get("drop") for v in votes
                 if v["lease"].get("drop")}
        if drops:
            # a peer (or this rank) asked the fleet to release the
            # lease — a preemption autosave it may survive, a manual
            # fire.  Everyone deactivates from this same round: no
            # abort, no generation bump, per-op voting until the
            # re-arm handshake.
            self._consume_ops()
            was = self._revoke_locked(clear_drop=True)
            if was != "revoked":
                _profiler.counter_bump("fault::dist::lease_revocations",
                                       1, cat="fault")
            self._point("lease.revoke",
                        "release requested by rank(s) %s" % sorted(drops))
            _flightrec.record("lease.release",
                              ranks=tuple(sorted(drops)))
            log.warning("step lease released (requested by rank(s) %s: "
                        "%s) — coordinated ops escalate to per-op "
                        "voting", sorted(drops),
                        "; ".join(str(r) for r in drops.values()))
            return votes
        gens = set(v["lease"]["gen"] for v in votes)
        if len(gens) > 1:
            # revoke BEFORE raising: a caller that catches this beat
            # error and keeps stepping must not keep the zero-vote fast
            # lane open across a detected divergence — per-op voting's
            # own gen check re-raises on every subsequent op instead
            self._revoke_locked(clear_drop=True)
            raise GenerationMismatchError(
                "step-lease beat saw generations %s — workers diverged"
                % sorted(gens))
        self._consume_ops()
        activated = False
        with self._lock:
            st = self._s["state"]
            if st in ("pending", "revoked"):
                self._s["clean"] += 1
                need = 1 if st == "pending" else self.rearm
                if self._s["clean"] >= need:
                    self._s["state"] = "active"
                    activated = True
        if activated:
            _profiler.counter_bump("fault::dist::lease_activations", 1,
                                   cat="fault")
            self._point("lease.activate", "gen %d" % min(gens))
            _flightrec.record("lease.activate", gen=min(gens))
            log.info("step lease ACTIVE at generation %d — coordinated "
                     "ops skip per-op voting until a failure is flagged",
                     min(gens))
        return votes


def step_lease():
    """The installed process-wide :class:`StepLease` (or None)."""
    return _fault._step_lease()


def enable_step_lease(comm=None, timeout=None, rearm=None, heartbeat=None):
    """Arm step-granularity consensus: install (or reuse) the step
    heartbeat and attach a :class:`StepLease` that the seam callers
    (dist KVStore ops, ring attention, pipeline) ride via
    ``coordinated_call(..., lease=True)``.  Must be called on EVERY
    rank (SPMD) — the lease only activates after a unanimous handshake
    beat, and a rank that never opts in hard-fails its peers' first
    beat (:class:`LeaseConfigError`) instead of hanging them later.

    The heartbeat must beat every step (``every=1``): the beat IS the
    aggregate vote, and a skipped beat would leave covered ops without
    a round."""
    hb = heartbeat if heartbeat is not None else _fault._DIST_HEARTBEAT
    install_hb = False
    if hb is None:
        # construct directly, NOT via enable_step_heartbeat: its
        # MXNET_FAULT_LEASE auto-attach would re-enter here and build a
        # second, briefly-installed lease; the heartbeat is installed
        # below only after the lease attached cleanly
        hb = Heartbeat(comm=comm, every=1, timeout=timeout)
        install_hb = True
    if hb.every != 1:
        raise ValueError(
            "step-lease mode needs the heartbeat at EVERY step "
            "(every=1): the beat is the aggregate vote covering the "
            "step's ops — got every=%d" % hb.every)
    lease = StepLease(heartbeat=hb, rearm=rearm)
    hb.lease = lease
    hb._lease_detached = False
    _fault._set_step_lease(lease)
    if install_hb:
        _fault._DIST_HEARTBEAT = hb
    return lease


def disable_step_lease():
    """Detach the process-wide step lease.  SPMD-uniform like
    :func:`enable_step_lease`: every rank must disable in the same
    beat window.  A one-sided mid-run disable fails fast on BOTH
    sides' next beat — the still-leased peers raise
    :class:`LeaseConfigError` naming the disabled rank (the missing-
    state check), and the disabled rank raises it naming itself (the
    detach tombstone) instead of hanging its next per-op vote into a
    slow :class:`PeerLostError`."""
    lease = _fault._step_lease()
    _fault._set_step_lease(None)
    # detach from the heartbeat that actually CARRIES the lease: an
    # explicitly-passed heartbeat (enable_step_lease(heartbeat=...))
    # is not _DIST_HEARTBEAT, and leaving hb.lease attached would keep
    # peers vote-skipping against this rank with no tombstone — the
    # slow-PeerLostError hang this function exists to prevent
    carriers = []
    if lease is not None and getattr(lease, "_hb", None) is not None:
        carriers.append(lease._hb)
    ambient = _fault._DIST_HEARTBEAT
    if ambient is not None and all(ambient is not c for c in carriers):
        carriers.append(ambient)
    for hb in carriers:
        if getattr(hb, "lease", None) is lease:
            hb.lease = None
            if lease is not None:
                hb._lease_detached = True


def _lease_env_enabled():
    return os.environ.get("MXNET_FAULT_LEASE", "0") not in (
        "", "0", "false", "False")


def _lease_escalation_timeout():
    """Deadline for the ESCALATION beat only: unlike boundary beats
    (which every rank starts together, so the heartbeat timeout fits),
    the escalating rank fires mid-step and its peers join up to a full
    step of compute later.  Must exceed the longest step wall time."""
    return float(os.environ.get("MXNET_FAULT_LEASE_ESCALATION_TIMEOUT",
                                "300"))


# ----------------------------------------------------------------------
# peer health: step-boundary heartbeat
# ----------------------------------------------------------------------
class Heartbeat:
    """Liveness allgather at step boundaries.  ``beat()`` fires every
    ``every``-th call: each worker contributes ``(rank, step, time)``;
    a peer that stays silent past ``timeout`` seconds raises
    :class:`PeerLostError` naming its ``process_index`` — turning the
    classic "job frozen for 6 hours" stall into an actionable error.
    The armed ``peer_hang`` fault delays THIS worker's vote past the
    timeout, so its peers exercise the detection path.

    With a :class:`StepLease` attached (``lease``), each beat also
    carries this rank's lease state and processes the round's aggregate
    vote (:meth:`StepLease.on_beat`) — the beat IS the per-step
    consensus round that lets the success path skip per-op voting."""

    _comm_epoch = 0  # per-process heartbeat-comm epoch (see .comm)

    def __init__(self, comm=None, every=None, timeout=None, lease=None,
                 telemetry=None):
        env = os.environ
        self._comm = comm
        self.every = int(env.get("MXNET_FAULT_HEARTBEAT_EVERY", "1")) \
            if every is None else int(every)
        self.timeout = float(env.get("MXNET_FAULT_HEARTBEAT_TIMEOUT",
                                     "30")) if timeout is None \
            else float(timeout)
        self.lease = lease
        # an attached mx.telemetry.TelemetrySession rides the same
        # allgather (payload()/on_beat(), duck-typed like the lease):
        # fleet metric aggregation at ZERO extra comm rounds
        self.telemetry = telemetry
        # an attached elastic grow watch (fault_elastic._JoinWatch,
        # duck-typed the same way): each beat carries the join jids
        # this rank saw pending on the vote board, and a completed
        # round where ANY rank saw one raises JoinRequestedError on
        # every rank — the fleet-symmetric grow trigger
        self.elastic = None
        self.beats = 0
        self.peers = {}  # rank -> last seen (step, time)
        self._calls = 0
        # set by disable_step_lease(): this heartbeat HAD a lease that
        # was detached mid-run.  The next beat checks the peers — a
        # one-sided disable must fail fast (LeaseConfigError naming
        # this rank), not surface as a slow PeerLostError when this
        # rank's per-op votes hang against peers still skipping them
        self._lease_detached = False

    @property
    def comm(self):
        # resolved per beat, not frozen at construction: a heartbeat
        # enabled before the bootstrap must pick up the
        # multi-process comm once the job is up
        if self._comm is not None:
            return self._comm
        ambient = default_comm()
        if isinstance(ambient, CoordServiceComm):
            # never share the cached default's round space: a beat and a
            # coordinated_call consuming the same rounds would cross-read
            # each other's payloads (opaque KeyError, skewed rounds).
            # The namespace carries a heartbeat-scoped epoch — not the
            # global construction sequence, so it lines up across ranks
            # however late each rank first beats relative to its other
            # comms; and not a fixed name, so a re-enabled heartbeat
            # cannot collide with the previous incarnation's used
            # barriers and GC'd keys.  Ranks must enable/disable
            # heartbeats the same number of times (the usual SPMD shape).
            self._comm = CoordServiceComm(
                namespace="mxhb%d" % Heartbeat._comm_epoch)
            Heartbeat._comm_epoch += 1
            return self._comm
        return ambient

    def beat(self, step=None, _force=False, _timeout=None):
        """One step boundary; returns the vote list when a heartbeat
        round ran, else None.  ``_force`` runs a round regardless of
        ``every`` — the lease escalation path, where the failing rank
        must vote its flag NOW (with a lease attached ``every`` is
        pinned to 1, so forcing never skews the round counts).
        ``_timeout`` overrides this one round's deadline — the
        escalation round waits for peers a full step of compute away,
        not just the boundary-aligned heartbeat window."""
        self._calls += 1
        if not _force and self.every > 1 and self._calls % self.every:
            return None
        comm = self.comm
        if isinstance(comm, LocalComm):
            return None
        for f in _fault.check("heartbeat", op="beat"):
            if f.kind == "peer_hang":
                # injected peer hang: this worker goes silent past the
                # peers' timeout (they raise PeerLostError naming us),
                # then votes — the persistent-vote comms keep rounds
                # aligned afterwards.  Proportional margin: each peer's
                # deadline starts at ITS allgather entry, which can lag
                # ours by scheduling skew — a few poll intervals of
                # slack would make the seeded chaos check flaky on a
                # loaded machine
                time.sleep(self.timeout * 1.5
                           + 4 * getattr(comm, "poll", 0.05))
        payload = {"rank": comm.rank,
                   "step": -1 if step is None else int(step),
                   "t": time.time()}
        lease = self.lease
        if lease is not None:
            payload["lease"] = lease.payload()
        telemetry = self.telemetry
        if telemetry is not None:
            payload["telemetry"] = telemetry.payload()
        elastic = self.elastic
        if elastic is not None:
            payload["elastic"] = elastic.payload()
        try:
            votes = comm.allgather(
                payload,
                timeout=self.timeout if _timeout is None else _timeout)
        except PeerLostError:
            _profiler.counter_bump("fault::dist::peer_lost", 1, cat="fault")
            raise
        self.beats += 1
        _profiler.counter_bump("fault::dist::heartbeats", 1, cat="fault")
        # the postmortem anchor event: (step, round) is shared across
        # the fleet by construction — wall clocks are not
        _flightrec.record("hb.beat", step=payload["step"],
                          round=getattr(comm, "_round", None),
                          rank=comm.rank, world=len(votes))
        for v in votes:
            self.peers[v["rank"]] = (v["step"], v["t"])
        if telemetry is not None:
            # before the lease vote: a revocation raise must not lose
            # the completed round's FleetView (on_beat never raises)
            telemetry.on_beat(votes)
        if lease is None and self._lease_detached:
            # the disable side of the SPMD-uniform rule (the enable
            # side is on_beat's missing-state check): this rank
            # disabled its lease mid-run — if any peer still carries
            # lease state, the worlds have diverged and this rank's
            # next per-op vote would hang against peers that skip
            # votes.  Fail THIS beat instead, naming the rank that
            # one-sided the disable.
            carriers = sorted(v["rank"] for v in votes
                              if isinstance(v.get("lease"), dict)
                              and v["lease"].get("want"))
            if carriers:
                raise LeaseConfigError(
                    "step lease was disabled mid-run on this process "
                    "(rank %d) while process(es) %s still carry lease "
                    "state — disable_step_lease must be SPMD-uniform "
                    "(every rank disables at the same step), or the "
                    "disabled rank's per-op votes would hang against "
                    "peers still skipping them"
                    % (comm.rank, carriers))
            # every rank disabled in the same window: uniform, clear
            self._lease_detached = False
        if lease is not None:
            # the per-step aggregate vote: renews the lease, runs the
            # activation handshake, or — on any failure flag — revokes
            # it on every rank in this same round and raises
            lease.on_beat(votes)
        if elastic is not None:
            # after the lease: a grow only proceeds from an otherwise
            # clean round (a revocation outranks a join request — the
            # join record stays pending and triggers the next epoch)
            elastic.on_beat(votes)
        return votes


def enable_step_heartbeat(comm=None, every=None, timeout=None):
    """Install a process-wide :class:`Heartbeat` that ``Trainer.step``
    and ``parallel.TrainStep`` beat at every step boundary (via the
    ``mx.fault`` hook, so the single-process fast path stays one
    attribute check).  With ``MXNET_FAULT_LEASE=1`` a :class:`StepLease`
    is attached too (step-granularity consensus; requires ``every=1``)."""
    hb = Heartbeat(comm=comm, every=every, timeout=timeout)
    # lease first: its every=1 validation must reject a misconfigured
    # MXNET_FAULT_LEASE + MXNET_FAULT_HEARTBEAT_EVERY combination
    # BEFORE anything global is installed (a raise here leaves no
    # partial heartbeat behind)
    if _lease_env_enabled():
        enable_step_lease(heartbeat=hb)
    _fault._DIST_HEARTBEAT = hb
    return hb


def disable_step_heartbeat():
    hb = _fault._DIST_HEARTBEAT
    if hb is not None and getattr(hb, "lease", None) is not None \
            and _fault._step_lease() is hb.lease:
        disable_step_lease()
    _fault._DIST_HEARTBEAT = None


# ----------------------------------------------------------------------
# instance maintenance notices -> preemption autosave
# ----------------------------------------------------------------------
GCE_MAINTENANCE_URL = ("http://metadata.google.internal/computeMetadata"
                       "/v1/instance/maintenance-event")
#: metadata values that mean "this host is about to go away"
TERMINAL_EVENTS = ("TERMINATE", "TERMINATE_ON_HOST_MAINTENANCE",
                   "MIGRATE_ON_HOST_MAINTENANCE", "STOP", "PREEMPTED")


class MaintenancePoller:
    """Poll the instance-metadata maintenance endpoint and fire the
    ``mx.fault`` preemption autosave *before* SIGTERM arrives (GCE gives
    ~60s of notice; the signal often much less).  ``on_event`` overrides
    the default action (snapshot via the installed
    :class:`~mxnet_tpu_torch.fault.PreemptionHandler`).  The endpoint is
    mockable via ``MXNET_FAULT_METADATA_URL`` (tests run a stub HTTP
    server); the armed ``maintenance_event`` fault short-circuits the
    HTTP fetch entirely."""

    def __init__(self, url=None, interval=None, on_event=None,
                 http_timeout=2.0):
        env = os.environ
        self.url = url or env.get("MXNET_FAULT_METADATA_URL",
                                  GCE_MAINTENANCE_URL)
        self.interval = float(env.get("MXNET_FAULT_MAINTENANCE_POLL",
                                      "1.0")) if interval is None \
            else float(interval)
        self.on_event = on_event
        self.http_timeout = http_timeout
        self.events = 0
        self.last_event = None
        #: latched while a terminal notice is pending — consumers that
        #: want to DRAIN at a safe boundary (mx.fault.elastic) poll
        #: ``pending()`` at step edges instead of racing the signal
        self.notice = threading.Event()
        self._notified = False  # one autosave per pending event
        self._stop = threading.Event()
        self._thread = None

    def pending(self):
        """The pending terminal-event string, or None — latched from
        the poll thread so a step loop can check it without an HTTP
        round-trip."""
        return self.last_event if self.notice.is_set() else None

    def poll_once(self):
        """One poll: the current maintenance-event string, or None when
        the metadata server is unreachable (not on GCE — the poller
        stays quiet rather than crashing the job)."""
        if _fault._ACTIVE and _fault.check("maintenance", op="poll"):
            return "TERMINATE_ON_HOST_MAINTENANCE"
        import urllib.request
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.http_timeout) as r:
                return r.read().decode("utf-8", "replace").strip()
        except OSError:
            return None

    def tick(self):
        """Poll and act: a terminal event fires the autosave once; the
        notice clearing back to NONE re-arms.  Returns the event string
        that fired, else None."""
        ev = self.poll_once()
        if ev is None:
            # unreachable metadata server: no information — keep the
            # current arm state (a blip mid-notice must not re-fire a
            # full snapshot every poll)
            return None
        if ev == "NONE" or not ev:
            self._notified = False
            self.notice.clear()
            return None
        if not any(ev.startswith(t) for t in TERMINAL_EVENTS):
            return None
        if self._notified:
            return None
        self._notified = True
        self.last_event = ev
        self.notice.set()
        self.events += 1
        _profiler.counter_bump("fault::dist::maintenance_events", 1,
                               cat="fault")
        log.warning("maintenance notice %r — firing preemption autosave",
                    ev)
        if self.on_event is not None:
            self.on_event(ev)
        else:
            handler = _fault.preempt_handler()
            if handler is not None:
                handler.fire(reason="maintenance:%s" % ev)
        return ev

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except (CoordinatedAbortError, PeerLostError,
                    GenerationMismatchError):
                # tick() can run user on_event hooks / the preemption
                # autosave; "surviving" a coordination abort there would
                # leave this rank polling while its peers stopped —
                # stop the poller and let the thread die loudly instead
                log.exception("maintenance poll hit a coordination "
                              "abort; stopping poller")
                self._stop.set()
                raise
            except Exception:  # noqa: BLE001 — the poller must survive
                log.exception("maintenance poll failed")
            self._stop.wait(self.interval)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="mx-fault-maintenance-poller")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def watch_maintenance(url=None, interval=None, on_event=None):
    """Start (and return) a :class:`MaintenancePoller` — typically right
    after ``mx.fault.on_preemption(...)`` so the notice feeds the same
    snapshot path the signal would."""
    return MaintenancePoller(url=url, interval=interval,
                             on_event=on_event).start()


def _flightrec_dist_context():
    """Dump-time context provider (mx.flightrec): the recovery epoch
    and step-lease state the rank died holding.  Runs OUTSIDE the
    recorder lock; reads its own subsystem locks like any caller."""
    with _ambient_lock:
        gen = None if _generation is None else _generation.value
    out = {"generation": gen}
    lease = _fault._step_lease()
    if lease is not None:
        out["lease_state"] = lease.state()
    return out


_flightrec.provide("dist", _flightrec_dist_context)
