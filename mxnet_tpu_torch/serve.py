"""serve -- continuous-batching decode runtime over ``TransformerLM``.

Counterpart of ``mxnet_tpu/serve.py``, on PyTorch and the port's CUDA
kernels.  Three layers, as there:

1. **Incremental decode** (``models.kv_cache`` + the model's
   ``forward(tokens, cache=...)``): a paged KV cache over fixed batch
   slots x a page budget, so one decode step is O(1) in generated
   length.  Prefill runs the flash kernel, decode the paged kernel.
2. **Continuous batching** (:class:`SlotScheduler` + :class:`Server`):
   new requests join the running batch at any step, finished requests
   free their pages at once, a refcounted radix prefix cache shares the
   KV pages of common prompt prefixes (copy-on-write where a write would
   land in a shared page), and every slot assignment carries an epoch so
   a result computed for a slot's previous occupant is dropped.
3. **Warm pool** (:class:`WarmPool`): parameters, their int8 copies
   (``ServeConfig(int8=True)``) and the KV pools live on the device for
   the replica's lifetime; the decode step, one prefill per ladder rung
   and one chunk prefill per rung are programs fixed at start-up -- on
   the card CUDA graphs, captured once and replayed with no per-op host
   dispatch (the JAX package's AOT-compiled programs); the COW page copy
   is one eager indexed copy.  PyTorch keeps no compile cache, so there
   is no ``cache_dir``.

Sampling runs inside the programs: every slot carries (seed, step,
temperature, top_k, top_p) as device tensors, and the noise for a token
is a counter-based hash of (seed, step, rank) in tensor ops, ``step`` =
tokens generated so far, so the same seed gives the same tokens, a
batched slot samples exactly as it would alone, and a preempted request
resumes at the same step indices.  ``temperature <= 0`` is the argmax.
The streams are the port's own: no RNG matches across packages.

The int8 path (``quantize_weights``, per-tensor minmax, as the JAX
package's): the decode's products read int8 weights from HBM through
the W8A16 kernel (``ops.int8``), the prefill and chunk programs
dequantize each weight into a transient and run one plain product.

Tensor parallelism (``Server(net, cfg, mesh=)``): every rank of the
mesh builds the same server over its shard of the weights and KV heads;
the leader schedules and sends each program's step plan to the
followers (:class:`Server`, :class:`WarmPool`).  Under NCCL the
collectives are captured inside the graphs; under gloo the programs run
eagerly.

The control plane, as the reference's: every scheduler transaction is
a flight-recorder event (``flightrec``) and bumps its ``serve::*``
counter (``telemetry.bump``); a terminal request feeds the replica's
:class:`~mxnet_tpu_torch.telemetry.ServeSLO` (``Server.slo``,
``slo_snapshot``); ``attach_telemetry`` registers the load gauges and
``attach_elastic`` drains the slots on a resize (``preempt_all``).  The
chaos seams ``fault.serve_engine_check`` (top of ``engine_step``) and
``fault.serve_decode_check`` (the decode commit) fire on the engine
thread; a transient decode failure (``fault_dist.classify_xla_error``)
drops the step, bumps ``serve::decode_retries`` and commits nothing, so
the next iteration replays the same step and the tokens are those of a
fault-free run; a fatal one kills the engine, and ``result`` re-raises.
All of it is host Python around the program replays.

Not ported: ``lower_decode_program`` (an XLA HLO seam, with no PyTorch
counterpart).

Knobs (environment, all optional)::

    MXNET_SERVE_SLOTS        batch slots                     (8)
    MXNET_SERVE_PAGE_SIZE    tokens per KV page              (128)
    MXNET_SERVE_PAGES        page-pool budget incl. trash    (64)
    MXNET_SERVE_LADDER       prefill pad lengths, csv        (64,128,256)
    MXNET_SERVE_MAX_NEW      default per-request output cap  (64)
    MXNET_SERVE_INT8         int8 weight path                (0)
    MXNET_SERVE_TEMP         default sampling temperature    (0 = greedy)
    MXNET_SERVE_TOP_K        default top-k cutoff            (0 = off)
    MXNET_SERVE_TOP_P        default nucleus mass            (1.0 = off)
    MXNET_SERVE_PREFIX_CACHE refcounted prompt-prefix reuse  (1)
    MXNET_SERVE_DEADLINE_MS  default per-request deadline, ms (0 = off)
"""
from __future__ import annotations

import functools
import logging
import os
import threading
import time

import numpy as onp
import torch
import torch.distributed as dist

from . import fault as _fault
from . import fault_dist as _fault_dist
from . import flightrec as _flightrec
from . import telemetry as _telemetry
from .contrib.quantization import Int8Weight, _minmax_scale, int8_weights
from .gluon.nn import Dense
from .models.kv_cache import (TRASH_PAGE, CacheSpec, CacheView, init_pools,
                              local_kv_heads)
from .ops.cuda_ops import capture_graph, replay_graph
from .ops.int8 import dequantize
from .parallel import _compat
from .parallel.sharding import placement, shard_params

log = logging.getLogger("mxnet_tpu_torch.serve")

__all__ = ["ServeConfig", "SlotScheduler", "WarmPool", "Server",
           "DeadlineExceededError", "OverloadedError", "quantize_weights"]


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before it finished: it was
    cancelled *through* the scheduler (pages and radix refcounts
    released), and :meth:`Server.result` raises this instead of
    hanging."""


class OverloadedError(RuntimeError):
    """The admission queue is full and the shed policy rejected this
    request (``serve_router.ReplicaGroup``): the typed backpressure
    signal that keeps admitted-request p99 bounded."""


def _env_int(name, default):
    return int(os.environ.get(name, str(default)))


def _env_on(name, default):
    return os.environ.get(name, default) not in ("", "0", "false", "False")


def _norm_sampling(sampling, rid):
    """Normalize a per-request sampling dict against greedy defaults.
    The seed defaults to the rid so distinct requests in one batch
    decorrelate even when the client never thinks about seeds."""
    sp = dict(sampling or {})
    return {"seed": int(sp.get("seed", rid)),
            "temperature": float(sp.get("temperature", 0.0)),
            "top_k": int(sp.get("top_k", 0)),
            "top_p": float(sp.get("top_p", 1.0))}


class ServeConfig:
    """Serving-replica shape: batch slots x page budget x prefill
    ladder.  Fixed at startup."""

    def __init__(self, slots=None, page_size=None, pages=None,
                 ladder=None, max_new=None, eos_id=None, int8=None,
                 temperature=None, top_k=None, top_p=None,
                 prefix_cache=None, deadline_ms=None):
        env = os.environ
        self.slots = _env_int("MXNET_SERVE_SLOTS", 8) if slots is None \
            else int(slots)
        self.page_size = _env_int("MXNET_SERVE_PAGE_SIZE", 128) \
            if page_size is None else int(page_size)
        self.pages = _env_int("MXNET_SERVE_PAGES", 64) if pages is None \
            else int(pages)
        if ladder is None:
            ladder = tuple(int(t) for t in env.get(
                "MXNET_SERVE_LADDER", "64,128,256").split(",") if t)
        self.ladder = tuple(sorted(set(int(t) for t in ladder)))
        self.max_new = _env_int("MXNET_SERVE_MAX_NEW", 64) \
            if max_new is None else int(max_new)
        self.eos_id = eos_id
        self.int8 = _env_on("MXNET_SERVE_INT8", "0") if int8 is None \
            else bool(int8)
        self.temperature = float(env.get("MXNET_SERVE_TEMP", "0")) \
            if temperature is None else float(temperature)
        self.top_k = _env_int("MXNET_SERVE_TOP_K", 0) if top_k is None \
            else int(top_k)
        self.top_p = float(env.get("MXNET_SERVE_TOP_P", "1.0")) \
            if top_p is None else float(top_p)
        self.prefix_cache = _env_on("MXNET_SERVE_PREFIX_CACHE", "1") \
            if prefix_cache is None else bool(prefix_cache)
        self.deadline_ms = _env_int("MXNET_SERVE_DEADLINE_MS", 0) \
            if deadline_ms is None else int(deadline_ms)
        self.max_pages_per_slot = -(-(max(self.ladder) + self.max_new)
                                    // self.page_size)

    def default_sampling(self):
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p}

    def default_deadline(self):
        """Replica-default per-request deadline in SECONDS (None when
        the knob is off)."""
        return self.deadline_ms / 1000.0 if self.deadline_ms > 0 \
            else None

    def cache_spec(self, cfg, mesh=None):
        """The pools' spec; on a tensor-parallel ``mesh`` the KV heads
        are this rank's (``kv_cache.local_kv_heads``)."""
        return CacheSpec(
            n_layers=cfg.n_layers,
            n_kv_heads=local_kv_heads(cfg.n_kv_heads, mesh),
            head_dim=cfg.dim // cfg.n_heads, slots=self.slots,
            pages=self.pages, page_size=self.page_size,
            max_pages_per_slot=self.max_pages_per_slot, dtype=cfg.dtype)


# ----------------------------------------------------------------------
# the admission/eviction/preemption state machine (pure host)
# ----------------------------------------------------------------------
class SlotScheduler:
    """Continuous-batching control plane over fixed slots x pages.

    All shared state lives in ONE dict (``_s``) with immutable values,
    every access under ``_lock``.  ``audit`` records allocator-invariant
    breaches (double-allocated or double-freed pages) for
    :meth:`check_conservation`.

    Request lifecycle::

        submit -> waiting -> [admit_next/commit_prefill] -> running
        running -> done        (eos / max_new / context cap)
        running -> waiting     (preempted: pages freed, requeued FRONT)
        any     -> cancelled   (client gone; running slots freed NOW)
    """

    def __init__(self, slots, pages, page_size, max_pages_per_slot,
                 prefix_cache=True, ladder=None):
        self._lock = threading.Lock()
        self.page_size = int(page_size)
        # prefill ladder, when known: partial-extension hits are only
        # taken when they shrink the chunk rung (a few shared tokens that
        # leave the rung unchanged cost a page copy for zero compute
        # saved).  None keeps the unconditional extension.
        self.ladder = tuple(sorted(set(int(t) for t in ladder))) \
            if ladder else None
        self.max_pages_per_slot = int(max_pages_per_slot)
        self.slots = int(slots)
        self.num_pages = int(pages)
        self.prefix_cache = bool(prefix_cache)
        self.audit = []
        self._s = {
            # page 0 is the trash page -- never allocated
            "free_pages": tuple(p for p in range(pages)
                                if p != TRASH_PAGE),
            "free_slots": tuple(range(slots)),
            "queue": (),
            "reqs": {},
            "slots": {},
            "next_rid": 0,
            "next_epoch": 0,
            "preemptions": 0,
            # prefix cache: trie keyed on (parent page, FULL token block)
            # -> (page, depth), plus per-page slot-owner refcounts.  A
            # page in the trie is never in free_pages; refcount 0 means
            # "cached, evictable".
            "prefix": {},
            "refs": {},
            "prefix_hits": 0,
            "prefix_evictions": 0,
        }

    # -- seams ----------------------------------------------------------
    @staticmethod
    def _point(kind, detail=""):
        # every scheduler transaction lands in the flight recorder,
        # called before / outside the locked transaction body
        _flightrec.record(kind, detail=detail)

    def _pages_for(self, tokens):
        return max(1, -(-int(tokens) // self.page_size))

    # -- allocator primitives (called ONLY under _lock) -----------------
    def _alloc(self, s, n):
        free = s["free_pages"]
        if len(free) < n:
            # allocator dry: zero-owner cached prefix pages are the
            # reclaimable reserve -- evict before giving up
            self._evict_prefix(s, n - len(free))
            free = s["free_pages"]
            if len(free) < n:
                return None
        got, rest = free[:n], free[n:]
        owned = [p for sl in s["slots"].values() for p in sl["pages"]]
        for p in got:
            if p in owned:
                self.audit.append("page %d allocated while owned" % p)
        s["free_pages"] = rest
        return got

    def _free(self, s, pages):
        for p in pages:
            if p in s["free_pages"]:
                self.audit.append("page %d freed while free" % p)
        s["free_pages"] = s["free_pages"] + tuple(pages)

    def _evict_prefix(self, s, n):
        """Free up to ``n`` cached prefix pages with ZERO slot owners,
        deepest key first (evicting a deep block never strands a live
        shallower one)."""
        if n <= 0 or not s["prefix"]:
            return
        prefix = dict(s["prefix"])
        refs = dict(s["refs"])
        freed = []
        for key in sorted(prefix, key=lambda k: (-prefix[k][1], k)):
            if len(freed) >= n:
                break
            page = prefix[key][0]
            if refs.get(page, 0) == 0:
                del prefix[key]
                refs.pop(page, None)
                freed.append(page)
        if freed:
            s["prefix"] = prefix
            s["refs"] = refs
            self._free(s, freed)
            s["prefix_evictions"] = s["prefix_evictions"] + len(freed)

    def _release_slot(self, s, slot):
        ent = s["slots"].pop(slot)
        held = set(ent.get("shared", ()))
        if held:
            # drop this slot's refs; the pages stay cached (refcount 0
            # = evictable), they are NOT freed here
            refs = dict(s["refs"])
            for p in held:
                n = refs.get(p, 0) - 1
                if n < 0:
                    self.audit.append("page %d refcount underflow" % p)
                    n = 0
                refs[p] = n
            s["refs"] = refs
        self._free(s, [p for p in ent["pages"] if p not in held])
        s["free_slots"] = s["free_slots"] + (slot,)
        return ent

    def _set_req(self, s, rid, **updates):
        reqs = dict(s["reqs"])
        req = dict(reqs[rid])
        req.update(updates)
        reqs[rid] = req
        s["reqs"] = reqs
        return req

    # -- client side ----------------------------------------------------
    def submit(self, prompt_len, max_new, prompt=None, sampling=None):
        """Enqueue one request; returns its rid (thread-safe).
        ``prompt`` (the token tuple) opts the request into prefix-cache
        sharing; ``sampling`` overrides the greedy defaults per request
        ({seed, temperature, top_k, top_p}; seed defaults to rid)."""
        self._point("sched.submit")
        with self._lock:
            s = self._s
            rid = s["next_rid"]
            s["next_rid"] = rid + 1
            reqs = dict(s["reqs"])
            reqs[rid] = {"rid": rid, "prompt_len": int(prompt_len),
                         "max_new": int(max_new), "state": "waiting",
                         "tokens": (), "slot": None, "epoch": None,
                         "prompt": (None if prompt is None
                                    else tuple(int(t) for t in prompt)),
                         "sampling": _norm_sampling(sampling, rid),
                         "t_submit": time.monotonic(), "t_admit": None,
                         "t_first": None, "t_done": None, "preempts": 0}
            s["reqs"] = reqs
            s["queue"] = s["queue"] + (rid,)
        _telemetry.bump("serve::submitted")
        return rid

    def cancel(self, rid):
        """Drop a request (client disconnect).  A waiting request leaves
        the queue; a running one frees its slot and pages NOW -- an
        in-flight step against it is dropped by the epoch check at
        commit.  Returns True when the request was still live."""
        self._point("sched.cancel", "rid %s" % rid)
        with self._lock:
            s = self._s
            req = s["reqs"].get(rid)
            if req is None or req["state"] in ("done", "cancelled",
                                               "failed"):
                return False  # terminal states stay terminal
            if req["state"] == "waiting":
                s["queue"] = tuple(r for r in s["queue"] if r != rid)
            elif req["state"] == "running":
                s["slots"] = dict(s["slots"])
                self._release_slot(s, req["slot"])
            self._set_req(s, rid, state="cancelled", slot=None,
                          epoch=None, t_done=time.monotonic())
        _telemetry.bump("serve::cancelled")
        return True

    # -- engine side ----------------------------------------------------
    def admit_next(self):
        """Admit the head-of-queue request when a slot and its prompt's
        pages are available; returns the admission plan (the prefill's
        inputs) or None.  Allocation + state flip are ONE transaction --
        the plan's (slot, epoch) identity is what ``commit_prefill``
        later checks against.

        Prefix-cache walk (``prompt`` known): the longest chain of cached
        FULL token blocks, optionally extended by the best partial cover
        from one block deeper.  The plan's ``prefill_start`` is the first
        position the engine must compute; ``cow`` names the (shared src,
        private dst) page pair to copy first when that position lands
        inside a shared page."""
        self._point("sched.admit")
        with self._lock:
            s = self._s
            if not s["queue"] or not s["free_slots"]:
                return None
            rid, need = None, 0
            while s["queue"]:
                rid = s["queue"][0]
                req = s["reqs"][rid]
                # a preempted request re-prefills prompt + tokens so far
                plen = req["prompt_len"] + len(req["tokens"])
                need = self._pages_for(plen)
                if need <= self.max_pages_per_slot:
                    break
                # unservable head: fail it and keep admitting -- it must
                # not head-of-line-block the admissible request behind
                s["queue"] = s["queue"][1:]
                self._set_req(s, rid, state="failed",
                              t_done=time.monotonic())
                rid = None
            if rid is None:
                return None
            psz = self.page_size
            seq = ()
            if self.prefix_cache and req.get("prompt") is not None \
                    and len(req["prompt"]) == req["prompt_len"]:
                seq = req["prompt"] + tuple(req["tokens"])
            chain, ext = [], None
            if seq:
                # radix walk: node key = (parent page, token block)
                prefix = s["prefix"]
                parent = 0  # root sentinel: the trash page id
                while (len(chain) + 1) * psz <= plen:
                    k = len(chain) * psz
                    val = prefix.get((parent, seq[k:k + psz]))
                    if val is None:
                        break
                    chain.append(val[0])
                    parent = val[0]
                m = len(chain)
                rem = seq[m * psz:]
                if rem:
                    # one block deeper: a cached block whose content
                    # partially covers our next block still saves its
                    # prefix positions (COW makes the tail writable)
                    for key, val in prefix.items():
                        if key[0] != parent:
                            continue
                        blk = key[1]
                        lcp = 0
                        while lcp < len(rem) and lcp < psz \
                                and blk[lcp] == rem[lcp]:
                            lcp += 1
                        if lcp and (ext is None or lcp > ext[1]
                                    or (lcp == ext[1]
                                        and key < ext[2])):
                            ext = (val[0], lcp, key)
            if ext is not None and self.ladder is not None:
                # rung-shrink gate: take a partial hit only when the
                # shorter suffix drops to a smaller ladder rung
                def _fit(n):
                    for T_ in self.ladder:
                        if T_ >= n:
                            return T_
                    return None
                c0 = len(chain) * psz
                r0 = _fit(plen - max(0, min(c0, plen - 1)))
                r1 = _fit(plen - max(0, min(c0 + ext[1], plen - 1)))
                if r0 is None or r1 is None or r1 >= r0:
                    ext = None
            shared_chain = chain + ([ext[0]] if ext else [])
            covered = len(chain) * psz + (ext[1] if ext else 0)
            # at least the last prompt position is recomputed -- its
            # logits seed the first generated token
            start = max(0, min(covered, plen - 1))
            b0 = start // psz
            cow = None
            table_head = list(shared_chain)
            if b0 < len(shared_chain):
                # first uncached write lands in a shared page:
                # copy-on-write.  The private copy takes the page's table
                # position; the shared src stays refcounted (so eviction
                # can't free it before the engine's copy).
                table_head = table_head[:b0]
                cow = (shared_chain[b0], None)
            s["slots"] = dict(s["slots"])
            got = self._alloc(s, need - len(table_head))
            if got is None:
                return None
            if cow is not None:
                cow = (cow[0], got[0])
            table = tuple(table_head) + tuple(got)
            held = set(shared_chain)
            if held:
                refs = dict(s["refs"])
                for p in held:
                    refs[p] = refs.get(p, 0) + 1
                s["refs"] = refs
                s["prefix_hits"] = s["prefix_hits"] + 1
            # FULL blocks this prefill completes, publishable into the
            # trie at commit; depth i's parent is this table's page i-1
            insert = tuple((((table[i - 1] if i else 0),
                             seq[i * psz:(i + 1) * psz]), i)
                           for i in range(b0, plen // psz)) if seq \
                else ()
            slot = s["free_slots"][0]
            s["free_slots"] = s["free_slots"][1:]
            s["queue"] = s["queue"][1:]
            epoch = s["next_epoch"]
            s["next_epoch"] = epoch + 1
            s["slots"][slot] = {"rid": rid, "epoch": epoch,
                                "pages": table, "len": plen,
                                "last_tok": None,
                                "shared": tuple(sorted(held))}
            self._set_req(s, rid, state="running", slot=slot,
                          epoch=epoch,
                          t_admit=req.get("t_admit")
                          or time.monotonic())
        _telemetry.bump("serve::admitted")
        return {"rid": rid, "slot": slot, "epoch": epoch,
                "pages": table, "prefill_len": plen,
                "prefill_start": start if seq else 0,
                "shared": tuple(sorted(held)), "cow": cow,
                "insert": insert,
                "sampling": dict(req["sampling"]),
                "ntok": len(req["tokens"])}

    def commit_prefill(self, plan, first_token, done=False):
        """Record the prefill's first generated token.  Epoch-checked:
        a cancel may have freed (and admission reassigned) the slot while
        the prefill was in flight -- a stale commit is dropped."""
        self._point("sched.commit_prefill", "rid %s" % plan["rid"])
        with self._lock:
            s = self._s
            ent = s["slots"].get(plan["slot"])
            if ent is None or ent["epoch"] != plan["epoch"]:
                return None  # reassigned/cancelled mid-prefill: drop
            rid = ent["rid"]
            req = s["reqs"][rid]
            s["slots"] = dict(s["slots"])
            # publish this prefill's freshly-written FULL blocks into the
            # trie; keys another request cached first are skipped.
            # ent["shared"] grows BEFORE the terminal release below so
            # the refcount is decremented exactly once either way.
            if self.prefix_cache and plan.get("insert"):
                prefix, refs = dict(s["prefix"]), dict(s["refs"])
                held = set(ent.get("shared", ()))
                grown = False
                for key, idx in plan["insert"]:
                    page = ent["pages"][idx]
                    if key in prefix or page in held:
                        continue
                    prefix[key] = (page, idx)
                    refs[page] = 1
                    held.add(page)
                    grown = True
                if grown:
                    s["prefix"], s["refs"] = prefix, refs
                    ent = dict(ent, shared=tuple(sorted(held)))
                    s["slots"][plan["slot"]] = ent
            tokens = req["tokens"] + (first_token,)
            # a prompt that exactly fills the slot leaves no cache
            # position for a decode write: terminal here
            capped = ent["len"] >= self.max_pages_per_slot \
                * self.page_size
            fin = done or len(tokens) >= req["max_new"] or capped
            now = time.monotonic()
            t_first = req.get("t_first") or now
            if fin:
                self._release_slot(s, plan["slot"])
                self._set_req(s, rid, state="done", tokens=tokens,
                              slot=None, epoch=None, t_first=t_first,
                              t_done=now)
            else:
                s["slots"][plan["slot"]] = dict(
                    ent, last_tok=first_token)
                self._set_req(s, rid, tokens=tokens, t_first=t_first)
        return rid if fin else None

    def fail(self, plan):
        """Terminal failure of an admitted-but-unprefillable request
        (a preempted request regrown past the ladder).  Epoch-checked."""
        self._point("sched.fail", "rid %s" % plan["rid"])
        with self._lock:
            s = self._s
            ent = s["slots"].get(plan["slot"])
            if ent is None or ent["epoch"] != plan["epoch"]:
                return
            s["slots"] = dict(s["slots"])
            self._release_slot(s, plan["slot"])
            self._set_req(s, ent["rid"], state="failed", slot=None,
                          epoch=None, t_done=time.monotonic())

    def begin_step(self):
        """Snapshot the decode batch: every running slot with one more
        token of page capacity.  A slot crossing a page boundary
        allocates here; when the pool is dry the YOUNGEST other running
        slot is preempted (pages freed, request requeued at the FRONT).
        Returns a tuple of per-slot dicts -- the identity
        ``commit_step`` validates."""
        self._point("sched.begin")
        with self._lock:
            s = self._s
            s["slots"] = dict(s["slots"])
            snap = []
            for slot in sorted(s["slots"]):
                ent = s["slots"].get(slot)
                if ent is None or ent["last_tok"] is None:
                    continue
                pos = ent["len"]  # this step writes cache position len
                if pos >= self.max_pages_per_slot * self.page_size:
                    # no decode headroom: terminal NOW, not leaked
                    self._release_slot(s, slot)
                    self._set_req(s, ent["rid"], state="done",
                                  slot=None, epoch=None,
                                  t_done=time.monotonic())
                    continue
                if pos // self.page_size >= len(ent["pages"]):
                    got = self._alloc(s, 1)
                    while got is None:
                        victim = self._pick_victim(s, exclude=slot)
                        if victim is None:
                            break
                        self._preempt(s, victim)
                        got = self._alloc(s, 1)
                    if got is None:
                        # not even preemption helped: requeue this one
                        self._preempt(s, slot)
                        continue
                    ent = dict(ent, pages=ent["pages"] + tuple(got))
                    s["slots"][slot] = ent
                req = s["reqs"][ent["rid"]]
                snap.append({"slot": slot, "rid": ent["rid"],
                             "epoch": ent["epoch"], "len": pos,
                             "pages": ent["pages"],
                             "last_tok": ent["last_tok"],
                             "sampling": dict(req.get("sampling")
                                              or _norm_sampling(
                                                  None, ent["rid"])),
                             "step": len(req["tokens"])})
        return tuple(snap)

    def _pick_victim(self, s, exclude):
        """Youngest (highest-epoch) running slot other than ``exclude``
        -- the cheapest recompute to throw away."""
        best = None
        for slot, ent in s["slots"].items():
            if slot == exclude:
                continue
            if best is None or ent["epoch"] > s["slots"][best]["epoch"]:
                best = slot
        return best

    def _preempt(self, s, slot):
        ent = self._release_slot(s, slot)
        req = s["reqs"][ent["rid"]]
        self._set_req(s, ent["rid"], state="waiting", slot=None,
                      epoch=None, preempts=req.get("preempts", 0) + 1)
        s["queue"] = (ent["rid"],) + s["queue"]
        s["preemptions"] = s["preemptions"] + 1
        _telemetry.bump("serve::preemptions")

    def commit_step(self, snapshot, results):
        """Apply one decode step's results: ``results`` pairs each
        snapshot entry with its (token, done) -- done e.g. at EOS.  The
        (slot, epoch) identity from the snapshot is re-validated:
        admissions ran while the decode was in flight, so a slot may now
        belong to another request.  Returns the rids finished."""
        self._point("sched.commit")
        finished = []
        with self._lock:
            s = self._s
            s["slots"] = dict(s["slots"])
            for entry, (token, done) in zip(snapshot, results):
                slot, epoch = entry["slot"], entry["epoch"]
                ent = s["slots"].get(slot)
                if ent is None or ent["epoch"] != epoch:
                    continue  # freed or reassigned mid-flight: drop
                rid = ent["rid"]
                req = s["reqs"][rid]
                tokens = req["tokens"] + (token,)
                new_len = ent["len"] + 1
                capped = new_len + 1 > self.max_pages_per_slot \
                    * self.page_size
                fin = done or len(tokens) >= req["max_new"] or capped
                if fin:
                    self._release_slot(s, slot)
                    self._set_req(s, rid, state="done", tokens=tokens,
                                  slot=None, epoch=None,
                                  t_done=time.monotonic())
                    finished.append(rid)
                else:
                    s["slots"][slot] = dict(ent, len=new_len,
                                            last_tok=token)
                    self._set_req(s, rid, tokens=tokens)
        if finished:
            _telemetry.bump("serve::finished", len(finished))
        return finished

    def preempt_all(self, reason="elastic"):
        """Drain EVERY occupied slot through the ordinary preemption
        path -- pages freed, each request requeued at the FRONT of the
        queue to re-prefill later -- and return the number of slots
        drained: the elastic-resize valve (:meth:`Server.attach_elastic`).
        No request is dropped, only its KV cache.  One transaction under
        the scheduler lock: an ``engine_step`` racing it sees either the
        old world (its stale-epoch commits are discarded) or the drained
        one."""
        with self._lock:
            s = self._s
            s["slots"] = dict(s["slots"])
            drained = 0
            for slot in sorted(s["slots"]):
                self._preempt(s, slot)
                drained += 1
        if drained:
            _telemetry.bump("serve::elastic_drains", drained)
            log.info("serve: drained %d slot(s) (%s)", drained, reason)
        return drained

    def purge(self, rid):
        """Drop a TERMINAL request's record and return it (None when the
        rid is unknown or still live), so per-request state stays bounded
        by live requests."""
        with self._lock:
            s = self._s
            req = s["reqs"].get(rid)
            if req is None or req["state"] not in ("done", "cancelled",
                                                   "failed"):
                return None
            reqs = dict(s["reqs"])
            del reqs[rid]
            s["reqs"] = reqs
            return dict(req)

    # -- introspection --------------------------------------------------
    def request(self, rid):
        with self._lock:
            req = self._s["reqs"].get(rid)
            return dict(req) if req else None

    def stats(self):
        with self._lock:
            s = self._s
            return {
                "waiting": len(s["queue"]),
                "running": len(s["slots"]),
                "free_slots": len(s["free_slots"]),
                "free_pages": len(s["free_pages"]),
                "preemptions": s["preemptions"],
                "requests": len(s["reqs"]),
                "cached_pages": len(s["prefix"]),
                "prefix_hits": s["prefix_hits"],
                "prefix_evictions": s["prefix_evictions"],
            }

    def check_conservation(self):
        """Allocator invariant: every page is free, cached in the prefix
        trie, or privately owned by exactly one slot; audit empty."""
        with self._lock:
            s = self._s
            vals = [v[0] for v in s["prefix"].values()]
            cached = sorted(set(vals))
            owned = [p for ent in s["slots"].values()
                     for p in ent["pages"]
                     if p not in set(ent.get("shared", ()))]
            free = list(s["free_pages"])
        problems = list(self.audit)
        if len(set(vals)) != len(vals):
            problems.append("trie maps two keys to one page")
        allp = owned + free + cached
        if len(set(allp)) != len(allp):
            problems.append("page owned/free/cached more than once: %s"
                            % sorted(allp))
        if len(allp) != self.num_pages - 1:  # trash page never pooled
            problems.append("page leak: %d accounted of %d"
                            % (len(allp), self.num_pages - 1))
        return problems

    def check_refcounts(self):
        """Prefix-cache refcount invariant: every cached page's refcount
        equals the number of slots holding it shared; refs never
        negative; no ref without a cache entry; no cached page free."""
        with self._lock:
            s = self._s
            cached = set(v[0] for v in s["prefix"].values())
            refs = dict(s["refs"])
            free = set(s["free_pages"])
            holders = {}
            for ent in s["slots"].values():
                for p in set(ent.get("shared", ())):
                    holders[p] = holders.get(p, 0) + 1
        problems = []
        for p in sorted(cached & free):
            problems.append("cached page %d is also free" % p)
        for p in sorted(set(holders) - cached):
            problems.append("ref held on non-cached page %d" % p)
        for p in sorted(cached):
            have = refs.get(p, 0)
            want = holders.get(p, 0)
            if have != want:
                problems.append("page %d refcount %d != %d holder(s)"
                                % (p, have, want))
        for p, n in sorted(refs.items()):
            if n < 0:
                problems.append("page %d refcount negative" % p)
            elif n and p not in cached:
                problems.append("refcount on evicted page %d" % p)
        return problems


# ----------------------------------------------------------------------
# int8 weight path
# ----------------------------------------------------------------------
def quantize_weights(params, exclude=("tok_embeddings", "gamma"),
                     amax=None):
    """Per-tensor int8 weights for memory-bound decode (the JAX
    ``quantize_weights``, minmax as ``contrib.quantization``): returns
    (params with every 2-D weight whose name holds no ``exclude`` entry
    as int8, {name: Python-float scale}).  scale = max|w| / 127 and
    q = clip(round(w / scale), -127, 127), in float32.  The decode reads
    the int8 weights from HBM and dequantizes them in registers, so its
    weight bytes -- the decode bottleneck -- halve against bf16.
    Embeddings and norm gains stay in the compute dtype.  ``amax``
    ({name: max|w| over the whole weight}) gives the scale of a weight
    of which ``params`` holds one rank's block."""
    q, scales = {}, {}
    amax = amax or {}
    for name, w in params.items():
        if w.dim() != 2 or any(t in name for t in exclude):
            q[name] = w
            continue
        w32 = w.detach().float()
        scale = _minmax_scale(w32) if name not in amax \
            else (amax[name] or 1.0) / 127
        div = torch.tensor(scale, dtype=torch.float32).to(w32.device)
        q[name] = torch.clamp(torch.round(w32 / div), -127, 127) \
            .to(torch.int8)
        scales[name] = float(scale)
    return q, scales


def _dequant(params, scales, dtype):
    """Every quantized weight of ``params`` as ``q.to(dtype) * scale``,
    rounded in ``dtype`` (the JAX ``_dequant``)."""
    if not scales:
        return params
    return {k: (dequantize(v, scales[k], dtype) if k in scales else v)
            for k, v in params.items()}


def _global_amax(params):
    """{name: max|w| over the whole weight} for each 2-D parameter
    sharded over a mesh: the local maxima of the weights sharded over the
    same axes gathered in one collective (every rank, one order)."""
    groups = {}
    for name, p in params.items():
        sh = placement(p)
        axes = tuple(a for a in (sh.spec if sh is not None else ())
                     if a is not None)
        if axes and p.dim() == 2:
            groups.setdefault((id(sh.mesh), axes), (sh.mesh, []))[1] \
                .append(name)
    out = {}
    for (_, axes), (mesh, names) in groups.items():
        local = torch.stack([params[n].detach().float().abs().max()
                             for n in names])
        amax = _compat.all_gather(local[None], 0, axes, mesh).amax(0)
        out.update(zip(names, amax.tolist()))
    return out


def _int8_layers(net):
    """``{Dense: Int8Weight}`` of ``net``'s quantized weights: each comes
    from :func:`quantize_weights` and computes in its weight's own dtype.
    The net's parameters stay as they are.  A tensor-parallel rank
    quantizes its blocks with the whole weight's scale, so each int8
    block is the block of the whole int8 weight."""
    ps = net.collect_params()
    params = {k: p.detach() for k, p in ps.items()}
    q, scales = quantize_weights(params, amax=_global_amax(ps))
    modules = dict(net.named_modules())
    layers = {}
    for name, scale in scales.items():
        owner, leaf = name.rsplit(".", 1)
        layer = modules.get(owner)
        if not isinstance(layer, Dense) or leaf != "weight":
            raise NotImplementedError("int8 path: %s is not the weight of "
                                      "a Dense layer" % name)
        layers[layer] = Int8Weight(q[name], scale, params[name].dtype)
    return layers


# ----------------------------------------------------------------------
# sampling on device tensors (inside the serving programs)
# ----------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit avalanche of an int64 tensor of values in [0, 2^32):
    xor-shift and multiply rounds whose constants are below 2^31, so no
    product leaves int64, masked back to 32 bits after each."""
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _M32
    x = ((x ^ (x >> 15)) * 0x46CA68B5) & _M32
    return x ^ (x >> 16)


def _uniforms(seeds, steps, n):
    """(S, n) float32 uniforms in (0, 1), a counter-based hash of (seed,
    step, index) in integer tensor ops: no generator object and no host
    integer, so it runs inside a captured program.  The top 23 bits of
    each hash, centred: (b + 0.5) / 2^23."""
    key = _mix32((seeds.long() & _M32) ^ 0x2545F491)
    key = _mix32(key ^ (steps.long() & _M32))
    idx = (torch.arange(n, device=seeds.device) * 0x61C88647) & _M32
    bits = _mix32(_mix32(idx[None, :] ^ key[:, None]) ^ 0x5BD1E995)
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def _sample_batch(logits, seeds, steps, temps, top_ks, top_ps):
    """Sample one token per row of (S, V) float32 logits, as the JAX
    ``_sample_batch`` (vmapped ``_sample_one``) does, on (S,) device
    tensors: seeds and steps (int), temps (float32), top_ks (int),
    top_ps (float32).  ``step`` = tokens generated so far, so the same
    seed gives the same tokens and a preempted request resumes at the
    same step indices.  Greedy and sampled are both computed and
    ``temp <= 0`` picks the argmax.  The sampled token is gumbel-max over
    the stably sorted row scaled by 1 / max(temp, 1e-6), masked to the
    top_k ranks (``top_k <= 0``: all) and to the ranks whose cumulative
    mass EXCLUDING self is below top_p (the top-1 always survives); the
    noise is a hash of (seed, step, rank).  Rows are independent, so a
    batched slot samples as it would alone.  Returns (S,) int64."""
    V = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    order = torch.argsort(-logits, dim=-1, stable=True)     # descending
    sl = logits.gather(1, order) / temps.clamp_min(1e-6)[:, None]
    rank = torch.arange(V, device=logits.device)
    keep = (top_ks[:, None] <= 0) | (rank[None, :] < top_ks[:, None])
    probs = torch.softmax(sl, dim=-1)
    keep &= (torch.cumsum(probs, dim=-1) - probs) < top_ps[:, None]
    gumbel = -torch.log(-torch.log(_uniforms(seeds, steps, V)))
    pick = (sl.masked_fill(~keep, float("-inf")) + gumbel).argmax(dim=-1)
    sampled = order.gather(1, pick[:, None])[:, 0]
    return torch.where(temps <= 0, greedy, sampled)


# ----------------------------------------------------------------------
# the warm pool: the serving programs, captured at start-up
# ----------------------------------------------------------------------
class _Inputs:
    """A program's static device inputs and their host staging.
    :meth:`fill` writes values into the (pinned, on CUDA) host tensors
    and queues non-blocking copies into the device buffers, which a
    captured program reads; it first waits until the previous fill's
    copies have read the staging."""

    def __init__(self, device, **specs):
        self._cuda = device.type == "cuda"
        self.dev = {n: torch.zeros(shape, dtype=dt, device=device)
                    for n, (shape, dt) in specs.items()}
        self._host = {n: torch.zeros(shape, dtype=dt, pin_memory=self._cuda)
                      for n, (shape, dt) in specs.items()}
        self._copied = None

    def fill(self, **values):
        if self._copied is not None:
            self._copied.synchronize()
        for n, v in values.items():
            self._host[n].numpy()[...] = v
            self.dev[n].copy_(self._host[n], non_blocking=True)
        if self._cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()


class _Program:
    """One serving program: a function of the pool's static buffers.  On
    the card it is captured into a CUDA graph once, at start-up, and
    replayed; on the CPU, which has no graphs, and with ``eager`` (a
    gloo mesh's collectives), it runs eagerly."""

    def __init__(self, fn, device, pool=None, eager=False):
        self.fn = fn
        self.graph, self.launches = None, {}
        if device.type == "cuda" and not eager:
            self.graph, _, self.launches = capture_graph(fn, pool=pool)

    def __call__(self):
        if self.graph is None:
            with torch.no_grad():
                self.fn()
        else:
            replay_graph(self.graph, self.launches)


class WarmPool:
    """The replica's device state and its programs, fixed at start-up:
    the model's parameters (and, with ``ServeConfig(int8=True)``, their
    int8 copies), the paged KV pools, and one decode program (S slots x
    MP pages), one prefill program per ladder rung and, with the prefix
    cache, one chunk program per rung.  On the card each program is a
    CUDA graph captured here (``stats``: ``programs`` graphs in
    ``capture_s``), so a step replays with no per-op host dispatch; a
    failed capture raises.  On the CPU the same functions run eagerly.

    Every program reads only static device buffers (page table, lengths,
    tokens, active, the sampling vectors; the padded tokens, the page
    row, ``true_len`` and ``start``), which :meth:`run_decode` and
    :meth:`run_prefill` fill from host staging before a replay, and
    writes its tokens into buffers outside every graph pool.  Sampling
    runs inside the programs.  The decode graph has its own memory pool;
    the prefill and chunk graphs, which run one at a time on the engine
    thread, share one.  The COW page copy is one indexed copy and stays
    eager.

    ``mesh`` (a tensor-parallel replica, reference ``serve.py:1148``):
    the net's parameters go through ``parallel.shard_params`` under the
    transformer's Megatron annotations (each rank keeps its blocks; the
    net is changed in place), the KV pools hold the rank's KV heads
    (``kv_cache.local_kv_heads``), and each program runs the model's
    tensor-parallel path, whose collectives run over the mesh.  Every
    rank of the mesh builds the same pool, in the same order.  Under
    NCCL the collectives are captured inside the graphs (the
    communicators are warmed first); under gloo with CUDA tensors they
    stage through host memory, which no graph can hold, so the programs
    run eagerly and ``stats["eager"]`` says why (``programs`` 0).  The
    backend decides this, never a failure."""

    def __init__(self, net, serve_cfg: ServeConfig, mesh=None):
        t0 = time.monotonic()
        self.net = net
        self.cfg = net.cfg
        self.serve_cfg = serve_cfg
        self.mesh = mesh
        if mesh is not None:
            shard_params(net, mesh)
        spec = self.spec = serve_cfg.cache_spec(net.cfg, mesh)
        dev = self.device = net.output.weight.device
        self.k_pages, self.v_pages = init_pools(spec, dev)
        self.int8 = _int8_layers(net) if serve_cfg.int8 else {}
        S, MP = spec.slots, spec.max_pages_per_slot
        i32, i64, f32 = torch.int32, torch.int64, torch.float32

        def samp(n):        # the sampler's knobs for n rows
            return {"seeds": ((n,), i64), "steps": ((n,), i64),
                    "temps": ((n,), f32), "top_ks": ((n,), i32),
                    "top_ps": ((n,), f32)}
        self._dec = _Inputs(dev, page_table=((S, MP), i32),
                            lengths=((S,), i32), tokens=((S,), i32),
                            active=((S,), torch.bool), **samp(S))
        self._pre = _Inputs(dev, tokens=((1, max(serve_cfg.ladder)), i32),
                            page_row=((MP,), i32), true_len=((), i32),
                            start=((), i32), **samp(1))
        # a prompt length whose last row exists, for the warm-up and
        # capture calls (a real prefill always sets its own)
        self._pre.fill(true_len=1)
        self._dec_out = torch.zeros(S, dtype=i64, device=dev)
        self._pre_out = torch.zeros(1, dtype=i64, device=dev)
        cuda = dev.type == "cuda"
        multi = mesh is not None and mesh.group is not None
        eager = None
        if cuda and multi and mesh.backend == "gloo":
            eager = ("gloo mesh: its collectives stage CUDA tensors "
                     "through host memory, which a CUDA graph cannot hold")
        elif cuda and multi:
            # NCCL builds a communicator at its first collective, which
            # a capture cannot hold: one collective per axis first
            for ax in mesh.axis_names:
                _compat.psum(torch.zeros(1, device=dev), ax, mesh)
            torch.cuda.synchronize(dev)
        graphs = cuda and eager is None
        with torch.no_grad():
            self._decode = _Program(self._decode_step, dev, pool=(
                torch.cuda.graph_pool_handle() if graphs else None),
                eager=eager is not None)
            shared = torch.cuda.graph_pool_handle() if graphs else None
            self._prefill = {T: _Program(functools.partial(
                self._prefill_step, T, False), dev, shared,
                eager=eager is not None) for T in serve_cfg.ladder}
            self._chunk = {T: _Program(functools.partial(
                self._prefill_step, T, True), dev, shared,
                eager=eager is not None)
                for T in serve_cfg.ladder} if serve_cfg.prefix_cache else {}
        self.stats = {
            "pool_bytes": 2 * self.k_pages.numel()
            * self.k_pages.element_size(),
            "programs": (1 + len(self._prefill) + len(self._chunk))
            if graphs else 0,
            "capture_s": round(time.monotonic() - t0, 3),
            "int8": bool(self.int8),
            "sharded": mesh is not None,
            "tp": mesh.axis_size("tp") if mesh is not None
            and "tp" in mesh.shape else 1,
            "eager": eager}
        log.info("serve warm pool ready: %d graphs in %.2fs%s%s",
                 self.stats["programs"], self.stats["capture_s"],
                 " (int8 weights)" if self.int8 else "",
                 " (eager: %s)" % eager if eager else "")

    def ladder_fit(self, n):
        """Smallest ladder length holding an n-token prompt (None when
        the prompt exceeds the ladder)."""
        for T in self.serve_cfg.ladder:
            if n <= T:
                return T
        return None

    # -- the captured functions (read static buffers, write static out) --
    def _decode_step(self):
        b = self._dec.dev
        view = CacheView("decode", self.k_pages, self.v_pages,
                         self.spec.page_size, page_table=b["page_table"],
                         lengths=b["lengths"], active=b["active"])
        with int8_weights(self.int8, "decode"):
            logits = self.net(b["tokens"][:, None], cache=view)
        self._dec_out.copy_(_sample_batch(
            logits[:, -1].float(), b["seeds"], b["steps"], b["temps"],
            b["top_ks"], b["top_ps"]))

    def _prefill_step(self, T, chunk):
        b = self._pre.dev
        view = CacheView("chunk" if chunk else "prefill", self.k_pages,
                         self.v_pages, self.spec.page_size,
                         page_row=b["page_row"], true_len=b["true_len"],
                         start=b["start"] if chunk else None)
        with int8_weights(self.int8, "prefill"):
            logits = self.net(b["tokens"][:, :T], cache=view)
        last = logits[0].index_select(
            0, (b["true_len"] - 1).long().reshape(1)).float()
        self._pre_out.copy_(_sample_batch(
            last, b["seeds"], b["steps"], b["temps"], b["top_ks"],
            b["top_ps"]))

    # -- program invocations --------------------------------------------
    def run_prefill(self, tokens_padded, page_row, true_len, start=0,
                    sampling=None, step=0):
        """Prefill ``true_len`` real tokens (ladder-padded input) and
        return the first generated token as an int.  ``start > 0`` runs
        the chunk program: the tokens are the prompt SUFFIX from
        absolute position ``start``, earlier positions read from cached
        pages."""
        tokens_padded = onp.asarray(tokens_padded, onp.int32).reshape(-1)
        T = tokens_padded.shape[0]
        programs = self._chunk if start else self._prefill
        if T not in programs:
            raise ValueError("no %s program for %d tokens (ladder %s%s)"
                             % ("chunk" if start else "prefill", T,
                                self.serve_cfg.ladder, "" if programs
                                else ", prefix cache off"))
        sp = _norm_sampling(sampling, 0)
        toks = onp.zeros((1, max(self.serve_cfg.ladder)), onp.int32)
        toks[0, :T] = tokens_padded
        self._pre.fill(tokens=toks, page_row=page_row, true_len=true_len,
                       start=start, seeds=sp["seed"] & _M32, steps=step,
                       temps=sp["temperature"], top_ks=sp["top_k"],
                       top_ps=sp["top_p"])
        programs[T]()
        return int(self._pre_out[0])

    def run_decode(self, page_table, lengths, tokens, active,
                   sampling=None):
        """One decode step over every slot.  ``sampling`` is a list of
        per-slot dicts (seed, step, temperature, top_k, top_p) or None
        (greedy).  Returns the (S,) next tokens as a device tensor of its
        own -- the caller reads it after queueing other work, so the
        host does not wait on the step here."""
        S = self.spec.slots
        seeds, steps = onp.zeros(S, onp.int64), onp.zeros(S, onp.int64)
        temps, top_ks = onp.zeros(S, onp.float32), onp.zeros(S, onp.int32)
        top_ps = onp.ones(S, onp.float32)
        for i, sp in enumerate(sampling or ()):
            if sp is not None:
                seeds[i], steps[i] = sp["seed"] & _M32, sp["step"]
                temps[i], top_ks[i] = sp["temperature"], sp["top_k"]
                top_ps[i] = sp["top_p"]
        self._dec.fill(page_table=page_table, lengths=lengths,
                       tokens=tokens, active=active, seeds=seeds,
                       steps=steps, temps=temps, top_ks=top_ks,
                       top_ps=top_ps)
        self._decode()
        return self._dec_out.clone()

    @torch.no_grad()
    def copy_page(self, src, dst):
        """COW: copy page ``src``'s K/V (all layers) into ``dst`` -- runs
        BEFORE the chunk prefill that writes into ``dst``."""
        self.k_pages[:, dst] = self.k_pages[:, src]
        self.v_pages[:, dst] = self.v_pages[:, src]


class _PlanChannel:
    """A tensor-parallel replica's step plans, from the leader (rank 0 of
    the mesh) to the followers: one ``broadcast_object_list`` per plan
    on a gloo group of the mesh's ranks, so a plan is host data and
    synchronizes nothing on the device.  A plan is ``(kind, args)``:
    ``decode`` / ``prefill`` (the padded host arrays and sampling of
    :meth:`WarmPool.run_decode` / :meth:`WarmPool.run_prefill`; the
    prefill's ``start`` picks the chunk program), ``copy`` (a COW page
    copy) or ``stop``.  Every rank of the world builds it, in one
    order (``new_group``)."""

    def __init__(self, mesh):
        ranks = mesh.member_ranks()
        self.group = dist.new_group(ranks, backend="gloo")
        self.root = ranks[0]
        self.leader = mesh.rank == self.root
        self.sent = {}      # plans sent, by kind

    def send(self, kind, args):
        dist.broadcast_object_list([(kind, args)], src=self.root,
                                   group=self.group)
        self.sent[kind] = self.sent.get(kind, 0) + 1

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.root, group=self.group)
        return box[0]


#: what each plan kind runs on a rank's pool (through the instance, so
#: a pool's own attribute wins)
_RUN = {"decode": lambda pool, **a: pool.run_decode(**a),
        "prefill": lambda pool, **a: pool.run_prefill(**a),
        "copy": lambda pool, **a: pool.copy_page(**a)}


class Server:
    """The serving replica: a :class:`WarmPool`, a
    :class:`SlotScheduler`, and one engine thread running the
    continuous-batching loop.  Clients call :meth:`submit` /
    :meth:`result` (or the one-shot :meth:`generate`) from any thread.

    ``mesh`` (reference ``serve.py:1338``): a tensor-parallel replica
    over the mesh's ranks.  The reference is one controller over every
    device; here every rank of the mesh builds the same ``Server``.  The
    **leader**, rank 0 of the mesh, runs the scheduler, takes
    ``submit`` / ``result`` / ``generate`` and, at each program it runs,
    first sends the followers its step plan (:class:`_PlanChannel`).
    The **followers** run the same programs on their shards from their
    engine threads (``start``), and a client call on a follower raises;
    a follower's ``stop`` returns once the leader's ``stop`` (or its
    engine's death) has sent the stop plan.  Faults are injected and
    handled on the leader; a follower's own failure ends its engine.

    Engine iteration::

        snapshot = sched.begin_step()      # capacity, preemption
        launch decode(snapshot)            # queued on the device
        while plan := sched.admit_next():  # admissions OVERLAP decode
            first = prefill(plan)
            sched.commit_prefill(plan, first)   # epoch-checked
        sched.commit_step(snapshot, results)    # epoch-checked
    """

    def __init__(self, net, serve_cfg=None, mesh=None, **kw):
        self.cfg = serve_cfg or ServeConfig(**kw)
        self.pool = WarmPool(net, self.cfg, mesh=mesh)
        self._plans = _PlanChannel(mesh) if mesh is not None \
            and mesh.group is not None else None
        self.leader = self._plans is None or self._plans.leader
        self._followers_stopped = False
        spec = self.pool.spec
        self.sched = SlotScheduler(spec.slots, spec.pages,
                                   spec.page_size,
                                   spec.max_pages_per_slot,
                                   prefix_cache=self.cfg.prefix_cache,
                                   ladder=self.cfg.ladder)
        self._lock = threading.Lock()   # guards the dicts below
        self._prompts = {}              # rid -> list[int] prompt tokens
        self._done = {}                 # rid -> threading.Event
        self._live = frozenset()        # rids not yet terminal
        self._results = {}              # rid -> terminal request dict
        self._deadlines = {}            # rid -> monotonic expiry time
        self._expired = set()           # rids cancelled by the sweep
        self._stop = threading.Event()
        self._work = threading.Event()
        self._thread = None
        self._error = None              # engine-thread death, if any
        # streaming SLO sketches, fed at terminal delivery
        self.slo = _telemetry.ServeSLO()

    def _require_leader(self, what):
        if not self.leader:
            raise RuntimeError(
                "%s on a follower rank of a tensor-parallel Server: "
                "requests go to the leader (global rank %d)"
                % (what, self._plans.root))

    def _run(self, kind, **args):
        """Run one program (``_RUN``), its plan sent to the followers
        first on a tensor-parallel replica."""
        if self._plans is not None:
            self._plans.send(kind, args)
        return _RUN[kind](self.pool, **args)

    def _stop_followers(self):
        if self._plans is not None and self.leader \
                and not self._followers_stopped:
            self._followers_stopped = True
            self._plans.send("stop", {})

    # -- client API -----------------------------------------------------
    def submit(self, prompt_tokens, max_new=None, sampling=None,
               deadline=None):
        """Enqueue a request.  ``sampling`` overrides the replica's
        default knobs per request ({seed, temperature, top_k, top_p});
        the seed defaults to the rid.  ``deadline`` is a per-request
        budget in SECONDS (default: ``MXNET_SERVE_DEADLINE_MS``); an
        expired request is cancelled through the scheduler and
        :meth:`result` raises :class:`DeadlineExceededError`."""
        self._require_leader("submit")
        prompt = [int(t) for t in prompt_tokens]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new is None:
            max_new = self.cfg.max_new
        if max_new < 1:
            raise ValueError("max_new must be >= 1, got %r"
                             % (max_new,))
        if self.pool.ladder_fit(len(prompt)) is None:
            raise ValueError(
                "prompt of %d tokens exceeds the prefill ladder %s"
                % (len(prompt), self.cfg.ladder))
        vocab = self.pool.cfg.vocab_size
        if min(prompt) < 0 or max(prompt) >= vocab:
            raise ValueError("prompt token out of range [0, %d)" % vocab)
        sp = dict(self.cfg.default_sampling())
        sp.update(sampling or {})
        if deadline is None:
            deadline = self.cfg.default_deadline()
        # sched.submit runs INSIDE our lock (one-way Server->sched
        # nesting) so the engine never admits a rid whose prompt/event
        # aren't registered yet
        with self._lock:
            if self._error is not None:
                raise RuntimeError("serve engine thread died") \
                    from self._error
            rid = self.sched.submit(len(prompt), max_new,
                                    prompt=prompt, sampling=sp)
            self._prompts[rid] = prompt
            self._done[rid] = threading.Event()
            self._live = self._live | {rid}
            if deadline is not None:
                self._deadlines[rid] = (time.monotonic()
                                        + float(deadline))
        self._work.set()
        return rid

    def cancel(self, rid):
        self._require_leader("cancel")
        ok = self.sched.cancel(rid)
        # the engine sweep is the SOLE notifier; wake it so the
        # cancelled waiter is released within one iteration
        self._work.set()
        return ok

    def _pop_result(self, rid):
        with self._lock:
            res = self._results.pop(rid, None)
            expired = rid in self._expired
            self._expired.discard(rid)
        return res, expired

    def result(self, rid, timeout=None):
        """Block for the request's terminal state; returns the request
        dict (state done|cancelled|failed, generated ``tokens``).
        Single-delivery: a second call for the same rid returns None.
        A caller whose ``timeout`` runs out cancels the request (pages
        released) and gets ``TimeoutError``; a request whose deadline
        expired raises :class:`DeadlineExceededError`."""
        self._require_leader("result")
        with self._lock:
            ev = self._done.get(rid)
        if ev is not None and not ev.wait(timeout):
            self.cancel(rid)
            with self._lock:
                self._live = self._live - {rid}
                self._done.pop(rid, None)
                self._prompts.pop(rid, None)
                self._results.pop(rid, None)
                self._deadlines.pop(rid, None)
                self._expired.discard(rid)
            self.sched.purge(rid)
            raise TimeoutError(
                "request %d not finished within %.3fs -- cancelled and "
                "evicted" % (rid, timeout))
        res, expired = self._pop_result(rid)
        if expired:
            raise DeadlineExceededError(
                "request %d exceeded its deadline (cancelled, pages "
                "released)" % rid)
        if res is not None:
            return res
        req = self.sched.request(rid)  # in flight (death/stop paths)
        if req is None:
            # the sweep moved it between our two reads
            res, expired = self._pop_result(rid)
            if expired:
                raise DeadlineExceededError(
                    "request %d exceeded its deadline (cancelled, "
                    "pages released)" % rid)
            return res
        if req["state"] not in ("done", "cancelled", "failed"):
            with self._lock:
                err = self._error
            if err is not None:
                raise RuntimeError(
                    "serve engine thread died with request %d "
                    "in flight" % rid) from err
        return req

    def generate(self, prompt_tokens, max_new=None, timeout=None,
                 sampling=None, deadline=None):
        """One-shot submit+result."""
        rid = self.submit(prompt_tokens, max_new=max_new,
                          sampling=sampling, deadline=deadline)
        return self.result(rid, timeout=timeout)

    def slo_snapshot(self):
        """Live serving SLOs: p50 / p95 / p99 latency, TTFT and queue
        time, and tokens/s, from the streaming histograms (no per-request
        state is kept past delivery)."""
        return self.slo.snapshot()

    def attach_telemetry(self, sess=None):
        """Register this replica's load gauges (``serve::queue_depth``,
        ``serve::running``, ``serve::free_pages``) on a telemetry session
        (default: the process-wide one).  Returns the session."""
        sess = sess or _telemetry.session()
        sched = self.sched
        sess.register_gauge("serve::queue_depth",
                            lambda: sched.stats()["waiting"])
        sess.register_gauge("serve::running",
                            lambda: sched.stats()["running"])
        sess.register_gauge("serve::free_pages",
                            lambda: sched.stats()["free_pages"])
        return sess

    def attach_elastic(self, runner):
        """Chain onto ``runner.on_resize`` (an elastic runner; any object
        with that attribute): every topology change drains this
        replica's slots through :meth:`SlotScheduler.preempt_all`, so the
        requests survive in the queue and re-prefill; only KV state is
        recomputed.  The previous hook still fires.  Returns the
        runner."""
        prev = runner.on_resize
        sched = self.sched

        def _drain(info, _prev=prev):
            gen = getattr(info.gen, "value", info.gen)
            sched.preempt_all(reason="resize gen=%s world=%s"
                              % (gen, info.world))
            self._work.set()   # the engine re-admits
            if _prev is not None:
                _prev(info)
        runner.on_resize = _drain
        return runner

    # -- engine ---------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._engine_loop if self.leader
                else self._follow_loop, daemon=True,
                name="mxserve-engine")
            self._thread.start()
        return self

    def stop(self):
        if not self.leader:
            # a follower ends at the leader's stop plan
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            return
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self._stop_followers()
        # wake every live waiter: their requests read back in their
        # honest non-terminal state
        with self._lock:
            evs = [self._done[r] for r in self._live
                   if r in self._done]
        for ev in evs:
            ev.set()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _finish_terminal(self):
        """Fire the completion event of every request that reached a
        terminal state -- the single notification path.  The terminal
        record moves to ``_results`` and is purged from the scheduler;
        it is stored before the purge so a concurrently-woken
        ``result()`` always finds it in one place or the other."""
        with self._lock:
            live = self._live
        done = {}
        for rid in live:
            req = self.sched.request(rid)
            if req is not None and req["state"] in ("done", "cancelled",
                                                    "failed"):
                done[rid] = req
        if not done:
            return
        with self._lock:
            # re-filter against the CURRENT live set: a concurrent
            # timeout-eviction may have disowned a rid
            done = {rid: req for rid, req in done.items()
                    if rid in self._live}
            if not done:
                return
            self._live = self._live - frozenset(done)
            self._results.update(done)
            evs = [self._done.pop(rid, None) for rid in done]
            for rid in done:
                self._prompts.pop(rid, None)
                self._deadlines.pop(rid, None)
        for rid, req in done.items():
            # lifecycle spans and SLO samples come from the record's
            # phase timestamps here, before the purge
            _telemetry.request_lifecycle(req, slo=self.slo)
            self.sched.purge(rid)
        for ev in evs:
            if ev is not None:
                ev.set()

    def _sweep_deadlines(self):
        """Cancel every request whose deadline passed, through the
        scheduler (pages and radix refcounts released)."""
        with self._lock:
            if not self._deadlines:
                return
            now = time.monotonic()
            due = sorted(rid for rid, t in self._deadlines.items()
                         if now >= t)
        for rid in due:
            cancelled = self.sched.cancel(rid)
            with self._lock:
                self._deadlines.pop(rid, None)
                if cancelled and rid in self._live:
                    self._expired.add(rid)
            if cancelled:
                _telemetry.bump("serve::deadline_exceeded")
                _flightrec.record("serve.deadline",
                                  detail="rid %d expired" % rid)

    def _bind_device(self):
        # the kernels launch on the thread's current card
        if self.pool.device.type == "cuda":
            torch.cuda.set_device(self.pool.device)

    def _follow_loop(self):
        """A follower's engine: run each plan the leader sends, on this
        rank's shard, until the stop plan."""
        self._bind_device()
        try:
            while True:
                kind, args = self._plans.recv()
                if kind == "stop":
                    return
                _RUN[kind](self.pool, **args)
        except BaseException as e:
            with self._lock:
                self._error = e
            log.exception("serve follower engine died")
            _flightrec.note_terminal("serve_follower", exc=e)
            raise

    def _engine_loop(self):
        self._bind_device()
        try:
            while not self._stop.is_set():
                if not self.engine_step():
                    # idle: park until a submit pokes us
                    self._work.wait(0.25)
                    self._work.clear()
        except BaseException as e:
            # a dying engine must not strand blocked result() callers:
            # record the error, wake every live waiter, refuse submits
            with self._lock:
                self._error = e
                evs = [self._done[r] for r in self._live
                       if r in self._done]
            log.exception("serve engine thread died")
            _flightrec.note_terminal("serve_engine", exc=e)
            for ev in evs:
                ev.set()
            raise
        finally:
            self._stop_followers()

    def engine_step(self):
        """One engine iteration; returns False when idle.  Public so
        tests (and single-threaded drivers) can pump the engine without
        the background thread (on a tensor-parallel replica, the
        leader's)."""
        self._require_leader("engine_step")
        # chaos seam: serve_engine_kill fires here, on the engine thread
        _fault.serve_engine_check("engine_step")
        self._sweep_deadlines()
        sched, pool = self.sched, self.pool
        spec = pool.spec
        eos = self.cfg.eos_id
        snapshot = sched.begin_step()
        toks = None
        if snapshot:
            S, MP = spec.slots, spec.max_pages_per_slot
            page_table = onp.zeros((S, MP), onp.int32)
            lengths = onp.zeros((S,), onp.int32)
            tokens = onp.zeros((S,), onp.int32)
            active = onp.zeros((S,), bool)
            sampling = [None] * S
            for e in snapshot:
                row = list(e["pages"])[:MP]
                page_table[e["slot"], :len(row)] = row
                lengths[e["slot"]] = e["len"]
                tokens[e["slot"]] = e["last_tok"]
                active[e["slot"]] = True
                sampling[e["slot"]] = dict(e["sampling"], step=e["step"])
            # the decode is queued on the device; the host runs the
            # admissions below meanwhile (their prefills queue behind it
            # on the same stream, so ordering is by the stream)
            toks = self._run("decode", page_table=page_table,
                             lengths=lengths, tokens=tokens, active=active,
                             sampling=sampling)
        admitted = False
        while True:
            plan = sched.admit_next()
            if plan is None:
                break
            admitted = True
            with self._lock:
                prompt = self._prompts.get(plan["rid"])
            if prompt is None:
                # a timeout-eviction disowned the rid between admit and
                # here; any commit against this plan is epoch-dropped
                continue
            req = sched.request(plan["rid"])
            prompt = list(prompt) + [int(t) for t in (req or {}).get(
                "tokens", ())]  # preempted: re-prefill generated tail
            start = int(plan.get("prefill_start", 0))
            chunk = prompt[start:]
            # only the UNCOVERED suffix rides the ladder
            T = pool.ladder_fit(len(chunk))
            if T is None:
                # a preempted request regrew past the ladder: terminal
                sched.fail(plan)
                continue
            if plan.get("cow"):
                # the first computed position lands in a shared page:
                # privatize it before any write can touch it
                self._run("copy", src=plan["cow"][0], dst=plan["cow"][1])
            padded = onp.zeros((T,), onp.int32)
            padded[:len(chunk)] = chunk
            row = onp.zeros((spec.max_pages_per_slot,), onp.int32)
            row[:len(plan["pages"])] = plan["pages"]
            first = self._run("prefill", tokens_padded=padded, page_row=row,
                              true_len=len(chunk), start=start,
                              sampling=plan.get("sampling"),
                              step=plan.get("ntok", 0))
            sched.commit_prefill(plan, first,
                                 done=(eos is not None and first == eos))
        if snapshot:
            try:
                _fault.serve_decode_check()
                out = toks.cpu().numpy()
            except Exception as exc:  # noqa: BLE001 -- classified below
                if _fault_dist.classify_xla_error(exc) != "transient":
                    raise  # fatal or unclassified: the engine dies
                # transient decode failure: nothing was committed, page
                # writes are write-before-read and sampling is a pure
                # function of (seed, step), so the same step replayed next
                # iteration gives the tokens a fault-free run gives
                _telemetry.bump("serve::decode_retries")
                _flightrec.record("serve.decode_retry",
                                  error=type(exc).__name__)
                log.warning("serve: transient decode failure, step "
                            "dropped for replay: %s", exc)
                self._finish_terminal()
                return True
            results = [(int(out[e["slot"]]),
                        eos is not None and int(out[e["slot"]]) == eos)
                       for e in snapshot]
            sched.commit_step(snapshot, results)
        self._finish_terminal()
        return bool(snapshot) or admitted

