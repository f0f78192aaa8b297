"""The port's continuous-batching server (``mxnet_tpu_torch.serve``).

Against the JAX package: with the same tiny_config weights, the port's
``Server`` emits the JAX ``Server``'s greedy tokens (guarded against
near-ties).  Within the port: batched == solo, same seed => same
sampled tokens, temperature 0 == greedy, the prefix cache is
transparent, and the scheduler's protocol cases of
``tests/test_serve.py`` re-run against the port's ``SlotScheduler``.
Plus the package's import hygiene: no jax, no mxnet_tpu.
"""
import ast
import os
import subprocess
import sys
import threading
import time

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import _tape
from mxnet_tpu import serve as jserve
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nets(seed=0):
    """A JAX net and the port's net with its weights; N(0, 0.2) weights
    spread the logits, so greedy tokens sit far from ties."""
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config())
    jnet.initialize(mx.init.Normal(0.2))
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(), device="cpu"), params)
    return jnet, tnet


def _tnet(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TransformerLM(tiny_config(), device="cpu").initialize(gen,
                                                                 std=0.1)


def _cfg(**kw):
    args = dict(slots=3, page_size=8, pages=24, ladder=(16, 32),
                max_new=10)
    args.update(kw)
    return serve.ServeConfig(**args)


def _serve_all(srv, prompts, max_new, sampling=None):
    with srv:
        rids = [srv.submit(p, max_new=m,
                           sampling=None if sampling is None
                           else sampling[i])
                for i, (p, m) in enumerate(zip(prompts, max_new))]
        return [srv.result(r, timeout=120)["tokens"] for r in rids]


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------
def test_server_greedy_tokens_match_jax_server():
    jnet, tnet = _nets(1)
    rng = onp.random.RandomState(20)
    prompts = [list(rng.randint(1, 256, int(rng.randint(3, 14))))
               for _ in range(4)]
    budgets = [6, 4, 7, 5]
    # one ladder rung and no prefix cache: the fewest JAX programs to
    # compile (decode, one prefill, the page copy)
    jsrv = jserve.Server(jnet, jserve.ServeConfig(
        slots=3, page_size=8, pages=24, ladder=(16,), max_new=10,
        cache_dir=None, int8=False, prefix_cache=False))
    want = _serve_all(jsrv, prompts, budgets)
    # tie guard: the JAX full forward's top-2 gap at every generated
    # position, so an fp32 near-tie cannot flip a token either way
    for p, toks in zip(prompts, want):
        seq = onp.asarray([p + list(toks[:-1])], onp.int32)
        with _tape.suspend_recording():
            logits = onp.asarray(jnet.forward(NDArray(jnp.asarray(seq)))
                                 ._data)[0, len(p) - 1:]
        top2 = onp.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    got = _serve_all(serve.Server(tnet, _cfg(ladder=(16,),
                                             prefix_cache=False)),
                     prompts, budgets)
    assert got == [tuple(t) for t in want]


# ----------------------------------------------------------------------
# within the port
# ----------------------------------------------------------------------
def test_server_continuous_batch_matches_solo_generation():
    tnet = _tnet(1)
    rng = onp.random.RandomState(4)
    prompts = [list(rng.randint(1, 256, int(rng.randint(3, 14))))
               for _ in range(7)]
    budgets = [3 + (i % 5) for i in range(7)]
    srv = serve.Server(tnet, _cfg())
    batched = _serve_all(srv, prompts, budgets)
    assert srv.sched.check_conservation() == []
    assert all(len(t) == m for t, m in zip(batched, budgets))
    solo_srv = serve.Server(tnet, _cfg(slots=1))
    for i in (0, 3, 6):
        assert _serve_all(solo_srv, [prompts[i]], [budgets[i]]) == \
            [batched[i]]


def test_sampling_deterministic_per_seed_and_batched_matches_solo():
    tnet = _tnet(2)
    rng = onp.random.RandomState(8)
    prompts = [list(rng.randint(1, 256, 6)) for _ in range(3)]
    sp = [{"temperature": 0.9, "top_k": 20, "top_p": 0.9, "seed": 40 + i}
          for i in range(3)]
    runs = [_serve_all(serve.Server(tnet, _cfg()), prompts, [8] * 3, sp)
            for _ in range(2)]
    assert runs[0] == runs[1], "same seeds must reproduce"
    solo_srv = serve.Server(tnet, _cfg(slots=1))
    for i in range(3):
        assert _serve_all(solo_srv, [prompts[i]], [8], [sp[i]]) == \
            [runs[0][i]], "batched != solo for seed %d" % (40 + i)


def test_temperature_zero_is_greedy_and_seeds_decorrelate():
    tnet = _tnet(3)
    prompt = [5, 9, 2, 14, 3]
    hot = {"temperature": 1.0, "top_k": 0, "top_p": 1.0}
    ta, tb, tz, tg = _serve_all(
        serve.Server(tnet, _cfg(slots=4)), [prompt] * 4, [10] * 4,
        [dict(hot, seed=1), dict(hot, seed=2),
         {"temperature": 0.0, "seed": 3}, None])
    assert tz == tg, "temperature 0 must be the argmax"
    assert ta != tb, "distinct seeds produced identical streams"


def _sample_one(logits, seed, step, temp, top_k, top_p):
    """One row through the sampler, its knobs as (1,) tensors."""
    def one(v, dt):
        return torch.tensor([v], dtype=dt)
    return int(serve._sample_batch(
        logits[None], one(seed, torch.int64), one(step, torch.int64),
        one(temp, torch.float32), one(top_k, torch.int32),
        one(top_p, torch.float32))[0])


def test_sample_one_respects_top_k_and_top_p():
    logits = torch.tensor([0.0, 5.0, 4.9, -3.0, 1.0])
    for step in range(20):
        tok = _sample_one(logits, 7, step, 1.0, 2, 1.0)
        assert tok in (1, 2)                     # top-2 only
        tok = _sample_one(logits, 7, step, 1.0, 0, 1e-6)
        assert tok == 1                          # top-1 always survives
    assert _sample_one(logits, 7, 0, 0.0, 0, 1.0) == 1


def test_server_prefix_cache_transparent():
    """Shared system prompt with the prefix cache ON vs OFF: the same
    tokens (COW + chunk prefill rebuild exactly the state a full prefill
    writes), and the ON run must hit the trie."""
    tnet = _tnet(4)
    rng = onp.random.RandomState(9)
    sys_prompt = list(rng.randint(1, 256, 10))
    prompts = [sys_prompt + list(rng.randint(1, 256,
                                             int(rng.randint(2, 6))))
               for _ in range(4)]
    outs = {}
    for on in (True, False):
        srv = serve.Server(tnet, _cfg(page_size=8, ladder=(8, 16, 32),
                                      max_new=6, prefix_cache=on))
        outs[on] = _serve_all(srv, prompts, [6] * 4)
        if on:
            assert srv.sched.stats()["prefix_hits"] >= 1
        assert srv.sched.check_refcounts() == []
        assert srv.sched.check_conservation() == []
    for a, b in zip(outs[True], outs[False]):
        assert a == b


def test_server_preemption_under_page_pressure_completes_all():
    tnet = _tnet(5)
    rng = onp.random.RandomState(5)
    srv = serve.Server(tnet, _cfg(slots=3, page_size=4, pages=10,
                                  ladder=(8, 16), max_new=12))
    prompts = [list(rng.randint(1, 256, 7)) for _ in range(4)]
    with srv:
        rids = [srv.submit(p, max_new=10) for p in prompts]
        res = [srv.result(r, timeout=120) for r in rids]
    assert all(r["state"] == "done" and len(r["tokens"]) == 10
               for r in res)
    assert srv.sched.stats()["preemptions"] >= 1
    assert srv.sched.check_conservation() == []
    assert srv.sched.stats()["requests"] == 0


def test_server_cancel_and_single_delivery():
    tnet = _tnet(6)
    srv = serve.Server(tnet, _cfg())
    with srv:
        keep = srv.submit([1, 2, 3, 4, 5, 6], max_new=8)
        drop = srv.submit([6, 5, 4, 3, 2, 1], max_new=8)
        srv.cancel(drop)
        res_drop = srv.result(drop, timeout=120)
        res_keep = srv.result(keep, timeout=120)
        assert srv.result(keep, timeout=1) is None   # delivered once
    assert res_keep["state"] == "done" and len(res_keep["tokens"]) == 8
    assert res_drop["state"] in ("cancelled", "done")
    assert srv.sched.check_conservation() == []
    assert srv._results == {} and srv._prompts == {}


def test_server_rejects_bad_requests():
    srv = serve.Server(_tnet(7), _cfg())
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([])
    with pytest.raises(ValueError, match="max_new"):
        srv.submit([1, 2], max_new=0)
    with pytest.raises(ValueError, match="ladder"):
        srv.submit([1] * 33)
    with pytest.raises(ValueError, match="out of range"):
        srv.submit([1, 256])


def test_server_deadline_cancels_through_scheduler():
    srv = serve.Server(_tnet(8), _cfg())   # engine pumped by hand
    rid = srv.submit([1, 2, 3], max_new=4, deadline=0.0)
    srv.engine_step()
    with pytest.raises(serve.DeadlineExceededError):
        srv.result(rid, timeout=5)
    assert srv.sched.check_conservation() == []


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_server_engine_death_fails_waiters_fast():
    srv = serve.Server(_tnet(9), _cfg())
    boom = RuntimeError("injected engine fault")

    def _dead_step():
        raise boom

    srv.engine_step = _dead_step
    with srv:
        try:
            rid = srv.submit([1, 2, 3], max_new=4)
        except RuntimeError:
            rid = None  # engine died before the submit: also correct
        if rid is not None:
            with pytest.raises(RuntimeError) as ei:
                srv.result(rid, timeout=30)
            assert ei.value.__cause__ is boom
    with pytest.raises(RuntimeError):
        srv.submit([1], max_new=1)


def test_server_stop_wakes_blocked_result_waiters():
    srv = serve.Server(_tnet(10), _cfg())   # engine never started
    rid = srv.submit([1, 2, 3], max_new=4)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        req=srv.result(rid, timeout=30)))
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive()
    srv.stop()
    t.join(timeout=10)
    assert not t.is_alive(), "stop() left the waiter stranded"
    assert out["req"]["state"] == "waiting"


# ----------------------------------------------------------------------
# scheduler protocol (the cases of tests/test_serve.py, port edition)
# ----------------------------------------------------------------------
def _sched(**kw):
    args = dict(slots=2, pages=9, page_size=2, max_pages_per_slot=4)
    args.update(kw)
    return serve.SlotScheduler(**args)


def test_scheduler_lifecycle_and_conservation():
    s = _sched()
    rid = s.submit(3, 2)
    plan = s.admit_next()
    assert plan["rid"] == rid and plan["prefill_len"] == 3
    assert s.commit_prefill(plan, 7) is None
    snap = s.begin_step()
    assert [e["rid"] for e in snap] == [rid]
    assert s.commit_step(snap, [(9, False)]) == [rid]
    req = s.request(rid)
    assert req["state"] == "done" and req["tokens"] == (7, 9)
    assert s.check_conservation() == []
    assert s.stats()["free_pages"] == 8


def test_scheduler_stale_commit_dropped_by_epoch_check():
    s = _sched(slots=1)
    a = s.submit(3, 3)
    b = s.submit(3, 3)
    plan = s.admit_next()
    s.commit_prefill(plan, 7)
    snap = s.begin_step()          # decode in flight for A
    assert s.cancel(a)             # client gone: slot freed NOW
    plan_b = s.admit_next()        # B takes the same slot, new epoch
    assert plan_b["rid"] == b and plan_b["slot"] == snap[0]["slot"]
    assert plan_b["epoch"] != snap[0]["epoch"]
    s.commit_prefill(plan_b, 20)
    s.commit_step(snap, [(("stale", a), False)])
    assert s.request(b)["tokens"] == (20,)  # nothing crossed
    assert s.request(a)["state"] == "cancelled"
    assert s.check_conservation() == []


def test_scheduler_preempts_youngest_under_page_pressure():
    s = _sched(slots=2, pages=5, page_size=2, max_pages_per_slot=4)
    a = s.submit(4, 6)
    b = s.submit(4, 6)
    for _ in range(2):
        s.commit_prefill(s.admit_next(), 5)
    assert s.stats()["free_pages"] == 0
    snap = s.begin_step()
    assert [e["rid"] for e in snap] == [a]
    assert s.request(b)["state"] == "waiting"
    assert s.stats()["preemptions"] >= 1
    assert s.check_conservation() == []


@pytest.mark.parametrize("prefix", [False, True])
def test_scheduler_random_ops_conserve_pages_and_refs(prefix):
    rng = onp.random.RandomState(13 if prefix else 3)
    s = _sched(slots=3, pages=13 if prefix else 11, page_size=2,
               max_pages_per_slot=4)
    base = (3, 1, 4, 1, 5, 9)
    live = []
    for it in range(300):
        op = rng.randint(0, 5)
        if op == 0:
            plen = int(rng.randint(1, 7))
            prompt = None
            if prefix:
                prompt = (base[:plen] if rng.rand() < 0.7 else
                          tuple(int(x) for x in rng.randint(1, 50, plen)))
            live.append(s.submit(plen, int(rng.randint(1, 5)),
                                 prompt=prompt))
        elif op == 1 and live:
            s.cancel(live[rng.randint(len(live))])
        elif op == 2:
            plan = s.admit_next()
            if plan is not None and rng.rand() < 0.9:
                s.commit_prefill(plan, it)
        else:
            snap = s.begin_step()
            s.commit_step(snap, [(it, rng.rand() < 0.2) for _ in snap])
        assert s.check_conservation() == [], "iteration %d" % it
        assert s.check_refcounts() == [], "iteration %d" % it


def test_scheduler_failed_requests_stay_failed_and_do_not_block():
    s = _sched(slots=1, pages=13, page_size=2, max_pages_per_slot=4)
    big = s.submit(9, 2)           # 5 pages > budget of 4: unservable
    ok = s.submit(3, 2)
    plan = s.admit_next()
    assert plan is not None and plan["rid"] == ok
    assert s.request(big)["state"] == "failed"
    assert s.cancel(big) is False  # terminal stays terminal
    assert s.request(big)["state"] == "failed"
    assert s.check_conservation() == []


def test_scheduler_purge_bounds_request_state():
    s = _sched()
    rid = s.submit(3, 1)
    assert s.purge(rid) is None    # live: refused
    plan = s.admit_next()
    assert s.commit_prefill(plan, 7) == rid   # max_new=1: done
    purged = s.purge(rid)
    assert purged["state"] == "done" and purged["tokens"] == (7,)
    assert s.request(rid) is None and s.stats()["requests"] == 0
    assert s.purge(rid) is None
    assert s.check_conservation() == []


def test_scheduler_cap_filling_prompt_terminates():
    s = _sched(slots=1, pages=9, page_size=2, max_pages_per_slot=4)
    rid = s.submit(8, 4)           # 8 tokens == 4 pages * 2 == cap
    plan = s.admit_next()
    assert plan["prefill_len"] == 8
    assert s.commit_prefill(plan, 7) == rid
    req = s.request(rid)
    assert req["state"] == "done" and req["tokens"] == (7,)
    assert s.begin_step() == ()
    assert s.check_conservation() == []
    assert s.stats()["free_slots"] == 1


def test_scheduler_prefix_partial_hit_cows_and_conserves():
    s = _sched(slots=2, pages=9)
    a = s.submit(4, 2, prompt=(7, 8, 9, 10))
    plan_a = s.admit_next()
    assert plan_a["prefill_start"] == 0 and plan_a["cow"] is None
    s.commit_prefill(plan_a, 100)
    s.commit_step(s.begin_step(), [(101, False)])
    assert s.request(a)["state"] == "done"
    assert s.stats()["cached_pages"] == 2
    b = s.submit(3, 2, prompt=(7, 8, 9))
    plan_b = s.admit_next()
    assert plan_b["prefill_start"] == 2
    src, dst = plan_b["cow"]
    assert src != dst and dst in plan_b["pages"]
    assert src not in plan_b["pages"]
    assert s.check_refcounts() == []
    s.commit_prefill(plan_b, 200)
    s.commit_step(s.begin_step(), [(201, False)])
    assert s.request(b)["tokens"] == (200, 201)
    assert s.check_refcounts() == [] and s.check_conservation() == []


def test_scheduler_prefix_full_hit_cows_last_block():
    s = _sched(slots=2, pages=9)
    s.submit(4, 1, prompt=(7, 8, 9, 10))
    s.commit_prefill(s.admit_next(), 100)
    s.submit(4, 2, prompt=(7, 8, 9, 10))
    plan_b = s.admit_next()
    assert plan_b["prefill_start"] == 3     # plen-1: recompute last tok
    assert plan_b["cow"] is not None
    s.commit_prefill(plan_b, 200)
    assert s.check_refcounts() == [] and s.check_conservation() == []


def test_scheduler_prefix_eviction_only_at_zero_refs_when_dry():
    s = _sched(slots=2, pages=9)
    s.submit(4, 2, prompt=(7, 8, 9, 10))
    s.commit_prefill(s.admit_next(), 100)
    s.commit_step(s.begin_step(), [(101, False)])
    assert s.stats()["cached_pages"] == 2
    big = s.submit(7, 2)
    big2 = s.submit(7, 2)
    s.commit_prefill(s.admit_next(), 300)
    assert s.request(big)["state"] == "running"
    s.commit_prefill(s.admit_next(), 301)   # needed eviction
    assert s.request(big2)["state"] == "running"
    assert s.stats()["prefix_evictions"] >= 1
    assert s.check_refcounts() == [] and s.check_conservation() == []


# ----------------------------------------------------------------------
# import hygiene
# ----------------------------------------------------------------------
def test_package_imports_neither_jax_nor_mxnet_tpu():
    code = ("import sys, mxnet_tpu_torch; "
            "import mxnet_tpu_torch.serve, mxnet_tpu_torch.convert, "
            "mxnet_tpu_torch.autograd, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.gluon.trainer, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch.parallel.train_step, "
            "mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.parallel._compat, "
            "mxnet_tpu_torch.parallel.ring, mxnet_tpu_torch.parallel.moe, "
            "mxnet_tpu_torch.parallel.seq_data, "
            "mxnet_tpu_torch.parallel.sharding, "
            "mxnet_tpu_torch.parallel.pipeline, "
            "mxnet_tpu_torch.kvstore, mxnet_tpu_torch.kvstore.base, "
            "mxnet_tpu_torch.kvstore.kvstore, "
            "mxnet_tpu_torch.kvstore.compression, "
            "mxnet_tpu_torch.gluon.utils, "
            "mxnet_tpu_torch.utils.serialization, "
            "mxnet_tpu_torch.flightrec, mxnet_tpu_torch.profiler, "
            "mxnet_tpu_torch.telemetry, mxnet_tpu_torch.fault, "
            "mxnet_tpu_torch.fault_dist, mxnet_tpu_torch.serve_router, "
            "mxnet_tpu_torch.recordio, mxnet_tpu_torch._native, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.image, "
            "mxnet_tpu_torch.gluon.data, mxnet_tpu_torch.gluon.data.vision, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.gluon.metric; "
            "mxnet_tpu_torch.metric, mxnet_tpu_torch.gluon.data; "
            # chip_smoke.py and what its ring phase's and tensor-parallel
            # serving phase's rank children import
            "import chip_smoke; chip_smoke.ring_rank_modules(); "
            "from mxnet_tpu_torch import serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_source_has_no_jax_or_mxnet_tpu_import():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    found = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                found += ["%s: %s" % (f, n) for n in names
                          if n.split(".")[0] in ("jax", "jaxlib",
                                                 "mxnet_tpu")]
    assert found == []


def test_waiting_deadline_never_admitted_is_cancelled():
    """A request still queued when its deadline passes is cancelled
    from the queue (never prefilled)."""
    srv = serve.Server(_tnet(11), _cfg(slots=1))
    first = srv.submit([1, 2, 3], max_new=3)
    late = srv.submit([4, 5, 6], max_new=3, deadline=0.0)
    t0 = time.monotonic()
    while srv.sched.request(first) is not None and \
            time.monotonic() - t0 < 60:
        srv.engine_step()
    assert srv.result(first, timeout=5)["state"] == "done"
    with pytest.raises(serve.DeadlineExceededError):
        srv.result(late, timeout=5)
