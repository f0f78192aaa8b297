"""The port's tensor-parallel serving replica, ``Server(net, cfg, mesh=)``.

Two gloo ranks on the CPU run the port's server once for the whole
module: this file is also their program (``python
tests/test_torch_serve_tp.py --rank R --world 2 --dir D``; the rank part
runs before the JAX imports below, so the ranks never import JAX).
They meet through a ``FileStore`` in a temporary directory, build the
same float32 ``tiny_config`` weights from a seeded numpy draw, and each
writes its results to one npz:

* greedy tokens of the one-rank server and of the ``tp=2`` server on the
  same weights and requests, with float32 and int8 weights, with
  ``n_kv_heads=1`` (which ``tp`` does not divide: the pools replicate),
  and through the prefix cache (the chunk program and a COW copy);
* prefill and decode logits of the model's tensor-parallel cache path
  against the one-rank path's;
* that ``stop()`` on the leader ends the follower's engine and that
  ``submit`` on a follower raises.

The tests then hold rank 0's tokens against the one-rank run's and
against the JAX package's ``Server(net, cfg, mesh=create_mesh(tp=2))``
on its virtual CPU devices (``tests/test_serve.py:768-795``; its
persistent-cache half has no port counterpart), and the logits within
1e-4.
"""
import os
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOGIT_TOL = 1e-4
SCFG = dict(slots=2, page_size=8, pages=24, ladder=(16,), max_new=6,
            prefix_cache=False)
#: server cases: name -> (config overrides, serve-config overrides)
CASES = {"fp32": ({}, {}), "int8": ({}, {"int8": True}),
         "kv1": ({"n_kv_heads": 1}, {}),
         "chunk": ({}, {"page_size": 4, "ladder": (8, 16, 32),
                        "prefix_cache": True})}


def weights(names_shapes, seed=7):
    """N(0, 0.2) float32 weights by name (norm gains 1), drawn in name
    order: the spread keeps greedy tokens far from ties."""
    rs = onp.random.RandomState(seed)
    return {n: (onp.ones(s, onp.float32) if n.endswith("gamma") else
                rs.normal(0, 0.2, s).astype(onp.float32))
            for n, s in sorted(names_shapes.items())}


def prompts(case, vocab=256):
    rs = onp.random.RandomState(3)
    if case == "chunk":
        shared = list(rs.randint(1, vocab, 9))
        # the last prompt is two cached pages whole: its recomputed last
        # token lands in a shared page, a copy-on-write
        return [shared + list(rs.randint(1, vocab, 2 + i))
                for i in range(2)] + [shared[:8]]
    return [list(rs.randint(1, vocab, int(rs.randint(3, 12))))
            for _ in range(3)]


# ----------------------------------------------------------------------
# the ranks' program (no JAX)
# ----------------------------------------------------------------------
def _serve(srv, ps, max_new=6):
    with srv:
        rids = [srv.submit(p, max_new=max_new) for p in ps]
        return [list(srv.result(r, timeout=120)["tokens"]) for r in rids]


def _cached_logits(net, scfg, mesh, prompt):
    """Prefill then two decode steps through a paged cache, called on
    the model directly: (prefill logits, decode logits)."""
    from mxnet_tpu_torch.models.kv_cache import CacheView, init_pools
    spec = scfg.cache_spec(net.cfg, mesh)
    k, v = init_pools(spec, "cpu")
    T, psz, MP = len(prompt), spec.page_size, spec.max_pages_per_slot
    row = torch.arange(1, MP + 1, dtype=torch.int32)
    with torch.no_grad():
        pre = net(torch.tensor([prompt + [0] * (16 - T)]), cache=CacheView(
            "prefill", k, v, psz, page_row=row, true_len=T))[0, :T]
        table = torch.zeros(spec.slots, MP, dtype=torch.int32)
        table[0] = row
        dec = []
        tok = int(pre[-1].argmax())
        for i in range(2):
            out = net(torch.tensor([[tok], [0]]), cache=CacheView(
                "decode", k, v, psz, page_table=table,
                lengths=torch.tensor([T + i, 0], dtype=torch.int32),
                active=torch.tensor([True, False])))[0, 0]
            dec.append(out)
            tok = int(out.argmax())
    return pre.numpy(), torch.stack(dec).numpy()


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel, serve
    from mxnet_tpu_torch.convert import load_params
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    res = {}

    def net_of(cfg):
        net = TransformerLM(cfg, device="cpu")
        shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
        return load_params(net, weights(shapes))

    with mt.cpu():
        mesh = parallel.create_mesh(tp=world)
        for case, (over, sover) in CASES.items():
            cfg = tiny_config(**over)
            scfg = serve.ServeConfig(**dict(SCFG, **sover))
            ps = prompts(case)
            res[case + "/one"] = onp.asarray(
                _serve(serve.Server(net_of(cfg), scfg), ps))
            srv = serve.Server(net_of(cfg), scfg, mesh=mesh)
            res[case + "/pool_heads"] = onp.int64(srv.pool.k_pages.shape[2])
            res[case + "/programs"] = onp.int64(srv.pool.stats["programs"])
            if srv.leader:
                res[case + "/tp"] = onp.asarray(_serve(srv, ps))
                res[case + "/prefix_hits"] = onp.int64(
                    srv.sched.stats()["prefix_hits"])
                for kind in ("decode", "prefill", "copy", "stop"):
                    res["%s/plans/%s" % (case, kind)] = onp.int64(
                        srv._plans.sent.get(kind, 0))
                res[case + "/conservation"] = onp.int64(
                    len(srv.sched.check_conservation()))
            else:
                try:
                    srv.submit(ps[0], max_new=2)
                    res[case + "/follower_submit"] = onp.str_("accepted")
                except RuntimeError as e:
                    res[case + "/follower_submit"] = onp.str_(str(e))
                srv.start()
                srv.stop()      # returns at the leader's stop plan
                res[case + "/follower_alive"] = onp.bool_(
                    srv._thread is not None and srv._thread.is_alive())
        cfg, scfg = tiny_config(), serve.ServeConfig(**SCFG)
        one = _cached_logits(net_of(cfg), scfg, None, prompts("fp32")[0])
        tp_net = net_of(cfg)
        parallel.shard_params(tp_net, mesh)
        tp = _cached_logits(tp_net, scfg, mesh, prompts("fp32")[0])
        for i, name in enumerate(("prefill", "decode")):
            res["logits/%s/one" % name] = one[i]
            res["logits/%s/tp" % name] = tp[i]
    res["imported_jax"] = onp.bool_(any(
        m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")
        for m in sys.modules))
    onp.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    _rank_main(int(args["--rank"]), int(args["--world"]), args["--dir"])
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (JAX from here on)
# ----------------------------------------------------------------------
import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu import serve as jserve  # noqa: E402
from mxnet_tpu.models import TransformerLM as JTransformerLM  # noqa: E402
from mxnet_tpu.models import tiny_config as j_tiny_config  # noqa: E402


def _spawn(out_dir, timeout=240):
    """Run the ranks; fail (and stop the others) if one fails."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(WORLD), "--dir", str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() - t0 > timeout:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, log[-4000:])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one run of the two ranks."""
    out_dir = tmp_path_factory.mktemp("ranks")
    _spawn(out_dir)
    return [dict(onp.load(out_dir / ("rank%d.npz" % r)))
            for r in range(WORLD)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_greedy_tokens_equal_one_rank_server(ranks, case):
    r0 = ranks[0]
    assert r0[case + "/tp"].tolist() == r0[case + "/one"].tolist()
    assert int(r0[case + "/conservation"]) == 0
    # the follower's one-rank run agrees too (same weights, same program)
    assert ranks[1][case + "/one"].tolist() == r0[case + "/one"].tolist()


def test_tp_greedy_tokens_equal_jax_tp_server(ranks):
    """The reference's sharded replica (``tests/test_serve.py:768``) on
    the same weights and requests."""
    jnet = JTransformerLM(j_tiny_config())
    jnet.initialize()
    params = jnet.collect_params()
    w = weights({k: tuple(p.shape) for k, p in params.items()})
    for k, p in params.items():
        p.set_data(w[k])
    scfg = jserve.ServeConfig(**dict(SCFG, cache_dir=None, int8=False))
    srv = jserve.Server(jnet, scfg, mesh=jpar.create_mesh(tp=2))
    with srv:
        rids = [srv.submit(p, max_new=6) for p in prompts("fp32")]
        want = [list(srv.result(r, timeout=120)["tokens"]) for r in rids]
    assert ranks[0]["fp32/tp"].tolist() == want


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_tp_cache_logits_within_tolerance_of_one_rank(ranks, phase):
    for r in ranks:
        got, want = r["logits/%s/tp" % phase], r["logits/%s/one" % phase]
        assert got.shape == want.shape and onp.isfinite(got).all()
        onp.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)


def test_pools_hold_each_ranks_kv_heads_or_replicate(ranks):
    for r in ranks:
        assert int(r["fp32/pool_heads"]) == 1      # 2 KV heads over tp=2
        assert int(r["kv1/pool_heads"]) == 1       # 1 KV head: replicated
        assert int(r["fp32/programs"]) == 0        # the CPU runs eagerly


def test_chunk_path_hits_the_prefix_cache(ranks):
    r0 = ranks[0]
    assert int(r0["chunk/prefix_hits"]) >= 2
    # every program the leader ran went to the follower as a plan, the
    # COW page copy included, then one stop
    assert int(r0["chunk/plans/copy"]) >= 1
    assert int(r0["fp32/plans/copy"]) == 0
    for case in CASES:
        assert int(r0[case + "/plans/prefill"]) == 3
        assert int(r0[case + "/plans/decode"]) >= 5
        assert int(r0[case + "/plans/stop"]) == 1


def test_follower_rejects_client_calls_and_stops_with_the_leader(ranks):
    for case in CASES:
        msg = str(ranks[1][case + "/follower_submit"])
        assert "follower rank" in msg and "leader" in msg
        assert not bool(ranks[1][case + "/follower_alive"])


def test_ranks_never_import_jax(ranks):
    assert not any(bool(r["imported_jax"]) for r in ranks)
