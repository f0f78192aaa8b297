"""The serving programs of the port's warm pool, on the CPU.

The sampler on device tensors: the same seed gives the same tokens, a
batched row samples as it would alone, temperature 0 and top_k = 1 are
the argmax, the top-k / top-p masks hold, distinct seeds decorrelate and
the noise is uniform.  Prefill and chunk with ``true_len`` / ``start``
as 0-dim device tensors give the logits and pools that Python ints give,
bit for bit.  The pool's static buffers: successive ``run_decode`` /
``run_prefill`` calls each equal a fresh pool's result.  Launches are
counted per graph replay (the capture itself is a card test, in
``test_torch_cuda.py``).  This file imports no JAX: the sampler's
streams are the port's own.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import serve
from mxnet_tpu_torch.models import (CacheSpec, CacheView, TransformerLM,
                                    init_pools, tiny_config)
from mxnet_tpu_torch.ops import cuda_ops


def _knobs(S, seed=0, step=0, temp=1.0, top_k=0, top_p=1.0):
    def full(v, dt):
        return torch.as_tensor(onp.broadcast_to(v, (S,)).copy(), dtype=dt)
    return (full(seed, torch.int64), full(step, torch.int64),
            full(temp, torch.float32), full(top_k, torch.int32),
            full(top_p, torch.float32))


def _logits(S, V=300, seed=0, scale=2.0):
    rng = onp.random.RandomState(seed)
    return torch.from_numpy((scale * rng.randn(S, V)).astype(onp.float32))


def test_same_seed_same_tokens_and_batched_equals_solo():
    logits = _logits(6)
    seeds = onp.arange(6) * 7 + 1
    knobs = _knobs(6, seed=seeds, step=onp.arange(6), temp=0.9, top_k=40,
                   top_p=0.95)
    a = serve._sample_batch(logits, *knobs)
    assert torch.equal(a, serve._sample_batch(logits, *knobs))
    for i in range(6):
        solo = serve._sample_batch(logits[i:i + 1],
                                   *(k[i:i + 1] for k in knobs))
        assert int(solo[0]) == int(a[i])


def test_temperature_zero_and_top_k_one_are_greedy():
    logits = _logits(5, seed=1)
    greedy = logits.argmax(dim=-1)
    for step in range(10):
        cold = serve._sample_batch(logits, *_knobs(5, seed=3, step=step,
                                                   temp=0.0))
        one = serve._sample_batch(logits, *_knobs(5, seed=3, step=step,
                                                  temp=1.5, top_k=1))
        assert torch.equal(cold, greedy) and torch.equal(one, greedy)
    # greedy slots beside sampled ones in one batch
    temps = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0])
    knobs = list(_knobs(5, seed=9))
    knobs[2] = temps
    mixed = serve._sample_batch(logits, *knobs)
    assert torch.equal(mixed[temps == 0], greedy[temps == 0])


def test_top_k_and_top_p_masks_hold():
    logits = _logits(4, V=50, seed=2, scale=1.0)
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(logits.gather(1, order), dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    for step in range(40):
        tok = serve._sample_batch(logits, *_knobs(4, seed=5, step=step,
                                                  top_k=3))
        rank = (order == tok[:, None]).float().argmax(dim=-1)
        assert (rank < 3).all()
        tok = serve._sample_batch(logits, *_knobs(4, seed=5, step=step,
                                                  top_p=0.5))
        rank = (order == tok[:, None]).float().argmax(dim=-1)
        assert (before.gather(1, rank[:, None])[:, 0] < 0.5).all()


def test_distinct_seeds_decorrelate_and_the_noise_is_uniform():
    n = 4096
    u = serve._uniforms(torch.arange(8), torch.zeros(8, dtype=torch.int64),
                        n)
    assert u.dtype == torch.float32 and u.shape == (8, n)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    hist = torch.histc(u.flatten(), bins=16, min=0.0, max=1.0)
    expect = 8 * n / 16
    chi2 = float(((hist - expect) ** 2 / expect).sum())
    assert chi2 < 45.0            # 15 dof: p < 1e-4 above this
    c = torch.corrcoef(u)
    assert float((c - torch.eye(8)).abs().max()) < 0.08
    steps = serve._uniforms(torch.full((8,), 3), torch.arange(8), n)
    c = torch.corrcoef(steps)
    assert float((c - torch.eye(8)).abs().max()) < 0.08
    flat = torch.zeros(2, 1000)
    a = [serve._sample_batch(flat, *_knobs(2, seed=[1, 2], step=s))
         for s in range(20)]
    a = torch.stack(a)
    assert not torch.equal(a[:, 0], a[:, 1])


def _net(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return TransformerLM(tiny_config(), device="cpu").initialize(gen,
                                                                 std=0.1)


def test_prefill_and_chunk_with_device_scalars_equal_python_ints():
    net = _net(1)
    cfg = net.cfg
    spec = CacheSpec(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.dim // cfg.n_heads, slots=2, pages=10,
                     page_size=4, max_pages_per_slot=4)
    toks = torch.from_numpy(onp.random.RandomState(1).randint(
        1, 256, (1, 8)).astype(onp.int32))
    row = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    outs = []
    for as_tensor in (False, True):
        k, v = init_pools(spec, "cpu")
        arg = (lambda n: torch.tensor(n, dtype=torch.int32)) if as_tensor \
            else (lambda n: n)
        with torch.no_grad():
            pre = net(toks, cache=CacheView("prefill", k, v, 4,
                                            page_row=row,
                                            true_len=arg(6)))
            chunk = net(toks[:, :5], cache=CacheView(
                "chunk", k, v, 4, page_row=row, true_len=arg(3),
                start=arg(6)))
        outs.append((pre, chunk, k, v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _pool(net, **kw):
    args = dict(slots=3, page_size=4, pages=16, ladder=(8, 16),
                max_new=6)
    args.update(kw)
    return serve.WarmPool(net, serve.ServeConfig(**args))


def _decode_inputs(seed, S=3, MP=6):
    rng = onp.random.RandomState(seed)
    table = rng.randint(1, 16, (S, MP)).astype(onp.int32)
    lengths = rng.randint(0, 12, S).astype(onp.int32)
    tokens = rng.randint(1, 256, S).astype(onp.int32)
    active = rng.rand(S) < 0.8
    sampling = [{"seed": int(rng.randint(100)), "step": int(rng.randint(9)),
                 "temperature": float(rng.choice([0.0, 0.8])),
                 "top_k": int(rng.choice([0, 5])), "top_p": 0.9}
                for _ in range(S)]
    return (table, lengths, tokens, active), sampling


def test_successive_run_calls_each_equal_a_fresh_pool():
    """Each call refills every static input: a pool that ran other
    inputs before gives what a fresh pool gives, tokens and pools."""
    net = _net(2)
    used = _pool(net)
    padded = onp.zeros(8, onp.int32)
    padded[:5] = [4, 8, 15, 16, 23]
    row = onp.array([2, 3, 0, 0, 0, 0], onp.int32)
    used.run_prefill(padded, row, 5, sampling={"seed": 1,
                                               "temperature": 0.7})
    for seed in (3, 4):
        inputs, sampling = _decode_inputs(seed)
        got = used.run_decode(*inputs, sampling=sampling)
        fresh = _pool(net)
        fresh.k_pages.copy_(used.k_pages)
        fresh.v_pages.copy_(used.v_pages)
        k0, v0 = used.k_pages.clone(), used.v_pages.clone()
        want = fresh.run_decode(*inputs, sampling=sampling)
        assert torch.equal(got, want)
        assert torch.equal(fresh.k_pages, used.k_pages)
        # the decode wrote its tokens: the pools moved
        used.k_pages.copy_(k0)
        used.v_pages.copy_(v0)
    first = used.run_prefill(padded, row, 5)
    second = used.run_prefill(padded[::-1].copy(), row, 8,
                              sampling={"seed": 2, "temperature": 1.0})
    fresh = _pool(net)
    assert fresh.run_prefill(padded[::-1].copy(), row, 8,
                             sampling={"seed": 2,
                                       "temperature": 1.0}) == second
    assert _pool(net).run_prefill(padded, row, 5) == first


def test_pool_stats_and_ladder_programs_on_the_cpu():
    pool = _pool(_net(3))
    assert pool.stats["programs"] == 0          # no graphs on the CPU
    assert pool.stats["int8"] is False and pool.stats["capture_s"] >= 0
    assert sorted(pool._prefill) == [8, 16] == sorted(pool._chunk)
    assert _pool(_net(3), prefix_cache=False)._chunk == {}
    with pytest.raises(ValueError, match="ladder"):
        pool.run_prefill(onp.zeros(12, onp.int32), onp.zeros(6, onp.int32),
                         3)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launches_are_counted_per_replay():
    cuda_ops.reset_launch_counts()
    g = _FakeGraph()
    counts = {"paged_decode": 2, "int8_linear": 15}
    for n in range(1, 4):
        cuda_ops.replay_graph(g, counts)
        assert g.replays == n
        assert cuda_ops.LAUNCHES["paged_decode"] == 2 * n
        assert cuda_ops.LAUNCHES["int8_linear"] == 15 * n
    prog = serve._Program(lambda: None, torch.device("cpu"))
    prog.graph, prog.launches = g, {"flash_fwd": 2}
    prog()
    assert cuda_ops.LAUNCHES["flash_fwd"] == 2 and g.replays == 4
    cuda_ops.reset_launch_counts()
