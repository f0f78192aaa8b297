"""The port's ``TransformerLM`` against the JAX package's, with the same
weights carried over by ``mxnet_tpu_torch.convert.load_params``.

fp32 ``tiny_config``: full-sequence logits, prefill and decode logits
through the paged cache.  The comparison is at rtol = atol = 1e-4, not
bitwise: the two frameworks reduce in different orders (and the JAX
package's own prefill-vs-forward bitwise claim no longer holds on this
toolchain).  A kernel-shaped slice (head_dim 64, page size 128, a
128-token prompt) makes the JAX side run BOTH of its Pallas kernels in
interpret mode, so the port's model is held against the kernels
themselves.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import _tape
from mxnet_tpu.models import CacheSpec as JCacheSpec
from mxnet_tpu.models import CacheView as JCacheView
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import init_pools as j_init_pools
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.gluon.nn import (BatchNorm, Conv2D, Dense, Embedding,
                                      RMSNorm)
from mxnet_tpu_torch.models import (CacheSpec, CacheView, TransformerBlock,
                                    TransformerLM, init_pools, tiny_config)
from mxnet_tpu_torch.models.bert import BERTModel, bert_tiny_config
from mxnet_tpu_torch.models.transformer import Attention, FeedForward
from mxnet_tpu_torch.ops import nn as tnn

TOL = 1e-4


def _pair(seed, **over):
    """A JAX net (seeded init) and the port's net with its weights."""
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config(**over))
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(**over), device="cpu"),
                       params)
    return jnet, tnet, params


def _j_forward(jnet, toks, view=None):
    with _tape.suspend_recording():
        return onp.asarray(jnet.forward(NDArray(jnp.asarray(toks)),
                                        cache=view)._data)


@torch.no_grad()
def _t_forward(tnet, toks, view=None):
    return tnet(torch.from_numpy(onp.asarray(toks)), cache=view).numpy()


def _specs(cfg, page_size, slots, pages, mp):
    kw = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.dim // cfg.n_heads, slots=slots, pages=pages,
              page_size=page_size, max_pages_per_slot=mp, dtype="float32")
    return JCacheSpec(**kw), CacheSpec(**kw)


def _prefill_decode(jnet, tnet, cfg, toks, T0, page_size, row, pages):
    """Prefill toks[:, :T0] into slot 0, then decode the rest one token
    at a time (slot 1 idle); returns per-step (jax, port) logits, the
    jax ones None when ``jnet`` is None."""
    S, mp = 2, len(row)
    jspec, tspec = _specs(cfg, page_size, S, pages, mp)
    jk, jv = j_init_pools(jspec)
    tk, tv = init_pools(tspec, "cpu")
    row = onp.asarray(row, onp.int32)
    jview = JCacheView("prefill", jk, jv, page_size,
                       page_row=jnp.asarray(row), true_len=jnp.int32(T0))
    tview = CacheView("prefill", tk, tv, page_size,
                      page_row=torch.from_numpy(row), true_len=T0)
    jout = None if jnet is None else \
        _j_forward(jnet, toks[:, :T0], jview)[0, :T0]
    outs = [(jout, _t_forward(tnet, toks[:, :T0], tview)[0, :T0])]
    jk, jv = jview.k, jview.v
    table = onp.zeros((S, mp), onp.int32)
    table[0] = row
    lengths = onp.array([T0, 0], onp.int32)
    active = onp.array([True, False])
    for t in range(T0, toks.shape[1]):
        step = onp.array([[toks[0, t]], [0]], onp.int32)
        jview = JCacheView("decode", jk, jv, page_size,
                           page_table=jnp.asarray(table),
                           lengths=jnp.asarray(lengths),
                           active=jnp.asarray(active))
        tview = CacheView("decode", tk, tv, page_size,
                          page_table=torch.from_numpy(table),
                          lengths=torch.from_numpy(lengths),
                          active=torch.from_numpy(active))
        jout = None if jnet is None else \
            _j_forward(jnet, step, jview)[0, 0]
        outs.append((jout, _t_forward(tnet, step, tview)[0, 0]))
        jk, jv = jview.k, jview.v
        lengths = lengths + active.astype(onp.int32)
    return outs


def test_full_forward_logits_match_jax():
    jnet, tnet, _ = _pair(0)
    toks = onp.random.RandomState(0).randint(0, 256, (2, 24)).astype(
        onp.int32)
    onp.testing.assert_allclose(_t_forward(tnet, toks),
                                _j_forward(jnet, toks), rtol=TOL, atol=TOL)


def test_prefill_and_decode_logits_match_jax():
    jnet, tnet, _ = _pair(1)
    cfg = tiny_config()
    toks = onp.random.RandomState(1).randint(0, 256, (1, 10)).astype(
        onp.int32)
    outs = _prefill_decode(jnet, tnet, cfg, toks, 6, 4, [3, 7, 1, 9], 12)
    assert len(outs) == 5      # prefill + 4 decode steps
    for want, got in outs:
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_kernel_shaped_slice_matches_jax_pallas_kernels(monkeypatch):
    """head_dim 64, page size 128, a 128-token prompt: the JAX prefill
    runs the Pallas flash kernel and its decode the Pallas paged kernel
    (interpret mode), the port their plain versions."""
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)
    over = dict(dim=256, n_heads=4, n_kv_heads=2, n_layers=2)
    jnet, tnet, _ = _pair(2, **over)
    cfg = tiny_config(**over)
    toks = onp.random.RandomState(2).randint(0, 256, (1, 130)).astype(
        onp.int32)
    outs = _prefill_decode(jnet, tnet, cfg, toks, 128, 128, [2, 5], 6)
    for want, got in outs:
        onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_chunk_prefill_logits_match_jax():
    """The prefix-cache path: prefill 10 tokens, then a chunk prefill of
    positions 8..13 that reads positions < 8 from the cached pages (and
    rewrites 8, 9 in place); logits against the JAX chunk program."""
    jnet, tnet, _ = _pair(10)
    cfg = tiny_config()
    toks = onp.random.RandomState(10).randint(0, 256, (1, 14)).astype(
        onp.int32)
    jspec, tspec = _specs(cfg, 4, 2, 12, 4)
    jk, jv = j_init_pools(jspec)
    tk, tv = init_pools(tspec, "cpu")
    row = onp.array([3, 7, 1, 9], onp.int32)
    jview = JCacheView("prefill", jk, jv, 4, page_row=jnp.asarray(row),
                       true_len=jnp.int32(10))
    _j_forward(jnet, toks[:, :10], jview)
    _t_forward(tnet, toks[:, :10], CacheView(
        "prefill", tk, tv, 4, page_row=torch.from_numpy(row), true_len=10))
    chunk = onp.zeros((1, 8), onp.int32)          # 6 real + 2 padding
    chunk[0, :6] = toks[0, 8:14]
    jview = JCacheView("chunk", jview.k, jview.v, 4,
                       page_row=jnp.asarray(row), true_len=jnp.int32(6),
                       start=jnp.int32(8))
    want = _j_forward(jnet, chunk, jview)[0, :6]
    got = _t_forward(tnet, chunk, CacheView(
        "chunk", tk, tv, 4, page_row=torch.from_numpy(row), true_len=6,
        start=8))[0, :6]
    onp.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the pools the chunk left behind agree too (trash page 0 aside)
    onp.testing.assert_allclose(tk.numpy()[:, 1:],
                                onp.asarray(jview.k)[:, 1:], rtol=TOL,
                                atol=TOL)


@pytest.mark.parametrize("which", ["prompt", "chunk", "token"])
def test_kv_cache_writes_match_jax(which):
    """The in-place ``write_*`` against the JAX functional updates,
    padding and inactive slots routed to the trash page included."""
    from mxnet_tpu.models import kv_cache as jkvc
    from mxnet_tpu_torch.models import kv_cache as tkvc
    rng = onp.random.RandomState(11)
    L, P, Hkv, psz, D, layer = 2, 8, 2, 4, 3, 1
    pool = rng.randn(L, P, Hkv, psz, D).astype(onp.float32)
    tpool = torch.from_numpy(pool.copy())
    if which == "token":
        table = rng.permutation(onp.arange(1, P))[:6].reshape(2, 3)
        table = table.astype(onp.int32)
        lengths = onp.array([5, 2], onp.int32)
        active = onp.array([True, False])
        kv = rng.randn(2, Hkv, D).astype(onp.float32)
        want = jkvc.write_token(jnp.asarray(pool), layer,
                                jnp.asarray(table), jnp.asarray(lengths),
                                jnp.asarray(kv), jnp.asarray(active), psz)
        tkvc.write_token(tpool, layer, torch.from_numpy(table),
                         torch.from_numpy(lengths), torch.from_numpy(kv),
                         torch.from_numpy(active), psz)
    else:
        row = onp.array([5, 2, 6], onp.int32)
        kv = rng.randn(7, Hkv, D).astype(onp.float32)   # 5 real tokens
        args = (jnp.asarray(row), jnp.asarray(kv), 5, psz)
        targs = (torch.from_numpy(row), torch.from_numpy(kv), 5, psz)
        if which == "prompt":
            want = jkvc.write_prompt(jnp.asarray(pool), layer, *args)
            tkvc.write_prompt(tpool, layer, *targs)
        else:
            want = jkvc.write_chunk(jnp.asarray(pool), layer, *args, 3)
            tkvc.write_chunk(tpool, layer, *targs, 3)
    want = onp.asarray(want)
    # real tokens land exactly; the trash page takes whatever collides
    assert onp.array_equal(tpool.numpy()[:, 1:], want[:, 1:])
    assert not onp.array_equal(tpool.numpy(), pool)


def test_dot_product_attention_matches_jax():
    from mxnet_tpu.ops.nn import dot_product_attention as j_dpa
    rng = onp.random.RandomState(12)
    q = rng.randn(1, 2, 5, 8).astype(onp.float32)
    k = rng.randn(1, 2, 7, 8).astype(onp.float32)
    v = rng.randn(1, 2, 7, 8).astype(onp.float32)
    want = onp.asarray(j_dpa(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=True))
    got = tnn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=True)
    onp.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_paged_equals_contiguous_bit_for_bit():
    """Within the port: 4-token pages scattered over the pool and one
    slot-sized page of the same capacity (12 positions either way) give
    identical bits -- paging is a layout change."""
    _, tnet, _ = _pair(3)
    cfg = tiny_config()
    toks = onp.random.RandomState(3).randint(0, 256, (1, 12)).astype(
        onp.int32)
    runs = []
    for page_size, row in ((4, [5, 1, 9]), (12, [1])):
        outs = _prefill_decode(None, tnet, cfg, toks, 4, page_size,
                               row, 12)
        runs.append(onp.stack([got for _, got in outs[1:]]))
    assert onp.array_equal(runs[0], runs[1])


def test_prefill_logits_equal_full_forward():
    _, tnet, _ = _pair(4)
    cfg = tiny_config()
    toks = onp.random.RandomState(4).randint(0, 256, (1, 9)).astype(
        onp.int32)
    full = _t_forward(tnet, toks)
    outs = _prefill_decode(None, tnet, cfg, toks, 5, 4, [1, 2, 3], 6)
    onp.testing.assert_allclose(outs[0][1], full[0, :5], rtol=TOL, atol=TOL)
    for i, (_, got) in enumerate(outs[1:]):
        onp.testing.assert_allclose(got, full[0, 5 + i], rtol=TOL, atol=TOL)


def test_rms_norm_keeps_jax_rounding_order():
    from mxnet_tpu.ops.nn import rms_norm as j_rms_norm
    rng = onp.random.RandomState(6)
    x = rng.randn(3, 64).astype(onp.float32)
    g = rng.rand(64).astype(onp.float32)
    want = onp.asarray(j_rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(g, jnp.bfloat16), eps=1e-5)
                       .astype(jnp.float32))
    got = tnn.rms_norm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(g).bfloat16(), eps=1e-5)
    assert got.dtype == torch.bfloat16
    onp.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                atol=1e-2)


def test_state_dict_keys_equal_jax_param_names():
    _, tnet, params = _pair(7)
    assert sorted(tnet.state_dict()) == sorted(params)
    assert tuple(tnet.layer0.attention.wk.weight.shape) == \
        params["layer0.attention.wk.weight"].shape


def test_load_params_rejects_missing_extra_and_misshaped():
    _, tnet, params = _pair(8)
    bad = dict(params)
    bad.pop("norm.gamma")
    with pytest.raises(KeyError, match="norm.gamma"):
        load_params(tnet, bad)
    with pytest.raises(KeyError, match="bogus"):
        load_params(tnet, dict(params, bogus=onp.zeros(1)))
    with pytest.raises(ValueError, match="output.weight"):
        load_params(tnet, dict(params, **{"output.weight":
                                          onp.zeros((3, 3))}))


def test_load_params_takes_bf16_jax_weights_exactly():
    """A bf16 JAX net exports ml_dtypes bfloat16 arrays; they load into
    the port's bf16 weights bit for bit, norm gains stay float32."""
    mx.np.random.seed(9)
    jnet = JTransformerLM(j_tiny_config(dtype="bfloat16"))
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(dtype="bfloat16"),
                                     device="cpu"), params)
    for name, p in tnet.named_parameters():
        want = params[name].astype(onp.float32)
        assert p.dtype == (torch.float32 if name.endswith("gamma")
                           else torch.bfloat16)
        assert onp.array_equal(p.detach().float().numpy(), want), name


def test_unknown_attn_impl_is_refused():
    with pytest.raises(ValueError, match="attn_impl"):
        TransformerLM(tiny_config(attn_impl="sparse"), device="cpu")


def test_dense_attention_logits_and_grads_match_jax_dense_model():
    """``attn_impl="dense"``: the plain causal attention over repeated KV
    heads (GQA 4 / 2), logits and every parameter's grad of a random
    projection of the logits against the JAX dense model, to 1e-5."""
    jnet, tnet, _ = _pair(30, attn_impl="dense")
    toks = onp.random.RandomState(30).randint(0, 256, (2, 12)).astype(
        onp.int32)
    w = onp.random.RandomState(31).randn(2, 12, 256).astype(onp.float32)
    with mx.autograd.record():
        jlogits = jnet(NDArray(jnp.asarray(toks)))
        jloss = (jlogits * NDArray(jnp.asarray(w))).mean()
    jloss.backward()
    tlogits = tnet(torch.from_numpy(toks))
    (tlogits * torch.from_numpy(w)).mean().backward()
    onp.testing.assert_allclose(tlogits.detach().numpy(),
                                onp.asarray(jlogits._data), rtol=1e-5,
                                atol=1e-5)
    jparams = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        onp.testing.assert_allclose(
            p.grad.numpy(), onp.asarray(jparams[name].grad()._data),
            rtol=1e-5, atol=1e-5, err_msg=name)


def test_dense_and_flash_models_agree_and_cache_paths_ignore_attn_impl():
    """The dense and flash models compute one function (the CPU's flash
    wrapper runs the plain attention), and a dense model's serving
    prefill, which stays on the flash path, equals the flash model's."""
    _, tdense, params = _pair(32, attn_impl="dense")
    tflash = load_params(TransformerLM(tiny_config(), device="cpu"),
                         params)
    toks = onp.random.RandomState(32).randint(0, 256, (1, 9)).astype(
        onp.int32)
    onp.testing.assert_allclose(_t_forward(tdense, toks),
                                _t_forward(tflash, toks), rtol=1e-5,
                                atol=1e-5)
    cfg = tiny_config()
    outs = [_prefill_decode(None, net, cfg, toks, 6, 4, [1, 2, 3], 8)
            for net in (tdense, tflash)]
    for (_, a), (_, b) in zip(*outs):
        assert onp.array_equal(a, b)


def test_default_device_is_cuda_and_raises_without_card():
    from mxnet_tpu_torch import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(tiny_config())
    assert resolve_device("cpu").type == "cpu"


# every public entry point that allocates: device=None means CUDA.  A
# Gluon layer allocates in ``initialize``; ``TransformerLM`` initializes
# itself on the device its constructor is given
_ENTRY_POINTS = {
    "Dense": lambda device: Dense(4, in_units=4).initialize(device=device),
    "Embedding": lambda device: Embedding(8, 4).initialize(device=device),
    "RMSNorm": lambda device: RMSNorm(4).initialize(device=device),
    "Conv2D": lambda device: Conv2D(4, 3, in_channels=2).initialize(
        device=device),
    "BatchNorm": lambda device: BatchNorm(in_channels=4).initialize(
        device=device),
    "BERTModel": lambda device: BERTModel(bert_tiny_config()).initialize(
        device=device),
    "Attention": lambda device: Attention(tiny_config()).initialize(
        device=device),
    "FeedForward": lambda device: FeedForward(tiny_config()).initialize(
        device=device),
    "TransformerBlock": lambda device: TransformerBlock(
        tiny_config()).initialize(device=device),
    "TransformerLM": lambda device: TransformerLM(tiny_config(),
                                                  device=device),
    "init_pools": lambda device: init_pools(
        _specs(tiny_config(), 4, 2, 6, 3)[1], device),
}


def _tensors(built):
    if isinstance(built, torch.nn.Module):
        return list(built.parameters())
    return list(built)


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_cuda(name):
    make = _ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in _tensors(make(None)))
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        make(None)


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_builds_on_cpu_when_asked(name):
    built = _tensors(_ENTRY_POINTS[name]("cpu"))
    assert built and all(t.device.type == "cpu" for t in built)
