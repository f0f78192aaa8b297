"""The port's int8 weight path of serving against the JAX package's.

``quantize_weights`` gives the JAX package's int8 arrays and scales bit
for bit, excluding the same names; ``_dequant`` rounds as the JAX one
does, in float32 and bfloat16; the plain ``int8_linear`` equals the JAX
``_dequant`` + dot; an int8 ``Server`` emits the JAX ``Server(int8=True)``
greedy tokens (tiny_config, float32, guarded against near-ties); and
``ServeConfig(int8=)`` / ``MXNET_SERVE_INT8`` read as the JAX ones do.
"""
import threading

import ml_dtypes
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
from mxnet_tpu_torch.contrib.quantization import int8_forward, int8_weights
from mxnet_tpu_torch.convert import load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config
from mxnet_tpu_torch.ops.int8 import int8_linear, int8_linear_plain

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _params(seed, std=0.2):
    """The JAX tiny_config net and its parameters as numpy."""
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config())
    jnet.initialize(mx.init.Normal(std))
    return jnet, {k: onp.asarray(p.data()._data)
                  for k, p in jnet.collect_params().items()}


def _as_torch(arr):
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.astype(onp.float32)).bfloat16()
    return torch.from_numpy(onp.array(arr))


def _as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_matches_jax_bit_for_bit(dtype):
    _, params = _params(1)
    params = {k: v.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                          else onp.float32) for k, v in params.items()}
    jq, jscales = jserve.quantize_weights(
        {k: jnp.asarray(v) for k, v in params.items()})
    tq, tscales = serve.quantize_weights(
        {k: _as_torch(v) for k, v in params.items()})
    assert sorted(tscales) == sorted(jscales)
    assert not any("tok_embeddings" in k or "gamma" in k for k in tscales)
    assert "output.weight" in tscales
    for k in params:
        if k in jscales:
            assert tscales[k] == jscales[k], k
            assert tq[k].dtype == torch.int8
            assert onp.array_equal(tq[k].numpy(), onp.asarray(jq[k])), k
        else:
            assert onp.array_equal(_as_numpy(tq[k]), params[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matches_jax_bit_for_bit(dtype):
    _, params = _params(2)
    jq, jscales = jserve.quantize_weights(
        {k: jnp.asarray(v) for k, v in params.items()})
    tq, tscales = serve.quantize_weights(
        {k: torch.from_numpy(onp.array(v)) for k, v in params.items()})
    jd = jserve._dequant(jq, jscales, jnp.dtype(dtype))
    td = serve._dequant(tq, tscales, TORCH_DTYPES[dtype])
    for k in jscales:
        assert td[k].dtype == TORCH_DTYPES[dtype]
        got = td[k].float().numpy()
        want = onp.asarray(jd[k]).astype(onp.float32)
        assert onp.array_equal(got, want), k


@pytest.mark.parametrize("M,N,K", [(1, 7, 33), (8, 64, 128), (17, 40, 64)])
def test_plain_int8_linear_equals_jax_dequant_dot(M, N, K):
    rng = onp.random.RandomState(M * 100 + K)
    w = rng.randn(N, K).astype(onp.float32)
    x = rng.randn(M, K).astype(onp.float32)
    jq, jscales = jserve.quantize_weights({"w": jnp.asarray(w)})
    want = onp.asarray(jnp.asarray(x) @ jserve._dequant(
        jq, jscales, jnp.float32)["w"].T)
    tq, tscales = serve.quantize_weights({"w": torch.from_numpy(w)})
    got = int8_linear(torch.from_numpy(x), tq["w"], tscales["w"])
    assert got.shape == (M, N) and got.dtype == torch.float32
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, int8_linear_plain(torch.from_numpy(x), tq["w"],
                                              tscales["w"]))


def test_int8_linear_refuses_what_it_does_not_take():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="not"):
        int8_linear(x, torch.zeros(3, 9, dtype=torch.int8), 1.0)
    with pytest.raises(TypeError, match="int8"):
        int8_linear(x, torch.zeros(3, 8), 1.0)


def _serve_all(srv, prompts, budgets):
    with srv:
        rids = [srv.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
        return [srv.result(r, timeout=120)["tokens"] for r in rids]


def test_int8_server_greedy_tokens_match_jax_int8_server():
    jnet, params = _params(3)
    rng = onp.random.RandomState(21)
    prompts = [list(rng.randint(1, 256, int(rng.randint(3, 14))))
               for _ in range(4)]
    budgets = [6, 4, 7, 5]
    # one ladder rung and no prefix cache: the fewest JAX programs to
    # compile (decode, one prefill, the page copy)
    kw = dict(slots=3, page_size=8, pages=24, ladder=(16,), max_new=10,
              prefix_cache=False, int8=True)
    jsrv = jserve.Server(jnet, jserve.ServeConfig(cache_dir=None, **kw))
    assert jsrv.pool.stats["int8"]
    want = _serve_all(jsrv, prompts, budgets)
    # tie guard: the top-2 gap of the JAX full forward with the
    # dequantized weights at every generated position
    ps = jnet.collect_params()
    deq = jserve._dequant(jsrv.pool.params, jsrv.pool.scales, jnp.float32)
    for p, toks in zip(prompts, want):
        seq = onp.asarray([p + list(toks[:-1])], onp.int32)
        with _tape.suspend_recording(), jserve._swapped_params(ps, deq):
            logits = onp.asarray(jnet.forward(NDArray(jnp.asarray(seq)))
                                 ._data)[0, len(p) - 1:]
        top2 = onp.sort(logits, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3
    tnet = load_params(TransformerLM(tiny_config(), device="cpu"), params)
    tsrv = serve.Server(tnet, serve.ServeConfig(**kw))
    assert tsrv.pool.stats["int8"] and tsrv.pool.stats["programs"] == 0
    assert _serve_all(tsrv, prompts, budgets) == [tuple(t) for t in want]


def test_int8_scope_leaves_the_net_and_other_threads_alone():
    """The same net serves its own dtype and int8: the scope only changes
    the Dense layers it names, on this thread, and the parameters stay;
    the decode route (the kernel's plain version on the CPU) and the
    prefill route (dequantize, then one product) agree."""
    _, params = _params(4)
    net = load_params(TransformerLM(tiny_config(), device="cpu"), params)
    layers = serve._int8_layers(net)
    assert len(layers) == 7 * 2 + 1
    toks = torch.from_numpy(onp.random.RandomState(4).randint(
        0, 256, (2, 5)).astype(onp.int32))
    with torch.no_grad():
        plain = net(toks)
        with int8_weights(layers, "decode"):
            dec = net(toks)
            other = {}
            t = threading.Thread(target=lambda: other.update(y=net(toks)))
            t.start()
            t.join()
        with int8_weights(layers, "prefill"):
            pre = net(toks)
        again = net(toks)
    assert torch.equal(plain, again)
    assert torch.equal(plain, other["y"].detach())
    assert not torch.equal(plain, dec)
    torch.testing.assert_close(dec, pre, rtol=1e-6, atol=1e-6)
    for k, v in net.collect_params().items():
        assert onp.array_equal(v.detach().numpy(), params[k]), k
    assert int8_forward(net.output, torch.zeros(1, 64), None, False) is None
    with pytest.raises(ValueError, match="route"):
        with int8_weights(layers, "chunk"):
            pass


@pytest.mark.parametrize("env,arg", [(None, None), ("1", None),
                                     ("0", None), ("false", None),
                                     ("", None), ("1", False),
                                     (None, True)])
def test_serve_config_int8_reads_as_jax(monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv("MXNET_SERVE_INT8", raising=False)
    else:
        monkeypatch.setenv("MXNET_SERVE_INT8", env)
    want = jserve.ServeConfig(int8=arg).int8
    assert serve.ServeConfig(int8=arg).int8 is want
