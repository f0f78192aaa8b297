"""The decode's grouped int8 products, on the CPU: ``int8_linear_group``
(weights stacked by rows, one launch on the card) and the serving
layers that share one (``serve._int8_layers``: wq, wk, wv and w1, w3 of
a block).  On the CPU each result is its weight's plain product, so the
grouped decode must give the ungrouped one's bits.  No JAX.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import serve
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.models import TransformerLM, tiny_config
from mxnet_tpu_torch.ops import int8 as i8


def _weights(rows, K, seed):
    rs = onp.random.RandomState(seed)
    q = torch.from_numpy(rs.randint(-127, 128, (sum(rows), K))
                         .astype(onp.int8))
    scales = [float(s) for s in rs.uniform(1e-4, 1e-2, len(rows))]
    return q, scales


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(48,), (40, 8), (64, 16, 16), (3, 1, 5)])
def test_group_plain_is_each_weights_product(rows, dtype):
    q, scales = _weights(rows, 32, len(rows))
    x = torch.randn(5, 32, generator=torch.Generator().manual_seed(1)).to(
        dtype)
    ys = i8.int8_linear_group(x, q, rows, scales)
    assert len(ys) == len(rows)
    r0 = 0
    for r, s, y in zip(rows, scales, ys):
        assert y.shape == (5, r) and y.dtype == dtype
        assert torch.equal(y, i8.int8_linear_plain(x, q[r0:r0 + r], s))
        r0 += r
    if len(rows) == 1:
        assert torch.equal(ys[0], i8.int8_linear(x, q, scales[0]))


@pytest.mark.parametrize("rows, n_scales", [((4, 4), 2), ((3, 3, 3, 3), 4),
                                            ((12, 0), 2), ((6, 6), 1)])
def test_group_refuses_rows_that_do_not_split_q(rows, n_scales):
    q = torch.zeros(12, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="rows"):
        i8.int8_linear_group(torch.zeros(2, 16), q, rows,
                             [1.0] * n_scales)


def _net(layers=2):
    net = TransformerLM(tiny_config(n_layers=layers), device="cpu")
    net.initialize(torch.Generator().manual_seed(0), std=0.2)
    return net


def test_int8_layers_stack_the_products_that_read_one_input():
    """Each block's wq, wk, wv and w1, w3 share one stacked tensor, each
    layer's weight the block of its rows, with the bits and scale it
    has alone; wo, w2 and the head stay alone."""
    net = _net()
    layers = serve._int8_layers(net)
    ps = {k: p.detach() for k, p in net.collect_params().items()}
    q, scales = serve.quantize_weights(ps)
    by_layer = {m: n for n, m in net.named_modules()}
    groups = {w.group for w in layers.values()} - {None}
    assert len(groups) == 2 * net.cfg.n_layers
    for layer, w in layers.items():
        name = by_layer[layer] + ".weight"
        assert torch.equal(w.q, q[name]) and w.scale == scales[name]
        leaf = by_layer[layer].split(".")[-1]
        if leaf in ("wo", "w2", "output"):
            assert w.group is None
            continue
        g = w.group
        assert leaf in ("wq", "wk", "wv", "w1", "w3") and layer in g.layers
        i = g.layers.index(layer)
        r0 = sum(g.rows[:i])
        assert w.q.data_ptr() == g.q[r0].data_ptr()
        assert g.scales[i] == w.scale and g.rows[i] == w.q.shape[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_decode_gives_the_ungrouped_bits(dtype, monkeypatch):
    """Under the decode scope a block launches one product for wq, wk, wv
    and one for w1, w3 (4 a block and the head's), and the logits are
    the ungrouped layers' bit for bit."""
    net = TransformerLM(tiny_config(n_layers=2, dtype=dtype), device="cpu")
    net.initialize(torch.Generator().manual_seed(0), std=0.2)
    layers = serve._int8_layers(net)
    alone = {m: qz.Int8Weight(w.q.clone(), w.scale, w.dtype)
             for m, w in layers.items()}
    calls = []
    group, single = qz.int8_linear_group, qz.int8_linear
    monkeypatch.setattr(qz, "int8_linear_group", lambda *a: calls.append(
        "group") or group(*a))
    monkeypatch.setattr(qz, "int8_linear", lambda *a: calls.append(
        "single") or single(*a))
    toks = torch.from_numpy(onp.random.RandomState(3).randint(
        0, 256, (2, 5)).astype(onp.int32))
    with torch.no_grad():
        with qz.int8_weights(layers, "decode"):
            got = net(toks)
        n = len(calls)
        with qz.int8_weights(alone, "decode"):
            want = net(toks)
    assert calls[:n].count("group") == 2 * net.cfg.n_layers
    assert calls[:n].count("single") == 2 * net.cfg.n_layers + 1
    assert calls[n:] == ["single"] * (7 * net.cfg.n_layers + 1)
    assert torch.equal(got, want)
