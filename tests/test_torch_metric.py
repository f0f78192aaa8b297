"""``gluon.metric`` of the port against the JAX package: every
registered metric on the same seeded inputs, over several updates,
within 1e-6 relative; ``create`` by name, list and callable,
``CompositeEvalMetric``, ``CustomMetric`` / ``np``; and the port's
device accumulators: ``update`` reads nothing to the host (no ``item`` /
``cpu`` / ``tolist`` / ``numpy`` call), ``get()`` reads once.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import metric as jm
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import metric as tm

RTOL = 1e-6


def _inputs(kind, seed, n=12, k=5):
    """(labels, preds) numpy pairs for one update; probabilities for the
    classification metrics, distinct values (no top-k ties)."""
    rng = onp.random.RandomState(seed)
    if kind == "class":
        logits = rng.permutation(n * k).reshape(n, k).astype("float32")
        p = onp.exp((logits - logits.max(1, keepdims=True)) / (n * k / 4))
        return (rng.randint(0, k, n).astype("float32"),
                (p / p.sum(1, keepdims=True)).astype("float32"))
    if kind == "binary":
        return (rng.randint(0, 2, n).astype("float32"),
                rng.uniform(0, 1, n).astype("float32"))
    if kind == "binary2":
        p = rng.uniform(0, 1, (n, 1)).astype("float32")
        return (rng.randint(0, 2, n).astype("float32"),
                onp.concatenate([1 - p, p], 1))
    if kind == "seq":
        p = rng.uniform(0.01, 1, (2, 6, k)).astype("float32")
        return (rng.randint(0, k, (2, 6)).astype("float32"),
                (p / p.sum(-1, keepdims=True)).astype("float32"))
    return (rng.normal(0, 1, (n, 3)).astype("float32"),
            rng.normal(0, 1, (n, 3)).astype("float32"))


_CASES = [
    ("acc", {}, "class"), ("accuracy", {"axis": 1}, "class"),
    ("top_k_accuracy", {"top_k": 3}, "class"), ("f1", {}, "binary"),
    ("f1", {"average": "micro"}, "binary2"), ("mcc", {}, "binary"),
    ("mcc", {"average": "micro"}, "binary"), ("fbeta", {"beta": 2},
                                              "binary"),
    ("binaryaccuracy", {"threshold": 0.4}, "binary"), ("mae", {}, "reg"),
    ("mse", {}, "reg"), ("rmse", {}, "reg"), ("ce", {}, "class"),
    ("nll_loss", {}, "class"), ("perplexity", {}, "seq"),
    ("perplexity", {"ignore_label": 2}, "seq"), ("pearsonr", {}, "reg"),
    ("pcc", {}, "class"), ("meancosinesimilarity", {}, "reg"),
    ("loss", {}, "reg"),
]


@pytest.mark.parametrize("name,kw,kind", _CASES,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(_CASES)])
def test_metric_matches_the_reference(name, kw, kind):
    jmet, tmet = jm.create(name, **kw), tm.create(name, **kw)
    assert type(tmet).__name__ == type(jmet).__name__
    for seed in range(3):
        lab, pred = _inputs(kind, seed)
        jmet.update([mx.np.array(lab)], [mx.np.array(pred)])
        tmet.update([mt.nd.array(lab, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
    (jn, jv), (tn, tv) = jmet.get(), tmet.get()
    assert tn == jn
    onp.testing.assert_allclose(tv, jv, rtol=RTOL)
    assert tmet.num_inst == jmet.num_inst
    onp.testing.assert_allclose(tmet.sum_metric, jmet.sum_metric, rtol=RTOL)
    tmet.reset()
    jmet.reset()
    assert onp.isnan(tmet.get()[1]) and onp.isnan(jmet.get()[1])


def _reads(fn):
    names = ("item", "cpu", "tolist", "numpy")
    real = {n: getattr(torch.Tensor, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def counting(n):
        def call(self, *a, **k):
            counts[n] += 1
            return real[n](self, *a, **k)
        return call
    try:
        for n in names:
            setattr(torch.Tensor, n, counting(n))
        out = fn()
    finally:
        for n in names:
            setattr(torch.Tensor, n, real[n])
    return sum(counts.values()), out


@pytest.mark.parametrize("name,kw,kind", [c for c in _CASES
                                          if c[0] not in ("pearsonr",
                                                          "pcc")])
def test_update_reads_nothing_and_get_reads_once(name, kw, kind):
    met = tm.create(name, **kw)
    ins = [tuple(torch.from_numpy(a) for a in _inputs(kind, s))
           for s in range(4)]
    n, _ = _reads(lambda: [met.update([lab], [pred]) for lab, pred in ins])
    assert n == 0
    n, value = _reads(met.get)
    assert n <= 1 and onp.isfinite(value[1])


def test_create_composite_and_custom_match():
    lab, pred = _inputs("class", 4)

    def feval(label, p):
        return float((p.argmax(1) == label).sum()), label.shape[0]

    def run(m, arr):
        comp = m.create(["acc", "ce", m.create("top_k_acc", top_k=2)])
        comp.update([arr(lab)], [arr(pred)])
        custom = m.create(feval)
        custom.update([arr(lab)], [arr(pred)])
        npm = m.np(lambda a, b: float(abs(a - b.argmax(1)).sum()))
        npm.update([arr(lab)], [arr(pred)])
        return comp.get(), custom.get(), npm.get(), comp.get_metric(0).name
    want = run(jm, mx.np.array)
    got = run(tm, lambda a: mt.nd.array(a, ctx=mt.cpu()))
    assert got[0][0] == want[0][0] and got[3] == want[3]
    onp.testing.assert_allclose(got[0][1], want[0][1], rtol=RTOL)
    for g, w in zip(got[1:3], want[1:3]):
        assert g[0] == w[0]
        onp.testing.assert_allclose(g[1], w[1], rtol=RTOL)
    assert isinstance(mt.metric.Accuracy(), mt.gluon.metric.EvalMetric)
    with pytest.raises(KeyError):
        tm.create("no_such_metric")
