"""The port's Gluon losses against the JAX package's: the 11 losses this
port added beside L2 / L1 / softmax CE, each on the same numpy inputs
(made from a seed) through both packages, every option and the shape
rules (``_reshape_like``: a label of another shape with the same size
is reshaped like the prediction), the per-sample values and the
gradients of their sum with respect to every float input, at 1e-5 of
the largest value (float32 in both).
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.gluon import loss as tloss

TOL = 1e-5


def _rs(seed):
    return onp.random.RandomState(seed)


def _arrays(seed):
    rs = _rs(seed)
    f = lambda *s: rs.normal(0, 1, s).astype("float32")  # noqa: E731
    prob = lambda *s: rs.uniform(0.05, 0.95, s).astype("float32")  # noqa
    return {
        "pred": f(4, 5), "pred3": f(4, 3, 5), "bin": (rs.uniform(size=(4, 5))
                                                      > 0.5).astype("float32"),
        "bin_flat": (rs.uniform(size=(20,)) > 0.5).astype("float32"),
        "prob": prob(4, 5), "signed": onp.sign(f(4, 5)).astype("float32"),
        "label": f(4, 5), "sw": rs.uniform(0.5, 1.5, (4, 1)).astype(
            "float32"),
        "posw": rs.uniform(0.5, 2.0, (5,)).astype("float32"),
        "dist": (lambda a: a / a.sum(-1, keepdims=True))(prob(4, 5)),
        "logp": onp.log((lambda a: a / a.sum(-1, keepdims=True))(prob(4, 5))),
        "pos": f(4, 6), "neg": f(4, 6), "anchor": f(4, 6),
        "counts": rs.poisson(2.0, (4, 5)).astype("float32"),
        "rate": rs.uniform(0.5, 3.0, (4, 5)).astype("float32"),
        "x1": f(4, 6), "x2": f(4, 6), "x1_flat": f(4, 2, 3),
        "cos_label": onp.array([1, -1, 1, -1], "float32"),
        "s1": f(5, 4), "s2": f(5, 4),
    }


# name -> (class name, constructor kwargs, positional inputs (names of
# _arrays), keyword inputs, indices of the inputs to differentiate)
CASES = {
    "sbce": ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "bin"), {}, (0,)),
    "sbce_alias_flat_label": ("SigmoidBCELoss", {}, ("pred", "bin_flat"),
                              {}, (0,)),
    "sbce_pos_weight": ("SigmoidBCELoss", {}, ("pred", "bin"),
                        {"pos_weight": "posw"}, (0,)),
    "sbce_from_sigmoid": ("SigmoidBCELoss", {"from_sigmoid": True},
                          ("prob", "bin"), {}, (0,)),
    "sbce_from_sigmoid_pos_weight": ("SigmoidBCELoss",
                                     {"from_sigmoid": True},
                                     ("prob", "bin"),
                                     {"pos_weight": "posw"}, (0,)),
    "sbce_weights": ("SigmoidBCELoss", {"weight": 0.7}, ("pred", "bin"),
                     {"sample_weight": "sw"}, (0,)),
    "kldiv": ("KLDivLoss", {}, ("logp", "dist"), {}, (0,)),
    "kldiv_logits_axis0": ("KLDivLoss", {"from_logits": False, "axis": 0},
                           ("pred", "dist"), {}, (0,)),
    "kldiv_batch_axis1": ("KLDivLoss", {"batch_axis": 1, "weight": 2.0},
                          ("logp", "dist"), {}, (0,)),
    "huber": ("HuberLoss", {}, ("pred", "label"), {}, (0, 1)),
    "huber_rho": ("HuberLoss", {"rho": 0.3, "weight": 0.5},
                  ("pred", "label"), {"sample_weight": "sw"}, (0, 1)),
    "hinge": ("HingeLoss", {}, ("pred", "signed"), {}, (0,)),
    "hinge_margin": ("HingeLoss", {"margin": 2.5, "batch_axis": 1},
                     ("pred", "signed"), {}, (0,)),
    "sq_hinge": ("SquaredHingeLoss", {}, ("pred", "signed"), {}, (0,)),
    "sq_hinge_margin": ("SquaredHingeLoss", {"margin": 0.5, "weight": 3.0},
                        ("pred", "signed"), {"sample_weight": "sw"}, (0,)),
    "logistic_signed": ("LogisticLoss", {}, ("pred", "signed"), {}, (0,)),
    "logistic_binary": ("LogisticLoss", {"label_format": "binary"},
                        ("pred", "bin"), {}, (0,)),
    "triplet": ("TripletLoss", {}, ("anchor", "pos", "neg"), {}, (0, 1, 2)),
    "triplet_margin_3d": ("TripletLoss", {"margin": 0.2, "weight": 0.5},
                          ("pred3", "pred3", "pred3"), {}, (0,)),
    "poisson_logits": ("PoissonNLLLoss", {}, ("pred", "counts"), {}, (0,)),
    "poisson_rate_full": ("PoissonNLLLoss", {"from_logits": False,
                                             "compute_full": True},
                          ("rate", "counts"), {}, (0,)),
    "poisson_weights_eps": ("PoissonNLLLoss", {"from_logits": False,
                                               "weight": 0.5},
                            ("rate", "counts"), {"sample_weight": "sw",
                                                 "epsilon": 1e-3}, (0,)),
    "cosine": ("CosineEmbeddingLoss", {}, ("x1", "x2", "cos_label"), {},
               (0, 1)),
    "cosine_margin_reshape": ("CosineEmbeddingLoss", {"margin": 0.3,
                                                      "weight": 2.0},
                              ("x1_flat", "x2", "cos_label"), {}, (0, 1)),
    "sdml": ("SDMLLoss", {}, ("s1", "s2"), {}, (0, 1)),
    "sdml_smoothing": ("SDMLLoss", {"smoothing_parameter": 0.1},
                       ("s1", "s2"), {}, (0, 1)),
}


def _jax(cls, kw, args, kwargs, diff):
    xs = [mx.np.array(a) for a in args]
    for i in diff:
        xs[i].attach_grad()
    kws = {k: (mx.np.array(v) if isinstance(v, onp.ndarray) else v)
           for k, v in kwargs.items()}
    with mx.autograd.record():
        out = getattr(jloss, cls)(**kw)(*xs, **kws)
    out.backward()
    return out.asnumpy(), [xs[i].grad.asnumpy() for i in diff]


def _port(cls, kw, args, kwargs, diff):
    xs = [torch.from_numpy(a.copy()) for a in args]
    for i in diff:
        xs[i].requires_grad_(True)
    kws = {k: (torch.from_numpy(v.copy()) if isinstance(v, onp.ndarray)
               else v) for k, v in kwargs.items()}
    with autograd.record():
        out = getattr(tloss, cls)(**kw)(*xs, **kws)
    autograd.backward(out)
    return out.detach().numpy(), [xs[i].grad.numpy() for i in diff]


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(onp.abs(want).max()), 1e-30)
    assert float(onp.abs(got - want).max()) <= TOL * scale, \
        (onp.abs(got - want).max(), scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_values_and_gradients_match_jax(case):
    cls, kw, names, kwnames, diff = CASES[case]
    arrs = _arrays(sorted(CASES).index(case))
    args = [arrs[n] for n in names]
    if case == "triplet_margin_3d":        # three different tensors
        rs = _rs(99)
        args = [rs.normal(0, 1, (4, 3, 5)).astype("float32")
                for _ in range(3)]
    kwargs = {k: (arrs[v] if isinstance(v, str) else v)
              for k, v in kwnames.items()}
    want, want_g = _jax(cls, kw, args, kwargs, diff)
    got, got_g = _port(cls, kw, args, kwargs, diff)
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


def test_every_reference_loss_has_a_port():
    assert sorted(jloss.__all__) == sorted(tloss.__all__)


def test_ctc_loss_waits_for_queue_5():
    with pytest.raises(NotImplementedError, match="queue 5"):
        tloss.CTCLoss()


def test_sdml_needs_two_rows():
    with pytest.raises(ValueError, match="batch_size >= 2"):
        tloss.SDMLLoss()(torch.ones(1, 3), torch.ones(1, 3))
