"""The port's BERT against the JAX package's: ``BERTModel`` sequence and
pooled outputs with and without ``valid_length``, ``BERTForPretrain``
logits and gradients of the MLM + NSP loss, and one ``Trainer`` AdamW
step.

The same numpy inputs and weights (``convert.load_params``) go through
both packages, float32, with dropout off (inference, or a config with
rate 0 under ``record``): the two frameworks cannot draw the same
masks.  The JAX model runs as its own tests run it on the CPU: without
``valid_length`` its attention is ``pallas_ops.flash_attention``, which
off the TPU is the kernel's XLA fallback; the port's flash wrapper runs
its plain version on CPU tensors.  Tolerances: outputs and logits 1e-4;
the loss at rtol 2e-5 / atol 1e-6 as in ``test_torch_train.py``;
gradients within 1e-5 of each tensor's largest value (measured 2e-7)
and weights after the AdamW step at rtol 1e-5 / atol 1e-4 (as in
``test_torch_train.py``'s Gluon loop) but for the key bias, whose true
gradient is zero (see the test).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.models import BERTForPretrain as JBERTForPretrain
from mxnet_tpu.models import BERTModel as JBERTModel
from mxnet_tpu.models import bert_tiny_config as j_tiny
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.convert import export_params, load_params
from mxnet_tpu_torch.models import (BERTForPretrain, BERTModel,
                                    bert_base_config, bert_tiny_config)
from mxnet_tpu_torch.ops import cuda_ops

TOL = 1e-4
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-6
GRAD_TOL = 1e-5


def _inputs(seed, B=2, T=24, vocab=1024):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, T)).astype(onp.int32),
            rng.randint(0, 2, (B, T)).astype(onp.int32),
            onp.array([T, T // 2 + 1][:B], onp.int32))


def _pair(jcls, tcls, seed, **over):
    mx.np.random.seed(seed)
    jnet = jcls(j_tiny(**over))
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(tcls(bert_tiny_config(**over)).initialize(
        device="cpu"), params)
    return jnet, tnet


def _j(a):
    return None if a is None else NDArray(jnp.asarray(a))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_model_matches_jax(masked):
    jnet, tnet = _pair(JBERTModel, BERTModel, 0)
    toks, types, vlen = _inputs(1)
    vlen = vlen if masked else None
    jseq, jpool = jnet(_j(toks), _j(types), _j(vlen))
    cuda_ops.reset_launch_counts()
    tseq, tpool = tnet(_t(toks), _t(types), _t(vlen))
    onp.testing.assert_allclose(tseq.detach().numpy(), onp.asarray(jseq._data),
                                rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(tpool.detach().numpy(),
                                onp.asarray(jpool._data), rtol=TOL, atol=TOL)
    assert tseq.shape == (2, 24, 128) and tpool.shape == (2, 128)
    assert cuda_ops.LAUNCHES["flash_fwd"] == 0     # the CPU runs plain


def _mlm_nsp_loss(loss_fn, mlm, nsp, mlm_labels, nsp_labels):
    return loss_fn(mlm.reshape(-1, mlm.shape[-1]),
                   mlm_labels.reshape(-1)).mean() \
        + loss_fn(nsp, nsp_labels).mean()


@pytest.mark.parametrize("masked", [False, True])
def test_bert_pretrain_logits_grads_and_step_match_jax(masked):
    jnet, tnet = _pair(JBERTForPretrain, BERTForPretrain, 2, dropout=0.0)
    toks, types, vlen = _inputs(3)
    vlen = vlen if masked else None
    rng = onp.random.RandomState(4)
    mlm_labels = rng.randint(0, 1024, toks.shape).astype(onp.int32)
    nsp_labels = rng.randint(0, 2, toks.shape[0]).astype(onp.int32)
    opt = {"learning_rate": 1e-3, "wd": 0.01}

    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adamw", dict(opt))
    with mx.autograd.record():
        jmlm, jnsp = jnet(_j(toks), _j(types), _j(vlen))
        jloss = _mlm_nsp_loss(mx.gluon.loss.SoftmaxCrossEntropyLoss(), jmlm,
                              jnsp, _j(mlm_labels), _j(nsp_labels))
    jloss.backward()
    jgrads = {k: onp.asarray(p.grad()._data)
              for k, p in jnet.collect_params().items()}
    jtrainer.step(1)

    ttrainer = gluon.Trainer(tnet.collect_params(), "adamw", dict(opt))
    with autograd.record():
        tmlm, tnsp = tnet(_t(toks), _t(types), _t(vlen))
        tloss = _mlm_nsp_loss(gluon.loss.SoftmaxCrossEntropyLoss(), tmlm,
                              tnsp, _t(mlm_labels), _t(nsp_labels))
    autograd.backward(tloss)
    tgrads = {k: p.grad.numpy().copy()
              for k, p in tnet.collect_params().items()}
    ttrainer.step(1)

    onp.testing.assert_allclose(tmlm.detach().numpy(),
                                onp.asarray(jmlm._data), rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(tnsp.detach().numpy(),
                                onp.asarray(jnsp._data), rtol=TOL, atol=TOL)
    onp.testing.assert_allclose(tloss.item(), float(jloss._data),
                                rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert sorted(tgrads) == sorted(jgrads)
    for name, want in jgrads.items():
        err = onp.abs(tgrads[name] - want).max() / max(onp.abs(want).max(),
                                                       1e-30)
        assert err <= GRAD_TOL, "grad %s: %.3e" % (name, err)
    jafter = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    H = 128
    for name, got in export_params(tnet).items():
        want = jafter[name]
        if name.endswith("attention.qkv.bias"):
            # the key bias has a zero true gradient (it shifts every
            # score of a row alike); Adam divides its rounding noise by
            # the noise's own size, so each package moves it by up to lr
            assert onp.abs(got[H:2 * H] - want[H:2 * H]).max() <= \
                2 * opt["learning_rate"]
            got, want = onp.delete(got, slice(H, 2 * H)), \
                onp.delete(want, slice(H, 2 * H))
        # elsewhere as in test_torch_train.py's Gluon loop: Adam's first
        # step is near +-lr for any grad well above eps, so fp32 noise in
        # a near-zero grad moves a weight apart (3.2e-5 at most here)
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                    err_msg=name)


def test_bert_names_equal_jax_and_base_config():
    mx.np.random.seed(0)
    jnames = list(JBERTForPretrain(j_tiny()).collect_params())
    assert list(BERTForPretrain(bert_tiny_config()).collect_params()) == \
        jnames
    cfg = bert_base_config()
    assert (cfg.hidden_size // cfg.num_heads, cfg.num_layers,
            cfg.vocab_size) == (64, 12, 30522)


def test_bert_dropout_runs_only_in_training():
    """With dropout on, training-mode outputs vary with the draw and
    inference is deterministic."""
    net = BERTModel(bert_tiny_config()).initialize(
        device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_inputs(5)[0])
    with autograd.pause():
        a, b = net(toks)[0], net(toks)[0]
    assert torch.equal(a, b)
    with autograd.record():
        c = net(toks)[0]
    assert not torch.allclose(a, c)
