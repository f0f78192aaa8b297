"""The port's training path against the JAX package's: logits and grads
of ``TransformerLM`` through the flash kernels, the ``TrainStep`` and
Gluon ``Trainer`` trajectories, and the pieces they are made of (losses,
``log_softmax``/``pick``, LR schedulers, optimizers).

The same numpy inputs and the same weights (``convert.load_params``)
go through both packages, fp32 throughout.  Tolerances: logits and
grads at 1e-5 (the two frameworks sum in different orders; the largest
differences measured are 2.5e-6 on logits up to 2.5 and 1.3e-7 on grads
up to 0.2); the 3-step losses at rtol 2e-5 / atol 1e-6, the dryrun's
own check (``__graft_entry__.py:158``); weights after three AdamW steps
at 1e-5 (1e-4 in the Gluon loop, reason there); the pieces at 1e-6
(elementwise fp32).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import _tape
from mxnet_tpu import lr_scheduler as j_lrs
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu.ops import nn as j_nn
from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch import autograd, gluon, lr_scheduler, optimizer
from mxnet_tpu_torch.convert import export_params, load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops import nn as t_nn
from mxnet_tpu_torch.parallel import TrainStep

# the dryrun's model (__graft_entry__.py:124)
DRYRUN = dict(n_heads=4, n_kv_heads=2, dim=64, hidden_dim=128, n_layers=2,
              vocab_size=128)


def _pair(seed, **over):
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config(**over))
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(**over), device="cpu"),
                       params)
    return jnet, tnet


def _batch(seed, B, T, vocab):
    rng = onp.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, T)).astype(onp.int32),
            rng.randint(0, vocab, (B, T)).astype(onp.int32))


def _j_params(jnet):
    return {k: onp.asarray(p.data()._data)
            for k, p in jnet.collect_params().items()}


def test_logits_and_grads_through_the_flash_kernels(monkeypatch):
    """head_dim 64 and T = 128: the JAX forward and backward run the
    Pallas flash kernels (interpret mode), the port the same model
    through ``_FlashAttention``; logits and every parameter's grad of
    the mean softmax-CE agree."""
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)
    over = dict(dim=256, n_heads=4, n_kv_heads=2, hidden_dim=256,
                n_layers=2, vocab_size=256)
    jnet, tnet = _pair(20, **over)
    toks, labels = _batch(20, 1, 128, 256)
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        jlogits = jnet(NDArray(jnp.asarray(toks)))
        jloss = jloss_fn(jlogits.reshape(-1, 256),
                         NDArray(jnp.asarray(labels)).reshape(-1)).mean()
    jloss.backward()
    tlogits = tnet(torch.from_numpy(toks))
    tloss = gluon.loss.SoftmaxCrossEntropyLoss()(
        tlogits.reshape(-1, 256), torch.from_numpy(labels).reshape(-1))
    tloss.mean().backward()
    onp.testing.assert_allclose(tlogits.detach().numpy(),
                                onp.asarray(jlogits._data), rtol=1e-5,
                                atol=1e-5)
    jparams = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        want = onp.asarray(jparams[name].grad()._data)
        onp.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5,
                                    atol=1e-5, err_msg=name)


def _fwd(loss_fn):
    def fwd(net, tokens, labels):
        logits = net.forward(tokens)
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1)).mean()
    return fwd


def test_train_step_trajectory_matches_jax_dryrun():
    """The dryrun's single-device replay (``__graft_entry__.py:151-159``):
    3 AdamW steps of ``TrainStep`` on both packages."""
    jnet, tnet = _pair(0, **DRYRUN)
    toks, labels = _batch(0, 2, 32, 128)
    jstep = mx.parallel.TrainStep(
        jnet, None, mx.optimizer.AdamW(learning_rate=1e-3), mesh=None,
        forward_fn=_fwd(mx.gluon.loss.SoftmaxCrossEntropyLoss()))
    tstep = TrainStep(tnet, None, optimizer.AdamW(learning_rate=1e-3),
                      forward_fn=_fwd(gluon.loss.SoftmaxCrossEntropyLoss()))
    jt, jl = NDArray(jnp.asarray(toks)), NDArray(jnp.asarray(labels))
    tt, tl = torch.from_numpy(toks), torch.from_numpy(labels)
    want = [float(jstep(jt, jl)) for _ in range(3)]
    got = [float(tstep(tt, tl)) for _ in range(3)]
    onp.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert got[2] < got[0]
    jp, tp = _j_params(jnet), export_params(tnet)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        onp.testing.assert_allclose(tp[name], jp[name], rtol=1e-5,
                                    atol=1e-5, err_msg=name)


def test_gluon_trainer_loop_matches_jax():
    """``autograd.record()`` -> ``backward`` -> ``Trainer.step(B)`` with
    a cosine schedule, weight decay and gradient clipping, 3 steps."""
    jnet, tnet = _pair(1, **DRYRUN)
    toks, labels = _batch(1, 2, 32, 128)

    def opt_params(lrs):
        return {"learning_rate": 1e-3, "wd": 0.01, "clip_gradient": 0.02,
                "lr_scheduler": lrs.CosineScheduler(max_update=6,
                                                    base_lr=1e-3,
                                                    warmup_steps=1)}
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), "adamw",
                                opt_params(j_lrs))
    ttrainer = gluon.Trainer(tnet.collect_params(), "adamw",
                             opt_params(lr_scheduler))
    jloss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    tloss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    want, got = [], []
    for _ in range(3):
        with mx.autograd.record():
            jloss = jloss_fn(jnet(NDArray(jnp.asarray(toks))),
                             NDArray(jnp.asarray(labels)))
        jloss.backward()
        jtrainer.step(2)
        want.append(onp.asarray(jloss._data))
        with autograd.record():
            assert autograd.is_recording() and autograd.is_training()
            tloss = tloss_fn(tnet(torch.from_numpy(toks)),
                             torch.from_numpy(labels))
        autograd.backward(tloss)
        ttrainer.step(2)
        got.append(tloss.detach().numpy())
    assert got[0].shape == (2,)
    onp.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    assert ttrainer.learning_rate == pytest.approx(jtrainer.learning_rate)
    # Adam's step m/(sqrt(v)+eps) is near +-1 for any grad well above
    # eps, so fp32 noise in a near-zero grad can move a weight by up to
    # lr = 1e-3; one element of 8192 moved 4.9e-5 apart here
    jp, tp = _j_params(jnet), export_params(tnet)
    for name in jp:
        onp.testing.assert_allclose(tp[name], jp[name], rtol=1e-5,
                                    atol=1e-4, err_msg=name)


def test_trainer_refuses_stale_gradients():
    net = TransformerLM(tiny_config(n_layers=1), device="cpu").initialize(
        torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    toks = torch.randint(0, 256, (1, 8), generator=torch.Generator()
                         .manual_seed(1))
    net(toks).mean().backward()
    trainer.step(1)
    assert all(p.grad is None for p in net.parameters())
    before = export_params(net)
    with pytest.raises(UserWarning, match="ignore_stale_grad"):
        trainer.step(1)                   # no backward since the step
    trainer.step(1, ignore_stale_grad=True)
    after = export_params(net)
    assert all(onp.array_equal(before[k], after[k]) for k in before)
    # a parameter that the backward did not reach is stale too
    net.norm(net.tok_embeddings(toks).float()).sum().backward()
    with pytest.raises(UserWarning, match="output.weight"):
        gluon.Trainer(net.collect_params("(norm|output)"), "sgd").step(1)


@pytest.mark.parametrize("kind", ["sparse", "dense", "from_logits",
                                  "sample_weight", "l1", "l2"])
def test_losses_match_jax(kind):
    rng = onp.random.RandomState(30)
    pred = rng.randn(4, 3, 7).astype(onp.float32)
    label = rng.randint(0, 7, (4, 3)).astype(onp.int32)
    sw = None
    kw = {}
    if kind == "dense":
        label = onp.exp(rng.randn(4, 3, 7)).astype(onp.float32)
        label /= label.sum(-1, keepdims=True)
        kw = {"sparse_label": False}
    elif kind == "from_logits":
        pred = onp.array(j_nn.log_softmax(jnp.asarray(pred)))
        kw = {"from_logits": True, "weight": 0.5}
    elif kind == "sample_weight":
        sw = rng.rand(4, 3).astype(onp.float32)
    elif kind in ("l1", "l2"):
        label = rng.randn(4, 21).astype(onp.float32)   # reshaped like pred
    name = {"l1": "L1Loss", "l2": "L2Loss"}.get(kind,
                                                 "SoftmaxCrossEntropyLoss")
    jl = getattr(mx.gluon.loss, name)(**kw)
    tl = getattr(gluon.loss, name)(**kw)
    jargs = [NDArray(jnp.asarray(a)) for a in (pred, label)]
    targs = [torch.from_numpy(a) for a in (pred, label)]
    if sw is not None:
        jargs.append(NDArray(jnp.asarray(sw)))
        targs.append(torch.from_numpy(sw))
    with _tape.suspend_recording():
        want = onp.asarray(jl(*jargs)._data)
    got = tl(*targs).numpy()
    assert got.shape == want.shape == (4,)
    onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
def test_log_softmax_and_pick_match_jax(mode):
    rng = onp.random.RandomState(31)
    x = rng.randn(3, 5, 6).astype(onp.float32)
    idx = rng.randint(-3, 9, (3, 6)).astype(onp.int32)
    onp.testing.assert_allclose(
        t_nn.log_softmax(torch.from_numpy(x), axis=1,
                         temperature=2.0).numpy(),
        onp.asarray(j_nn.log_softmax(jnp.asarray(x), axis=1,
                                     temperature=2.0)), rtol=1e-6, atol=1e-6)
    for keepdims in (False, True):
        want = j_nn.pick(jnp.asarray(x), jnp.asarray(idx), axis=1,
                         keepdims=keepdims, mode=mode)
        got = t_nn.pick(torch.from_numpy(x), torch.from_numpy(idx), axis=1,
                        keepdims=keepdims, mode=mode)
        assert onp.array_equal(got.numpy(), onp.asarray(want))


_SCHEDULERS = {
    "factor": lambda m: m.FactorScheduler(step=7, factor=0.5, base_lr=0.1,
                                          stop_factor_lr=0.01),
    "multifactor": lambda m: m.MultiFactorScheduler(
        step=[5, 12, 30], factor=0.3, base_lr=0.2, warmup_steps=3,
        warmup_begin_lr=0.01),
    "poly": lambda m: m.PolyScheduler(max_update=40, base_lr=0.1, pwr=2,
                                      final_lr=0.001, warmup_steps=5),
    "cosine": lambda m: m.CosineScheduler(max_update=45, base_lr=0.1,
                                          final_lr=0.002, warmup_steps=4,
                                          warmup_begin_lr=0.005),
    "factor_constant_warmup": lambda m: m.FactorScheduler(
        step=10, factor=0.9, base_lr=0.05, warmup_steps=6,
        warmup_begin_lr=0.01, warmup_mode="constant"),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULERS))
def test_lr_schedulers_match_jax(name):
    js, ts = _SCHEDULERS[name](j_lrs), _SCHEDULERS[name](lr_scheduler)
    want = [js(n) for n in range(51)]
    assert [ts(n) for n in range(51)] == want
    assert len(set(want)) > 2


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"momentum": 0.9}), ("adam", {}), ("adamw", {})])
def test_optimizer_update_matches_jax(name, kw):
    """Three ``Optimizer.update`` calls on one weight, with wd,
    ``rescale_grad`` and ``clip_gradient`` (which the first grad
    exceeds) on both packages."""
    rng = onp.random.RandomState(32)
    w0 = rng.randn(5, 4).astype(onp.float32)
    grads = [rng.randn(5, 4).astype(onp.float32) * 3 for _ in range(3)]
    args = dict(kw, learning_rate=0.05, wd=0.1, rescale_grad=0.5,
                clip_gradient=1.0)
    jopt = mx.optimizer.create(name, **args)
    topt = optimizer.create(name, **args)
    jw, tw = NDArray(jnp.asarray(w0)), torch.from_numpy(w0.copy())
    jst, tst = jopt.create_state(0, jw), topt.create_state(0, tw)
    for g in grads:
        jopt.update(0, jw, NDArray(jnp.asarray(g)), jst)
        topt.update(0, tw, torch.from_numpy(g), tst)
    assert topt.num_update == jopt.num_update == 3
    onp.testing.assert_allclose(tw.numpy(), onp.asarray(jw._data),
                                rtol=1e-6, atol=1e-6)
    for js, ts in zip(jst, tst):
        onp.testing.assert_allclose(ts.numpy(), onp.asarray(js._data),
                                    rtol=1e-6, atol=1e-6)


def test_unported_training_options_raise():
    net = TransformerLM(tiny_config(n_layers=1), device="cpu")
    opt = optimizer.AdamW()
    with pytest.raises(NotImplementedError, match="queue 3"):
        TrainStep(net, None, opt, aot=True)
    params = net.collect_params()
    # skip_nonfinite, refused until the low-precision slice, now runs: a
    # step with no fresh gradient is stale; preemption and the elastic
    # reset of the kvstore are ported too
    tr = gluon.Trainer(params, "sgd", kvstore="dist_sync")
    with pytest.raises(UserWarning, match="not updated by backward"):
        tr.step(1, skip_nonfinite=True)
    assert tr._kvstore is not None and tr._kvstore.num_workers == 1
    tr.reset_kvstore()
    assert tr._kvstore is None and not tr._kv_initialized
    from mxnet_tpu_torch import fault
    assert fault.PreemptionHandler("unused").fired == 0
    # multi_precision and LAMB, refused until the optimizer slice, now work
    opt = optimizer.Adam(multi_precision=True)
    w16 = torch.ones(3, dtype=torch.float16)
    w32, (m, v) = opt.create_state_multi_precision(0, w16)
    assert w32.dtype == m.dtype == v.dtype == torch.float32
    assert isinstance(optimizer.create("lamb"), optimizer.LAMB)
    with pytest.raises(ValueError, match="Cannot find optimizer"):
        optimizer.create("lamb_not_an_optimizer")


@pytest.mark.parametrize("make", [
    lambda net: TrainStep(net, None, optimizer.AdamW(), param_rules=[]),
    lambda net: TrainStep(net, None, optimizer.AdamW(), batch_spec=("dp",)),
    lambda net: TrainStep(net, None, optimizer.AdamW(), donate=False),
    lambda net: TrainStep(net, None, optimizer.AdamW(), None, None),
    lambda net: optimizer.SGD(lazy_update=True),
    lambda net: gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": 0.1, "lazy_update": True}),
], ids=["param_rules", "batch_spec", "donate", "positional", "lazy_update",
        "trainer_optimizer_params"])
def test_options_the_port_lacks_are_refused(make):
    """An option of the JAX package that the port does not have, or that
    means nothing without a mesh (``param_rules``, ``batch_spec``, which
    the JAX step ignores there), is an error, never silently dropped."""
    with pytest.raises(TypeError):
        make(TransformerLM(tiny_config(n_layers=1), device="cpu"))


@pytest.mark.parametrize("name,kw", [
    ("adamw", {"aggregate_num": 4}), ("sgd", {"use_fused_step": False}),
    ("sgd", {"aggregate_num": 1, "use_fused_step": False,
             "momentum": 0.9}),
    ("lamb", {"aggregate_num": 2})],
    ids=["aggregate_num", "use_fused_step", "both", "lamb_aggregate_num"])
def test_aggregate_num_and_use_fused_step_change_no_result(name, kw):
    """``aggregate_num`` and ``use_fused_step`` (refused before the
    optimizer slice) are taken and, as in the JAX package, change no
    result: three list-form updates equal the defaults' bit for bit."""
    rng = onp.random.RandomState(5)
    shapes = [(4, 3), (7,), (2, 2, 2)]
    w0 = [rng.randn(*s).astype(onp.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(onp.float32) for s in shapes]
             for _ in range(3)]
    out = []
    for opts in ({}, kw):
        args = {k: v for k, v in kw.items()
                if k not in ("aggregate_num", "use_fused_step")}
        opt = optimizer.create(name, learning_rate=0.1, wd=0.01,
                               **dict(args, **opts))
        assert opt.aggregate_num == opts.get("aggregate_num", 0)
        assert opt.use_fused_step == opts.get("use_fused_step", True)
        ws = [torch.from_numpy(w.copy()) for w in w0]
        sts = [opt.create_state(i, w) for i, w in enumerate(ws)]
        for gs in grads:
            opt.update(list(range(3)), ws, [torch.from_numpy(g) for g in gs],
                       sts)
        out.append([w.numpy() for w in ws])
    for a, b in zip(*out):
        assert onp.array_equal(a, b)


def test_collect_params_names_select_and_num_params():
    jnet, tnet = _pair(3)
    names = list(tnet.collect_params())
    assert sorted(names) == sorted(jnet.collect_params())
    assert list(tnet.collect_params("layer1.attention")) == [
        n for n in names if n.startswith("layer1.attention")]
    assert tnet.num_params() == jnet.num_params()
    tnet(torch.zeros(1, 3, dtype=torch.long)).sum().backward()
    tnet.zero_grad()
    assert all(not p.grad.any() for p in tnet.parameters())


def test_training_on_cpu_launches_no_kernel():
    _, tnet = _pair(4)
    cuda_ops.reset_launch_counts()
    TrainStep(tnet, gluon.loss.SoftmaxCELoss(), optimizer.SGD())(
        *(torch.from_numpy(a) for a in _batch(4, 1, 8, 256)))
    assert set(cuda_ops.LAUNCHES.values()) == {0}
