"""The port's one-device half of queue 3 against the JAX package: the
switch MoE, the MoE ``TransformerLM``, ``attn_impl="ring"``,
``TrainStep(remat=True)``, ``TrainStep`` checkpoints and
``Trainer.save_states`` / ``load_states``.

The same seeded numpy inputs and weights (``convert.load_params``) go
through both packages at float32.  ``switch_moe`` and the MoE model at
1e-5 (outputs, aux losses) and 1e-4 / 1e-5 (grads); argmax routing is
discontinuous, so every test first asserts that each token's top-1
router margin exceeds 1e-4 on its inputs: a failure is then a real
difference.  Remat against the plain step to 1e-6 over 3 steps (the
reference's own test, ``tests/test_parallel.py:433``); a checkpoint
resumes bit for bit; a JAX ``Trainer.save_states`` file steps on in the
port as in the reference, at 1e-6.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import TransformerLM as JTransformerLM
from mxnet_tpu.models import tiny_config as j_tiny_config
from mxnet_tpu.ndarray.ndarray import NDArray
from mxnet_tpu_torch import autograd, gluon, optimizer
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.convert import export_params, load_params
from mxnet_tpu_torch.models import TransformerLM, tiny_config
from mxnet_tpu_torch.models.transformer import MoEFeedForward
from mxnet_tpu_torch.parallel import TrainStep

MARGIN = 1e-4


def _margins(x, gate_w):
    """Each token's top-1 minus top-2 router logit (float64)."""
    logits = onp.asarray(x, onp.float64) @ onp.asarray(gate_w, onp.float64)
    top = onp.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


def _moe_inputs(T, D, H, E, seed, dtype=onp.float32):
    rs = onp.random.RandomState(seed)
    return [rs.normal(0, 1, (T, D)).astype(dtype),
            rs.normal(0, 0.5, (D, E)).astype(dtype),
            rs.normal(0, 0.5, (E, D, H)).astype(dtype),
            rs.normal(0, 0.5, (E, H, D)).astype(dtype)]


#: (T, D, H, E, seed, capacity_factor)
MOE = {"no_drops": (16, 8, 12, 4, 0, 100.0),
       "default_capacity": (32, 8, 16, 8, 2, 1.25),
       "tight_capacity": (40, 8, 16, 4, 5, 0.5),
       "many_tokens": (300, 16, 8, 3, 9, 1.0)}


@pytest.mark.parametrize("name", sorted(MOE))
def test_switch_moe_and_grads_match_jax(name):
    T, D, H, E, seed, cf = MOE[name]
    arrays = _moe_inputs(T, D, H, E, seed)
    assert _margins(arrays[0], arrays[1]).min() > MARGIN

    def jf(*a):
        out, aux = jpar.switch_moe(*a, capacity_factor=cf)
        return out.sum() + 0.5 * aux, (out, aux)
    jg, (jout, jaux) = jax.grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out, aux = tpar.switch_moe(*ts, capacity_factor=cf)
    tg = torch.autograd.grad(out.sum() + 0.5 * aux, ts)
    assert aux.dtype == torch.float32
    onp.testing.assert_allclose(out.detach().numpy(), onp.asarray(jout),
                                rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    for got, want in zip(tg, jg):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    rtol=1e-4, atol=1e-5)


def test_switch_moe_matches_per_token_loop():
    """Dense einsum dispatch equals the obvious per-token loop."""
    T, D, H, E = 16, 8, 12, 4
    x, gate_w, w1, w2 = _moe_inputs(T, D, H, E, 0)
    assert _margins(x, gate_w).min() > MARGIN
    out, aux = tpar.switch_moe(*(torch.from_numpy(a) for a in
                                 (x, gate_w, w1, w2)), capacity_factor=100.0)
    logits = x @ gate_w
    probs = onp.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = onp.zeros((T, D), onp.float32)
    for t in range(T):
        e = int(probs[t].argmax())
        want[t] = onp.maximum(x[t] @ w1[e], 0) @ w2[e] * probs[t, e]
    onp.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)
    assert float(aux) > 0


def test_switch_moe_capacity_drops_the_same_tokens_as_jax():
    """Every token prefers expert 0 by a wide margin; capacity 4 of 16
    keeps the first 4 in token order and drops the rest (output 0)."""
    T, D, H, E = 16, 8, 12, 2
    x, _, w1, w2 = _moe_inputs(T, D, H, E, 1)
    x[:, 0] = 1.0
    gate_w = onp.zeros((D, E), onp.float32)
    gate_w[0, 0] = 10.0
    assert _margins(x, gate_w).min() > MARGIN
    out, _ = tpar.switch_moe(*(torch.from_numpy(a) for a in
                               (x, gate_w, w1, w2)), capacity_factor=0.5)
    jout, _ = jpar.switch_moe(*(jnp.asarray(a) for a in (x, gate_w, w1, w2)),
                              capacity_factor=0.5)
    produced = onp.abs(out.numpy()).sum(1) > 1e-7
    assert produced.tolist() == [True] * 4 + [False] * 12
    onp.testing.assert_allclose(out.numpy(), onp.asarray(jout), rtol=1e-5,
                                atol=1e-6)


def test_switch_moe_bf16_positions_stay_exact():
    """1024 bf16 tokens to one expert: the float32 queue positions stay
    exact past 256 (a bf16 cumsum would collide), so every token is
    kept; one expert, so routing has no second choice to be near.
    Positive tokens and first-layer weights: no kept token's output can
    be 0, so a zero row means a dropped token."""
    T, D, H = 1024, 8, 8
    x, _, w1, w2 = _moe_inputs(T, D, H, 1, 3)
    x, w1 = onp.abs(x) + 0.1, onp.abs(w1) + 0.1
    gate_w = onp.zeros((D, 1), onp.float32)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in
            (x, gate_w, w1, w2)]
    out, aux = tpar.switch_moe(*args, capacity_factor=1.0)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    produced = (out.float().abs().sum(1) > 1e-6).sum().item()
    jout, _ = jpar.switch_moe(*(jnp.asarray(a, jnp.bfloat16) for a in
                                (x, gate_w, w1, w2)), capacity_factor=1.0)
    jproduced = int((onp.abs(onp.asarray(jout, onp.float32)).sum(1)
                     > 1e-6).sum())
    assert produced == jproduced == T


def test_moe_param_specs_name_the_ep_axis():
    spec = tpar.moe_param_specs()
    assert spec == {"gate": (None, None), "w1": ("ep", None, None),
                    "w2": ("ep", None, None)}
    assert tuple(jpar.moe_param_specs()["w1"]) == spec["w1"]


# ----------------------------------------------------------------------
# the MoE TransformerLM and attn_impl="ring"
# ----------------------------------------------------------------------
MOE_LM = dict(moe_num_experts=4, moe_every=2, n_layers=3)


def _pair(seed, **over):
    mx.np.random.seed(seed)
    jnet = JTransformerLM(j_tiny_config(**over))
    jnet.initialize()
    params = {k: onp.asarray(p.data()._data)
              for k, p in jnet.collect_params().items()}
    tnet = load_params(TransformerLM(tiny_config(**over), device="cpu"),
                       params)
    return jnet, tnet, params


def _router_margins(tnet, toks):
    """The top-1 margin of every token at every MoE block of ``tnet``."""
    seen = []

    def hook(mod, args):
        x = args[0].detach().reshape(-1, args[0].shape[-1])
        seen.append(_margins(x.numpy(), mod.gate.detach().numpy()))
    hooks = [blk.feed_forward.register_forward_pre_hook(hook)
             for blk in tnet.layers
             if isinstance(blk.feed_forward, MoEFeedForward)]
    with torch.no_grad():
        tnet(torch.from_numpy(toks))
    for h in hooks:
        h.remove()
    return onp.concatenate(seen)


def test_moe_lm_structure_and_names_match_jax():
    jnet, tnet, params = _pair(40, **MOE_LM)
    kinds = [type(blk.feed_forward).__name__ for blk in tnet.layers]
    assert kinds == ["MoEFeedForward", "FeedForward", "MoEFeedForward"]
    names = sorted(export_params(tnet))
    assert names == sorted(params)
    assert {"layer0.feed_forward.gate", "layer0.feed_forward.experts_w1",
            "layer2.feed_forward.experts_w2"} <= set(names)
    assert tnet.num_params() == jnet.num_params()
    plain = TransformerLM(tiny_config(n_layers=1), device="cpu")
    assert float(plain.moe_aux_loss()) == 0.0


def test_moe_lm_logits_grads_and_aux_match_jax():
    """Logits, the aux loss and every parameter's grad of a random
    projection of the logits plus 0.01 x aux, against the JAX model."""
    jnet, tnet, _ = _pair(41, **MOE_LM)
    toks = onp.random.RandomState(41).randint(0, 256, (2, 12)).astype(
        onp.int32)
    assert _router_margins(tnet, toks).min() > MARGIN
    w = onp.random.RandomState(42).randn(2, 12, 256).astype(onp.float32)
    with mx.autograd.record():
        jlogits = jnet(NDArray(jnp.asarray(toks)))
        jaux = jnet.moe_aux_loss()
        jloss = (jlogits * NDArray(jnp.asarray(w))).mean() + 0.01 * jaux
    jloss.backward()
    tlogits = tnet(torch.from_numpy(toks))
    taux = tnet.moe_aux_loss()
    ((tlogits * torch.from_numpy(w)).mean() + 0.01 * taux).backward()
    onp.testing.assert_allclose(tlogits.detach().numpy(),
                                onp.asarray(jlogits._data), rtol=1e-5,
                                atol=1e-5)
    onp.testing.assert_allclose(float(taux), float(jaux._data), rtol=1e-5)
    jparams = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        onp.testing.assert_allclose(
            p.grad.numpy(), onp.asarray(jparams[name].grad()._data),
            rtol=1e-5, atol=1e-5, err_msg=name)


def test_moe_aux_loss_is_reset_by_each_forward():
    _, tnet, _ = _pair(43, **MOE_LM)
    toks = torch.from_numpy(onp.random.RandomState(43).randint(
        0, 256, (1, 8)).astype(onp.int32))
    tnet(toks)
    first = float(tnet.moe_aux_loss())
    tnet(toks[:, :4])
    second = float(tnet.moe_aux_loss())
    tnet(toks)
    assert float(tnet.moe_aux_loss()) == first != second


def test_ring_attn_impl_runs_the_reference_dense_path():
    """``attn_impl="ring"`` is dense causal attention over repeated KV
    heads in the reference (it never calls the ring): logits and grads
    against the JAX ring-configured model."""
    jnet, tnet, _ = _pair(44, attn_impl="ring")
    toks = onp.random.RandomState(44).randint(0, 256, (2, 12)).astype(
        onp.int32)
    with mx.autograd.record():
        jlogits = jnet(NDArray(jnp.asarray(toks)))
        jloss = jlogits.mean()
    jloss.backward()
    tlogits = tnet(torch.from_numpy(toks))
    tlogits.mean().backward()
    onp.testing.assert_allclose(tlogits.detach().numpy(),
                                onp.asarray(jlogits._data), rtol=1e-5,
                                atol=1e-5)
    jparams = jnet.collect_params()
    for name, p in tnet.collect_params().items():
        onp.testing.assert_allclose(
            p.grad.numpy(), onp.asarray(jparams[name].grad()._data),
            rtol=1e-5, atol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# remat, checkpoints, Trainer states
# ----------------------------------------------------------------------
def _mlp(weights=None):
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu"), gluon.nn.Dense(4))
    net.initialize(device="cpu")
    net(torch.zeros(4, 8))
    return net if weights is None else load_params(net, weights)


def _lm_fwd(net, tokens, labels):
    logits = net(tokens)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)).mean()
    return ce + 0.01 * net.moe_aux_loss()


def test_remat_matches_plain_mlp():
    """The reference's own case (``tests/test_parallel.py:433``): SGD
    steps of a two-layer MLP, remat against plain, to 1e-6."""
    rs = onp.random.RandomState(0)
    x = torch.from_numpy(rs.uniform(-1, 1, (4, 8)).astype(onp.float32))
    y = torch.from_numpy(rs.randint(0, 4, (4,)).astype(onp.int32))
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    weights = export_params(_mlp())
    plain = TrainStep(_mlp(weights), loss, optimizer.SGD(learning_rate=0.1))
    ck = TrainStep(_mlp(weights), loss, optimizer.SGD(learning_rate=0.1),
                   remat=True)
    for _ in range(3):
        l1, l2 = float(plain(x, y)), float(ck(x, y))
        assert abs(l1 - l2) < 1e-6, (l1, l2)


def test_remat_matches_plain_moe_lm():
    """A MoE LM with its aux loss, 3 AdamW steps: remat recomputes the
    forward (routing included) in the backward and gives the same
    losses and weights."""
    toks, labels = (torch.from_numpy(onp.random.RandomState(s).randint(
        0, 256, (2, 12)).astype(onp.int32)) for s in (45, 46))
    runs = []
    for remat in (False, True):
        _, tnet, _ = _pair(45, **MOE_LM)
        step = TrainStep(tnet, None, optimizer.AdamW(learning_rate=1e-3),
                         forward_fn=_lm_fwd, remat=remat)
        runs.append(([float(step(toks, labels)) for _ in range(3)],
                     export_params(tnet)))
    onp.testing.assert_allclose(runs[1][0], runs[0][0], rtol=0, atol=1e-6)
    for name, w in runs[0][1].items():
        onp.testing.assert_allclose(runs[1][1][name], w, rtol=0, atol=1e-6,
                                    err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_resumes_bit_for_bit(tmp_path, dtype):
    """Save at step 2, restore into a fresh step over a model with other
    weights: steps 3-4 and the weights equal the uninterrupted run's
    exactly; a second save to the same path replaces the first."""
    over = dict(MOE_LM, dtype=dtype)
    toks, labels = (torch.from_numpy(onp.random.RandomState(s).randint(
        0, 256, (2, 10)).astype(onp.int32)) for s in (47, 48))

    def make(seed):
        _, tnet, _ = _pair(seed, **over)
        return tnet, TrainStep(tnet, None,
                               optimizer.AdamW(learning_rate=1e-2),
                               forward_fn=_lm_fwd)
    net, step = make(47)
    whole = [step(toks, labels).item() for _ in range(4)]
    ck = str(tmp_path / "ck")
    make(46)[1].save_checkpoint(ck)     # an older file at the path
    _, step_a = make(47)
    for _ in range(2):
        step_a(toks, labels)
    step_a.save_checkpoint(ck)
    net_b, step_b = make(99)
    step_b.load_checkpoint(ck)
    assert step_b._t == 2 and step_b.optimizer.num_update == 2
    resumed = [step_b(toks, labels).item() for _ in range(2)]
    assert resumed == whole[2:]
    ref = export_params(net)
    for name, w in export_params(net_b).items():
        assert onp.array_equal(w, ref[name]), name


def test_load_checkpoint_refuses_a_file_of_another_model(tmp_path):
    net1 = TransformerLM(tiny_config(n_layers=1), device="cpu")
    net2 = TransformerLM(tiny_config(n_layers=2), device="cpu")
    s1 = TrainStep(net1, None, optimizer.AdamW(), forward_fn=_lm_fwd)
    s2 = TrainStep(net2, None, optimizer.AdamW(), forward_fn=_lm_fwd)
    s1.save_checkpoint(str(tmp_path))
    with pytest.raises(KeyError, match="lacks"):
        s2.load_checkpoint(str(tmp_path))


TRAINER = {"adam": ("adam", {"learning_rate": 0.05}),
           "sgd_momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
           "adamw_wd": ("adamw", {"learning_rate": 0.05, "wd": 0.01})}


def _dense_pair(seed):
    mx.np.random.seed(seed)
    jnet = mx.gluon.nn.Dense(3, in_units=5)
    jnet.initialize()
    tnet = gluon.nn.Dense(3, in_units=5)
    tnet.initialize(device="cpu")
    load_params(tnet, {k: onp.asarray(p.data()._data)
                       for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _j_step(jnet, trainer, x, y):
    with mx.autograd.record():
        loss = mx.gluon.loss.L2Loss()(jnet(NDArray(jnp.asarray(x))),
                                      NDArray(jnp.asarray(y)))
    loss.backward()
    trainer.step(x.shape[0])


def _t_step(tnet, trainer, x, y):
    with autograd.record():
        loss = gluon.loss.L2Loss()(tnet(torch.from_numpy(x)),
                                   torch.from_numpy(y))
    autograd.backward(loss)
    trainer.step(x.shape[0])


@pytest.mark.parametrize("name", sorted(TRAINER))
def test_jax_trainer_states_load_into_the_port(tmp_path, name):
    """A JAX Trainer trains 2 steps and saves its states; a fresh JAX
    Trainer and the port's Trainer each load them, over the same
    weights, and take one more step: the weights agree, and the port's
    own file loads back into JAX the same."""
    opt, kw = TRAINER[name]
    rs = onp.random.RandomState(50)
    x = rs.normal(0, 1, (4, 5)).astype(onp.float32)
    y = rs.normal(0, 1, (4, 3)).astype(onp.float32)
    jnet, _ = _dense_pair(50)
    jtrainer = mx.gluon.Trainer(jnet.collect_params(), opt, dict(kw))
    for _ in range(2):
        _j_step(jnet, jtrainer, x, y)
    path = str(tmp_path / "states")
    jtrainer.save_states(path)
    weights = {k: onp.asarray(p.data()._data)
               for k, p in jnet.collect_params().items()}

    jnet2, tnet = _dense_pair(51)
    for k, p in jnet2.collect_params().items():
        p.set_data(mx.np.array(weights[k]))
    load_params(tnet, weights)
    jt2 = mx.gluon.Trainer(jnet2.collect_params(), opt, dict(kw))
    jt2.load_states(path)
    tt = gluon.Trainer(tnet.collect_params(), opt, dict(kw))
    tt.load_states(path)
    assert tt.optimizer.num_update == jt2._optimizer.num_update == 2
    _j_step(jnet2, jt2, x, y)
    _t_step(tnet, tt, x, y)
    want = {k: onp.asarray(p.data()._data)
            for k, p in jnet2.collect_params().items()}
    for k, w in export_params(tnet).items():
        onp.testing.assert_allclose(w, want[k], rtol=1e-6, atol=1e-6,
                                    err_msg=k)
    back = str(tmp_path / "back")
    tt.save_states(back)
    jt3 = mx.gluon.Trainer(jnet2.collect_params(), opt, dict(kw))
    jt3.load_states(back)
    for i, st in enumerate(tt._states):
        items = st if isinstance(st, tuple) else (st,)
        jitems = jt3._states[i]
        jitems = jitems if isinstance(jitems, tuple) else (jitems,)
        for got, want in zip(items, jitems):
            onp.testing.assert_array_equal(got.numpy(),
                                           onp.asarray(want._data))
