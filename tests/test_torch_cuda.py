"""mxnet_tpu_torch on the card: the hand-written CUDA kernels against
their plain PyTorch versions, the wrappers' refusals, a small bf16
model served through the forward and decode kernels, and a small bf16
model trained through the forward and backward kernels.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  This file imports neither jax nor mxnet_tpu, so it also runs on
the machine with the card, where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: flash bf16 outputs (P is rounded to bf16 before P V) within
2e-2 + 1e-2 * |plain| of the plain version on N(0, 1) inputs -- one bf16
step is 2^-8 of the value, and a causal row that sees one key outputs
that key's value row, up to ~4.5 here; the lse is float32 and within
1e-5.  The paged kernel keeps P in float32, so its bf16 output is within
one bf16 step of plain: 1e-3 + 1e-2 * |plain|.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.ops import cuda_ops

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _bf16(dev, seed, *shape):
    rng = onp.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape).astype(onp.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off,D", [
    (128, 128, True, 0, 0, 128), (300, 300, True, 0, 0, 128),
    (300, 300, False, 0, 0, 128), (128, 128, True, 0, 100, 128),
    (77, 200, True, 150, 30, 64), (64, 64, False, 0, 0, 64)])
def test_flash_kernel_matches_plain(dev, T, Tk, causal, q_off, k_off, D):
    q = _bf16(dev, T, 1, 8, T, D)
    k, v = _bf16(dev, Tk, 1, 2, Tk, D), _bf16(dev, Tk + 1, 1, 2, Tk, D)
    before = cuda_ops.LAUNCHES["flash_fwd"]
    o, lse = cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal, q_offset=q_off, k_offset=k_off)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["flash_fwd"] == before + 1
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (q_off, k_off)]
    o_p, lse_p = cuda_ops._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
    masked = torch.isneginf(lse_p)
    assert torch.equal(torch.isneginf(lse), masked)
    assert not o[masked[..., None].expand_as(o)].any()
    torch.testing.assert_close(o.float(), o_p.float(), atol=2e-2,
                               rtol=1e-2)
    assert (lse[~masked] - lse_p[~masked]).abs().max().item() < 1e-5


def test_paged_kernel_matches_plain(dev):
    S, H, Hkv, D, psz, P, MP = 5, 8, 2, 64, 32, 24, 4
    q, kp, vp = (_bf16(dev, 1, S, H, D), _bf16(dev, 2, P, Hkv, psz, D),
                 _bf16(dev, 3, P, Hkv, psz, D))
    pt = torch.from_numpy(onp.random.RandomState(4).permutation(
        onp.arange(1, P))[:S * MP].reshape(S, MP).astype(onp.int32)).to(dev)
    lens = torch.tensor([0, 1, 32, 33, 128], dtype=torch.int32, device=dev)
    before = cuda_ops.LAUNCHES["paged_decode"]
    got = cuda_ops.paged_attention(q, kp, vp, pt, lens)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["paged_decode"] == before + 1
    want = cuda_ops._paged_dense(q, kp, vp, pt, lens, D ** -0.5)
    assert not got[0].any()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=1e-2)


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off,D", [
    (300, 300, True, 0, 0, 128), (77, 200, True, 150, 30, 64)])
def test_flash_bwd_kernels_match_plain(dev, T, Tk, causal, q_off, k_off, D):
    """dq, dk, dv of the two backward kernels against
    ``_flash_bwd_dense`` on the same bf16 inputs, the lse and delta of a
    real forward with a dlse cotangent folded in.  P and dS are rounded
    to bf16 before their products: within 1e-2 of max|plain| per tensor
    (4.7e-3 measured on an H100), and exactly 0 in dq on a row that
    sees no key."""
    q = _bf16(dev, T, 1, 8, T, D)
    k, v = _bf16(dev, Tk, 1, 2, Tk, D), _bf16(dev, Tk + 1, 1, 2, Tk, D)
    do = _bf16(dev, T + 2, 1, 8, T, D)
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (q_off, k_off)]
    o, lse = cuda_ops._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    dlse = _bf16(dev, T + 3, 1, 8, T).float()
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    before = dict(cuda_ops.LAUNCHES)
    got = cuda_ops._flash_bwd_cuda(q, k, v, do, lse, delta, *offs, causal,
                                   D ** -0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert cuda_ops.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    want = cuda_ops._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                     D ** -0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item(), (name, err)
    masked = torch.isneginf(lse)
    assert not got[0][masked[..., None].expand_as(got[0])].any()


def test_attention_weights_get_grads_on_cuda(dev):
    """Attention is in the autograd graph on the card: after
    ``loss.backward()`` the q/k/v projections hold non-zero grads, and
    the backward ran both kernels."""
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    cfg = tiny_config(dim=256, n_heads=2, n_kv_heads=1, n_layers=1,
                      dtype="bfloat16")
    net = TransformerLM(cfg).initialize(
        torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=dev)
    cuda_ops.reset_launch_counts()
    net(toks).float().logsumexp(-1).mean().backward()
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["flash_bwd_dq"] == 1
    assert cuda_ops.LAUNCHES["flash_bwd_dkv"] == 1
    for w in ("wq", "wk", "wv"):
        g = getattr(net.layer0.attention, w).weight.grad
        assert g is not None and g.float().abs().sum().item() > 0, w


def test_train_step_on_cuda_matches_cpu(dev):
    """Two AdamW ``TrainStep`` steps of a small bf16 model on the card
    (flash forward and backward kernels) and on the CPU (their plain
    versions) from the same weights and batch: the losses agree to 1e-2
    relative -- bf16 matmuls and kernel rounding -- the second one after
    an update of ~lr = 1e-2 on every weight, and the loss falls."""
    from mxnet_tpu_torch import gluon, optimizer
    from mxnet_tpu_torch.convert import export_params, load_params
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    from mxnet_tpu_torch.parallel import TrainStep
    cfg = tiny_config(dim=256, n_heads=2, n_kv_heads=1, dtype="bfloat16")
    net = TransformerLM(cfg).initialize(
        torch.Generator(device=dev).manual_seed(0))
    cpu = load_params(TransformerLM(cfg, device="cpu"), export_params(net))
    rng = onp.random.RandomState(0)
    batch = [torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 64)))
             for _ in range(2)]
    loss_fn = gluon.loss.SoftmaxCELoss()

    def fwd(model, x, y):   # the loss of float32 logits
        return loss_fn(model(x).float(), y).mean()
    losses = []
    cuda_ops.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        step = TrainStep(model, None, optimizer.AdamW(learning_rate=1e-2),
                         forward_fn=fwd)
        losses.append([step(*(b.to(d) for b in batch)).item()
                       for _ in range(2)])
    assert cuda_ops.LAUNCHES["flash_bwd_dq"] == 2 * cfg.n_layers
    assert cuda_ops.LAUNCHES["flash_bwd_dkv"] == 2 * cfg.n_layers
    got, want = onp.array(losses[0]), onp.array(losses[1])
    assert onp.all(onp.abs(got - want) <= 1e-2 * onp.abs(want)), losses
    assert got[1] < got[0]


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k = _bf16(dev, 1, 1, 4, 16, 96), _bf16(dev, 2, 1, 2, 16, 96)
    with pytest.raises(ValueError, match="head_dim"):
        cuda_ops.flash_attention(q, k, k)
    q, k = _bf16(dev, 1, 1, 4, 16, 64), _bf16(dev, 2, 1, 2, 16, 64)
    with pytest.raises(TypeError):
        cuda_ops.flash_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.flash_attention(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        cuda_ops.flash_attention(q, k.cpu(), k)
    kp = _bf16(dev, 3, 4, 2, 24, 64)              # page size 24: no
    pt = torch.ones(1, 2, dtype=torch.int32, device=dev)
    ln = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_ops.paged_attention(_bf16(dev, 4, 1, 4, 64), kp, kp, pt, ln)


def test_tiny_bf16_server_runs_both_kernels(dev):
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    from mxnet_tpu_torch.serve import ServeConfig, Server
    cfg = tiny_config(dim=256, n_heads=4, n_kv_heads=2, dtype="bfloat16")
    net = TransformerLM(cfg).initialize(
        torch.Generator(device=dev).manual_seed(0))
    cuda_ops.reset_launch_counts()
    scfg = ServeConfig(slots=4, page_size=16, pages=32, ladder=(32, 64),
                       max_new=6)
    with Server(net, scfg) as srv:
        res = [srv.generate(list(range(1, n)), timeout=300)
               for n in (5, 40, 60)]
    assert all(r["state"] == "done" and len(r["tokens"]) == 6 for r in res)
    assert srv.sched.check_conservation() == []
    assert cuda_ops.LAUNCHES["flash_fwd"] > 0
    assert cuda_ops.LAUNCHES["paged_decode"] > 0
