"""mxnet_tpu_torch on the card: the hand-written CUDA kernels against
their plain PyTorch versions, the wrappers' refusals, a small bf16
model served through the forward and decode kernels, a small bf16
model trained through the forward and backward kernels, a head_dim-64
BERT layer through all three flash kernels, and the Gluon layers'
card paths: ``hybridize()`` as CUDA-graph replay, NHWC against NCHW,
BatchNorm's running statistics.

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


# (B, H, Hkv, T, Tk, causal, q_off, k_off, D): the serving prefill's
# top rung and the training shape, ragged T, ring steps whose first rows
# see no key, D = 64, rep in {1, 4, 8}, non-causal, and BERT-base's
# full-width shape
FLASH_CASES = [
    (1, 8, 2, 128, 128, True, 0, 0, 128), (1, 8, 2, 300, 300, True, 0, 0, 128),
    (1, 8, 2, 300, 300, False, 0, 0, 128),
    (1, 8, 2, 128, 128, True, 0, 100, 128),
    (1, 8, 2, 77, 200, True, 150, 30, 64), (1, 8, 2, 64, 64, False, 0, 0, 64),
    (1, 32, 8, 512, 512, True, 0, 0, 128),
    (2, 32, 8, 1024, 1024, True, 0, 0, 128),
    (1, 8, 8, 300, 300, True, 0, 0, 128), (1, 8, 1, 77, 77, True, 0, 0, 64),
    (1, 8, 2, 300, 428, True, 28, 128, 128),
    (1, 4, 4, 77, 200, False, 0, 0, 64),
    (1, 8, 1, 300, 300, False, 0, 0, 128),
    (16, 12, 12, 512, 512, False, 0, 0, 64),     # BERT-base's attention
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, case):
    """The TMA + wgmma forward against plain at the main path's shapes
    and the edges of its design (ragged tiles, GQA groups of 1, 4 and 8,
    masked rows); two calls give the same bits."""
    B, H, Hkv, T, Tk, causal, q_off, k_off, D = case
    q = _bf16(dev, T, B, H, T, D)
    k, v = _bf16(dev, Tk, B, Hkv, Tk, D), _bf16(dev, Tk + 1, B, Hkv, Tk, D)
    before = cuda_ops.LAUNCHES["flash_fwd"]
    o, lse = cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal, q_offset=q_off, k_offset=k_off)
    o2, lse2 = cuda_ops.flash_attention_with_lse(
        q, k, v, causal=causal, q_offset=q_off, k_offset=k_off)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["flash_fwd"] == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (q_off, k_off)]
    o_p, lse_p = cuda_ops._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
    masked = torch.isneginf(lse_p)
    assert torch.equal(torch.isneginf(lse), masked)
    assert bool(masked.any()) == (causal and k_off > q_off)
    assert not o[masked[..., None].expand_as(o)].any()
    torch.testing.assert_close(o.float(), o_p.float(), atol=2e-2,
                               rtol=1e-2)
    assert (lse[~masked] - lse_p[~masked]).abs().max().item() < 1e-5


# (S, H, Hkv, D, psz, P, MP, lengths): lengths on the split boundaries
# +-1 (cuda_ops.paged_split_plan), full tables, empty slots, S = 1,
# rep in {1, 4, 8}, page sizes 16, 32 and 128, D 64 and 128, and a long
# case with several chunks per split (the double-buffered loop)
PAGED_CASES = [
    (5, 8, 2, 64, 32, 24, 4, [0, 1, 32, 33, 128]),
    (8, 32, 8, 128, 128, 64, 5, [0, 63, 64, 65, 127, 128, 129, 640]),
    (1, 8, 8, 64, 16, 12, 10, [160]),
    (4, 8, 1, 64, 128, 24, 4, [1, 511, 512, 0]),
    (3, 32, 4, 128, 16, 40, 12, [15, 16, 17]),
    (2, 32, 8, 128, 128, 130, 64, [8192, 5000]),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(dev, case):
    """The split-page decode against plain; the splits are merged in a
    fixed order, so two calls give the same bits."""
    S, H, Hkv, D, psz, P, MP, lens = case
    q, kp, vp = (_bf16(dev, 1, S, H, D), _bf16(dev, 2, P, Hkv, psz, D),
                 _bf16(dev, 3, P, Hkv, psz, D))
    pt = torch.from_numpy(onp.random.RandomState(4).permutation(
        onp.arange(1, P))[:S * MP].reshape(S, MP).astype(onp.int32)).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = cuda_ops.LAUNCHES["paged_decode"]
    got = cuda_ops.paged_attention(q, kp, vp, pt, ln)
    again = cuda_ops.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["paged_decode"] == before + 2
    assert torch.equal(got, again)
    want = cuda_ops._paged_dense(q, kp, vp, pt, ln, D ** -0.5)
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=1e-2)


def _bwd_case(dev, case):
    """bf16 q, k, v, dO of a FLASH_CASES case, the forward kernel's O and
    lse, a dlse cotangent, and the device offsets."""
    B, H, Hkv, T, Tk, causal, q_off, k_off, D = case
    q = _bf16(dev, T, B, H, T, D)
    k, v = _bf16(dev, Tk, B, Hkv, Tk, D), _bf16(dev, Tk + 1, B, Hkv, Tk, D)
    do = _bf16(dev, T + 2, B, H, T, D)
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (q_off, k_off)]
    o, lse = cuda_ops._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    dlse = _bf16(dev, T + 3, B, H, T).float()
    return q, k, v, do, o, lse, dlse, offs


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_kernels_match_plain(dev, case):
    """dq, dk, dv of the two backward kernels against
    ``_flash_bwd_dense`` on the same bf16 inputs, the lse of a real
    forward with a dlse cotangent folded into delta: once with delta
    computed inside the dq launch from O (the training path), once with
    delta given (the ring primitive's path).  P and dS are rounded to
    bf16 before their products: within 1e-2 of max|plain| per tensor,
    and exactly 0 in dq on a row that sees no key."""
    causal, D = case[5], case[8]
    q, k, v, do, o, lse, dlse, offs = _bwd_case(dev, case)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    want = cuda_ops._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                     D ** -0.5)
    masked = torch.isneginf(lse)
    for kw in (dict(delta=None, o=o, dlse=dlse), dict(delta=delta)):
        before = dict(cuda_ops.LAUNCHES)
        d = kw.pop("delta")
        got = cuda_ops._flash_bwd_cuda(q, k, v, do, lse, d, *offs, causal,
                                       D ** -0.5, **kw)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        assert cuda_ops.LAUNCHES["flash_bwd_dkv"] == \
            before["flash_bwd_dkv"] + 1
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w).abs().max().item()
            assert err <= 1e-2 * w.abs().max().item(), (name, err, kw.keys())
        assert not got[0][masked[..., None].expand_as(got[0])].any()


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (1, 4, 7, 10)])
def test_flash_bwd_kernels_give_the_same_bits(dev, case):
    """No atomics: two calls give the same dq, dk and dv bits."""
    causal, D = case[5], case[8]
    q, k, v, do, o, lse, dlse, offs = _bwd_case(dev, case)
    args = (q, k, v, do, lse, None, *offs, causal, D ** -0.5)
    first = cuda_ops._flash_bwd_cuda(*args, o=o, dlse=dlse)
    again = cuda_ops._flash_bwd_cuda(*args, o=o, dlse=dlse)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("with_dlse", [True, False])
@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (4, 7, 10)])
def test_flash_bwd_dq_writes_delta(dev, case, with_dlse):
    """The delta the dq kernel computes and writes, against the eager
    rowsum(dO o O) - dlse.  The products of two bf16 values are exact in
    fp32, so the two differ only by the order of D + 1 fp32 additions:
    |err| <= (D + 1) * 2^-24 * (sum |dO o O| + |dlse|) per row, the
    classic bound for recursive summation in any order."""
    causal, D = case[5], case[8]
    q, k, v, do, o, lse, dlse, offs = _bwd_case(dev, case)
    dlse = dlse if with_dlse else None
    delta = torch.full(lse.shape, float("nan"), device=dev)
    cuda_ops._flash_bwd_dq_cuda(q, k, v, do, lse, delta, *offs, causal,
                                D ** -0.5, o=o, dlse=dlse)
    torch.cuda.synchronize()
    prod = do.float() * o.float()
    want = prod.sum(-1) - (0 if dlse is None else dlse)
    bound = (D + 1) * 2.0 ** -24 * (
        prod.abs().sum(-1) + (0 if dlse is None else dlse.abs()))
    assert bool(((delta - want).abs() <= bound).all()), \
        (delta - want).abs().max().item()


def test_tma_kernels_launch_from_a_fresh_thread(dev):
    """The kernels that encode TMA tensor maps (flash forward, dq, dk/dv)
    launch from a thread that has made no CUDA runtime call of its own
    -- PyTorch's autograd worker is one -- with its tensors from the
    allocator's cache: the encoder needs a context bound to the thread."""
    import threading
    case = FLASH_CASES[1]
    causal, D = case[5], case[8]
    q, k, v, do, o, lse, dlse, offs = _bwd_case(dev, case)
    torch.cuda.synchronize()
    torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # warm the cache
    out = {}

    def run():
        try:
            out["fwd"] = cuda_ops._flash_fwd_cuda(q, k, v, *offs, causal,
                                                  D ** -0.5)
            out["bwd"] = cuda_ops._flash_bwd_cuda(
                q, k, v, do, lse, None, *offs, causal, D ** -0.5, o=o,
                dlse=dlse)
            torch.cuda.synchronize()
        except Exception as e:          # re-raised in the test's thread
            out["error"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    assert "error" not in out, out.get("error")
    assert torch.equal(out["fwd"][0], o)


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


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(dev,
                                                         exact_fp32):
    """What the Hopper kernels do not take (float32, head_dim 96, page
    size 24) runs the tensor-core or general kernels and agrees with the
    plain oracle; a head_dim above 256, a non-contiguous input and mixed
    devices are still refused."""
    q, k = _bf16(dev, 1, 1, 4, 16, 96), _bf16(dev, 2, 1, 2, 16, 96)
    before = cuda_ops.LAUNCHES["flash_fwd_mma"]
    got = cuda_ops.flash_attention(q, k, k)
    want = cuda_ops._dense_with_lse(q, k, k, *_offs(dev, 0, 0), False,
                                    96 ** -0.5)[0]
    assert cuda_ops.LAUNCHES["flash_fwd_mma"] == before + 1
    assert _max_err(got, want) <= GENERAL_TOL[torch.bfloat16] * \
        want.float().abs().max().item()
    q, k = _bf16(dev, 1, 1, 4, 16, 64), _bf16(dev, 2, 1, 2, 16, 64)
    got = cuda_ops.flash_attention(q.float(), k.float(), k.float())
    want = cuda_ops._dense_with_lse(q.float(), k.float(), k.float(),
                                    *_offs(dev, 0, 0), False, 0.125)[0]
    assert _max_err(got, want) <= GENERAL_TOL[torch.float32] * \
        want.abs().max().item()
    with pytest.raises(ValueError, match="head_dim"):
        big = _bf16(dev, 1, 1, 2, 8, 320)
        cuda_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.flash_attention(q.transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        cuda_ops.flash_attention(q, k.cpu(), k)
    kp = _bf16(dev, 3, 4, 2, 24, 64)              # page size 24
    pt = torch.ones(1, 2, dtype=torch.int32, device=dev)
    ln = torch.full((1,), 30, dtype=torch.int32, device=dev)
    qd = _bf16(dev, 4, 1, 4, 64)
    before = cuda_ops.LAUNCHES["paged_decode_general"]
    got = cuda_ops.paged_attention(qd, kp, kp, pt, ln)
    want = cuda_ops._paged_dense(qd, kp, kp, pt, ln, 0.125)
    assert cuda_ops.LAUNCHES["paged_decode_general"] == before + 1
    assert _max_err(got, want) <= GENERAL_TOL[torch.bfloat16] * \
        want.float().abs().max().item()


# ---------------------------------------------------------------------------
# the general kernels (csrc/flash_general.cu, csrc/paged_general.cu)
# ---------------------------------------------------------------------------

#: max |kernel - plain| / max |plain| per tensor, against the plain
#: version on the same card inputs with TF32 off.  float32 and float64
#: differ only by the order of their sums; float16 / bf16 outputs also by
#: the plain forward rounding P to the input type before P V, where the
#: kernel keeps it in float32, and by one rounding of the output.  The
#: tensor-core forward and backward also by their 3xTF32 products (about
#: 2^-22 each).
GENERAL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5,
               torch.float16: 4e-3, torch.bfloat16: 2e-2}


@pytest.fixture()
def exact_fp32():
    """The plain oracle in full float32: TF32 off for its matmuls."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def _offs(dev, q_off, k_off):
    return [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (q_off, k_off)]


def _max_err(got, want):
    return (got.double() - want.double()).abs().max().item()


def _rand(dev, seed, dtype, *shape):
    rng = onp.random.RandomState(seed)
    return torch.from_numpy(rng.randn(*shape)).to(dev, dtype)


_F16, _BF16, _F32, _F64 = (torch.float16, torch.bfloat16, torch.float32,
                           torch.float64)

# (B, H, Hkv, T, Tk, causal, q_off, k_off, D, dtype): every dtype, head
# dims 1 to 256, GQA groups 1, 4 and 32, ring-step offsets whose first
# rows see no key, one-row decode
GENERAL_FLASH_CASES = [
    (2, 4, 4, 77, 77, False, 0, 0, 64, _F32),
    (1, 8, 2, 50, 50, True, 0, 0, 16, _F32),
    (1, 4, 1, 40, 70, True, 30, 0, 32, _F16),
    (1, 4, 4, 33, 45, True, 0, 20, 96, _F64),
    (1, 4, 2, 64, 64, True, 0, 0, 256, _BF16),
    (1, 32, 1, 40, 40, True, 0, 0, 64, _F32),
    (1, 2, 2, 10, 10, False, 0, 0, 1, _F32),
    (1, 2, 1, 40, 40, True, 0, 0, 256, _F64),
    (2, 8, 2, 1, 100, True, 99, 0, 128, _F32),
    (1, 4, 4, 70, 70, True, 0, 0, 96, _BF16),
    (1, 6, 2, 90, 130, True, 40, 0, 12, _F32),   # mma, padded to 16
    (1, 4, 1, 65, 65, False, 0, 0, 40, _F16),    # mma, padded to 64
    (1, 4, 2, 60, 60, True, 0, 0, 12, _F16),     # simt: 24-byte rows
    (1, 4, 4, 50, 80, True, 0, 30, 20, _BF16),   # simt: 40-byte rows
]


def _general_inputs(dev, case):
    B, H, Hkv, T, Tk, causal, q_off, k_off, D, dt = case
    q = _rand(dev, T, dt, B, H, T, D)
    k, v = _rand(dev, Tk, dt, B, Hkv, Tk, D), \
        _rand(dev, Tk + 1, dt, B, Hkv, Tk, D)
    return q, k, v, _offs(dev, q_off, k_off)


@pytest.mark.parametrize("case", GENERAL_FLASH_CASES)
def test_general_flash_forward_matches_plain(dev, exact_fp32, case):
    """(o, lse) of the forward that ``_flash_route`` picks (the
    tensor-core kernel for float16 / bfloat16 / float32 up to head_dim
    128 with 16-byte rows, the general one for float64, head_dim 256
    and unaligned rows) against ``_dense_with_lse``; the same -inf rows;
    two calls give the same bits."""
    causal, D, dt = case[5], case[8], case[9]
    q, k, v, offs = _general_inputs(dev, case)
    route = cuda_ops._flash_route(dt, D, D * q.element_size() % 16 == 0)
    assert route == ("simt" if dt == _F64 or D > 128 or
                     D * q.element_size() % 16 else "mma")
    name = "flash_fwd_" + cuda_ops.FWD_ROUTES[route][1]
    before = cuda_ops.LAUNCHES[name]
    o, lse = cuda_ops._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    o2, _ = cuda_ops._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES[name] == before + 2
    assert o.dtype == dt and lse.dtype == torch.float32
    assert torch.equal(o, o2)
    o_p, lse_p = cuda_ops._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
    masked = torch.isneginf(lse_p)
    assert torch.equal(torch.isneginf(lse), masked)
    assert not o[masked[..., None].expand_as(o)].any()
    tol = GENERAL_TOL[dt]
    assert _max_err(o, o_p) <= tol * o_p.double().abs().max().item()
    assert _max_err(lse[~masked], lse_p[~masked]) <= \
        max(tol, 2 ** -23) * lse_p[~masked].abs().max().item()


@pytest.mark.parametrize("case", GENERAL_FLASH_CASES)
def test_general_flash_backward_matches_plain(dev, exact_fp32, case):
    """dq, dk, dv of the backward that ``_flash_route`` picks (the
    tensor-core kernels for float16 / bfloat16 / float32 up to head_dim
    128 with 16-byte rows, the general ones for float64, head_dim 256
    and unaligned rows) against ``_flash_bwd_dense`` on the same inputs,
    lse and delta: both sum in float32 (float64 for float64), so every
    dtype is within its float32 / float64 tolerance; delta computed
    inside the dq launch (the training path) and given (the ring
    primitive's)."""
    causal, D, dt = case[5], case[8], case[9]
    q, k, v, offs = _general_inputs(dev, case)
    route = cuda_ops._flash_route(dt, D, D * q.element_size() % 16 == 0)
    assert route == ("simt" if dt == _F64 or D > 128 or
                     D * q.element_size() % 16 else "mma")
    do = _rand(dev, 7, dt, *q.shape)
    o, lse = cuda_ops._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
    dlse = _rand(dev, 8, torch.float32, *lse.shape)
    delta = cuda_ops._delta(do, o, dlse)
    want = cuda_ops._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                     D ** -0.5)
    tol = GENERAL_TOL[_F64 if dt == _F64 else _F32]
    for kw in (dict(delta=None, o=o, dlse=dlse), dict(delta=delta)):
        before = dict(cuda_ops.LAUNCHES)
        d = kw.pop("delta")
        got = cuda_ops._flash_bwd_cuda(q, k, v, do, lse, d, *offs, causal,
                                       D ** -0.5, **kw)
        again = cuda_ops._flash_bwd_cuda(q, k, v, do, lse, d, *offs, causal,
                                         D ** -0.5, **kw)
        torch.cuda.synchronize()
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            name += "_" + cuda_ops.BWD_ROUTES[route][1]
            assert cuda_ops.LAUNCHES[name] == before[name] + 2
        for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            assert g.dtype == w.dtype and torch.equal(g, g2), name
            err = _max_err(g, w)
            assert err <= tol * w.abs().max().item(), (name, err, kw.keys())


# (S, H, Hkv, D, psz, P, MP, lens, dtype): rep 16 and 32, page sizes 1,
# 7, 24 and 128, lengths of 0 and past the table, head_dim up to 256; the
# float32 page-7 rep-32 case's splits of 32 keys cross pages
GENERAL_PAGED_CASES = [
    (3, 32, 2, 128, 16, 40, 8, [0, 100, 128], _BF16),
    (2, 32, 1, 64, 24, 20, 6, [1, 144], _F32),
    (2, 4, 2, 16, 1, 120, 50, [50, 0], _F32),
    (2, 8, 2, 256, 128, 6, 2, [200, 256], _BF16),
    (2, 8, 8, 96, 24, 12, 4, [60, 99], _F64),
    (3, 8, 4, 32, 7, 30, 5, [34, 5, 7], _F16),
    (3, 32, 1, 64, 7, 130, 40, [0, 150, 300], _F32),
]


@pytest.mark.parametrize("case", GENERAL_PAGED_CASES)
def test_general_paged_kernel_matches_plain(dev, exact_fp32, case):
    S, H, Hkv, D, psz, P, MP, lens, dt = case
    q, kp, vp = (_rand(dev, 1, dt, S, H, D), _rand(dev, 2, dt, P, Hkv, psz, D),
                 _rand(dev, 3, dt, P, Hkv, psz, D))
    pt = torch.from_numpy(onp.random.RandomState(4).permutation(
        onp.arange(1, P))[:S * MP].reshape(S, MP).astype(onp.int32)).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = cuda_ops.LAUNCHES["paged_decode_general"]
    got = cuda_ops.paged_attention(q, kp, vp, pt, ln)
    again = cuda_ops.paged_attention(q, kp, vp, pt, ln)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["paged_decode_general"] == before + 2
    assert torch.equal(got, again)
    want = cuda_ops._paged_dense(q, kp, vp, pt, ln, D ** -0.5)
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any()
    assert _max_err(got, want) <= GENERAL_TOL[dt] * \
        want.double().abs().max().item()


def test_general_kernels_train_a_float32_layer(dev, exact_fp32):
    """flash_attention's autograd on float32 CUDA tensors (head_dim 16,
    GQA 4) runs the tensor-core forward, dq and dk/dv, and gives the
    plain CPU path's gradients."""
    q, k, v = (_rand(torch.device("cpu"), s, _F32, *shape) for s, shape in
               ((1, (2, 8, 24, 16)), (2, (2, 2, 24, 16)), (3, (2, 2, 24, 16))))
    grads = []
    cuda_ops.reset_launch_counts()
    for d in (dev, "cpu"):
        leaves = [t.to(d).requires_grad_() for t in (q, k, v)]
        o, lse = cuda_ops.flash_attention_with_lse(*leaves, causal=True)
        ((o * o).sum() + lse.sum()).backward()
        grads.append([t.grad.cpu() for t in leaves])
    for name in ("flash_fwd_mma", "flash_bwd_dq_mma",
                 "flash_bwd_dkv_mma"):
        assert cuda_ops.LAUNCHES[name] == 1
    for g, w in zip(*grads):
        assert _max_err(g, w) <= 1e-5 * w.abs().max().item()


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


def _resnet_block(dev, layout="NCHW", seed=0):
    from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1
    blk = BottleneckV1(64, 2, True, in_channels=32, layout=layout)
    return blk.initialize(device=dev,
                          generator=torch.Generator().manual_seed(seed))


def test_hybridized_block_replays_a_graph_equal_to_eager(dev):
    """``hybridize()`` captures the forward once per signature and
    replays it: the replayed output equals eager (same cuDNN algorithms,
    benchmark mode off), a second signature captures a second graph, a
    result survives the next replay, and replacing a parameter's
    storage invalidates the graph."""
    from mxnet_tpu_torch import autograd
    blk = _resnet_block(dev)
    x = torch.from_numpy(onp.random.RandomState(0).randn(
        4, 32, 16, 16).astype(onp.float32)).to(dev)
    with autograd.pause():
        want = blk(x)
        blk.hybridize()
        first = blk(x)                       # eager, then capture
        got = blk(x)                         # replay
        assert len(blk._graphs) == 1
        torch.testing.assert_close(first, want, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        other = blk(x[:2])
        assert len(blk._graphs) == 2
        torch.testing.assert_close(other, want[:2], rtol=1e-5, atol=1e-5)
        kept = blk(x * 2)
        blk(x)
        torch.testing.assert_close(kept, blk(x * 2), rtol=0, atol=0)
        w = blk.body[0].weight
        w.data = w.data * 0.5                # new storage: recapture
        halved = blk(x)
        blk.hybridize(False)
        torch.testing.assert_close(halved, blk(x), rtol=1e-5, atol=1e-5)
        assert not torch.allclose(halved, want)
        with autograd.record():              # recording runs eagerly
            blk.hybridize()
            blk(x).sum().backward()
        assert w.grad is not None


def test_hybridized_block_replays_outside_any_scope(dev):
    """MXNet's idiom ``net.hybridize(); net(x)`` with no scope: autograd
    is not recording there, so the block captures a graph and replays
    it, with torch's grad mode left on, and the result carries no
    autograd history."""
    from mxnet_tpu_torch import autograd
    blk = _resnet_block(dev)
    x = torch.from_numpy(onp.random.RandomState(0).randn(
        4, 32, 16, 16).astype(onp.float32)).to(dev)
    with autograd.pause():
        want = blk(x)
    blk.hybridize()
    assert torch.is_grad_enabled() and not autograd.is_recording()
    first, got = blk(x), blk(x)              # capture, then replay
    assert len(blk._graphs) == 1
    assert not first.requires_grad and not got.requires_grad
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.is_grad_enabled()


def test_hybridized_training_mode_updates_batch_norm_stats(dev):
    """In training mode a replay updates BatchNorm's running statistics
    in place, once per call, as eager calls do."""
    from mxnet_tpu_torch import autograd
    x = torch.from_numpy(onp.random.RandomState(1).randn(
        4, 32, 16, 16).astype(onp.float32)).to(dev)
    eager, hyb = _resnet_block(dev, seed=2), _resnet_block(dev, seed=2)
    hyb.hybridize()
    with autograd.pause(train_mode=True):
        for _ in range(3):
            torch.testing.assert_close(hyb(x), eager(x), rtol=1e-5,
                                       atol=1e-5)
    for (name, a), (_, b) in zip(eager.collect_params().items(),
                                 hyb.collect_params().items()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6, msg=name)


@pytest.fixture()
def fp32_convs():
    """cuDNN convolutions in full float32: its default TF32 keeps about
    three decimal digits, and the two layouts pick different kernels."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = tf32


def test_nhwc_equals_nchw_on_cuda(dev, fp32_convs):
    """The channels-last net on OHWI weights gives the NCHW net's
    output, in inference and with BatchNorm in training mode."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import export_params, load_params
    x = torch.from_numpy(onp.random.RandomState(3).randn(
        4, 32, 16, 16).astype(onp.float32)).to(dev)
    nchw, nhwc = _resnet_block(dev), _resnet_block(dev, "NHWC")
    with autograd.pause():
        nchw(x)
        nhwc(x.permute(0, 2, 3, 1).contiguous())
    params = {k: v.transpose(0, 2, 3, 1) if v.ndim == 4 else v
              for k, v in export_params(nchw).items()}
    load_params(nhwc, params)
    for mode in (autograd.pause(), autograd.record()):
        with mode:
            want = nchw(x)
            got = nhwc(x.permute(0, 2, 3, 1).contiguous())
        torch.testing.assert_close(got.permute(0, 3, 1, 2), want, rtol=1e-4,
                                   atol=1e-4)


def test_batch_norm_stats_follow_mxnet_momentum_on_cuda(dev):
    """bf16 input, float32 statistics: running = 0.9 * running + 0.1 *
    batch, with the biased batch variance."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.nn import BatchNorm
    x = (torch.from_numpy(onp.random.RandomState(4).randn(
        8, 16, 5, 5).astype(onp.float32)) * 3 + 1).to(dev, torch.bfloat16)
    bn = BatchNorm(in_channels=16).initialize(device=dev)
    with autograd.record():
        bn(x)
    xc = x.float().transpose(0, 1).reshape(16, -1)
    assert bn.running_mean.dtype == torch.float32
    torch.testing.assert_close(bn.running_mean.detach(), 0.1 * xc.mean(1),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bn.running_var.detach(),
                               0.9 + 0.1 * xc.var(1, unbiased=False),
                               rtol=1e-4, atol=1e-4)


def test_bert_layer_head_dim_64_runs_the_flash_kernels(dev):
    """A bf16 BERT layer with 4 heads of 64 on the card, non-causal and
    without a mask: the forward launches flash_fwd, the backward dq and
    dk/dv, once each; output and grads agree with the same weights on
    the CPU's plain path in relative norm (output to 1e-2, each grad to
    3e-2: bf16 matmuls and the kernels' bf16 P and dS; the key bias,
    whose true gradient is zero, is left out)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.convert import export_params, load_params
    from mxnet_tpu_torch.models.bert import BertLayer, bert_tiny_config
    cfg = bert_tiny_config(hidden_size=256, num_heads=4,
                           intermediate_size=1024, dtype="bfloat16",
                           dropout=0.0)
    net = BertLayer(cfg).initialize(
        device=dev, generator=torch.Generator().manual_seed(0))
    cpu = load_params(BertLayer(cfg).initialize(device="cpu"),
                      export_params(net))
    rng = onp.random.RandomState(5)
    x, w = (torch.from_numpy(rng.randn(2, 128, 256).astype(onp.float32))
            for _ in range(2))
    outs, grads = [], []
    cuda_ops.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        with autograd.record():     # a random projection of the output
            out = model(x.to(d)).float()
            loss = (out * w.to(d)).mean()
        autograd.backward(loss)
        outs.append(out.detach().cpu())
        grads.append({k: p.grad.float().cpu()
                      for k, p in model.collect_params().items()})
    assert (cuda_ops.LAUNCHES["flash_fwd"], cuda_ops.LAUNCHES["flash_bwd_dq"],
            cuda_ops.LAUNCHES["flash_bwd_dkv"]) == (1, 1, 1)
    assert ((outs[0] - outs[1]).norm() / outs[1].norm()).item() <= 1e-2
    for k, want in grads[1].items():
        if k == "attention.qkv.bias":
            want, got = (torch.cat([g[:256], g[512:]])    # the key bias's
                         for g in (want, grads[0][k]))   # true grad is 0
        else:
            got = grads[0][k]
        rel = ((got - want).norm() / want.norm()).item()
        assert rel <= 3e-2, (k, rel)


# ---------------------------------------------------------------------------
# the optimizer's multi-tensor kernels (csrc/multi_tensor.cu)
# ---------------------------------------------------------------------------
# A ragged list: empty, single, odd and past-a-chunk tensors, one more
# that is a view offset by one element (its pointers are not 16-byte
# aligned: the scalar path), and a few ordinary ones.
MT_NUMELS = [0, 1, 3, 4097, 16, 40000, 2 * 16384 + 5]
MT_UNALIGNED = 4           # index of the offset view
# (weight dtype, grad dtype, float32 master weights)
MT_DTYPES = [(torch.float32, torch.float32, False),
             (torch.bfloat16, torch.bfloat16, False),
             (torch.bfloat16, torch.float32, False),
             (torch.float16, torch.float16, True),
             (torch.float16, torch.float32, False)]
MANTISSA = {torch.float16: 10, torch.bfloat16: 7}


def _mt_groups(dev, wdt, gdt, mp, n_states, seed, numels=MT_NUMELS):
    """Groups (w, g, states..., w32 or None) on the card, from a seed."""
    gen = torch.Generator().manual_seed(seed)

    def put(x, dtype, offset=False):
        if offset:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            buf[1:].copy_(x)
            return buf[1:]
        return x.to(dev, dtype)
    groups = []
    for k, n in enumerate(numels):
        off = k == MT_UNALIGNED
        w = torch.randn(n, generator=gen)
        states = [put(torch.randn(n, generator=gen) * 0.1, torch.float32,
                      off)]
        if n_states == 2:
            states.append(put(torch.rand(n, generator=gen) + 0.1,
                              torch.float32, off))
        groups.append((put(w, wdt, off),
                       put(torch.randn(n, generator=gen) * 3, gdt, off),
                       *states, put(w, torch.float32, off) if mp else None))
    return groups


def _clone(groups):
    return [tuple(None if t is None else t.clone() for t in grp)
            for grp in groups]


def _mt_check(got, want):
    for gi, (gg, wg) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(gg, wg)):
            if a is None or not a.numel() or j == 1:
                continue
            if a.dtype in MANTISSA:
                top = torch.maximum(a.float().abs(), b.float().abs())
                step = torch.exp2(torch.floor(torch.log2(
                    top.clamp(min=2.0 ** -14))) - MANTISSA[a.dtype])
                assert bool(((a.float() - b.float()).abs() <= step).all()), \
                    (gi, j)
            else:
                d = (a - b).abs().max().item()
                assert d <= 1e-6 * b.abs().max().item(), (gi, j, d)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("mom", [False, True])
@pytest.mark.parametrize("dtypes", MT_DTYPES)
def test_multi_sgd_kernel_matches_plain(dev, dtypes, mom, nesterov):
    from mxnet_tpu_torch.ops import multi_tensor as mt
    wdt, gdt, mp = dtypes
    groups = _mt_groups(dev, wdt, gdt, mp, 1, 1)
    if not mom:
        groups = [(w, g, None, w32) for w, g, _, w32 in groups]
    plain = _clone(groups)
    n = len(groups)
    kw = dict(lrs=[0.1 * (k + 1) for k in range(n)],
              wds=[0.01 * k for k in range(n)], momentum=0.9,
              nesterov=nesterov, rescale=0.5, clip=1.0)
    before = cuda_ops.LAUNCHES["multi_sgd"]
    mt.multi_sgd(groups, **kw)
    mt.multi_sgd_plain(plain, **kw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["multi_sgd"] == before + 1
    _mt_check(groups, plain)


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("decoupled,bias", [(False, True), (True, True),
                                            (True, False)])
@pytest.mark.parametrize("dtypes", MT_DTYPES)
def test_multi_adam_kernel_matches_plain(dev, dtypes, decoupled, bias, clip):
    from mxnet_tpu_torch.ops import multi_tensor as mt
    wdt, gdt, mp = dtypes
    groups = _mt_groups(dev, wdt, gdt, mp, 2, 2)
    plain = _clone(groups)
    n = len(groups)
    kw = dict(lrs=[1e-3 * (k + 1) for k in range(n)],
              wds=[0.01 * k for k in range(n)],
              etas=[1.0 + k for k in range(n)],
              steps=[1 + 3 * k for k in range(n)], decoupled=decoupled,
              bias_correction=bias, rescale=0.5, clip=clip)
    before = cuda_ops.LAUNCHES["multi_adam"]
    mt.multi_adam(groups, **kw)
    mt.multi_adam_plain(plain, **kw)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["multi_adam"] == before + 1
    _mt_check(groups, plain)


@pytest.mark.parametrize("bounds", [(None, None), (0.5, 4.0)])
@pytest.mark.parametrize("dtypes", MT_DTYPES)
def test_multi_lamb_kernels_match_plain(dev, dtypes, bounds):
    """Both LAMB phases: weights and states as the other kernels', and
    each tensor's trust ratio within 1e-6 of the plain one's."""
    from mxnet_tpu_torch.ops import multi_tensor as mt
    wdt, gdt, mp = dtypes
    groups = _mt_groups(dev, wdt, gdt, mp, 2, 3)
    plain = _clone(groups)
    n = len(groups)
    kw = dict(lrs=[1e-2 * (k + 1) for k in range(n)],
              wds=[0.01 * k for k in range(n)],
              steps=[1 + k for k in range(n)], lower_bound=bounds[0],
              upper_bound=bounds[1], rescale=0.5, clip=1.0)
    ratios, want = (torch.full((n,), -1.0, device=dev) for _ in range(2))
    before = [cuda_ops.LAUNCHES[k] for k in ("multi_lamb_phase1",
                                             "multi_lamb_phase2")]
    mt.multi_lamb(groups, ratios=ratios, **kw)
    mt.multi_lamb_plain(plain, ratios=want, **kw)
    torch.cuda.synchronize()
    assert [cuda_ops.LAUNCHES[k] for k in ("multi_lamb_phase1",
                                           "multi_lamb_phase2")] == [
        b + 1 for b in before]
    _mt_check(groups, plain)
    assert ratios[0].item() == want[0].item() == -1.0    # the empty tensor
    rel = ((ratios - want).abs() / want.abs()).max().item()
    assert rel <= 1e-6, (ratios, want)


def test_multi_tensor_kernels_give_the_same_bits_and_cut_tables(dev):
    """1500 tiny tensors take ceil(1500 / TABLE) launches; two runs from
    the same inputs give the same bits."""
    from mxnet_tpu_torch.ops import multi_tensor as mt
    numels = [1 + (k * 37) % 300 for k in range(1500)]
    runs = []
    for _ in range(2):
        groups = _mt_groups(dev, torch.bfloat16, torch.bfloat16, False, 2,
                            4, numels)
        before = cuda_ops.LAUNCHES["multi_adam"]
        mt.multi_adam(groups, [1e-3] * 1500, [0.01] * 1500,
                      steps=[2] * 1500, decoupled=True)
        assert cuda_ops.LAUNCHES["multi_adam"] == before + -(-1500 //
                                                             mt.TABLE)
        lamb = _mt_groups(dev, torch.float32, torch.float32, False, 2, 5,
                          MT_NUMELS)
        mt.multi_lamb(lamb, [1e-2] * len(lamb), [0.01] * len(lamb),
                      steps=[3] * len(lamb))
        torch.cuda.synchronize()
        runs.append([t for grp in groups + lamb for t in grp
                     if t is not None])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_multi_tensor_kernels_refuse(dev):
    from mxnet_tpu_torch.ops import multi_tensor as mt
    w = torch.zeros(8, device=dev)
    with pytest.raises(TypeError):
        mt.multi_sgd([(w.double(), w.double(), None, None)], [0.1], [0.0])
    with pytest.raises(ValueError):
        mt.multi_adam([(w, w.cpu(), w, w, None)], [0.1], [0.0], steps=[1])
    with pytest.raises(ValueError):
        mt.multi_adam([(w, torch.zeros(4, 2, device=dev).t(), w, w, None)],
                      [0.1], [0.0], steps=[1])


@pytest.mark.parametrize("name,kw,kernel", [
    ("sgd", {"momentum": 0.9}, "multi_sgd"), ("nag", {"momentum": 0.9},
                                               "multi_sgd"),
    ("adam", {}, "multi_adam"), ("adamw", {}, "multi_adam"),
    ("lamb", {}, "multi_lamb_phase2")])
def test_optimizers_launch_one_kernel_per_group_and_match_cpu(dev, name, kw,
                                                              kernel):
    """An optimizer's list update on the card: one launch per dtype group
    (bf16 weights and float32 ones here), the weights within the kernels'
    limits of the same update on the CPU."""
    from mxnet_tpu_torch import optimizer
    gen = torch.Generator().manual_seed(6)
    ws = [torch.randn(n, generator=gen) for n in (300, 17, 5000, 64)]
    gs = [torch.randn(w.shape, generator=gen) for w in ws]
    out = {}
    for d in (dev, "cpu"):
        opt = optimizer.create(name, learning_rate=0.01, wd=0.01,
                               rescale_grad=0.5, clip_gradient=1.0, **kw)
        w = [x.to(d, torch.bfloat16 if k % 2 else torch.float32)
             for k, x in enumerate(ws)]
        st = [opt.create_state(k, x) for k, x in enumerate(w)]
        before = cuda_ops.LAUNCHES[kernel]
        opt.update(list(range(4)), w, [g.to(d, x.dtype) for g, x in
                                       zip(gs, w)], st)
        launched = cuda_ops.LAUNCHES[kernel] - before
        assert launched == (2 if d == dev else 0)
        out[str(d)] = w
    _mt_check([(a,) for a in out[str(dev)]],
              [(b.to(dev),) for b in out["cpu"]])


# ----------------------------------------------------------------------
# the int8 decode product and the serving programs as CUDA graphs
# ----------------------------------------------------------------------
# (dtype, limit on max|kernel - plain| / max|plain|): bf16 / fp16 output
# rounding (one step is 2^-8 / 2^-11 of the value) against cuBLAS's own
# rounding and summation order; float32 / float64 summation order only
INT8_TOL = {torch.bfloat16: 1e-2, torch.float16: 2e-3, torch.float32: 1e-5,
            torch.float64: 1e-12}
# (M, N, K): decode-like rows of 1, 8 and 17 slots (a second row tile),
# odd N and K (the scalar path), K below one staged tile, K = 0
INT8_SHAPES = [(1, 96, 4096), (8, 1024, 4096), (17, 33, 4096),
               (8, 31, 100), (3, 17, 1), (5, 64, 528), (2, 9, 0)]


def _int8_weight(dev, seed, N, K):
    from mxnet_tpu_torch.serve import quantize_weights
    if K == 0:          # no scale of an empty weight: any one will do
        return torch.zeros((N, 0), dtype=torch.int8, device=dev), 1.0
    w = torch.from_numpy(onp.random.RandomState(seed).randn(N, K)
                         .astype(onp.float32)).to(dev)
    q, scales = quantize_weights({"w": w})
    return q["w"], scales["w"]


@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("dtype", list(INT8_TOL))
def test_int8_linear_matches_plain(dev, dtype, shape):
    """The W8A16 kernel against ``F.linear(x, dequantize(q))`` on the same
    card inputs; two calls give the same bits."""
    from mxnet_tpu_torch.ops.int8 import int8_linear, int8_linear_plain
    M, N, K = shape
    q, scale = _int8_weight(dev, N + K, N, K)
    x = torch.from_numpy(onp.random.RandomState(M).randn(M, K).astype(
        onp.float32)).to(dev, dtype)
    before = cuda_ops.LAUNCHES["int8_linear"]
    got = int8_linear(x, q, scale)
    again = int8_linear(x, q, scale)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["int8_linear"] == before + 2
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, again)
    want = int8_linear_plain(x, q, scale)
    scale_ = max(want.abs().max().item(), 1e-30)
    assert _max_err(got, want) <= INT8_TOL[dtype] * scale_


@pytest.mark.parametrize("n", [4096 * 33, 16 * 5 + 7, 3, 0])
@pytest.mark.parametrize("dtype", list(INT8_TOL))
def test_int8_dequant_matches_plain_bit_for_bit(dev, dtype, n):
    """The prefill's dequantize against ``q * scale``: the same bits, on
    the vector path, its scalar tail, an unaligned view and no data."""
    from mxnet_tpu_torch.ops.int8 import dequantize, dequantize_plain
    q = torch.randint(-127, 128, (n + 1,), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(n)).to(dev)
    for view in (q[:n], q[1:]):
        before = cuda_ops.LAUNCHES["int8_dequant"]
        got = dequantize(view, 3.7e-3, dtype)
        assert cuda_ops.LAUNCHES["int8_dequant"] == before + (n > 0)
        assert got.dtype == dtype
        assert torch.equal(got, dequantize_plain(view, 3.7e-3, dtype))


def test_int8_linear_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.ops.int8 import int8_linear
    q, scale = _int8_weight(dev, 0, 16, 64)
    x = torch.zeros(2, 64, device=dev, dtype=torch.bfloat16)
    base = torch.zeros(16 * 64 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        int8_linear(x, base[1:].view(16, 64), scale)    # unaligned rows
    with pytest.raises(ValueError, match="contiguous"):
        int8_linear(torch.zeros(64, 2, device=dev).t(), q, scale)
    with pytest.raises(TypeError):
        int8_linear(x.int(), q, scale)
    with pytest.raises(ValueError):
        int8_linear(x, q.cpu(), scale)


def _graph_pool(dev, int8=False, layers=2):
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    from mxnet_tpu_torch.serve import ServeConfig, WarmPool
    cfg = tiny_config(dim=256, n_heads=4, n_kv_heads=2, n_layers=layers,
                      dtype="bfloat16")
    net = TransformerLM(cfg).initialize(
        torch.Generator(device=dev).manual_seed(0))
    return WarmPool(net, ServeConfig(slots=4, page_size=16, pages=32,
                                     ladder=(32, 64), max_new=8, int8=int8))


def _replay_vs_eager(pool, program, run):
    """``run()`` (fill the static inputs, replay ``program``) against an
    eager call of the very function captured, from the same pools:
    the tokens and the K/V written must be the same bits."""
    k0, v0 = pool.k_pages.clone(), pool.v_pages.clone()
    run()
    torch.cuda.synchronize()
    # page 0 is the trash page: padding tokens past true_len write there,
    # several to one slot where a chunk's padding outruns a page, in no
    # fixed order; no attended position reads it
    graphed = [t.clone() for t in (pool._dec_out, pool._pre_out,
                                   pool.k_pages[:, 1:], pool.v_pages[:, 1:])]
    pool.k_pages.copy_(k0)
    pool.v_pages.copy_(v0)
    with torch.no_grad():
        program.fn()
    torch.cuda.synchronize()
    eager = (pool._dec_out, pool._pre_out, pool.k_pages[:, 1:],
             pool.v_pages[:, 1:])
    assert not torch.equal(graphed[2], k0[:, 1:])   # it wrote the cache
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True])
def test_serving_graph_replays_equal_the_eager_function(dev, int8):
    pool = _graph_pool(dev, int8=int8)
    assert pool.stats["programs"] == 1 + 2 + 2
    assert pool.stats["int8"] is int8
    row = onp.arange(1, 1 + pool.spec.max_pages_per_slot, dtype=onp.int32)
    padded = onp.zeros(64, onp.int32)
    padded[:50] = onp.arange(3, 53)
    _replay_vs_eager(pool, pool._prefill[64], lambda: pool.run_prefill(
        padded, row, 50, sampling={"seed": 4, "temperature": 0.7}))
    _replay_vs_eager(pool, pool._chunk[32], lambda: pool.run_prefill(
        padded[:32], row, 20, start=40))
    S, MP = 4, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    table[1] = row
    lengths = onp.array([5, 50, 0, 17], onp.int32)
    sampling = [None, {"seed": 1, "step": 3, "temperature": 0.9,
                       "top_k": 20, "top_p": 0.9}, None, None]
    _replay_vs_eager(pool, pool._decode, lambda: pool.run_decode(
        table, lengths, onp.array([7, 8, 9, 10], onp.int32),
        onp.array([True, True, False, True]), sampling=sampling))


def test_graph_replays_count_their_launches(dev):
    """Each replay adds the launches its capture recorded: the decode
    graph one paged decode per layer (and one int8 product per Dense
    with int8 weights), a prefill graph one flash forward per layer."""
    pool = _graph_pool(dev, int8=True, layers=3)
    assert pool._decode.launches == {"paged_decode": 3,
                                     "int8_linear": 7 * 3 + 1}
    assert pool._prefill[32].launches == {"flash_fwd": 3,
                                          "int8_dequant": 7 * 3 + 1}
    cuda_ops.reset_launch_counts()
    S, MP = 4, pool.spec.max_pages_per_slot
    for n in range(1, 4):
        pool.run_decode(onp.ones((S, MP), onp.int32),
                        onp.full(S, n, onp.int32), onp.ones(S, onp.int32),
                        onp.ones(S, bool))
        assert cuda_ops.LAUNCHES["paged_decode"] == 3 * n
        assert cuda_ops.LAUNCHES["int8_linear"] == 22 * n
    pool.run_prefill(onp.ones(32, onp.int32), onp.ones(MP, onp.int32), 9)
    assert cuda_ops.LAUNCHES["flash_fwd"] == 3


def test_bf16_and_int8_replicas_of_one_net_serve_at_once(dev):
    """One net, two replicas: the int8 one captures its graphs while the
    bf16 one's engine thread decodes (and syncs to read its tokens);
    both serve, and the net's own weights stay as they were."""
    from mxnet_tpu_torch.serve import ServeConfig, Server
    pool = _graph_pool(dev)
    net = pool.net
    before = {k: p.detach().clone() for k, p in net.collect_params().items()}
    kw = dict(slots=4, page_size=16, pages=32, ladder=(32, 64), max_new=24)
    prompts = [list(range(1, 9 + 5 * i)) for i in range(6)]
    with Server(net, ServeConfig(**kw)) as a:
        rids = [a.submit(p) for p in prompts]
        b = Server(net, ServeConfig(int8=True, **kw))
        with b:
            got_b = [b.generate(p, timeout=300) for p in prompts[:3]]
        got_a = [a.result(r, timeout=300) for r in rids]
    assert b.pool.stats["int8"] and b.pool.stats["programs"] == 5
    for r in got_a + got_b:
        assert r["state"] == "done" and len(r["tokens"]) == 24
    for k, p in net.collect_params().items():
        assert torch.equal(p.detach(), before[k]), k


def test_server_raises_when_a_program_cannot_be_captured(dev,
                                                         monkeypatch):
    """A step that syncs with the host (``.item()``) cannot be captured:
    the Server raises at start-up and never runs it eagerly instead."""
    from mxnet_tpu_torch import serve
    sample = serve._sample_batch

    def syncing(logits, *args):
        out = sample(logits, *args)
        out.sum().item()
        return out

    monkeypatch.setattr(serve, "_sample_batch", syncing)
    with pytest.raises(RuntimeError):
        _graph_pool(dev, layers=1)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# low precision: multi_all_finite, int8_quantize, int8_conv
# ----------------------------------------------------------------------
FINITE_DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64]


@pytest.mark.parametrize("bad", [None, float("inf"), float("-inf"),
                                 float("nan")])
def test_multi_all_finite_matches_plain(dev, bad):
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    gen = torch.Generator(device=dev).manual_seed(3)
    sizes = [1, 7, 16384 + 3, 40000, 8]
    ts = [torch.randn(n, generator=gen, device=dev).to(
        FINITE_DTYPES[i % 4]) for i, n in enumerate(sizes)]
    ts.append(torch.randn(9, device=dev)[1:])       # not 16-byte aligned
    for j in range(len(ts)):
        u = [t.clone() for t in ts]
        if bad is not None:
            u[j][-1] = bad
        before = cuda_ops.LAUNCHES["multi_all_finite"]
        got = mtk.multi_all_finite(u)
        assert cuda_ops.LAUNCHES["multi_all_finite"] == before + 1
        assert got.item() == mtk.multi_all_finite_plain(u).item() == \
            (1.0 if bad is None else 0.0)
    many = [torch.ones(3, device=dev) for _ in range(600)]
    many[599][2] = float("nan")
    before = cuda_ops.LAUNCHES["multi_all_finite"]
    assert mtk.multi_all_finite(many).item() == 0.0
    assert cuda_ops.LAUNCHES["multi_all_finite"] == before + 3
    big = [torch.full((5,), 1e300, dtype=torch.float64, device=dev)]
    assert mtk.multi_all_finite(big).item() == 0.0
    assert mtk.multi_all_finite(big, narrow=False).item() == 1.0
    flag = torch.zeros(1, device=dev)
    assert mtk.multi_all_finite(ts, flag).item() == 0.0
    with pytest.raises(TypeError):
        mtk.multi_all_finite([torch.ones(3, dtype=torch.int32, device=dev)])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32, torch.int8])
def test_int8_quantize_matches_plain_bit_for_bit(dev, dtype):
    from mxnet_tpu_torch.ops.int8 import int8_quantize, int8_quantize_plain
    gen = torch.Generator(device=dev).manual_seed(4)
    for shape, groups in (((2, 3, 17, 19), 1), ((1, 12, 5, 7), 3),
                          ((5, 37), 1), ((2, 64, 14, 14), 2)):
        if dtype == torch.int8:
            x = torch.randint(-128, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8)
            scales = (1.0,)
        else:
            x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dtype)
            # .5 ties of the scale 0.5
            x.view(-1)[:8] = ((torch.arange(8, device=dev) + 0.5) * 0.5) \
                .to(dtype)
            scales = (0.0123, 0.5, 1 / 3)
        for s in scales:
            got = int8_quantize(x, s, groups)
            assert torch.equal(got, int8_quantize_plain(x, s, groups))


# (N, C, H, W, O, kernel, stride, pad, dilation, groups)
INT8_CONV_CASES = [
    (2, 3, 32, 32, 64, 7, 2, 3, 1, 1),       # the stem, C = 3
    (2, 64, 14, 14, 64, 3, 1, 1, 1, 1),
    (1, 256, 7, 7, 64, 1, 1, 0, 1, 1),       # batch 1
    (3, 37, 13, 11, 45, 3, 2, 0, 2, 1),      # C, O odd; dilation 2
    (1, 16, 9, 9, 24, 3, 1, 1, 1, 2),        # groups 2
    (2, 32, 9, 9, 32, 3, 2, 1, 1, 32),       # depthwise
    (4, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),    # ResNet-50's Dense
]


@pytest.mark.parametrize("case", INT8_CONV_CASES)
def test_int8_conv_matches_plain_bit_for_bit(dev, case):
    from mxnet_tpu_torch.ops import int8 as i8
    N, C, H, W, O, k, s, p, d, g = case
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(N, C, H, W, generator=gen, device=dev)
    xq = i8.int8_quantize(x, 0.02, g)
    wq = torch.randint(-127, 128, (O, C // g, k, k), generator=gen,
                       device=dev, dtype=torch.int8)
    wpk = i8.pack_conv_weight(wq, g)
    scale = torch.rand(O, generator=gen, device=dev) * 1e-3
    bias = torch.randn(O, generator=gen, device=dev)
    bi = torch.randint(-999, 999, (O,), generator=gen, device=dev,
                       dtype=torch.int32)
    geo = ((k, k), (s, s), (p, p), (d, d), g)
    for kw in (dict(out_dtype=torch.int32, bias_i32=bi),
               dict(out_dtype=torch.int32),
               dict(scale=scale, bias=bias, relu=True,
                    out_dtype=torch.float16),
               dict(scale=scale, out_dtype=torch.bfloat16),
               dict(scale=scale, bias=bias, out_dtype=torch.float32,
                    channels_last=True)):
        before = cuda_ops.LAUNCHES["int8_conv"]
        got = i8.int8_conv(xq, wpk, *geo, **kw)
        assert cuda_ops.LAUNCHES["int8_conv"] == before + 1
        assert torch.equal(got, i8.int8_conv_plain(xq, wpk, *geo, **kw))


def test_int8_conv_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.ops import int8 as i8
    xq = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="weight row of 64"):
        i8.int8_conv(xq, torch.zeros(1, 8, 64, dtype=torch.int8,
                                     device=dev), (3, 3))
    wpk = torch.zeros(1, 8, 128, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="scales"):
        i8.int8_conv(xq, wpk, (3, 3))
    with pytest.raises(TypeError):
        i8.int8_conv(xq, wpk, (3, 3), out_dtype=torch.float64,
                     scale=torch.ones(8, device=dev))
    with pytest.raises(ValueError):
        i8.int8_conv(xq, wpk, (3, 3), out_dtype=torch.int32,
                     bias_i32=torch.zeros(8, device=dev))
    with pytest.raises(TypeError):
        i8.int8_quantize(torch.zeros(2, 4, device=dev,
                                     dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="scale 1"):
        i8.int8_quantize(torch.zeros(2, 4, device=dev, dtype=torch.int8),
                         0.5)


def test_quantized_net_hybridizes_into_graphs(dev):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, activation="relu"), nn.MaxPool2D(2),
            nn.Conv2D(16, 3, padding=1), nn.BatchNorm(),
            nn.GlobalAvgPool2D(), nn.Dense(10))
    net.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(6))
    x = torch.rand(4, 3, 16, 16, device=dev)
    with autograd.pause():
        ref = net(x)
    q.quantize_net(net, calib_data=[x])
    cuda_ops.reset_launch_counts()
    with autograd.pause():
        eager = net(x)
    assert cuda_ops.LAUNCHES["int8_conv"] == 3
    assert cuda_ops.LAUNCHES["int8_quantize"] == 3
    net.hybridize()
    net(x)
    out = net(x)
    assert len(net._graphs) == 1 and torch.equal(out, eager)
    assert (out.argmax(-1) == ref.argmax(-1)).float().mean() >= 0.75


def test_amp_step_guard_on_the_card(dev):
    from mxnet_tpu_torch import amp, autograd, fault, gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.Dense(4, in_units=6).initialize(device=dev)
    amp.convert_hybrid_block(net, "float16")
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
    amp.init("float16")
    amp.init_trainer(tr)
    guard = fault.GradGuard(tr)
    x = torch.randn(3, 6, device=dev, dtype=torch.float16)
    fault.inject("nan_grad", at=1)
    try:
        with autograd.record():
            loss = (net(x).float() ** 2).mean()
            with amp.scale_loss(loss, tr) as scaled:
                autograd.backward(scaled)
        w = net.weight.detach().clone()
        cuda_ops.reset_launch_counts()
        tr.step(3)
        assert torch.equal(net.weight.detach(), w)
        assert guard.skipped == 1
        assert tr._amp_loss_scaler.loss_scale == 2.0 ** 15
        assert cuda_ops.LAUNCHES["multi_all_finite"] == 1
    finally:
        fault.clear()
