"""The port's flash backward (``cuda_ops._FlashAttention`` and
``flash_attention_block_bwd``) against the JAX package's Pallas backward
kernels ``_bwd_dq_call`` / ``_bwd_dkv_call``.

On the CPU the port runs the plain recompute backward
(``_flash_bwd_dense``); the JAX side runs the Pallas kernels in
interpret mode (as ``tests/test_flash_attention.py`` does), so the plain
version is held against the TPU kernels' semantics: GQA, runtime causal
offsets, fully masked rows and the lse cotangent folded into delta.
fp32 throughout; the tolerance, 1e-5, is fp32 summation-order noise over
D = 64 and Tk <= 256 on N(0, 1) inputs (the largest difference measured
here is 3e-6).  The CUDA kernels are held against the same plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.ops import cuda_ops

ATOL = 1e-5

CASES = [
    (128, 128, False, 0, 0),
    (128, 128, True, 0, 0),
    (256, 256, True, 0, 0),
    (128, 256, True, 256, 128),   # a later ring step: offsets shift
    (128, 128, True, 0, 100),     # rows 0..99 see no key: lse -inf
]


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)


def _inputs(seed, T, Tk, H=4, Hkv=2, D=64):
    rng = onp.random.RandomState(seed)
    return (rng.randn(1, H, T, D).astype(onp.float32),
            rng.randn(1, Hkv, Tk, D).astype(onp.float32),
            rng.randn(1, Hkv, Tk, D).astype(onp.float32),
            rng.randn(1, H, T, D).astype(onp.float32),    # dO
            rng.randn(1, H, T).astype(onp.float32))       # dlse


def _torch_grads(q, k, v, do, dlse, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = cuda_ops.flash_attention_with_lse(q, k, v, **kw)
    return [g.numpy() for g in torch.autograd.grad(
        (o, lse), (q, k, v), (torch.from_numpy(do), torch.from_numpy(dlse)))]


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off", CASES)
def test_flash_grads_match_pallas_backward_kernels(interpret_kernels, T, Tk,
                                                   causal, q_off, k_off):
    q, k, v, do, dlse = _inputs(T + Tk + k_off, T, Tk)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    (o_j, lse_j), vjp = jax.vjp(
        lambda q, k, v: pallas_ops.flash_attention_with_lse(q, k, v, **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    got = _torch_grads(q, k, v, do, dlse, **kw)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, onp.asarray(w), atol=ATOL, rtol=0)
    if k_off > q_off:   # a row that sees no key gets no gradient
        masked = onp.isneginf(onp.asarray(lse_j))[..., None]
        assert masked.any() and not got[0][masked[..., 0]].any()


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off", CASES)
def test_block_bwd_matches_pallas(interpret_kernels, T, Tk, causal, q_off,
                                  k_off):
    """One block's (dq, dk, dv) against a global lse that other blocks
    raised (logaddexp with an outside term) and a delta from a merged
    output, as the ring passes them."""
    q, k, v, do, _ = _inputs(T * 3 + Tk + k_off, T, Tk)
    rng = onp.random.RandomState(T + q_off)
    _, lse_blk = cuda_ops.flash_attention_with_lse(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_offset=q_off, k_offset=k_off)
    lse = onp.logaddexp(lse_blk.numpy(),
                        rng.randn(1, 4, T).astype(onp.float32))
    delta = (do * rng.randn(*do.shape).astype(onp.float32)).sum(-1)
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    want = pallas_ops.flash_attention_block_bwd(
        *(jnp.asarray(a) for a in (q, k, v, do, lse, delta)), **kw)
    got = cuda_ops.flash_attention_block_bwd(
        *(torch.from_numpy(onp.ascontiguousarray(a))
          for a in (q, k, v, do, lse, delta)), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        onp.testing.assert_allclose(g.numpy(), onp.asarray(w), atol=ATOL,
                                    rtol=0)


def test_recompute_backward_equals_autograd_of_dense_forward():
    """The recompute formula alone, on ragged shapes the kernels' tiles
    do not divide: the ``_FlashAttention`` CPU backward against torch
    autograd through ``_dense_with_lse`` itself."""
    T, Tk, D = 37, 53, 16
    q, k, v, do, dlse = _inputs(5, T, Tk, H=6, Hkv=2, D=D)
    kw = dict(causal=True, q_offset=20, k_offset=30)
    got = _torch_grads(q, k, v, do, dlse, **kw)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    offs = [torch.tensor([x], dtype=torch.int32) for x in (20, 30)]
    o, lse = cuda_ops._dense_with_lse(qt, kt, vt, *offs, True, D ** -0.5)
    want = torch.autograd.grad((o, lse), (qt, kt, vt),
                               (torch.from_numpy(do), torch.from_numpy(dlse)))
    assert torch.isneginf(lse).any()
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=0)


def test_cpu_backward_launches_no_kernel():
    cuda_ops.reset_launch_counts()
    q, k, v, do, dlse = _inputs(6, 16, 16)
    _torch_grads(q, k, v, do, dlse, causal=True)
    cuda_ops.flash_attention_block_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, do)),
        torch.zeros(1, 4, 16), torch.from_numpy(dlse))
    assert set(cuda_ops.LAUNCHES.values()) == {0}
