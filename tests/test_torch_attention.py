"""The port's attention ops (``mxnet_tpu_torch.ops.cuda_ops``) against
the JAX package's Pallas kernels.

On the CPU the port runs each kernel's plain PyTorch version; the JAX
side runs the actual Pallas kernels in interpret mode (as
``tests/test_flash_attention.py`` does), so the plain versions are held
against the TPU kernels' semantics -- GQA, runtime causal offsets, fully
masked rows, ragged page lengths, an empty slot.  fp32 throughout; the
tolerance is fp32 summation-order noise over D <= 128 and Tk <= 384.
The hand-written CUDA kernels are held against the same plain versions
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.ops import cuda_ops
from mxnet_tpu_torch.ops.int8 import (dequantize, int8_conv, int8_linear,
                                      int8_quantize, int8_quantize_im2col,
                                      pack_conv_weight)
from mxnet_tpu_torch.ops.multi_tensor import multi_all_finite

ATOL = 2e-5


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)


def _qkv(seed, B, H, Hkv, T, Tk, D):
    rng = onp.random.RandomState(seed)
    return (rng.randn(B, H, T, D).astype(onp.float32),
            rng.randn(B, Hkv, Tk, D).astype(onp.float32),
            rng.randn(B, Hkv, Tk, D).astype(onp.float32))


def _assert_lse_close(got, want):
    got, want = onp.asarray(got), onp.asarray(want)
    assert onp.array_equal(onp.isneginf(got), onp.isneginf(want))
    fin = onp.isfinite(want)
    onp.testing.assert_allclose(got[fin], want[fin], atol=ATOL, rtol=0)


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off", [
    (128, 128, False, 0, 0),
    (128, 128, True, 0, 0),
    (256, 256, False, 0, 0),
    (256, 256, True, 0, 0),
    (128, 256, True, 256, 128),   # a later ring step: offsets shift
    (128, 128, True, 0, 100),     # rows 0..99 see no key: lse -inf, O 0
])
def test_flash_with_lse_matches_pallas_kernel(interpret_kernels, T, Tk,
                                              causal, q_off, k_off):
    q, k, v = _qkv(T + Tk + q_off, 1, 4, 2, T, Tk, 64)
    o_j, lse_j = pallas_ops.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_off, k_offset=k_off)
    o_t, lse_t = cuda_ops.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_off, k_offset=k_off)
    onp.testing.assert_allclose(o_t.numpy(), onp.asarray(o_j), atol=ATOL,
                                rtol=0)
    _assert_lse_close(lse_t.numpy(), lse_j)
    if k_off > q_off:
        masked = onp.isneginf(lse_t.numpy())
        assert masked.any()
        assert not o_t.numpy()[masked].any()


def test_flash_attention_matches_pallas_kernel(interpret_kernels):
    q, k, v = _qkv(7, 1, 4, 2, 128, 128, 64)
    o_j = pallas_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True)
    o_t = cuda_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    onp.testing.assert_allclose(o_t.numpy(), onp.asarray(o_j), atol=ATOL,
                                rtol=0)


def _paged_case(seed=2):
    """The case of tests/test_serve.py's kernel-vs-fallback test."""
    S, H, Hkv, D, psz, P, MP = 3, 8, 2, 64, 128, 7, 3
    rng = onp.random.RandomState(seed)
    q = rng.randn(S, H, D).astype(onp.float32)
    kp = rng.randn(P, Hkv, psz, D).astype(onp.float32)
    vp = rng.randn(P, Hkv, psz, D).astype(onp.float32)
    pt = rng.randint(1, P, (S, MP)).astype(onp.int32)
    lens = onp.array([5, 3 * psz, 0], onp.int32)
    return q, kp, vp, pt, lens


def test_paged_attention_matches_pallas_kernel(interpret_kernels):
    q, kp, vp, pt, lens = _paged_case()
    D = q.shape[-1]
    want = pallas_ops._paged_kernel_call(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lens), D ** -0.5)
    got = cuda_ops.paged_attention(*(torch.from_numpy(a) for a in
                                     (q, kp, vp, pt, lens)))
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=ATOL,
                                rtol=0)
    assert not got.numpy()[2].any()   # the empty slot returns zeros


def test_cpu_path_launches_no_kernel():
    cuda_ops.reset_launch_counts()
    q, kp, vp, pt, lens = (torch.from_numpy(a) for a in _paged_case())
    cuda_ops.paged_attention(q, kp, vp, pt, lens)
    qq, kk, vv = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 16, 16, 64))
    cuda_ops.flash_attention(qq, kk, vv, causal=True)
    int8_linear(qq[0, 0], torch.ones(5, 64, dtype=torch.int8), 0.5)
    dequantize(torch.ones(5, 64, dtype=torch.int8), 0.5, torch.float32)
    xq = int8_quantize(qq[0, 0].reshape(1, 4, 16, 16), 0.5)
    int8_conv(xq, pack_conv_weight(torch.ones(3, 4, 3, 3, dtype=torch.int8),
                                   1), (3, 3), out_dtype=torch.int32)
    int8_quantize_im2col(qq[0, 0].reshape(1, 4, 16, 16), 0.5, (3, 3))
    multi_all_finite([qq, kk])
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_decode")
    assert cuda_ops.LAUNCHES == dict.fromkeys(
        [name for k in kernels for name in (k, k + "_general")]
        + ["flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
           "multi_sgd", "multi_adam", "multi_lamb_phase1",
           "multi_lamb_phase2", "multi_all_finite", "int8_linear",
           "int8_dequant", "int8_quantize", "int8_quantize_im2col",
           "int8_conv", "int8_conv_hopper", "int8_conv_general",
           "int8_conv_depthwise"], 0)


def test_gqa_head_mismatch_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 3, 2, 8, 8, 64))
    with pytest.raises(ValueError, match="not a multiple"):
        cuda_ops.flash_attention(q, k, v)
