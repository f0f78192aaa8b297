"""The tensor-core flash forward (``csrc/flash_fwd_mma.cu``): its
arithmetic emulated on the CPU, and the route that picks it.

The kernel cannot run here, so its arithmetic is emulated in numpy in
its own order, with ``test_torch_bwd_mma.py``'s TF32 helpers: float32
operands split into hi = tf32(x) and lo = tf32(x - hi); each m16n8k8
``mma`` a sum of 8 exact products added to a float32 accumulator; the
terms of a product in the kernel's order (lo.hi, hi.lo, hi.hi) over k
steps of 8, each step summed apart from zero and then added to its
accumulator (``mma.cuh`` ``mma3_add``).  Keys are taken in the kernel's
tiles (``BN``: 64 keys, 32 for float32 at a head dim padded to 128):
per tile S = Q K^T over the head dim; the running max of s * scale *
log2(e) per row; P = exp2(fma(s, scale log2 e, -m)); the row sums and
O rescaled by exp2(m_old - m); O += P V over the tile's keys in steps
of 8, P split like any float32 operand.  A row that sees no key gives
O = 0 and lse = -inf; lse = (m + log2(l)) ln 2.

The emulation is held against the JAX package's forward
(``pallas_ops.flash_attention_with_lse``: its Pallas kernel in interpret
mode where it takes the shape, as ``test_torch_attention.py`` runs it,
else its dense fallback) within 1e-5 of max|ref| for O and the lse, the
kernel's limit on the card (``tests/test_torch_cuda.py``
``GENERAL_TOL``, ``chip_smoke.py``).  The same emulation with one TF32
product (no split) exceeds that limit: the reason for 3xTF32.

These tests check the design's arithmetic, not the kernel: they run
none of ``flash_fwd_mma.cu``, so a change to its tiles, split or
accumulation does not fail them.  They mirror its constants (``BN``,
k steps of 8, ``mma3_add``'s order of terms, exp2 with the scale folded
into log2 e), which change together with the source.  The kernel itself
is held against ``_dense_with_lse`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.ops import cuda_ops
from test_torch_bwd_mma import LOG2E, _mma, _pad8

LIMIT = 1e-5          # of max |ref|, per tensor
LN2 = onp.float32(0.6931471805599453)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)


def _f32(x):
    return onp.asarray(x, onp.float64).astype(onp.float32)


def emulate(q, k, v, causal, q_off, k_off, passes=3):
    """(o, lse) of the kernel, float32, emulated."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    bn = 32 if D > 64 else 64                 # the kernel's BN at float32
    sl2 = onp.float32(onp.float32(D ** -0.5) * LOG2E)
    qp = _pad8(q, 3)
    kf, vf = (onp.repeat(_pad8(x, 3), rep, axis=1) for x in (k, v))
    qpos = q_off + onp.arange(T)
    kpos = k_off + onp.arange(Tk)
    vis = (qpos[:, None] >= kpos[None, :]) if causal else \
        onp.ones((T, Tk), bool)
    m = onp.full((B, H, T), -onp.inf, onp.float32)
    l = onp.zeros((B, H, T), onp.float32)
    o = onp.zeros(qp.shape, onp.float32)
    for j0 in range(0, Tk, bn):
        kt, vt = kf[:, :, j0:j0 + bn], vf[:, :, j0:j0 + bn]
        on = vis[:, j0:j0 + bn]
        s = _mma(onp.zeros((B, H, T, kt.shape[2]), onp.float32), qp,
                 kt.swapaxes(-1, -2), passes)
        x = onp.where(on, _f32(s.astype(onp.float64) * sl2), -onp.inf)
        mt = onp.maximum(m, x.max(-1))
        ms = onp.where(onp.isneginf(mt), onp.float32(0), mt)
        corr = _f32(onp.exp2(m.astype(onp.float64) - ms))
        # fma(s, sl2, -m): the product exact, one rounding
        arg = _f32(s.astype(onp.float64) * onp.float64(sl2) - ms[..., None])
        p = onp.where(on, _f32(onp.exp2(arg.astype(onp.float64))),
                      onp.float32(0))
        l = _f32(l * corr + p.sum(-1, dtype=onp.float64))
        o = _f32(o * corr[..., None])
        o = _mma(o, _pad8(p, 3), _pad8(vt, 2), passes)
        m = mt
    empty = l == 0
    lsafe = onp.where(empty, onp.float32(1), l)
    o = onp.where(empty[..., None], onp.float32(0),
                  _f32(o / lsafe[..., None]))[..., :D]
    lse = onp.where(empty, -onp.inf,
                    _f32((m + onp.log2(lsafe.astype(onp.float64))) * LN2))
    return o, lse.astype(onp.float32)


# (T, Tk, causal, q_off, k_off, H, Hkv, D), GQA 4 throughout: the Pallas
# kernel's shape (D 64, T 128) on a later ring step over 4 key tiles, a
# ring step at D 16 whose first rows see no key, and D 96 (padded to 128,
# 32-key tiles) with a ragged T
CASES = [
    pytest.param(128, 256, True, 256, 128, 4, 1, 64, id="d64-ring-pallas"),
    pytest.param(72, 150, True, 20, 60, 4, 1, 16, id="d16-ring-masked"),
    pytest.param(70, 90, False, 0, 0, 4, 1, 96, id="d96-ragged"),
]


def _rel(got, want):
    fin = onp.isfinite(want)
    return onp.abs(got[fin] - want[fin]).max() / onp.abs(want[fin]).max()


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off,H,Hkv,D", CASES)
def test_3xtf32_emulation_meets_the_limit_and_1xtf32_does_not(
        interpret_kernels, T, Tk, causal, q_off, k_off, H, Hkv, D):
    rng = onp.random.RandomState(T + D)
    q = rng.randn(1, H, T, D).astype(onp.float32)
    k, v = (rng.randn(1, Hkv, Tk, D).astype(onp.float32) for _ in range(2))
    o_ref, lse_ref = (onp.asarray(x) for x in
                      pallas_ops.flash_attention_with_lse(
                          *(jnp.asarray(x) for x in (q, k, v)),
                          causal=causal, q_offset=q_off, k_offset=k_off))
    o, lse = emulate(q, k, v, causal, q_off, k_off)
    assert o.shape == o_ref.shape and lse.shape == lse_ref.shape
    assert onp.array_equal(onp.isneginf(lse), onp.isneginf(lse_ref))
    assert _rel(o, o_ref) <= LIMIT, _rel(o, o_ref)
    assert _rel(lse, lse_ref) <= LIMIT, _rel(lse, lse_ref)
    o1, lse1 = emulate(q, k, v, causal, q_off, k_off, passes=1)
    assert _rel(o1, o_ref) > LIMIT and _rel(lse1, lse_ref) > LIMIT, \
        (_rel(o1, o_ref), _rel(lse1, lse_ref))
    if k_off > q_off:          # rows that see no key: O = 0, lse = -inf
        empty = onp.isneginf(lse)
        assert empty.any() and not o[empty].any()


_F16, _BF16, _F32, _F64 = (torch.float16, torch.bfloat16, torch.float32,
                           torch.float64)


def _qkv(dtype, D, aligned):
    """q, k, v (1, 2, 4, D) of ``dtype`` on the CPU; with ``aligned``
    False each starts one element past a 16-byte boundary."""
    n = 2 * 4 * D
    out = []
    for _ in range(3):
        flat = torch.zeros(n + 1, dtype=dtype)
        out.append((flat[:n] if aligned else flat[1:]).view(1, 2, 4, D))
    return out


@pytest.mark.parametrize("dtype", [_F16, _BF16, _F32, _F64])
@pytest.mark.parametrize("D", [1, 4, 6, 8, 12, 16, 32, 40, 64, 96, 128, 136,
                               256])
@pytest.mark.parametrize("aligned", [True, False])
def test_fwd_route(monkeypatch, dtype, D, aligned):
    """``_flash_fwd_cuda`` sends aligned bf16 at 64 / 128 to the Hopper
    kernel, float16 / bfloat16 / float32 up to 128 with 16-byte rows on
    16-byte boundaries to the tensor-core kernel, and the rest to the
    general one: the routes of ``_flash_route``, read from q, k and v."""
    calls = []
    monkeypatch.setattr(cuda_ops, "_flash_fwd_hopper",
                        lambda *a: calls.append("hopper"))
    monkeypatch.setattr(cuda_ops, "_flash_fwd_general",
                        lambda *a: calls.append(a[-1]))
    q, k, v = _qkv(dtype, D, aligned)
    cuda_ops._flash_fwd_cuda(q, k, v, None, None, False, 1.0)
    ok = aligned and D * q.element_size() % 16 == 0
    want = ("hopper" if ok and dtype == _BF16 and D in (64, 128) else
            "mma" if ok and dtype != _F64 and D <= 128 else "simt")
    assert calls == [want]

