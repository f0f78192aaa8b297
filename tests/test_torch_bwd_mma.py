"""The tensor-core flash backward (``csrc/flash_bwd_mma.cu``): its
arithmetic emulated on the CPU, and the route that picks it.

The kernels cannot run here, so their arithmetic is emulated in numpy
in their own order: TF32 operands rounded as ``cvt.rna.tf32.f32`` does
it (``(bits + 0x1000) & 0xFFFFE000``); float32 operands split into
hi = tf32(x) and lo = tf32(x - hi); each m16n8k8 ``mma`` a sum of 8
exact products added to a float32 accumulator (summed in float64, then
rounded: an ideal tensor core), the terms of a product in the kernels'
order (lo.hi, hi.lo, hi.hi) over k steps of 8, each step summed apart
from zero and then added to its accumulator; S = Q K^T and dP = dO
V^T over the head dim, then P = exp2(fma(S, scale log2 e, -lse log2 e)),
dS = P (dP - delta) scale; dq summed over keys in steps of 8, dk / dv
over the GQA group's heads and then over queries in steps of 8 from
each 64-key block's first visible query.

The emulation is held against the JAX package's backward
(``pallas_ops.flash_attention_block_bwd``: its Pallas kernels in
interpret mode where they take the shape, as ``test_torch_flash_bwd.py``
runs them, else its dense fallback) within 1e-5 of max|ref|, the
kernels' limit on the card (``tests/test_torch_cuda.py``
``GENERAL_TOL``, ``chip_smoke.py``).  The same emulation with one TF32
product (no split) exceeds that limit: the reason for 3xTF32.

These tests check the design's arithmetic, not the kernels: they run
none of ``flash_bwd_mma.cu``, so a change to its tile order, split or
accumulation does not fail them.  They mirror its constants (``BM`` 64
rows or keys a CTA, k steps of 8, ``mma.cuh`` ``mma3_add``'s order of
terms), which change together with the source.  The kernels themselves
are held against ``_flash_bwd_dense`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.ops import cuda_ops

LIMIT = 1e-5          # of max |ref|, per tensor
BM = 64               # rows (dq) / keys (dk/dv) a CTA owns
LOG2E = onp.float32(1.4426950408889634)


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away."""
    b = onp.ascontiguousarray(x, onp.float32).view(onp.uint32)
    return ((b + onp.uint32(0x1000)) & onp.uint32(0xFFFFE000)).view(
        onp.float32)


def _parts(x, passes):
    """(hi, lo) of float32 ``x``; lo is None for one pass or where x is
    exact in TF32 (the kernels skip that mma)."""
    hi = tf32(x)
    if passes == 1:
        return hi, None
    lo = tf32(x - hi)
    return hi, (lo if lo.any() else None)


def _f32_add(acc, x):
    return (acc.astype(onp.float64) + x).astype(onp.float32)


def _mma(acc, a, b, passes):
    """acc += a @ b over k steps of 8: each step's terms lo.hi, hi.lo,
    hi.hi (3xTF32) or hi.hi alone, each an ideal mma (exact products
    summed in float64, added to a float32 accumulator) into a sum of
    their own from zero, which is then added to ``acc`` in float32."""
    for k0 in range(0, a.shape[-1], 8):
        ah, al = _parts(a[..., k0:k0 + 8], passes)
        bh, bl = _parts(b[..., k0:k0 + 8, :], passes)
        step = onp.zeros_like(acc)
        for x, y in [(al, bh), (ah, bl), (ah, bh)]:
            if x is not None and y is not None:
                step = _f32_add(step, x.astype(onp.float64)
                                @ y.astype(onp.float64))
        acc = _f32_add(acc, step)
    return acc


def _pad8(x, axis):
    n = (-x.shape[axis]) % 8
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n)
    return onp.pad(x, pad)


def _probs(s, ds_in, lse, delta, vis, scale):
    """P and dS from the S and dP accumulators, as the kernels form
    them (lse -inf read as 0, invisible pairs 0)."""
    L = onp.where(onp.isneginf(lse), 0, lse * LOG2E).astype(onp.float32)
    arg = (s.astype(onp.float64) * onp.float64(onp.float32(scale * LOG2E))
           - L.astype(onp.float64)).astype(onp.float32)
    p = onp.where(vis, onp.exp2(arg), onp.float32(0)).astype(onp.float32)
    return p, (p * (ds_in - delta) * onp.float32(scale)).astype(onp.float32)


def emulate(q, k, v, do, lse, delta, causal, q_off, k_off, passes=3):
    """(dq, dk, dv) of the two kernels, float32, emulated."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = onp.float32(D ** -0.5)
    qp, kp, vp, dop = (_pad8(x, 3) for x in (q, k, v, do))
    kf, vf = (onp.repeat(x, rep, axis=1) for x in (kp, vp))
    qpos = q_off + onp.arange(T)
    kpos = k_off + onp.arange(Tk)
    vis = (qpos[:, None] >= kpos[None, :]) if causal else \
        onp.ones((T, Tk), bool)
    zero = onp.zeros((B, H, T, Tk), onp.float32)
    s = _mma(zero, qp, kf.swapaxes(-1, -2), passes)
    dp = _mma(zero, dop, vf.swapaxes(-1, -2), passes)
    p, ds = _probs(s, dp, lse[..., None], delta[..., None], vis, scale)
    # dq: keys in steps of 8 (zero-padded keys add nothing)
    dq = _mma(onp.zeros(qp.shape, onp.float32), _pad8(ds, 3),
              _pad8(kf, 2), passes)[..., :D]
    # dk / dv: per 64-key block, heads r of the group, then queries in
    # steps of 8 from the block's first visible query
    dk = onp.zeros(kp.shape, onp.float32)
    dv = onp.zeros(kp.shape, onp.float32)
    pT = p.reshape(B, Hkv, rep, T, Tk).swapaxes(-1, -2)
    dsT = ds.reshape(B, Hkv, rep, T, Tk).swapaxes(-1, -2)
    qg = qp.reshape(B, Hkv, rep, T, -1)
    dog = dop.reshape(B, Hkv, rep, T, -1)
    for j0 in range(0, Tk, BM):
        blk = slice(j0, min(j0 + BM, Tk))
        t0 = min(T, max(0, k_off + j0 - q_off)) if causal else 0
        for r in range(rep):
            pr = _pad8(pT[:, :, r, blk, t0:], 3)
            sr = _pad8(dsT[:, :, r, blk, t0:], 3)
            dv[:, :, blk] = _mma(dv[:, :, blk], pr,
                                 _pad8(dog[:, :, r, t0:], 2), passes)
            dk[:, :, blk] = _mma(dk[:, :, blk], sr,
                                 _pad8(qg[:, :, r, t0:], 2), passes)
    return dq, dk[..., :D], dv[..., :D]


# (T, Tk, causal, q_off, k_off, H, Hkv, D), GQA rep 2 throughout: the
# Pallas kernels' shape (D 64, T 128), a later ring step at D 16 with
# rows that see no key, and D 96 with a ragged T
CASES = [
    pytest.param(128, 256, True, 256, 128, 4, 2, 64, id="d64-ring-pallas"),
    pytest.param(72, 150, True, 20, 60, 4, 2, 16, id="d16-ring-masked"),
    pytest.param(70, 90, False, 0, 0, 2, 1, 96, id="d96-ragged"),
]


def _case(T, Tk, causal, q_off, k_off, H, Hkv, D, seed=0):
    rng = onp.random.RandomState(seed + T + D)
    q, do = (rng.randn(1, H, T, D).astype(onp.float32) for _ in range(2))
    k, v = (rng.randn(1, Hkv, Tk, D).astype(onp.float32) for _ in range(2))
    offs = [torch.tensor([x], dtype=torch.int32) for x in (q_off, k_off)]
    o, lse = cuda_ops._dense_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), *offs, causal, D ** -0.5)
    delta = (do * o.numpy()).sum(-1).astype(onp.float32)
    return q, k, v, do, lse.numpy(), delta


def _rel(got, want):
    return onp.abs(got - want).max() / onp.abs(want).max()


@pytest.mark.parametrize("T,Tk,causal,q_off,k_off,H,Hkv,D", CASES)
def test_3xtf32_emulation_meets_the_limit_and_1xtf32_does_not(
        interpret_kernels, T, Tk, causal, q_off, k_off, H, Hkv, D):
    q, k, v, do, lse, delta = _case(T, Tk, causal, q_off, k_off, H, Hkv, D)
    want = [onp.asarray(w) for w in pallas_ops.flash_attention_block_bwd(
        *(jnp.asarray(x) for x in (q, k, v, do, lse, delta)),
        causal=causal, q_offset=q_off, k_offset=k_off)]
    got = emulate(q, k, v, do, lse, delta, causal, q_off, k_off)
    one = emulate(q, k, v, do, lse, delta, causal, q_off, k_off, passes=1)
    for name, g, g1, w in zip(("dq", "dk", "dv"), got, one, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= LIMIT, (name, _rel(g, w))
        assert _rel(g1, w) > LIMIT, (name, _rel(g1, w))
    if k_off > q_off:          # rows that see no key get no gradient
        masked = onp.isneginf(lse)
        assert masked.any() and not got[0][masked].any()


def test_tf32_rounding_is_cvt_rna():
    """Ties round away from zero, the mantissa keeps 10 bits, and a
    split's parts sum back to within 2^-22 of the value."""
    x = onp.array([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                   1 + 3 * 2 ** -11], onp.float32)
    onp.testing.assert_array_equal(
        tf32(x), onp.array([1 + 2 ** -10, -(1 + 2 ** -10), 1,
                            1 + 2 ** -9], onp.float32))
    y = onp.random.RandomState(1).randn(1000).astype(onp.float32)
    hi, lo = _parts(y, 3)
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()
    assert onp.all(onp.abs(hi.astype(onp.float64) + lo - y)
                   <= 2 ** -22 * onp.abs(y))


_F16, _BF16, _F32, _F64 = (torch.float16, torch.bfloat16, torch.float32,
                           torch.float64)


@pytest.mark.parametrize("dtype", [_F16, _BF16, _F32, _F64])
@pytest.mark.parametrize("D", [1, 4, 6, 8, 12, 16, 32, 40, 64, 96, 128, 136,
                               256])
@pytest.mark.parametrize("aligned", [True, False])
def test_bwd_route(dtype, D, aligned):
    """Hopper for aligned bf16 at 64 / 128; the tensor-core kernels for
    float16 / bfloat16 / float32 up to 128 whose rows are whole 16-byte
    chunks on 16-byte boundaries; the general kernels for the rest."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    ok = aligned and D * itemsize % 16 == 0
    want = ("hopper" if ok and dtype == _BF16 and D in (64, 128) else
            "mma" if ok and dtype != _F64 and D <= 128 else "simt")
    assert cuda_ops._flash_route(dtype, D, ok) == want


def test_route_of_reads_alignment_from_the_tensors():
    """``_route_of`` counts a row of D * itemsize bytes and every
    pointer: a view one element in is not 16-byte aligned."""
    x = torch.zeros(2, 3, 8, 33)
    assert cuda_ops._route_of(x[..., :32].contiguous()) == "mma"
    assert cuda_ops._route_of(x[..., 1:].contiguous()) == "mma"
    flat = torch.zeros(1 + 2 * 3 * 8 * 32)
    shifted = flat[1:].view(2, 3, 8, 32)
    assert shifted.data_ptr() % 16 and cuda_ops._route_of(shifted) == "simt"
    assert cuda_ops._route_of(torch.zeros(1, 1, 4, 6)) == "simt"
    assert cuda_ops._route_of(x[..., :32].to(_F64).contiguous()) == "simt"
    assert cuda_ops._route_of(x[..., :32].contiguous(),
                              None, shifted) == "simt"
