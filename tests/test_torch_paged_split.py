"""The split plan of the port's paged decode kernel and its plain
split-and-merge version, against the plain paged read and the JAX
package's Pallas kernel.

``cuda_ops.paged_split_plan`` sizes the kernel's grid from the shapes
alone; ``cuda_ops._paged_split_dense`` repeats the kernel's algorithm
(one softmax per split, merged in split order) in PyTorch.  Both run
here on the CPU.  The JAX side runs the Pallas kernel in interpret mode,
as ``tests/test_torch_attention.py`` does.  fp32 throughout; the
tolerance is fp32 summation-order noise (the merge reorders the sums).
"""
import inspect

import numpy as onp
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_ops
from mxnet_tpu_torch.ops import cuda_ops

ATOL = 1e-5


@pytest.mark.parametrize("S,Hkv,MP,psz", [
    (8, 8, 5, 128), (8, 8, 64, 128), (1, 1, 3, 16), (2, 2, 4, 32),
    (1, 8, 7, 48), (64, 8, 20, 80), (3, 1, 1, 16), (5, 2, 9, 64)])
def test_split_plan_covers_every_key_once(S, Hkv, MP, psz):
    nsplit, kps, chunk = cuda_ops.paged_split_plan(S, Hkv, MP, psz)
    assert chunk in (16, 32, 64) and psz % chunk == 0 and kps % chunk == 0
    cover = onp.zeros(MP * psz, onp.int64)
    for i in range(nsplit):
        lo, hi = i * kps, min((i + 1) * kps, MP * psz)
        assert lo < hi                      # no split is empty
        cover[lo:hi] += 1
    assert (cover == 1).all()
    # the first chunk of every split starts a chunk, and no chunk
    # straddles a page
    assert all((i * kps) % chunk == 0 for i in range(nsplit))


def test_split_plan_reads_shapes_only():
    assert list(inspect.signature(cuda_ops.paged_split_plan).parameters) \
        == ["S", "Hkv", "MP", "psz"]
    # the serving shape: 8 slots x 8 kv heads over 5 pages of 128 give
    # more CTAs than the card's 132 SMs
    nsplit, _, _ = cuda_ops.paged_split_plan(8, 8, 5, 128)
    assert 8 * 8 * nsplit > 132


def _paged(seed, S, H, Hkv, D, psz, P, MP, lens):
    rng = onp.random.RandomState(seed)
    q = rng.randn(S, H, D).astype(onp.float32)
    kp = rng.randn(P, Hkv, psz, D).astype(onp.float32)
    vp = rng.randn(P, Hkv, psz, D).astype(onp.float32)
    pt = rng.permutation(onp.arange(1, P))[:S * MP].reshape(S, MP)
    return q, kp, vp, pt.astype(onp.int32), onp.asarray(lens, onp.int32)


# (S, H, Hkv, D, psz, P, MP, lengths): empty slots, lengths at the split
# boundaries +-1 and a full table (MP * psz)
CASES = [
    (8, 8, 2, 64, 32, 40, 4, [0, 31, 32, 33, 63, 64, 65, 128]),
    (4, 4, 4, 64, 16, 24, 5, [1, 15, 17, 80]),
    (3, 8, 1, 128, 64, 10, 3, [192, 0, 129]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_merge_matches_plain(case):
    S, H, Hkv, D, psz, P, MP, lens = CASES[case]
    args = [torch.from_numpy(a)
            for a in _paged(case, S, H, Hkv, D, psz, P, MP, lens)]
    nsplit, _, _ = cuda_ops.paged_split_plan(S, Hkv, MP, psz)
    assert nsplit > 1
    got = cuda_ops._paged_split_dense(*args, D ** -0.5)
    want = cuda_ops._paged_dense(*args, D ** -0.5)
    onp.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                rtol=0)
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any()


@pytest.mark.parametrize("case", [0, 2])
def test_split_merge_matches_pallas_kernel(monkeypatch, case):
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)
    S, H, Hkv, D, psz, P, MP, lens = CASES[case]
    arrs = _paged(case, S, H, Hkv, D, psz, P, MP, lens)
    want = pallas_ops._paged_kernel_call(*(jnp.asarray(a) for a in arrs),
                                         D ** -0.5)
    got = cuda_ops._paged_split_dense(*(torch.from_numpy(a) for a in arrs),
                                      D ** -0.5)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=ATOL,
                                rtol=0)


def test_zero_offsets_are_cached_per_device():
    cpu = torch.device("cpu")
    a = cuda_ops._offsets(None, cpu)
    assert a is cuda_ops._offsets(None, cpu)
    assert a.dtype == torch.int32 and a.tolist() == [0]
    # an explicit offset is a fresh tensor every time
    assert cuda_ops._offsets(5, cpu).tolist() == [5]
    assert cuda_ops._offsets(0, cpu) is not a


# ---------------------------------------------------------------------------
# the general kernel's plan (csrc/paged_general.cu): chunks of 32 keys that
# may cross pages, so any page size, and any GQA ratio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psz", [1, 7, 24, 128])
@pytest.mark.parametrize("rep", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("S,Hkv,MP", [(8, 8, 3), (1, 1, 5), (3, 2, 40)])
def test_general_plan_covers_every_key_once(psz, rep, S, Hkv, MP):
    nsplit, kps, chunk = cuda_ops.paged_general_plan(S, rep * Hkv, Hkv, MP,
                                                     psz)
    assert chunk == cuda_ops.PAGED_GENERAL_CHUNK and kps % chunk == 0
    cover = onp.zeros(MP * psz, onp.int64)
    for i in range(nsplit):
        lo, hi = i * kps, min((i + 1) * kps, MP * psz)
        assert lo < hi                      # no split is empty
        cover[lo:hi] += 1
    assert (cover == 1).all()


def test_general_plan_reads_shapes_only():
    assert list(inspect.signature(cuda_ops.paged_general_plan).parameters) \
        == ["S", "H", "Hkv", "MP", "psz"]
    # the float32 serving shape: more CTAs than the card's 132 SMs
    nsplit, kps, _ = cuda_ops.paged_general_plan(8, 32, 8, 3, 128)
    assert 8 * 8 * nsplit > 132 and nsplit * kps >= 3 * 128
    # a GQA group above 32 query heads takes more CTAs per split, so
    # fewer splits where the target bounds them
    assert cuda_ops.paged_general_plan(8, 512, 8, 64, 128)[0] < \
        cuda_ops.paged_general_plan(8, 256, 8, 64, 128)[0]


# (S, H, Hkv, D, psz, P, MP, lengths, dtype): page sizes 7, 128 and 1,
# rep 4, 32 and 1, D 16 and 256, float32 and float64, lengths of 0 and
# past the table's MP * psz positions
GENERAL_CASES = [
    pytest.param(3, 8, 2, 16, 7, 40, 9, [0, 40, 100], onp.float32,
                 id="f32-d16-page7"),
    pytest.param(2, 4, 1, 256, 128, 6, 2, [300, 0], onp.float32,
                 id="f32-d256-page128-pallas"),
    pytest.param(3, 32, 1, 16, 7, 130, 40, [0, 150, 300], onp.float64,
                 id="f64-d16-page7-rep32"),
    pytest.param(2, 8, 8, 256, 1, 130, 64, [64, 3], onp.float64,
                 id="f64-d256-page1"),
]


@pytest.mark.parametrize("S,H,Hkv,D,psz,P,MP,lens,dt", GENERAL_CASES)
def test_general_split_merge_matches_jax(monkeypatch, S, H, Hkv, D, psz, P,
                                         MP, lens, dt):
    """``_paged_split_dense`` under the general plan against the JAX
    package's ``paged_attention``: its Pallas kernel in interpret mode
    where it takes the shape, else its dense fallback; the port sums in
    float64 for float64 inputs, the reference in float32."""
    monkeypatch.setattr(pallas_ops, "_INTERPRET", True)
    arrs = _paged(S + D, S, H, Hkv, D, psz, P, MP, lens)
    q, kp, vp, pt, ln = (torch.from_numpy(a) for a in arrs)
    q, kp, vp = (t.to(torch.from_numpy(onp.zeros(0, dt)).dtype)
                 for t in (q, kp, vp))
    plan = cuda_ops.paged_general_plan(S, H, Hkv, MP, psz)
    assert plan[0] > 1
    got = cuda_ops._paged_split_dense(q, kp, vp, pt, ln, D ** -0.5, plan)
    assert got.dtype == q.dtype
    jargs = [jnp.asarray(a) for a in arrs]
    want = (pallas_ops._paged_kernel_call
            if pallas_ops._paged_shapes_ok(jargs[0], jargs[1])
            else pallas_ops._paged_dense)(*jargs, D ** -0.5)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want), atol=ATOL,
                                rtol=0)
    onp.testing.assert_allclose(
        got.numpy(),
        cuda_ops._paged_dense(q, kp, vp, pt, ln, D ** -0.5).numpy(),
        atol=1e-12 if dt == onp.float64 else ATOL, rtol=0)
    for s, n in enumerate(lens):
        if n == 0:
            assert not got[s].any()
