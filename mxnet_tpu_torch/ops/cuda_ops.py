"""Attention kernels: hand-written CUDA on the card, their plain PyTorch
versions on the CPU.

Counterpart of ``mxnet_tpu/ops/pallas_ops.py``, all four of its Pallas
kernels:

* ``flash_attention_with_lse`` / ``flash_attention`` -- the flash
  forward ``_fwd_call`` (pallas_ops.py:62), now ``csrc/flash_fwd.cu``,
  differentiable through :class:`_FlashAttention` (the ``_flash_lse``
  custom VJP, pallas_ops.py:334-376), whose backward is the recompute
  pair ``_bwd_dq_call`` (:149) and ``_bwd_dkv_call`` (:227), now
  ``csrc/flash_bwd.cu``;
* ``flash_attention_block_bwd`` -- the ring-attention backward
  primitive (pallas_ops.py:540), over the same backward kernels;
* ``paged_attention`` -- the page-table decode kernel
  ``_paged_kernel_call`` (pallas_ops.py:621), now
  ``csrc/paged_decode.cu``.

Dispatch is by the device of the tensors and nothing else: a CPU tensor
goes to the plain version (``_dense_with_lse``, ``_flash_bwd_dense``,
``_paged_dense``, the semantics of the JAX fallbacks); a CUDA tensor
goes to the kernel, or the wrapper raises on what the kernel does not
take.  There is no fallback from the card to the plain path.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one
where it launches and nowhere else, so a run can show which kernels its
main path went through (:func:`reset_launch_counts` before, read after).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["flash_attention_with_lse", "flash_attention",
           "flash_attention_block_bwd", "paged_attention", "LAUNCHES",
           "reset_launch_counts"]

NEG_INF = float("-inf")

#: kernel name -> launches since the last reset
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "paged_decode": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _is_cuda(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError("attention inputs must all be on the CPU or all on "
                     "CUDA, got %s" % sorted(devs))


def _check_kernel_input(name, t, dtype, dim):
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != dim:
        raise ValueError("%s: expected %d dims, got shape %s"
                         % (name, dim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.data_ptr() % 16:
        raise ValueError("%s must be 16-byte aligned" % name)


def _offsets(offset, device):
    if offset is None:
        return torch.zeros(1, dtype=torch.int32, device=device)
    return torch.as_tensor(offset, dtype=torch.int32,
                           device=device).reshape(1)


# ---------------------------------------------------------------------------
# flash forward
# ---------------------------------------------------------------------------

def _dense_with_lse(q, k, v, q_off, k_off, causal, scale):
    """Plain (o, lse) with the semantics of ``_fwd_call``: fp32 scores
    and softmax, -inf lse and zero output on a row that sees no key."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        T, Tk = q.shape[2], k.shape[2]
        qpos = q_off.to(q.device)[0] + torch.arange(T, device=q.device)
        kpos = k_off.to(q.device)[0] + torch.arange(Tk, device=q.device)
        vis = qpos[:, None] >= kpos[None, :]
        s = s.masked_fill(~vis, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    if causal:
        p = p.masked_fill(~vis, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / l_safe[..., None]).to(v.dtype),
                     v)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      m + torch.log(l_safe))
    return o.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, q_off, k_off, causal, scale):
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, t, torch.bfloat16, 4)
    if D not in (64, 128):
        raise ValueError("flash kernel takes head_dim 64 or 128, got %d" % D)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash kernel: k %s / v %s do not fit q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if q_off.device != q.device or k_off.device != q.device:
        raise ValueError("flash kernel: offsets must be on %s" % q.device)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_fwd")
    err = lib.mx_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_off.data_ptr(),
        k_off.data_ptr(), o.data_ptr(), lse.data_ptr(), B * H, B * Hkv, T,
        Tk, D, float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_fwd kernel launch failed: CUDA error %d"
                           % err)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


# ---------------------------------------------------------------------------
# flash backward
# ---------------------------------------------------------------------------

def _flash_bwd_dense(q, k, v, do, lse, delta, q_off, k_off, causal, scale):
    """Plain recompute backward, the semantics of the dense branch of
    ``flash_attention_block_bwd`` (pallas_ops.py:579-601) with the
    kernels' -inf lse rule (:174, :256): P = exp(s * scale - lse), a
    -inf lse read as 0 and masked pairs 0; dS = P o (dO V^T - delta) *
    scale; the GQA grads summed over the ``rep`` query heads of a group.
    Returns float32 (dq, dk, dv)."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        qpos = q_off.to(q.device)[0] + torch.arange(T, device=q.device)
        kpos = k_off.to(q.device)[0] + torch.arange(Tk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    lse = lse.float()
    lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if rep > 1:
        dk = dk.reshape(B, Hkv, rep, Tk, D).sum(dim=2)
        dv = dv.reshape(B, Hkv, rep, Tk, D).sum(dim=2)
    return dq, dk, dv


def _launch_bwd(kernel, outs, q, k, v, do, lse, delta, q_off, k_off, causal,
                scale):
    """Check the inputs and launch ``mx_<kernel>`` of
    ``csrc/flash_bwd.cu`` into the preallocated ``outs``."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_input(name, t, torch.bfloat16, 4)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_kernel_input(name, t, torch.float32, 3)
    if D not in (64, 128):
        raise ValueError("flash kernel takes head_dim 64 or 128, got %d" % D)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or do.shape != q.shape or lse.shape != (B, H, T) \
            or delta.shape != (B, H, T):
        raise ValueError("flash backward: k %s, v %s, do %s, lse %s, delta "
                         "%s do not fit q %s"
                         % tuple(tuple(t.shape) for t in
                                 (k, v, do, lse, delta, q)))
    if q_off.device != q.device or k_off.device != q.device:
        raise ValueError("flash kernel: offsets must be on %s" % q.device)
    fn = getattr(_build.library("flash_bwd"), "mx_" + kernel)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), q_off.data_ptr(),
             k_off.data_ptr(), *(o.data_ptr() for o in outs), B * H,
             B * Hkv, T, Tk, D, float(scale), int(bool(causal)),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (kernel, err))
    LAUNCHES[kernel] += 1


def _flash_bwd_dq_cuda(q, k, v, do, *rest):
    """dq (bf16) from ``mx_flash_bwd_dq``; ``rest`` is (lse, delta,
    q_off, k_off, causal, scale)."""
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, do, *rest)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, *rest):
    """(dk, dv) (bf16) from ``mx_flash_bwd_dkv``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, do, *rest)
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, delta, q_off, k_off, causal, scale):
    """(dq, dk, dv) in bf16 from the two kernels of ``csrc/flash_bwd.cu``."""
    args = (q, k, v, do, lse, delta, q_off, k_off, causal, scale)
    return (_flash_bwd_dq_cuda(*args),) + _flash_bwd_dkv_cuda(*args)


def _flash_bwd(q, k, v, do, lse, delta, q_off, k_off, causal, scale):
    if _is_cuda(q, k, v, do, lse, delta):
        return _flash_bwd_cuda(q, k, v, do, lse, delta, q_off, k_off,
                               causal, scale)
    return _flash_bwd_dense(q, k, v, do, lse, delta, q_off, k_off, causal,
                            scale)


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with a recompute backward: the ``_flash_lse`` custom VJP
    (pallas_ops.py:334-376).  The forward keeps only O and the lse; the
    backward folds the lse cotangent into delta = rowsum(dO o O) - dlse
    and re-forms each score tile from q and k."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, k_off, causal, scale):
        if _is_cuda(q, k, v):
            o, lse = _flash_fwd_cuda(q, k, v, q_off, k_off, causal, scale)
        else:
            o, lse = _dense_with_lse(q, k, v, q_off, k_off, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, q_off, k_off)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, q_off, k_off = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        delta = (do.float() * o.float()).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.float()
        dor = do.to(q.dtype).contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, dor, lse, delta.contiguous(), q_off,
                                k_off, ctx.causal, ctx.scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention_with_lse(q, k, v, causal=False, scale=None,
                             q_offset=None, k_offset=None):
    """Attention returning (output, logsumexp) on (B, H, T, D).

    ``k``/``v`` may carry fewer heads (H % H_kv == 0); the kernel maps
    each query head to its kv group, so repeated K/V are never stored.
    ``q_offset``/``k_offset`` are global position offsets for the causal
    mask (ints or int32 tensors of one element); the kernel reads them
    on the device.  On CUDA, q/k/v must be contiguous bf16 with head_dim
    64 or 128; the lse is float32 (B, H, T).  Gradients flow through
    both outputs, on CUDA through the backward kernels."""
    if q.shape[1] % k.shape[1] != 0:
        raise ValueError(
            "flash_attention: %d query heads not a multiple of %d kv "
            "heads" % (q.shape[1], k.shape[1]))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_off = _offsets(q_offset, q.device)
    k_off = _offsets(k_offset, q.device)
    return _FlashAttention.apply(q, k, v, q_off, k_off, causal, scale)


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention on (B, H, T, D); see
    :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale)[0]


def flash_attention_block_bwd(q, k, v, do, lse, delta, causal=False,
                              scale=None, q_offset=None, k_offset=None):
    """(dq, dk, dv) of one attention block against the global merged
    ``lse`` (B, H, T) and its ``delta`` = rowsum(dO o O) (B, H, T): the
    ring-attention backward primitive (pallas_ops.py:540).  The block's
    probabilities exp(s - lse) are the global ones, so the per-block
    contributions sum to the dense gradient.  On CUDA it runs the two
    backward kernels (``do`` cast to q's dtype, as the JAX kernel path
    does); returns float32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_off = _offsets(q_offset, q.device)
    k_off = _offsets(k_offset, q.device)
    dq, dk, dv = _flash_bwd(q, k, v, do.to(q.dtype), lse, delta, q_off,
                            k_off, causal, scale)
    return dq.float(), dk.float(), dv.float()


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _paged_dense(q, k_pages, v_pages, page_table, lengths, scale):
    """Plain paged attention: gather each slot's pages into a contiguous
    view and run masked attention with a float32 softmax."""
    S, H, D = q.shape
    Hkv = k_pages.shape[1]
    pt = page_table.long()
    g = k_pages[pt]                          # (S, MP, Hkv, psz, D)
    MP, psz = g.shape[1], g.shape[3]
    k = g.permute(0, 1, 3, 2, 4).reshape(S, MP * psz, Hkv, D)
    v = v_pages[pt].permute(0, 1, 3, 2, 4).reshape(S, MP * psz, Hkv, D)
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("shd,skhd->shk", q.float(), k.float()) * scale
    kpos = torch.arange(MP * psz, device=q.device)
    mask = kpos[None, None, :] < lengths.to(q.device)[:, None, None]
    sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(sc - m_safe[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("shk,skhd->shd", p / l_safe[..., None], v.float())
    return o.to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths, scale):
    S, H, D = q.shape
    P, Hkv, psz, _ = k_pages.shape
    _check_kernel_input("q", q, torch.bfloat16, 3)
    _check_kernel_input("k_pages", k_pages, torch.bfloat16, 4)
    _check_kernel_input("v_pages", v_pages, torch.bfloat16, 4)
    _check_kernel_input("page_table", page_table, torch.int32, 2)
    _check_kernel_input("lengths", lengths, torch.int32, 1)
    if D not in (64, 128) or k_pages.shape[3] != D:
        raise ValueError("paged kernel takes head_dim 64 or 128, got q %s "
                         "and pools %s" % (tuple(q.shape),
                                           tuple(k_pages.shape)))
    if psz % 16:
        raise ValueError("paged kernel takes a page size that is a "
                         "multiple of 16, got %d" % psz)
    if H // Hkv > 8:
        raise ValueError("paged kernel takes at most 8 query heads per kv "
                         "head, got %d" % (H // Hkv))
    if v_pages.shape != k_pages.shape or page_table.shape[0] != S \
            or lengths.shape[0] != S:
        raise ValueError("paged kernel: pools %s / %s, page table %s, "
                         "lengths %s do not fit q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            tuple(page_table.shape), tuple(lengths.shape),
                            tuple(q.shape)))
    out = torch.empty_like(q)
    lib = _build.library("paged_decode")
    err = lib.mx_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), S, H,
        Hkv, psz, D, page_table.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_decode kernel launch failed: CUDA error "
                           "%d" % err)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None):
    """One decode step's attention read over a paged KV cache.

    ``q``: (S, H, D), one query token per batch slot; ``k_pages`` /
    ``v_pages``: (P, H_kv, page_size, D) single-layer page pools;
    ``page_table``: (S, MP) int32 page ids per slot (unused entries must
    hold a valid id, by convention the trash page 0); ``lengths``: (S,)
    int32 tokens to attend over per slot, the new token included.  A
    slot with ``lengths == 0`` returns zeros.  Page ids and lengths are
    trusted: the kernel reads the pages they name."""
    if q.shape[1] % k_pages.shape[1] != 0:
        raise ValueError(
            "paged_attention: %d query heads not a multiple of %d kv "
            "heads" % (q.shape[1], k_pages.shape[1]))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _is_cuda(q, k_pages, v_pages, page_table, lengths):
        return _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths,
                                  scale)
    return _paged_dense(q, k_pages, v_pages, page_table, lengths, scale)
