"""Ring attention: context parallelism over a mesh axis of ranks.

Counterpart of ``mxnet_tpu/parallel/ring.py``.  Each rank keeps its
block of queries; the K/V blocks travel round the ring (``ppermute``
along the ``cp`` axis), and every step runs the port's flash forward
(``cuda_ops.flash_attention_with_lse``) on the block it holds, with the
global position offsets of that block feeding the causal mask.  The
partial results over disjoint key sets merge exactly by their
logsumexps (:func:`_merge`, float32).

* ``layout="striped"`` (the default when causal): rank ``r`` holds the
  tokens ``r, r+n, r+2n, ...``, so every (query rank, key block) pair
  does about the same causal work; its mask is a block offset
  (:func:`_mask_offsets`).  ``"roundrobin"`` keeps contiguous blocks.
* ``axis_name=("dcn", "cp")`` runs the two-level ring: an outer ring of
  superblocks around an inner ring (:func:`_ring2_fwd_loop`).
* The double-buffered ring (the default) sends K and V as one buffer,
  starts the next block's exchange before the current block's kernel,
  and has a hand-written backward (:class:`_RingAttention`) that keeps
  O(local) residuals: q, the home K/V, the merged O and its lse.  The
  backward sends K/V round the ring a second time and runs
  ``cuda_ops.flash_attention_block_bwd`` on each block against the
  merged lse and delta = rowsum(dO o O), while the (dk, dv) partials
  ride their own buffer one hop behind.
* ``double_buffer=False`` is the legacy flat ring, differentiated by
  autograd through the per-step flash calls and permutes.

``ring_attention_sharded`` launches through the fault seam of the
reference (:593-614): the ``collective_fail`` injection point, then, in
a job of more than one rank (or with a ``_comm`` given),
``fault_dist.coordinated_call`` -- every rank votes after a failed
attempt and the fleet re-enters the ring as one -- and with one rank
``fault.retry_call``.  Neither wraps the collective in a per-attempt
timeout thread (an abandoned attempt would issue a second identical
collective on the same group).  ``_comm`` / ``_gen`` are the test seams
of ``coordinated_call``'s parameters.
"""
from __future__ import annotations

import torch

from .. import fault as _fault
from ..ops.cuda_ops import flash_attention_block_bwd, flash_attention_with_lse
from ._compat import ppermute, ppermute_start, shard_map
from .mesh import _world, current_mesh

__all__ = ["LAYOUTS", "BALANCE_LAYOUTS", "stripe_permutation",
           "unstripe_permutation", "stripe_sequence", "unstripe_sequence",
           "ring_axes", "ring_size", "causal_balance", "ring_attention_local",
           "ring_attention_sharded"]

LAYOUTS = ("striped", "roundrobin")
#: layouts :func:`causal_balance` scores ("zigzag" is analytic only)
BALANCE_LAYOUTS = LAYOUTS + ("zigzag",)


# ---------------------------------------------------------------------------
# striped layout: permutation, mask offsets, analytic balance
# ---------------------------------------------------------------------------

def stripe_permutation(T, n, device=None):
    """Indices putting a sequence in striped order: contiguous shard
    ``r`` of the result holds tokens ``r, r+n, r+2n, ...``."""
    if T % n:
        raise ValueError("sequence length %d not divisible by ring size %d"
                         % (T, n))
    return torch.arange(T, device=device).reshape(T // n, n).T.reshape(-1)


def unstripe_permutation(T, n, device=None):
    """Inverse of :func:`stripe_permutation`."""
    if T % n:
        raise ValueError("sequence length %d not divisible by ring size %d"
                         % (T, n))
    return torch.arange(T, device=device).reshape(n, T // n).T.reshape(-1)


def stripe_sequence(x, n, axis=2):
    """Reorder a naturally ordered sequence axis into striped layout."""
    return torch.index_select(x, axis, stripe_permutation(x.shape[axis], n,
                                                          x.device))


def unstripe_sequence(x, n, axis=2):
    """Undo :func:`stripe_sequence`."""
    return torch.index_select(x, axis, unstripe_permutation(x.shape[axis], n,
                                                            x.device))


def ring_axes(axis_name):
    """``axis_name`` -- one mesh axis or an (outer, inner) pair -- as a
    validated tuple."""
    axes = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    if len(axes) not in (1, 2):
        raise ValueError("axis_name must be one mesh axis or an "
                         "(outer, inner) pair, got %r" % (axis_name,))
    return axes


def ring_size(mesh, axis_name):
    """Ranks the sequence shards over: the product of the ring axes."""
    n = 1
    for a in ring_axes(axis_name):
        n *= mesh.shape[a]
    return n


def _mask_offsets(layout, my, owner, T, Tk):
    """(q_offset, k_offset) of the causal mask for the block of rank
    ``owner``.  roundrobin: the blocks' global starts.  striped: query
    ``i`` of rank ``my`` is token ``my + i*n``, key ``j`` of ``owner``
    token ``owner + j*n``, so ``q >= k`` iff ``i > j`` or (``i == j``
    and ``owner <= my``): causal with the keys shifted by one exactly
    when the owner is a later rank."""
    if layout == "striped":
        return 0, int(owner > my)
    return my * T, owner * Tk


def causal_balance(layout, inner, outer=1, block_tokens=128):
    """Analytic causal work balance of one ring pass: per-step max/mean
    work across ranks, and the critical-path factor (1.0 = every rank
    equally busy every step)."""
    if layout not in BALANCE_LAYOUTS:
        raise ValueError("unknown layout %r" % (layout,))
    L = block_tokens
    n = inner * outer

    def work(my, owner):
        if layout == "roundrobin":
            if owner < my:
                return L * L
            return L * (L + 1) // 2 if owner == my else 0
        if layout == "zigzag":
            half = L // 2
            tri = half * (half + 1) // 2
            w = 0
            for cq in (my, 2 * n - 1 - my):
                for ck in (owner, 2 * n - 1 - owner):
                    if cq > ck:
                        w += half * half
                    elif cq == ck:
                        w += tri
            return w
        return L * (L + 1) // 2 if owner <= my else L * (L - 1) // 2

    steps = []
    for so in range(outer):
        for si in range(inner):
            w = []
            for o in range(outer):
                for i in range(inner):
                    owner = (((o - so) % outer) * inner
                             + (i - si) % inner)
                    w.append(work(o * inner + i, owner))
            steps.append(w)
    per_step = [max(w) * n / sum(w) for w in steps if sum(w)]
    total = sum(sum(w) for w in steps)
    crit = sum(max(w) for w in steps) * n / total
    return {"per_step_max_over_mean": [round(x, 4) for x in per_step],
            "critical_path_x": round(crit, 4)}


def _merge(acc_o, acc_lse, o_s, lse_s):
    """Exact merge of two normalised attentions over disjoint keys:
    o = (o1 e^l1 + o2 e^l2) / (e^l1 + e^l2), max-shifted, float32."""
    m = torch.maximum(acc_lse, lse_s)
    zero = torch.zeros_like(m)
    m_safe = torch.where(torch.isneginf(m), zero, m)
    w1 = torch.where(torch.isneginf(acc_lse), zero,
                     torch.exp(acc_lse - m_safe))
    w2 = torch.where(torch.isneginf(lse_s), zero, torch.exp(lse_s - m_safe))
    tot = w1 + w2
    tot_safe = torch.where(tot == 0.0, torch.ones_like(tot), tot)
    o = (acc_o * w1[..., None] + o_s.float() * w2[..., None]) \
        / tot_safe[..., None]
    lse = torch.where(tot == 0.0, torch.full_like(tot, float("-inf")),
                      m_safe + torch.log(tot_safe))
    return o, lse


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _start(mesh, axis):
    """(ring size, this rank's index) along ``axis``."""
    return mesh.axis_size(axis), mesh.axis_index(axis)


# ---------------------------------------------------------------------------
# flat double-buffered ring
# ---------------------------------------------------------------------------

def _ring_fwd_loop(mesh, q, k, v, axis, causal, scale, layout):
    """Forward ring: one fused K/V buffer a step, the next block's
    exchange started before the current block's kernel."""
    n, my = _start(mesh, axis)
    T, Tk = q.shape[2], k.shape[2]
    acc_o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
    kv = torch.stack((k, v))
    for step in range(n):
        nxt = ppermute_start(kv, axis, _ring(n), mesh)
        owner = (my - step) % n
        q_off, k_off = _mask_offsets(layout, my, owner, T, Tk)
        o_s, lse_s = flash_attention_with_lse(
            q, kv[0], kv[1], causal=causal, scale=scale,
            q_offset=q_off, k_offset=k_off)
        acc_o, acc_lse = _merge(acc_o, acc_lse, o_s, lse_s)
        kv = nxt.wait()
    return acc_o, acc_lse


def _ring_bwd_loop(mesh, q, k, v, o, lse, do, axis, causal, scale, layout):
    """Backward ring: K/V go round a second time; dq accumulates here,
    the (dk, dv) partials ride their own buffer one hop behind and are
    home, complete, after ``n`` hops.  Each block's gradients use the
    merged lse, so they sum to the dense gradient."""
    n, my = _start(mesh, axis)
    T, Tk = q.shape[2], k.shape[2]
    delta = (do.float() * o).sum(-1)
    kv = torch.stack((k, v))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    hop = None                     # the (dk, dv) partials in flight
    for step in range(n):
        nxt = ppermute_start(kv, axis, _ring(n), mesh)
        owner = (my - step) % n
        q_off, k_off = _mask_offsets(layout, my, owner, T, Tk)
        dq_b, dk_b, dv_b = flash_attention_block_bwd(
            q, kv[0], kv[1], do, lse, delta, causal=causal, scale=scale,
            q_offset=q_off, k_offset=k_off)
        dq += dq_b
        if hop is not None:
            dkv = hop.wait()
        dkv = dkv + torch.stack((dk_b, dv_b))
        hop = ppermute_start(dkv, axis, _ring(n), mesh)
        kv = nxt.wait()
    return dq, hop.wait()


# ---------------------------------------------------------------------------
# two-level ring: an outer ring of superblocks around an inner ring
# ---------------------------------------------------------------------------

def _ring2_owner(mesh, outer, inner, so, si):
    n_out, n_in = mesh.shape[outer], mesh.shape[inner]
    return (((mesh.coords[outer] - so) % n_out) * n_in
            + (mesh.coords[inner] - si) % n_in)


def _ring2_fwd_loop(mesh, q, k, v, outer, inner, causal, scale, layout):
    """Two-level forward.  Each outer step starts the outer exchange of
    the block held now, sweeps the inner ring over the superblock
    resident in this outer slice, then takes the outer block.  At
    outer step ``so``, inner step ``si``, rank (o, i) holds the block
    of rank ((o - so) mod n_out, (i - si) mod n_in): every block once."""
    n_out, n_in = mesh.shape[outer], mesh.shape[inner]
    my = mesh.axis_index((outer, inner))
    T, Tk = q.shape[2], k.shape[2]
    acc_o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
    kv = torch.stack((k, v))
    for so in range(n_out):
        far = ppermute_start(kv, outer, _ring(n_out), mesh) \
            if so < n_out - 1 else None
        cur = kv
        for si in range(n_in):
            nxt = ppermute_start(cur, inner, _ring(n_in), mesh) \
                if si < n_in - 1 else None
            owner = _ring2_owner(mesh, outer, inner, so, si)
            q_off, k_off = _mask_offsets(layout, my, owner, T, Tk)
            o_s, lse_s = flash_attention_with_lse(
                q, cur[0], cur[1], causal=causal, scale=scale,
                q_offset=q_off, k_offset=k_off)
            acc_o, acc_lse = _merge(acc_o, acc_lse, o_s, lse_s)
            if nxt is not None:
                cur = nxt.wait()
        if far is not None:
            kv = far.wait()
    return acc_o, acc_lse


def _ring2_bwd_loop(mesh, q, k, v, o, lse, do, outer, inner, causal, scale,
                    layout):
    """Two-level backward.  The (dk, dv) buffer shadows K/V: inside an
    outer step it rides one inner hop behind the kernels, then finishes
    its inner ring (one more hop, back in line with the superblock the
    outer exchange delivers) and crosses the outer ring after the
    slice's last contribution.  After ``n_out`` outer steps it is home."""
    n_out, n_in = mesh.shape[outer], mesh.shape[inner]
    my = mesh.axis_index((outer, inner))
    T, Tk = q.shape[2], k.shape[2]
    delta = (do.float() * o).sum(-1)
    kv = torch.stack((k, v))
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for so in range(n_out):
        far = ppermute_start(kv, outer, _ring(n_out), mesh) \
            if so < n_out - 1 else None
        cur = kv
        for si in range(n_in):
            nxt = ppermute_start(cur, inner, _ring(n_in), mesh) \
                if si < n_in - 1 else None
            owner = _ring2_owner(mesh, outer, inner, so, si)
            q_off, k_off = _mask_offsets(layout, my, owner, T, Tk)
            dq_b, dk_b, dv_b = flash_attention_block_bwd(
                q, cur[0], cur[1], do, lse, delta, causal=causal,
                scale=scale, q_offset=q_off, k_offset=k_off)
            dq += dq_b
            dkv += torch.stack((dk_b, dv_b))
            dkv = ppermute_start(dkv, inner, _ring(n_in), mesh).wait()
            if nxt is not None:
                cur = nxt.wait()
        dkv = ppermute_start(dkv, outer, _ring(n_out), mesh).wait()
        if far is not None:
            kv = far.wait()
    return dq, dkv


# ---------------------------------------------------------------------------
# the ring as one autograd Function (O(local) residuals)
# ---------------------------------------------------------------------------

class _RingAttention(torch.autograd.Function):
    """The double-buffered ring with its hand-written backward: the
    ``_ring_db`` custom VJP (reference :405-449)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale, layout):
        if isinstance(axis, tuple):
            o, lse = _ring2_fwd_loop(mesh, q, k, v, axis[0], axis[1], causal,
                                     scale, layout)
        else:
            o, lse = _ring_fwd_loop(mesh, q, k, v, axis, causal, scale,
                                    layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mesh, ctx.axis, ctx.causal = mesh, axis, causal
        ctx.scale, ctx.layout = scale, layout
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if isinstance(ctx.axis, tuple):
            dq, dkv = _ring2_bwd_loop(ctx.mesh, q, k, v, o, lse, do,
                                      ctx.axis[0], ctx.axis[1], ctx.causal,
                                      ctx.scale, ctx.layout)
        else:
            dq, dkv = _ring_bwd_loop(ctx.mesh, q, k, v, o, lse, do, ctx.axis,
                                     ctx.causal, ctx.scale, ctx.layout)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def _legacy_ring(mesh, q, k, v, axis, causal, scale, layout):
    """The flat ring before double buffering: K and V permuted apart
    after each block, differentiated by autograd."""
    n, my = _start(mesh, axis)
    T, Tk = q.shape[2], k.shape[2]
    acc_o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc_lse = torch.full(q.shape[:3], float("-inf"), device=q.device)
    kk, vv = k, v
    for step in range(n):
        owner = (my - step) % n
        q_off, k_off = _mask_offsets(layout, my, owner, T, Tk)
        o_s, lse_s = flash_attention_with_lse(
            q, kk, vv, causal=causal, scale=scale, q_offset=q_off,
            k_offset=k_off)
        acc_o, acc_lse = _merge(acc_o, acc_lse, o_s, lse_s)
        kk = ppermute(kk, axis, _ring(n), mesh)
        vv = ppermute(vv, axis, _ring(n), mesh)
    return acc_o.to(q.dtype)


def ring_attention_local(q, k, v, axis_name, causal=False, scale=None,
                         double_buffer=True, layout="roundrobin", mesh=None):
    """Ring attention over this rank's shard: q, k, v are (B, H, T_local,
    D) blocks of a sequence sharded over ``axis_name`` (one mesh axis or
    an (outer, inner) pair) of ``mesh`` (default: the current mesh, as
    :func:`~._compat.shard_map` sets).  ``layout="striped"`` expects the
    sequence already striped (:func:`stripe_sequence`)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("ring_attention_local needs a mesh: pass one or "
                           "enter parallel.mesh_scope")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if layout not in LAYOUTS:
        raise ValueError("unknown layout %r" % (layout,))
    axes = ring_axes(axis_name)
    axis = axes[0] if len(axes) == 1 else axes
    if not double_buffer:
        if isinstance(axis, tuple):
            raise ValueError("double_buffer=False (the legacy path) "
                             "supports the flat ring only")
        return _legacy_ring(mesh, q, k, v, axis, causal, scale, layout)
    return _RingAttention.apply(q, k, v, mesh, axis, causal, scale, layout)


def ring_attention_sharded(q, k, v, mesh, axis_name="cp", causal=False,
                           scale=None, batch_axis=None, double_buffer=True,
                           layout=None, permute_inputs=None, _comm=None,
                           _gen=None):
    """Ring attention over replicated (B, H, T, D) tensors: every rank
    passes the whole q / k / v, runs the ring on its shard of the
    sequence (over ``axis_name``; the batch over ``batch_axis`` if
    given), and gets the whole output back.  Gradients reach q, k and v
    in full on every rank.

    ``layout`` ("striped" by default when causal, else "roundrobin");
    non-causal attention always runs roundrobin (without a mask the
    layouts compute the same).  ``permute_inputs`` (default True for
    striped) stripes q / k / v on the way in and unstripes the output;
    ``False`` means the data are striped already, and the output stays
    striped.  With more than one rank (or ``_comm``) a failed attempt is
    voted and re-issued by every rank together
    (``fault_dist.coordinated_call``); ``_comm`` / ``_gen`` are its test
    seams."""
    axes = ring_axes(axis_name)
    n_total = ring_size(mesh, axis_name)
    if layout is None:
        layout = "striped" if causal else "roundrobin"
    if layout not in LAYOUTS:
        raise ValueError("unknown layout %r" % (layout,))
    if not causal:
        layout = "roundrobin"
    if layout == "striped":
        if q.shape[2] != k.shape[2]:
            raise ValueError("striped layout needs equal q/k sequence "
                             "lengths, got %d vs %d"
                             % (q.shape[2], k.shape[2]))
        if permute_inputs is None:
            permute_inputs = True
    else:
        permute_inputs = False
    if permute_inputs:
        q, k, v = (stripe_sequence(a, n_total) for a in (q, k, v))
    body_axis = axes[0] if len(axes) == 1 else axes
    spec = (batch_axis, None, body_axis, None)

    def body(qq, kk, vv):
        return ring_attention_local(qq, kk, vv, body_axis, causal=causal,
                                    scale=scale, double_buffer=double_buffer,
                                    layout=layout, mesh=mesh)

    def attempt():
        _fault.collective_check("ring_attention")
        return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)

    if _comm is not None or _world()[1] > 1:
        from .. import fault_dist as _fdist
        # lease=True on the production path (ambient comm and
        # generation): an ACTIVE step lease covers the launch with the
        # step-boundary vote; the test seams stay on per-op voting
        out = _fdist.coordinated_call(attempt, op="ring_attention",
                                      comm=_comm, gen=_gen,
                                      lease=(_comm is None and
                                             _gen is None) or None)
    else:
        out = _fault.retry_call(attempt, op="ring_attention",
                                policy=_fault.mutating_policy())
    if permute_inputs:
        out = unstripe_sequence(out, n_total)
    return out
