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

Each has two hand-written kernels on the card.  The Hopper kernels
above (TMA, wgmma / mma.sync) take bf16 with head_dim 64 or 128 (paged
decode also: a page size that is a multiple of 16, at most 8 query heads
per kv head).  Every other CUDA call goes to the general kernels of
``csrc/flash_general.cu`` and ``csrc/paged_general.cu``, which take the
reference's whole contract: float16, bfloat16, float32 and float64, any
head_dim from 1 to 256, any GQA ratio and any page size.  The flash
forward and backward have a third route between the two
(:func:`_flash_route`): ``csrc/flash_fwd_mma.cu`` and
``csrc/flash_bwd_mma.cu``, TF32 tensor cores in 3xTF32 for float16,
bfloat16 and float32 at head_dim up to 128 with 16-byte rows; the
general kernels keep float64, head_dim above 128 and unaligned rows.

Dispatch is by the device of the tensors: a CPU tensor goes to the
plain version (``_dense_with_lse``, ``_flash_bwd_dense``,
``_paged_dense``, the semantics of the JAX fallbacks, in float64 for
float64 inputs and float32 otherwise); a CUDA tensor goes to a kernel,
or the wrapper raises on what no kernel takes (head_dim above 256, a
non-contiguous input, mixed dtypes or devices).  There is no fallback
from the card to the plain path.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one
where it launches and nowhere else, so a run can show which kernels its
main path went through (:func:`reset_launch_counts` before, read after).
A CUDA graph (:func:`capture_graph`) records the counts its capture
added and adds them again on every replay (:func:`replay_graph`), so the
count keeps its meaning when a path runs as graphs; the collectives'
``parallel._compat.TRANSPORT`` counts a capture holds are carried the
same way.
"""
from __future__ import annotations

import threading

import torch

from . import _build

__all__ = ["flash_attention_with_lse", "flash_attention",
           "flash_attention_block_bwd", "paged_attention",
           "paged_split_plan", "paged_general_plan", "LAUNCHES",
           "reset_launch_counts", "capture_graph", "capturing",
           "replay_graph",
           "GraphCounts"]

NEG_INF = float("-inf")

#: kernel name -> launches since the last reset
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "paged_decode": 0, "flash_fwd_general": 0,
            "flash_bwd_dq_general": 0, "flash_bwd_dkv_general": 0,
            "paged_decode_general": 0, "flash_bwd_dq_mma": 0,
            "flash_bwd_dkv_mma": 0, "flash_fwd_mma": 0,
            # the optimizer's multi-tensor kernels (ops/multi_tensor.py)
            "multi_sgd": 0, "multi_adam": 0, "multi_lamb_phase1": 0,
            "multi_lamb_phase2": 0, "multi_all_finite": 0,
            # the int8 weight path (ops/int8.py): the decode product, the
            # prefill's dequantize; post-training quantization's activation
            # quantize (every call, and its im2col calls again) and int8
            # convolution / product (every call, and each call again under
            # its route)
            "int8_linear": 0, "int8_dequant": 0, "int8_quantize": 0,
            "int8_quantize_im2col": 0, "int8_conv": 0,
            "int8_conv_hopper": 0, "int8_conv_general": 0,
            "int8_conv_depthwise": 0}

#: dtype codes of the general kernels' C interface (csrc/general.cuh)
GENERAL_DTYPES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2,
                  torch.float64: 3}
MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128
#: forward / backward route -> (library, entry-point / launch-count
#: suffix) of the general launchers; "hopper" has launchers of its own
FWD_ROUTES = {"mma": ("flash_fwd_mma", "mma"),
              "simt": ("flash_general", "general")}
BWD_ROUTES = {"mma": ("flash_bwd_mma", "mma"),
              "simt": ("flash_general", "general")}


def refuse_export(kernel):
    """Raise where ``torch.export`` traces a forward that reaches
    ``kernel``, which has no ``torch.library`` op yet: an exported
    program would hold its plain version in its place."""
    if torch.compiler.is_exporting():
        raise NotImplementedError(
            "mxnet_tpu_torch: export cannot carry the %s kernel yet: its "
            "torch.library op is ROADMAP queue 2's" % kernel)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_SIDE_STREAMS = {}


def _side_stream():
    """The current device's warm-up stream, one for every capture: cuBLAS
    keeps a workspace for each stream it has run on, for the life of
    the process, so a fresh stream per capture would leak one each."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


class GraphCounts(dict):
    """The kernel launches a captured graph holds (kernel -> count),
    with ``transport``: the collectives' ``TRANSPORT`` counts it holds."""

    transport = {}


_CAPTURE = threading.local()


def capturing():
    """True on this thread while :func:`capture_graph` runs its warm-ups
    or its capture: code reached there (a forward hook, ``mx.monitor``)
    must queue nothing and sync nothing."""
    return getattr(_CAPTURE, "depth", 0) > 0


def capture_graph(fn, pool=None, warmup=2):
    """``(graph, out, launches)``: ``fn()`` run ``warmup`` times on a side
    stream (first uses build kernels, fill lazy caches and let the
    libraries pick their algorithms, all outside the capture), then
    captured once into a CUDA graph on memory pool ``pool``; ``out`` is
    what the captured call returned (static tensors the graph writes).
    ``launches`` maps each kernel to the count its capture added: the
    capture ran nothing, so they are taken off ``LAUNCHES`` here and
    added per replay by :func:`replay_graph` (a :class:`GraphCounts`,
    whose ``transport`` does the same for ``parallel._compat.TRANSPORT``,
    the NCCL collectives a tensor-parallel program holds).  Anything
    that cannot be captured (a host sync, a pageable copy) raises: the
    error ``fn`` raised, after :func:`_abandon_capture` has put the
    memory pool, the default generator and the counts back as they
    were, so the process goes on as if no capture had begun.  The
    capture checks this thread only, so another thread's work on the
    card (a serving replica's engine reading its tokens) neither fails
    nor breaks it.  :func:`capturing` is True on this thread meanwhile."""
    _CAPTURE.depth = getattr(_CAPTURE, "depth", 0) + 1
    try:
        return _capture_graph(fn, pool, warmup)
    finally:
        _CAPTURE.depth -= 1


def _capture_graph(fn, pool, warmup):
    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from ..parallel._compat import TRANSPORT
    before, t_before = dict(LAUNCHES), dict(TRANSPORT)
    graph = torch.cuda.CUDAGraph()
    dev = torch.cuda.current_device()
    if pool is None:
        pool = torch.cuda.graph_pool_handle()   # private, but known here
    gen = torch.cuda.default_generators[dev]
    outside = gen.clone_state()       # the generator outside any capture
    failed = []
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            try:
                out = fn()
            except BaseException as e:
                failed.append(e)
                raise
    except BaseException as e:
        _abandon_capture(graph, dev, pool, gen, outside)
        LAUNCHES.update(before)
        TRANSPORT.update(t_before)
        raise (failed[0] if failed else e)
    launches = GraphCounts({k: n - before[k] for k, n in LAUNCHES.items()
                            if n != before[k]})
    for k, n in launches.items():
        LAUNCHES[k] -= n
    launches.transport = {k: n - t_before[k] for k, n in TRANSPORT.items()
                          if n != t_before[k]}
    for k, n in launches.transport.items():
        TRANSPORT[k] -= n
    return graph, out, launches


def _abandon_capture(graph, dev, pool, gen, outside):
    """Leave the process as it was before a capture that failed: a
    failed ``capture_end`` stops short of handing the memory pool back
    and of taking the default CUDA generator out of its capture (it
    would then raise "Offset increment outside graph capture" at every
    unseeded random draw), so both are done here, and the graph is
    dropped."""
    torch._C._cuda_endAllocateToPool(dev, pool)
    torch._C._cuda_releasePool(dev, pool)
    graph.reset()
    gen.graphsafe_set_state(outside)


def replay_graph(graph, launches):
    """Replay ``graph`` and count the kernel launches (and collectives)
    it holds."""
    graph.replay()
    for k, n in launches.items():
        LAUNCHES[k] += n
    transport = getattr(launches, "transport", None)
    if transport:
        from ..parallel._compat import TRANSPORT
        for k, n in transport.items():
            TRANSPORT[k] += n


def _is_cuda(*ts):
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError("attention inputs must all be on the CPU or all on "
                     "CUDA, got %s" % sorted(devs))


def _check_kernel_input(name, t, dtype, dim, align=16):
    if t.dtype != dtype:
        raise TypeError("%s: expected %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != dim:
        raise ValueError("%s: expected %d dims, got shape %s"
                         % (name, dim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.data_ptr() % align:
        raise ValueError("%s must be %d-byte aligned" % (name, align))


def _acc(t):
    """The plain versions' (and the general kernels') accumulation type:
    float64 for float64 inputs, float32 for every other float."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _fits_hopper(D, *ts):
    """Whether the Hopper paged kernel's type rule takes these inputs:
    bf16, 16-byte aligned, head_dim 64 or 128 (the flash kernels route
    by :func:`_flash_route`)."""
    return D in (64, 128) and all(
        t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0 for t in ts)


def _general_dtype(q, D):
    """The general kernels' dtype code of ``q``, raising on a dtype or a
    head_dim they do not take."""
    code = GENERAL_DTYPES.get(q.dtype)
    if code is None:
        raise TypeError("attention kernels take float16, bfloat16, float32 "
                        "or float64, got %s" % q.dtype)
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError("attention kernels take head_dim 1 to %d, got %d"
                         % (MAX_HEAD_DIM, D))
    return code


_ZERO_OFFSETS = {}


def _offsets(offset, device):
    """The offset as a one-element int32 tensor on ``device``.  ``None``
    gives one cached zero per device (the kernels only read it), so a
    call without offsets launches no fill kernel and allocates nothing."""
    if offset is None:
        zero = _ZERO_OFFSETS.get(device)
        if zero is None:
            zero = _ZERO_OFFSETS[device] = torch.zeros(
                1, dtype=torch.int32, device=device)
        return zero
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
    acc = _acc(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale
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
    return o.to(q.dtype), lse.float()


def _check_fwd_inputs(q, k, v, q_off, k_off, dtype, align):
    B, D = q.shape[0], q.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, t, dtype, 4, align)
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash kernel: k %s / v %s do not fit q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(q.shape)))
    if q_off.device != q.device or k_off.device != q.device:
        raise ValueError("flash kernel: offsets must be on %s" % q.device)


def _flash_fwd_cuda(q, k, v, q_off, k_off, causal, scale):
    """(o, lse) from the forward kernel of :func:`_flash_route`'s route:
    ``csrc/flash_fwd.cu`` (Hopper), ``csrc/flash_fwd_mma.cu`` (tensor
    cores) or ``csrc/flash_general.cu``."""
    route = _route_of(q, k, v)
    if route == "hopper":
        return _flash_fwd_hopper(q, k, v, q_off, k_off, causal, scale)
    return _flash_fwd_general(q, k, v, q_off, k_off, causal, scale, route)


def _flash_fwd_general(q, k, v, q_off, k_off, causal, scale, route):
    """(o, lse) from ``mx_flash_fwd_mma`` of ``csrc/flash_fwd_mma.cu``
    (route ``"mma"``) or ``mx_flash_fwd_general`` of
    ``csrc/flash_general.cu`` (``"simt"``): one C interface."""
    B, H, T, D = q.shape
    code = _general_dtype(q, D)
    _check_fwd_inputs(q, k, v, q_off, k_off, q.dtype, 1)
    lib, suffix = FWD_ROUTES[route]
    name = "flash_fwd_" + suffix
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    err = getattr(_build.library(lib), "mx_" + name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_off.data_ptr(),
        k_off.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, k.shape[1], T,
        k.shape[2], D, float(scale), int(bool(causal)), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))
    LAUNCHES[name] += 1
    return o, lse


def _check_hopper_dim(D):
    if D not in (64, 128):
        raise ValueError("Hopper flash kernels take head_dim 64 or 128, "
                         "got %d" % D)


def _flash_fwd_hopper(q, k, v, q_off, k_off, causal, scale):
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    _check_hopper_dim(D)
    _check_fwd_inputs(q, k, v, q_off, k_off, torch.bfloat16, 16)
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
    Returns (dq, dk, dv) in float64 for float64 inputs, else float32."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = H // Hkv
    acc = _acc(q)
    qf, dof = q.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(rep, dim=1)
    vf = v.to(acc).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        qpos = q_off.to(q.device)[0] + torch.arange(T, device=q.device)
        kpos = k_off.to(q.device)[0] + torch.arange(Tk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
    lse = lse.to(acc)
    lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta.to(acc)[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if rep > 1:
        dk = dk.reshape(B, Hkv, rep, Tk, D).sum(dim=2)
        dv = dv.reshape(B, Hkv, rep, Tk, D).sum(dim=2)
    return dq, dk, dv


def _delta(do, o, dlse):
    """Plain delta = rowsum(dO o O) - dlse (``_flash_lse_bwd``,
    pallas_ops.py:356-359), summed in the accumulation type and stored in
    float32, as the kernels store it; ``dlse`` may be None."""
    acc = _acc(do)
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1)
    return (delta if dlse is None else delta - dlse.to(acc)).float()


def _check_bwd_inputs(q, k, v, do, lse, delta, q_off, k_off, o, dlse,
                      dtype=torch.bfloat16, align=16):
    B, H, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do), ("o", o)):
        if t is not None:
            _check_kernel_input(name, t, dtype, 4, align)
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if t is not None:
            _check_kernel_input(name, t, torch.float32, 3, align)
    rows = [t for t in (lse, delta, dlse) if t is not None]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or do.shape != q.shape or (o is not None and o.shape != q.shape) \
            or any(t.shape != (B, H, T) for t in rows):
        raise ValueError("flash backward: k %s, v %s, do %s, o %s, lse / "
                         "delta / dlse %s do not fit q %s"
                         % (tuple(k.shape), tuple(v.shape), tuple(do.shape),
                            None if o is None else tuple(o.shape),
                            [tuple(t.shape) for t in rows], tuple(q.shape)))
    if q_off.device != q.device or k_off.device != q.device:
        raise ValueError("flash kernel: offsets must be on %s" % q.device)


def _launch_bwd(kernel, tensors, q, k, causal, scale):
    """Launch ``mx_<kernel>`` of ``csrc/flash_bwd.cu`` on ``tensors``'
    pointers (None passes a null one) and the shapes of q and k."""
    B, H, T, D = q.shape
    fn = getattr(_build.library("flash_bwd"), "mx_" + kernel)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(*(None if t is None else t.data_ptr() for t in tensors),
             B * H, B * k.shape[1], T, k.shape[2], D, float(scale),
             int(bool(causal)), stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (kernel, err))
    LAUNCHES[kernel] += 1


def _flash_route(dtype, D, aligned):
    """Which flash kernels, forward and backward, take inputs of
    ``dtype`` at head_dim ``D``; ``aligned``: rows of a 16-byte multiple
    (D * itemsize % 16 == 0) on 16-byte-aligned pointers.  ``"hopper"``:
    bf16 at 64 / 128 (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``);
    ``"mma"``: float16, bfloat16 or float32 up to 128
    (``csrc/flash_fwd_mma.cu``, ``csrc/flash_bwd_mma.cu``, TF32 tensor
    cores); ``"simt"``: the rest (float64, head_dim above 128, unaligned
    rows), on the CUDA cores (``csrc/flash_general.cu``)."""
    if aligned and dtype == torch.bfloat16 and D in (64, 128):
        return "hopper"
    if aligned and dtype in (torch.float16, torch.bfloat16, torch.float32) \
            and 1 <= D <= MMA_MAX_HEAD_DIM:
        return "mma"
    return "simt"


def _route_of(q, *ts):
    """:func:`_flash_route` of the inputs ``q`` and ``ts`` (None entries
    skipped)."""
    D = q.shape[-1]
    aligned = D * q.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q,) + ts if t is not None)
    return _flash_route(q.dtype, D, aligned)


def _launch_bwd_general(kernel, tensors, q, k, causal, scale, route):
    """Launch ``mx_<kernel>_mma`` of ``csrc/flash_bwd_mma.cu`` (route
    ``"mma"``) or ``mx_<kernel>_general`` of ``csrc/flash_general.cu``
    (``"simt"``): one C interface."""
    B, H, T, D = q.shape
    code = _general_dtype(q, D)
    lib, suffix = BWD_ROUTES[route]
    name = "%s_%s" % (kernel, suffix)
    err = getattr(_build.library(lib), "mx_" + name)(
        *(None if t is None else t.data_ptr() for t in tensors),
        B, H, k.shape[1], T, k.shape[2], D, float(scale), int(bool(causal)),
        code, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))
    LAUNCHES[name] += 1


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                       o=None, dlse=None):
    """dq from the kernel of :func:`_flash_route`: bf16 from the Hopper
    kernel, else in the accumulation type; ``o`` / ``dlse`` / ``delta``
    as for :func:`_flash_bwd_dq_hopper`."""
    route = _route_of(q, k, v, do, o)
    if route == "hopper":
        return _flash_bwd_dq_hopper(q, k, v, do, lse, delta, q_off, k_off,
                                    causal, scale, o=o, dlse=dlse)
    _check_bwd_inputs(q, k, v, do, lse, delta, q_off, k_off, o, dlse,
                      q.dtype, 1)
    dq = torch.empty(q.shape, dtype=_acc(q), device=q.device)
    _launch_bwd_general("flash_bwd_dq", (q, k, v, do, o, lse, dlse, delta,
                                         q_off, k_off, dq), q, k, causal,
                        scale, route)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_off, k_off, causal,
                        scale):
    """(dk, dv) from the kernel of :func:`_flash_route`: bf16 from the
    Hopper kernel, else in the accumulation type."""
    route = _route_of(q, k, v, do)
    if route == "hopper":
        return _flash_bwd_dkv_hopper(q, k, v, do, lse, delta, q_off, k_off,
                                     causal, scale)
    _check_bwd_inputs(q, k, v, do, lse, delta, q_off, k_off, None, None,
                      q.dtype, 1)
    dk = torch.empty(k.shape, dtype=_acc(q), device=q.device)
    dv = torch.empty(v.shape, dtype=_acc(q), device=q.device)
    _launch_bwd_general("flash_bwd_dkv", (q, k, v, do, lse, delta, q_off,
                                          k_off, dk, dv), q, k, causal,
                        scale, route)
    return dk, dv


def _flash_bwd_dq_hopper(q, k, v, do, lse, delta, q_off, k_off, causal,
                         scale, o=None, dlse=None):
    """dq (bf16) from ``mx_flash_bwd_dq``.  Without ``o`` the kernel
    reads ``delta``.  With ``o`` it computes delta = rowsum(dO o O) -
    dlse (``dlse`` may be None) for its own rows in the same launch and
    writes it into ``delta`` (B, H, T) float32, which
    :func:`_flash_bwd_dkv_cuda` then reads: launch that after this one,
    on the same stream."""
    _check_hopper_dim(q.shape[-1])
    _check_bwd_inputs(q, k, v, do, lse, delta, q_off, k_off, o, dlse)
    dq = torch.empty_like(q)
    _launch_bwd("flash_bwd_dq", (q, k, v, do, o, lse, dlse, delta, q_off,
                                 k_off, dq), q, k, causal, scale)
    return dq


def _flash_bwd_dkv_hopper(q, k, v, do, lse, delta, q_off, k_off, causal,
                          scale):
    """(dk, dv) (bf16) from ``mx_flash_bwd_dkv``."""
    _check_hopper_dim(q.shape[-1])
    _check_bwd_inputs(q, k, v, do, lse, delta, q_off, k_off, None, None)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("flash_bwd_dkv", (q, k, v, do, lse, delta, q_off, k_off, dk,
                                  dv), q, k, causal, scale)
    return dk, dv


def _flash_bwd_cuda(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
                    o=None, dlse=None):
    """(dq, dk, dv) from the two backward kernels of
    :func:`_flash_route`'s route: those of ``csrc/flash_bwd.cu`` (bf16
    out), ``csrc/flash_bwd_mma.cu`` or ``csrc/flash_general.cu`` (out in
    the accumulation type).  With ``o`` (and ``delta`` None) the dq
    kernel computes delta from ``o`` and ``dlse``; otherwise ``delta``
    is given."""
    if o is not None:
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, q_off, k_off, causal,
                            scale, o=o, dlse=dlse)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, q_off, k_off,
                                 causal, scale)
    return dq, dk, dv


def _flash_bwd(q, k, v, do, lse, delta, q_off, k_off, causal, scale,
               o=None, dlse=None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain recompute on
    the CPU.  Give either ``delta`` or ``o`` (and ``dlse``, or None)."""
    if _is_cuda(*(t for t in (q, k, v, do, lse, delta, o, dlse)
                  if t is not None)):
        return _flash_bwd_cuda(q, k, v, do, lse, delta, q_off, k_off,
                               causal, scale, o=o, dlse=dlse)
    if o is not None:
        delta = _delta(do, o, dlse)
    return _flash_bwd_dense(q, k, v, do, lse, delta, q_off, k_off, causal,
                            scale)


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with a recompute backward: the ``_flash_lse`` custom VJP
    (pallas_ops.py:334-376).  The forward keeps only O and the lse; the
    backward folds the lse cotangent into delta = rowsum(dO o O) - dlse
    (on CUDA inside the dq kernel's launch) and re-forms each score tile
    from q and k."""

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
        dor = do.to(q.dtype).contiguous()
        if dlse is not None:
            dlse = dlse.float().contiguous()
        dq, dk, dv = _flash_bwd(q, k, v, dor, lse, None, q_off, k_off,
                                ctx.causal, ctx.scale, o=o, dlse=dlse)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention_with_lse(q, k, v, causal=False, scale=None,
                             q_offset=None, k_offset=None):
    """Attention returning (output, logsumexp) on (B, H, T, D).

    ``k``/``v`` may carry fewer heads (H % H_kv == 0); the kernel maps
    each query head to its kv group, so repeated K/V are never stored.
    ``q_offset``/``k_offset`` are global position offsets for the causal
    mask (ints or int32 tensors of one element); the kernel reads them
    on the device.  On CUDA, q/k/v are contiguous, of one float dtype,
    with head_dim 1 to 256 (:func:`_flash_route`: bf16 at 64 or 128 runs
    the Hopper kernels, float16 / bfloat16 / float32 up to 128 with
    16-byte rows the tensor-core ones, the rest the general ones); the
    lse is float32 (B, H, T).
    Gradients flow through both outputs, on CUDA through the backward
    kernels.  ``torch.export`` of a forward that reaches it raises."""
    refuse_export("flash forward")
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
    acc = _acc(q)
    sc = torch.einsum("shd,skhd->shk", q.to(acc), k.to(acc)) * scale
    kpos = torch.arange(MP * psz, device=q.device)
    mask = kpos[None, None, :] < lengths.to(q.device)[:, None, None]
    sc = sc.masked_fill(~mask, NEG_INF)
    m = sc.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(sc - m_safe[..., None]).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("shk,skhd->shd", p / l_safe[..., None], v.to(acc))
    return o.to(q.dtype)


#: CTAs the split plan aims for: 8 per SM of an H100.  Splits past a
#: slot's length exit at once, so a generous grid costs little.
PAGED_TARGET_CTAS = 8 * 132


def paged_split_plan(S, Hkv, MP, psz):
    """How ``csrc/paged_decode.cu`` splits each (slot, kv head):
    ``(nsplit, keys_per_split, chunk)``.  Split ``i`` covers key
    positions ``[i * keys_per_split, (i + 1) * keys_per_split)`` of the
    ``MP * psz`` a slot can hold, in chunks of ``chunk`` keys that never
    straddle a page.  It depends on the shapes only, never on the
    lengths, so sizing the grid reads nothing from the device."""
    chunk = next(c for c in (64, 32, 16) if psz % c == 0)
    n_chunks = MP * psz // chunk
    want = max(1, -(-PAGED_TARGET_CTAS // (S * Hkv)))
    per = -(-n_chunks // min(n_chunks, want))
    return -(-n_chunks // per), per * chunk, chunk


#: key positions a tile of ``csrc/paged_general.cu`` stages, and the
#: unit of its split plan
PAGED_GENERAL_CHUNK = 32
#: query heads one CTA of ``csrc/paged_general.cu`` scores
PAGED_GENERAL_HEADS = 32


def paged_general_plan(S, H, Hkv, MP, psz):
    """How ``csrc/paged_general.cu`` splits each (slot, kv head):
    ``(nsplit, keys_per_split, chunk)``, as :func:`paged_split_plan`,
    but in chunks of :data:`PAGED_GENERAL_CHUNK` key positions that may
    cross pages (the kernel looks up each position's page), so any page
    size works, and with the CTAs of a GQA group above
    :data:`PAGED_GENERAL_HEADS` query heads counted.  It depends on the
    shapes only, never on the lengths."""
    chunk = PAGED_GENERAL_CHUNK
    n_chunks = -(-MP * psz // chunk)
    groups = -(-(H // Hkv) // PAGED_GENERAL_HEADS)
    want = max(1, -(-PAGED_TARGET_CTAS // max(1, S * Hkv * groups)))
    per = -(-n_chunks // min(n_chunks, want))
    return -(-n_chunks // per), per * chunk, chunk


def _paged_split_dense(q, k_pages, v_pages, page_table, lengths, scale,
                       plan=None):
    """Plain version of the split kernels' algorithm: each split of
    ``plan`` -- ``(nsplit, keys_per_split, chunk)``, by default
    :func:`paged_split_plan`'s (the Hopper kernel's), or
    :func:`paged_general_plan`'s (the general kernel's) -- takes a
    softmax over its own keys, giving (m, l, acc); the splits are merged
    in split order.  Sums in float64 for float64 inputs, else float32.
    Equal to :func:`_paged_dense` up to rounding."""
    S, H, D = q.shape
    Hkv, psz = k_pages.shape[1], k_pages.shape[2]
    MP = page_table.shape[1]
    nsplit, kps, _ = plan or paged_split_plan(S, Hkv, MP, psz)
    rep = H // Hkv
    acc_t = _acc(q)
    pt = page_table.long()

    def gather(pages):
        x = pages[pt].permute(0, 1, 3, 2, 4).reshape(S, MP * psz, Hkv, D)
        return x.repeat_interleave(rep, dim=2).to(acc_t)
    k, v = gather(k_pages), gather(v_pages)
    sc = torch.einsum("shd,skhd->shk", q.to(acc_t), k) * scale
    kpos = torch.arange(MP * psz, device=q.device)
    live = kpos[None, None, :] < lengths.to(q.device)[:, None, None]
    sc = sc.masked_fill(~live, NEG_INF)
    parts = []
    for i in range(nsplit):
        lo, hi = i * kps, min((i + 1) * kps, MP * psz)
        m = sc[..., lo:hi].amax(dim=-1)
        m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
        p = torch.exp(sc[..., lo:hi] - m_safe[..., None])
        parts.append((m, p.sum(dim=-1),
                      torch.einsum("shk,skhd->shd", p, v[:, lo:hi])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    m_all = torch.where(torch.isneginf(m_all), torch.zeros_like(m_all),
                        m_all)
    l = torch.zeros_like(m_all)
    acc = torch.zeros(S, H, D, dtype=acc_t, device=q.device)
    for m, l_i, acc_i in parts:
        w = torch.where(torch.isneginf(m), torch.zeros_like(m),
                        torch.exp(m - m_all))
        l = l + w * l_i
        acc = acc + w[..., None] * acc_i
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(q.dtype)


def _paged_decode_cuda(q, k_pages, v_pages, page_table, lengths, scale):
    """The Hopper kernel where it takes the inputs (and rep <= 8, a page
    size that is a multiple of 16), else the general kernel."""
    H, Hkv, psz = q.shape[1], k_pages.shape[1], k_pages.shape[2]
    if _fits_hopper(q.shape[-1], q, k_pages, v_pages) and H // Hkv <= 8 \
            and psz % 16 == 0:
        return _paged_decode_hopper(q, k_pages, v_pages, page_table,
                                    lengths, scale)
    return _paged_decode_general(q, k_pages, v_pages, page_table, lengths,
                                 scale)


def _check_paged_inputs(q, k_pages, v_pages, page_table, lengths, dtype,
                        align):
    S = q.shape[0]
    _check_kernel_input("q", q, dtype, 3, align)
    _check_kernel_input("k_pages", k_pages, dtype, 4, align)
    _check_kernel_input("v_pages", v_pages, dtype, 4, align)
    _check_kernel_input("page_table", page_table, torch.int32, 2, align)
    _check_kernel_input("lengths", lengths, torch.int32, 1, align)
    if v_pages.shape != k_pages.shape or page_table.shape[0] != S \
            or lengths.shape[0] != S or k_pages.shape[3] != q.shape[2]:
        raise ValueError("paged kernel: pools %s / %s, page table %s, "
                         "lengths %s do not fit q %s"
                         % (tuple(k_pages.shape), tuple(v_pages.shape),
                            tuple(page_table.shape), tuple(lengths.shape),
                            tuple(q.shape)))


def _paged_decode_general(q, k_pages, v_pages, page_table, lengths, scale):
    S, H, D = q.shape
    Hkv, psz = k_pages.shape[1], k_pages.shape[2]
    MP = page_table.shape[1]
    code = _general_dtype(q, D)
    _check_paged_inputs(q, k_pages, v_pages, page_table, lengths, q.dtype, 1)
    nsplit, kps, _ = paged_general_plan(S, H, Hkv, MP, psz)
    out = torch.empty_like(q)
    # each split's unnormalised (acc, (m, l)), merged by the second kernel
    part_acc = torch.empty((S, H, nsplit, D), dtype=_acc(q),
                           device=q.device)
    part_ml = torch.empty((S, H, nsplit, 2), dtype=_acc(q), device=q.device)
    err = _build.library("paged_general").mx_paged_decode_general(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), S, H, Hkv, psz, D, MP,
        nsplit, kps, float(scale), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_decode_general kernel launch failed: CUDA "
                           "error %d" % err)
    LAUNCHES["paged_decode_general"] += 1   # the split and merge as one
    return out


def _paged_decode_hopper(q, k_pages, v_pages, page_table, lengths, scale):
    S, H, D = q.shape
    P, Hkv, psz, _ = k_pages.shape
    _check_paged_inputs(q, k_pages, v_pages, page_table, lengths,
                        torch.bfloat16, 16)
    if D not in (64, 128):
        raise ValueError("Hopper paged kernel takes head_dim 64 or 128, got "
                         "%d" % D)
    if psz % 16:
        raise ValueError("Hopper paged kernel takes a page size that is a "
                         "multiple of 16, got %d" % psz)
    if H // Hkv > 8:
        raise ValueError("Hopper paged kernel takes at most 8 query heads "
                         "per kv head, got %d" % (H // Hkv))
    MP = page_table.shape[1]
    nsplit, kps, chunk = paged_split_plan(S, Hkv, MP, psz)
    out = torch.empty_like(q)
    # each split's unnormalised (acc, (m, l)), merged by the second kernel
    part_acc = torch.empty((S, H, nsplit, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((S, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    lib = _build.library("paged_decode")
    err = lib.mx_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), S, H, Hkv, psz, D, MP,
        nsplit, kps, chunk, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_decode kernel launch failed: CUDA error "
                           "%d" % err)
    LAUNCHES["paged_decode"] += 1     # the split and merge kernels as one
    return out


def paged_attention(q, k_pages, v_pages, page_table, lengths, scale=None):
    """One decode step's attention read over a paged KV cache.

    ``q``: (S, H, D), one query token per batch slot; ``k_pages`` /
    ``v_pages``: (P, H_kv, page_size, D) single-layer page pools;
    ``page_table``: (S, MP) int32 page ids per slot (unused entries must
    hold a valid id, by convention the trash page 0); ``lengths``: (S,)
    int32 tokens to attend over per slot, the new token included.  A
    slot with ``lengths == 0`` returns zeros.  Page ids and lengths are
    trusted: the kernel reads the pages they name.  ``torch.export`` of
    a forward that reaches it raises."""
    refuse_export("paged_decode")
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
