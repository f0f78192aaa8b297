"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``
(printing each kernel's registers and spills, and failing where ptxas
serialised its wgmma pipeline), holds each against its plain PyTorch
version on the card, checks one training step of a small bf16 model
on the card against the CPU, serves a Llama-3-8B-width
``TransformerLM`` (random weights from a seed)
through the port's ``Server`` and checks the served tokens against a
full-sequence forward, trains an 8-layer Llama-3-8B-width model
through ``TrainStep`` and the Gluon ``Trainer``, runs ResNet-50 from
the Gluon zoo (inference at ``__graft_entry__.entry()``'s shape, eager and
hybridized, NCHW and NHWC, then training) and trains BERT-base through
the flash kernels at head_dim 64.  Each path that runs kernels does so
with the launch counts reset before it and read after it, and fails
unless every kernel it goes through was launched.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without a CUDA device it exits non-zero at once.

A kernel's time is its own device time, summed from a torch.profiler
trace of its calls with the L2 cache flushed before each
(:func:`device_ms`); the event time of the whole wrapper call is kept
beside it as ``call_ms``.  ``python3 chip_smoke.py --kernel-timing``
runs only the forward, backward and paged kernels' timing; copied into
another checkout's root, it times that tree's kernels the same way, so
two trees compare in one call.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
# Tolerances against the plain version on the same card inputs.  Flash O
# is bf16 with P rounded to bf16 before P.V: one bf16 step of an |O| near
# 2-4 is 1.6e-2.  lse is fp32 throughout.  Paged keeps P in fp32, so O
# differs from plain only by the bf16 rounding of the output: one step,
# at most 2^-7 of |O|, plus a small floor for fp32 summation order.
FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-5
PAGED_ATOL, PAGED_RTOL = 1e-3, 1e-2
# Flash backward: P and dS are rounded to bf16 (8 bits of mantissa, a
# relative step of 2^-8 = 3.9e-3) before their tile products, and the
# outputs are bf16, against a plain version in fp32; the limit is on
# max|kernel - plain| / max|plain| per tensor.
# Measured on an H100: at most 4.7e-3 over the cases below.
FLASH_BWD_TOL = 1e-2
# Training parity on the card (bf16 model on CUDA vs the same weights on
# the CPU's plain path): the loss to 1e-2 relative, each parameter's grad
# to GRAD_REL_TOL in ||g_cuda - g_cpu|| / ||g_cpu||.
# Measured on an H100: loss 5.5e-5 relative, grads at most 1.35e-2
# (median 8.6e-3): the kernels round P and dS to bf16, the plain path
# does not.
PARITY_LOSS_RTOL = 1e-2
GRAD_REL_TOL = 3e-2
# Served tokens against a teacher-forced full forward.  The two paths
# round differently in bf16 (decode GEMMs at M = 8 against M = T; the
# paged kernel keeps P in fp32 where the flash kernel rounds it to bf16),
# so near-ties flip.  Measured on an H100 over all 448 greedy positions
# of the serving run: the served token's logit was at most 0.1875 below
# the full forward's top with the mma.sync forward and unsplit paged
# decode, 0.1562 with the TMA/wgmma forward and split paged decode (6
# and 5 bf16 steps of a logit in [4, 8)), and 93.5% / 95.1% of the
# served tokens were the argmax.
SERVED_LOGIT_TOL = 0.25         # 8 bf16 steps of a logit in [4, 8)
SERVED_EXACT_MIN = 0.85
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FLUSH_BYTES = 256 << 20         # > the 50 MB L2: every timed call is cold
FLUSH_KERNEL = "FillFunctor<unsigned char>"   # the flush's zero_()


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` in ms, CUDA events around each call,
    with the L2 cache flushed before every call."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_ms(fn, match=None, iters=20, warmup=3, attempts=5):
    """(ms, per_kernel) of ``fn()``: the device time per call of its
    kernels whose name contains ``match`` (all of them when None), from
    a torch.profiler trace of ``iters`` calls with the L2 cache flushed
    before each; ``per_kernel`` maps every kernel of the call to its ms
    per call.  The flush is a uint8 fill, left out by its kernel's name.
    The trace now and then comes back missing some or all device events
    (seen on the H100 machine); it counts only when the flush kernel
    appears once per call, and is taken again otherwise."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        if sum(e.count for e in events if FLUSH_KERNEL in e.key) == iters:
            break
    else:
        raise SmokeFailure("%d profiler traces in a row lacked device "
                           "events: %s" % (attempts,
                                           sorted(e.key for e in events)))
    per = {e.key: e.self_device_time_total / iters / 1e3
           for e in events if FLUSH_KERNEL not in e.key}
    ms = sum(v for k, v in per.items() if match is None or match in k)
    check(ms > 0, "no device time for %r in %s" % (match, sorted(per)))
    return ms, per


def ptxas_report(build):
    """Registers and spill bytes of every kernel, from the ``-Xptxas
    -v`` output kept beside each library; fails where ptxas serialised
    the wgmma pipeline (warnings C7514 / C7515)."""
    out = []
    for name in build.SOURCES:
        log = build.build_log(name)
        check("C7514" not in log and "C7515" not in log,
              "ptxas serialised wgmma in %s:\n%s" % (name, log))
        for fn, body in re.findall(
                r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry"
                r" function|\Z)", log, re.S):
            kern = re.search(r"\d([a-z_]+_kernel)ILi(\d+)E", fn)
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            out.append("%s<%s> %s regs %s B spill"
                       % (kern.group(1), kern.group(2), regs.group(1),
                          spill.group(1)))
    print("ptxas: " + "; ".join(sorted(out)))


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: flash forward kernel vs plain _dense_with_lse
# ----------------------------------------------------------------------
def flash_phase(co, dev):
    gen = torch.Generator(device="cpu").manual_seed(1)
    H, Hkv, D = 32, 8, 128
    # (B, T, Tk, causal, q_off, k_off); the main path's two shapes are
    # checked where they are timed (flash_timing)
    cases = [(1, 128, 128, True, 0, 0), (1, 128, 128, False, 0, 0),
             (1, 512, 512, False, 0, 0),
             (1, 300, 300, True, 0, 0), (1, 300, 300, False, 0, 0),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 300, 428, True, 28, 128)]
    err_o = err_l = 0.0
    for B, T, Tk, causal, qo, ko in cases:
        q = torch.randn(B, H, T, D, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(B, Hkv, Tk, D, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(B, Hkv, Tk, D, generator=gen).to(dev, torch.bfloat16)
        o, lse = co.flash_attention_with_lse(q, k, v, causal=causal,
                                             q_offset=qo, k_offset=ko)
        offs = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (qo, ko)]
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
        torch.cuda.synchronize()
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked),
              "flash: -inf lse rows differ (T=%d causal=%s)" % (T, causal))
        check(bool((o[masked[..., None].expand_as(o)] == 0).all()),
              "flash: a fully masked row is not zero")
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse[~masked] - lse_p[~masked]).abs().max().item()
        print("flash B=%d T=%d Tk=%d causal=%s q_off=%d k_off=%d: O err "
              "%.3e, lse err %.3e (max |kernel - plain|); masked rows %d"
              % (B, T, Tk, causal, qo, ko, eo, el, int(masked.sum())))
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash kernel disagrees with plain: %.3e / %.3e (limits "
              "%.0e / %.0e)" % (eo, el, FLASH_O_ATOL, FLASH_LSE_ATOL))
        err_o, err_l = max(err_o, eo), max(err_l, el)

    shapes = flash_timing(co, dev)
    head = shapes[0]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:62",
            "max_abs_err": max([err_o] + [s["max_abs_err"] for s in shapes]),
            "max_abs_err_lse": max([err_l] + [s["max_abs_err_lse"]
                                              for s in shapes]),
            **{k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "library_kernels")},
            "shapes": shapes}


# (B, H, Hkv, T, D, causal): the serving ladder's top rung, the training
# shape, and BERT-base's attention (12 heads of 64, non-causal)
FWD_SHAPES = [(1, 32, 8, 512, 128, True), (2, 32, 8, 1024, 128, True),
              (16, 12, 12, 512, 64, False)]


def _pairs(B, H, T, causal):
    """Score pairs the work needs: the visible ones when causal."""
    return B * H * (T * (T + 1) // 2 if causal else T * T)


def flash_timing(co, dev, shapes=FWD_SHAPES):
    """The flash forward at the main paths' shapes: held against plain,
    then timed -- the kernel's own device time, the event time of the
    whole wrapper call, the plain version and SDPA (its kernels' device
    time, names on record)."""
    out = []
    for i, (B, H, Hkv, T, D, causal) in enumerate(shapes):
        gen = torch.Generator(device="cpu").manual_seed(100 + i)
        q = torch.randn(B, H, T, D, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(B, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(B, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        o, lse = co.flash_attention_with_lse(q, k, v, causal=causal)
        o_p, lse_p = co._dense_with_lse(q, k, v, zero, zero, causal,
                                        D ** -0.5)
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse - lse_p).abs().max().item()
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash (%d,%d,%d,%d) disagrees with plain: %.3e / %.3e"
              % (B, H, T, D, eo, el))
        del o, lse, o_p, lse_p
        ms, _ = device_ms(lambda: co.flash_attention(q, k, v, causal=causal),
                          "flash_fwd")
        call_ms = time_ms(lambda: co.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: co._dense_with_lse(
            q, k, v, zero, zero, causal, D ** -0.5), iters=5)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms, lib_k = device_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                               enable_gqa=Hkv != H))
        nbytes = 2 * (2 * B * H * T * D + 2 * B * Hkv * T * D) + 4 * B * H * T
        b_ms, b_by = bound_ms(nbytes, 4 * D * _pairs(B, H, T, causal))
        shape = "q(%d,%d,%d,%d) %s" % (B, H, T, D,
                                       "causal" if causal else "non-causal")
        print("flash timing %s: kernel %.4f ms (device), call %.4f ms "
              "(events), plain %.4f ms, SDPA %.4f ms (device; kernels %s), "
              "bound %.4f ms (%s); O err %.3e, lse err %.3e"
              % (shape, ms, call_ms, plain_ms, lib_ms,
                 ", ".join("%s %.4f" % kv for kv in lib_k.items()), b_ms,
                 b_by, eo, el))
        out.append({"shape": shape, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_kernels": lib_k, "bound_ms": b_ms,
                    "bound_by": b_by, "max_abs_err": eo,
                    "max_abs_err_lse": el})
        del q, k, v
    return out


# ----------------------------------------------------------------------
# phase 3: flash backward kernels vs plain _flash_bwd_dense
# ----------------------------------------------------------------------
def _bwd_inputs(co, gen, dev, B, H, Hkv, T, Tk, D, causal, qo, ko):
    """bf16 q/k/v/dO, the forward's O and lse, a random dlse, delta =
    rowsum(dO o O) - dlse, and the device offsets."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, k, v = rnd(B, H, T, D), rnd(B, Hkv, Tk, D), rnd(B, Hkv, Tk, D)
    do = rnd(B, H, T, D)
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (qo, ko)]
    o, lse = co._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    dlse = torch.randn(B, H, T, generator=gen).to(dev)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    return q, k, v, do, o, lse, dlse, delta, offs


TRAIN_ATTN = (2, 32, 8, 1024, 128, True)     # (B, H, Hkv, T, D, causal)
BERT_ATTN = (16, 12, 12, 512, 64, False)


def flash_bwd_phase(co, dev, card):
    gen = torch.Generator(device="cpu").manual_seed(4)
    # (B, H, Hkv, T, Tk, causal, q_off, k_off, D); the last two are the
    # main paths' shapes: training, q (2,32,1024,128) causal over k/v
    # (2,8,1024,128), and BERT-base, q/k/v (16,12,512,64) non-causal
    cases = [(1, 32, 8, 128, 128, True, 0, 0, 128),
             (1, 32, 8, 128, 128, False, 0, 0, 128),
             (1, 32, 8, 300, 300, True, 0, 0, 128),
             (1, 32, 8, 300, 300, False, 0, 0, 128),
             (1, 32, 8, 1024, 1024, True, 0, 0, 128),
             (1, 32, 8, 1024, 1024, False, 0, 0, 128),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 32, 8, 300, 428, True, 28, 128, 128),
             (1, 32, 8, 300, 300, True, 0, 0, 64),
             (2, 32, 8, 1024, 1024, True, 0, 0, 128),
             (16, 12, 12, 512, 512, False, 0, 0, 64)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    abs_err = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    timed = {}
    for B, H, Hkv, T, Tk, causal, qo, ko, D in cases:
        inputs = _bwd_inputs(co, gen, dev, B, H, Hkv, T, Tk, D, causal, qo,
                             ko)
        q, k, v, do, o, lse, dlse, delta, offs = inputs
        # the forward's O and lse, which the backward takes, against plain
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked),
              "flash bwd: -inf lse rows of the forward differ")
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse[~masked] - lse_p[~masked]).abs().max().item()
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash bwd: the forward disagrees with plain: %.3e / %.3e "
              "(limits %.0e / %.0e)" % (eo, el, FLASH_O_ATOL, FLASH_LSE_ATOL))
        del o_p, lse_p
        want = co._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                   D ** -0.5)
        # delta computed inside the dq launch from O and dlse (the
        # training path), then given (the ring primitive's path)
        for how, extra in (("fused delta", dict(o=o, dlse=dlse)),
                           ("given delta", {})):
            got = co._flash_bwd_cuda(q, k, v, do, lse,
                                     None if extra else delta, *offs,
                                     causal, D ** -0.5, **extra)
            torch.cuda.synchronize()
            rel = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w).abs().max().item()
                rel[name] = err / w.abs().max().item()
                abs_err[name] = max(abs_err[name], err)
                worst[name] = max(worst[name], rel[name])
            check(not got[0][masked[..., None].expand_as(got[0])].any(),
                  "flash bwd: dq of a fully masked row is not zero")
            print("flash bwd B=%d H=%d/%d T=%d Tk=%d causal=%s q_off=%d "
                  "k_off=%d D=%d, %s: forward O err %.3e, lse err %.3e; "
                  "max|d|/max|plain| dq %.3e dk %.3e dv %.3e, masked rows %d"
                  % (B, H, Hkv, T, Tk, causal, qo, ko, D, how, eo, el,
                     rel["dq"], rel["dk"], rel["dv"], int(masked.sum())))
            check(max(rel.values()) <= FLASH_BWD_TOL,
                  "flash bwd kernels disagree with plain (%s): %s (limit "
                  "%.0e)" % (how, rel, FLASH_BWD_TOL))
            del got
        del want
        shape = (B, H, Hkv, T, D, causal)
        if shape in (TRAIN_ATTN, BERT_ATTN) and T == Tk and qo == ko == 0:
            timed[shape] = inputs
        del inputs, q, k, v, do, o, lse, dlse, delta

    # timing on the main paths' inputs, the last two cases above
    ts = [bwd_timing(co, dev, card, shape, timed.pop(shape))
          for shape in (TRAIN_ATTN, BERT_ATTN)]
    for t in ts:
        others = sorted(k for k in t["backward_kernels"]
                        if "flash_bwd" not in k)
        check(not others, "the backward launched kernels besides dq and "
              "dk/dv (an eager delta pass?): %s" % others)
    t = ts[0]
    keys = ("plain_ms", "library_ms", "library_call_ms", "library_kernels",
            "backward_ms", "backward_call_ms", "backward_kernels",
            "delta_ms")
    common = {"route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
              **{k: t[k] for k in keys}}

    def shapes(kernel):
        return [dict({k: x[k] for k in ("shape",) + keys},
                     ms=x[kernel + "_ms"], call_ms=x[kernel + "_call"],
                     bound_ms=x[kernel + "_bound"][0],
                     bound_by=x[kernel + "_bound"][1]) for x in ts]
    return [dict(common, name="flash_bwd_dq",
                 replaces="mxnet_tpu/ops/pallas_ops.py:149",
                 max_abs_err=abs_err["dq"], max_rel_err=worst["dq"],
                 ms=t["dq_ms"], call_ms=t["dq_call"],
                 bound_ms=t["dq_bound"][0], bound_by=t["dq_bound"][1],
                 shapes=shapes("dq")),
            dict(common, name="flash_bwd_dkv",
                 replaces="mxnet_tpu/ops/pallas_ops.py:227",
                 max_abs_err=max(abs_err["dk"], abs_err["dv"]),
                 max_rel_err=max(worst["dk"], worst["dv"]),
                 ms=t["dkv_ms"], call_ms=t["dkv_call"],
                 bound_ms=t["dkv_bound"][0], bound_by=t["dkv_bound"][1],
                 shapes=shapes("dkv"))]


def bwd_timing(co, dev, card, shape=TRAIN_ATTN, inputs=None):
    """The backward at ``shape`` (B, H, Hkv, T, D, causal) over its
    inputs (made here unless given): each kernel's own device time and
    its call's event time; the whole port backward --
    ``torch.autograd.grad`` through ``flash_attention_with_lse`` with dO
    and a dlse cotangent, delta pass included wherever the tree does it
    -- by device time (all its kernels) and event time; SDPA's backward
    the same way; the eager delta pass and the plain version by event
    time.  Only calls that an earlier tree also has, so that this file
    copied into that tree's root times it the same way."""
    import inspect
    B, H, Hkv, T, D, causal = shape
    if inputs is None:
        gen = torch.Generator(device="cpu").manual_seed(104)
        inputs = _bwd_inputs(co, gen, dev, B, H, Hkv, T, T, D, causal, 0, 0)
    q, k, v, do, o, lse, dlse, delta, offs = inputs
    scale = D ** -0.5
    args = (q, k, v, do, lse, delta, *offs, causal, scale)
    if "o" in inspect.signature(co._flash_bwd_dq_cuda).parameters:
        scratch = torch.empty_like(delta)   # the dq launch writes delta

        def dq_fn():
            return co._flash_bwd_dq_cuda(q, k, v, do, lse, scratch, *offs,
                                         causal, scale, o=o, dlse=dlse)
    else:
        def dq_fn():
            return co._flash_bwd_dq_cuda(*args)
    dq_ms, _ = device_ms(dq_fn, "flash_bwd_dq")
    dkv_ms, _ = device_ms(lambda: co._flash_bwd_dkv_cuda(*args),
                          "flash_bwd_dkv")
    dq_call = time_ms(dq_fn)
    dkv_call = time_ms(lambda: co._flash_bwd_dkv_cuda(*args))
    delta_ms = time_ms(lambda: (do.float() * o.float()).sum(-1) - dlse)
    plain_ms = time_ms(lambda: co._flash_bwd_dense(*args), iters=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out, lse_g = co.flash_attention_with_lse(qg, kg, vg, causal=causal)

    def port_bwd():
        return torch.autograd.grad((out, lse_g), (qg, kg, vg), (do, dlse),
                                   retain_graph=True)
    port_ms, port_k = device_ms(port_bwd)
    port_call = time_ms(port_bwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=Hkv != H)

    def sdpa_bwd():
        return torch.autograd.grad(ref, (qg, kg, vg), do, retain_graph=True)
    lib_ms, lib_k = device_ms(sdpa_bwd)
    lib_call = time_ms(sdpa_bwd)
    pairs = _pairs(B, H, T, causal)
    qd, kd = 2 * B * H * T * D, 2 * B * Hkv * T * D  # bytes of one q / k
    # dq: q, dO, O, k, v, lse and dlse read, dq and delta written
    dq_b = bound_ms(3 * qd + 2 * kd + 2 * 4 * B * H * T + qd + 4 * B * H * T,
                    6 * D * pairs)
    # dk/dv: q, dO, k, v, lse and delta read, dk and dv written
    dkv_b = bound_ms(2 * qd + 2 * kd + 2 * 4 * B * H * T + 2 * kd,
                     8 * D * pairs)
    name = "q(%d,%d,%d,%d) %s, kv (%d,%d,%d,%d)" % (
        B, H, T, D, "causal" if causal else "non-causal", B, Hkv, T, D)
    print("flash bwd timing %s: dq %.4f ms (device; call %.4f, bound %.4f, "
          "%s), dkv %.4f ms (device; call %.4f, bound %.4f, %s); whole port "
          "backward %.4f ms (device; call %.4f; kernels %s); SDPA backward "
          "%.4f ms (device; call %.4f; kernels %s); eager delta pass %.4f "
          "ms, plain %.4f ms (events) [%s]"
          % (name, dq_ms, dq_call, dq_b[0], dq_b[1], dkv_ms, dkv_call,
             dkv_b[0], dkv_b[1], port_ms, port_call,
             ", ".join("%s %.4f" % kv for kv in port_k.items()), lib_ms,
             lib_call, ", ".join("%s %.4f" % kv for kv in lib_k.items()),
             delta_ms, plain_ms, card))
    return {"shape": name, "dq_ms": dq_ms, "dq_call": dq_call,
            "dq_bound": dq_b, "dkv_ms": dkv_ms, "dkv_call": dkv_call,
            "dkv_bound": dkv_b, "backward_ms": port_ms,
            "backward_call_ms": port_call, "backward_kernels": port_k,
            "library_ms": lib_ms, "library_call_ms": lib_call,
            "library_kernels": lib_k, "delta_ms": delta_ms,
            "plain_ms": plain_ms}


# ----------------------------------------------------------------------
# phase 4: one training step of a small bf16 model, card vs CPU
# ----------------------------------------------------------------------
def parity_phase(mt, co, dev, card):
    """The same bf16 weights on CUDA (flash kernels) and on the CPU
    (plain versions): one forward + backward of the mean softmax-CE."""
    cfg = mt.models.LlamaConfig(vocab_size=32000, dim=1024, n_layers=2,
                                n_heads=8, n_kv_heads=2, hidden_dim=2816,
                                dtype="bfloat16")
    net = mt.models.TransformerLM(cfg, device=dev).initialize(
        torch.Generator(device=dev).manual_seed(5))
    cpu = mt.convert.load_params(mt.models.TransformerLM(cfg, device="cpu"),
                                 mt.convert.export_params(net))
    gen = torch.Generator().manual_seed(6)
    toks, labels = (torch.randint(0, cfg.vocab_size, (1, 256), generator=gen)
                    for _ in range(2))
    loss_fn = mt.gluon.loss.SoftmaxCELoss()
    losses = []
    co.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        logits = model(toks.to(d)).float()
        loss = loss_fn(logits.reshape(-1, cfg.vocab_size),
                       labels.to(d).reshape(-1)).mean()
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    check(co.LAUNCHES["flash_bwd_dq"] == cfg.n_layers
          and co.LAUNCHES["flash_bwd_dkv"] == cfg.n_layers,
          "parity: the backward kernels did not run: %s" % co.LAUNCHES)
    rel = {}
    for (name, g), (_, p) in zip(net.named_parameters(),
                                 cpu.named_parameters()):
        gc, gp = g.grad.float().cpu(), p.grad.float()
        rel[name] = ((gc - gp).norm() / gp.norm()).item()
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            g = getattr(getattr(net, "layer%d" % i).attention, w).weight.grad
            check(g is not None and bool(g.any()),
                  "parity: layer%d %s has no gradient on CUDA" % (i, w))
    worst = max(rel, key=rel.get)
    print("parity (dim 1024, 8/2 heads, hidden 2816, 2 layers, vocab "
          "32000, T=256): loss cuda %.6f cpu %.6f; grad ||cuda-cpu||/||cpu||"
          " max %.3e (%s), median %.3e [%s]"
          % (losses[0], losses[1], rel[worst], worst,
             sorted(rel.values())[len(rel) // 2], card))
    check(abs(losses[0] - losses[1]) <= PARITY_LOSS_RTOL * abs(losses[1]),
          "parity: losses differ: %s" % losses)
    check(rel[worst] <= GRAD_REL_TOL, "parity: %s grad differs by %.3e "
          "(limit %.0e)" % (worst, rel[worst], GRAD_REL_TOL))
    return rel[worst]


# ----------------------------------------------------------------------
# phase 5: paged decode kernel vs plain _paged_dense
# ----------------------------------------------------------------------
def paged_phase(co, dev):
    """The paged decode kernel against plain at three shapes, each then
    timed: ``paged_phase`` (ragged lengths with an empty slot, one exactly
    full page and a full table), ``serve`` (the lengths of the served
    decode steps) and ``long`` (8 slots of 8192 tokens, 268 MB of K/V,
    where bytes really bound it)."""
    shapes = paged_timing(co, dev)
    head = shapes[1]
    return {"name": "paged_decode", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_decode.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:621",
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            **{k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "shapes": shapes}


def paged_timing(co, dev):
    H, Hkv, D, psz = 32, 8, 128, 128
    cases = [("paged_phase", [0, 37, 128, 129, 300, 450, 531, 640], 5),
             ("serve", [51, 90, 128, 129, 200, 256, 300, 347], 5),
             ("long", [8192] * 8, 64)]
    out = []
    for i, (name, lens_h, MP) in enumerate(cases):
        gen = torch.Generator(device="cpu").manual_seed(200 + i)
        S = len(lens_h)
        P = S * MP + 1                         # page 0 is the trash page
        q = torch.randn(S, H, D, generator=gen).to(dev, torch.bfloat16)
        kp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev,
                                                           torch.bfloat16)
        vp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev,
                                                           torch.bfloat16)
        pt = (torch.randperm(P - 1, generator=gen) + 1).reshape(S, MP)
        pt = pt.to(dev, torch.int32)
        lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
        got = co.paged_attention(q, kp, vp, pt, lens)
        want = co._paged_dense(q, kp, vp, pt, lens, D ** -0.5)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # the largest excess over the limit atol + rtol*|plain|, <= 0
        excess = (diff - PAGED_ATOL - PAGED_RTOL * want.float().abs()).max()
        check(excess.item() <= 0, "paged %s disagrees with plain: O err "
              "%.3e, over the limit by %.3e" % (name, err, excess.item()))
        for s, n in enumerate(lens_h):
            check(n > 0 or not got[s].any().item(),
                  "paged: an empty slot is not zero")
        del got, want, diff
        ms, _ = device_ms(lambda: co.paged_attention(q, kp, vp, pt, lens),
                          "paged_decode")
        call_ms = time_ms(lambda: co.paged_attention(q, kp, vp, pt, lens))
        plain_ms = time_ms(lambda: co._paged_dense(q, kp, vp, pt, lens,
                                                   D ** -0.5), iters=5)
        live = sum(lens_h)
        nbytes = 2 * live * Hkv * D * 2 + 2 * 2 * S * H * D + 4 * (S * MP + S)
        b_ms, b_by = bound_ms(nbytes, 4 * live * H * D)
        print("paged %s S=%d lengths %s: O err %.3e (limit %.0e + %.0e*"
              "|O|, exceeded by %.3e); kernel %.4f ms (device), call %.4f "
              "ms (events), plain %.4f ms, bound %.4f ms (%s)"
              % (name, S, lens_h if S <= 8 and MP < 64 else "%d x %d"
                 % (S, lens_h[0]), err, PAGED_ATOL, PAGED_RTOL,
                 excess.item(), ms, call_ms, plain_ms, b_ms, b_by))
        out.append({"shape": name, "lengths": lens_h, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        del q, kp, vp
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 6: serve a Llama-3-8B-width model through the port's Server
# ----------------------------------------------------------------------
def build_model(mt, dev, n_layers):
    cfg = mt.models.llama3_8b_config(dtype="bfloat16", n_layers=n_layers)
    net = mt.models.TransformerLM(cfg, device=dev)
    net.initialize(torch.Generator(device=dev).manual_seed(0), std=0.02)
    return net


def make_requests(vocab, seed=3):
    """16 requests, prompts of 20..500 tokens.  A, B and C share a
    256-token prefix: B prefills only its suffix (the chunk path), C is
    the prefix alone, so its last position lands in a cached page (COW).
    Two requests sample with fixed seeds; the rest are greedy."""
    gen = torch.Generator().manual_seed(seed)

    def toks(n):
        return torch.randint(1, vocab, (n,), generator=gen).tolist()

    shared = toks(256)
    reqs = [(shared + toks(44), None), (shared + toks(60), None),
            (shared, None)]
    for n in (20, 33, 64, 100, 127, 129, 200, 255, 300, 380, 450, 500):
        reqs.append((toks(n), None))
    reqs.append((toks(90), None))
    reqs[5] = (reqs[5][0], {"temperature": 0.8, "top_k": 50, "seed": 11})
    reqs[9] = (reqs[9][0], {"temperature": 1.0, "top_p": 0.9, "seed": 12})
    return reqs


def serve_phase(mt, co, net, dev, card, max_new=32):
    scfg = mt.serve.ServeConfig(slots=8, page_size=128, pages=64,
                                ladder=(128, 256, 512), max_new=max_new)
    srv = mt.serve.Server(net, scfg)
    print("KV pool %.3f GB on %s" % (srv.pool.stats["pool_bytes"] / 1e9,
                                     dev))
    copies = []
    copy_page = srv.pool.copy_page

    def counting_copy(src, dst):
        copies.append((src, dst))
        copy_page(src, dst)

    srv.pool.copy_page = counting_copy
    reqs = make_requests(net.cfg.vocab_size)
    torch.cuda.synchronize()
    co.reset_launch_counts()
    t0 = time.monotonic()
    with srv:
        rids = [srv.submit(p, sampling=sp) for p, sp in reqs]
        res = [srv.result(r, timeout=600) for r in rids]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    for r in res:
        check(r is not None and r["state"] == "done"
              and len(r["tokens"]) == max_new,
              "request did not complete: %r" % (r and r.get("state"),))
    check(srv.sched.check_conservation() == [],
          "page conservation broken: %s" % srv.sched.check_conservation())
    check(srv.sched.check_refcounts() == [], "prefix refcounts broken")
    check(srv.sched.stats()["prefix_hits"] >= 2, "prefix cache never hit")
    check(len(copies) >= 1, "the COW page copy never ran")
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0, "kernel %s was not launched on the "
              "serve path" % name)
    ntok = sum(len(r["tokens"]) for r in res)
    ttft = sorted(r["t_first"] - r["t_submit"] for r in res)
    steps = launches["paged_decode"] // net.cfg.n_layers
    print("serve: %d requests, %d tokens in %.3f s = %.1f tokens/s; TTFT "
          "p50 %.1f ms; %d decode steps; launches %s; COW copies %d; "
          "prefix hits %d [%s]"
          % (len(res), ntok, wall, ntok / wall, 1e3 * ttft[len(ttft) // 2],
             steps, launches, len(copies),
             srv.sched.stats()["prefix_hits"], card))
    return srv, reqs, res, launches


def device_busy(fn, reps=5):
    """(host ms per call, device ms per call, top kernels, counts, {kernel
    name: (device ms, launches) per call}) of ``fn``: host time
    synchronized and unprofiled; device time the sum of the CUDA
    kernels' self time in a torch.profiler trace of the same calls;
    counts per call from that trace -- top-level aten ops, aten op
    events at every level, and device events (kernels, memcpy,
    memset)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    aten = [e for e in prof.events() if e.device_type.name == "CPU"
            and e.name.startswith("aten::")]
    counts = {"top-level aten ops": sum(e.cpu_parent is None for e in aten),
              "aten op events": len(aten),
              "device events": sum(e.count for e in kernels)}
    counts = {k: v / reps for k, v in counts.items()}
    return host_ms, dev_ms, [(e.key[:40], e.self_device_time_total / reps
                              / 1e3) for e in top], counts, \
        {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps)
         for e in kernels}


def step_timing(srv, reqs, res, card):
    """Host time of one decode step (8 active slots at the lengths the
    served requests reached) and of one solo 500-token prefill (ladder
    rung 512), each synchronized, beside the device time of their
    kernels from a profiler trace."""
    import numpy as onp
    pool = srv.pool
    S, MP = pool.spec.slots, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    lengths = onp.array([min(len(p) + 31, MP * 128 - 1)
                         for p, _ in reqs[:S]], onp.int32)
    tokens = onp.array([r["tokens"][-1] for r in res[:S]], onp.int32)
    active = onp.ones(S, bool)
    prompt = onp.asarray(reqs[14][0][:512], onp.int32)   # 500 tokens
    padded = onp.zeros(512, onp.int32)
    padded[:len(prompt)] = prompt
    row = onp.arange(41, 41 + MP, dtype=onp.int32)
    out = {}
    for name, fn in (
            ("decode step", lambda: pool.run_decode(
                table, lengths, tokens, active).cpu()),
            ("prefill T=512", lambda: pool.run_prefill(
                padded, row, len(prompt)))):
        ms, dev_ms, top, counts, _ = device_busy(fn)
        out[name] = ms
        print("%s: %.2f ms host, %.2f ms of kernels (device busy %.1f%%) "
              "[%s]; top kernels (ms per call): %s"
              % (name, ms, dev_ms, 100 * dev_ms / ms, card,
                 "; ".join("%s %.3f" % t for t in top)))
        ops = counts["top-level aten ops"]
        print("%s: per call %s; host us per top-level op %.2f"
              % (name, ", ".join("%s %.1f" % kv for kv in counts.items()),
                 1e3 * ms / ops if ops else float("nan")))
    return out


# ----------------------------------------------------------------------
# phase 7: served tokens vs a full-sequence forward (teacher forced)
# ----------------------------------------------------------------------
def consistency_phase(net, reqs, res, dev):
    """Every greedy request's served tokens against a teacher-forced full
    forward of the same sequence: at every position the served token's
    logit is within SERVED_LOGIT_TOL of the full forward's largest, and
    at least SERVED_EXACT_MIN of the positions are its argmax."""
    exact = checked = 0
    worst = (0.0, None)
    with torch.no_grad():
        for i, (prompt, sp) in enumerate(reqs):
            if sp is not None:
                continue
            served = list(res[i]["tokens"])
            seq = torch.tensor([prompt + served[:-1]], device=dev)
            logits = net(seq)[0, len(prompt) - 1:].float()
            got = logits.gather(1, torch.tensor(served, device=dev)[:, None])
            deficit = (logits.amax(dim=-1) - got[:, 0]).tolist()
            for pos, d in enumerate(deficit):
                checked += 1
                exact += d == 0.0
                if d > worst[0]:
                    worst = (d, (i, pos))
                check(d <= SERVED_LOGIT_TOL, "request %d position %d: the "
                      "served token is %.4f below the full forward's top "
                      "logit (limit %.2f)" % (i, pos, d, SERVED_LOGIT_TOL))
    print("consistency: %d positions of %d greedy requests; served token "
          "= full-forward argmax at %d (%.1f%%); largest shortfall %.4f "
          "(request, position %s), limit %.2f"
          % (checked, sum(sp is None for _, sp in reqs), exact,
             100 * exact / checked, worst[0], worst[1], SERVED_LOGIT_TOL))
    check(exact >= SERVED_EXACT_MIN * checked, "consistency: only %d of %d "
          "served tokens are the full forward's argmax" % (exact, checked))


# ----------------------------------------------------------------------
# phase 8: train an 8-layer Llama-3-8B-width model (the slice-2 path)
# ----------------------------------------------------------------------
TRAIN_LAYERS = 8   # 32 layers need ~96 GB of AdamW state: > the 80 GB card


def train_phase(mt, co, dev, card, B=2, T=1024):
    """3 AdamW ``TrainStep`` steps, then one Gluon ``Trainer`` step, of
    ``llama3_8b_config(n_layers=8)`` on one batch; returns the launch
    counts of that run."""
    net = build_model(mt, dev, TRAIN_LAYERS)
    cfg = net.cfg
    V = cfg.vocab_size
    print("train model: llama3_8b_config widths (dim %d, %d/%d heads, "
          "hidden %d, vocab %d), depth cut to %d of 32 layers (AdamW keeps "
          "12 B/param: 32 layers need ~96 GB, the card has 80): %.3f B "
          "params" % (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim,
                      V, TRAIN_LAYERS, net.num_params() / 1e9))
    gen = torch.Generator(device=dev).manual_seed(7)
    toks, labels = (torch.randint(0, V, (B, T), device=dev, generator=gen)
                    for _ in range(2))
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def fwd(model, tokens, lab):
        logits = model(tokens).float()
        return loss_fn(logits.reshape(-1, V), lab.reshape(-1)).mean()
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step(toks, labels).item() for _ in range(3)]
    torch.cuda.synchronize()
    wall3 = time.monotonic() - t0
    with mt.autograd.record():
        loss = loss_fn(net(toks).float().reshape(B, T, V), labels)
    mt.autograd.backward(loss)
    del step                      # its AdamW state: the Trainer has its own
    trainer = mt.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-3})
    trainer.step(B)
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gluon_loss = loss.mean().item()
    losses.append(gluon_loss)
    print("train losses (3 TrainStep steps, then the Gluon loop) %s"
          % losses)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train: a loss is not finite: %s" % losses)
    check(losses[2] < losses[0], "train: the loss did not fall: %s"
          % losses)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 4 * TRAIN_LAYERS,
              "train: %s launched %d times in 4 steps, want %d per step"
              % (name, launches[name], TRAIN_LAYERS))
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "train: parameters did not change: %s" % unchanged)
    del before, trainer, loss
    torch.cuda.empty_cache()

    params = list(net.parameters())
    fb_ms, fb_dev, _, _, _ = device_busy(
        lambda: torch.autograd.grad(fwd(net, toks, labels), params), reps=2)
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    ms, dev_ms, top, counts, _ = device_busy(
        lambda: step(toks, labels).item(), reps=2)
    # useful model flops: 6 per matmul weight per token (the embedding
    # is a gather), attention 4 * D per visible pair forward, 8 * D back
    pairs = B * cfg.n_heads * T * (T + 1) // 2
    flops = 6 * (net.num_params() - V * cfg.dim) * B * T \
        + TRAIN_LAYERS * 12 * (cfg.dim // cfg.n_heads) * pairs
    print("train step (B=%d, T=%d, %d layers): %.1f ms host (3 steps in "
          "%.2f s), %.1f ms of kernels (device busy %.1f%%), %.0f tokens/s, "
          "%.1f model TFLOP/s (%.1f%% of 989), peak memory %.2f GB [%s]; "
          "top kernels (ms per step): %s"
          % (B, T, TRAIN_LAYERS, ms, wall3, dev_ms, 100 * dev_ms / ms,
             B * T / ms * 1e3, flops / ms / 1e9, flops / ms / 9.89e9,
             peak / 1e9, card, "; ".join("%s %.3f" % t for t in top)))
    print("train step: forward + backward alone %.1f ms host, %.1f ms of "
          "kernels; the rest of the step (AdamW over %.3f B params) %.1f ms "
          "of kernels" % (fb_ms, fb_dev, net.num_params() / 1e9,
                          dev_ms - fb_dev))
    print("train step: per step %s" % ", ".join("%s %.1f" % kv
                                                for kv in counts.items()))
    return launches


# ----------------------------------------------------------------------
# phase 9: ResNet-50 (__graft_entry__.entry()'s model) through the zoo
# ----------------------------------------------------------------------
RESNET_B, RESNET_TRAIN_B, RESNET_TRAIN_STEPS = 32, 128, 3
# Limits on ||a - b|| / ||b|| of the logits.  A replayed graph runs the
# eager call's kernels.  NHWC and NCHW may run different cuDNN kernels
# in bf16 (each rounding to bf16, a relative step of 2^-8).  The fp32
# card forward (TF32 off) against the CPU sums in another order only.
# Measured on an H100: replay and eager bitwise equal in both layouts;
# NHWC and NCHW bitwise equal (cuDNN transposes NCHW to NHWC and runs
# the same kernels); card vs CPU 1.08e-06.
RESNET_HYB_REL = 1e-3
RESNET_LAYOUT_REL = 1e-2
RESNET_CPU_REL = 1e-5
COPY_KERNEL = re.compile(r"copy|nchwToNhwc|nhwcToNchw|transpose", re.I)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _resnet50(mt, dev, layout="NCHW"):
    """``resnet50_v1`` at full width, 1000 classes, its weights drawn
    from seed 0 on the card at the first forward."""
    net = mt.gluon.model_zoo.vision.resnet50_v1(layout=layout)
    return net.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))


def _ohwi(params):
    """NCHW zoo weights -> NHWC: conv weights OIHW -> OHWI."""
    import numpy as onp
    return {k: onp.ascontiguousarray(v.transpose(0, 2, 3, 1))
            if v.ndim == 4 else v for k, v in params.items()}


def resnet_phase(mt, dev, card):
    """ResNet-50 inference at ``__graft_entry__.entry()``'s shape (B=32,
    3x224x224, every parameter bf16), eager and hybridized, NCHW and
    NHWC, on the same weights; a B=2 float32 forward on the card against
    the CPU; then 3 training steps at B=128."""
    vision = mt.gluon.model_zoo.vision
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(RESNET_B, 3, 224, 224, generator=gen, device=dev).to(
        torch.bfloat16)
    nets = {"NCHW": _resnet50(mt, dev).cast("bfloat16")}
    inputs = {"NCHW": x, "NHWC": x.permute(0, 2, 3, 1).contiguous()}
    with mt.autograd.pause():
        eager = {"NCHW": nets["NCHW"](x)}
        params = mt.convert.export_params(nets["NCHW"])
        nets["NHWC"] = mt.convert.load_params(
            vision.resnet50_v1(layout="NHWC").initialize(device=dev).cast(
                "bfloat16"), _ohwi(params))
        eager["NHWC"] = nets["NHWC"](inputs["NHWC"])
        lay = _rel(eager["NHWC"], eager["NCHW"])
        print("resnet50 NHWC vs NCHW (same bf16 weights, B=%d): logits "
              "||d||/||NCHW|| %.3e (limit %.0e), max|d| %.4f of max|logit| "
              "%.4f" % (RESNET_B, lay, RESNET_LAYOUT_REL,
                        (eager["NHWC"].float() - eager["NCHW"].float()).abs()
                        .max().item(), eager["NCHW"].float().abs().max()
                        .item()))
        check(lay <= RESNET_LAYOUT_REL, "resnet50: NHWC disagrees with NCHW "
              "by %.3e" % lay)
    rows = []
    for layout in ("NCHW", "NHWC"):
        net, inp = nets[layout], inputs[layout]
        for mode in ("eager", "hybridized"):
            net.hybridize(mode == "hybridized")
            # MXNet's ``net.hybridize(); net(x)``: outside any record()
            # autograd is not recording, so no scope is needed to replay;
            # the eager forward runs under pause() to keep no tape
            scope = contextlib.nullcontext() if mode == "hybridized" \
                else mt.autograd.pause()
            with scope:
                if mode == "hybridized":
                    net(inp)                    # eager once, then capture
                    out = net(inp)              # replay
                    check(len(net._graphs) == 1 and not out.requires_grad,
                          "resnet50: no graph was captured")
                    rel = _rel(out, eager[layout])
                    print("resnet50 %s hybridized vs eager: bitwise equal "
                          "%s, ||d||/||eager|| %.3e (limit %.0e)"
                          % (layout, torch.equal(out, eager[layout]), rel,
                             RESNET_HYB_REL))
                    check(rel <= RESNET_HYB_REL, "resnet50 %s: hybridized "
                          "disagrees with eager by %.3e" % (layout, rel))
                host, dev_ms, top, counts, per = device_busy(
                    lambda: net(inp), reps=10)
                copies = ["%s: %.4f ms in %g launches" % (k[:60], ms, n)
                          for k, (ms, n) in per.items()
                          if COPY_KERNEL.search(k)]
                print("resnet50 %s %s forward (B=%d bf16): %.0f images/s, "
                      "%.2f ms host, %.2f ms of kernels (device busy %.1f%%),"
                      " %.1f device events per call; copy / layout kernels "
                      "per call: %s; top kernels %s [%s]"
                      % (layout, mode, RESNET_B, RESNET_B / host * 1e3, host,
                         dev_ms, 100 * dev_ms / host,
                         counts["device events"], "; ".join(copies) or "none",
                         "; ".join("%s %.3f" % t for t in top), card))
                rows.append((layout, mode, host))
        net.hybridize(False)
    print("resnet50 forward host ms, same run: %s"
          % ", ".join("%s %s %.2f" % r for r in rows))
    del nets, eager, inputs
    gc.collect()
    torch.cuda.empty_cache()
    resnet_cpu_check(mt, dev, params, x[:2].float())
    del params
    for layout in ("NCHW", "NHWC"):
        resnet_train(mt, dev, card, layout)
        gc.collect()
        torch.cuda.empty_cache()


def resnet_cpu_check(mt, dev, params, x):
    """The same weights in float32 on the card (cuDNN with TF32 off, the
    float32 matmul at full precision) and on the CPU: a B=2 forward."""
    vision = mt.gluon.model_zoo.vision
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with mt.autograd.pause():
            card = mt.convert.load_params(
                vision.resnet50_v1().initialize(device=dev), params)(x)
            cpu = mt.convert.load_params(
                vision.resnet50_v1().initialize(device="cpu"),
                params)(x.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = _rel(card.cpu(), cpu)
    print("resnet50 float32 B=2, card (TF32 off) vs CPU: logits "
          "||d||/||cpu|| %.3e, max|d| %.3e (limit %.0e)"
          % (rel, (card.cpu() - cpu).abs().max().item(), RESNET_CPU_REL))
    check(rel <= RESNET_CPU_REL, "resnet50: the card disagrees with the CPU "
          "by %.3e" % rel)


def resnet_train(mt, dev, card, layout):
    """3 SGD steps (lr 0.05, momentum 0.9, wd 1e-4) at B=128 in
    ``layout``, BatchNorm in training mode, the softmax CE, then the
    steps timed.  Convolution and dense weights are bf16; BatchNorm's
    gains and statistics stay float32, as mixed precision keeps them (a
    bf16 running variance near 1 cannot take a step below half its
    2^-8 spacing)."""
    B = RESNET_TRAIN_B
    net = _resnet50(mt, dev, layout).cast("bfloat16")
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            m.cast("float32")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, 3, 224, 224, generator=gen, device=dev).to(
        torch.bfloat16)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    labels = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with mt.autograd.pause():
        net(x[:2])                               # materialise the weights
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    # lr 0.1 per 256 images (the linear scaling rule of ResNet training)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def step():
        with mt.autograd.record():
            loss = loss_fn(net(x).float(), labels)
        mt.autograd.backward(loss)
        trainer.step(B)
        return loss.mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    losses = [step() for _ in range(RESNET_TRAIN_STEPS)]
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), "resnet50 %s train: a loss "
          "is not finite: %s" % (layout, losses))
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "resnet50 %s train: unchanged: %s"
          % (layout, unchanged))
    stats = sum("running" in n for n in before)
    del before
    ms, dev_ms, top, counts, _ = device_busy(step, reps=2)
    print("resnet50 train (B=%d, %s, SGD lr 0.05 momentum 0.9 wd 1e-4): "
          "losses %s;"
          " every one of %d trainable tensors and %d BatchNorm statistics "
          "changed; %d steps in %.2f s; step %.1f ms host, %.1f ms of "
          "kernels (device busy %.1f%%), %.0f images/s, peak memory %.2f GB "
          "[%s]; top kernels (ms per step): %s"
          % (B, layout, losses,
             sum(p.requires_grad for p in net.parameters()),
             stats, RESNET_TRAIN_STEPS, wall, ms, dev_ms, 100 * dev_ms / ms,
             B / ms * 1e3, peak / 1e9, card,
             "; ".join("%s %.3f" % t for t in top)))


# ----------------------------------------------------------------------
# phase 10: BERT-base pretraining steps through the flash kernels
# ----------------------------------------------------------------------
BERT_B, BERT_T, BERT_STEPS = 16, 512, 3


def bert_batch(cfg, dev, B, T, seed):
    """Random tokens, two segments, MLM labels at every position and
    NSP labels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=dev)
    types = (torch.arange(T, device=dev) >= T // 2).long().expand(B, T)
    mlm = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    nsp = torch.randint(0, 2, (B,), generator=gen, device=dev)
    return toks, types, mlm, nsp


def bert_loss(mt, net, toks, types, mlm, nsp):
    """Mean MLM + NSP softmax CE on float32 logits."""
    ce = mt.gluon.loss.SoftmaxCELoss()
    mlm_logits, nsp_logits = net(toks, types)
    V = mlm_logits.shape[-1]
    return ce(mlm_logits.float().reshape(-1, V), mlm.reshape(-1)).mean() \
        + ce(nsp_logits.float(), nsp).mean()


def bert_parity(mt, co, dev, card):
    """A small head_dim-64 BERT (hidden 256, 4 heads, 2 layers), the
    same bf16 weights on the card (flash kernels) and on the CPU (plain
    versions), dropout off: the loss and every grad, as ``parity_phase``
    compares them."""
    cfg = mt.models.bert_tiny_config(hidden_size=256, num_heads=4,
                                     intermediate_size=1024,
                                     dtype="bfloat16", dropout=0.0)
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    cpu = mt.convert.load_params(
        mt.models.BERTForPretrain(cfg).initialize(device="cpu"),
        mt.convert.export_params(net))
    batch = bert_batch(cfg, "cpu", 2, 128, 6)
    losses = []
    co.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        with mt.autograd.record():
            loss = bert_loss(mt, model, *(t.to(d) for t in batch))
        mt.autograd.backward(loss)
        losses.append(loss.item())
    torch.cuda.synchronize()
    check(co.LAUNCHES["flash_fwd"] == co.LAUNCHES["flash_bwd_dq"]
          == co.LAUNCHES["flash_bwd_dkv"] == cfg.num_layers,
          "bert parity: the flash kernels did not run: %s" % co.LAUNCHES)
    rel = {}
    for (name, g), (_, p) in zip(net.named_parameters(),
                                 cpu.named_parameters()):
        gc_, gp = g.grad.float().cpu(), p.grad.float()
        rel[name] = ((gc_ - gp).norm() / gp.norm()).item()
    worst = max(rel, key=rel.get)
    print("bert parity (hidden 256, 4 heads of 64, 2 layers, vocab %d, "
          "B=2, T=128): loss cuda %.6f cpu %.6f; grad ||cuda-cpu||/||cpu|| "
          "max %.3e (%s), median %.3e [%s]"
          % (cfg.vocab_size, losses[0], losses[1], rel[worst], worst,
             sorted(rel.values())[len(rel) // 2], card))
    check(abs(losses[0] - losses[1]) <= PARITY_LOSS_RTOL * abs(losses[1]),
          "bert parity: losses differ: %s" % losses)
    check(rel[worst] <= GRAD_REL_TOL, "bert parity: %s grad differs by "
          "%.3e (limit %.0e)" % (worst, rel[worst], GRAD_REL_TOL))


def bert_phase(mt, co, dev, card):
    """``BERTForPretrain(bert_base_config())`` with bf16 weights, B=16,
    T=512, no ``valid_length`` (the flash path): 3 AdamW steps through
    the Gluon ``Trainer`` on one batch.  Returns the launch counts of
    those steps."""
    bert_parity(mt, co, dev, card)
    cfg = mt.models.bert_base_config(dtype="bfloat16")
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    nparams = sum(p.numel() for p in net.parameters())
    batch = bert_batch(cfg, dev, BERT_B, BERT_T, 7)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    trainer = mt.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 2e-5, "wd": 0.01})

    def step():
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
        mt.autograd.backward(loss)
        trainer.step(1)
        return loss.item()
    torch.cuda.manual_seed(8)     # dropout's masks: the same every run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step() for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("bert-base train losses (%d AdamW steps, B=%d, T=%d) %s; launches "
          "%s" % (BERT_STEPS, BERT_B, BERT_T, losses, launches))
    check(all(math.isfinite(v) for v in losses), "bert: a loss is not "
          "finite: %s" % losses)
    check(losses[-1] < losses[0], "bert: the loss did not fall: %s" % losses)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == cfg.num_layers * BERT_STEPS,
              "bert: %s launched %d times in %d steps, want %d per step"
              % (name, launches[name], BERT_STEPS, cfg.num_layers))
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "bert: parameters did not change: %s" % unchanged)
    del before
    ms, dev_ms, top, counts, _ = device_busy(step, reps=2)
    print("bert-base train step (%.1f M params, bf16, B=%d, T=%d, dropout "
          "0.1): %d steps in %.2f s; step %.1f ms host, %.1f ms of kernels "
          "(device busy %.1f%%), %.1f samples/s, peak memory %.2f GB [%s]; "
          "top kernels (ms per step): %s"
          % (nparams / 1e6, BERT_B, BERT_T, BERT_STEPS, wall, ms, dev_ms,
             100 * dev_ms / ms, BERT_B / ms * 1e3, peak / 1e9, card,
             "; ".join("%s %.3f" % t for t in top)))
    return launches


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_ops as co
    t_start = time.monotonic()
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s x%d"
          % (torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0), torch.cuda.device_count()))
    t0 = time.monotonic()
    _build.build_all()
    print("kernel build %.2f s (nvcc, one process per source)"
          % (time.monotonic() - t0))
    if argv[1:] == ["--kernel-timing"]:
        # only the kernels' timing, for comparing two trees in one
        # call: copy this file into the other tree's root
        print(json.dumps({"kernel_timing": {
            "tree": root, "card": card, "flash_fwd": flash_timing(co, dev),
            "flash_bwd": [bwd_timing(co, dev, card, shape)
                          for shape in (TRAIN_ATTN, BERT_ATTN)],
            "paged_decode": paged_timing(co, dev)}}))
        return 0
    check(len(argv) == 1, "usage: chip_smoke.py [--kernel-timing]")
    ptxas_report(_build)

    flash = flash_phase(co, dev)
    flash_bwd = flash_bwd_phase(co, dev, card)
    parity_phase(mt, co, dev, card)
    paged = paged_phase(co, dev)

    n_layers = 32
    net = build_model(mt, dev, n_layers)
    print("model: llama3_8b_config widths, %d layers, %.2f GB of bf16 "
          "weights" % (n_layers, sum(p.numel() for p in net.parameters())
                       * 2 / 1e9))
    srv, reqs, res, serve_launches = serve_phase(mt, co, net, dev, card)
    consistency_phase(net, reqs, res, dev)
    step_timing(srv, reqs, res, card)
    del srv, net                  # free the serving model for training
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_phase(mt, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches = bert_phase(mt, co, dev, card)

    kernels = [flash] + flash_bwd + [paged]
    for k in kernels:
        by_path = {"serve": serve_launches[k["name"]],
                   "train": train_launches[k["name"]],
                   "bert": bert_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print("total %.1f s" % (time.monotonic() - t_start))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
